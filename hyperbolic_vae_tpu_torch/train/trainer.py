"""The training engine.

Port of ``hyperbolic_vae_tpu/train/trainer.py`` for one model on one
device: Riemannian Adam (with ``moment_dtype`` and ``ema_decay``), row or
block shuffle, the finite guard with ``skipped_steps``, the split-exact
val eval, and on the device ReduceLROnPlateau, early stopping and
best-params tracking on ``monitor``. History rows carry ``train/<m>``,
``val/<m>``, ``lr`` and ``epoch`` as in JAX.

As in JAX every fit runs through the chunk program
(``train/chunk_program.py``): ``epochs_per_dispatch`` K epochs a
dispatch, with the controllers on the device, so histories are
bit-identical for every K, and one fetch of metrics per chunk. On the
card the chunk's pieces are CUDA graphs (``train/cuda_graph.py``),
captured at the first chunk; on the CPU the same pieces run eagerly.
``lr_schedule`` (``optim.cosine_schedule``, ``exponential_schedule``)
replaces the plateau lr; ``beta_schedule`` (``beta_warmup_schedule``)
sets the model's KL weight per epoch, as sugar for ``hp_schedule``, whose
keys must be ones the model reads as a device tensor (``beta``). The
host, at chunk boundaries, logs (every ``log_every_n_epochs``),
checkpoints (``checkpoint_dir``: best, last, ``ema``, and, every
``state_every_n_epochs`` and at every stop and the end, the resume state
that ``fit(resume=True)`` continues from), calls ``callbacks``
(``train/callbacks.py``) and checks for a graceful stop
(``preempt_signals``, ``max_wall_seconds``: ``train/preemption.py``);
``profile_dir`` gets a torch.profiler trace of the second chunk. Before
staging, a memory preflight (``hbm_limit_bytes``) fails early. Seed
ensembles and hyperparameter lanes (``hp_model_fn``) run through
``fit_ensemble`` and ``fit_lane_sweep`` (``train/ensemble.py``). After
training, ``evaluate``, ``evaluate_iwae``, ``evaluate_probe`` and
``encode_split`` delegate to ``train/evaluation.py``.

Hooks, as in JAX: ``loss_fn(model, batch, generator) -> metrics`` (e.g.
``ops.flagship_fused.make_fused_loss_fn``) replaces ``model.loss``;
``train_step_fn(model, optimizer, batch, generator) -> metrics`` (e.g.
``ops.flagship_fused.make_fused_train_step``, K3) replaces the whole step
(loss, backward, guard and update) and owns its finite guard, so
``finite_guard`` does not apply to it. The options that do not compose
raise, as in JAX: ``grad_accum_steps``, ``grad_clip_norm`` and
``ema_decay`` with ``train_step_fn``; ``beta_schedule`` with ``loss_fn``
or ``train_step_fn``; ``grad_accum_steps`` with a model whose
``loss_reduction`` is not ``"per_sample_mean"``; and, in the port,
``moment_dtype`` with ``train_step_fn`` (K3 keeps f32 moments).
``fit`` trains ``model`` in place, from its current weights or from
``params``. ``fit_streamed(dm, block_rows)`` trains a split that stays on
the host, streamed through the card in double-buffered blocks
(``train/streaming.py``), and ``evaluate(..., stream_block_rows=m)``
evaluates one in blocks; the memory preflight then counts two blocks, and
when it refuses a resident fit its remedy names ``fit_streamed``.
``log_dir`` gets JSONL metrics, and TensorBoard event files where
``torch.utils.tensorboard`` imports (``train/metrics.py``).

``mesh`` (``parallel.make_mesh``; ``use_mesh=True`` builds one over the
world) trains data parallel over ``torch.distributed``, one process a
card (``parallel/data_parallel.py``): every rank stages the split (padded
to a multiple of the data axis with its own first rows, as JAX's
``_stage``), takes its rows of each global batch with the global batch's
draws, and sums its gradients and metrics with the other ranks' before
the guard and the update; the val batches run whole on every rank. K3's
``train_step_fn`` and K2's fused ``loss_fn`` run the whole batch on every
rank with no collective. Rank 0 alone writes logs and checkpoints; every
rank resumes from them and returns the same ``TrainResult``.

``param_sharding_fn`` (``parallel.tp_param_shardings``,
``fsdp_param_shardings``, ``fsdp_tp_param_shardings``; a mesh is needed)
lays the parameters out over the mesh for the fit
(``parallel/fsdp.py``, ``parallel/tensor_parallel.py``): tensor-parallel
layers on the 'model' axis (K1 on each rank's plane shard), FSDP's
slices and their moments on the 'data' axis. The model's layers are
swapped for the fit and put back at its end, and for each callback's
call; ``TrainResult.params``, ``best_params`` and ``ema_params``, the
checkpoints and what callbacks receive hold whole tensors in the
reference layout, gathered on every rank, so a resume may take another
layout or none (elastic resume).
K3's ``train_step_fn`` and K2's fused ``loss_fn`` run on gathered whole
tensors and keep each rank's slices, as XLA runs a Pallas call.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import math
import signal
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule
from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.optim import EarlyStopping, ReduceLROnPlateau, RiemannianAdam
from hyperbolic_vae_tpu_torch.parallel.mesh import DATA_AXIS
from hyperbolic_vae_tpu_torch.train.chunk_program import ChunkProgram
from hyperbolic_vae_tpu_torch.train.epoch_program import default_loss_fn
from hyperbolic_vae_tpu_torch.train.metrics import MetricLogger

logger = logging.getLogger(__name__)


# the keys a hyperparameter schedule may set: attributes that the port's
# models read at every call, so a 0-d device tensor can stand in for the
# float; anything else (e.g. manifold_curvature) is baked in at build time
SCHEDULABLE_KEYS = ("beta",)


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]
    best_params: Dict[str, torch.Tensor]
    history: list
    best_metric: float
    epochs_run: int
    samples_per_sec: float
    # the parameters' EMA over the run (with ema_decay), by state_dict name
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    # True when a graceful stop (preempt_signals, max_wall_seconds) ended
    # the run; with a checkpoint_dir its resume state was saved
    interrupted: bool = False
    stop_reason: Optional[str] = None


def _snapshot(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def init_params_of(model, seed: int, device) -> Dict[str, torch.Tensor]:
    """Fresh weights for ``model``'s configuration (``model.hparams()``),
    drawn on the CPU from ``seed``, on ``device``."""
    g = torch.Generator().manual_seed(int(seed))
    fresh = type(model)(**model.hparams(), generator=g, device="cpu")
    return {k: v.to(device) for k, v in fresh.state_dict().items()}


class _Run:
    """One fit on the device: ``trainer.model`` trained in place, with its
    optimizer, generator and chunk program (from ``params`` or a resume
    ``state``), and the host's reading of the chunks: history, best metric,
    epochs run. ``fit`` drives one; a sweep drives one a lane, each with its
    own trainer (``train/ensemble.py``), so a lane is a fit by construction.
    ``close()`` gives the model back its scheduled attributes' floats."""

    def __init__(self, trainer, batch_size: int, x_train, x_val, params=None, state=None,
                 meta=None, stream=None, blocks=None):
        tr = self.trainer = trainer
        tr.plateau = ReduceLROnPlateau(**tr._plateau_cfg)
        if tr._early_patience:
            tr.early_stopping = EarlyStopping(patience=tr._early_patience)
        model = tr.model
        self.static = {}
        if params is not None:
            model.load_state_dict(params)
        # under a layout the whole starting weights are cut into the
        # layout's pieces, the optimizer stepping the masters
        self.sharded = None
        if tr.param_sharding_fn is not None:
            if state is not None:
                model.load_state_dict(state["params"])
            self.sharded = tr._shard(model)
        try:
            tr.optimizer = tr._make_optimizer(self.sharded)
            if state is not None:
                if self.sharded is None:
                    model.load_state_dict(state["params"])
                    tr.optimizer.load_state_dict(state["optimizer"])
                else:
                    tr.optimizer.load_state_dict(
                        self.sharded.local_optimizer_state(state["optimizer"]))
        except BaseException:
            self.close()
            raise
        self.gen = torch.Generator(device=tr.device).manual_seed(tr.seed)
        self.start_epoch = 0
        self.ig_best, self.stopped = math.inf, False
        if state is not None:
            self.start_epoch = int(meta["epoch"]) + 1
            self.gen.set_state(state["generator"].cpu())
            tr.plateau.lr, tr.plateau.best = meta["plateau_lr"], meta["plateau_best"]
            tr.plateau.num_bad_epochs = meta["plateau_bad"]
            if tr.early_stopping:
                tr.early_stopping.best, tr.early_stopping.wait = meta["early_best"], meta["early_wait"]
            self.ig_best = float(state["chunk"]["ctrl"]["best_val"])
            self.stopped = bool(state["chunk"]["ctrl"]["stopped"])
        # each scheduled key as a 0-d tensor the chunk program writes per
        # epoch (a float would be frozen into a captured graph)
        self.static = {k: getattr(model, k) for k in tr.hp_keys}
        hp = {k: torch.zeros((), dtype=torch.float32, device=tr.device) for k in tr.hp_keys}
        for k, t in hp.items():
            setattr(model, k, t)
        loss_fn = tr.loss_fn or default_loss_fn
        try:
            if blocks is None:
                self.prog = ChunkProgram(tr, model, tr.optimizer, x_train, x_val, batch_size,
                                         self.gen, self.start_epoch, loss_fn=loss_fn, hp=hp,
                                         stream=stream, sharded=self.sharded)
            else:
                # x_train on the host, streamed in blocks (train/streaming.py)
                from hyperbolic_vae_tpu_torch.train.streaming import StreamedProgram

                block_rows, reshuffle = blocks
                self.prog = StreamedProgram(tr, model, tr.optimizer, x_train, block_rows,
                                            reshuffle, x_val, batch_size, self.gen,
                                            self.start_epoch, loss_fn=loss_fn, hp=hp,
                                            sharded=self.sharded)
            if state is not None:
                self.prog.load_state_dict(state["chunk"])
        except BaseException:
            self.close()
            raise
        tr.program = self.prog
        self.samples_per_epoch = self.prog.samples_per_epoch
        self.history: list = []
        self.best_metric = self.ig_best
        self.epochs_run = self.start_epoch

    def close(self) -> None:
        for k, v in self.static.items():
            setattr(self.trainer.model, k, v)
        if hasattr(self, "prog"):  # not yet when the program's constructor raised
            self.prog.close()
        if self.sharded is not None:  # a fit that failed: the layers back, untrained
            self.sharded.restore(None)
            self.sharded = None

    def absorb(self, rows: np.ndarray, ctrl: dict):
        """A fetched chunk into the host's state: the controllers' mirrors,
        the history (logged every ``log_every_n_epochs``), the best metric.
        Returns the chunk's new best (epoch, metrics), or None."""
        tr = self.trainer
        tr.plateau.lr, tr.plateau.best = ctrl["pl_lr"], ctrl["pl_best"]
        tr.plateau.num_bad_epochs = ctrl["pl_bad"]
        self.stopped, self.ig_best = ctrl["stopped"], ctrl["best_val"]
        if tr.early_stopping:
            tr.early_stopping.best, tr.early_stopping.wait = ctrl["es_best"], ctrl["es_wait"]
            tr.early_stopping.stopped = self.stopped
        best_row = None
        for i in range(ctrl["epoch"] - self.epochs_run):
            epoch = self.epochs_run
            metrics = self.prog.row_metrics(rows[i])
            metrics["epoch"] = epoch
            self.history.append(metrics)
            self.epochs_run = epoch + 1
            if epoch % tr.log_every_n_epochs == 0:
                tr.metric_logger.log_scalars(epoch, metrics)
            if tr.check_finite and not np.isfinite(metrics["train/loss_total"]):
                logger.warning("non-finite train loss at epoch %d", epoch)
            mon = metrics[tr.monitor]
            if np.isfinite(mon) and mon < self.best_metric:
                self.best_metric, best_row = mon, (epoch, metrics)
        return best_row

    def resume_state(self):
        """(state, meta) of the resume unit: parameters, optimizer, the
        device's controllers and best params, the generator; the host
        controllers' mirrors in the metadata. Whole tensors under a layout."""
        tr = self.trainer
        es = tr.early_stopping
        opt = (copy.deepcopy(tr.optimizer.state_dict()) if self.sharded is None
               else self.sharded.full_optimizer_state(tr.optimizer))
        return ({"params": self.full_params(), "optimizer": opt,
                 "chunk": self.prog.state_dict(), "generator": self.gen.get_state()},
                {"epoch": self.epochs_run - 1, "plateau_lr": tr.plateau.lr,
                 "plateau_best": tr.plateau.best, "plateau_bad": tr.plateau.num_bad_epochs,
                 "early_best": es.best if es else math.inf, "early_wait": es.wait if es else 0})

    def full(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tracked tensors by key, whole (gathered under a layout)."""
        if self.sharded is None:
            return {k: v.clone() for k, v in tensors.items()}
        return self.sharded.full(tensors)

    def whole_model(self):
        """A context in which ``trainer.model`` is the model one process
        holds: its own layers and this fit's weights, whole (callbacks run
        in it); unchanged without a layout."""
        return contextlib.nullcontext() if self.sharded is None else self.sharded.whole()

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The model's weights, whole, on every rank."""
        return _snapshot(self.trainer.model) if self.sharded is None else self.sharded.full_params()

    def ema_params(self) -> Dict[str, torch.Tensor]:
        tr = self.trainer
        if self.sharded is None:
            return tr._ema_params()
        ema = tr.optimizer.ema_params()
        return self.sharded.full({leaf.key: ema[leaf.master] for leaf in self.sharded.leaves})

    def result(self, samples_per_sec: float, stop_reason: Optional[str]) -> TrainResult:
        tr = self.trainer
        params = self.full_params()
        out = TrainResult(
            params=params,
            best_params=self.full(self.prog.best),
            history=self.history,
            best_metric=self.best_metric,
            epochs_run=self.epochs_run,
            samples_per_sec=samples_per_sec,
            ema_params=self.ema_params() if tr.ema_decay is not None else None,
            interrupted=stop_reason is not None,
            stop_reason=stop_reason,
        )
        if self.sharded is not None:  # the model's own layers back, trained
            self.sharded.restore(params)
            self.sharded = None
        return out


class Trainer:
    def __init__(
        self,
        model,
        lr: Optional[float] = None,
        max_epochs: int = 300,
        seed: int = 42,
        monitor: str = "val/loss_total",
        early_stopping_patience: Optional[int] = 10,
        plateau_factor: float = 0.2,
        plateau_patience: int = 20,
        plateau_min_lr: float = 5e-5,
        log_dir: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        callbacks: Sequence = (),
        check_finite: bool = True,
        log_every_n_epochs: int = 1,
        profile_dir: Optional[str] = None,  # a torch.profiler trace of the second chunk
        state_every_n_epochs: int = 1,  # the resume state's cadence (also saved at every stop and at the end)
        shuffle: str = "row",  # "row" (fresh permutation) | "block" (random windows)
        epochs_per_dispatch: int = 1,  # K: epochs a chunk runs before the host looks
        loss_fn: Optional[Callable] = None,  # fn(model, batch, generator) -> metrics
        train_step_fn: Optional[Callable] = None,  # fn(model, optimizer, batch, generator) -> metrics
        moment_dtype=None,  # storage type of both Adam moments, e.g. "bfloat16"; math in f32
        hp_model_fn: Optional[Callable] = None,  # fn(lane hparams) -> model: hyperparameter lanes (fit_lane_sweep)
        hp_schedule: Optional[Callable] = None,  # fn(epoch) -> {key: value}, each key a tensor the model reads (beta)
        beta_schedule: Optional[Callable] = None,  # fn(epoch) -> beta, e.g. beta_warmup_schedule
        ema_decay: Optional[float] = None,  # an EMA of the parameters (TrainResult.ema_params)
        lr_schedule: Optional[Callable] = None,  # fn(epoch) -> lr; replaces the plateau lr
        grad_accum_steps: int = 1,  # A > 1: each step sums the gradients of A microbatches of batch/A rows
        grad_clip_norm: Optional[float] = None,  # clip the gradients to this global L2 norm
        max_wall_seconds: Optional[float] = None,  # graceful stop once a fit has run this long
        preempt_signals: Sequence[int] = (),  # e.g. (signal.SIGTERM,): graceful stops (train/preemption.py)
        hbm_limit_bytes: Optional[int] = None,  # the memory preflight's limit (None: the card's memory)
        finite_guard: bool = True,  # skip a step whose loss or gradient is not finite (default step)
        mesh=None,  # parallel.make_mesh(): data parallel over its ranks
        use_mesh: bool = False,  # build make_mesh() over the torch.distributed world
        param_sharding_fn: Optional[Callable] = None,  # fn(model, mesh) -> layout (parallel.sharding_rules)
        device: DeviceLike = None,
    ):
        if shuffle not in ("row", "block"):
            raise ValueError(f"shuffle must be 'row' or 'block', got {shuffle!r}")
        if epochs_per_dispatch < 1:
            raise ValueError(f"epochs_per_dispatch must be >= 1, got {epochs_per_dispatch}")
        if state_every_n_epochs < 1:
            raise ValueError(f"state_every_n_epochs must be >= 1, got {state_every_n_epochs}")
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        if grad_accum_steps > 1 and train_step_fn is not None:
            raise ValueError("grad_accum_steps does not compose with train_step_fn "
                             "(the full-step override owns its own grad computation)")
        if grad_accum_steps > 1 and (
                getattr(model, "loss_reduction", "per_sample_mean") != "per_sample_mean"):
            # accumulation averages the metrics and gradients over A equal
            # microbatches: exact only for per-sample-mean losses
            raise ValueError(
                f"grad_accum_steps>1 requires a per-sample-mean loss dict, "
                f"but {type(model).__name__}.loss_reduction is "
                f"'{model.loss_reduction}' (its loss entries are batch "
                f"sums, which accumulation rescales by 1/A). Use the "
                f"per-sample-mean loss mode (e.g. loss_recon="
                f"'bernoulli_elbo') or grad_accum_steps=1.")
        if grad_clip_norm is not None and train_step_fn is not None:
            raise ValueError("grad_clip_norm does not compose with train_step_fn")
        if beta_schedule is not None:
            if hp_model_fn is not None or hp_schedule is not None:
                raise ValueError("beta_schedule is sugar for hp_model_fn+hp_schedule: pass "
                                 "either the sugar or the generic form, not both")
            if loss_fn is not None or train_step_fn is not None:
                raise ValueError("beta_schedule does not compose with loss_fn/train_step_fn")
            if not hasattr(model, "beta"):
                raise ValueError(f"beta_schedule requires a model with a beta attribute "
                                 f"(got {type(model).__name__})")
            hp_schedule = lambda epoch: {"beta": beta_schedule(epoch)}  # noqa: E731
        elif hp_schedule is not None and hp_model_fn is None:
            raise ValueError("hp_schedule requires hp_model_fn (or beta_schedule)")
        if hp_model_fn is not None and (loss_fn is not None or train_step_fn is not None):
            raise ValueError("hp_model_fn does not compose with loss_fn/train_step_fn")
        self.hp_keys = tuple(hp_schedule(torch.zeros((), dtype=torch.int32))) if hp_schedule else ()
        for key in self.hp_keys:
            if key not in SCHEDULABLE_KEYS or not hasattr(model, key):
                raise ValueError(
                    f"hp_schedule key {key!r} is baked into {type(model).__name__} when it is "
                    f"built; a schedule sets only what the model reads as a device tensor at "
                    f"every call ({', '.join(SCHEDULABLE_KEYS)})")
        if ema_decay is not None and train_step_fn is not None:
            # the full-step override replaces the optimizer, so the EMA
            # would never update
            raise ValueError("ema_decay does not compose with train_step_fn")
        if moment_dtype is not None and train_step_fn is not None:
            raise ValueError("moment_dtype does not compose with train_step_fn "
                             "(the fused train step keeps f32 moments)")
        mon_src, _, mon_key = monitor.partition("/")
        if mon_src not in ("val", "train") or not mon_key:
            raise ValueError(f"monitor must be 'val/<metric>' or 'train/<metric>', got {monitor!r}")
        if mesh is None and use_mesh:
            from hyperbolic_vae_tpu_torch.parallel import make_mesh

            mesh = make_mesh(device=device)
        if mesh is not None and DATA_AXIS not in mesh.shape:
            raise ValueError(f"a Trainer's mesh needs a {DATA_AXIS!r} axis (make_mesh), got "
                             f"{mesh.shape}; a seed mesh goes to fit_ensemble(seed_mesh=...)")
        if param_sharding_fn is not None:
            if mesh is None:
                raise ValueError("param_sharding_fn lays the parameters out over a mesh: pass "
                                 "mesh=make_mesh(n_data, n_model) (or use_mesh=True)")
            if hp_model_fn is not None:
                raise ValueError("param_sharding_fn does not compose with hp_model_fn lanes")
        self.param_sharding_fn = param_sharding_fn
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None or device is not None
                                     else mesh.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"the mesh's rank runs on {mesh.device}, the Trainer on {self.device}")
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the Trainer on {self.device}")
        self.model = model
        self.lr = float(lr if lr is not None else getattr(model, "lr", 1e-3))
        self.max_epochs = max_epochs
        self.seed = seed
        self.monitor = monitor
        self.callbacks = list(callbacks)
        self.check_finite = check_finite
        self.log_every_n_epochs = int(log_every_n_epochs)
        self.profile_dir = profile_dir
        self.state_every_n_epochs = int(state_every_n_epochs)
        self.shuffle = shuffle
        self.epochs_per_dispatch = int(epochs_per_dispatch)
        self.loss_fn = loss_fn
        self.train_step_fn = train_step_fn
        self.moment_dtype = moment_dtype
        self.hp_model_fn = hp_model_fn
        self.hp_schedule = hp_schedule
        self.ema_decay = ema_decay
        self.lr_schedule = lr_schedule
        self.finite_guard = bool(finite_guard)
        self.grad_accum_steps = int(grad_accum_steps)
        self.grad_clip_norm = float(grad_clip_norm) if grad_clip_norm is not None else None
        self.max_wall_seconds = max_wall_seconds
        self.preempt_signals = tuple(preempt_signals)
        self.hbm_limit_bytes = hbm_limit_bytes
        self._shutdown = None
        self._fit_t0 = None
        self._stop_reason = None
        # a sweep replays each lane on its own CUDA stream (one stream
        # against S: tools/lane_streams.py)
        self._lane_streams = True
        self._plateau_cfg = dict(lr=self.lr, factor=plateau_factor, patience=plateau_patience,
                                 min_lr=plateau_min_lr)
        self._early_patience = early_stopping_patience
        self.plateau = ReduceLROnPlateau(**self._plateau_cfg)
        self.early_stopping = (EarlyStopping(patience=early_stopping_patience)
                               if early_stopping_patience else None)
        # under a mesh rank 0 alone writes logs and checkpoints
        self._writer = mesh is None or mesh.is_writer
        self.metric_logger = MetricLogger(log_dir if self._writer else None)
        self.optimizer: Optional[RiemannianAdam] = None
        self.program: Optional[ChunkProgram] = None  # the last fit's chunk program
        self.lane_programs: list = []  # the last sweep's chunk programs, one a lane
        self._ckpt_mgr = None
        if checkpoint_dir:
            from hyperbolic_vae_tpu_torch.train.checkpoint import CheckpointManager, model_hparams

            self._ckpt_mgr = CheckpointManager(checkpoint_dir, read_only=not self._writer)
            self._ckpt_mgr.model_config = model_hparams(model)

    def _make_optimizer(self, sharded=None) -> RiemannianAdam:
        """Riemannian Adam over the model's parameters, or over a layout's
        masters (their specs recorded as ``param_specs``)."""
        ball = getattr(self.model, "ball", None) or PoincareBall(c=1.0)
        params = self.model.parameters() if sharded is None else sharded.masters
        opt = RiemannianAdam(params, lr=self.plateau.lr, ball=ball,
                             moment_dtype=self.moment_dtype, ema_decay=self.ema_decay)
        if sharded is not None:
            opt.param_specs = sharded.param_specs()
        return opt

    def _shard(self, model):
        """``model`` laid out by ``param_sharding_fn`` over the mesh."""
        from hyperbolic_vae_tpu_torch.parallel.fsdp import ShardedState

        return ShardedState(model, self.param_sharding_fn(model, self.mesh), self.mesh,
                            whole_batch=self._whole_batch())

    def _stage(self, x: np.ndarray) -> torch.Tensor:
        """``x`` on the device as f32; under a mesh padded to a multiple of
        the data axis with its own first rows, as JAX stages it."""
        x = np.ascontiguousarray(x, np.float32)
        if self.mesh is not None:
            rem = x.shape[0] % self.mesh.shape[DATA_AXIS]
            if rem:
                x = np.concatenate([x, x[:self.mesh.shape[DATA_AXIS] - rem]], axis=0)
        return torch.from_numpy(x).to(self.device)

    def _resident(self, x: np.ndarray) -> torch.Tensor:
        """``x`` staged (``_stage``), its rows without the padding."""
        return self._stage(x)[:x.shape[0]]

    def init_params(self, seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Fresh weights for the model's configuration, drawn from ``seed``
        (default: the Trainer's), on the Trainer's device."""
        return init_params_of(self.model, self.seed if seed is None else seed, self.device)

    def _whole_batch(self) -> bool:
        from hyperbolic_vae_tpu_torch.parallel.data_parallel import runs_whole_batch

        return runs_whole_batch(self)

    def _ema_params(self) -> Dict[str, torch.Tensor]:
        ema = self.optimizer.ema_params()
        names = {p: n for n, p in self.model.named_parameters()}
        return {names[p]: e.detach().clone() for p, e in ema.items()}

    def _check_batch(self, dm: ArrayDataModule) -> None:
        if dm.batch_size % self.grad_accum_steps:
            raise ValueError(f"batch_size {dm.batch_size} not divisible by grad_accum_steps "
                             f"{self.grad_accum_steps}")

    # ---- graceful stops and the memory preflight --------------------------

    def _external_stop(self) -> Optional[str]:
        """The graceful-stop reason, or None; checked at chunk boundaries,
        where the resume state is consistent."""
        if self._shutdown is not None and self._shutdown.triggered:
            return f"preemption signal {signal.Signals(self._shutdown.signum).name}"
        if (self.max_wall_seconds is not None and self._fit_t0 is not None
                and time.monotonic() - self._fit_t0 > self.max_wall_seconds):
            return f"wall-clock budget ({self.max_wall_seconds}s) exceeded"
        return None

    @contextlib.contextmanager
    def _graceful_scope(self):
        """Around every fit-like entry point: arms the wall clock and
        installs the preemption handlers while training runs; warns when a
        stop could not save resume state."""
        self._fit_t0 = time.monotonic()
        self._stop_reason = None
        if (self.preempt_signals or self.max_wall_seconds is not None) and not self._ckpt_mgr:
            logger.warning("graceful-stop options (preempt_signals/max_wall_seconds) are set "
                           "but the Trainer has no checkpoint_dir: a stop will NOT save resume "
                           "state")
        if not self.preempt_signals:
            self._shutdown = None
            yield
            return
        from hyperbolic_vae_tpu_torch.train.preemption import GracefulShutdown

        with GracefulShutdown(self.preempt_signals) as shutdown:
            self._shutdown = shutdown
            try:
                yield
            finally:
                self._shutdown = None

    def memory_estimate(self, dm: ArrayDataModule, models: Sequence,
                        stream_rows: Optional[int] = None) -> dict:
        """The memory preflight's bytes, by part: a lower bound, as JAX's HBM
        preflight: the staged splits (shared by the lanes of a sweep; when
        streaming, two blocks of ``stream_rows`` and the val split) and, for
        each model (one a lane), its parameters twice (live and best), the
        optimizer's moments (and EMA) and one microbatch of input,
        reconstruction and gradient. Under ``param_sharding_fn`` what a rank
        holds: its pieces, their moments and best copy, and ``gathered``,
        the working copies its forward reads (with K3 their moments too)."""
        row_bytes = int(np.prod(dm.x_train.shape[1:])) * 4  # staged f32
        # streaming: the two device block buffers at the peak; under a mesh
        # every rank holds the whole split, padded to the data axis
        n_data = self.mesh.shape[DATA_AXIS] if self.mesh is not None else 1
        padded = lambda n: -(-int(n) // n_data) * n_data  # noqa: E731
        train_rows = 2 * int(stream_rows) if stream_rows else padded(dm.x_train.shape[0])
        split = (train_rows + padded(dm.x_val.shape[0])) * row_bytes
        moment = getattr(torch, self.moment_dtype) if isinstance(self.moment_dtype, str) else self.moment_dtype
        p = o = gathered = 0
        for model in models:
            held = self._held_shapes(model)
            p += sum(int(np.prod(held[k][0])) * t.element_size()
                     for k, t in model.state_dict().items())
            for k, t in model.named_parameters():
                n, size = int(np.prod(held[k][0])), t.element_size()
                msize = torch.empty((), dtype=moment).element_size() if moment else size
                o += n * (2 * msize + (4 if self.ema_decay is not None else 0))
                if held[k][1] != held[k][0]:  # the working copy a layout gathers
                    extra = 2 * msize if self.train_step_fn is not None else 0  # K3's moments
                    gathered += int(np.prod(held[k][1])) * (size + extra)
        micro = dm.batch_size // self.grad_accum_steps
        if n_data > 1 and not self._whole_batch():  # this rank's rows of a microbatch
            micro = -(-micro // n_data)
        act = 3 * micro * row_bytes * len(models)  # input + recon + grad floor
        # 2 * p: live + best
        return {"splits": split, "params+best": 2 * p, "opt": o, "gathered": gathered,
                "activations": act, "total": split + 2 * p + o + gathered + act}

    def _held_shapes(self, model) -> Dict[str, tuple]:
        """key -> (the shape a rank holds: its master, the working shape its
        forward reads): the whole shape twice without a layout; under
        ``param_sharding_fn`` the layout's pieces (a whole-batch step reads
        whole tensors, a tensor-parallel layer its 'model' piece)."""
        shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()}
        if self.param_sharding_fn is None:
            return {k: (s, s) for k, s in shapes.items()}
        from hyperbolic_vae_tpu_torch.parallel.mesh import MODEL_AXIS
        from hyperbolic_vae_tpu_torch.parallel.sharding_rules import local_shape

        layout = self.param_sharding_fn(model, self.mesh)
        tp = () if self._whole_batch() else (MODEL_AXIS,)
        return {k: (local_shape(s, layout[k], self.mesh),
                    local_shape(s, layout[k], self.mesh, axes=tp)) for k, s in shapes.items()}

    def _preflight(self, dm: ArrayDataModule, models: Sequence,
                   stream_rows: Optional[int] = None) -> None:
        """Fail before staging when the fit cannot fit in the card's memory
        (``memory_estimate``). The limit is ``hbm_limit_bytes``, else the
        card's memory; on the CPU without ``hbm_limit_bytes`` there is no
        check."""
        limit = self.hbm_limit_bytes
        if limit is None:
            if self.device.type != "cuda":
                return
            limit = torch.cuda.mem_get_info(self.device)[1]
        est = self.memory_estimate(dm, models, stream_rows)
        if est["total"] > limit:
            gib = 2 ** 30
            raise RuntimeError(
                f"CUDA memory preflight: estimated bytes {est['total'] / gib:.2f} GiB exceed the "
                f"card's {limit / gib:.2f} GiB (splits {est['splits'] / gib:.2f} + params+best "
                f"{est['params+best'] / gib:.2f} + opt {est['opt'] / gib:.2f} + activations "
                f"{est['activations'] / gib:.2f} GiB, {len(models)} lane(s)). Use "
                f"fit_streamed(dm, block_rows=...) to keep x_train on the host, "
                f"grad_accum_steps to shrink activations, or sweep fewer lanes at once.")

    @contextlib.contextmanager
    def _profiled(self, on: bool):
        """With ``profile_dir`` and ``on`` (the second chunk: the first
        captures the graphs), torch.profiler over the block, its trace in
        ``profile_dir/trace.json``."""
        if not (on and self.profile_dir and self._writer):
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            yield
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))

    # ---- fit ---------------------------------------------------------------

    def fit(self, dm: ArrayDataModule, params: Optional[Dict[str, Any]] = None,
            resume: bool = False) -> TrainResult:
        """Train ``self.model`` in place (from ``params`` if given) for at
        most ``max_epochs`` epochs; with ``resume`` and a saved resume
        state in ``checkpoint_dir``, continue that fit from its next epoch.
        A graceful stop returns at a chunk boundary with ``interrupted``."""
        with self._graceful_scope():
            return self._fit(dm, params, resume)

    def fit_streamed(self, dm: ArrayDataModule, block_rows: int,
                     params: Optional[Dict[str, Any]] = None, resume: bool = False,
                     reshuffle: str = "block_order") -> TrainResult:
        """``fit`` for a train split that does not fit in the card's memory:
        ``dm.x_train`` (numpy or ``np.memmap``) stays on the host and
        streams through the device in double-buffered blocks of
        ``block_rows`` rows (``train/streaming.py``); ``reshuffle="rows"``
        re-deals the rows to blocks every epoch. Controllers, checkpoints,
        resume, callbacks and graceful stops are ``fit``'s; with
        ``block_rows == n_train`` the history is ``fit``'s bit for bit. Not
        with ``epochs_per_dispatch > 1`` (an epoch is already J dispatches)
        or ``hp_model_fn`` lanes. ``x_val`` stays on the device. Under a
        mesh every rank streams the same blocks and trains on its rows of
        each batch; ``block_rows`` must divide by the data axis, as in JAX."""
        from hyperbolic_vae_tpu_torch.train.streaming import check_blocks

        if self.epochs_per_dispatch > 1:
            raise ValueError("fit_streamed does not compose with epochs_per_dispatch>1")
        if self.hp_model_fn is not None:
            raise ValueError("fit_streamed does not compose with hp_model_fn lanes")
        self._check_batch(dm)
        if self.mesh is not None and int(block_rows) % self.mesh.shape[DATA_AXIS]:
            raise ValueError("block_rows must shard evenly over the mesh 'data' axis")
        check_blocks(int(dm.x_train.shape[0]), dm.batch_size, int(block_rows), reshuffle)
        with self._graceful_scope():
            return self._fit(dm, params, resume, blocks=(int(block_rows), reshuffle))

    def _fit(self, dm: ArrayDataModule, params, resume: bool, blocks=None) -> TrainResult:
        if self.hp_model_fn is not None:
            raise ValueError(
                "hp_model_fn trainers sweep hyperparameter lanes: use fit_lane_sweep (a "
                "generic hp_schedule composes with the lanes there); for a single scheduled "
                "model use Trainer(beta_schedule=...)")
        self._check_batch(dm)
        state = meta = None
        if resume and self._ckpt_mgr is not None:
            state, meta = self._ckpt_mgr.restore_state(device=self.device)
        self._preflight(dm, [self.model], stream_rows=blocks[0] if blocks else None)
        x_train = self._resident(dm.x_train) if blocks is None else dm.x_train
        run = _Run(self, dm.batch_size, x_train, self._resident(dm.x_val), params, state, meta,
                   blocks=blocks)
        try:
            if state is not None:
                logger.info("resumed from epoch %d", run.start_epoch)
            self.metric_logger.log_hparams({
                "model": self.model, "lr": self.lr, "batch_size": dm.batch_size,
                "max_epochs": self.max_epochs, "dataset": dm.name,
            })
            with run.whole_model():
                for cb in self.callbacks:
                    if hasattr(cb, "on_fit_start"):
                        cb.on_fit_start(self, dm)
            result = self._fit_chunked(run)
            if self.mesh is not None:  # rank 0's files are written for every rank
                self.mesh.barrier()
            return result
        finally:
            run.close()

    def _fit_chunked(self, run: _Run) -> TrainResult:
        """The chunk loop: the host logs, checkpoints and calls back at
        chunk boundaries and saves the resume state on the
        ``state_every_n_epochs`` cadence and at every stop and the end; the
        tail chunk is cut so training never runs past ``max_epochs``; the
        first chunk (capture and warm-up on the card) is left out of
        ``samples_per_sec``."""
        k, prog = self.epochs_per_dispatch, run.prog
        total_samples, t_start = 0, None
        for n, chunk_start in enumerate(range(run.start_epoch, self.max_epochs, k)):
            with self._profiled(n == 1):
                rows, ctrl = prog.run(min(k, self.max_epochs - chunk_start))
            if t_start is None:
                t_start = time.perf_counter()
            else:
                total_samples += run.samples_per_epoch * (ctrl["epoch"] - chunk_start)
            best_row = run.absorb(rows, ctrl)
            stop = run.stopped
            if stop:
                logger.info("early stopping at epoch %d", run.epochs_run - 1)
            if self._ckpt_mgr is not None and best_row is not None:
                # the device's best epoch must be the host's reading of the history
                if ctrl["best_epoch"] != best_row[0]:
                    raise RuntimeError(f"best epoch {ctrl['best_epoch']} on the device, "
                                       f"{best_row[0]} in the history")
                self._ckpt_mgr.save_best(best_row[0], run.full(prog.best), best_row[1])
            if self.callbacks:
                with run.whole_model():
                    live = self.model.state_dict()
                    for cb in self.callbacks:
                        if hasattr(cb, "on_epoch_end"):
                            cb.on_epoch_end(self, run.epochs_run - 1, live,
                                            run.history[-1] if run.history else {})
            # a completed run is never interrupted
            done = run.epochs_run >= self.max_epochs
            reason = None if done else self._external_stop()
            if self.mesh is not None and not done and (self.preempt_signals
                                                       or self.max_wall_seconds is not None):
                # every rank stops at the same chunk
                if self.mesh.any(reason is not None) and reason is None:
                    reason = "another rank of the mesh stopped"
            n_state = self.state_every_n_epochs
            cadence = run.epochs_run // n_state > chunk_start // n_state
            if self._ckpt_mgr is not None and (cadence or stop or reason or done):
                self._save_resume_state(run, run.epochs_run - 1)
            if stop:
                break
            if reason:
                self._stop_reason = reason
                logger.warning("graceful stop after epoch %d: %s", run.epochs_run - 1, reason)
                break
        if self._ckpt_mgr is not None and run.epochs_run > run.start_epoch:
            self._ckpt_mgr.save_last(run.epochs_run - 1, run.full_params(), run.history[-1])
            if self.ema_decay is not None:
                self._ckpt_mgr.save_named("ema", run.ema_params(),
                                          {"epoch": run.epochs_run - 1, "ema_decay": self.ema_decay})
        elapsed = time.perf_counter() - t_start if t_start is not None else 0.0
        self.metric_logger.close()
        return run.result(total_samples / elapsed if total_samples else 0.0, self._stop_reason)

    def _save_resume_state(self, run: _Run, epoch: int) -> None:
        """The resume unit of ``run`` after ``epoch`` (``fit(resume=True)``
        continues from it)."""
        state, meta = run.resume_state()
        self._ckpt_mgr.save_state(state, dict(meta, epoch=epoch))

    # ---- sweeps ------------------------------------------------------------

    def fit_ensemble(self, dm: ArrayDataModule, seeds: Sequence[int],
                     epochs_per_dispatch: Optional[int] = None, seed_mesh=None,
                     resume: bool = False) -> list:
        """One model per seed, each a lane of one sweep
        (``train/ensemble.py``): a ``TrainResult`` per seed, each what
        ``fit(dm, params=init_params(seed))`` with ``seed`` gives, bit for
        bit. Resumable and stoppable as ``fit``."""
        from hyperbolic_vae_tpu_torch.train.ensemble import fit_ensemble

        self._refuse_layout("fit_ensemble")
        with self._graceful_scope():
            return fit_ensemble(self, dm, seeds, epochs_per_dispatch, seed_mesh=seed_mesh,
                                resume=resume)

    def fit_lane_sweep(self, dm: ArrayDataModule, lanes: Sequence[dict],
                       epochs_per_dispatch: Optional[int] = None, seed_mesh=None,
                       resume: bool = False) -> list:
        """Hyperparameter lanes: each dict of scalars (curvature, beta, ...,
        and the reserved ``seed`` and ``lr``) trains its own
        ``hp_model_fn(lane)`` model (``train/ensemble.py``)."""
        if self.lr_schedule is not None and any("lr" in lane for lane in lanes):
            # one schedule would override every lane's lr: the sweep's point
            raise ValueError("lr_schedule does not compose with per-lane lr sweeps")
        from hyperbolic_vae_tpu_torch.train.ensemble import fit_lane_sweep

        self._refuse_layout("fit_lane_sweep")
        with self._graceful_scope():
            return fit_lane_sweep(self, dm, lanes, epochs_per_dispatch, seed_mesh=seed_mesh,
                                  resume=resume)

    def _refuse_layout(self, what: str) -> None:
        if self.param_sharding_fn is not None:
            raise ValueError(f"{what} trains whole lanes (a seed mesh spreads them over ranks); "
                             f"it does not compose with param_sharding_fn")

    # ---- after training ----------------------------------------------------

    def evaluate(self, dm: ArrayDataModule, params: Optional[Dict[str, Any]] = None,
                 split: str = "test", stream_block_rows: Optional[int] = None) -> dict:
        """Mean loss metrics over a split (``train/evaluation.py``); under a
        schedule at ``hp_schedule(max_epochs)``. ``stream_block_rows``: a
        host split copied to the device a block of that many rows at a
        time."""
        from hyperbolic_vae_tpu_torch.train.evaluation import evaluate

        return evaluate(self, dm, params, split, stream_block_rows)

    def evaluate_iwae(self, dm: ArrayDataModule, params: Optional[Dict[str, Any]] = None,
                      k: int = 5000, split: str = "test", batch_chunk: int = 256,
                      k_chunk: int = 500) -> float:
        """Mean K-importance-weighted log p(x) bound over a split
        (``train/evaluation.py``)."""
        from hyperbolic_vae_tpu_torch.train.evaluation import evaluate_iwae

        return evaluate_iwae(self, dm, params, k, split, batch_chunk, k_chunk)

    def evaluate_probe(self, dm: ArrayDataModule, params: Optional[Dict[str, Any]] = None,
                       k: int = 10, train_split: str = "train", eval_split: str = "test",
                       max_train: int = 20000) -> dict:
        """Latent-probe accuracies (``train/evaluation.py``)."""
        from hyperbolic_vae_tpu_torch.train.evaluation import evaluate_probe

        return evaluate_probe(self, dm, params, k, train_split, eval_split, max_train)

    def encode_split(self, dm: ArrayDataModule, params: Optional[Dict[str, Any]] = None,
                     split: str = "val", batch_size: Optional[int] = None):
        """Posterior means and labels of a split (``train/evaluation.py``)."""
        from hyperbolic_vae_tpu_torch.train.evaluation import encode_split

        return encode_split(self, dm, params, split, batch_size)
