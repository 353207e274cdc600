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
sets the model's KL weight per epoch. The host, at chunk boundaries,
logs (every ``log_every_n_epochs``), checkpoints (``checkpoint_dir``:
best, last, ``ema``, and the resume state that ``fit(resume=True)``
continues from) and calls ``callbacks`` (``train/callbacks.py``). After
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
``params``. Still to port:
ensembles and lanes, streaming, preemption, meshes, the memory
preflight, TensorBoard, ``profile_dir``, ``evaluate(stream_block_rows=...)``.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import math
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule
from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.optim import EarlyStopping, ReduceLROnPlateau, RiemannianAdam
from hyperbolic_vae_tpu_torch.train.chunk_program import ChunkProgram
from hyperbolic_vae_tpu_torch.train.epoch_program import default_loss_fn
from hyperbolic_vae_tpu_torch.train.metrics import MetricLogger

logger = logging.getLogger(__name__)


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


def _snapshot(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


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
        shuffle: str = "row",  # "row" (fresh permutation) | "block" (random windows)
        epochs_per_dispatch: int = 1,  # K: epochs a chunk runs before the host looks
        loss_fn: Optional[Callable] = None,  # fn(model, batch, generator) -> metrics
        train_step_fn: Optional[Callable] = None,  # fn(model, optimizer, batch, generator) -> metrics
        moment_dtype=None,  # storage type of both Adam moments, e.g. "bfloat16"; math in f32
        beta_schedule: Optional[Callable] = None,  # fn(epoch) -> beta, e.g. beta_warmup_schedule
        ema_decay: Optional[float] = None,  # an EMA of the parameters (TrainResult.ema_params)
        lr_schedule: Optional[Callable] = None,  # fn(epoch) -> lr; replaces the plateau lr
        finite_guard: bool = True,  # skip a step whose loss or gradient is not finite (default step)
        grad_accum_steps: int = 1,  # A > 1: each step sums the gradients of A microbatches of batch/A rows
        grad_clip_norm: Optional[float] = None,  # clip the gradients to this global L2 norm
        device: DeviceLike = None,
    ):
        if shuffle not in ("row", "block"):
            raise ValueError(f"shuffle must be 'row' or 'block', got {shuffle!r}")
        if epochs_per_dispatch < 1:
            raise ValueError(f"epochs_per_dispatch must be >= 1, got {epochs_per_dispatch}")
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
            if loss_fn is not None or train_step_fn is not None:
                raise ValueError("beta_schedule does not compose with loss_fn/train_step_fn")
            if not hasattr(model, "beta"):
                raise ValueError(f"beta_schedule requires a model with a beta attribute "
                                 f"(got {type(model).__name__})")
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
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
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
        self.shuffle = shuffle
        self.epochs_per_dispatch = int(epochs_per_dispatch)
        self.loss_fn = loss_fn
        self.train_step_fn = train_step_fn
        self.moment_dtype = moment_dtype
        self.beta_schedule = beta_schedule
        self.ema_decay = ema_decay
        self.lr_schedule = lr_schedule
        self.finite_guard = bool(finite_guard)
        self.grad_accum_steps = int(grad_accum_steps)
        self.grad_clip_norm = float(grad_clip_norm) if grad_clip_norm is not None else None
        self._plateau_cfg = dict(lr=self.lr, factor=plateau_factor, patience=plateau_patience,
                                 min_lr=plateau_min_lr)
        self._early_patience = early_stopping_patience
        self.plateau = ReduceLROnPlateau(**self._plateau_cfg)
        self.early_stopping = (EarlyStopping(patience=early_stopping_patience)
                               if early_stopping_patience else None)
        self.metric_logger = MetricLogger(log_dir)
        self.optimizer: Optional[RiemannianAdam] = None
        self.program: Optional[ChunkProgram] = None  # the last fit's chunk program
        self._ckpt_mgr = None
        if checkpoint_dir:
            from hyperbolic_vae_tpu_torch.train.checkpoint import CheckpointManager, model_hparams

            self._ckpt_mgr = CheckpointManager(checkpoint_dir)
            self._ckpt_mgr.model_config = model_hparams(model)

    def _make_optimizer(self) -> RiemannianAdam:
        ball = getattr(self.model, "ball", None) or PoincareBall(c=1.0)
        return RiemannianAdam(self.model.parameters(), lr=self.plateau.lr, ball=ball,
                              moment_dtype=self.moment_dtype, ema_decay=self.ema_decay)

    def _stage(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def init_params(self, seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Fresh weights for the model's configuration, drawn from ``seed``
        (default: the Trainer's), on the Trainer's device."""
        g = torch.Generator().manual_seed(self.seed if seed is None else seed)
        fresh = type(self.model)(**self.model.hparams(), generator=g, device="cpu")
        return {k: v.to(self.device) for k, v in fresh.state_dict().items()}

    def _ema_params(self) -> Dict[str, torch.Tensor]:
        ema = self.optimizer.ema_params()
        names = {p: n for n, p in self.model.named_parameters()}
        return {names[p]: e.detach().clone() for p, e in ema.items()}

    def fit(self, dm: ArrayDataModule, params: Optional[Dict[str, Any]] = None,
            resume: bool = False) -> TrainResult:
        """Train ``self.model`` in place (from ``params`` if given) for at
        most ``max_epochs`` epochs; with ``resume`` and a saved resume
        state in ``checkpoint_dir``, continue that fit from its next epoch."""
        self.plateau = ReduceLROnPlateau(**self._plateau_cfg)
        if self._early_patience:
            self.early_stopping = EarlyStopping(patience=self._early_patience)
        if params is not None:
            self.model.load_state_dict(params)
        if dm.batch_size % self.grad_accum_steps:
            raise ValueError(f"batch_size {dm.batch_size} not divisible by grad_accum_steps "
                             f"{self.grad_accum_steps}")
        self.optimizer = self._make_optimizer()
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        x_train, x_val = self._stage(dm.x_train), self._stage(dm.x_val)
        state = None
        if resume and self._ckpt_mgr is not None:
            state, meta = self._ckpt_mgr.restore_state(device=self.device)
        start_epoch = 0
        if state is not None:
            start_epoch = int(meta["epoch"]) + 1
            self.model.load_state_dict(state["params"])
            self.optimizer.load_state_dict(state["optimizer"])
            gen.set_state(state["generator"].cpu())
            self.plateau.lr, self.plateau.best = meta["plateau_lr"], meta["plateau_best"]
            self.plateau.num_bad_epochs = meta["plateau_bad"]
            if self.early_stopping:
                self.early_stopping.best, self.early_stopping.wait = meta["early_best"], meta["early_wait"]
            logger.info("resumed from epoch %d", start_epoch)
        static_beta = getattr(self.model, "beta", None)
        beta = None
        if self.beta_schedule is not None:
            # a 0-d tensor the chunk program writes per epoch (a float would
            # be frozen into a captured graph); the float comes back after
            beta = torch.zeros((), dtype=torch.float32, device=self.device)
            self.model.beta = beta
        try:
            prog = ChunkProgram(self, self.model, self.optimizer, x_train, x_val, dm.batch_size,
                                gen, start_epoch, loss_fn=self.loss_fn or default_loss_fn, beta=beta)
            self.program = prog
            if state is not None:
                prog.load_state_dict(state["chunk"])
            self.metric_logger.log_hparams({
                "model": self.model, "lr": self.lr, "batch_size": dm.batch_size,
                "max_epochs": self.max_epochs, "dataset": dm.name,
            })
            for cb in self.callbacks:
                if hasattr(cb, "on_fit_start"):
                    cb.on_fit_start(self, dm)
            best = float(state["chunk"]["ctrl"]["best_val"]) if state is not None else math.inf
            return self._fit_chunked(prog, gen, x_train.shape[0] // dm.batch_size * dm.batch_size,
                                     start_epoch, best)
        finally:
            if beta is not None:
                self.model.beta = static_beta

    def _fit_chunked(self, prog: ChunkProgram, gen, samples_per_epoch: int,
                     start_epoch: int, best_metric: float) -> TrainResult:
        """The chunk loop: the host logs, checkpoints and calls back at
        chunk boundaries; the tail chunk is cut so training never runs past
        ``max_epochs``; the first chunk (capture and warm-up on the card)
        is left out of ``samples_per_sec``."""
        k = self.epochs_per_dispatch
        history: list = []
        total_samples, t_start = 0, None
        epochs_run = start_epoch
        for chunk_start in range(start_epoch, self.max_epochs, k):
            k_eff = min(k, self.max_epochs - chunk_start)
            rows, ctrl = prog.run(k_eff)
            if t_start is None:
                t_start = time.perf_counter()
            else:
                total_samples += samples_per_epoch * (ctrl["epoch"] - chunk_start)
            stop = ctrl["stopped"]
            # the host controllers mirror the device's (resume metadata)
            self.plateau.lr, self.plateau.best = ctrl["pl_lr"], ctrl["pl_best"]
            self.plateau.num_bad_epochs = ctrl["pl_bad"]
            if self.early_stopping:
                self.early_stopping.best, self.early_stopping.wait = ctrl["es_best"], ctrl["es_wait"]
                self.early_stopping.stopped = stop
            best_row = None
            for i in range(ctrl["epoch"] - chunk_start):
                epoch = chunk_start + i
                metrics = prog.row_metrics(rows[i])
                metrics["epoch"] = epoch
                history.append(metrics)
                epochs_run = epoch + 1
                if epoch % self.log_every_n_epochs == 0:
                    self.metric_logger.log_scalars(epoch, metrics)
                if self.check_finite and not np.isfinite(metrics["train/loss_total"]):
                    logger.warning("non-finite train loss at epoch %d", epoch)
                mon = metrics[self.monitor]
                if np.isfinite(mon) and mon < best_metric:
                    best_metric, best_row = mon, (epoch, metrics)
            if stop:
                logger.info("early stopping at epoch %d", epochs_run - 1)
            if self._ckpt_mgr is not None:
                if best_row is not None:
                    # the device's best epoch must be the host's reading of the history
                    if ctrl["best_epoch"] != best_row[0]:
                        raise RuntimeError(f"best epoch {ctrl['best_epoch']} on the device, "
                                             f"{best_row[0]} in the history")
                    self._ckpt_mgr.save_best(best_row[0], prog.best, best_row[1])
                self._save_resume_state(prog, gen, epochs_run - 1)
            for cb in self.callbacks:
                if hasattr(cb, "on_epoch_end"):
                    cb.on_epoch_end(self, epochs_run - 1, self.model.state_dict(),
                                    history[-1] if history else {})
            if stop:
                break
        if self._ckpt_mgr is not None and epochs_run > start_epoch:
            self._ckpt_mgr.save_last(epochs_run - 1, self.model.state_dict(), history[-1])
            if self.ema_decay is not None:
                self._ckpt_mgr.save_named("ema", self._ema_params(),
                                          {"epoch": epochs_run - 1, "ema_decay": self.ema_decay})
        elapsed = time.perf_counter() - t_start if t_start is not None else 0.0
        self.metric_logger.close()
        return TrainResult(
            params=_snapshot(self.model),
            best_params={k: v.clone() for k, v in prog.best.items()},
            history=history,
            best_metric=best_metric,
            epochs_run=epochs_run,
            samples_per_sec=total_samples / elapsed if total_samples else 0.0,
            ema_params=self._ema_params() if self.ema_decay is not None else None,
        )

    def _save_resume_state(self, prog: ChunkProgram, gen, epoch: int) -> None:
        """Parameters, optimizer, the device's controllers and best params,
        the generator; the host controllers' mirrors in the metadata."""
        es = self.early_stopping
        self._ckpt_mgr.save_state(
            {"params": _snapshot(self.model), "optimizer": copy.deepcopy(self.optimizer.state_dict()),
             "chunk": prog.state_dict(), "generator": gen.get_state()},
            {"epoch": epoch, "plateau_lr": self.plateau.lr, "plateau_best": self.plateau.best,
             "plateau_bad": self.plateau.num_bad_epochs,
             "early_best": es.best if es else math.inf, "early_wait": es.wait if es else 0})

    def evaluate(self, dm: ArrayDataModule, params: Optional[Dict[str, Any]] = None,
                 split: str = "test") -> dict:
        """Mean loss metrics over a split (``train/evaluation.py``); under a
        ``beta_schedule`` at ``beta_schedule(max_epochs)``."""
        from hyperbolic_vae_tpu_torch.train.evaluation import evaluate

        return evaluate(self, dm, params, split)

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
