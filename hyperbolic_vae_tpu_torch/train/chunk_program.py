"""The K-epochs-per-dispatch chunk program and its controllers on the
device.

Port of ``hyperbolic_vae_tpu/train/chunk_program.py``. One chunk runs K
epochs of (train epoch + full val eval + best-params tracking +
ReduceLROnPlateau + EarlyStopping) with no host sync; the host fetches
the chunk's metric rows and the controller state in one transfer at its
end. The controllers live in 0-d device tensors (``init_ctrl``) and step
with ``torch.where`` exactly as JAX's in-graph ones (f32 comparisons, the
relative plateau threshold, reductions only, a step only on a finite
monitor), so histories are bit-identical for every K.

Epoch by epoch, in pieces (``train/cuda_graph.py`` captures them):

  * ``begin_epoch``: lr = ``lr_schedule(epoch)`` if set, else the plateau
    lr, written into the optimizer's lr tensor (which K3 reads on the
    device) and kept for the history; each key of the hyperparameter
    schedule (``beta_schedule``, ``hp_schedule``) into the model's tensor
    of that name; a copy of the state a stopped epoch restores; then the
    epoch program's ``begin``;
  * the epoch program's train steps and val batches;
  * ``end_epoch``: masked skip, as JAX's production default (an epoch
    after an in-graph stop runs, then its parameters, optimizer state and
    metric row are put back / set to NaN); best params by ``torch.where``
    into static buffers; the controllers; the epoch counter + 1 unless
    stopped (after a stop it freezes, which is how the host learns how
    many epochs ran); the epoch's row (train means, val means, lr) into
    the chunk's rows.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.optim.schedules import _f32
from hyperbolic_vae_tpu_torch.parallel.data_parallel import row_shard
from hyperbolic_vae_tpu_torch.train import tracing
from hyperbolic_vae_tpu_torch.train.cuda_graph import GraphedProgram, Segment
from hyperbolic_vae_tpu_torch.train.epoch_program import EpochProgram, NanCheck

# name -> dtype of each controller tensor, in the order the host fetches them
CTRL_FIELDS = (
    ("best_val", torch.float32), ("best_epoch", torch.int32), ("epoch", torch.int32),
    ("pl_lr", torch.float32), ("pl_best", torch.float32), ("pl_bad", torch.int32),
    ("es_best", torch.float32), ("es_wait", torch.int32), ("stopped", torch.bool),
)


class ControllerConfig(NamedTuple):
    pl_factor: float  # f32 values, as JAX's weak-typed constants
    pl_min_lr: float
    pl_patience: int
    pl_keep: float  # 1 - the plateau's relative threshold
    es_enabled: bool
    es_patience: int
    es_min_delta: float

    @classmethod
    def of(cls, trainer) -> "ControllerConfig":
        cfg, es = trainer._plateau_cfg, trainer.early_stopping
        return cls(_f32(cfg["factor"]), _f32(cfg["min_lr"]), int(cfg["patience"]),
                   _f32(1.0 - trainer.plateau.threshold), trainer._early_patience is not None,
                   int(trainer._early_patience or 0), _f32(es.min_delta) if es else 0.0)


def init_ctrl(trainer, start_epoch: int, device) -> Dict[str, torch.Tensor]:
    """The controllers' and best tracking's state as 0-d device tensors,
    seeded from the Trainer's host controllers (JAX ``init_ctrl``)."""
    es = trainer.early_stopping
    values = dict(
        best_val=float("inf"), best_epoch=-1, epoch=start_epoch, pl_lr=trainer.plateau.lr,
        pl_best=trainer.plateau.best, pl_bad=trainer.plateau.num_bad_epochs,
        es_best=es.best if es else float("inf"), es_wait=es.wait if es else 0, stopped=False,
    )
    return {k: torch.tensor(values[k], dtype=dt, device=device) for k, dt in CTRL_FIELDS}


@torch.no_grad()
def step_controllers(ctrl: Dict[str, torch.Tensor], mon: torch.Tensor, active: torch.Tensor,
                     cfg: ControllerConfig) -> torch.Tensor:
    """One epoch of the controllers on the monitored value ``mon`` (0-d
    f32), in place, as JAX's chunk body: best tracking, ReduceLROnPlateau
    (mode min, relative threshold, reductions only), early stopping, each
    stepping only where ``mon`` is finite and the fit ``active``; the epoch
    counter + 1 where active. Returns ``better`` (0-d bool): this epoch is
    the new best."""
    c = ctrl
    finite = torch.isfinite(mon) & active
    better = finite & (mon < c["best_val"])
    c["best_epoch"].copy_(torch.where(better, c["epoch"], c["best_epoch"]))
    c["best_val"].copy_(torch.where(better, mon, c["best_val"]))
    improved = mon < c["pl_best"] * cfg.pl_keep
    pl_best = torch.where(improved, mon, c["pl_best"])
    pl_bad = torch.where(improved, 0, c["pl_bad"] + 1)
    trip = pl_bad > cfg.pl_patience
    # reductions only: an lr below min_lr is never raised to it
    cand = torch.clamp_min(c["pl_lr"] * cfg.pl_factor, cfg.pl_min_lr)
    pl_lr = torch.where(trip & (cand < c["pl_lr"]), cand, c["pl_lr"])
    pl_bad = torch.where(trip, 0, pl_bad)
    c["pl_best"].copy_(torch.where(finite, pl_best, c["pl_best"]))
    c["pl_bad"].copy_(torch.where(finite, pl_bad, c["pl_bad"]))
    c["pl_lr"].copy_(torch.where(finite, pl_lr, c["pl_lr"]))
    if cfg.es_enabled:
        es_improved = mon < c["es_best"] - cfg.es_min_delta
        es_best = torch.where(es_improved, mon, c["es_best"])
        es_wait = torch.where(es_improved, 0, c["es_wait"] + 1)
        c["es_best"].copy_(torch.where(finite, es_best, c["es_best"]))
        c["es_wait"].copy_(torch.where(finite, es_wait, c["es_wait"]))
        c["stopped"].copy_(c["stopped"] | (finite & (es_wait >= cfg.es_patience)))
    # the stop epoch itself counts as run
    c["epoch"].add_(active.to(torch.int32))
    return better


class ChunkProgram:
    """The fit's device state (the epoch program, the controllers, best
    params, the chunk's rows) and ``run(k)``, which runs k epochs and
    returns their rows and the controller state, fetched once.

    ``segments``: on the K3 path (``train_step_fn``) the whole train epoch
    is one segment, so one graph per epoch; on the autograd paths one
    step is a segment replayed ``steps`` times. One full val batch is a
    segment replayed ``eval_steps`` times, then the tail and the epoch's
    end."""

    def __init__(self, trainer, model, optimizer, x_train, x_val, batch_size: int, generator,
                 start_epoch: int, *, loss_fn, hp: Optional[Dict[str, torch.Tensor]] = None,
                 stream: Optional[torch.cuda.Stream] = None, sharded=None):
        self.trainer, self.optimizer = trainer, optimizer
        dev = x_train.device
        self.device = dev
        # under a parameter layout (parallel/fsdp.py) the program tracks the
        # layout's masters, and a whole-batch step runs on gathered tensors
        self.sharded = sharded
        step_fn = trainer.train_step_fn
        if sharded is not None and step_fn is not None:
            step_fn = sharded.wrap_train_step(step_fn, optimizer)
        self.ctrl = init_ctrl(trainer, start_epoch, dev)
        self.ep = EpochProgram(
            model, optimizer, x_train, x_val, batch_size, generator, shuffle=trainer.shuffle,
            loss_fn=loss_fn, train_step_fn=step_fn,
            finite_guard=trainer.finite_guard, grad_accum_steps=trainer.grad_accum_steps,
            grad_clip_norm=trainer.grad_clip_norm, shard=row_shard(trainer, batch_size),
            layout=sharded,
            nan_check=NanCheck(self.ctrl["epoch"]) if trainer.debug_nans else None)
        self.params = sharded.master_state() if sharded is not None else dict(model.state_dict())
        self.best = {k: v.detach().clone() for k, v in self.params.items()}
        self.hp = dict(hp or {})  # scheduled key -> the model's 0-d tensor
        self.stream = stream
        # what an epoch after a stop puts back: params, moments, EMA, count
        opt_state = [t for p in optimizer.state.values() for t in p.values()]
        self.masked = list(self.params.values()) + opt_state + [optimizer.count]
        self.prev = [t.detach().clone() for t in self.masked]
        self.lr_used = torch.zeros((), dtype=torch.float32, device=dev)
        self.krow = torch.zeros((), dtype=torch.long, device=dev)
        self.k_max = trainer.epochs_per_dispatch
        self.rows = None  # (k_max, n_train + n_val + 1), allocated at the first end_epoch
        self.mon_src, _, self.mon_key = trainer.monitor.partition("/")
        self.mon_idx = None
        self.cfg = ControllerConfig.of(trainer)

        ep = self.ep
        end = (ep.val_tail,) if ep.rem else ()
        segments = self._train_segments() + [
            Segment((ep.val_step,), ep.eval_steps, "val batch"),
            Segment(end + (ep.end_val, self.end_epoch), 1, "val tail and epoch end")]
        state = (self.masked + [g["lr"] for g in optimizer.param_groups] + list(self.ctrl.values())
                 + list(self.best.values()) + [self.krow] + list(self.hp.values())
                 + (sharded.working_copies if sharded is not None else []))
        # under a mesh the step's all-reduce is captured too; NCCL's watchdog
        # thread queries events meanwhile, which a global capture forbids
        self.program = GraphedProgram(
            segments, device=dev, generator=generator, state=state, capture_stream=stream,
            capture_error_mode="thread_local" if trainer.mesh is not None else "global")

    def _train_segments(self) -> list:
        ep = self.ep
        if self.trainer.train_step_fn is not None:
            return [Segment((self.begin_epoch, *(ep.step,) * ep.steps, ep.end_train), 1,
                            "train epoch")]
        return [Segment((self.begin_epoch,), 1, "begin epoch"),
                Segment((ep.step,), ep.steps, "train step"),
                Segment((ep.end_train,), 1, "train means")]

    @property
    def samples_per_epoch(self) -> int:
        return self.ep.steps * self.ep.batch_size

    # ---- pieces ---------------------------------------------------------

    def begin_epoch(self) -> None:
        self.begin_controls()
        self.ep.begin()

    def begin_controls(self) -> None:
        """``begin_epoch`` up to the epoch program's ``begin``."""
        c, tr = self.ctrl, self.trainer
        lr = tr.lr_schedule(c["epoch"]) if tr.lr_schedule is not None else c["pl_lr"]
        self.lr_used.copy_(lr)
        self.optimizer.set_lr(self.lr_used)
        if self.hp:
            values = tr.hp_schedule(c["epoch"])
            for name, t in self.hp.items():
                t.copy_(values[name])
        with torch.no_grad():
            for prev, cur in zip(self.prev, self.masked):
                prev.copy_(cur)

    @torch.no_grad()
    def end_epoch(self) -> None:
        ep, c = self.ep, self.ctrl
        if self.rows is None:
            self._bind_names()
        active = ~c["stopped"]
        for cur, prev in zip(self.masked, self.prev):
            cur.copy_(torch.where(active, cur, prev))
        t = torch.where(active, ep.t_means, float("nan"))
        v = torch.where(active, ep.v_means, float("nan"))
        mon = (t if self.mon_src == "train" else v)[self.mon_idx]
        better = step_controllers(c, mon, active, self.cfg)
        for name, b in self.best.items():
            b.copy_(torch.where(better, self.params[name], b))
        row = torch.cat([t, v, self.lr_used.view(1)])
        self.rows.index_copy_(0, self.krow.view(1), row.view(1, -1))
        self.krow.add_(1)

    def _bind_names(self) -> None:
        ep = self.ep
        names = ep.t_names if self.mon_src == "train" else ep.v_names
        if self.mon_key not in names:
            keys = [f"train/{k}" for k in ep.t_names] + [f"val/{k}" for k in ep.v_names]
            raise KeyError(f"monitor {self.trainer.monitor!r} not among the metrics {sorted(keys)}")
        self.mon_idx = names.index(self.mon_key)
        self.rows = torch.zeros((self.k_max, len(ep.t_names) + len(ep.v_names) + 1),
                                dtype=torch.float32, device=self.device)

    # ---- the host's side ------------------------------------------------

    def on_stream(self):
        """The program's stream as the current one (a no-op without one)."""
        return contextlib.nullcontext() if self.stream is None else torch.cuda.stream(self.stream)

    def _after_caller(self) -> None:
        """The program's stream waits for what the caller's stream queued
        (staging, a restored state)."""
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def prepare(self) -> None:
        """Capture the program's graphs on its stream now (on the card);
        the caller's stream then waits for the state the capture put back."""
        self._after_caller()
        with self.on_stream():
            self.program.capture()
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def issue_steps(self, k: int):
        """Queue k (<= epochs_per_dispatch) epochs, waiting for nothing, one
        graph replay (one segment's pieces, eager) a ``next()``; the caller
        makes each on ``on_stream()``. A sweep takes its lanes' steps in
        turn."""
        self._after_caller()

        def steps():
            self.krow.zero_()
            for _ in range(k):
                yield from self.program.replays()

        return steps()

    def fetch(self, k: int):
        """The queued chunk's results in one transfer: (rows (k, n_cols)
        float64 numpy, the controllers as Python numbers)."""
        self._after_caller()
        with self.on_stream():
            ctrl = torch.stack([self.ctrl[name].double() for name, _ in CTRL_FIELDS])
            flat = torch.cat([self.rows[:k].double().reshape(-1), ctrl]).cpu().numpy()
        rows = flat[:-len(CTRL_FIELDS)].reshape(k, -1)
        host = {}
        for (name, dt), val in zip(CTRL_FIELDS, flat[-len(CTRL_FIELDS):]):
            host[name] = bool(val) if dt == torch.bool else (int(val) if dt == torch.int32 else float(val))
        return rows, host

    def run(self, k: int):
        """k epochs queued (``issue_steps``), then ``fetch(k)``. While a fit
        records (``train/tracing.py``), the spans ``chunk.issue`` and
        ``chunk.fetch``; the previous chunk's spans on the card are read
        between them, while the card runs this one."""
        with tracing.span("chunk.issue"):
            steps = self.issue_steps(k)
            with self.on_stream():
                for _ in steps:
                    pass
        rec = tracing.current
        if rec is not None:
            rec.read_queued()
        with tracing.span("chunk.fetch"):
            out = self.fetch(k)
        if rec is not None:
            rec.anchor()
        return out

    def row_metrics(self, row: np.ndarray) -> dict:
        ep = self.ep
        n_t = len(ep.t_names)
        out = {f"train/{k}": float(v) for k, v in zip(ep.t_names, row[:n_t])}
        out.update({f"val/{k}": float(v) for k, v in zip(ep.v_names, row[n_t:-1])})
        out["lr"] = float(row[-1])
        return out

    # ---- resume state ---------------------------------------------------

    def state_dict(self) -> dict:
        """The controllers and the best parameters (whole, under a layout:
        a collective)."""
        best = (self.sharded.full(self.best) if self.sharded is not None
                else {k: v.clone() for k, v in self.best.items()})
        return {"ctrl": {k: v.clone() for k, v in self.ctrl.items()}, "best": best}

    def load_state_dict(self, state: dict) -> None:
        for k, v in state["ctrl"].items():
            self.ctrl[k].copy_(v)
        best = self.sharded.local(state["best"]) if self.sharded is not None else state["best"]
        for k, v in best.items():
            self.best[k].copy_(v)

    def close(self) -> None:
        """Release what the program holds beyond its tensors (nothing
        here; the streamed program stops its gather thread)."""
