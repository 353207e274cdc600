"""The training engine.

Port of ``hyperbolic_vae_tpu/train/trainer.py`` for one model on one
device: Riemannian Adam, one epoch per loop iteration (row or block
shuffle, the finite guard with ``skipped_steps``, the split-exact val
eval), then on the host ReduceLROnPlateau, early stopping and
best-params tracking on ``monitor``. History rows carry ``train/<m>``,
``val/<m>``, ``lr`` and ``epoch`` as in JAX.

JAX runs K epochs per dispatch (``train/chunk_program.py``); its
histories equal the one-epoch loop's by construction, and the port runs
that loop. Metrics leave the device once per epoch.

Hooks, as in JAX: ``loss_fn(model, batch, generator) -> metrics`` (e.g.
``ops.flagship_fused.make_fused_loss_fn``) replaces ``model.loss``;
``train_step_fn(model, optimizer, batch, generator) -> metrics`` (e.g.
``ops.flagship_fused.make_fused_train_step``, K3) replaces the whole step
(loss, backward, guard and update) and owns its finite guard, so
``finite_guard`` does not apply to it; ``grad_accum_steps`` and
``grad_clip_norm`` do not compose with it and raise, as in JAX. ``fit``
trains ``model`` in place, from its current weights or from ``params``.
Still to port: ``epochs_per_dispatch``, EMA, moment_dtype, hyperparameter
lanes, meshes, streaming, checkpoints, lr and beta schedules.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import math
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule
from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.optim import EarlyStopping, ReduceLROnPlateau, RiemannianAdam
from hyperbolic_vae_tpu_torch.train.epoch_program import default_loss_fn, eval_full, train_epoch
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
        check_finite: bool = True,
        shuffle: str = "row",  # "row" (fresh permutation) | "block" (random windows)
        loss_fn: Optional[Callable] = None,  # fn(model, batch, generator) -> metrics
        train_step_fn: Optional[Callable] = None,  # fn(model, optimizer, batch, generator) -> metrics
        finite_guard: bool = True,  # skip a step whose loss or gradient is not finite (default step)
        grad_accum_steps: int = 1,  # A > 1: each step sums the gradients of A microbatches of batch/A rows
        grad_clip_norm: Optional[float] = None,  # clip the gradients to this global L2 norm
        device: DeviceLike = None,
    ):
        if shuffle not in ("row", "block"):
            raise ValueError(f"shuffle must be 'row' or 'block', got {shuffle!r}")
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        if grad_accum_steps > 1 and train_step_fn is not None:
            raise ValueError("grad_accum_steps does not compose with train_step_fn "
                             "(the full-step override owns its own grad computation)")
        if grad_clip_norm is not None and train_step_fn is not None:
            raise ValueError("grad_clip_norm does not compose with train_step_fn")
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
        self.check_finite = check_finite
        self.shuffle = shuffle
        self.loss_fn = loss_fn
        self.train_step_fn = train_step_fn
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

    def _make_optimizer(self) -> RiemannianAdam:
        ball = getattr(self.model, "ball", None) or PoincareBall(c=1.0)
        return RiemannianAdam(self.model.parameters(), lr=self.plateau.lr, ball=ball)

    def _stage(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def init_params(self, seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Fresh weights for the model's configuration, drawn from ``seed``
        (default: the Trainer's), on the Trainer's device."""
        g = torch.Generator().manual_seed(self.seed if seed is None else seed)
        fresh = type(self.model)(**self.model.hparams(), generator=g, device="cpu")
        return {k: v.to(self.device) for k, v in fresh.state_dict().items()}

    def fit(self, dm: ArrayDataModule, params: Optional[Dict[str, Any]] = None) -> TrainResult:
        """Train ``self.model`` in place (from ``params`` if given) for at
        most ``max_epochs`` epochs."""
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
        loss_fn = self.loss_fn or default_loss_fn
        x_train, x_val = self._stage(dm.x_train), self._stage(dm.x_val)
        self.metric_logger.log_hparams({
            "model": self.model, "lr": self.lr, "batch_size": dm.batch_size,
            "max_epochs": self.max_epochs, "dataset": dm.name,
        })
        samples_per_epoch = (x_train.shape[0] // dm.batch_size) * dm.batch_size
        history: list = []
        best_params = _snapshot(self.model)
        best_metric = math.inf
        total_samples, t_start = 0, None
        for epoch in range(self.max_epochs):
            lr_used = self.plateau.lr
            for group in self.optimizer.param_groups:
                group["lr"] = lr_used
            t_names, t_means = train_epoch(
                self.model, self.optimizer, x_train, dm.batch_size, gen, shuffle=self.shuffle,
                loss_fn=loss_fn, train_step_fn=self.train_step_fn, finite_guard=self.finite_guard,
                grad_accum_steps=self.grad_accum_steps, grad_clip_norm=self.grad_clip_norm)
            v_names, v_means = eval_full(self.model, x_val, dm.batch_size, gen, loss_fn)
            values = torch.cat([t_means, v_means]).tolist()  # the epoch's one fetch
            metrics = {f"train/{k}": v for k, v in zip(t_names, values)}
            metrics.update({f"val/{k}": v for k, v in zip(v_names, values[len(t_names):])})
            metrics.update(lr=lr_used, epoch=epoch)
            history.append(metrics)
            if t_start is None:
                t_start = time.perf_counter()  # the first epoch is warm-up
            else:
                total_samples += samples_per_epoch
            self.metric_logger.log_scalars(epoch, metrics)
            if self.check_finite and not np.isfinite(metrics["train/loss_total"]):
                logger.warning("non-finite train loss at epoch %d", epoch)
            if self.monitor not in metrics:
                raise KeyError(f"monitor {self.monitor!r} not among the metrics {sorted(metrics)}")
            mon = np.float32(metrics[self.monitor])
            if not np.isfinite(mon):
                continue
            if mon < np.float32(best_metric):
                best_metric = float(mon)
                best_params = _snapshot(self.model)
            self.plateau.step(float(mon))
            if self.early_stopping and self.early_stopping.step(float(mon)):
                logger.info("early stopping at epoch %d", epoch)
                break
        elapsed = time.perf_counter() - t_start if t_start is not None else 0.0
        self.metric_logger.close()
        return TrainResult(
            params=_snapshot(self.model),
            best_params=best_params,
            history=history,
            best_metric=best_metric,
            epochs_run=len(history),
            samples_per_sec=total_samples / elapsed if total_samples else 0.0,
        )

    def evaluate(self, dm: ArrayDataModule, params: Optional[Dict[str, Any]] = None,
                 split: str = "test") -> dict:
        """Mean loss metrics over a split (eval fold with its tail batch),
        for ``params`` if given (the model is left as it is), with draws
        from seed + 1."""
        model = self.model
        if params is not None:
            model = copy.deepcopy(self.model)
            model.load_state_dict(params)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        x = self._stage(getattr(dm, f"x_{split}"))
        names, means = eval_full(model, x, dm.batch_size, gen, self.loss_fn or default_loss_fn)
        return {f"{split}/{k}": v for k, v in zip(names, means.tolist())}
