"""Training control: ReduceLROnPlateau, EarlyStopping and the epoch
schedules.

Port of ``hyperbolic_vae_tpu/optim/schedules.py``: torch's
ReduceLROnPlateau(mode="min", relative threshold 1e-4) and Lightning's
EarlyStopping(mode="min"), with every comparison in float32 as the JAX
controllers make it, so the same metrics give the same lr sequence and
the same stop epoch. The Trainer runs their in-graph twins
(``train/chunk_program.py``) and keeps these as host mirrors of the
state for checkpoints.

``cosine_schedule``, ``exponential_schedule`` and ``beta_warmup_schedule``
return ``fn(epoch) -> 0-d f32 tensor``, written on tensors in JAX's f32
operation order: ``epoch`` is a number or an integer tensor on any
device, so the same callable runs on the host and inside a captured CUDA
graph from the device's epoch counter.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.2
    patience: int = 20
    min_lr: float = 5e-5
    threshold: float = 1e-4
    best: float = math.inf
    num_bad_epochs: int = 0

    def __post_init__(self):
        # f32 throughout, the starting lr included
        self.lr = float(np.float32(self.lr))

    def step(self, metric: float) -> float:
        if np.float32(metric) < np.float32(self.best) * (
            np.float32(1.0) - np.float32(self.threshold)
        ):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = float(np.maximum(np.float32(self.lr) * np.float32(self.factor),
                                      np.float32(self.min_lr)))
            # only a reduction is applied: an lr below min_lr is never raised
            if new_lr < self.lr:
                self.lr = new_lr
            self.num_bad_epochs = 0
        return self.lr


@dataclasses.dataclass
class EarlyStopping:
    patience: int = 10
    min_delta: float = 0.0
    best: float = math.inf
    wait: int = 0
    stopped: bool = False

    def step(self, metric: float) -> bool:
        """True once training should stop."""
        if np.float32(metric) < np.float32(self.best) - np.float32(self.min_delta):
            self.best = metric
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
        return self.stopped


def _f32(v) -> float:
    """v rounded to f32, as a Python float (exact in the f32 ops below)."""
    return float(np.float32(v))


def _epoch(epoch) -> torch.Tensor:
    if isinstance(epoch, torch.Tensor):
        return epoch.to(torch.float32)
    return torch.tensor(float(epoch), dtype=torch.float32)


def cosine_schedule(base_lr: float, total_epochs: int, warmup_epochs: int = 0,
                    min_lr: float = 0.0):
    """Linear warmup (epochs 0..warmup-1 ramp to base_lr), then cosine
    decay to min_lr at total_epochs, constant min_lr after."""
    base, lo = _f32(base_lr), _f32(min_lr)
    w, total = _f32(warmup_epochs), _f32(total_epochs)
    half_span = _f32(np.float32(0.5) * (np.float32(base) - np.float32(lo)))
    span = _f32(max(np.float32(total) - np.float32(w), np.float32(1.0)))
    pi = _f32(math.pi)

    def fn(epoch) -> torch.Tensor:
        e = _epoch(epoch)
        warm = base * (e + 1.0) / max(w, 1.0)
        t = ((e - w) / span).clamp(0.0, 1.0)
        cos = lo + half_span * (1.0 + torch.cos(pi * t))
        return torch.where(e < w, warm, cos)

    return fn


def exponential_schedule(base_lr: float, gamma: float, min_lr: float = 0.0,
                         warmup_epochs: int = 0):
    """Linear warmup, then base_lr * gamma^(epoch - warmup), floored at
    min_lr."""
    base, lo = _f32(base_lr), _f32(min_lr)
    w, g = _f32(warmup_epochs), _f32(gamma)

    def fn(epoch) -> torch.Tensor:
        e = _epoch(epoch)
        warm = base * (e + 1.0) / max(w, 1.0)
        dec = (base * torch.pow(torch.full_like(e, g), e - w)).clamp_min(lo)
        return torch.where(e < w, warm, dec)

    return fn


def beta_warmup_schedule(beta_end: float, warmup_epochs: int, beta_start: float = 0.0):
    """KL annealing: beta ramps linearly from ``beta_start`` to
    ``beta_end`` over ``warmup_epochs`` epochs, then stays at beta_end
    (constant beta_end from epoch 0 when ``warmup_epochs`` <= 0)."""
    b0, b1 = _f32(beta_start), _f32(beta_end)
    span = _f32(np.float32(b1) - np.float32(b0))
    w = _f32(warmup_epochs)

    def fn(epoch) -> torch.Tensor:
        e = _epoch(epoch)
        if warmup_epochs <= 0:
            return torch.full_like(e, b1)
        return b0 + span * (e / max(w, 1.0)).clamp(0.0, 1.0)

    return fn
