"""Training control: ReduceLROnPlateau and EarlyStopping.

Port of ``hyperbolic_vae_tpu/optim/schedules.py``: torch's
ReduceLROnPlateau(mode="min", relative threshold 1e-4) and Lightning's
EarlyStopping(mode="min"), per epoch on the host, with every comparison
in float32 as the JAX controllers make it, so the same metrics give the
same lr sequence and the same stop epoch. The cosine, exponential and
beta-warmup schedules are still to port.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


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
