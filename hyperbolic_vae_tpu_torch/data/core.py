"""Array-based data modules.

Port of ``hyperbolic_vae_tpu/data/core.py`` (numpy, so the same seed
gives equal arrays): ``ArrayDataModule`` holds numpy splits, which the
Trainer stages onto the device once per fit; ``split_train_val`` is the
seeded 90/10 split, ``split_three_way`` the seeded 70/15/15 one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ArrayDataModule:
    """Train/val/test arrays: ``x_*`` float32, channels-last images
    (H, W, C) or flat vectors; ``y_*`` int32 labels (-1 when unlabeled)."""

    x_train: np.ndarray
    y_train: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    batch_size: int = 256
    label_names: Optional[Sequence[str]] = None
    name: str = "dataset"

    @property
    def input_shape(self):
        return self.x_train.shape[1:]

    def steps_per_epoch(self, split: str = "train") -> int:
        n = len(getattr(self, f"x_{split}"))
        return n // self.batch_size if split == "train" else -(-n // self.batch_size)

    def __post_init__(self):
        for s in ("train", "val", "test"):
            x, y = getattr(self, f"x_{s}"), getattr(self, f"y_{s}")
            if len(x) != len(y):
                raise ValueError(f"{s}: {len(x)} inputs but {len(y)} labels")


def split_train_val(x: np.ndarray, y: np.ndarray, val_fraction: float = 0.1, seed: int = 42):
    """Seeded random split: (x_train, y_train, x_val, y_val)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    n_val = int(round(len(x) * val_fraction))
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    return x[train_idx], y[train_idx], x[val_idx], y[val_idx]


def split_three_way(x: np.ndarray, y: np.ndarray, fractions=(0.7, 0.15), seed: int = 42):
    """Seeded 70/15/15 split: ((x, y) train, val, test)."""
    rng = np.random.default_rng(seed)
    n = len(x)
    perm = rng.permutation(n)
    n_train = int(fractions[0] * n)
    n_val = int(fractions[1] * n)
    tr = perm[:n_train]
    va = perm[n_train:n_train + n_val]
    te = perm[n_train + n_val:]
    return (x[tr], y[tr]), (x[va], y[va]), (x[te], y[te])
