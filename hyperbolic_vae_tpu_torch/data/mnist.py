"""Seeded synthetic MNIST-like data (numpy), for request payloads and
tests. A copy of ``hyperbolic_vae_tpu/data/mnist.py::synthetic_mnist_arrays``:
the same seed gives the same arrays."""

from __future__ import annotations

import numpy as np


def synthetic_mnist_arrays(
    n_train: int = 60000, n_test: int = 10000, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Seeded digit-like data: each class is a smooth random prototype
    (low-frequency blob pattern) + per-sample jitter, clipped to [0, 1].
    Returns x_train (n, 28, 28, 1), y_train, x_test, y_test."""
    rng = np.random.default_rng(seed)
    protos = []
    yy, xx = np.mgrid[0:28, 0:28] / 27.0
    for k in range(10):
        acc = np.zeros((28, 28), np.float32)
        for _ in range(3):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            sx, sy = rng.uniform(0.08, 0.25, 2)
            acc += np.exp(-((xx - cx) ** 2 / (2 * sx**2) + (yy - cy) ** 2 / (2 * sy**2)))
        protos.append(acc / acc.max())
    protos = np.stack(protos)  # (10, 28, 28)

    def make(n, seed_offset):
        r = np.random.default_rng(seed + seed_offset)
        y = r.integers(0, 10, n).astype(np.int32)
        shift = r.normal(0, 1.0, (n, 2)).astype(np.int64)
        noise = r.normal(0, 0.08, (n, 28, 28)).astype(np.float32)
        # vectorized per-sample circular translation (roll): out[i] = in[(i - s) % 28]
        imgs = protos[y]
        grid = np.arange(28)
        r_idx = (grid[None, :] - shift[:, 0:1]) % 28
        c_idx = (grid[None, :] - shift[:, 1:2]) % 28
        x = imgs[np.arange(n)[:, None, None], r_idx[:, :, None], c_idx[:, None, :]]
        x = np.clip(x + noise, 0.0, 1.0).astype(np.float32)
        return x[..., None], y

    x_train, y_train = make(n_train, 1)
    x_test, y_test = make(n_test, 2)
    return x_train, y_train, x_test, y_test
