"""MNIST arrays and the data module (numpy).

A copy of ``hyperbolic_vae_tpu/data/mnist.py``: the same seed gives the
same arrays. The standard IDX files are read from ``data_dir`` (raw or
.gz; nothing is downloaded); ``synthetic=True`` builds the seeded
stand-in instead. ``make_data_module`` splits the train set 90/10 with
seed 42, as the reference does; ``pad_to_32`` pads its images to 32 x 32
for the conv families' three stride-2 convs.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule, split_train_val


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        _zero, _dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find(data_dir: Path, stem: str) -> Optional[Path]:
    for suffix in ("", ".gz"):
        p = data_dir / (stem + suffix)
        if p.exists():
            return p
    return None


def load_mnist_arrays(data_dir) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """x_train (60000, 28, 28, 1) in [0, 1], y_train, x_test, y_test from
    the four IDX files under ``data_dir`` (or ``data_dir/MNIST/raw``)."""
    data_dir = Path(data_dir)
    names = {
        "x_train": "train-images-idx3-ubyte",
        "y_train": "train-labels-idx1-ubyte",
        "x_test": "t10k-images-idx3-ubyte",
        "y_test": "t10k-labels-idx1-ubyte",
    }
    found = {k: _find(data_dir, v) or _find(data_dir / "MNIST" / "raw", v) for k, v in names.items()}
    missing = [names[k] for k, v in found.items() if v is None]
    if missing:
        raise FileNotFoundError(
            f"MNIST IDX files not found under {data_dir}: {missing}. "
            "Nothing is downloaded; provide the files or use synthetic=True."
        )
    x_train = _read_idx(found["x_train"]).astype(np.float32) / 255.0
    y_train = _read_idx(found["y_train"]).astype(np.int32)
    x_test = _read_idx(found["x_test"]).astype(np.float32) / 255.0
    y_test = _read_idx(found["y_test"]).astype(np.int32)
    return x_train[..., None], y_train, x_test[..., None], y_test


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


def make_data_module(
    batch_size: int = 256,
    data_dir: str = "data",
    synthetic: bool = False,
    n_train: int = 60000,
    n_test: int = 10000,
    seed: int = 42,
) -> ArrayDataModule:
    """MNIST (or its synthetic stand-in) with the train set split 90/10."""
    if synthetic:
        x_tr, y_tr, x_te, y_te = synthetic_mnist_arrays(n_train, n_test)
    else:
        x_tr, y_tr, x_te, y_te = load_mnist_arrays(data_dir)
    x_train, y_train, x_val, y_val = split_train_val(x_tr, y_tr, 0.1, seed)
    return ArrayDataModule(
        x_train=x_train, y_train=y_train, x_val=x_val, y_val=y_val,
        x_test=x_te, y_test=y_te, batch_size=batch_size,
        label_names=[str(i) for i in range(10)],
        name="mnist-synthetic" if synthetic else "mnist",
    )


def pad_to_32(dm: ArrayDataModule) -> ArrayDataModule:
    """Zero-pad every split's 28 x 28 images to 32 x 32 (two pixels a
    side), in place; returns ``dm``."""
    for s in ("train", "val", "test"):
        x = getattr(dm, f"x_{s}")
        setattr(dm, f"x_{s}", np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0))))
    return dm
