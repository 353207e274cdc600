"""CIFAR-10 arrays and the data module (numpy).

A copy of ``hyperbolic_vae_tpu/data/cifar10.py``: the same seed gives
the same arrays. The standard python-pickle batches are read from
``data_dir`` (or its ``cifar-10-batches-py``; nothing is downloaded) and
normalised to [-1, 1] (the reference's Normalize(0.5, 0.5), which pairs
with the tanh output); ``synthetic=True`` builds the seeded stand-in.
Images are channels-last (N, 32, 32, 3). ``make_data_module`` splits the
train set 45k/5k with seed 42, as the reference does.
"""

from __future__ import annotations

import pickle
import tarfile
from pathlib import Path

import numpy as np

from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule, split_train_val

CIFAR10_LABELS = [
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
]


def _load_batch(raw: dict) -> tuple[np.ndarray, np.ndarray]:
    data = raw[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
    labels = np.asarray(raw[b"labels"], dtype=np.int32)
    return data, labels


def _read(path: Path) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        return _load_batch(pickle.load(f, encoding="bytes"))


def load_cifar10_arrays(data_dir) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """x_train (50000, 32, 32, 3) in [-1, 1], y_train, x_test, y_test from
    the five data batches and the test batch under ``data_dir`` (or
    ``data_dir/cifar-10-batches-py``, extracted from
    ``cifar-10-python.tar.gz`` there if only the archive is present)."""
    data_dir = Path(data_dir)
    base = next((d for d in (data_dir / "cifar-10-batches-py", data_dir)
                 if (d / "data_batch_1").exists()), None)
    if base is None:
        tar = data_dir / "cifar-10-python.tar.gz"
        if not tar.exists():
            raise FileNotFoundError(
                f"CIFAR-10 batches not found under {data_dir}. "
                "Nothing is downloaded; provide the files or use synthetic=True."
            )
        with tarfile.open(tar) as tf:
            tf.extractall(data_dir, filter="data")
        base = data_dir / "cifar-10-batches-py"
    parts = [_read(base / f"data_batch_{i}") for i in range(1, 6)]
    x_train = np.concatenate([p[0] for p in parts])
    y_train = np.concatenate([p[1] for p in parts])
    x_test, y_test = _read(base / "test_batch")

    def norm(a):  # ToTensor + Normalize(0.5, 0.5): [0, 255] -> [-1, 1]
        return (a.astype(np.float32) / 255.0 - 0.5) / 0.5

    return norm(x_train), y_train, norm(x_test), y_test


def synthetic_cifar10_arrays(n_train: int = 50000, n_test: int = 10000, seed: int = 0):
    """Class-prototype colour blobs in [-1, 1], (N, 32, 32, 3), with
    labels: x_train, y_train, x_test, y_test."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32] / 31.0
    protos = []
    for _ in range(10):
        img = np.zeros((32, 32, 3), np.float32)
        for ch in range(3):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            s = rng.uniform(0.1, 0.3)
            img[..., ch] = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s**2)))
        protos.append(img / img.max() * 2.0 - 1.0)
    protos = np.stack(protos)

    def make(n, off):
        r = np.random.default_rng(seed + off)
        y = r.integers(0, 10, n).astype(np.int32)
        x = protos[y] + r.normal(0, 0.15, (n, 32, 32, 3)).astype(np.float32)
        return np.clip(x, -1.0, 1.0).astype(np.float32), y

    x_tr, y_tr = make(n_train, 1)
    x_te, y_te = make(n_test, 2)
    return x_tr, y_tr, x_te, y_te


def make_data_module(
    batch_size: int = 256,
    data_dir: str = "data",
    synthetic: bool = False,
    n_train: int = 50000,
    n_test: int = 10000,
    seed: int = 42,
) -> ArrayDataModule:
    """CIFAR-10 (or its synthetic stand-in) split 45k/5k/10k with ``seed``."""
    if synthetic:
        x_tr, y_tr, x_te, y_te = synthetic_cifar10_arrays(n_train, n_test)
    else:
        x_tr, y_tr, x_te, y_te = load_cifar10_arrays(data_dir)
    x_train, y_train, x_val, y_val = split_train_val(x_tr, y_tr, 0.1, seed)
    return ArrayDataModule(
        x_train=x_train, y_train=y_train, x_val=x_val, y_val=y_val,
        x_test=x_te, y_test=y_te, batch_size=batch_size, label_names=CIFAR10_LABELS,
        name="cifar10-synthetic" if synthetic else "cifar10",
    )
