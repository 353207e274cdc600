"""Latent-space probes: embedding quality as classification accuracy under
the manifold's metric.

Port of ``hyperbolic_vae_tpu/probe.py``:

  * ``knn_accuracy``: a k-nearest-neighbour vote under geodesic distances
    (Euclidean for flat latents), over query chunks of 2048 rows with the
    tail padded to a full chunk, as JAX runs one compiled shape;
  * ``nearest_mean_accuracy``: the nearest per-class Frechet mean
    (``manifolds.stats.class_means``; arithmetic means for flat latents).

Labels may be any integers; they are reindexed to a contiguous range on
the host, and test labels unseen in train do not count. The distances
run on the device the embeddings are given on (tensors) or on
``device`` (numpy inputs).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.device import DeviceLike
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.manifolds.stats import class_means

__all__ = ["knn_accuracy", "nearest_mean_accuracy", "pairwise_dist"]


def _as_f32(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dtype=torch.float32, device=device if device is not None else a.device)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def pairwise_dist(ball: Optional[PoincareBall], a, b) -> torch.Tensor:
    """(m, d) x (n, d) -> (m, n) geodesic (or, with ``ball=None``,
    Euclidean) distances."""
    a = _as_f32(a)
    b = _as_f32(b, a.device)
    if ball is None:
        # |a - b|^2 expanded into one matrix product instead of an (m, n, d) cube
        sq = (a * a).sum(-1)[:, None] - 2.0 * (a @ b.T) + (b * b).sum(-1)[None, :]
        return torch.sqrt(sq.clamp_min(0.0))
    return ball.dist(a[:, None, :], b[None, :, :])


def _contiguous_labels(y_train, y_test):
    classes, y_tr = np.unique(np.asarray(y_train), return_inverse=True)
    lut = {int(c): i for i, c in enumerate(classes)}
    y_te = np.asarray([lut.get(int(v), -1) for v in np.asarray(y_test)])
    return len(classes), y_tr.astype(np.int64), y_te.astype(np.int64)


def _device_of(*arrays, device: DeviceLike = None) -> torch.device:
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    from hyperbolic_vae_tpu_torch.device import resolve_device

    return resolve_device(device)


def knn_accuracy(z_train, y_train, z_test, y_test, ball: Optional[PoincareBall] = None,
                 k: int = 10, chunk: int = 2048, device: DeviceLike = None) -> float:
    """Accuracy of a k-NN majority vote under the latent metric. Ties go
    to the smaller class index (as JAX's argmax)."""
    dev = _device_of(z_train, z_test, device=device)
    n_classes, y_tr, y_te = _contiguous_labels(y_train, y_test)
    k = min(int(k), len(z_train))
    zt = _as_f32(z_train, dev)
    yt = torch.as_tensor(y_tr, device=dev)
    zq_all = _as_f32(z_test, dev)
    correct = total = 0
    for start in range(0, zq_all.shape[0], chunk):
        zq = zq_all[start:start + chunk]
        rows = zq.shape[0]
        if rows < chunk:  # the tail padded to a full chunk, as in JAX
            zq = torch.cat([zq, zq.new_zeros((chunk - rows,) + tuple(zq.shape[1:]))])
        d = pairwise_dist(ball, zq, zt)
        idx = torch.topk(-d, k, dim=-1).indices
        votes = torch.nn.functional.one_hot(yt[idx], n_classes).sum(dim=1)
        pred = votes.argmax(dim=-1)[:rows].cpu().numpy()
        yq = y_te[start:start + chunk]
        keep = yq >= 0
        correct += int((pred[keep] == yq[keep]).sum())
        total += int(keep.sum())
    return correct / max(total, 1)


def nearest_mean_accuracy(z_train, y_train, z_test, y_test,
                          ball: Optional[PoincareBall] = None, device: DeviceLike = None) -> float:
    """Accuracy of nearest-class-prototype classification: per-class
    Frechet means on the ball, arithmetic means for flat latents."""
    dev = _device_of(z_train, z_test, device=device)
    n_classes, y_tr, y_te = _contiguous_labels(y_train, y_test)
    z_tr = _as_f32(z_train, dev)
    labels = torch.as_tensor(y_tr, device=dev)
    if ball is not None:
        means = class_means(ball, z_tr, labels, n_classes)
    else:
        onehot = torch.nn.functional.one_hot(labels, n_classes).to(torch.float32)
        means = (onehot.T @ z_tr) / onehot.sum(dim=0).clamp_min(1.0)[:, None]
    pred = pairwise_dist(ball, _as_f32(z_test, dev), means).argmin(dim=-1).cpu().numpy()
    keep = y_te >= 0
    return float((pred[keep] == y_te[keep]).mean()) if keep.any() else 0.0
