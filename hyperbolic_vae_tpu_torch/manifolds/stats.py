"""Statistics on the Poincare ball: Frechet means, dispersion, geodesics.

Port of ``hyperbolic_vae_tpu/manifolds/stats.py``:

  * ``frechet_mean``: the Karcher iteration m <- exp_m(sum_i w_i log_m(x_i)),
    a fixed ``num_iters`` steps from the projected Euclidean average (on
    the ball the weighted mean is unique and the iteration contracts);
  * ``frechet_variance``: the weighted mean squared geodesic distance to
    the mean;
  * ``class_means``: per-label means as one batched computation over
    class weight masks (no loop over classes; an empty class gives the
    origin);
  * ``geodesic``: the constant-speed geodesic x -> y at times t.
"""

from __future__ import annotations

import torch

from hyperbolic_vae_tpu_torch.manifolds.poincare import PoincareBall

__all__ = ["class_means", "frechet_mean", "frechet_variance", "geodesic"]


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def frechet_mean(ball: PoincareBall, x, weights=None, num_iters: int = 32) -> torch.Tensor:
    """Weighted Frechet (Karcher) mean of points x (..., N, D) over axis
    -2 -> (..., D). ``weights`` (..., N) need not be normalised; points of
    weight 0 are ignored (safe padding)."""
    x = ball.project(_f32(x))
    w = torch.ones(x.shape[:-1], dtype=torch.float32, device=x.device) if weights is None \
        else _f32(weights, x.device)
    wn = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    m = ball.project((wn[..., None] * x).sum(dim=-2))
    for _ in range(num_iters):
        v = (wn[..., None] * ball.logmap(m[..., None, :], x)).sum(dim=-2)
        m = ball.project(ball.expmap(m, v))
    return m


def frechet_variance(ball: PoincareBall, x, mean=None, weights=None) -> torch.Tensor:
    """Weighted mean squared geodesic distance to the Frechet mean:
    x (..., N, D) -> (...,)."""
    x = _f32(x)
    if mean is None:
        mean = frechet_mean(ball, x, weights)
    d2 = ball.dist(_f32(mean, x.device)[..., None, :], x) ** 2
    if weights is None:
        return d2.mean(dim=-1)
    w = _f32(weights, x.device)
    return (w * d2).sum(dim=-1) / w.sum(dim=-1).clamp_min(1e-30)


def class_means(ball: PoincareBall, x, labels, num_classes: int,
                num_iters: int = 32) -> torch.Tensor:
    """Per-label Frechet means: x (N, D), integer labels (N,) ->
    (num_classes, D), all classes at once as weight masks over the whole
    point set; a class with no members gets the origin."""
    x = _f32(x)
    labels = torch.as_tensor(labels, dtype=torch.long, device=x.device)
    onehot = torch.nn.functional.one_hot(labels, num_classes).to(torch.float32)  # (N, C)
    counts = onehot.sum(dim=0)
    means = frechet_mean(ball, x.expand(num_classes, *x.shape), onehot.T, num_iters)
    return torch.where(counts[:, None] > 0, means, torch.zeros_like(means))


def geodesic(ball: PoincareBall, x, y, t) -> torch.Tensor:
    """Constant-speed geodesic from x to y: gamma(t) = x (+) t (x) ((-x) (+) y),
    gamma(0) = x, gamma(1) = y. Times t (...,) broadcast against x, y
    (..., D); t's extra axes lead (t (T,) with x (D,) -> (T, D))."""
    x = ball.project(_f32(x))
    y = ball.project(_f32(y, x.device))
    v = ball.mobius_add(-x, y)
    t = _f32(t, x.device)[..., None]
    return ball.project(ball.mobius_add(x, ball.mobius_scalar_mul(t, v)))
