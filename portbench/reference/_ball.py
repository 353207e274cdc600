"""Poincare-ball geometry in plain PyTorch, for the plain references.

Written from the definitions, not from the program: Mobius addition, the
exponential and logarithmic maps, the conformal factor, parallel
transport by gyration, the geodesic distance and the signed distance to
a gyroplane whose normal is its own point. The guards are the ones the
configurations' published models state: f32 norms floored at 1e-15,
artanh clipped at 1 - eps(f32), tanh's argument at +-15, points kept at
radius (1 - 4e-3) / sqrt(c).
"""

from __future__ import annotations

import math

import torch

MIN_NORM = 1e-15
TANH_CLAMP = 15.0
BOUNDARY_EPS = 4e-3
F32_EPS = float(torch.finfo(torch.float32).eps)


def sq(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(dim=-1, keepdim=True)


def norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sq(x).clamp_min(MIN_NORM * MIN_NORM))


def artanh(x: torch.Tensor) -> torch.Tensor:
    return torch.atanh(x.clamp(-1.0 + F32_EPS, 1.0 - F32_EPS))


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x.clamp(-TANH_CLAMP, TANH_CLAMP))


def project(x: torch.Tensor, c: float) -> torch.Tensor:
    max_norm = (1.0 - BOUNDARY_EPS) / math.sqrt(c)
    return x * (max_norm / norm(x)).clamp_max(1.0)


def lam(x: torch.Tensor, c: float) -> torch.Tensor:
    """The conformal factor 2 / (1 - c |x|^2), (..., 1)."""
    return 2.0 / (1.0 - c * sq(x)).clamp_min(MIN_NORM)


def mobius_add(x: torch.Tensor, y: torch.Tensor, c: float) -> torch.Tensor:
    x2, y2 = sq(x), sq(y)
    xy = (x * y).sum(dim=-1, keepdim=True)
    num = (1.0 + 2.0 * c * xy + c * y2) * x + (1.0 - c * x2) * y
    den = 1.0 + 2.0 * c * xy + c * c * x2 * y2
    return num / den.clamp_min(MIN_NORM)


def expmap0(u: torch.Tensor, c: float) -> torch.Tensor:
    s = math.sqrt(c)
    n = norm(u)
    return project(tanh(s * n) * u / (s * n), c)


def logmap0(y: torch.Tensor, c: float) -> torch.Tensor:
    s = math.sqrt(c)
    n = norm(y)
    return artanh(s * n) * y / (s * n)


def expmap(x: torch.Tensor, u: torch.Tensor, c: float) -> torch.Tensor:
    s = math.sqrt(c)
    n = norm(u)
    second = tanh(s * lam(x, c) * n / 2.0) * u / (s * n)
    return project(mobius_add(x, second, c), c)


def logmap(x: torch.Tensor, y: torch.Tensor, c: float) -> torch.Tensor:
    s = math.sqrt(c)
    sub = mobius_add(-x, y, c)
    n = norm(sub)
    return 2.0 / (s * lam(x, c)) * artanh(s * n) * sub / n


def dist(x: torch.Tensor, y: torch.Tensor, c: float) -> torch.Tensor:
    """Geodesic distance, (...,)."""
    s = math.sqrt(c)
    return (2.0 / s * artanh(s * norm(mobius_add(-x, y, c)))).squeeze(-1)


def dist0(x: torch.Tensor, c: float) -> torch.Tensor:
    """Geodesic distance from the origin, (..., 1)."""
    s = math.sqrt(c)
    return 2.0 / s * artanh(s * norm(x))


def gyration(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, c: float) -> torch.Tensor:
    """gyr[u, v] w = -(u + v) + (u + (v + w)), Mobius sums."""
    return mobius_add(-mobius_add(u, v, c), mobius_add(u, mobius_add(v, w, c), c), c)


def transport(x: torch.Tensor, y: torch.Tensor, v: torch.Tensor, c: float) -> torch.Tensor:
    """Parallel transport of v from the tangent space at x to that at y."""
    return gyration(y, -x, v, c) * lam(x, c) / lam(y, c)


def log_sinh_ratio(t: torch.Tensor) -> torch.Tensor:
    """log(sinh t / t) for t >= 0: its series below 0.2, else the closed
    form, whose argument is kept at 0.1 or more (both branches are
    differentiated)."""
    ts = t.clamp_min(0.1)
    big = ts + torch.log1p(-torch.exp(-2.0 * ts)) - math.log(2.0) - torch.log(ts)
    t2 = t * t
    small = t2 / 6.0 - t2 * t2 / 180.0 + t2 * t2 * t2 / 2835.0
    return torch.where(t < 0.2, small, big)


def gyroplane_distance(z: torch.Tensor, points: torch.Tensor, c: float) -> torch.Tensor:
    """Signed distance from each row of z (B, D) to each gyroplane through
    points[j] with normal points[j] (P, D): (B, P), from the definition
    arsinh(2 sqrt(c) <(-p) + z, p> / ((1 - c |(-p) + z|^2) |p|)) / sqrt(c)."""
    s = math.sqrt(c)
    diff = mobius_add(-points[None, :, :], z[:, None, :], c)  # (B, P, D)
    d2 = sq(diff).squeeze(-1).clamp_min(MIN_NORM)
    dot = (diff * points[None]).sum(-1)
    pn = norm(points).squeeze(-1)
    den = ((1.0 - c * d2) * pn).clamp_min(MIN_NORM)
    return torch.asinh(2.0 * s * dot / den) / s


def wrapped_normal_rsample(mu: torch.Tensor, scale: torch.Tensor, eps: torch.Tensor,
                           c: float, max_radius: float = 10.0) -> torch.Tensor:
    """A draw of the wrapped normal at mu: the tangent draw scale * eps at
    the origin, cut to the radius the f32 chart holds faithfully and to
    ``max_radius``, halved (lambda at the origin is 2), transported to mu
    and mapped onto the ball."""
    s = math.sqrt(c)
    chart = 2.0 / s * math.atanh(1.0 - BOUNDARY_EPS)
    v = scale * eps
    allowed = (chart - dist0(mu, c)).clamp_min(1e-2).clamp_max(max_radius)
    v = v * (allowed / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)).clamp_max(1.0)
    u = (v / 2.0) * (1.0 - c * sq(mu)).clamp_min(MIN_NORM)
    return expmap(mu, u, c)


def wrapped_normal_log_prob(mu: torch.Tensor, scale: torch.Tensor, z: torch.Tensor,
                            c: float) -> torch.Tensor:
    """log density of the wrapped normal at z, (...,): the normal density
    of the tangent vector carried back to the origin (times lambda_0 = 2),
    less the exponential map's log volume change."""
    v = logmap(mu, z, c) * lam(mu, c) / 2.0
    u = v * 2.0
    var = scale * scale
    normal = (-(u * u) / (2.0 * var) - torch.log(scale) - 0.5 * math.log(2.0 * math.pi)).sum(-1)
    d = mu.shape[-1]
    return normal - (d - 1) * log_sinh_ratio(math.sqrt(c) * dist(mu, z, c))
