"""Poincare-ball geometry as plain tensor functions.

Port of ``hyperbolic_vae_tpu/manifolds/poincare.py`` with the same
numerics: the trailing axis is the coordinate axis, bf16/f16 inputs are
upcast to f32, ``artanh`` is clipped at 1 - eps(dtype), ``tanh`` at
+-15, norms are floored at MIN_NORM and points are projected to radius
(1 - BOUNDARY_EPS)/sqrt(c).

This slice ports the methods the serving path uses; the rest of the
class (gyration, Mobius matvec, logmap, dist, dist2plane, the optimizer
helpers, logdetexp) arrives with the training slice.
"""

from __future__ import annotations

import dataclasses
import math

import torch

MIN_NORM = 1e-15
# Max tanh argument before f32 saturates.
TANH_CLAMP = 15.0
# Projection margin: points are clamped to radius (1-eps)/sqrt(c).
BOUNDARY_EPS = 4e-3


def _upcast(x: torch.Tensor) -> torch.Tensor:
    """bf16/f16 -> f32 for stable manifold math."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x


def artanh(x: torch.Tensor) -> torch.Tensor:
    """arctanh with |x| clipped to 1 - eps(dtype)."""
    eps = torch.finfo(x.dtype).eps
    return torch.atanh(x.clamp(-1.0 + eps, 1.0 - eps))


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x.clamp(-TANH_CLAMP, TANH_CLAMP))


def _sq_norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return (x * x).sum(dim=-1, keepdim=keepdim)


def _norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return torch.sqrt(_sq_norm(x, keepdim).clamp_min(MIN_NORM**2))


@dataclasses.dataclass(frozen=True)
class PoincareBall:
    """Poincare ball of curvature ``c`` (> 0), radius 1/sqrt(c)."""

    c: float = 1.0

    @property
    def sqrt_c(self) -> float:
        return math.sqrt(self.c)

    @property
    def radius(self) -> float:
        return 1.0 / self.sqrt_c

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """Clamp points into the open ball: |x| <= (1-eps)/sqrt(c)."""
        x = _upcast(x)
        max_norm = (1.0 - BOUNDARY_EPS) / self.sqrt_c
        scale = (max_norm / _norm(x)).clamp_max(1.0)
        return x * scale

    def lambda_x(self, x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
        """Conformal factor lambda_x = 2 / (1 - c|x|^2)."""
        x = _upcast(x)
        return 2.0 / (1.0 - self.c * _sq_norm(x, keepdim)).clamp_min(MIN_NORM)

    def mobius_add(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Mobius addition x (+) y on the c-ball."""
        x, y = _upcast(x), _upcast(y)
        c = self.c
        x2 = _sq_norm(x)
        y2 = _sq_norm(y)
        xy = (x * y).sum(dim=-1, keepdim=True)
        num = (1.0 + 2.0 * c * xy + c * y2) * x + (1.0 - c * x2) * y
        denom = 1.0 + 2.0 * c * xy + c * c * x2 * y2
        return num / denom.clamp_min(MIN_NORM)

    def expmap(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Exponential map exp_x(u)."""
        x, u = _upcast(x), _upcast(u)
        sqrt_c = self.sqrt_c
        u_norm = _norm(u)
        lam = self.lambda_x(x)
        second = tanh(sqrt_c * lam * u_norm / 2.0) * u / (sqrt_c * u_norm)
        return self.project(self.mobius_add(x, second))

    def expmap0(self, u: torch.Tensor) -> torch.Tensor:
        """exp_0(u) = tanh(sqrt(c)|u|) u / (sqrt(c)|u|)."""
        u = _upcast(u)
        sqrt_c = self.sqrt_c
        u_norm = _norm(u)
        return self.project(tanh(sqrt_c * u_norm) * u / (sqrt_c * u_norm))

    def logmap0(self, y: torch.Tensor) -> torch.Tensor:
        """log_0(y) = artanh(sqrt(c)|y|) y / (sqrt(c)|y|)."""
        y = _upcast(y)
        sqrt_c = self.sqrt_c
        y_norm = _norm(y)
        return artanh(sqrt_c * y_norm) * y / (sqrt_c * y_norm)

    def transp0(self, y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Transport from the origin to y: v * (1 - c|y|^2)."""
        y, v = _upcast(y), _upcast(v)
        return v * (1.0 - self.c * _sq_norm(y)).clamp_min(MIN_NORM)

    def dist0(self, x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
        """Geodesic distance from the origin."""
        x = _upcast(x)
        sqrt_c = self.sqrt_c
        return 2.0 / sqrt_c * artanh(sqrt_c * _norm(x, keepdim=keepdim))
