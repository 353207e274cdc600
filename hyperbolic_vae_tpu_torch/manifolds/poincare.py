"""Poincare-ball geometry as plain tensor functions.

Port of ``hyperbolic_vae_tpu/manifolds/poincare.py`` with the same
numerics: the trailing axis is the coordinate axis, bf16/f16 inputs are
upcast to f32, ``artanh`` is clipped at 1 - eps(dtype), ``tanh`` at
+-15, norms are floored at MIN_NORM and points are projected to radius
(1 - BOUNDARY_EPS)/sqrt(c).

The serving path's methods, the training path's (logmap, gyration,
transport, dist, the Riemannian optimizer's helpers, logdetexp with the
stable ``log_sinh_ratio``) and the evaluation path's
(``mobius_scalar_mul``, for geodesics), and the conv image families'
(``mobius_matvec``, ``dist2plane``, ``normdist2plane``, with the free
function ``normdist2plane``); and the rest of the JAX module's surface
(``origin``, ``check_point_on_manifold``, ``wrapped_normal``, the free
function ``logdetexp`` and the alias ``PoincareBallWithExtras``). The
port spells the reduction flag ``keepdim``, torch's name for JAX's
``keepdims``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

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


def arsinh(x: torch.Tensor) -> torch.Tensor:
    return torch.asinh(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x.clamp(-TANH_CLAMP, TANH_CLAMP))


def log_sinh_ratio(t: torch.Tensor) -> torch.Tensor:
    """log(sinh(t)/t), stable for all t >= 0: the series
    t^2/6 - t^4/180 + t^6/2835 below t = 0.2, else
    t + log1p(-exp(-2t)) - log 2 - log t. ``torch.where`` differentiates
    both branches, so the second one's input is kept at t >= 0.1, away
    from log1p(-1) = -inf."""
    t_safe = t.clamp_min(0.1)
    big = t_safe + torch.log1p(-torch.exp(-2.0 * t_safe)) - math.log(2.0) - torch.log(t_safe)
    t2 = t * t
    small = t2 / 6.0 - t2 * t2 / 180.0 + t2 * t2 * t2 / 2835.0
    return torch.where(t < 0.2, small, big)


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

    def origin(self, shape, dtype=torch.float32, device=None) -> torch.Tensor:
        """The ball's origin: zeros of ``shape`` (geoopt's ``origin``)."""
        if isinstance(shape, int):
            shape = (shape,)
        return torch.zeros(shape, dtype=dtype, device=device)

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

    def mobius_neg(self, x: torch.Tensor) -> torch.Tensor:
        return -x

    def mobius_scalar_mul(self, r, x: torch.Tensor) -> torch.Tensor:
        """r (x) x = tanh(r artanh(sqrt(c)|x|)) x / (sqrt(c)|x|)."""
        x = _upcast(x)
        sqrt_c = self.sqrt_c
        x_norm = _norm(x)
        res = tanh(r * artanh(sqrt_c * x_norm)) * x / (x_norm * sqrt_c)
        return self.project(res)

    def mobius_matvec(self, m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Mobius matrix-vector product M (x) x for M (out, in) and x (..., in):
        tanh(|Mx|/|x| artanh(sqrt(c)|x|)) Mx / (sqrt(c)|Mx|), the origin
        where Mx == 0, projected into the ball."""
        x, m = _upcast(x), _upcast(m)
        sqrt_c = self.sqrt_c
        x_norm = _norm(x)
        mx = x @ m.T
        mx_norm = _norm(mx)
        res = tanh(mx_norm / x_norm * artanh(sqrt_c * x_norm)) * mx / (mx_norm * sqrt_c)
        zero = (mx == 0.0).all(dim=-1, keepdim=True)
        res = torch.where(zero, torch.zeros_like(res), res)
        return self.project(res)

    def gyration(self, u: torch.Tensor, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """gyr[u, v] w = -(u (+) v) (+) (u (+) (v (+) w))."""
        return self.mobius_add(-self.mobius_add(u, v), self.mobius_add(u, self.mobius_add(v, w)))

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

    def logmap(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Log map log_x(y)."""
        x, y = _upcast(x), _upcast(y)
        sqrt_c = self.sqrt_c
        sub = self.mobius_add(-x, y)
        sub_norm = _norm(sub)
        lam = self.lambda_x(x)
        return 2.0 / (sqrt_c * lam) * artanh(sqrt_c * sub_norm) * sub / sub_norm

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

    def transp(self, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Parallel transport of v from T_x to T_y: gyr[y, -x] v * lam_x / lam_y."""
        x, y, v = _upcast(x), _upcast(y), _upcast(v)
        return self.gyration(y, -x, v) * self.lambda_x(x) / self.lambda_x(y)

    def transp0back(self, y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Transport from y back to the origin: v * lam_y / 2."""
        y, v = _upcast(y), _upcast(v)
        return v * self.lambda_x(y) / 2.0

    def dist(self, x: torch.Tensor, y: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
        """Geodesic distance 2/sqrt(c) artanh(sqrt(c) |(-x) (+) y|)."""
        x, y = _upcast(x), _upcast(y)
        sqrt_c = self.sqrt_c
        sub_norm = _norm(self.mobius_add(-x, y), keepdim=keepdim)
        return 2.0 / sqrt_c * artanh(sqrt_c * sub_norm)

    def dist0(self, x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
        """Geodesic distance from the origin."""
        x = _upcast(x)
        sqrt_c = self.sqrt_c
        return 2.0 / sqrt_c * artanh(sqrt_c * _norm(x, keepdim=keepdim))

    def dist2plane(
        self, x: torch.Tensor, p: torch.Tensor, a: torch.Tensor, signed: bool = False,
        scaled: bool = False, keepdim: bool = False,
    ) -> torch.Tensor:
        """Distance from x to the gyroplane through p with tangent normal a:
        arsinh(2 sqrt(c) <(-p)(+)x, a> / ((1 - c|(-p)(+)x|^2) |a|)) / sqrt(c),
        times |a| with ``scaled``."""
        x, p, a = _upcast(x), _upcast(p), _upcast(a)
        c = self.c
        sqrt_c = self.sqrt_c
        diff = self.mobius_add(-p, x)
        diff_norm2 = _sq_norm(diff, keepdim).clamp_min(MIN_NORM)
        sc_diff_a = (diff * a).sum(dim=-1, keepdim=keepdim)
        if not signed:
            sc_diff_a = sc_diff_a.abs()
        a_norm = torch.sqrt((a * a).sum(dim=-1, keepdim=keepdim).clamp_min(MIN_NORM**2))
        num = 2.0 * sqrt_c * sc_diff_a
        denom = ((1.0 - c * diff_norm2) * a_norm).clamp_min(MIN_NORM)
        res = arsinh(num / denom) / sqrt_c
        if scaled:
            res = res * a_norm
        return res

    def normdist2plane(
        self, x: torch.Tensor, a: torch.Tensor, p: torch.Tensor, signed: bool = False,
        norm: bool = False, keepdim: bool = False,
    ) -> torch.Tensor:
        """The reference's signature: distance from x to the gyroplane
        through ``p`` with normal ``a``, times |a| with ``norm``."""
        return self.dist2plane(x, p, a, signed=signed, scaled=norm, keepdim=keepdim)

    # ---- Riemannian structure (for the optimizer) ----------------------

    def egrad2rgrad(self, x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        """Euclidean -> Riemannian gradient: grad / lambda_x^2."""
        lam = self.lambda_x(x)
        return grad / (lam * lam)

    def component_inner(
        self, x: torch.Tensor, u: torch.Tensor, v: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Per-component metric product lambda_x^2 u v (the second moment
        of Riemannian Adam)."""
        if v is None:
            v = u
        lam = self.lambda_x(x)
        return (lam * lam) * u * v

    def inner(
        self, x: torch.Tensor, u: torch.Tensor, v: Optional[torch.Tensor] = None,
        keepdim: bool = False,
    ) -> torch.Tensor:
        if v is None:
            v = u
        lam = self.lambda_x(x, keepdim=keepdim)
        return (lam * lam) * (u * v).sum(dim=-1, keepdim=keepdim)

    def retr(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Retraction: the exact exponential map."""
        return self.expmap(x, u)

    def retr_transp(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        """Retract x along u and transport v to the new point."""
        y = self.expmap(x, u)
        return y, self.transp(x, y, v)

    def logdetexp(self, x: torch.Tensor, y: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
        """log|det d(exp_x)| at log_x(y), the wrapped normal's volume term:
        (d - 1) log(sinh(sqrt(c) d(x, y)) / (sqrt(c) d(x, y)))."""
        d = self.dist(x, y, keepdim=keepdim)
        return (x.shape[-1] - 1) * log_sinh_ratio(self.sqrt_c * d)

    def check_point_on_manifold(self, x: torch.Tensor, atol: float = 1e-5) -> torch.Tensor:
        """c |x|^2 <= 1 + atol: a bool tensor, one per point."""
        return self.c * _sq_norm(x, keepdim=False) <= 1.0 + atol

    def wrapped_normal(self, generator: Optional[torch.Generator], shape, mean: torch.Tensor,
                       std=1.0) -> torch.Tensor:
        """A wrapped-normal sample of ``shape`` centred at ``mean``: eps of
        ``shape`` from ``generator`` (on mean's device) through
        ``distributions.wrapped_normal_rsample_from_eps``, so the draw is
        scaled and chart-truncated as the distribution's rsample."""
        from hyperbolic_vae_tpu_torch.distributions.wrapped_normal import (
            wrapped_normal_rsample_from_eps,
        )

        shape = tuple(shape)
        eps = torch.randn(shape, generator=generator, device=mean.device)
        std = torch.broadcast_to(torch.as_tensor(std, dtype=torch.float32, device=mean.device),
                                 shape)
        return wrapped_normal_rsample_from_eps(self, mean, std, eps)


# the reference's name for the ball with its sampling and density helpers
PoincareBallWithExtras = PoincareBall


def logdetexp(ball: PoincareBall, x: torch.Tensor, y: torch.Tensor,
              keepdim: bool = False) -> torch.Tensor:
    """Free-function form of :meth:`PoincareBall.logdetexp` (the
    reference's ``manifolds.logdetexp``)."""
    return ball.logdetexp(x, y, keepdim=keepdim)


def normdist2plane(ball: PoincareBall, x, a, p, signed=False, norm=False, keepdim=False):
    """Free-function form of :meth:`PoincareBall.normdist2plane`."""
    return ball.normdist2plane(x, a, p, signed=signed, norm=norm, keepdim=keepdim)
