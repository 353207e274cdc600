"""Wrapped normal distribution on the Poincare ball.

Port of ``hyperbolic_vae_tpu/distributions/wrapped_normal.py``:

    rsample:  eps ~ N(0, I);  v = scale * eps / lambda_0
              u = PT_{0->loc}(v);      z = exp_loc(u)
    log_prob: v = log_loc(x);  u = PT_{loc->0}(v) * lambda_0
              log N(u; 0, scale) - logdetexp(loc, x)

with the tangent draw truncated to the chart radius the f32 chart
represents faithfully (see MAX_SAMPLE_RADIUS).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from hyperbolic_vae_tpu_torch.distributions import draws
from hyperbolic_vae_tpu_torch.distributions.relaxed_bernoulli import softplus as _softplus
from hyperbolic_vae_tpu_torch.manifolds import BOUNDARY_EPS, PoincareBall


def max_chart_radius(ball: PoincareBall) -> float:
    """Geodesic distance from the origin to the projection boundary —
    the largest radius the f32 chart represents faithfully."""
    return 2.0 / ball.sqrt_c * math.atanh(1.0 - BOUNDARY_EPS)


# Max geodesic radius of a sample from its loc (Riemannian units). A
# point farther than max_chart_radius from the origin is relocated by
# project(), so rsample truncates the tangent draw to
# min(MAX_SAMPLE_RADIUS, max_chart_radius - dist0(loc)).
MAX_SAMPLE_RADIUS = 10.0

_LOG_2PI = math.log(2.0 * math.pi)


def normal_log_prob(x: torch.Tensor, loc, scale) -> torch.Tensor:
    """Elementwise N(loc, scale) log density."""
    var = scale * scale
    return -((x - loc) ** 2) / (2.0 * var) - torch.log(torch.as_tensor(scale)) - 0.5 * _LOG_2PI


def wrapped_normal_rsample_from_eps(
    ball: PoincareBall, loc: torch.Tensor, scale: torch.Tensor, eps: torch.Tensor
) -> torch.Tensor:
    """Deterministic rsample given the standard-normal draw."""
    loc, scale = torch.broadcast_tensors(loc, scale)
    v = scale * eps
    r_allowed = (max_chart_radius(ball) - ball.dist0(loc, keepdim=True)).clamp_min(1e-2)
    r_allowed = r_allowed.clamp_max(MAX_SAMPLE_RADIUS)
    v_norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    v = v * (r_allowed / v_norm.clamp_min(1e-12)).clamp_max(1.0)
    # lambda at the origin is exactly 2
    v = v / 2.0
    u = ball.transp0(loc, v)
    return ball.expmap(loc, u)


def wrapped_normal_rsample(
    generator: Optional[torch.Generator],
    ball: PoincareBall,
    loc: torch.Tensor,
    scale: torch.Tensor,
    sample_shape: Tuple[int, ...] = (),
) -> torch.Tensor:
    """Reparameterized sample; shape sample_shape + broadcast(loc, scale).
    The generator must live on loc's device."""
    loc, scale = torch.broadcast_tensors(loc, scale)
    shape = tuple(sample_shape) + tuple(loc.shape)
    eps = draws.randn(shape, generator, loc.device, batch_axis=len(sample_shape))
    return wrapped_normal_rsample_from_eps(ball, loc, scale, eps)


def wrapped_normal_log_prob(
    ball: PoincareBall, loc: torch.Tensor, scale: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Log density at x; shape broadcast(loc.shape[:-1], x.shape[:-1])."""
    v = ball.logmap(loc, x)
    v = ball.transp0back(loc, v)  # PT_{loc->0}
    u = v * 2.0  # * lambda_0
    norm_pdf = normal_log_prob(u, 0.0, scale).sum(dim=-1)
    return norm_pdf - ball.logdetexp(loc, x, keepdim=False)


class WrappedNormal:
    """The distribution object over the functions above (loc, scale,
    manifold; ``rsample``, ``sample``, ``log_prob``, ``mean``,
    ``batch_shape``, ``event_shape``). ``softplus``: ``scale`` is mapped
    through softplus before use. Its draw is eps ~ N(0, I) of the sample's
    shape: ``noise`` draws it, ``rsample_from_eps`` (alias
    ``rsample_from_noise``, the name the Riemannian normal shares) takes
    it."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, manifold: PoincareBall,
                 softplus: bool = False):
        self.loc, self.scale, self.manifold = loc, scale, manifold
        self.softplus = bool(softplus)

    @property
    def _scale(self) -> torch.Tensor:
        return _softplus(self.scale) if self.softplus else self.scale

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    @property
    def batch_shape(self) -> torch.Size:
        return torch.broadcast_shapes(self.loc.shape, self.scale.shape)[:-1]

    @property
    def event_shape(self) -> torch.Size:
        return self.loc.shape[-1:]

    def noise(self, generator: Optional[torch.Generator],
              sample_shape: Tuple[int, ...] = ()) -> Tuple[torch.Tensor]:
        """The draw of ``rsample``: (eps,), eps of sample_shape + the
        broadcast shape of loc and scale."""
        shape = tuple(sample_shape) + tuple(torch.broadcast_shapes(self.loc.shape,
                                                                   self.scale.shape))
        return (draws.randn(shape, generator, self.loc.device, batch_axis=len(sample_shape)),)

    def rsample_from_eps(self, eps: torch.Tensor) -> torch.Tensor:
        return wrapped_normal_rsample_from_eps(self.manifold, self.loc, self._scale, eps)

    rsample_from_noise = rsample_from_eps

    def rsample(self, generator: Optional[torch.Generator],
                sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self.rsample_from_eps(*self.noise(generator, sample_shape))

    def sample(self, generator: Optional[torch.Generator],
               sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """``rsample`` without a gradient."""
        with torch.no_grad():
            return self.rsample(generator, sample_shape)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return wrapped_normal_log_prob(self.manifold, self.loc, self._scale, x)
