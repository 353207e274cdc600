"""Wrapped normal distribution on the Poincare ball: sampling.

Port of the sampling half of
``hyperbolic_vae_tpu/distributions/wrapped_normal.py``:

    eps ~ N(0, I);  v = scale * eps / lambda_0
    u = PT_{0->loc}(v);      z = exp_loc(u)

with the tangent draw truncated to the chart radius the f32 chart
represents faithfully (see MAX_SAMPLE_RADIUS). ``log_prob`` arrives with
the training slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

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
    eps = torch.randn(shape, generator=generator, device=loc.device, dtype=torch.float32)
    return wrapped_normal_rsample_from_eps(ball, loc, scale, eps)
