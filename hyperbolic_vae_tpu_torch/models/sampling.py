"""Latent-prior sampling: z ~ WrappedNormal(0, prior_scale) on the ball,
or N(0, prior_scale^2 I) for a Euclidean latent (``ball=None``).

Port of ``hyperbolic_vae_tpu/models/sampling.py``, with an explicit
``torch.Generator`` in place of the module's RNG stream.
"""

from __future__ import annotations

from typing import Optional

import torch

from hyperbolic_vae_tpu_torch.distributions import (
    wrapped_normal_rsample,
    wrapped_normal_rsample_from_eps,
)
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall

__all__ = ["prior_sample", "prior_sample_from_eps"]


def prior_sample(
    generator: Optional[torch.Generator],
    ball: Optional[PoincareBall],
    n: int,
    latent_dim: int,
    prior_scale: float = 1.0,
    device=None,
) -> torch.Tensor:
    """(n, latent_dim) draws from the latent prior (``ball=None``: a
    Euclidean latent), on ``device`` (the generator's device)."""
    if ball is None:
        eps = torch.randn((n, latent_dim), generator=generator, device=device, dtype=torch.float32)
        return prior_scale * eps
    zeros = torch.zeros((n, latent_dim), dtype=torch.float32, device=device)
    scale = torch.full((n, latent_dim), prior_scale, dtype=torch.float32, device=device)
    return wrapped_normal_rsample(generator, ball, zeros, scale)


def prior_sample_from_eps(
    ball: Optional[PoincareBall], eps: torch.Tensor, prior_scale: float = 1.0
) -> torch.Tensor:
    """The prior sample for a given standard-normal draw eps (n, latent)."""
    if ball is None:
        return prior_scale * eps
    zeros = torch.zeros_like(eps)
    scale = torch.full_like(eps, prior_scale)
    return wrapped_normal_rsample_from_eps(ball, zeros, scale, eps)
