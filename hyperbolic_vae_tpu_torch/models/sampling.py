"""Latent-prior sampling: z ~ WrappedNormal(0, prior_scale) on the ball.

Port of ``hyperbolic_vae_tpu/models/sampling.py`` for Poincare latents,
with an explicit ``torch.Generator`` in place of the module's RNG stream.
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
    ball: PoincareBall,
    n: int,
    latent_dim: int,
    prior_scale: float = 1.0,
    device=None,
) -> torch.Tensor:
    """(n, latent_dim) draws from the wrapped-normal prior at the origin,
    on ``device`` (the generator's device)."""
    zeros = torch.zeros((n, latent_dim), dtype=torch.float32, device=device)
    scale = torch.full((n, latent_dim), prior_scale, dtype=torch.float32, device=device)
    return wrapped_normal_rsample(generator, ball, zeros, scale)


def prior_sample_from_eps(
    ball: PoincareBall, eps: torch.Tensor, prior_scale: float = 1.0
) -> torch.Tensor:
    """The prior sample for a given standard-normal draw eps (n, latent)."""
    zeros = torch.zeros_like(eps)
    scale = torch.full_like(eps, prior_scale)
    return wrapped_normal_rsample_from_eps(ball, zeros, scale, eps)
