"""Importance-weighted (IWAE) marginal-likelihood bounds.

Port of ``hyperbolic_vae_tpu/models/iwae.py``. A model's ``iwae(x, k)``
returns the per-sample bound (B,)

    L_k(x) = logsumexp_K [log p(x|z_i) + log p(z_i) - log q(z_i|x)] - log K,

a lower bound on log p(x) that does not decrease with K in expectation
(Burda et al. 2016). ``Trainer.evaluate_iwae`` chunks over the split and
over K and recombines the chunks exactly (``combine_chunked_bounds``),
so K = 5000 never materialises a (K, B, data) tensor.

Draws come from an explicit ``torch.Generator``; the ``*_from_eps``
forms take the standard-normal draw eps (K, B, latent) instead, which is
how the tests feed the JAX package's and the port's the same numbers
(threefry and Philox streams differ).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from hyperbolic_vae_tpu_torch.distributions import (
    normal_log_prob,
    wrapped_normal_log_prob,
    wrapped_normal_rsample_from_eps,
)
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.distributions import draws

__all__ = [
    "combine_chunked_bounds",
    "gaussian_loglik",
    "iwae_bound",
    "latent_log_weights",
    "latent_log_weights_from_eps",
]


def gaussian_loglik(x_flat: torch.Tensor, xh: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Gaussian joint log-likelihood (unit scale by default), summed over
    the trailing feature axis: x (B, D) against xh (K, B, D) -> (K, B)."""
    d = x_flat.shape[-1]
    quad = -0.5 * ((xh - x_flat[None]) ** 2).sum(dim=-1) / (scale**2)
    return quad - 0.5 * d * math.log(2.0 * math.pi) - d * math.log(scale)


def latent_log_weights_from_eps(
    ball: Optional[PoincareBall],
    mu: torch.Tensor,
    scale: torch.Tensor,
    eps: torch.Tensor,
    prior_scale: float,
    loglik_of_z: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """(K, B) importance log-weights for the draw eps (K, B, latent).
    ``ball=None``: a Euclidean latent (diagonal Gaussian q and prior);
    otherwise a WrappedNormal on the ball. ``loglik_of_z`` maps the flat
    latents (K*B, latent) to the joint reconstruction term (K, B)."""
    d = mu.shape[-1]
    if ball is None:
        z = mu[None] + scale[None] * eps
        log_q = normal_log_prob(z, mu[None], scale[None]).sum(dim=-1)
        log_p = normal_log_prob(z, 0.0, prior_scale).sum(dim=-1)
    else:
        z = wrapped_normal_rsample_from_eps(ball, mu, scale, eps)
        log_q = wrapped_normal_log_prob(ball, mu, scale, z)
        origin = torch.zeros((d,), dtype=torch.float32, device=z.device)
        prior = torch.full((d,), prior_scale, dtype=torch.float32, device=z.device)
        log_p = wrapped_normal_log_prob(ball, origin, prior, z)
    log_px = loglik_of_z(z.reshape(-1, d))
    return log_px + log_p - log_q


def latent_log_weights(
    ball: Optional[PoincareBall],
    mu: torch.Tensor,
    scale: torch.Tensor,
    k: int,
    prior_scale: float,
    loglik_of_z: Callable[[torch.Tensor], torch.Tensor],
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """``latent_log_weights_from_eps`` for eps (k, B, latent) ~ N(0, I)
    drawn from ``generator`` (on mu's device)."""
    eps = draws.randn((k,) + tuple(mu.shape), generator, mu.device, batch_axis=1)
    return latent_log_weights_from_eps(ball, mu, scale, eps, prior_scale, loglik_of_z)


def iwae_bound(log_w: torch.Tensor) -> torch.Tensor:
    """(K, B) log-weights -> per-sample bound (B,)."""
    return torch.logsumexp(log_w, dim=0) - math.log(float(log_w.shape[0]))


def combine_chunked_bounds(bounds: Sequence[torch.Tensor], ks: Sequence[int]) -> torch.Tensor:
    """Recombine per-chunk bounds of independent sample chunks exactly:
    bound_i = lse(chunk_i) - log k_i  ->  lse(all) - log(sum k).
    ``bounds`` are (B,) tensors, ``ks`` their sample counts."""
    ks = [float(k) for k in ks]
    stacked = torch.stack([b + math.log(k) for b, k in zip(bounds, ks)], dim=0)
    return torch.logsumexp(stacked, dim=0) - math.log(sum(ks))
