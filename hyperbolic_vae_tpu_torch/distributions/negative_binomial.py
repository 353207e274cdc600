"""Negative-binomial count likelihood for RNA-seq reconstruction.

Port of ``hyperbolic_vae_tpu/distributions/negative_binomial.py``, in
torch's parameterisation (``total_count`` r, success probability of each
trial ``probs``; mean r probs / (1 - probs)):

    log p(k) = lgamma(k + r) - lgamma(r) - lgamma(k + 1)
               + r log(1 - probs) + k log(probs)

with log(probs) = -softplus(-logits) and log(1 - probs) = -softplus(logits)
in the stable softplus. ``value`` may be real (the continuous relaxation
through lgamma).
"""

from __future__ import annotations

from typing import Optional

import torch

from hyperbolic_vae_tpu_torch.distributions.relaxed_bernoulli import softplus


def negative_binomial_log_prob(
    value: torch.Tensor,
    total_count,
    logits: Optional[torch.Tensor] = None,
    probs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """log p(value) under NB(total_count, probs); pass exactly one of
    ``logits`` and ``probs`` (clipped to [1e-6, 1 - 1e-6])."""
    if (logits is None) == (probs is None):
        raise ValueError("pass exactly one of logits/probs")
    if logits is None:
        probs = probs.clamp(1e-6, 1.0 - 1e-6)
        logits = torch.log(probs) - torch.log1p(-probs)
    k = torch.as_tensor(value, dtype=torch.float32, device=logits.device)
    r = torch.as_tensor(total_count, dtype=torch.float32, device=logits.device)
    log_probs = -softplus(-logits)
    log_1m_probs = -softplus(logits)
    return (torch.lgamma(k + r) - torch.lgamma(r) - torch.lgamma(k + 1.0)
            + r * log_1m_probs + k * log_probs)


def nb_mean_dispersion_to_logits(mean: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The logits of NB(total_count=theta) with mean ``mean`` (the scvi
    parameterisation, inverse dispersion theta): log(mean) - log(theta)."""
    return torch.log(mean.clamp_min(1e-8)) - torch.log(theta.clamp_min(1e-8))
