"""RelaxedBernoulli (binary Concrete) log density.

Port of ``hyperbolic_vae_tpu/distributions/relaxed_bernoulli.py``. With
temperature l, logit a and y = logit(x):

    log p(x) = log l + a - l y - 2 softplus(a - l y) - log x - log(1 - x)

probs are clipped to [1e-7, 1 - 1e-7] and x to [tiny, 1 - eps] of its
dtype, so pixels of exactly 0 or 1 (most of MNIST) give finite values.
At x = 0, a - l y reaches ~100, where exp overflows f32: softplus is
taken in the stable form max(d, 0) + log1p(exp(-|d|)), as
``jax.nn.softplus`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) without overflow, with slope 1/2 at x = 0 as
    ``jax.nn.softplus`` (``logaddexp(x, 0)``): ``clamp_min`` alone passes
    slope 1 there. Values and slopes elsewhere are those of the plain
    stable form."""
    relu = torch.where(x == 0.0, 0.5 * x, x.clamp_min(0.0))
    return relu + torch.log1p(torch.exp(-x.abs()))


def relaxed_bernoulli_log_prob(
    x: torch.Tensor,
    temperature: float,
    logits: Optional[torch.Tensor] = None,
    probs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if (logits is None) == (probs is None):
        raise ValueError("pass exactly one of logits / probs")
    if logits is None:
        p = probs.clamp(1e-7, 1.0 - 1e-7)
        logits = torch.log(p) - torch.log1p(-p)
    finfo = torch.finfo(x.dtype if x.is_floating_point() else torch.float32)
    xc = x.clamp(finfo.tiny, 1.0 - finfo.eps)
    y = torch.log(xc) - torch.log1p(-xc)  # logit(x)
    diff = logits - temperature * y
    base = math.log(temperature) + diff - 2.0 * softplus(diff)
    # change of variables: d logit(x) / dx = 1 / (x (1 - x))
    return base - torch.log(xc) - torch.log1p(-xc)
