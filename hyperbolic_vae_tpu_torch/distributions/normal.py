"""Euclidean normal helpers: the log density and the analytic KLs.

Port of ``hyperbolic_vae_tpu/distributions/normal.py``. The analytic
Gaussian KL is the Euclidean VAE's loss term; ``normal_log_prob`` is the
one ``wrapped_normal.py`` defines, re-exported here.
"""

from __future__ import annotations

import torch

from hyperbolic_vae_tpu_torch.distributions.wrapped_normal import normal_log_prob

__all__ = ["kl_normal_normal", "kl_std_normal_from_logvar", "normal_log_prob"]


def kl_normal_normal(loc_p, scale_p, loc_q, scale_q) -> torch.Tensor:
    """KL(N(loc_p, scale_p) || N(loc_q, scale_q)), elementwise."""
    var_ratio = (scale_p / scale_q) ** 2
    t1 = ((loc_p - loc_q) / scale_q) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def kl_std_normal_from_logvar(mu, log_var) -> torch.Tensor:
    """-0.5 (1 + log_var - mu^2 - exp(log_var)), elementwise: KL(N(mu,
    exp(log_var)) || N(0, 1))."""
    return -0.5 * (1.0 + log_var - mu * mu - torch.exp(log_var))
