"""Plain reference of the flagship GyroplaneVAE (the reference's script
``_6_train_vae_hyperbolic_mnist_gyroplane.py``): its parameters, its
forward pass and its ELBO, in plain PyTorch.

  encoder: x (B, 784) -> Linear(64) -> GELU -> Linear(16) -> GELU
  mu:      Linear(latent) -> exp_0 onto the ball of curvature c
  scale:   Linear(latent) -> clip(softplus + 1e-3, 1e-3, 10)
  z:       one wrapped-normal draw at mu from eps (B, latent)
  decoder: signed gyroplane distances (latent -> 16 planes) + bias -> GELU
           -> Linear(64) -> GELU -> Linear(784) -> sigmoid
  recon:   -sum over pixels of RelaxedBernoulli(T = 1, probs).log_prob(x)
  kl:      log q(z | x) - log p(z), p the wrapped normal at the origin
           with scale prior_scale
  total:   mean over the batch of recon + beta kl

GELU is the tanh approximation. The relaxed Bernoulli clips probs to
[1e-7, 1 - 1e-7] and x to [tiny, 1 - eps] of f32, so pixels of exactly
0 or 1 stay finite. Parameter names and layouts follow the reference's
state_dict (weights (out, in)).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import _ball as ball

METRICS = ("loss_total", "recon_loss", "kl_loss")
MANIFOLD = ("decoder.0.points",)
_F32 = torch.finfo(torch.float32)


def param_specs(model_cfg: dict) -> list:
    """(name, shape, init, fan_in) of every parameter, in the reference's
    state_dict order. ``init``: lecun (truncated normal over fan_in),
    zeros, ball (a point on the ball) or pm1 (uniform on (-1, 1))."""
    kw = model_cfg["kwargs"]
    d = int(math.prod(kw["data_shape"]))
    h1, h2 = kw["hidden_dims"]
    lat = kw["latent_dim"]
    return [
        ("encoder.1.weight", (h1, d), "lecun", d), ("encoder.1.bias", (h1,), "zeros", d),
        ("encoder.3.weight", (h2, h1), "lecun", h1), ("encoder.3.bias", (h2,), "zeros", h1),
        ("mu.0.weight", (lat, h2), "lecun", h2), ("mu.0.bias", (lat,), "zeros", h2),
        ("scale.0.weight", (lat, h2), "lecun", h2), ("scale.0.bias", (lat,), "zeros", h2),
        ("decoder.0.points", (h2, lat), "ball", lat), ("decoder.0.bias", (h2,), "pm1", lat),
        ("decoder.2.weight", (h1, h2), "lecun", h2), ("decoder.2.bias", (h1,), "zeros", h2),
        ("decoder.4.weight", (d, h1), "lecun", h1), ("decoder.4.bias", (d,), "zeros", h1),
    ]


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _relaxed_bernoulli_log_prob(x, probs, temperature: float = 1.0):
    p = probs.clamp(1e-7, 1.0 - 1e-7)
    logits = torch.log(p) - torch.log1p(-p)
    xc = x.clamp(_F32.tiny, 1.0 - _F32.eps)
    y = torch.log(xc) - torch.log1p(-xc)
    diff = logits - temperature * y
    # softplus with slope 1/2 at 0, stable for large |diff|
    sp = torch.where(diff == 0.0, 0.5 * diff, diff.clamp_min(0.0)) + torch.log1p(torch.exp(-diff.abs()))
    return math.log(temperature) + diff - 2.0 * sp - torch.log(xc) - torch.log1p(-xc)


def loss(params: dict, x: torch.Tensor, eps: torch.Tensor, model_cfg: dict) -> dict:
    """The metrics {loss_total, recon_loss, kl_loss}, batch means, for the
    batch x (B, ...) and the draws eps (B, latent), and ``loss_scale``,
    the rows' mean of the magnitudes summed into their loss (every
    pixel's |log density|, beta |log q| and beta |log p|): the
    comparison's scale, since a row's terms can cancel to near 0."""
    kw = model_cfg["kwargs"]
    c, beta, prior = float(kw["manifold_curvature"]), float(kw["beta"]), float(kw["prior_scale"])
    p = params
    xf = x.reshape(x.shape[0], -1)
    h = _gelu(F.linear(xf, p["encoder.1.weight"], p["encoder.1.bias"]))
    h = _gelu(F.linear(h, p["encoder.3.weight"], p["encoder.3.bias"]))
    mu = ball.expmap0(F.linear(h, p["mu.0.weight"], p["mu.0.bias"]), c)
    scale = torch.clamp(F.softplus(F.linear(h, p["scale.0.weight"], p["scale.0.bias"])) + 1e-3,
                        1e-3, 10.0)
    z = ball.wrapped_normal_rsample(mu, scale, eps, c)
    g = ball.gyroplane_distance(z, p["decoder.0.points"], c) + p["decoder.0.bias"]
    g = _gelu(F.linear(_gelu(g), p["decoder.2.weight"], p["decoder.2.bias"]))
    x_hat = torch.sigmoid(F.linear(g, p["decoder.4.weight"], p["decoder.4.bias"]))
    pixels = _relaxed_bernoulli_log_prob(xf, x_hat)
    recon = -pixels.sum(-1)
    lat = mu.shape[-1]
    origin = torch.zeros((lat,), dtype=z.dtype, device=z.device)
    prior_scale = torch.full((lat,), prior, dtype=z.dtype, device=z.device)
    log_q = ball.wrapped_normal_log_prob(mu, scale, z, c)
    log_p = ball.wrapped_normal_log_prob(origin, prior_scale, z, c)
    kl = log_q - log_p
    magnitude = pixels.abs().sum(-1) + beta * (log_q.abs() + log_p.abs())
    return {"loss_total": (recon + beta * kl).mean(), "recon_loss": recon.mean(),
            "kl_loss": kl.mean(), "loss_scale": magnitude.mean()}
