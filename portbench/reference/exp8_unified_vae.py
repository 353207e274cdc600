"""Plain reference of experiment 8's UnifiedVAE (the reference's script
``_8_train_vaes_rnaseq.py``, ``vae_one_b.VAE``) as that script configures
it: hidden 100, latent 2 on the ball of curvature 1, learned posterior
scale, GELU, sigmoid output, MSE reconstruction, the analytic KL of
log_0(mu) against N(0, prior_scale), in plain PyTorch.

  encoder: x (B, genes) -> Linear(hidden) -> GELU
  mu:      Linear(latent) -> exp_0 onto the ball
  scale:   Linear(latent) -> clip(softplus + 1e-3, 1e-3, 10)
  z:       one wrapped-normal draw at mu from eps (B, latent)
  decoder: signed gyroplane distances (latent -> hidden planes) + bias ->
           GELU -> Linear(genes) -> sigmoid
  recon:   mean over every element of (x_hat - x)^2
  kl:      mean over every element of KL(N(log_0(mu), scale) || N(0, prior_scale))
  total:   recon + beta kl
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import _ball as ball

METRICS = ("loss_total", "loss_reconstruction", "loss_kl")
MANIFOLD = ("decoder.0.points",)


def param_specs(model_cfg: dict) -> list:
    """(name, shape, init, fan_in) of every parameter, in the reference's
    state_dict order (see ``flagship_gyroplane_vae.param_specs``)."""
    kw = model_cfg["kwargs"]
    n = int(math.prod(kw["input_size"]))
    h, lat = kw["hidden_layer_dim"], kw["latent_dim"]
    return [
        ("encoder.0.weight", (h, n), "lecun", n), ("encoder.0.bias", (h,), "zeros", n),
        ("mu.0.weight", (lat, h), "lecun", h), ("mu.0.bias", (lat,), "zeros", h),
        ("scale.0.weight", (lat, h), "lecun", h), ("scale.0.bias", (lat,), "zeros", h),
        ("decoder.0.points", (h, lat), "ball", lat), ("decoder.0.bias", (h,), "pm1", lat),
        ("decoder.2.weight", (n, h), "lecun", h), ("decoder.2.bias", (n,), "zeros", h),
    ]


def loss(params: dict, x: torch.Tensor, eps: torch.Tensor, model_cfg: dict) -> dict:
    """The metrics {loss_total, loss_reconstruction, loss_kl} for the batch
    x (B, genes) and the draws eps (B, latent), and ``loss_scale``, the
    comparison's scale (the magnitudes summed into the loss)."""
    kw = model_cfg["kwargs"]
    c, beta, prior = float(kw["latent_curvature"]), float(kw["beta"]), float(kw["prior_scale"])
    p = params
    xf = x.reshape(x.shape[0], -1)
    h = F.gelu(F.linear(xf, p["encoder.0.weight"], p["encoder.0.bias"]), approximate="tanh")
    mu = ball.expmap0(F.linear(h, p["mu.0.weight"], p["mu.0.bias"]), c)
    scale = torch.clamp(F.softplus(F.linear(h, p["scale.0.weight"], p["scale.0.bias"])) + 1e-3,
                        1e-3, 10.0)
    z = ball.wrapped_normal_rsample(mu, scale, eps, c)
    g = ball.gyroplane_distance(z, p["decoder.0.points"], c) + p["decoder.0.bias"]
    g = F.gelu(g, approximate="tanh")
    x_hat = torch.sigmoid(F.linear(g, p["decoder.2.weight"], p["decoder.2.bias"]))
    recon = ((x_hat - xf) ** 2).mean(-1)
    mu_t = ball.logmap0(mu, c)
    var_ratio = (scale / prior) ** 2
    kl = (0.5 * (var_ratio + (mu_t / prior) ** 2 - 1.0 - torch.log(var_ratio))).mean(-1)
    total = recon + beta * kl
    # every term is at least 0: the magnitudes summed are the loss itself
    return {"loss_total": total.mean(), "loss_reconstruction": recon.mean(),
            "loss_kl": kl.mean(), "loss_scale": total.mean()}
