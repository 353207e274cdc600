"""The unified configurable VAE (the reference's ``vae_one`` design).

Port of ``hyperbolic_vae_tpu/models/vae_unified.py``:

  encoder: flatten -> Linear(hidden) -> activation ("gelu", tanh
           approximation, or "relu")
  mu:      Linear(latent), then expmap0 onto the ball when there is one
  scale:   Linear(latent) -> clip(softplus + 1e-3, 1e-3, 10)
           (``posterior_scale="learned"``), or ones (``"fixed"``)
  decoder: gyroplane distances (latent -> hidden) + bias on the ball
           (``latent_curvature`` c > 0; K1 on the card), or Linear for a
           Euclidean latent (``latent_curvature=None`` or 0)
           -> activation -> Linear(data) -> last activation
           ("none" | "sigmoid" | "softplus")
  recon:   "MSE" | "binary_cross_entropy" |
           "binary_cross_entropy_with_logits" | "relaxed bernoulli"
           (T = 0.3, on logits or probs), each a mean over every element
  kl:      "logmap0_analytic" (the Gaussian KL of logmap0(mu) against
           N(0, prior_scale)), "log_prob" or "logmap0_log_prob" (Monte
           Carlo, weighted by exp(log q) as the reference weights them),
           each a mean over the batch; log q is the intended diagonal
           log q(z_i | x_i), not the reference's O(B^2) cross product
  total:   recon + beta kl; every entry a per-sample mean

Draws come from an explicit ``torch.Generator``: eps (B, latent) ~ N(0,
I) for the posterior sample (the wrapped normal's, or mu + scale eps);
``loss_from_eps``, ``iwae_from_eps`` and ``generate_from_eps`` take it.
Submodule indices follow the reference state_dict layout (JAX's
``export_torch_state_dict``): ``encoder.1`` for a multi-dimensional
``input_size`` (a Flatten at 0), else ``encoder.0``; ``mu.0``;
``scale.0`` when learned; ``decoder.0.points`` / ``decoder.0.bias`` on
the ball, ``decoder.0.weight`` / ``.bias`` otherwise; ``decoder.2``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device
from hyperbolic_vae_tpu_torch.distributions import (
    kl_normal_normal,
    normal_log_prob,
    relaxed_bernoulli_log_prob,
    wrapped_normal_log_prob,
    wrapped_normal_rsample_from_eps,
)
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.models.iwae import (
    gaussian_loglik,
    iwae_bound,
    latent_log_weights_from_eps,
)
from hyperbolic_vae_tpu_torch.models.sampling import prior_sample_from_eps
from hyperbolic_vae_tpu_torch.models.vae_gyroplane import _dense, _gelu
from hyperbolic_vae_tpu_torch.nn import PoincareHyperplanes
from hyperbolic_vae_tpu_torch.distributions import draws

__all__ = ["UnifiedVAE", "VAE"]

_ACTIVATIONS = {"gelu": _gelu, "relu": nn.ReLU}
_LAST = {"none": nn.Identity, "sigmoid": nn.Sigmoid, "softplus": nn.Softplus}
_RECON = ("MSE", "binary_cross_entropy", "binary_cross_entropy_with_logits", "relaxed bernoulli")
_KL = ("log_prob", "logmap0_analytic", "logmap0_log_prob")
_RB_TEMPERATURE = 0.3


def _bce(probs, x):
    p = torch.clamp(probs, 1e-7, 1.0 - 1e-7)
    return -(x * torch.log(p) + (1.0 - x) * torch.log1p(-p))


def _bce_with_logits(logits, x):
    return torch.clamp_min(logits, 0) - logits * x + torch.log1p(torch.exp(-logits.abs()))


class UnifiedVAE(nn.Module):
    """Parameters are drawn on the CPU from ``generator`` (so one seed
    gives the same weights on every device), then moved to ``device``
    (default ``cuda``; raises when there is no card)."""

    # the layers JAX's tensor-parallel rules name by their flax names
    # (parallel/sharding_rules.py): module path -> role, over every layer
    # of the role's type at or under the path
    tp_roles = {"encoder": "enc", "decoder": "gyroplanes", "decoder.2": "dec_out"}

    # every loss entry is a per-sample mean (gradient accumulation is exact)
    loss_reduction = "per_sample_mean"

    def __init__(
        self,
        input_size: Sequence[int] = (28, 28, 1),
        hidden_layer_dim: int = 100,
        latent_dim: int = 2,
        latent_curvature: Optional[float] = 1.0,
        prior_scale: float = 1.0,
        posterior_scale: str = "learned",
        learning_rate: float = 1e-3,
        beta: float = 1.0,
        kl_loss_method: str = "logmap0_analytic",
        activation: str = "gelu",
        last_activation: str = "none",
        loss_recon_method: str = "MSE",
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        for name, value, allowed in (
                ("posterior_scale", posterior_scale, ("learned", "fixed")),
                ("activation", activation, tuple(_ACTIVATIONS)),
                ("last_activation", last_activation, tuple(_LAST)),
                ("loss_recon_method", loss_recon_method, _RECON),
                ("kl_loss_method", kl_loss_method, _KL)):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
        device = resolve_device(device)
        self.input_size = tuple(int(d) for d in input_size)
        self.hidden_layer_dim = int(hidden_layer_dim)
        self.latent_dim = int(latent_dim)
        self.latent_curvature = float(latent_curvature) if latent_curvature else None
        self.prior_scale = float(prior_scale)
        self.posterior_scale = posterior_scale
        self.learning_rate = float(learning_rate)
        self.beta = float(beta)
        self.kl_loss_method = kl_loss_method
        self.activation = activation
        self.last_activation = last_activation
        self.loss_recon_method = loss_recon_method
        self.ball = PoincareBall(c=self.latent_curvature) if self.latent_curvature else None

        n, h, d = self.input_features, self.hidden_layer_dim, self.latent_dim
        act = _ACTIVATIONS[activation]
        enc = [nn.Flatten()] if len(self.input_size) > 1 else []
        self.encoder = nn.Sequential(*enc, _dense(n, h, generator), act())
        self.mu = nn.Sequential(_dense(h, d, generator))
        if posterior_scale == "learned":
            self.scale = nn.Sequential(_dense(h, d, generator))
        first = (PoincareHyperplanes(plane_shape=d, num_planes=h, ball=self.ball,
                                     generator=generator)
                 if self.ball is not None else _dense(d, h, generator))
        self.decoder = nn.Sequential(first, act(), _dense(h, n, generator), _LAST[last_activation]())
        self.to(device)

    @property
    def input_features(self) -> int:
        return int(math.prod(self.input_size))

    @property
    def data_shape(self) -> tuple:
        return self.input_size

    @property
    def lr(self) -> float:
        return self.learning_rate

    @property
    def device(self) -> torch.device:
        return self.mu[0].weight.device

    def hparams(self) -> dict:
        """The constructor's configuration (everything but the weights)."""
        return dict(
            input_size=self.input_size, hidden_layer_dim=self.hidden_layer_dim,
            latent_dim=self.latent_dim, latent_curvature=self.latent_curvature,
            prior_scale=self.prior_scale, posterior_scale=self.posterior_scale,
            learning_rate=self.learning_rate, beta=self.beta,
            kl_loss_method=self.kl_loss_method, activation=self.activation,
            last_activation=self.last_activation, loss_recon_method=self.loss_recon_method,
        )

    def encode(self, x):
        """Posterior mean (on the ball when there is one) and scale, each
        (B, latent)."""
        h = self.encoder(x.reshape(x.shape[0], -1))
        mu = self.mu(h)
        if self.ball is not None:
            mu = self.ball.expmap0(mu)
        if self.posterior_scale == "learned":
            scale = torch.clamp(nn.functional.softplus(self.scale(h)) + 1e-3, 1e-3, 10.0)
        else:
            scale = torch.ones_like(mu)
        return mu, scale

    def posterior_mean(self, x):
        """The latent embedding of x: the posterior mean (B, latent)."""
        return self.encode(x)[0]

    def decode(self, z):
        """Latents (B, latent) -> outputs (B, *input_size) after the last
        activation (logits with "none")."""
        return self.decoder(z).reshape((z.shape[0],) + self.input_size)

    def _sample(self, mu, scale, eps):
        if self.ball is not None:
            return wrapped_normal_rsample_from_eps(self.ball, mu, scale, eps)
        return mu + scale * eps

    def _eps(self, shape, generator):
        # (B, latent) or (K, B, latent): the batch is the second-to-last axis
        return draws.randn(shape, generator, self.device, batch_axis=len(shape) - 2)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        mu, scale = self.encode(x)
        z = self._sample(mu, scale, self._eps(mu.shape, generator))
        return {"mu": mu, "scale": scale, "z": z, "x_hat": self.decode(z)}

    # ---- losses ----

    def loss_recon(self, x, output):
        m = self.loss_recon_method
        if m == "MSE":
            return ((output - x) ** 2).mean()
        if m == "binary_cross_entropy":
            return _bce(output, x).mean()
        if m == "binary_cross_entropy_with_logits":
            return _bce_with_logits(output, x).mean()
        xf, of = x.reshape(x.shape[0], -1), output.reshape(output.shape[0], -1)
        if self.last_activation == "none":
            lp = relaxed_bernoulli_log_prob(xf, _RB_TEMPERATURE, logits=of)
        elif self.last_activation == "sigmoid":
            lp = relaxed_bernoulli_log_prob(xf, _RB_TEMPERATURE, probs=of)
        else:
            raise ValueError(f"last_activation {self.last_activation} not compatible with "
                             "relaxed bernoulli")
        return -lp.mean()

    def loss_kl(self, mu, scale, z):
        ball, method, prior = self.ball, self.kl_loss_method, self.prior_scale
        if method == "logmap0_analytic":
            mu_t = ball.logmap0(mu) if ball is not None else mu
            return kl_normal_normal(mu_t, scale, 0.0, prior).mean()
        if method == "log_prob":
            if ball is not None:
                d = self.latent_dim
                lq = wrapped_normal_log_prob(ball, mu, scale, z)
                # the prior's loc and scale are (latent,): no (B, B) broadcast
                origin = torch.zeros((d,), dtype=torch.float32, device=z.device)
                lp = wrapped_normal_log_prob(
                    ball, origin, torch.full((d,), prior, dtype=torch.float32, device=z.device), z)
            else:
                lq = normal_log_prob(z, mu, scale).sum(dim=-1)
                lp = normal_log_prob(z, 0.0, prior).sum(dim=-1)
        else:  # logmap0_log_prob
            mu_t = ball.logmap0(mu) if ball is not None else mu
            z_t = ball.logmap0(z) if ball is not None else z
            lq = normal_log_prob(z_t, mu_t, scale).sum(dim=-1)
            lp = normal_log_prob(z_t, 0.0, prior).sum(dim=-1)
        # the reference's importance weighting exp(log q)
        return (torch.exp(lq) * (lq - lp)).mean()

    def loss(self, x, generator: Optional[torch.Generator] = None) -> dict:
        """{loss_total, loss_reconstruction, loss_kl} for one posterior
        sample per row: eps (B, latent) ~ N(0, I) from ``generator`` (on
        the model's device)."""
        return self.loss_from_eps(x, self._eps((x.shape[0], self.latent_dim), generator))

    def loss_from_eps(self, x, eps) -> dict:
        """The loss for a given standard-normal draw eps (B, latent)."""
        mu, scale = self.encode(x)
        z = self._sample(mu, scale, eps)
        loss_recon = self.loss_recon(x, self.decode(z))
        loss_kl = self.loss_kl(mu, scale, z)
        return {
            "loss_total": loss_recon + self.beta * loss_kl,
            "loss_reconstruction": loss_recon,
            "loss_kl": loss_kl,
        }

    def transform_decoder_output(self, output):
        """Sigmoid of a logit-space output (for figures and generate)."""
        if self.last_activation == "none" and self.loss_recon_method in _RECON[1:]:
            return torch.sigmoid(output)
        return output

    def iwae(self, x, k: int = 256, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-sample K-importance-weighted log p(x) bound (B,) for eps
        (k, B, latent) ~ N(0, I) from ``generator`` (on the model's device)."""
        return self.iwae_from_eps(x, self._eps((k, x.shape[0], self.latent_dim), generator))

    def iwae_from_eps(self, x, eps) -> torch.Tensor:
        """The bound for a given draw eps (K, B, latent), on either latent
        geometry, with the likelihood of ``loss_recon_method`` summed over
        features (MSE a unit Gaussian; the bce variants Bernoulli, the
        same clip as training's; relaxed bernoulli T = 0.3). The K*B
        latents are decoded in one call (one K1 launch on the card)."""
        k, b = eps.shape[0], x.shape[0]
        xf = x.reshape(b, -1)
        mu, scale = self.encode(x)
        m = self.loss_recon_method

        def loglik(zf):
            xh = self.decode(zf).reshape(k, b, -1)
            if m == "MSE":
                return gaussian_loglik(xf, xh)
            if m != "relaxed bernoulli":
                f = _bce if m == "binary_cross_entropy" else _bce_with_logits
                return -f(xh, xf[None]).sum(dim=-1)
            kw = {"logits": xh} if self.last_activation == "none" else {"probs": xh}
            return relaxed_bernoulli_log_prob(xf[None], _RB_TEMPERATURE, **kw).sum(dim=-1)

        return iwae_bound(latent_log_weights_from_eps(self.ball, mu, scale, eps,
                                                      self.prior_scale, loglik))

    def generate(self, n: int = 64, generator: Optional[torch.Generator] = None):
        """Decode n prior draws (WrappedNormal(0, prior_scale) on the ball,
        N(0, prior_scale^2 I) otherwise) through
        ``transform_decoder_output``; the generator lives on the model's
        device."""
        return self.generate_from_eps(torch.randn((n, self.latent_dim), generator=generator,
                                                  device=self.device, dtype=torch.float32))

    def generate_from_eps(self, eps):
        """``generate`` for a given standard-normal draw eps (n, latent)."""
        z = prior_sample_from_eps(self.ball, eps, self.prior_scale)
        return self.transform_decoder_output(self.decode(z))

    def reconstruct(self, x, generator: Optional[torch.Generator] = None):
        """Decode one posterior sample (stochastic, as in JAX; the serving
        endpoint decodes the posterior mean instead)."""
        return self.transform_decoder_output(self(x, generator)["x_hat"])


# the reference's class name
VAE = UnifiedVAE
