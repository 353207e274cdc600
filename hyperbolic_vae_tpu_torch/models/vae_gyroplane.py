"""Flagship model: MLP VAE with a Poincare latent and a gyroplane decoder.

Port of ``hyperbolic_vae_tpu/models/vae_gyroplane.py``:

  encoder: flatten -> Linear(64) -> GELU -> Linear(16) -> GELU
  mu:      Linear(latent) -> expmap0        (onto the ball)
  scale:   Linear(latent) -> clip(softplus + 1e-3, 1e-3, 10)
  decoder: gyroplane distances (latent -> 16) + bias -> GELU -> Linear(64)
           -> GELU -> Linear(data) -> sigmoid
  loss:    recon = -sum RelaxedBernoulli(T=1, probs=x_hat).log_prob(x)
           kl    = log q(z|x) - log p(z),  p = WrappedNormal(0, prior_scale)
           total = mean(recon + beta * kl)
  iwae:    the K-importance-weighted bound under the same likelihood
           (``models/iwae.py``); its decode of K*B latents is one
           gyroplane-kernel launch on the card

GELU is the tanh approximation (flax's ``gelu`` default). Submodule
indices follow the reference state_dict layout: ``encoder.1``,
``encoder.3``, ``mu.0``, ``scale.0``, ``decoder.0.points``,
``decoder.0.bias``, ``decoder.2``, ``decoder.4``. Data is HWC:
``decode`` returns (B, 28, 28, 1) as the JAX model does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device
from hyperbolic_vae_tpu_torch.distributions import (
    relaxed_bernoulli_log_prob,
    wrapped_normal_log_prob,
    wrapped_normal_rsample,
    wrapped_normal_rsample_from_eps,
)
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.models.iwae import iwae_bound, latent_log_weights_from_eps
from hyperbolic_vae_tpu_torch.models.sampling import prior_sample_from_eps
from hyperbolic_vae_tpu_torch.nn import PoincareHyperplanes
from hyperbolic_vae_tpu_torch.distributions import draws

# flax lecun_normal: variance_scaling(1, fan_in, truncated_normal), whose
# std is corrected for the truncation at two standard deviations
_TRUNC_STD_CORRECTION = 0.87962566103423978


def _lecun_(layer: nn.Module, fan_in: int, generator: Optional[torch.Generator]) -> nn.Module:
    """flax's kernel init on ``layer`` in place: lecun-normal (truncated)
    weight over ``fan_in``, zero bias."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


def _dense(n_in: int, n_out: int, generator: Optional[torch.Generator]) -> nn.Linear:
    """Linear layer with flax's Dense init: lecun-normal (truncated)
    weight, zero bias."""
    return _lecun_(nn.utils.skip_init(nn.Linear, n_in, n_out), n_in, generator)


def _gelu() -> nn.GELU:
    return nn.GELU(approximate="tanh")


class GyroplaneVAE(nn.Module):
    """Parameters are drawn on the CPU from ``generator`` (so one seed
    gives the same weights on every device), then moved to ``device``
    (default ``cuda``; raises when there is no card)."""

    def __init__(
        self,
        data_shape: Sequence[int] = (28, 28, 1),
        latent_dim: int = 2,
        manifold_curvature: float = 1.0,
        beta: float = 1.0,
        prior_scale: float = 1.0,
        hidden_dims: Sequence[int] = (64, 16),
        lr: float = 1e-3,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.data_shape = tuple(int(d) for d in data_shape)
        self.latent_dim = int(latent_dim)
        self.manifold_curvature = float(manifold_curvature)
        self.beta = float(beta)
        self.prior_scale = float(prior_scale)
        self.hidden_dims = tuple(int(d) for d in hidden_dims)
        self.lr = float(lr)
        self.ball = PoincareBall(c=self.manifold_curvature)

        enc = [nn.Flatten()]
        n_in = self.data_numel
        for d in self.hidden_dims:
            enc += [_dense(n_in, d, generator), _gelu()]
            n_in = d
        self.encoder = nn.Sequential(*enc)
        self.mu = nn.Sequential(_dense(n_in, self.latent_dim, generator))
        self.scale = nn.Sequential(_dense(n_in, self.latent_dim, generator))
        dec = [
            PoincareHyperplanes(
                plane_shape=self.latent_dim, num_planes=self.hidden_dims[-1],
                ball=self.ball, generator=generator,
            ),
            _gelu(),
        ]
        n_in = self.hidden_dims[-1]
        for d in reversed(self.hidden_dims[:-1]):
            dec += [_dense(n_in, d, generator), _gelu()]
            n_in = d
        dec += [_dense(n_in, self.data_numel, generator), nn.Sigmoid()]
        self.decoder = nn.Sequential(*dec)
        self.to(device)

    @property
    def data_numel(self) -> int:
        return int(math.prod(self.data_shape))

    @property
    def device(self) -> torch.device:
        return self.mu[0].weight.device

    def hparams(self) -> dict:
        """The constructor's configuration (everything but the weights)."""
        return dict(
            data_shape=self.data_shape, latent_dim=self.latent_dim,
            manifold_curvature=self.manifold_curvature, beta=self.beta,
            prior_scale=self.prior_scale, hidden_dims=self.hidden_dims, lr=self.lr,
        )

    def encode(self, x):
        """Posterior mean on the ball and scale, each (B, latent)."""
        h = self.encoder(x)
        scale = torch.clamp(F.softplus(self.scale(h)) + 1e-3, 1e-3, 10.0)
        return self.ball.expmap0(self.mu(h)), scale

    def posterior_mean(self, x):
        """The latent embedding of x: the posterior mean (B, latent)."""
        return self.encode(x)[0]

    def decode(self, z):
        x_hat = self.decoder(z)
        return x_hat.reshape((z.shape[0],) + self.data_shape)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        mu, scale = self.encode(x)
        z = wrapped_normal_rsample(generator, self.ball, mu, scale)
        return {"mu": mu, "scale": scale, "z": z, "x_hat": self.decode(z)}

    def loss(self, x, generator: Optional[torch.Generator] = None) -> dict:
        """The metric dict {loss_total, recon_loss, kl_loss}, each a mean
        over the batch, for one posterior sample per row. The draw is
        eps (B, latent) ~ N(0, I) from ``generator`` (on the model's
        device), as ``wrapped_normal_rsample`` makes it."""
        out = self(x, generator)
        return self._loss_parts(x, out["mu"], out["scale"], out["z"], out["x_hat"])

    def loss_from_eps(self, x, eps) -> dict:
        """The loss for a given standard-normal draw eps (B, latent)."""
        mu, scale = self.encode(x)
        z = wrapped_normal_rsample_from_eps(self.ball, mu, scale, eps)
        return self._loss_parts(x, mu, scale, z, self.decode(z))

    def _loss_parts(self, x, mu, scale, z, x_hat) -> dict:
        xf = x.reshape(x.shape[0], -1)
        xhf = x_hat.reshape(x.shape[0], -1)
        recon = -relaxed_bernoulli_log_prob(xf, 1.0, probs=xhf).sum(dim=-1)
        log_q = wrapped_normal_log_prob(self.ball, mu, scale, z)
        origin = torch.zeros((self.latent_dim,), dtype=torch.float32, device=z.device)
        prior = torch.full((self.latent_dim,), self.prior_scale, dtype=torch.float32,
                           device=z.device)
        kl = log_q - wrapped_normal_log_prob(self.ball, origin, prior, z)
        return {
            "loss_total": (recon + self.beta * kl).mean(),
            "recon_loss": recon.mean(),
            "kl_loss": kl.mean(),
        }

    def iwae(self, x, k: int = 1000, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-sample K-importance-weighted log p(x) bound (B,) for eps
        (k, B, latent) ~ N(0, I) drawn from ``generator`` (on the model's
        device)."""
        eps = draws.randn((k, x.shape[0], self.latent_dim), generator, self.device, batch_axis=1)
        return self.iwae_from_eps(x, eps)

    def iwae_from_eps(self, x, eps) -> torch.Tensor:
        """The bound for a given draw eps (K, B, latent): the parity hook,
        as ``loss_from_eps`` is the loss's. The K*B latents are decoded in
        one call, and the log density is summed within it; call it under
        ``torch.no_grad()`` when no gradient is wanted."""
        k, b = eps.shape[0], x.shape[0]
        xf = x.reshape(b, -1)
        mu, scale = self.encode(x)

        def loglik(zf):
            xh = self.decode(zf).reshape(k, b, -1)
            return relaxed_bernoulli_log_prob(xf[None], 1.0, probs=xh).sum(dim=-1)

        log_w = latent_log_weights_from_eps(self.ball, mu, scale, eps, self.prior_scale, loglik)
        return iwae_bound(log_w)

    def generate(self, n: int = 64, generator: Optional[torch.Generator] = None):
        """Decode n prior draws z ~ WrappedNormal(0, prior_scale): pixel
        probabilities in (0, 1). The generator lives on the model's device."""
        return self.generate_from_eps(torch.randn((n, self.latent_dim), generator=generator,
                                                  device=self.device, dtype=torch.float32))

    def generate_from_eps(self, eps):
        """``generate`` for a given standard-normal draw eps (n, latent)."""
        return self.decode(prior_sample_from_eps(self.ball, eps, self.prior_scale))

    def reconstruct(self, x, generator: Optional[torch.Generator] = None):
        """Decode one posterior sample (stochastic, as in JAX; the serving
        endpoint decodes the posterior mean instead)."""
        return self(x, generator)["x_hat"]
