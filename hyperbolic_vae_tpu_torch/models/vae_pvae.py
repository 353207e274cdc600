"""The pvae replication's MLP VAE: a wrapped or a Riemannian normal
posterior on the ball, and the importance-weighted bound.

Port of ``hyperbolic_vae_tpu/models/vae_pvae.py`` (experiment 9: MNIST
784 -> 600 (ReLU) -> latent d, batch 128, lr 5e-4, 80 epochs, the
5000-sample bound, a Bernoulli likelihood):

  encoder: flatten -> Linear(hidden) -> ReLU
  mu:      Linear(latent) -> expmap0 onto the c-ball
  scale:   Linear(latent for "wrapped", 1 for "riemannian")
           -> clip(softplus + 1e-3, 1e-3, 10) (and the Riemannian normal
           clips it again to [0.1, 7])
  decoder: ``GeodesicLayer`` (latent -> hidden signed geodesic distances,
           ``decoder_first="geodesic"``) or Linear -> ReLU
           -> Linear(data): Bernoulli logits, flat (B, data)
  loss:    with k_train posterior samples a row, recon = -mean log p(x|z),
           kl = mean(log q(z|x) - log p(z)), p = WrappedNormal(0,
           prior_scale); total = recon + beta kl; elbo = -(recon + kl)
  iwae:    per-sample logsumexp_K(log p(x|z) + log p(z) - log q(z|x)) - log K

Draws come from an explicit ``torch.Generator``: the posterior's
``noise`` (eps (K, B, latent) for the wrapped normal; normals (K, B,
latent), then uniforms (K, B) for the Riemannian one), which
``loss_from_noise`` and ``iwae_from_noise`` take. JAX has no
``generate`` for this family, and neither has the port. Submodule
indices (the port's own layout: JAX has no exporter for this family):
``encoder.1``, ``mu.0``, ``scale.0``, ``decoder.0._weight`` /
``decoder.0._bias`` (geodesic) or ``decoder.0.weight`` / ``.bias``
(linear), ``decoder.2``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device
from hyperbolic_vae_tpu_torch.distributions import (
    RiemannianNormal,
    WrappedNormal,
    wrapped_normal_log_prob,
)
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.models.iwae import iwae_bound
from hyperbolic_vae_tpu_torch.models.vae_gyroplane import _dense
from hyperbolic_vae_tpu_torch.nn import GeodesicLayer

__all__ = ["PvaeMLPVAE"]


def _bernoulli_log_prob(logits, x):
    """Bernoulli log p(x | logits) = -BCE with logits (pvae's likelihood)."""
    return -(torch.clamp_min(logits, 0) - logits * x + torch.log1p(torch.exp(-logits.abs())))


class PvaeMLPVAE(nn.Module):
    """Parameters are drawn on the CPU from ``generator`` (so one seed
    gives the same weights on every device), then moved to ``device``
    (default ``cuda``; raises when there is no card)."""

    # the layers JAX's tensor-parallel rules name by their flax names
    # (parallel/sharding_rules.py): module path -> role, over every layer
    # of the role's type at or under the path
    tp_roles = {"encoder": "enc", "decoder": "gyroplanes", "decoder.2": "dec_out"}

    # every loss entry is a mean over the batch and the k_train samples
    loss_reduction = "per_sample_mean"

    def __init__(
        self,
        data_shape: Sequence[int] = (28, 28, 1),
        hidden_dim: int = 600,
        latent_dim: int = 2,
        manifold_curvature: float = 1.0,
        posterior: str = "wrapped",
        decoder_first: str = "geodesic",
        prior_scale: float = 1.0,
        beta: float = 1.0,
        lr: float = 5e-4,
        k_train: int = 1,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        if posterior not in ("wrapped", "riemannian"):
            raise ValueError(f"posterior must be 'wrapped' or 'riemannian', got {posterior!r}")
        if decoder_first not in ("geodesic", "linear"):
            raise ValueError(f"decoder_first must be 'geodesic' or 'linear', got {decoder_first!r}")
        device = resolve_device(device)
        self.data_shape = tuple(int(d) for d in data_shape)
        self.hidden_dim = int(hidden_dim)
        self.latent_dim = int(latent_dim)
        self.manifold_curvature = float(manifold_curvature)
        self.posterior = posterior
        self.decoder_first = decoder_first
        self.prior_scale = float(prior_scale)
        self.beta = float(beta)
        self.lr = float(lr)
        self.k_train = int(k_train)
        self.ball = PoincareBall(c=self.manifold_curvature)

        n, h, d = self.data_numel, self.hidden_dim, self.latent_dim
        self.encoder = nn.Sequential(nn.Flatten(), _dense(n, h, generator), nn.ReLU())
        self.mu = nn.Sequential(_dense(h, d, generator))
        self.scale = nn.Sequential(_dense(h, d if posterior == "wrapped" else 1, generator))
        first = (GeodesicLayer(d, h, self.ball, generator=generator)
                 if decoder_first == "geodesic" else _dense(d, h, generator))
        self.decoder = nn.Sequential(first, nn.ReLU(), _dense(h, n, generator))
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
            data_shape=self.data_shape, hidden_dim=self.hidden_dim, latent_dim=self.latent_dim,
            manifold_curvature=self.manifold_curvature, posterior=self.posterior,
            decoder_first=self.decoder_first, prior_scale=self.prior_scale, beta=self.beta,
            lr=self.lr, k_train=self.k_train,
        )

    def encode(self, x):
        """Posterior mean on the ball (B, latent) and scale (B, latent) for
        the wrapped normal or (B, 1) for the Riemannian one."""
        h = self.encoder(x.reshape(x.shape[0], -1))
        scale = torch.clamp(nn.functional.softplus(self.scale(h)) + 1e-3, 1e-3, 10.0)
        return self.ball.expmap0(self.mu(h)), scale

    def posterior_mean(self, x):
        """The latent embedding of x: the posterior mean (B, latent)."""
        return self.encode(x)[0]

    def posterior_dist(self, mu, scale):
        if self.posterior == "wrapped":
            return WrappedNormal(mu, scale, self.ball)
        return RiemannianNormal(mu, scale, self.ball)

    def decode(self, z):
        """Latents (B, latent) -> Bernoulli logits, flat (B, data)."""
        return self.decoder(z)

    def noise(self, x, k: int, generator: Optional[torch.Generator] = None) -> Tuple:
        """The posterior's draws for k samples of each row of x, from
        ``generator`` (on the model's device), as the posterior's ``noise``
        draws them: (eps (k, B, latent),) for the wrapped normal; (normals
        (k, B, latent), uniforms (k, B)), in that order, for the Riemannian
        one."""
        b, dev = x.shape[0], self.device
        q = self.posterior_dist(torch.zeros((b, self.latent_dim), device=dev),
                                torch.ones((b, 1), device=dev))
        return q.noise(generator, (k,))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        mu, scale = self.encode(x)
        z = self.posterior_dist(mu, scale).rsample(generator)
        return {"mu": mu, "scale": scale, "z": z, "x_hat": self.decode(z)}

    def _prior_log_prob(self, z):
        d = self.latent_dim
        origin = torch.zeros((d,), dtype=torch.float32, device=z.device)
        prior = torch.full((d,), self.prior_scale, dtype=torch.float32, device=z.device)
        return wrapped_normal_log_prob(self.ball, origin, prior, z)

    def elbo_parts_from_noise(self, x, noise):
        """(log p(x|z), log p(z), log q(z|x)), each (K, B), for the
        posterior's draws ``noise`` of K samples a row."""
        mu, scale = self.encode(x)
        q = self.posterior_dist(mu, scale)
        z = q.rsample_from_noise(*noise)  # (K, B, latent)
        k, b = z.shape[0], x.shape[0]
        logits = self.decode(z.reshape(-1, self.latent_dim)).reshape(k, b, -1)
        log_px_z = _bernoulli_log_prob(logits, x.reshape(1, b, -1)).sum(dim=-1)
        return log_px_z, self._prior_log_prob(z), q.log_prob(z)

    def elbo_parts(self, x, k: int, generator: Optional[torch.Generator] = None):
        return self.elbo_parts_from_noise(x, self.noise(x, k, generator))

    def loss(self, x, generator: Optional[torch.Generator] = None) -> dict:
        """The beta-ELBO with ``k_train`` samples a row (pvae's objective)."""
        return self.loss_from_noise(x, self.noise(x, self.k_train, generator))

    def loss_from_noise(self, x, noise) -> dict:
        """The loss for given posterior draws (``noise``'s form)."""
        log_px_z, log_pz, log_qz = self.elbo_parts_from_noise(x, noise)
        recon = -log_px_z.mean()
        kl = (log_qz - log_pz).mean()
        return {"loss_total": recon + self.beta * kl, "loss_recon": recon, "loss_kl": kl,
                "elbo": -(recon + kl)}

    def iwae(self, x, k: int = 5000, generator: Optional[torch.Generator] = None):
        """The per-sample importance-weighted bound (B,): logsumexp_K(log w)
        - log K, so that ``evaluate_iwae``'s chunks recombine exactly."""
        return self.iwae_from_noise(x, self.noise(x, k, generator))

    def iwae_from_noise(self, x, noise) -> torch.Tensor:
        log_px_z, log_pz, log_qz = self.elbo_parts_from_noise(x, noise)
        return iwae_bound(log_px_z + log_pz - log_qz)

    def reconstruct(self, x, generator: Optional[torch.Generator] = None):
        """Pixel probabilities of one posterior sample, in x's shape
        (stochastic, as in JAX; the serving endpoint decodes the posterior
        mean instead)."""
        return torch.sigmoid(self(x, generator)["x_hat"]).reshape(
            (x.shape[0],) + self.data_shape)
