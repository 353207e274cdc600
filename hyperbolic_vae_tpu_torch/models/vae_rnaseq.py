"""Hyperbolic VAE for 1-D expression vectors (scRNA-seq).

Port of ``hyperbolic_vae_tpu/models/vae_rnaseq.py``:

  encoder: Linear(genes -> hidden) -> GELU
  mu:      Linear(latent) -> expmap0        (onto the ball)
  scale:   Linear(latent) -> clip(softplus + 1e-3, 1e-3, 10)
  decoder: gyroplane distances (latent -> hidden) + bias -> GELU
           -> Linear(hidden -> genes) -> sigmoid
  loss:    recon = per-sample sum-MSE (``recon="mse"``), or the negative
           binomial's -log p(x) with the sigmoid output as per-gene trial
           probs and a learned per-gene log inverse-dispersion
           ``nb_log_theta`` (``recon="nb"``, on non-negative counts: a row
           with a negative input is poisoned to NaN, in the loss and in
           the bound, so the Trainer's finite guard skips it)
           kl    = log q(z|x) - log p(z),  p = WrappedNormal(0, 1)
           total = mean(recon + beta * kl); every entry a per-sample mean
  iwae:    the K-importance-weighted bound under the same likelihood (a
           unit Gaussian on the sigmoid output in ``mse`` mode), one
           gyroplane-kernel launch a decode on the card

The two wide layers (``encoder.0`` and ``decoder.2``, genes x hidden) run
their products in ``compute_dtype`` and store their weight and bias in
``param_dtype`` ("float32" or "bfloat16" each), as flax's
``Dense(dtype=..., param_dtype=...)`` does; the heads, the gyroplanes and
``nb_log_theta`` stay f32, and everything that faces the manifold is
computed in f32. GELU is the tanh approximation, the init lecun-normal
with zero bias, drawn on the CPU from ``generator``. Submodule indices
follow the reference state_dict layout: ``encoder.0``, ``mu.0``,
``scale.0``, ``decoder.0.points``, ``decoder.0.bias``, ``decoder.2``,
plus ``nb_log_theta``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device
from hyperbolic_vae_tpu_torch.distributions import (
    negative_binomial_log_prob,
    wrapped_normal_log_prob,
    wrapped_normal_rsample,
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

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str, what: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"{what} must be 'float32' or 'bfloat16', got {name!r}")
    return _DTYPES[name]


class RNASeqVAE(nn.Module):
    """Parameters are drawn on the CPU from ``generator`` (so one seed
    gives the same weights on every device), then moved to ``device``
    (default ``cuda``; raises when there is no card)."""

    # every loss entry is a per-sample mean (gradient accumulation is exact)
    loss_reduction = "per_sample_mean"

    def __init__(
        self,
        in_features: int = 2000,
        hidden_dim: int = 100,
        latent_dim: int = 2,
        manifold_curvature: float = 1.0,
        beta: float = 1.0,
        lr: float = 1e-3,
        recon: str = "mse",
        compute_dtype: str = "float32",
        param_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        if recon not in ("mse", "nb"):
            raise ValueError(f"recon must be 'mse' or 'nb', got {recon!r}")
        device = resolve_device(device)
        self.in_features = int(in_features)
        self.hidden_dim = int(hidden_dim)
        self.latent_dim = int(latent_dim)
        self.manifold_curvature = float(manifold_curvature)
        self.beta = float(beta)
        self.lr = float(lr)
        self.recon = recon
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self._compute = _dtype(compute_dtype, "compute_dtype")
        pdt = _dtype(param_dtype, "param_dtype")
        self.ball = PoincareBall(c=self.manifold_curvature)

        g, h, d = self.in_features, self.hidden_dim, self.latent_dim
        self.encoder = nn.Sequential(_dense(g, h, generator).to(pdt), _gelu())
        self.mu = nn.Sequential(_dense(h, d, generator))
        self.scale = nn.Sequential(_dense(h, d, generator))
        self.decoder = nn.Sequential(
            PoincareHyperplanes(plane_shape=d, num_planes=h, ball=self.ball, generator=generator),
            _gelu(),
            _dense(h, g, generator).to(pdt),
            nn.Sigmoid(),
        )
        if recon == "nb":
            # per-gene log inverse-dispersion; theta = exp(0) = 1 at init
            self.nb_log_theta = nn.Parameter(torch.zeros(g))
        self.to(device)

    @property
    def data_shape(self) -> tuple:
        return (self.in_features,)

    @property
    def device(self) -> torch.device:
        return self.mu[0].weight.device

    def hparams(self) -> dict:
        """The constructor's configuration (everything but the weights)."""
        return dict(
            in_features=self.in_features, hidden_dim=self.hidden_dim,
            latent_dim=self.latent_dim, manifold_curvature=self.manifold_curvature,
            beta=self.beta, lr=self.lr, recon=self.recon, compute_dtype=self.compute_dtype,
            param_dtype=self.param_dtype,
        )

    def _wide(self, layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        """A wide layer in ``compute_dtype``: input, weight and bias cast
        to it, as flax's Dense(dtype=...) promotes them."""
        dt = self._compute
        return F.linear(h.to(dt), layer.weight.to(dt), layer.bias.to(dt))

    def encode(self, x):
        """Posterior mean on the ball and scale, each (B, latent)."""
        h = self.encoder[1](self._wide(self.encoder[0], x)).float()
        scale = torch.clamp(F.softplus(self.scale(h)) + 1e-3, 1e-3, 10.0)
        return self.ball.expmap0(self.mu(h)), scale

    def posterior_mean(self, x):
        """The latent embedding of x: the posterior mean (B, latent)."""
        return self.encode(x)[0]

    def decode(self, z):
        """Latents (B, latent) -> per-gene sigmoid outputs (B, genes) f32."""
        h = self.decoder[1](self.decoder[0](z))  # the manifold-facing layer in f32
        return torch.sigmoid(self._wide(self.decoder[2], h).float())

    def forward(self, x, generator: Optional[torch.Generator] = None):
        mu, scale = self.encode(x)
        z = wrapped_normal_rsample(generator, self.ball, mu, scale)
        return {"mu": mu, "scale": scale, "z": z, "x_hat": self.decode(z)}

    def _nb_params(self, x_hat):
        """NB logits from the sigmoid output (clipped to [1e-6, 1 - 1e-6])
        and the inverse dispersion exp(nb_log_theta); shared by the loss
        and the bound, so the bound scores the trained density."""
        probs = torch.clamp(x_hat, 1e-6, 1.0 - 1e-6)
        return torch.log(probs) - torch.log1p(-probs), torch.exp(self.nb_log_theta)

    def _nb_loglik(self, x, x_hat):
        """The NB log p(x | x_hat) summed over genes: x (B, G) against
        x_hat (..., B, G) -> (..., B); NaN on a row with a negative input."""
        logits, theta = self._nb_params(x_hat)
        lp = negative_binomial_log_prob(x, theta, logits=logits).sum(dim=-1)
        return torch.where((x < 0).any(dim=-1), float("nan"), lp)

    def loss(self, x, generator: Optional[torch.Generator] = None) -> dict:
        """{loss_total, loss_recon, loss_kl}, each a mean over the batch,
        for one posterior sample per row: eps (B, latent) ~ N(0, I) from
        ``generator`` (on the model's device)."""
        out = self(x, generator)
        return self._loss_parts(x, out["mu"], out["scale"], out["z"], out["x_hat"])

    def loss_from_eps(self, x, eps) -> dict:
        """The loss for a given standard-normal draw eps (B, latent)."""
        mu, scale = self.encode(x)
        z = wrapped_normal_rsample_from_eps(self.ball, mu, scale, eps)
        return self._loss_parts(x, mu, scale, z, self.decode(z))

    def _loss_parts(self, x, mu, scale, z, x_hat) -> dict:
        if self.recon == "nb":
            recon = -self._nb_loglik(x, x_hat)
        else:
            recon = ((x_hat - x) ** 2).sum(dim=-1)  # per-sample sum-MSE
        log_q = wrapped_normal_log_prob(self.ball, mu, scale, z)
        origin = torch.zeros((self.latent_dim,), dtype=torch.float32, device=z.device)
        unit = torch.ones((self.latent_dim,), dtype=torch.float32, device=z.device)
        kl = log_q - wrapped_normal_log_prob(self.ball, origin, unit, z)
        return {
            "loss_total": (recon + self.beta * kl).mean(),
            "loss_recon": recon.mean(),
            "loss_kl": kl.mean(),
        }

    def iwae(self, x, k: int = 256, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-sample K-importance-weighted log p(x) bound (B,) for eps
        (k, B, latent) ~ N(0, I) drawn from ``generator`` (on the model's
        device)."""
        eps = draws.randn((k, x.shape[0], self.latent_dim), generator, self.device, batch_axis=1)
        return self.iwae_from_eps(x, eps)

    def iwae_from_eps(self, x, eps) -> torch.Tensor:
        """The bound for a given draw eps (K, B, latent): the K*B latents
        are decoded in one call. Call it under ``torch.no_grad()`` when no
        gradient is wanted."""
        k, b = eps.shape[0], x.shape[0]
        mu, scale = self.encode(x)

        def loglik(zf):
            xh = self.decode(zf).reshape(k, b, -1)
            return self._nb_loglik(x, xh) if self.recon == "nb" else gaussian_loglik(x, xh)

        return iwae_bound(latent_log_weights_from_eps(self.ball, mu, scale, eps, 1.0, loglik))

    def generate(self, n: int = 64, generator: Optional[torch.Generator] = None):
        """Decode n prior draws z ~ WrappedNormal(0, 1): synthetic
        expression profiles on the sigmoid scale (n, genes). The generator
        lives on the model's device."""
        return self.generate_from_eps(torch.randn((n, self.latent_dim), generator=generator,
                                                  device=self.device, dtype=torch.float32))

    def generate_from_eps(self, eps):
        """``generate`` for a given standard-normal draw eps (n, latent)."""
        return self.decode(prior_sample_from_eps(self.ball, eps, 1.0))

    def reconstruct(self, x, generator: Optional[torch.Generator] = None):
        """Decode one posterior sample (stochastic, as in JAX; the serving
        endpoint decodes the posterior mean instead)."""
        return self(x, generator)["x_hat"]
