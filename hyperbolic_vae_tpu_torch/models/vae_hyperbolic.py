"""Conv image VAE with a Poincare latent and configurable manifold layers.

Port of ``hyperbolic_vae_tpu/models/vae_hyperbolic.py``:

  encoder: Conv(m,s2) -> Conv(2m,s2) -> Conv(2m,s2) (GELU) -> flatten
  mu head: ``linear`` (Linear + expmap0) | ``mobius`` (MobiusLayer)
  log_var: Linear (``mse`` only; the bernoulli modes use log_var = 0)
  z ~ WrappedNormal(mu, clip(exp(0.5 log_var), 1e-3, 10)), one sample
  decoder first layer: ``linear`` | ``geodesic`` | ``mobius`` |
           ``geoopt_gyroplane`` (gyroplane distances: the gyroplane
           kernel K1 on CUDA tensors, 2m H/8 W/8 planes), then GELU
  conv-transpose stack back to the image; sigmoid under ``mse``
  loss:    KL summed over the batch + recon: sum-MSE (``mse``), the
           RelaxedBernoulli(T=0.1, logits) per-element mean NLL
           (``bernoulli``, the reference's reduction), or per-sample sums
           with both terms meaned over the batch (``bernoulli_elbo``)

The conv stacks run in ``compute_dtype`` (bf16: weights cast as flax's
``Conv(dtype=...)``); the manifold-facing layers, sampling and the loss
stay f32. Images are channels-last (B, H, W, C) at the public methods,
NCHW inside; the heads read the features flattened (C, H, W) as the
reference torch modules do (``models/vae_euclidean.py``). Submodule
names follow the reference state_dict layout: ``encoder.{0,2,4}``,
``mu`` (``mu._weight``/``mu._bias`` for the Mobius head), ``log_var``,
``decoder.0`` (``.points``/``.bias``, ``._weight``/``._bias`` or
``.weight``/``.bias``), ``decoder.{3,7,11}`` (transposed), ``decoder.{5,9}``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device
from hyperbolic_vae_tpu_torch.distributions import (
    relaxed_bernoulli_log_prob,
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
from hyperbolic_vae_tpu_torch.models.vae_euclidean import (
    _check_shape,
    conv,
    conv_t,
    nchw,
    nhwc,
    run_stack,
)
from hyperbolic_vae_tpu_torch.models.vae_gyroplane import _dense, _gelu
from hyperbolic_vae_tpu_torch.models.vae_rnaseq import _dtype
from hyperbolic_vae_tpu_torch.nn import GeodesicLayer, MobiusLayer, PoincareHyperplanes
from hyperbolic_vae_tpu_torch.distributions import draws

ENCODER_LAST = ("linear", "mobius")
DECODER_FIRST = ("linear", "geodesic", "mobius", "geoopt_gyroplane")
LOSS_RECON = ("mse", "bernoulli", "bernoulli_elbo")


class HyperbolicImageVAE(nn.Module):
    """Parameters are drawn on the CPU from ``generator`` (so one seed
    gives the same weights on every device), then moved to ``device``
    (default ``cuda``; raises when there is no card)."""

    def __init__(
        self,
        data_shape: Sequence[int] = (32, 32, 1),
        latent_dim: int = 2,
        manifold_curvature: float = 1.0,
        encoder_last_layer_module: str = "linear",
        decoder_first_layer_module: str = "linear",
        beta: float = 1.0,
        lr: float = 1e-3,
        loss_recon: str = "mse",
        compute_dtype: str = "float32",
        base_channels: int = 16,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        for name, value, allowed in (("encoder_last_layer_module", encoder_last_layer_module,
                                      ENCODER_LAST),
                                     ("decoder_first_layer_module", decoder_first_layer_module,
                                      DECODER_FIRST),
                                     ("loss_recon", loss_recon, LOSS_RECON)):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
        device = resolve_device(device)
        self.data_shape = _check_shape(data_shape)
        self.latent_dim = int(latent_dim)
        self.manifold_curvature = float(manifold_curvature)
        self.encoder_last_layer_module = encoder_last_layer_module
        self.decoder_first_layer_module = decoder_first_layer_module
        self.beta = float(beta)
        self.lr = float(lr)
        self.loss_recon = loss_recon
        self.compute_dtype = compute_dtype
        self._compute = _dtype(compute_dtype, "compute_dtype")
        self.base_channels = int(base_channels)
        self.ball = PoincareBall(c=self.manifold_curvature)

        h, w, ch = self.data_shape
        m, d, g = self.base_channels, self.latent_dim, generator
        feat = self.encoder_out_channels
        self.encoder = nn.Sequential(conv(ch, m, 2, g), _gelu(), conv(m, 2 * m, 2, g), _gelu(),
                                     conv(2 * m, 2 * m, 2, g), _gelu())
        self.mu = (_dense(feat, d, g) if encoder_last_layer_module == "linear"
                   else MobiusLayer(feat, d, self.ball, generator=g))
        if loss_recon == "mse":
            self.log_var = _dense(feat, d, g)
        first = {
            "linear": lambda: _dense(d, feat, g),
            "geodesic": lambda: GeodesicLayer(d, feat, self.ball, generator=g),
            "mobius": lambda: MobiusLayer(d, feat, self.ball, generator=g),
            "geoopt_gyroplane": lambda: PoincareHyperplanes(d, feat, self.ball, generator=g),
        }[decoder_first_layer_module]()
        self.decoder = nn.Sequential(
            first, _gelu(), nn.Unflatten(1, (2 * m, h // 8, w // 8)),
            conv_t(2 * m, 2 * m, g), _gelu(), conv(2 * m, 2 * m, 1, g), _gelu(),
            conv_t(2 * m, m, g), _gelu(), conv(m, m, 1, g), _gelu(), conv_t(m, ch, g))
        self.to(device)

    @property
    def loss_reduction(self) -> str:
        """``mse`` and ``bernoulli`` return the reference's batch sums, which
        gradient accumulation would rescale (the Trainer refuses it);
        ``bernoulli_elbo`` is per-sample means throughout."""
        return "per_sample_mean" if self.loss_recon == "bernoulli_elbo" else "batch_sum"

    @property
    def mixed_loss_reduction(self) -> bool:
        """``bernoulli``'s reconstruction is a mean over rows and pixels and
        its KL a sum over rows: no one weight splits it over a data mesh."""
        return self.loss_recon == "bernoulli"

    @property
    def encoder_out_channels(self) -> int:
        h, w = self.data_shape[0], self.data_shape[1]
        return 2 * self.base_channels * (h // 8) * (w // 8)

    @property
    def device(self) -> torch.device:
        return self.encoder[0].weight.device

    def hparams(self) -> dict:
        """The constructor's configuration (everything but the weights)."""
        return dict(
            data_shape=self.data_shape, latent_dim=self.latent_dim,
            manifold_curvature=self.manifold_curvature,
            encoder_last_layer_module=self.encoder_last_layer_module,
            decoder_first_layer_module=self.decoder_first_layer_module, beta=self.beta,
            lr=self.lr, loss_recon=self.loss_recon, compute_dtype=self.compute_dtype,
            base_channels=self.base_channels,
        )

    def encode(self, x):
        """(mu on the ball, scale), each (B, latent)."""
        h = run_stack(self.encoder, nchw(x), self._compute).flatten(1).float()
        mu = self.mu(h)
        if self.encoder_last_layer_module == "linear":
            mu = self.ball.expmap0(mu)
        log_var = self.log_var(h) if self.loss_recon == "mse" else torch.zeros_like(mu)
        return mu, torch.clamp(torch.exp(0.5 * log_var), 1e-3, 10.0)

    def posterior_mean(self, x):
        """The latent embedding of x: the posterior mean (B, latent)."""
        return self.encode(x)[0]

    def decode(self, z):
        """Latents (B, latent) -> (B, H, W, C) f32: the sigmoid under
        ``mse``, logits under the bernoulli modes."""
        d = self.decoder
        h = d[1](d[0](z.float()))  # the manifold-facing layer in f32
        h = run_stack(d[2:], h, self._compute).float()
        if self.loss_recon == "mse":
            h = torch.sigmoid(h)
        return nhwc(h)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        mu, scale = self.encode(x)
        z = wrapped_normal_rsample(generator, self.ball, mu, scale)
        return {"mu": mu, "scale": scale, "z": z, "x_hat": self.decode(z)}

    def loss(self, x, generator: Optional[torch.Generator] = None) -> dict:
        """{loss_total, loss_recon, loss_kl, mse} for one posterior sample
        a row: eps (B, latent) ~ N(0, I) from ``generator`` (on the model's
        device); reductions per ``loss_recon`` (module docstring)."""
        out = self(x, generator)
        return self._loss_parts(x, out["mu"], out["scale"], out["z"], out["x_hat"])

    def loss_from_eps(self, x, eps) -> dict:
        """The loss for a given standard-normal draw eps (B, latent)."""
        mu, scale = self.encode(x)
        z = wrapped_normal_rsample_from_eps(self.ball, mu, scale, eps)
        return self._loss_parts(x, mu, scale, z, self.decode(z))

    def _loss_parts(self, x, mu, scale, z, x_hat) -> dict:
        b = x.shape[0]
        log_q = wrapped_normal_log_prob(self.ball, mu, scale, z)
        origin = torch.zeros((self.latent_dim,), dtype=torch.float32, device=z.device)
        unit = torch.ones((self.latent_dim,), dtype=torch.float32, device=z.device)
        kl = log_q - wrapped_normal_log_prob(self.ball, origin, unit, z)
        loss_kl = kl.sum()
        sq = (x_hat - x) ** 2
        if self.loss_recon == "mse":
            loss_recon = sq.sum()
        else:
            lp = relaxed_bernoulli_log_prob(x.reshape(b, -1), 0.1, logits=x_hat.reshape(b, -1))
            if self.loss_recon == "bernoulli":
                loss_recon = -lp.mean()
            else:
                loss_recon = -lp.sum(dim=-1).mean()
                loss_kl = kl.mean()
        per_sample = self.loss_recon == "bernoulli_elbo"
        mse = sq.reshape(b, -1).sum(dim=-1).mean() if per_sample else sq.sum()
        return {"loss_total": loss_recon + self.beta * loss_kl, "loss_recon": loss_recon,
                "loss_kl": loss_kl, "mse": mse}

    def iwae(self, x, k: int = 256, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-sample K-importance-weighted log p(x) bound (B,) for eps
        (k, B, latent) ~ N(0, I) from ``generator`` (on the model's device)."""
        eps = draws.randn((k, x.shape[0], self.latent_dim), generator, self.device, batch_axis=1)
        return self.iwae_from_eps(x, eps)

    def iwae_from_eps(self, x, eps) -> torch.Tensor:
        """The bound for a given draw eps (K, B, latent): wrapped posterior
        and prior on the ball; a unit Gaussian on the sigmoid output
        (``mse``) or RelaxedBernoulli(T=0.1) logits, summed over pixels. The
        K*B latents are decoded in one call (one K1 launch on the card)."""
        k, b = eps.shape[0], x.shape[0]
        xf = x.reshape(b, -1)
        mu, scale = self.encode(x)

        def loglik(zf):
            xh = self.decode(zf).reshape(k, b, -1)
            if self.loss_recon == "mse":
                return gaussian_loglik(xf, xh)
            return relaxed_bernoulli_log_prob(xf[None], 0.1, logits=xh).sum(dim=-1)

        return iwae_bound(latent_log_weights_from_eps(self.ball, mu, scale, eps, 1.0, loglik))

    def generate(self, n: int = 64, generator: Optional[torch.Generator] = None):
        """Decode n prior draws z ~ WrappedNormal(0, 1). The generator lives
        on the model's device."""
        return self.generate_from_eps(torch.randn((n, self.latent_dim), generator=generator,
                                                  device=self.device, dtype=torch.float32))

    def generate_from_eps(self, eps):
        """``generate`` for a given standard-normal draw eps (n, latent)."""
        return self.decode(prior_sample_from_eps(self.ball, eps, 1.0))

    def reconstruct(self, x, generator: Optional[torch.Generator] = None):
        """Decode one posterior sample (stochastic, as in JAX; the serving
        endpoint decodes the posterior mean instead)."""
        return self(x, generator)["x_hat"]
