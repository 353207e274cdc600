"""Euclidean conv VAE, and the conv stacks the image families share.

Port of ``hyperbolic_vae_tpu/models/vae_euclidean.py``:

  encoder: Conv(c,s2) -> Conv(c) -> Conv(2c,s2) -> Conv(2c) -> Conv(2c,s2)
           (GELU after each) -> flatten at (2c, H/8, W/8)
  heads:   mu / log_var Linear
  z = mu + eps * exp(0.5 log_var)
  decoder: Linear -> GELU -> (2c, H/8, W/8) -> ConvT(2c,s2) -> Conv(2c)
           -> ConvT(c,s2) -> Conv(c) -> ConvT(data,s2) (GELU between) -> tanh
  loss:    sum-MSE + beta * the analytic Gaussian KL, both summed over the
           batch and the features (the reference's reductions)

The public methods take and return channels-last images (B, H, W, C), as
the data modules, the HTTP wire and JAX do; inside, the convs run NCHW,
and the heads read the features flattened in (C, H, W) order, the
reference torch modules' (``interop/state_dict.py`` permutes JAX's
(H, W, C)-ordered weights to it). ``ConvTranspose2d(3, stride=2,
padding=1, output_padding=1)`` doubles the size as JAX's
``CONVT_PADDING``. ``compute_dtype="bfloat16"`` runs the conv stacks (and
the decoder's first Linear) in bf16, weights cast as flax's
``Conv(dtype=...)`` casts them; parameters stay f32. GELU is the tanh
approximation (flax's ``gelu``); convs and Linears get flax's init,
lecun-normal (truncated) with zero bias. Submodule indices follow the
reference state_dict layout: ``encoder.{0,2,4,6,8}``, ``mu``,
``log_var``, ``decoder.0``, ``decoder.{3,7,11}`` (transposed) and
``decoder.{5,9}``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device
from hyperbolic_vae_tpu_torch.distributions import kl_std_normal_from_logvar
from hyperbolic_vae_tpu_torch.models.iwae import (
    gaussian_loglik,
    iwae_bound,
    latent_log_weights_from_eps,
)
from hyperbolic_vae_tpu_torch.models.sampling import prior_sample_from_eps
from hyperbolic_vae_tpu_torch.models.vae_gyroplane import _dense, _gelu, _lecun_
from hyperbolic_vae_tpu_torch.models.vae_rnaseq import _dtype
from hyperbolic_vae_tpu_torch.distributions import draws

def conv(n_in: int, n_out: int, stride: int, generator) -> nn.Conv2d:
    """3x3 conv, padding 1 (flax ``Conv((3, 3), strides, padding=1)``)."""
    layer = nn.utils.skip_init(nn.Conv2d, n_in, n_out, 3, stride=stride, padding=1)
    return _lecun_(layer, 9 * n_in, generator)


def conv_t(n_in: int, n_out: int, generator) -> nn.ConvTranspose2d:
    """3x3 transposed conv doubling H and W (JAX's ``CONVT_PADDING``)."""
    layer = nn.utils.skip_init(nn.ConvTranspose2d, n_in, n_out, 3, stride=2, padding=1,
                               output_padding=1)
    return _lecun_(layer, 9 * n_in, generator)


def run_stack(layers, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Run conv/GELU/reshape layers on h in ``dt``: inputs, weights and
    biases cast to it, as flax's ``Conv(dtype=...)`` promotes them."""
    h = h.to(dt)
    for layer in layers:
        if isinstance(layer, nn.ConvTranspose2d):
            h = F.conv_transpose2d(h, layer.weight.to(dt), layer.bias.to(dt), layer.stride,
                                   layer.padding, layer.output_padding)
        elif isinstance(layer, nn.Conv2d):
            h = F.conv2d(h, layer.weight.to(dt), layer.bias.to(dt), layer.stride, layer.padding)
        elif isinstance(layer, nn.Linear):
            h = F.linear(h, layer.weight.to(dt), layer.bias.to(dt))
        else:
            h = layer(h)
    return h


def nchw(x: torch.Tensor) -> torch.Tensor:
    """Channels-last images (B, H, W, C) as an NCHW view."""
    return x.permute(0, 3, 1, 2)


def nhwc(h: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous channels-last images (B, H, W, C)."""
    return h.permute(0, 2, 3, 1).contiguous()


class ConvEncoder(nn.Sequential):
    """Five 3x3 convs (c, c, 2c, 2c, 2c; stride 2 at 0, 2, 4), GELU after
    each: (B, H, W, C) -> (B, 2c H/8 W/8) f32, flattened (C, H, W)."""

    def __init__(self, in_channels: int, hidden_size: int, generator=None):
        c = hidden_size
        widths = ((in_channels, c, 2), (c, c, 1), (c, 2 * c, 2), (2 * c, 2 * c, 1),
                  (2 * c, 2 * c, 2))
        layers = []
        for n_in, n_out, s in widths:
            layers += [conv(n_in, n_out, s, generator), _gelu()]
        super().__init__(*layers)

    def features(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return run_stack(self, nchw(x), dt).flatten(1).float()


class ConvDecoder(nn.Sequential):
    """Linear -> GELU -> (2c, H/8, W/8) -> ConvT(2c) -> Conv(2c) -> ConvT(c)
    -> Conv(c) -> ConvT(C) (GELU between) -> tanh | sigmoid | none:
    (B, latent) -> (B, H, W, C) f32."""

    def __init__(self, latent_dim: int, hidden_size: int, data_shape: Sequence[int],
                 final_activation: str = "tanh", generator=None):
        if final_activation not in ("tanh", "sigmoid", "none"):
            raise ValueError(f"final_activation must be tanh, sigmoid or none, "
                             f"got {final_activation!r}")
        c = hidden_size
        h8, w8, ch = data_shape[0] // 8, data_shape[1] // 8, data_shape[2]
        layers = [_dense(latent_dim, 2 * c * h8 * w8, generator), _gelu(),
                  nn.Unflatten(1, (2 * c, h8, w8)),
                  conv_t(2 * c, 2 * c, generator), _gelu(), conv(2 * c, 2 * c, 1, generator), _gelu(),
                  conv_t(2 * c, c, generator), _gelu(), conv(c, c, 1, generator), _gelu(),
                  conv_t(c, ch, generator)]
        if final_activation == "tanh":
            layers.append(nn.Tanh())
        elif final_activation == "sigmoid":
            layers.append(nn.Sigmoid())
        super().__init__(*layers)
        self.final_activation = final_activation

    def images(self, z: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        h = run_stack(list(self)[:12], z, dt).float()
        return nhwc(self[12](h) if len(self) > 12 else h)


def _check_shape(data_shape) -> tuple:
    shape = tuple(int(d) for d in data_shape)
    if len(shape) != 3 or shape[0] % 8 or shape[1] % 8:
        raise ValueError(f"data_shape must be (H, W, C) with H and W divisible by 8, got {shape}")
    return shape


class EuclideanVAE(nn.Module):
    """Parameters are drawn on the CPU from ``generator`` (so one seed
    gives the same weights on every device), then moved to ``device``
    (default ``cuda``; raises when there is no card)."""

    # the loss entries are batch sums (the reference's reductions), which
    # gradient accumulation would rescale: the Trainer refuses it
    loss_reduction = "batch_sum"

    def __init__(
        self,
        data_shape: Sequence[int] = (32, 32, 3),
        hidden_size: int = 32,
        latent_dim: int = 2,
        beta: float = 1.0,
        lr: float = 1e-3,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.data_shape = _check_shape(data_shape)
        self.hidden_size = int(hidden_size)
        self.latent_dim = int(latent_dim)
        self.beta = float(beta)
        self.lr = float(lr)
        self.compute_dtype = compute_dtype
        self._compute = _dtype(compute_dtype, "compute_dtype")
        h, w, ch = self.data_shape
        feat = 2 * self.hidden_size * (h // 8) * (w // 8)
        self.encoder = ConvEncoder(ch, self.hidden_size, generator)
        self.mu = _dense(feat, self.latent_dim, generator)
        self.log_var = _dense(feat, self.latent_dim, generator)
        self.decoder = ConvDecoder(self.latent_dim, self.hidden_size, self.data_shape, "tanh",
                                   generator)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.mu.weight.device

    def hparams(self) -> dict:
        """The constructor's configuration (everything but the weights)."""
        return dict(data_shape=self.data_shape, hidden_size=self.hidden_size,
                    latent_dim=self.latent_dim, beta=self.beta, lr=self.lr,
                    compute_dtype=self.compute_dtype)

    def encode(self, x):
        """(mu, log_var), each (B, latent)."""
        h = self.encoder.features(x, self._compute)
        return self.mu(h), self.log_var(h)

    def posterior_mean(self, x):
        """The latent embedding of x: the posterior mean (B, latent)."""
        return self.encode(x)[0]

    def decode(self, z):
        """Latents (B, latent) -> images (B, H, W, C) in (-1, 1), f32."""
        return self.decoder.images(z, self._compute)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        mu, log_var = self.encode(x)
        eps = draws.randn(mu.shape, generator, mu.device)
        z = mu + eps * torch.exp(0.5 * log_var)
        return {"mu": mu, "log_var": log_var, "z": z, "x_hat": self.decode(z)}

    def loss(self, x, generator: Optional[torch.Generator] = None) -> dict:
        """{loss_total, loss_recon, loss_kld} with the reference's sum
        reductions, for one draw eps (B, latent) ~ N(0, I) from
        ``generator`` (on the model's device)."""
        out = self(x, generator)
        return self._loss_parts(x, out["mu"], out["log_var"], out["x_hat"])

    def loss_from_eps(self, x, eps) -> dict:
        """The loss for a given standard-normal draw eps (B, latent)."""
        mu, log_var = self.encode(x)
        return self._loss_parts(x, mu, log_var, self.decode(mu + eps * torch.exp(0.5 * log_var)))

    def _loss_parts(self, x, mu, log_var, x_hat) -> dict:
        loss_recon = ((x_hat - x) ** 2).sum()
        loss_kld = kl_std_normal_from_logvar(mu, log_var).sum()
        return {"loss_total": loss_recon + self.beta * loss_kld, "loss_recon": loss_recon,
                "loss_kld": loss_kld}

    def iwae(self, x, k: int = 256, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-sample K-importance-weighted log p(x) bound (B,) for eps
        (k, B, latent) ~ N(0, I) from ``generator`` (on the model's device)."""
        eps = draws.randn((k, x.shape[0], self.latent_dim), generator, self.device, batch_axis=1)
        return self.iwae_from_eps(x, eps)

    def iwae_from_eps(self, x, eps) -> torch.Tensor:
        """The bound for a given draw eps (K, B, latent): diagonal-Gaussian
        posterior and prior, a unit-scale Gaussian likelihood; the K*B
        latents decoded in one call."""
        k, b = eps.shape[0], x.shape[0]
        xf = x.reshape(b, -1)
        mu, log_var = self.encode(x)

        def loglik(zf):
            return gaussian_loglik(xf, self.decode(zf).reshape(k, b, -1))

        log_w = latent_log_weights_from_eps(None, mu, torch.exp(0.5 * log_var), eps, 1.0, loglik)
        return iwae_bound(log_w)

    def generate(self, n: int = 64, generator: Optional[torch.Generator] = None):
        """Decode n prior draws z ~ N(0, I). The generator lives on the
        model's device."""
        return self.generate_from_eps(torch.randn((n, self.latent_dim), generator=generator,
                                                  device=self.device, dtype=torch.float32))

    def generate_from_eps(self, eps):
        """``generate`` for a given standard-normal draw eps (n, latent)."""
        return self.decode(prior_sample_from_eps(None, eps, 1.0))

    def reconstruct(self, x, generator: Optional[torch.Generator] = None):
        """Decode one posterior sample (stochastic, as in JAX)."""
        return self(x, generator)["x_hat"]
