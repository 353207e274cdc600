"""Plain (non-variational) conv autoencoder.

Port of ``hyperbolic_vae_tpu/models/autoencoder.py``: the Euclidean VAE's
conv trunk (``models/vae_euclidean.py``), a Linear latent bottleneck, the
tanh decoder; loss = the per-sample pixel-sum MSE averaged over the batch.
It has no prior, so no ``generate`` and no bound: the serving engine
answers 404 for ``generate``, as JAX's does. Submodule names follow the
reference state_dict layout: ``encoder.net.{0,2,4,6,8}`` (convs),
``encoder.net.11`` (the latent Linear), ``decoder.linear.0``,
``decoder.net.{0,4,8}`` (transposed) and ``decoder.net.{2,6}``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device
from hyperbolic_vae_tpu_torch.models.vae_euclidean import (
    ConvDecoder,
    ConvEncoder,
    _check_shape,
    nchw,
    nhwc,
    run_stack,
)
from hyperbolic_vae_tpu_torch.models.vae_gyroplane import _dense
from hyperbolic_vae_tpu_torch.models.vae_rnaseq import _dtype


class _Encoder(nn.Module):
    def __init__(self, net: nn.Sequential):
        super().__init__()
        self.net = net


class _Decoder(nn.Module):
    def __init__(self, linear: nn.Sequential, net: nn.Sequential):
        super().__init__()
        self.linear, self.net = linear, net


class Autoencoder(nn.Module):
    """Parameters are drawn on the CPU from ``generator`` (so one seed
    gives the same weights on every device), then moved to ``device``
    (default ``cuda``; raises when there is no card)."""

    loss_reduction = "per_sample_mean"

    def __init__(
        self,
        data_shape: Sequence[int] = (32, 32, 3),
        base_channel_size: int = 32,
        latent_dim: int = 128,
        lr: float = 1e-3,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.data_shape = _check_shape(data_shape)
        self.base_channel_size = int(base_channel_size)
        self.latent_dim = int(latent_dim)
        self.lr = float(lr)
        self.compute_dtype = compute_dtype
        self._compute = _dtype(compute_dtype, "compute_dtype")
        h, w, ch = self.data_shape
        c = self.base_channel_size
        trunk = ConvEncoder(ch, c, generator)
        self.encoder = _Encoder(nn.Sequential(
            *trunk, nn.Flatten(), _dense(2 * c * (h // 8) * (w // 8), self.latent_dim, generator)))
        dec = list(ConvDecoder(self.latent_dim, c, self.data_shape, "tanh", generator))
        self.decoder = _Decoder(nn.Sequential(dec[0], dec[1]), nn.Sequential(*dec[3:]))
        self._unflatten = dec[2]
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.encoder.net[11].weight.device

    def hparams(self) -> dict:
        """The constructor's configuration (everything but the weights)."""
        return dict(data_shape=self.data_shape, base_channel_size=self.base_channel_size,
                    latent_dim=self.latent_dim, lr=self.lr, compute_dtype=self.compute_dtype)

    def encode(self, x):
        """The latent code (B, latent)."""
        net = self.encoder.net
        return net[11](run_stack(net[:10], nchw(x), self._compute).flatten(1).float())

    def posterior_mean(self, x):
        """The latent embedding of x: the code itself (no posterior)."""
        return self.encode(x)

    def decode(self, z):
        """Latents (B, latent) -> images (B, H, W, C) in (-1, 1), f32."""
        d = self.decoder
        h = run_stack([*d.linear, self._unflatten, *d.net[:9]], z, self._compute).float()
        return nhwc(d.net[9](h))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        z = self.encode(x)
        return {"z": z, "x_hat": self.decode(z)}

    def loss(self, x, generator: Optional[torch.Generator] = None) -> dict:
        """{loss_total, loss_recon}: the per-sample pixel-sum MSE, averaged
        over the batch. Draws nothing (``generator`` is the Trainer's
        common signature)."""
        per_sample = ((self(x)["x_hat"] - x) ** 2).sum(dim=(1, 2, 3))
        loss = per_sample.mean()
        return {"loss_total": loss, "loss_recon": loss}

    def reconstruct(self, x, generator: Optional[torch.Generator] = None):
        return self(x)["x_hat"]
