"""Synthetic MNIST (the data kind ``blob_images``). Each class a prototype
of ``blobs`` Gaussian blobs (centres uniform on [0.2, 0.8], widths on
[0.08, 0.25] of the image), scaled to a peak of 1; each image its
class's prototype rolled by a normal shift (std ``shift_std`` pixels,
cut toward zero), plus normal noise (std ``noise_std``), clipped to [0,
1]. The first ``n_train`` images train, the next ``n_val`` validate."""

from __future__ import annotations

import torch


def make(d: dict, gen: torch.Generator, dev) -> tuple:
    h, w = d["shape"][:2]
    k, nb = int(d["n_classes"]), int(d["blobs"])
    n = int(d["n_train"]) + int(d["n_val"])
    u = torch.rand((k, nb, 4), generator=gen, device=dev)
    cx, cy = 0.2 + 0.6 * u[..., 0, None, None], 0.2 + 0.6 * u[..., 1, None, None]
    sx, sy = 0.08 + 0.17 * u[..., 2, None, None], 0.08 + 0.17 * u[..., 3, None, None]
    yy = (torch.arange(h, device=dev, dtype=torch.float32) / (h - 1))[:, None]
    xx = (torch.arange(w, device=dev, dtype=torch.float32) / (w - 1))[None, :]
    acc = torch.exp(-((xx - cx) ** 2 / (2 * sx ** 2) + (yy - cy) ** 2 / (2 * sy ** 2))).sum(1)
    protos = acc / acc.amax(dim=(1, 2), keepdim=True)  # (k, h, w)
    labels = torch.randint(0, k, (n,), generator=gen, device=dev)
    shift = torch.trunc(torch.randn((n, 2), generator=gen, device=dev) * float(d["shift_std"])).long()
    rows = (torch.arange(h, device=dev)[None, :] - shift[:, :1]) % h
    cols = (torch.arange(w, device=dev)[None, :] - shift[:, 1:]) % w
    x = protos[labels[:, None, None], rows[:, :, None], cols[:, None, :]]
    x = x + torch.randn((n, h, w), generator=gen, device=dev) * float(d["noise_std"])
    x = x.clamp_(0.0, 1.0).reshape(n, *d["shape"])
    n_train = int(d["n_train"])
    return x[:n_train], x[n_train:]
