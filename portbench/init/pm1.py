"""Uniform on (-1, 1) (the gyroplane layer's bias)."""

import math

import torch


def draw(leaves, gen, curvature, device) -> list:
    flat = torch.rand(sum(math.prod(s) for s, _ in leaves), device=device, generator=gen) * 2.0 - 1.0
    out, at = [], 0
    for shape, _ in leaves:
        n = math.prod(shape)
        out.append(flat[at:at + n].view(shape).clone())
        at += n
    return out
