"""A normal truncated at two standard deviations with std sqrt(1 /
fan_in), corrected for the truncation (flax's lecun_normal, as the
published models initialise their dense layers)."""

import math

import torch

_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated at +-2


def draw(leaves, gen, curvature, device) -> list:
    total = sum(math.prod(s) for s, _ in leaves)
    flat = torch.nn.init.trunc_normal_(torch.empty(total, device=device), 0.0, 1.0, -2.0, 2.0,
                                       generator=gen)
    out, at = [], 0
    for shape, fan_in in leaves:
        n = math.prod(shape)
        out.append(flat[at:at + n].view(shape) * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
        at += n
    return out
