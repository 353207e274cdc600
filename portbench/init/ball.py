"""Points on the ball, exp_0(direction * radius), with a uniform
direction and a standard normal radius (the gyroplane layer's init): a
leaf (P, D) is P points."""

import math

import torch

from portbench.reference import _ball


def draw(leaves, gen, curvature, device) -> list:
    total = sum(math.prod(s) for s, _ in leaves)
    flat = torch.randn(total + sum(s[0] for s, _ in leaves), device=device, generator=gen)
    radii = flat[total:]
    out, at, r = [], 0, 0
    for shape, _ in leaves:
        n, p = math.prod(shape), shape[0]
        unit = flat[at:at + n].view(shape)
        unit = unit / torch.linalg.vector_norm(unit, dim=-1, keepdim=True)
        out.append(_ball.expmap0(unit * radii[r:r + p].view(p, 1), curvature))
        at, r = at + n, r + p
    return out
