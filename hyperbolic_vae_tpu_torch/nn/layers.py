"""Hyperbolic layers as ``nn.Module``s.

Port of the serving path's part of ``hyperbolic_vae_tpu/nn/layers.py``:
``ExpMap0`` and ``PoincareHyperplanes``. JAX tags manifold parameters by
an ``mp_`` name prefix; here a manifold parameter is a
:class:`ManifoldParameter`, and the ball it lives on is its module's
``ball``. That keeps the reference state_dict names (``decoder.0.points``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.ops.gyroplane import gyroplane_distances_fast


class ManifoldParameter(nn.Parameter):
    """A parameter whose rows are points on the owning module's ball.
    The Riemannian optimizer (training slice) dispatches on this type."""


def is_manifold_param(p: torch.Tensor) -> bool:
    return isinstance(p, ManifoldParameter)


class ExpMap0(nn.Module):
    """Map Euclidean vectors onto the ball."""

    def __init__(self, ball: PoincareBall):
        super().__init__()
        self.ball = ball

    def forward(self, x):
        return self.ball.expmap0(x)


class PoincareHyperplanes(nn.Module):
    """Gyroplane distance layer: ``num_planes`` learned points on the
    ball; forward = dist2plane(x, p=points, a=points, signed) + bias,
    with the bias added inside the gyroplane kernel.

    Parameters: ``points`` (P, D), a :class:`ManifoldParameter`, and
    ``bias`` (P,). Init as the JAX layer: direction normal-then-
    normalised, radius ~ N(0, 1), then expmap0; bias ~ U(-1, 1). The JAX
    layer's ``squared``, ``use_bias=False`` and ``std`` options have no
    caller in the port and are not carried over.
    """

    def __init__(
        self,
        plane_shape: int,
        num_planes: int,
        ball: PoincareBall,
        signed: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.ball = ball
        self.signed = signed
        direction = torch.randn(num_planes, plane_shape, generator=generator)
        direction = direction / torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
        distance = torch.randn(num_planes, 1, generator=generator)
        self.points = ManifoldParameter(ball.expmap0(direction * distance))
        self.bias = nn.Parameter(torch.rand(num_planes, generator=generator) * 2.0 - 1.0)

    def forward(self, x):
        """x (B, D) -> (B, P) f32."""
        return gyroplane_distances_fast(x, self.points, self.ball.c, self.signed, self.bias)
