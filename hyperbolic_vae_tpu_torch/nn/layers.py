"""Hyperbolic layers as ``nn.Module``s.

Port of ``hyperbolic_vae_tpu/nn/layers.py``: ``ExpMap0``, ``LogMap0``,
``PoincareHyperplanes`` and the Riemannian layers ``GeodesicLayer`` and
``MobiusLayer``. JAX tags manifold parameters by an ``mp_`` name prefix;
here a manifold parameter is a :class:`ManifoldParameter`, and the ball
it lives on is its module's ``ball``. That keeps the reference
state_dict names (``decoder.0.points``; ``_weight`` / ``_bias`` for the
Riemannian layers).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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


def kaiming_normal_a_sqrt5(shape: Sequence[int], generator: Optional[torch.Generator] = None):
    """torch ``init.kaiming_normal_(w, a=sqrt(5))`` on an (out, in) matrix:
    N(0, 1/3 / fan_in), drawn from ``generator``."""
    std = math.sqrt(2.0 / (1.0 + 5.0)) / math.sqrt(shape[-1])
    return torch.randn(tuple(shape), generator=generator) * std


class LogMap0(nn.Module):
    """Map points of the ball to the tangent space at the origin."""

    def __init__(self, ball: PoincareBall):
        super().__init__()
        self.ball = ball

    def forward(self, x):
        return self.ball.logmap0(x)


class _RiemannianLayer(nn.Module):
    """The Riemannian parameterisation of the Geodesic and Mobius layers:
    a weight ``_weight`` (out, in) in the tangent space at the origin and
    a bias point, either ``expmap0(_weight * _bias)`` with a scalar
    ``_bias`` (out, 1) per row, or (``over_param``) ``_bias`` (out, in)
    itself, a :class:`ManifoldParameter`; the effective weight is
    ``_weight`` transported from the origin to the bias point. Init as
    JAX: kaiming normal (a = sqrt 5) for the weight; U(+-4/sqrt(in)) for
    the scalar bias, expmap0 of it for the point."""

    def __init__(self, in_features: int, out_features: int, ball: PoincareBall,
                 over_param: bool = False, weight_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ball = ball
        self.in_features, self.out_features = int(in_features), int(out_features)
        self.over_param, self.weight_norm = bool(over_param), bool(weight_norm)
        self._weight = nn.Parameter(kaiming_normal_a_sqrt5((out_features, in_features), generator))
        bound = 4.0 / math.sqrt(in_features)
        if over_param:
            b = torch.rand((out_features, in_features), generator=generator) * (2 * bound) - bound
            self._bias = ManifoldParameter(ball.expmap0(b))
        else:
            self._bias = nn.Parameter(
                torch.rand((out_features, 1), generator=generator) * (2 * bound) - bound)

    def _params(self):
        """(weight at the bias point, bias point), each (out, in)."""
        w = self._weight
        bias_point = self._bias if self.over_param else self.ball.expmap0(w * self._bias)
        return self.ball.transp0(bias_point, w), bias_point


class GeodesicLayer(_RiemannianLayer):
    """``out_features`` signed gyroplane distances, with the reference's
    live convention: the plane passes through the transported weight with
    normal the bias point; times the normal's norm with ``weight_norm``."""

    def forward(self, x):
        weight, bias_point = self._params()
        return self.ball.normdist2plane(x[..., None, :], a=bias_point, p=weight, signed=True,
                                        norm=self.weight_norm)


class MobiusLayer(_RiemannianLayer):
    """Mobius matrix-vector product with the transported weight."""

    def forward(self, x):
        weight, _ = self._params()
        return self.ball.mobius_matvec(weight, x)


class PoincareHyperplanes(nn.Module):
    """Gyroplane distance layer: ``num_planes`` learned points on the
    ball; forward = dist2plane(x, p=points, a=points, signed), squared
    when ``squared`` (its sign kept when ``signed``), plus ``bias`` when
    ``use_bias``.

    Parameters: ``points`` (P, D), a :class:`ManifoldParameter`, and, with
    ``use_bias``, ``bias`` (P,). Init as the JAX layer: direction
    normal-then-normalised, radius ``std`` x N(0, 1), then expmap0; bias ~
    U(-1, 1). The distances are the gyroplane kernel's in every case
    (:func:`hyperplane_distances`).
    """

    def __init__(
        self,
        plane_shape: int,
        num_planes: int,
        ball: PoincareBall,
        signed: bool = True,
        squared: bool = False,
        use_bias: bool = True,
        std: float = 1.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.ball = ball
        self.signed, self.squared = bool(signed), bool(squared)
        direction = torch.randn(num_planes, plane_shape, generator=generator)
        direction = direction / torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
        distance = torch.randn(num_planes, 1, generator=generator) * float(std)
        self.points = ManifoldParameter(ball.expmap0(direction * distance))
        if use_bias:
            self.bias = nn.Parameter(torch.rand(num_planes, generator=generator) * 2.0 - 1.0)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        """x (B, D) -> (B, P) f32."""
        return hyperplane_distances(x, self.points, self.ball.c, self.signed, self.squared,
                                    self.bias)


def hyperplane_distances(x, points, c: float, signed: bool, squared: bool,
                         bias: Optional[torch.Tensor] = None, distances=None):
    """The layer's forward on given tensors: the gyroplane distances (the
    kernel's, or ``distances(x, points, c, signed, bias)``), squared when
    ``squared`` (the sign kept when ``signed``), plus ``bias`` (None: no
    bias). Unsquared, the kernel adds the bias itself; squared, the square
    and the bias follow it."""
    distances = distances or gyroplane_distances_fast
    if not squared:
        return distances(x, points, c, signed, bias)
    d = distances(x, points, c, signed, None)
    d = torch.sign(d) * d * d if signed else d * d
    return d if bias is None else d + bias


# the reference's and geoopt's names for the layer
Distance2PoincareHyperplanes = PoincareHyperplanes
Distance2StereographicHyperplanes = PoincareHyperplanes
