"""The flat latent space: the c -> 0 limit of the Poincare ball.

Port of ``hyperbolic_vae_tpu/manifolds/euclidean.py``. It lets models and
the Riemannian optimizer treat a Euclidean latent (``UnifiedVAE`` with
``latent_curvature=None``) with the ball's method names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Euclidean:
    def origin(self, shape, dtype=torch.float32, device=None) -> torch.Tensor:
        if isinstance(shape, int):
            shape = (shape,)
        return torch.zeros(shape, dtype=dtype, device=device)

    def project(self, x):
        return x

    def expmap(self, x, u):
        return x + u

    def expmap0(self, u):
        return u

    def logmap(self, x, y):
        return y - x

    def logmap0(self, y):
        return y

    def transp(self, x, y, v):
        return v

    def transp0(self, y, v):
        return v

    def dist(self, x, y, keepdim: bool = False):
        return torch.linalg.vector_norm(y - x, dim=-1, keepdim=keepdim)

    def egrad2rgrad(self, x, grad):
        return grad

    def component_inner(self, x, u, v: Optional[torch.Tensor] = None):
        if v is None:
            v = u
        return u * v

    def retr(self, x, u):
        return x + u

    def retr_transp(self, x, u, v):
        return x + u, v
