"""pvae's building blocks of the Riemannian normal: ``HyperbolicRadius``,
``HypersphericalUniform`` and ``expmap_polar``.

Port of ``hyperbolic_vae_tpu/distributions/hyperspherical.py``, on the
functions of ``riemannian_normal.py``. Conventions (pvae's):

- ``HyperbolicRadius(dim, c, scale)``: ``dim`` is the ball's dimension d;
  p(r) ∝ exp(-r^2/2 sigma^2) (sinh(sqrt(c) r)/sqrt(c))^{d-1} on r >= 0.
- ``HypersphericalUniform(dim)``: uniform on the sphere S^dim in
  R^{dim+1}.

Draws come from an explicit ``torch.Generator``; ``*_from_uniform`` and
``sample_from_noise`` take given draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from hyperbolic_vae_tpu_torch.distributions.riemannian_normal import (
    _log_radius_density_unnorm,
    log_radius_normalizer,
    log_sphere_area,
    radius_uniform,
    sample_radius_from_uniform,
)

__all__ = ["HyperbolicRadius", "HypersphericalUniform", "expmap_polar"]


@dataclasses.dataclass(frozen=True)
class HyperbolicRadius:
    """The radial part of the maximum-entropy normal on a curvature-c ball,
    p(r | sigma) = exp(-r^2 / 2 sigma^2) (sinh(sqrt(c) r) / sqrt(c))^{dim-1} / Z_r(sigma).
    ``scale`` broadcasts; samples and log densities have its shape."""

    dim: int
    c: float
    scale: torch.Tensor

    def rsample_from_uniform(self, u: torch.Tensor) -> torch.Tensor:
        """The radius for given uniforms on [1e-6, 1 - 1e-6] of the
        sample's shape, sample_shape + scale.shape."""
        scale = torch.as_tensor(self.scale, dtype=torch.float32)
        return sample_radius_from_uniform(u, scale.expand(u.shape), self.c, self.dim)

    def rsample(self, generator: Optional[torch.Generator],
                sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        scale = torch.as_tensor(self.scale, dtype=torch.float32)
        shape = tuple(sample_shape) + tuple(scale.shape)
        return self.rsample_from_uniform(radius_uniform(generator, shape, scale.device))

    def log_prob(self, r: torch.Tensor) -> torch.Tensor:
        scale = torch.as_tensor(self.scale, dtype=torch.float32)
        r = torch.as_tensor(r, dtype=torch.float32)
        logp = _log_radius_density_unnorm(r, scale, self.c, self.dim)
        logp = logp - log_radius_normalizer(scale, self.c, self.dim)
        return torch.where(r >= 0, logp, -math.inf)


@dataclasses.dataclass(frozen=True)
class HypersphericalUniform:
    """Uniform on S^dim in R^{dim+1}; log_prob is -log A(S^dim) and the
    entropy log A(S^dim)."""

    dim: int

    @property
    def _log_area(self) -> float:
        return log_sphere_area(self.dim + 1)

    def sample_from_noise(self, g: torch.Tensor) -> torch.Tensor:
        """The point for a given standard-normal draw g (..., dim + 1)."""
        return g / torch.clamp_min(torch.linalg.vector_norm(g, dim=-1, keepdim=True), 1e-12)

    def sample(self, generator: Optional[torch.Generator], sample_shape: Tuple[int, ...] = (),
               device=None) -> torch.Tensor:
        g = torch.randn(tuple(sample_shape) + (self.dim + 1,), generator=generator,
                        device=device, dtype=torch.float32)
        return self.sample_from_noise(g)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return torch.full(tuple(x.shape[:-1]), -self._log_area, dtype=torch.float32,
                          device=x.device)

    def entropy(self) -> torch.Tensor:
        return torch.tensor(self._log_area, dtype=torch.float32)


def expmap_polar(manifold, loc: torch.Tensor, alpha: torch.Tensor,
                 radius: torch.Tensor) -> torch.Tensor:
    """exp_loc(alpha radius / lambda_loc): a unit direction ``alpha`` in
    T_loc and a Riemannian distance ``radius`` to a point of the ball."""
    r = radius if radius.dim() == alpha.dim() else radius[..., None]
    return manifold.expmap(loc, alpha * r / manifold.lambda_x(loc))
