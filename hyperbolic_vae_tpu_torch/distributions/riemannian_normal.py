"""Riemannian (maximum-entropy) normal on the Poincare ball.

Port of ``hyperbolic_vae_tpu/distributions/riemannian_normal.py``:

Density:   p(z | mu, sigma) = exp(-d(mu, z)^2 / (2 sigma^2)) / Z(sigma)
Sampling:  direction alpha ~ Uniform(S^{d-1}) in T_mu,
           radius r ~ p(r) ∝ exp(-r^2/(2 sigma^2)) (sinh(sqrt(c) r)/sqrt(c))^{d-1},
           z = exp_mu(alpha r / lambda_mu)  (a tangent vector of Riemannian norm r)

The radius is drawn by inverse CDF on a sigma-adaptive 512-point grid
(the density's mode plus 8 sigma); the grid CDF is made of differentiable
ops, so pathwise gradients in sigma flow through the interpolation (the
segment index carries none). ``log_prob``'s normaliser is a trapezoid
quadrature on the same grid, finite in value and gradient for every
(sigma, d). The closed form (a binomial expansion of sinh^{d-1}) is kept
for cross-checks only: its alternating sum cancels in f32 and its
gradient goes NaN at isolated sigma at d = 10.

The grid is ``linspace(0, 1, 512)`` rounded as the JAX package's is
(``iota * f32(1/511)``, how XLA computes it). Draws come from an
explicit ``torch.Generator``: the direction's normals first, then the
radius's uniforms on [1e-6, 1 - 1e-6] (JAX splits one key into two);
``RiemannianNormal.rsample_from_noise(g, u)`` and
``sample_radius_from_uniform`` take given draws.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from hyperbolic_vae_tpu_torch.distributions import draws
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall, log_sinh_ratio

__all__ = [
    "RiemannianNormal",
    "log_radius_normalizer",
    "log_radius_normalizer_closed_form",
    "log_sphere_area",
    "radius_uniform",
    "sample_radius",
    "sample_radius_from_uniform",
]

_GRID_SIZE = 512
_U_MIN = 1e-6


def _unit_grid(grid_size: int, device) -> torch.Tensor:
    """linspace(0, 1, grid_size) in f32 as XLA rounds it: i * f32(1/(n-1)),
    the last point exactly 1."""
    # a fill, not a host copy: the grid is built inside captured CUDA graphs
    step = torch.full((), 1.0 / (grid_size - 1), dtype=torch.float32, device=device)
    head = torch.arange(grid_size - 1, dtype=torch.float32, device=device) * step
    return torch.cat([head, torch.ones(1, dtype=torch.float32, device=device)])


def _r_max(sigma: torch.Tensor, c, dim: int) -> torch.Tensor:
    """The grid's end: the density's mode (near (d-1) sqrt(c) sigma^2) + 8 sigma."""
    return (dim - 1) * math.sqrt(c) * sigma * sigma + 8.0 * sigma + 1e-2


def _log_gauss_tail_term(t: torch.Tensor) -> torch.Tensor:
    """log[exp(t^2) (1 + erf(t))], stable for all t: direct for t >= -4,
    else the asymptotic series of erfcx(-t)."""
    direct = t * t + torch.log(torch.clamp_min(1.0 + torch.special.erf(t), 1e-38))
    s = torch.clamp_min(-t, 4.0)  # the asymptotic branch's variable, kept NaN-free
    inv2 = 1.0 / (2.0 * s * s)
    asym = -torch.log(s * math.sqrt(math.pi)) + torch.log1p(-inv2 + 3.0 * inv2 * inv2)
    return torch.where(t >= -4.0, direct, asym)


def _signed_logsumexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log|sum(b exp(a))| over the last axis, the max shift held constant
    (as ``jax.scipy.special.logsumexp(a, b=b)``)."""
    amax = a.amax(dim=-1, keepdim=True).detach()
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    s = (b * torch.exp(a - amax)).sum(dim=-1)
    return torch.log(s.abs()) + amax[..., 0]


def log_radius_normalizer_closed_form(sigma: torch.Tensor, c, dim: int) -> torch.Tensor:
    """log Z_r by the binomial expansion of sinh^{d-1}, with n = d - 1 and
    a_k = (n - 2k) sqrt(c):

        Z_r = 2^-n c^(-n/2) sum_k C(n, k) (-1)^k sigma sqrt(pi/2)
              exp(a_k^2 sigma^2 / 2) (1 + erf(a_k sigma / sqrt 2)).

    For cross-checks only: the alternating sum cancels in f32, and where
    it does its gradient is NaN (at d = 10, c = 1, e.g. sigma ~ 0.588).
    ``log_radius_normalizer`` is the production form. Computed in
    sigma's floating type (float64 for a reference)."""
    n = dim - 1
    sigma = torch.as_tensor(sigma)
    if n == 0:  # the half-Gaussian integral
        return torch.log(sigma) + 0.5 * math.log(math.pi / 2.0)
    sqrt_c = math.sqrt(c)
    k = torch.arange(n + 1, dtype=sigma.dtype, device=sigma.device)
    nf = torch.full((), float(n), dtype=sigma.dtype, device=sigma.device)
    log_binom = torch.lgamma(nf + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(nf - k + 1.0)
    sign = torch.where(k % 2 == 0, 1.0, -1.0)
    a_k = (n - 2.0 * k) * sqrt_c
    t = a_k * sigma[..., None] / math.sqrt(2.0)
    log_terms = (log_binom + _log_gauss_tail_term(t) + torch.log(sigma)[..., None]
                 + 0.5 * math.log(math.pi / 2.0))
    const = -n * math.log(2.0) - n * math.log(sqrt_c)
    return const + _signed_logsumexp(log_terms, sign)


def _log_radius_density_unnorm(r: torch.Tensor, sigma: torch.Tensor, c, dim: int) -> torch.Tensor:
    """Unnormalised log p(r) = -r^2/(2 sigma^2) + (d-1) log(sinh(sqrt(c) r)/sqrt(c)),
    the last term as log_sinh_ratio(sqrt(c) r) + log r."""
    t = math.sqrt(c) * r
    log_sinh_term = log_sinh_ratio(t) + torch.log(torch.clamp_min(r, 1e-30))
    return -(r * r) / (2.0 * sigma * sigma) + (dim - 1) * log_sinh_term


def log_radius_normalizer(sigma: torch.Tensor, c, dim: int) -> torch.Tensor:
    """log Z_r(sigma) = log Int_0^inf exp(-r^2/2 sigma^2) (sinh(sqrt(c) r)/sqrt(c))^{d-1} dr,
    by the trapezoid rule on the sampler's grid: smooth in sigma (values
    and gradients finite for every (sigma, d)) and consistent with the
    sampler's discretisation."""
    n = dim - 1
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    if n == 0:  # the half-Gaussian integral
        return torch.log(sigma) + 0.5 * math.log(math.pi / 2.0)
    r_max = _r_max(sigma, c, dim)
    grid = _unit_grid(_GRID_SIZE, sigma.device)
    logp = _log_radius_density_unnorm(r_max[..., None] * grid, sigma[..., None], c, dim)
    # the trapezoid's end weights 1/2, built without a host copy (captured
    # CUDA graphs run this)
    i = torch.arange(_GRID_SIZE, device=sigma.device)
    log_w = torch.where((i == 0) | (i == _GRID_SIZE - 1), -math.log(2.0), 0.0)
    dr = r_max * grid[1]  # r_max / (G - 1), rounded as the grid's step
    return torch.logsumexp(logp + log_w, dim=-1) + torch.log(dr)


def log_sphere_area(dim: int) -> float:
    """log area of the unit sphere S^{d-1} in R^d."""
    return math.log(2.0) + (dim / 2.0) * math.log(math.pi) - math.lgamma(dim / 2.0)


def radius_uniform(generator: Optional[torch.Generator], shape, device=None,
                   batch_axis: int = 0) -> torch.Tensor:
    """The radius sampler's uniforms: U(1e-6, 1 - 1e-6) of ``shape`` (the
    batch along ``batch_axis``)."""
    u = draws.rand(shape, generator, device, batch_axis)
    return torch.clamp_min(u * (1.0 - 2.0 * _U_MIN) + _U_MIN, _U_MIN)


def sample_radius_from_uniform(u: torch.Tensor, sigma: torch.Tensor, c, dim: int,
                               grid_size: int = _GRID_SIZE) -> torch.Tensor:
    """The inverse-CDF radius for the uniforms ``u`` (the shape of
    ``sigma``): the grid CDF's segment holding u, linearly interpolated.
    Differentiable in sigma through the CDF; the segment index is not."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    r_grid = _r_max(sigma, c, dim)[..., None] * _unit_grid(grid_size, sigma.device)
    logp = _log_radius_density_unnorm(r_grid, sigma[..., None], c, dim)
    # amax, not max: tied maxima share the gradient, as jnp.max's do
    p = torch.exp(logp - logp.amax(dim=-1, keepdim=True))
    seg = 0.5 * (p[..., 1:] + p[..., :-1]) * (r_grid[..., 1:] - r_grid[..., :-1])
    cdf = torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, dim=-1)], dim=-1)
    cdf = cdf / torch.clamp_min(cdf[..., -1:], 1e-30)
    idx = (cdf < u[..., None]).sum(dim=-1, keepdim=True) - 1
    idx = idx.clamp(0, grid_size - 2)
    c0, c1 = torch.gather(cdf, -1, idx)[..., 0], torch.gather(cdf, -1, idx + 1)[..., 0]
    r0, r1 = torch.gather(r_grid, -1, idx)[..., 0], torch.gather(r_grid, -1, idx + 1)[..., 0]
    w = (u - c0) / torch.clamp_min(c1 - c0, 1e-30)
    return r0 + w * (r1 - r0)


def sample_radius(generator: Optional[torch.Generator], sigma: torch.Tensor, c, dim: int,
                  grid_size: int = _GRID_SIZE) -> torch.Tensor:
    """One inverse-CDF radius per element of ``sigma``, its uniforms from
    ``generator`` (on sigma's device)."""
    u = radius_uniform(generator, sigma.shape, sigma.device)
    return sample_radius_from_uniform(u, sigma, c, dim, grid_size)


class RiemannianNormal:
    """p(z | loc, scale) ∝ exp(-d(loc, z)^2 / (2 scale^2)) on the ball.

    ``scale`` is isotropic per event, shape (..., 1), clamped to the
    reference's [0.1, 7.0]."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, manifold: PoincareBall):
        self.loc, self.scale, self.manifold = loc, scale, manifold

    @property
    def _scale(self) -> torch.Tensor:
        return torch.clamp(self.scale, 0.1, 7.0)

    @property
    def dim(self) -> int:
        return self.loc.shape[-1]

    def noise(self, generator: Optional[torch.Generator],
              sample_shape: Tuple[int, ...] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
        """The draws of ``rsample``: the direction's normals
        (sample_shape + loc.shape), then the radius's uniforms
        (sample_shape + loc.shape[:-1]), from one generator in that order."""
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        dev = self.loc.device
        axis = len(tuple(sample_shape))
        g = draws.randn(shape, generator, dev, batch_axis=axis)
        return g, radius_uniform(generator, shape[:-1], dev, batch_axis=axis)

    def rsample_from_noise(self, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """The sample for given draws: ``g`` normals of the sample's shape
        and ``u`` uniforms of its batch shape."""
        ball = self.manifold
        loc = self.loc.expand(g.shape)
        scale = self._scale.expand(tuple(loc.shape[:-1]) + (1,))
        alpha = g / torch.clamp_min(torch.linalg.vector_norm(g, dim=-1, keepdim=True), 1e-12)
        r = sample_radius_from_uniform(u, scale[..., 0], ball.c, self.dim)[..., None]
        return ball.expmap(loc, alpha * r / ball.lambda_x(loc))

    def rsample(self, generator: Optional[torch.Generator],
                sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self.rsample_from_noise(*self.noise(generator, sample_shape))

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        ball = self.manifold
        scale = self._scale[..., 0]
        d = ball.dist(self.loc, z)
        log_norm = log_sphere_area(self.dim) + log_radius_normalizer(scale, ball.c, self.dim)
        return -(d * d) / (2.0 * scale * scale) - log_norm
