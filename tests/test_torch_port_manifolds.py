"""The port's PoincareBall against the JAX package's, method by method.

Inputs are made with numpy from a seed: interior points (norm <= 0.7
radius), near-boundary points (norm in [0.95, 1] radius, some beyond the
projection margin), zero vectors, and tangent vectors. Tolerance: rtol
1e-5, atol 1e-6 in f32 (both sides run the same formulas with the same
clamps; differences are last-bit rounding), except ``logmap0`` and
``dist0`` near the boundary, whose artanh amplifies a last-bit
difference in |y| by 1/(1 - c|y|^2) (up to ~250 at the projection
margin): rtol 1e-4 there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.manifolds import PoincareBall as JaxBall
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall, artanh, tanh
from hyperbolic_vae_tpu.manifolds import poincare as jax_poincare

TOL = dict(rtol=1e-5, atol=1e-6)
ARTANH_BOUNDARY = dict(rtol=1e-4, atol=1e-6)


def _vecs(seed, n, d, c, region):
    rng = np.random.default_rng(seed)
    if region == "zero":
        return np.zeros((n, d), np.float32)
    u = rng.normal(size=(n, d))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    lo, hi = {"interior": (0.0, 0.7), "boundary": (0.95, 1.0), "tangent": (0.0, 3.0)}[region]
    r = rng.uniform(lo, hi, size=(n, 1))
    return (u * r / np.sqrt(c)).astype(np.float32)


def _both(method, c, *arrays, **kw):
    j = getattr(JaxBall(c=c), method)(*[jnp.asarray(a) for a in arrays], **kw)
    t = getattr(PoincareBall(c=c), method)(*[torch.from_numpy(a) for a in arrays],
                                             **{k.replace("keepdims", "keepdim"): v
                                                for k, v in kw.items()})
    return np.asarray(j), t.numpy()


REGIONS = ["interior", "boundary", "zero"]


@pytest.mark.parametrize("region", REGIONS)
@pytest.mark.parametrize("c", [0.5, 1.0, 1.4])
@pytest.mark.parametrize("method", ["project", "lambda_x", "expmap0", "logmap0", "dist0"])
def test_unary_methods(method, c, region):
    x = _vecs(0, 32, 3, c, "tangent" if method == "expmap0" and region != "zero" else region)
    j, t = _both(method, c, x)
    assert np.all(np.isfinite(t))
    tol = ARTANH_BOUNDARY if method in ("logmap0", "dist0") and region == "boundary" else TOL
    np.testing.assert_allclose(t, j, **tol)


@pytest.mark.parametrize("region", REGIONS)
@pytest.mark.parametrize("c", [0.5, 1.0, 1.4])
@pytest.mark.parametrize("method", ["mobius_add", "expmap", "transp0"])
def test_binary_methods(method, c, region):
    x = _vecs(1, 32, 3, c, region)
    y = _vecs(2, 32, 3, c, "tangent" if method != "mobius_add" else "interior")
    j, t = _both(method, c, x, y)
    assert np.all(np.isfinite(t))
    np.testing.assert_allclose(t, j, **TOL)


def test_keepdim_forms():
    x = _vecs(3, 8, 2, 1.0, "interior")
    for method in ("lambda_x", "dist0"):
        for keep in (True, False):
            j, t = _both(method, 1.0, x, keepdims=keep)
            assert t.shape == j.shape
            np.testing.assert_allclose(t, j, **TOL)


def test_scalar_clamps_match():
    v = np.array([-30.0, -1.0, -0.9999999, 0.0, 0.5, 0.9999999, 1.0, 30.0], np.float32)
    np.testing.assert_allclose(artanh(torch.from_numpy(v)).numpy(),
                               np.asarray(jax_poincare.artanh(jnp.asarray(v))), **TOL)
    np.testing.assert_allclose(tanh(torch.from_numpy(v)).numpy(),
                               np.asarray(jax_poincare.tanh(jnp.asarray(v))), **TOL)


def test_bf16_inputs_upcast_to_f32():
    x = _vecs(4, 8, 2, 1.0, "interior")
    out = PoincareBall(1.0).expmap0(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.float32
    ref = JaxBall(1.0).expmap0(jnp.asarray(x).astype(jnp.bfloat16))
    assert ref.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
