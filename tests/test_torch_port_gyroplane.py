"""The port's gyroplane-distance op against the JAX package.

Inputs are made with numpy from a seed and fed to both sides.
Tolerances:
  * interior points (norm <= 0.7 radius): rtol 1e-4, atol 1e-5, against
    the jnp version and against the Pallas kernel in interpret mode;
  * near-boundary points (norm in [0.95, 1 - 4e-3] radius): rtol 5e-4,
    atol 1e-5. The analytic epilogue cancels there (den and |diff|^2 lose
    most of their f32 bits), so the two frameworks' last-bit differences
    in <x, p> are amplified, to about 1e-4 of the (large) distances;
  * gradients (port autograd vs jax.grad of gyroplane_distances_fast),
    interior points: rtol 1e-4, atol 1e-6.
The kernel itself runs only on a CUDA card (test marked ``cuda``). A
machine with a card need not have JAX: there, run
``python -m pytest --noconftest -m cuda tests/test_torch_port_gyroplane.py``.
"""

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.ops import gyroplane as port_gyro

INTERIOR = dict(rtol=1e-4, atol=1e-5)
BOUNDARY = dict(rtol=5e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _points(rng, n, d, c, region):
    """n points in R^d: interior (norm <= 0.7 radius) or near the
    boundary (norm in [0.95, 1 - 4e-3] radius)."""
    u = rng.normal(size=(n, d))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    if region == "interior":
        r = rng.uniform(0.0, 0.7, size=(n, 1))
    else:
        r = rng.uniform(0.95, 1.0 - 4e-3, size=(n, 1))
    return (u * r / np.sqrt(c)).astype(np.float32)


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, the JAX gyroplane module), imported only by the
    tests that compare with JAX."""
    jax = pytest.importorskip("jax")
    from hyperbolic_vae_tpu.ops import gyroplane

    return jax, jax.numpy, gyroplane


def _inputs(seed, b, p, d, c, region, with_bias):
    rng = np.random.default_rng(seed)
    x = _points(rng, b, d, c, region)
    pts = _points(rng, p, d, c, region)
    bias = rng.uniform(-1, 1, size=(p,)).astype(np.float32) if with_bias else None
    return x, pts, bias


def _port(fn, x, pts, c, signed, bias):
    out = fn(torch.from_numpy(x), torch.from_numpy(pts), c, signed,
             None if bias is None else torch.from_numpy(bias))
    return out.detach().numpy()


@pytest.mark.parametrize("region", ["interior", "boundary"])
@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("c", [0.5, 1.0, 1.4])
def test_plain_matches_jnp(jx, c, signed, with_bias, d, region):
    _, jnp, jax_gyro = jx
    x, pts, bias = _inputs(0, 64, 16, d, c, region, with_bias)
    ref = np.asarray(jax_gyro.gyroplane_distances(
        jnp.asarray(x), jnp.asarray(pts), c, signed=signed,
        bias=None if bias is None else jnp.asarray(bias)))
    tol = INTERIOR if region == "interior" else BOUNDARY
    for fn in (port_gyro.gyroplane_distances, port_gyro.gyroplane_distances_fast):
        out = _port(fn, x, pts, c, signed, bias)
        assert np.all(np.isfinite(out))
        np.testing.assert_allclose(out, ref, **tol)


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("c", [0.5, 1.0, 1.4])
def test_plain_matches_pallas_interpret(jx, c, signed, with_bias, d):
    _, jnp, jax_gyro = jx
    x, pts, bias = _inputs(1, 128, 64, d, c, "interior", with_bias)
    ref = np.asarray(jax_gyro.gyroplane_distances_pallas(
        jnp.asarray(x), jnp.asarray(pts), c, signed=signed,
        bias=None if bias is None else jnp.asarray(bias),
        block_b=64, block_p=32))
    out = _port(port_gyro.gyroplane_distances_fast, x, pts, c, signed, bias)
    np.testing.assert_allclose(out, ref, **INTERIOR)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("c", [0.5, 1.0, 1.4])
def test_grads_match_jax(jx, c, signed, with_bias):
    jax, jnp, jax_gyro = jx
    x, pts, bias = _inputs(2, 32, 16, 2, c, "interior", with_bias)
    w = np.random.default_rng(3).normal(size=(32, 16)).astype(np.float32)

    def jloss(xx, pp, bb):
        out = jax_gyro.gyroplane_distances_fast(xx, pp, c, signed, bb)
        return jnp.sum(out * w)

    args = [jnp.asarray(x), jnp.asarray(pts), None if bias is None else jnp.asarray(bias)]
    argnums = (0, 1, 2) if with_bias else (0, 1)
    jgrads = jax.grad(jloss, argnums=argnums)(*args)

    tx = torch.from_numpy(x).requires_grad_()
    tp = torch.from_numpy(pts).requires_grad_()
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_()
    out = port_gyro.gyroplane_distances_fast(tx, tp, c, signed, tb)
    (out * torch.from_numpy(w)).sum().backward()
    tgrads = (tx.grad, tp.grad) + ((tb.grad,) if with_bias else ())
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD)


def test_dispatch_requires_cpu_or_cuda_and_kernel_requires_cuda():
    x, pts, _ = _inputs(4, 8, 4, 2, 1.0, "interior", False)
    with pytest.raises(ValueError, match="CUDA"):
        port_gyro.gyroplane_distances_cuda(torch.from_numpy(x), torch.from_numpy(pts), 1.0)
    with pytest.raises(ValueError, match="no path"):
        port_gyro.gyroplane_distances_fast(
            torch.from_numpy(x).to("meta"), torch.from_numpy(pts).to("meta"), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("region", ["interior", "boundary"])
@pytest.mark.parametrize("b", [1, 256, 4096, 128_000])
def test_kernel_matches_plain_on_card(b, region):
    """The CUDA kernel against the plain version on the card, at the
    flagship's P = 16, D = 2. Interior points: atol 1e-5. Near the
    boundary the kernel and the plain version each lie up to ~3e-3 from
    the float64 evaluation (f32 cancellation in the epilogue), so there
    the kernel's max error against float64 must be at most twice the
    plain f32 version's, plus 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for c in (0.5, 1.0, 2.0):
        for signed in (True, False):
            for with_bias in (False, True):
                x, pts, bias = _inputs(5, b, 16, 2, c, region, with_bias)
                tx, tp = torch.from_numpy(x).cuda(), torch.from_numpy(pts).cuda()
                tb = None if bias is None else torch.from_numpy(bias).cuda()
                n0 = port_gyro.launches.count
                out = port_gyro.gyroplane_distances_cuda(tx, tp, c, signed, tb)
                torch.cuda.synchronize()
                assert port_gyro.launches.count == n0 + 1
                assert torch.isfinite(out).all()
                ref = port_gyro.gyroplane_distances(tx, tp, c, signed, tb)
                if region == "interior":
                    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                               rtol=0, atol=1e-5)
                    continue
                exact = port_gyro.gyroplane_distances(
                    tx.double(), tp.double(), c, signed, None if tb is None else tb.double())
                k_err = float((out.double() - exact).abs().max())
                p_err = float((ref.double() - exact).abs().max())
                assert k_err <= 2.0 * p_err + 1e-5, (k_err, p_err)



@pytest.mark.cuda
@pytest.mark.parametrize("p,d,misaligned", [(7, 3, False), (20, 2, False), (100, 2, False),
                                            (16, 2, True)])
def test_kernel_runtime_shapes_match_plain_on_card(p, d, misaligned):
    """The kernel's other shapes against the plain version on the card,
    interior points, atol 1e-5: a width other than 2, a P that is not 4 x
    a power of 2, more than 64 planes (the wide kernel), and an x that is
    not 8-byte aligned (a view one float into its storage)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, pts, bias = _inputs(6, 1000, p, d, 1.0, "interior", True)
    tx = torch.from_numpy(x).cuda()
    if misaligned:
        tx = torch.cat([torch.zeros(1, device="cuda"), tx.reshape(-1)])[1:].view(1000, d)
        assert tx.data_ptr() % 8 != 0
    tp, tb = torch.from_numpy(pts).cuda(), torch.from_numpy(bias).cuda()
    for signed in (True, False):
        out = port_gyro.gyroplane_distances_cuda(tx, tp, 1.0, signed, tb)
        torch.cuda.synchronize()
        ref = port_gyro.gyroplane_distances(tx, tp, 1.0, signed, tb)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-5)