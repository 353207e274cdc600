"""K1 at the widths the gyroplane decoders of the RNA-seq (256 planes),
conv (512) and UnifiedVAE (100) families give it, where the wide D = 2
kernel (``gyroplane_wide_kernel``) runs on a card.

On the CPU the port's plain version and ``gyroplane_distances_fast`` are
held to JAX's jnp ``gyroplane_distances`` and to its Pallas kernel in
interpret mode, B = 64, D = 2. Interior points: rtol 1e-4, atol 1e-5, as
in ``test_torch_port_gyroplane.py``. Near the boundary the epilogue
cancels in f32: at 6,400 to 32,768 outputs the port and JAX each lie
1.2e-3 to 2.1e-3 from the float64 evaluation of the same formula, and as
far from each other, so that file's elementwise rtol 5e-4 (drawn at 1,024
outputs) fails at a few outputs near a sign change. There the port's max
error against float64 must be at most twice JAX's, plus 1e-5: the card's
rule for the kernel.

On a card (tests marked ``cuda``): the wide kernel against the plain
version under ``chip_smoke._k1_check``'s rules (interior atol 1e-5; near
the boundary no farther from float64 than twice the plain version, plus
1e-5), the wide kernel equal bit for bit to the fallback kernel
(``gyroplane_distances_fallback_cuda``), and the kernel each shape takes.
A machine with a card need not have JAX: there, run
``python -m pytest --noconftest -m cuda tests/test_torch_port_k1_wide.py``.
"""

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.ops import gyroplane as port_gyro

INTERIOR = dict(rtol=1e-4, atol=1e-5)
FAMILY_PLANES = (100, 256, 512)  # UnifiedVAE, RNASeqVAE, experiments 5 and 7
# (signed, with bias): the decoders' call, and the other two flags flipped
FLAGS = ((True, True), (False, False))


def _points(rng, n, c, region):
    """n points in the c-ball in R^2: interior (norm <= 0.7 radius) or near
    the boundary (norm in [0.95, 1 - 4e-3] radius)."""
    u = rng.normal(size=(n, 2))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    lo, hi = (0.0, 0.7) if region == "interior" else (0.95, 1.0 - 4e-3)
    return (u * rng.uniform(lo, hi, size=(n, 1)) / np.sqrt(c)).astype(np.float32)


def _inputs(seed, b, p, c, region):
    rng = np.random.default_rng(seed)
    return (_points(rng, b, c, region), _points(rng, p, c, region),
            rng.uniform(-1, 1, size=(p,)).astype(np.float32))


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, the JAX gyroplane module), imported only by the
    tests that compare with JAX."""
    jax = pytest.importorskip("jax")
    from hyperbolic_vae_tpu.ops import gyroplane

    return jax, jax.numpy, gyroplane


def _against(ref_fn, c, region, p, seed):
    """The port's plain version and its dispatcher against ``ref_fn(x,
    points, bias, signed, with_bias)`` for each of ``FLAGS``."""
    x, pts, bias = _inputs(seed, 64, p, c, region)
    for signed, with_bias in FLAGS:
        ref = np.asarray(ref_fn(x, pts, bias, signed, with_bias))
        tb = torch.from_numpy(bias) if with_bias else None
        exact = port_gyro.gyroplane_distances(
            torch.from_numpy(x).double(), torch.from_numpy(pts).double(), c, signed,
            None if tb is None else tb.double()).numpy()
        for fn in (port_gyro.gyroplane_distances, port_gyro.gyroplane_distances_fast):
            out = fn(torch.from_numpy(x), torch.from_numpy(pts), c, signed, tb).numpy()
            assert out.shape == (64, p) and np.all(np.isfinite(out))
            if region == "interior":
                np.testing.assert_allclose(out, ref, **INTERIOR)
                continue
            err, ref_err = np.abs(out - exact).max(), np.abs(ref - exact).max()
            assert err <= 2.0 * ref_err + 1e-5, (err, ref_err)


@pytest.mark.parametrize("region", ["interior", "boundary"])
@pytest.mark.parametrize("c", [1.0, 1.4])
@pytest.mark.parametrize("p", FAMILY_PLANES)
def test_wide_planes_match_jnp(jx, p, c, region):
    jax, jnp, jax_gyro = jx

    def ref(x, pts, bias, signed, with_bias):
        fn = jax.jit(lambda xx, pp, bb: jax_gyro.gyroplane_distances(
            xx, pp, c, signed=signed, bias=bb if with_bias else None))
        return fn(jnp.asarray(x), jnp.asarray(pts), jnp.asarray(bias))

    _against(ref, c, region, p, seed=40 + p)


@pytest.mark.parametrize("region", ["interior", "boundary"])
@pytest.mark.parametrize("c", [1.0, 1.4])
@pytest.mark.parametrize("p", FAMILY_PLANES)
def test_wide_planes_match_pallas_interpret(jx, p, c, region):
    jax, jnp, jax_gyro = jx

    def ref(x, pts, bias, signed, with_bias):
        fn = jax.jit(lambda xx, pp, bb: jax_gyro.gyroplane_distances_pallas(
            xx, pp, c, signed=signed, bias=bb if with_bias else None))
        return fn(jnp.asarray(x), jnp.asarray(pts), jnp.asarray(bias))

    _against(ref, c, region, p, seed=50 + p)


# ---------------------------------------------------------------------- #
# On the card.


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _on_card(seed, b, p, c, region):
    return (torch.from_numpy(a).cuda() for a in _inputs(seed, b, p, c, region))


@pytest.mark.cuda
@pytest.mark.parametrize("region", ["interior", "boundary"])
@pytest.mark.parametrize("b", [1, 256, 25_600, 128_000])
@pytest.mark.parametrize("p", FAMILY_PLANES)
def test_wide_kernel_matches_plain_on_card(p, b, region):
    """The wide kernel against the plain version: interior atol 1e-5; near
    the boundary its max error against float64 at most twice the plain
    f32 version's, plus 1e-5."""
    _card()
    for c in (1.0, 1.4):
        x, pts, bias = _on_card(60 + p, b, p, c, region)
        assert port_gyro.kernel_path(x, pts) == "wide"
        for signed in (True, False):
            for bb in (None, bias):
                n0 = port_gyro.launches.count
                out = port_gyro.gyroplane_distances_cuda(x, pts, c, signed, bb)
                torch.cuda.synchronize()
                assert port_gyro.launches.count == n0 + 1
                assert out.shape == (b, p) and torch.isfinite(out).all()
                ref = port_gyro.gyroplane_distances(x, pts, c, signed, bb)
                if region == "interior":
                    assert float((out - ref).abs().max()) <= 1e-5
                    continue
                exact = port_gyro.gyroplane_distances(
                    x.double(), pts.double(), c, signed, None if bb is None else bb.double())
                k_err = float((out.double() - exact).abs().max())
                p_err = float((ref.double() - exact).abs().max())
                assert k_err <= 2.0 * p_err + 1e-5, (k_err, p_err)


@pytest.mark.cuda
@pytest.mark.parametrize("region", ["interior", "boundary"])
@pytest.mark.parametrize("b,p", [(b, p) for p in FAMILY_PLANES for b in (1, 256, 25_600, 128_000)]
                         + [(256, 1100), (25_600, 1100), (256, 2048)])
def test_wide_kernel_equals_fallback_bit_for_bit_on_card(b, p, region):
    """The wide kernel gives the fallback kernel's bits, signed and
    unsigned, with and without bias; 1,100 and 2,048 planes take two
    tiles of planes. The fallback's launches are not counted."""
    _card()
    for c in (0.5, 1.0, 1.4):
        x, pts, bias = _on_card(70 + p, b, p, c, region)
        assert port_gyro.kernel_path(x, pts) == "wide"
        for signed in (True, False):
            for bb in (None, bias):
                out = port_gyro.gyroplane_distances_cuda(x, pts, c, signed, bb)
                n0 = port_gyro.launches.count
                ref = port_gyro.gyroplane_distances_fallback_cuda(x, pts, c, signed, bb)
                torch.cuda.synchronize()
                assert port_gyro.launches.count == n0
                assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), (c, signed)


@pytest.mark.cuda
def test_kernel_path_on_card():
    """Each family's (P, D = 2) takes the wide kernel, the flagship's 16
    planes the D = 2 kernel; (7, 3) and an x one float into its storage
    (``test_torch_port_gyroplane.py``'s unaligned view) take the fallback."""
    _card()
    x, _, _ = _on_card(80, 1000, 4, 1.0, "interior")
    for p, want in [(16, "d2"), (64, "d2"), (68, "wide"), (100, "wide"), (256, "wide"),
                    (512, "wide"), (2048, "wide")]:
        assert port_gyro.kernel_path(x, torch.zeros(p, 2, device="cuda")) == want, p
    assert port_gyro.kernel_path(torch.zeros(1000, 3, device="cuda"),
                                 torch.zeros(7, 3, device="cuda")) == "fallback"
    assert port_gyro.kernel_path(x, torch.zeros(98, 2, device="cuda")) == "fallback"
    skew = torch.cat([torch.zeros(1, device="cuda"), x.reshape(-1)])[1:].view(1000, 2)
    assert skew.data_ptr() % 8 != 0
    assert port_gyro.kernel_path(skew, torch.zeros(512, 2, device="cuda")) == "fallback"
