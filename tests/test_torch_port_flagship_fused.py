"""The port's fused flagship loss (K2) against the JAX package.

``flagship_forward_torch`` is held to the JAX mirror ``flagship_forward_jnp``
(which JAX's own tests tie to its Pallas kernel), ``FusedFlagshipLoss``'s
gradients to ``jax.grad`` of that mirror (what JAX's custom VJP computes),
and the mirror to the port's ``GyroplaneVAE.loss_from_eps``. JAX parameters
are carried into the port with ``state_dict_from_jax_params``; inputs and
draws come from numpy with a seed. Tolerances:
  * mirror vs mirror: recon rtol 1e-5, KL rtol 1e-4 atol 1e-5 (JAX's
    Pallas-vs-mirror tolerances), loss_total rtol 1e-5 on the scale of its
    terms |recon| + beta |kl|, since their sum can cancel;
  * gradients: rtol 1e-3, atol 3e-5 of each tensor's largest gradient
    (two f32 backward passes in different summation orders; the gyroplane
    epilogue's cancellation reaches ~1e-5 of the scale); the x gradient
    also gets 2e-7 / (x (1 - x)), the size of the two terms its
    RelaxedBernoulli part cancels;
  * the mirror vs the model: rtol 2e-4 on loss_total and recon, KL rtol
    2e-3 atol 1e-3 (JAX's own mirror-vs-model tolerances): the mirror's
    artanh (log1p form, clipped at 1.19e-7) and guarded-log arsinh are not
    the model's.
The kernel runs only on a CUDA card (tests marked ``cuda``; on a machine
without JAX run them with ``python -m pytest --noconftest -m cuda
tests/test_torch_port_flagship_fused.py``).
"""

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, the JAX model class, the JAX fused module)."""
    jax = pytest.importorskip("jax")
    from hyperbolic_vae_tpu.models import GyroplaneVAE
    from hyperbolic_vae_tpu.ops import flagship_fused

    return jax, jax.numpy, GyroplaneVAE, flagship_fused


CONFIGS = {
    "default": dict(),
    "nondefault": dict(latent_dim=3, manifold_curvature=1.4, beta=0.5, prior_scale=2.0),
    "boundary": dict(),  # posterior means pushed to the projection margin
}


def _setup(jx, name, B=32):
    jax, jnp, JaxVAE, _ = jx
    from hyperbolic_vae_tpu_torch.interop import (
        gyroplane_vae_from_state_dict,
        state_dict_from_jax_params,
    )

    kw = CONFIGS[name]
    jm = JaxVAE(**kw)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (B, 28, 28, 1)).astype(np.float32)
    x[:, :5] = 0.0  # exact-0 and exact-1 pixels
    x[:, -3:] = 1.0
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                              jnp.asarray(x))["params"]
    params = jax.tree.map(np.array, params)
    if name == "boundary":
        params["mu"]["kernel"] *= 30.0
        params["mu"]["bias"] += 2.0
        params["scale"]["bias"] += 3.0  # large draws: the truncation is active
    tm = gyroplane_vae_from_state_dict(
        state_dict_from_jax_params(params), device="cpu", manifold_curvature=jm.manifold_curvature,
        prior_scale=jm.prior_scale, beta=jm.beta)
    eps = rng.normal(size=(B, jm.latent_dim)).astype(np.float32)
    return jm, params, tm, x, eps


def _cfg(jm):
    return dict(c=jm.manifold_curvature, beta=jm.beta, prior_scale=jm.prior_scale,
                latent_dim=jm.latent_dim, data_numel=784)


def _close(t, j, beta):
    """t, j: (loss_total, recon, kl) as floats; the module's tolerances."""
    lt, rm, km = j
    assert abs(t[1] - rm) <= 1e-5 * abs(rm), (t, j)
    assert abs(t[2] - km) <= 1e-4 * abs(km) + 1e-5, (t, j)
    assert abs(t[0] - lt) <= 1e-5 * (abs(rm) + beta * abs(km)), (t, j)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_matches_jax_mirror(jx, name):
    jax, jnp, _, jff = jx
    jm, params, tm, x, eps = _setup(jx, name)
    cfg = _cfg(jm)
    j = jax.jit(lambda p, a, e: jff.flagship_forward_jnp(p, a, e, **cfg))(
        jff._params_tuple(params), jnp.asarray(x), jnp.asarray(eps))
    with torch.no_grad():
        t = ff.flagship_forward_torch(ff.params_tuple(tm), torch.from_numpy(x), torch.from_numpy(eps), **cfg)
    if name == "boundary":
        with torch.no_grad():
            mu, _ = tm.encode(torch.from_numpy(x))
        assert float((mu.norm(dim=-1) >= 0.99 * (1 - 4e-3)).float().mean()) > 0.5
    _close([float(v) for v in t], [float(v) for v in j], jm.beta)


@pytest.mark.parametrize("name", ["default", "nondefault"])
def test_fused_loss_grads_match_jax_grad_of_mirror(jx, name):
    """FusedFlagshipLoss (CPU forward, autograd-of-the-plain-version
    backward) against jax.grad of flagship_forward_jnp, for every
    parameter and for x, with cotangents on all three outputs."""
    jax, jnp, _, jff = jx
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params

    jm, params, tm, x, eps = _setup(jx, name)
    cfg = _cfg(jm)
    w = np.array([1.0, 0.3, -0.7], np.float32)

    def jloss(p, a):
        return jnp.dot(jnp.stack(jff.flagship_forward_jnp(p, a, jnp.asarray(eps), **cfg)), w)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jff._params_tuple(params), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = ff.fused_flagship_loss(ff.params_tuple(tm), tx, torch.from_numpy(eps), **cfg)
    (torch.stack(out) @ torch.from_numpy(w)).backward()
    # back to the JAX tree layout, then through the state_dict mapping
    tree = jax.tree.map(np.asarray, jff._tuple_to_params(jgp))
    jsd = state_dict_from_jax_params(tree)
    for name_, p in tm.named_parameters():
        ref = jsd[name_].numpy().reshape(p.shape)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-3,
                                   atol=3e-5 * float(np.abs(ref).max()), err_msg=name_)
    # d/dx of the RelaxedBernoulli density cancels two terms of size
    # 1 / (x (1 - x)) (from logit(x) inside the softplus and from the
    # change of variables): its f32 rounding is ~1e-7 of that size
    ref = np.asarray(jgx)
    xc = np.clip(x, 1e-7, 1 - 1e-7)
    cancel = 1.0 / (xc * (1.0 - xc))
    err = np.abs(tx.grad.numpy() - ref)
    assert np.all(err <= 1e-3 * np.abs(ref) + 3e-5 * float(np.abs(ref).max()) + 2e-7 * cancel)


@pytest.mark.parametrize("name", ["default", "nondefault"])
def test_plain_matches_port_model(jx, name):
    jm, _, tm, x, eps = _setup(jx, name)
    with torch.no_grad():
        t = ff.flagship_forward_torch(ff.params_tuple(tm), torch.from_numpy(x), torch.from_numpy(eps),
                                      **_cfg(jm))
        m = tm.loss_from_eps(torch.from_numpy(x), torch.from_numpy(eps))
    np.testing.assert_allclose(float(t[0]), float(m["loss_total"]), rtol=2e-4)
    np.testing.assert_allclose(float(t[1]), float(m["recon_loss"]), rtol=2e-4)
    np.testing.assert_allclose(float(t[2]), float(m["kl_loss"]), rtol=2e-3, atol=1e-3)


def test_params_tuple_is_the_jax_order_without_copies(jx):
    jm, params, tm, _, _ = _setup(jx, "default", B=2)
    jff = jx[3]
    pt = ff.params_tuple(tm)
    named = dict(tm.named_parameters())
    assert [id(t) for t in pt] == [id(named[k]) for k in (
        "encoder.1.weight", "encoder.1.bias", "encoder.3.weight", "encoder.3.bias",
        "mu.0.weight", "mu.0.bias", "scale.0.weight", "scale.0.bias",
        "decoder.0.points", "decoder.0.bias", "decoder.2.weight", "decoder.2.bias",
        "decoder.4.weight", "decoder.4.bias")]
    for t, j in zip(pt, jff._params_tuple(params)):
        j = np.asarray(j)
        np.testing.assert_array_equal(t.detach().numpy(), j.T if j.ndim == 2 and j.shape != t.shape else j)


def test_make_fused_loss_fn_draws_eps_like_model_loss(jx):
    """Same generator seed -> the fused loss_fn and model.loss see the same
    eps: the fused value equals the mirror at that draw, and model.loss at
    it within the mirror-vs-model tolerance."""
    jm, _, tm, x, _ = _setup(jx, "default", B=16)
    loss_fn = ff.make_fused_loss_fn(tm)
    xb = torch.from_numpy(x)
    with torch.no_grad():
        fused = loss_fn(tm, xb, torch.Generator().manual_seed(3))
        plain = tm.loss(xb, torch.Generator().manual_seed(3))
        eps = torch.randn((16, 2), generator=torch.Generator().manual_seed(3))
        mirror = ff.flagship_forward_torch(ff.params_tuple(tm), xb, eps, **_cfg(jm))
    assert sorted(fused) == ["kl_loss", "loss_total", "recon_loss"]
    assert torch.equal(fused["loss_total"], mirror[0])
    np.testing.assert_allclose(float(fused["loss_total"]), float(plain["loss_total"]), rtol=2e-4)


def test_unsupported_models_and_devices_raise():
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE

    small = GyroplaneVAE(hidden_dims=(32, 8), device="cpu")
    assert not ff.supports_fused(small)
    with pytest.raises(ValueError, match="flagship"):
        ff.make_fused_loss_fn(small)
    m = GyroplaneVAE(device="cpu")
    assert ff.supports_fused(m)
    x, eps = torch.rand(4, 784), torch.randn(4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ff.flagship_fused_cuda(ff.params_tuple(m), x, eps, **ff.fused_config(m))
    with pytest.raises(ValueError, match="no path"):
        ff.fused_flagship_loss([p.detach().to("meta") for p in ff.params_tuple(m)],
                               x.to("meta"), eps.to("meta"), **ff.fused_config(m))


@pytest.mark.parametrize("b", [1, 37, 1024])
def test_wrapper_checks_accept_the_flagship_batch(b):
    """The K2 wrapper's shape and shared-memory checks take the flagship's
    784 pixels at any batch (clusters of 16 rows; the last one ragged) and
    need no build: they run on CPU tensors."""
    x, eps = torch.rand(b, 784), torch.randn(b, 2)
    ff._check_shapes("k2", x, eps, 2, 784, False)
    assert ff._rows_smem_bytes(784, False) <= ff._MAX_SMEM
    with pytest.raises(ValueError, match="eps must be"):
        ff._check_shapes("k2", x, torch.randn(b + 1, 2), 2, 784, False)
    with pytest.raises(ValueError, match="CUDA"):
        ff._check_batch("k2", x, eps, 2, 784, False)


def test_wrapper_raises_for_pixels_over_the_shared_memory():
    """The largest data_numel whose staged rows and weight slices fit one
    block passes; one pixel more raises before any launch."""
    d = 784
    while ff._rows_smem_bytes(d + 1, False) <= ff._MAX_SMEM:
        d += 1
    assert 1000 < d < 2000
    ff._check_shapes("k2", torch.rand(2, d), torch.randn(2, 2), 2, d, False)
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE

    m = GyroplaneVAE(data_shape=(d + 4,), device="cpu")
    cfg = ff.fused_config(m)
    with pytest.raises(ValueError, match="shared memory"):
        ff.flagship_fused_cuda(ff.params_tuple(m), torch.rand(2, d + 4), torch.randn(2, 2), **cfg)


def test_build_hash_follows_included_headers(tmp_path):
    """An edited header changes the hash a source builds under, so a
    library built against the old header is not loaded."""
    from hyperbolic_vae_tpu_torch.ops import _build

    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    src = tmp_path / "flagship_train.cu"
    before = _build.source_digest(src)
    assert before == _build.source_digest(_build.CSRC / "flagship_train.cu")
    hdr = tmp_path / "hopper.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert _build.source_digest(src) != before
    assert _build.source_digest(tmp_path / "gyroplane.cu") == _build.source_digest(
        _build.CSRC / "gyroplane.cu")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 37, 256, 1024])
def test_kernel_matches_plain_on_card(b):
    """K2 against the plain version on the card (the module's mirror
    tolerances), for the seeded flagship at c = 1 and latent 2; one launch
    counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE

    m = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
    cfg = ff.fused_config(m)
    x = torch.rand(b, 784, generator=torch.Generator().manual_seed(1)).cuda()
    x[:, :100] = 0.0
    eps = torch.randn(b, 2, generator=torch.Generator().manual_seed(2)).cuda()
    n0 = ff.launches.count
    out = ff.flagship_fused_cuda(ff.params_tuple(m), x, eps, **cfg)
    torch.cuda.synchronize()
    assert ff.launches.count == n0 + 1
    with torch.no_grad():
        ref = torch.stack(ff.flagship_forward_torch(ff.params_tuple(m), x, eps, **cfg))
    _close(out.tolist(), ref.tolist(), cfg["beta"])


@pytest.mark.cuda
def test_fused_loss_fn_on_card_launches_the_kernel_and_backpropagates():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE

    m = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
    loss_fn = ff.make_fused_loss_fn(m)
    x = torch.rand(64, 28, 28, 1, generator=torch.Generator().manual_seed(1)).cuda()
    n0 = ff.launches.count
    out = loss_fn(m, x, torch.Generator(device="cuda").manual_seed(0))
    out["loss_total"].backward()
    torch.cuda.synchronize()
    assert ff.launches.count == n0 + 1
    assert all(torch.isfinite(p.grad).all() for p in m.parameters())


@pytest.mark.cuda
def test_kernel_keeps_a_nan_pixel_nan_on_card():
    """A NaN pixel makes all three metrics NaN, as in the plain version
    (and JAX): the kernel's clamps keep NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE

    m = GyroplaneVAE(generator=torch.Generator().manual_seed(0))
    cfg = ff.fused_config(m)
    x = torch.rand(8, 784, generator=torch.Generator().manual_seed(1)).cuda()
    x[3, 10] = float("nan")
    eps = torch.randn(8, 2, generator=torch.Generator().manual_seed(2)).cuda()
    out = ff.flagship_fused_cuda(ff.params_tuple(m), x, eps, **cfg)
    with torch.no_grad():
        ref = torch.stack(ff.flagship_forward_torch(ff.params_tuple(m), x, eps, **cfg))
    assert torch.isnan(ref).all() and torch.isnan(out).all()
