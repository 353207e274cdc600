"""The port's flagship GyroplaneVAE against the JAX model.

The JAX model is initialised at its published width (784 -> 64 -> 16 ->
2-D Poincare latent, c = 1 -> 16 gyroplanes -> 64 -> 784) and its
parameters are carried into the port with ``state_dict_from_jax_params``.
Inputs and standard-normal draws are made with numpy from a seed and fed
to both. Tolerance: rtol 1e-5, atol 1e-5 in f32 on every output (means,
scales, latents, pixel probabilities); the two frameworks differ only in
the order of f32 sums inside the matmuls and in their tanh-GELU and
softplus formulas' last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.distributions import wrapped_normal_rsample_from_eps as jax_rsample
from hyperbolic_vae_tpu.interop import export_torch_state_dict
from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxVAE
from hyperbolic_vae_tpu_torch.distributions import wrapped_normal_rsample_from_eps
from hyperbolic_vae_tpu_torch.interop import (
    gyroplane_vae_from_state_dict,
    load_state_dict_file,
    state_dict_from_jax_params,
)
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE, prior_sample_from_eps
from hyperbolic_vae_tpu_torch.nn import ManifoldParameter, is_manifold_param

TOL = dict(rtol=1e-5, atol=1e-5)
B = 24


@pytest.fixture(scope="module")
def pair():
    jm = JaxVAE()
    x0 = jnp.zeros((2, 28, 28, 1), jnp.float32)
    params = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x0)["params"]
    params = jax.tree.map(np.asarray, params)
    tm = gyroplane_vae_from_state_dict(state_dict_from_jax_params(params), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=(B, 28, 28, 1)).astype(np.float32)
    eps = rng.normal(size=(B, 2)).astype(np.float32)
    return jm, params, tm, x, eps


def _japply(jm, params, *args, method):
    return jm.apply({"params": params}, *args, method=method)


def test_state_dict_layout_and_shapes(pair):
    _, _, tm, _, _ = pair
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert shapes == {
        "encoder.1.weight": (64, 784), "encoder.1.bias": (64,),
        "encoder.3.weight": (16, 64), "encoder.3.bias": (16,),
        "mu.0.weight": (2, 16), "mu.0.bias": (2,),
        "scale.0.weight": (2, 16), "scale.0.bias": (2,),
        "decoder.0.points": (16, 2), "decoder.0.bias": (16,),
        "decoder.2.weight": (64, 16), "decoder.2.bias": (64,),
        "decoder.4.weight": (784, 64), "decoder.4.bias": (784,),
    }
    assert is_manifold_param(tm.decoder[0].points)
    assert [n for n, p in tm.named_parameters() if is_manifold_param(p)] == ["decoder.0.points"]


def test_jax_export_npz_loads_identically(pair, tmp_path):
    """The .npz the JAX package's exporter writes is the port's layout."""
    jm, params, tm, _, _ = pair
    f = tmp_path / "flagship_torch.npz"
    np.savez(f, **export_torch_state_dict(jm, params))
    sd = load_state_dict_file(f)
    ours = state_dict_from_jax_params(params)
    assert sorted(sd) == sorted(ours)
    for k in sd:
        assert torch.equal(sd[k], ours[k]), k
    pt = tmp_path / "flagship.pt"
    torch.save(tm.state_dict(), pt)
    for k, v in load_state_dict_file(pt).items():
        assert torch.equal(v, tm.state_dict()[k]), k


def test_encode_matches(pair):
    jm, params, tm, x, _ = pair
    jmu, jscale = _japply(jm, params, jnp.asarray(x), method="encode")
    with torch.no_grad():
        tmu, tscale = tm.encode(torch.from_numpy(x))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), **TOL)
    np.testing.assert_allclose(tscale.numpy(), np.asarray(jscale), **TOL)


def test_decode_matches(pair):
    jm, params, tm, _, eps = pair
    z = np.array(jax_rsample(JaxVAE().ball, jnp.zeros((B, 2)), jnp.full((B, 2), 0.8),
                               jnp.asarray(eps)))
    jx = _japply(jm, params, jnp.asarray(z), method="decode")
    with torch.no_grad():
        tx = tm.decode(torch.from_numpy(z))
    assert tx.shape == (B, 28, 28, 1)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


def test_rsample_from_eps_then_decode_matches(pair):
    jm, params, tm, x, eps = pair
    jmu, jscale = _japply(jm, params, jnp.asarray(x), method="encode")
    jz = jax_rsample(JaxVAE().ball, jmu, jscale, jnp.asarray(eps))
    jx = _japply(jm, params, jz, method="decode")
    with torch.no_grad():
        tmu, tscale = tm.encode(torch.from_numpy(x))
        tz = wrapped_normal_rsample_from_eps(tm.ball, tmu, tscale, torch.from_numpy(eps))
        tx = tm.decode(tz)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


def test_prior_sample_from_eps_then_decode_matches(pair, monkeypatch):
    """generate = decode(prior sample): fed the same draw, both agree."""
    jm, params, tm, _, eps = pair
    import hyperbolic_vae_tpu.models.sampling as jsampling

    monkeypatch.setattr(jsampling.jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(eps[: shape[0]]))
    jx = jm.apply({"params": params}, B, method="generate", rngs={"sample": jax.random.PRNGKey(5)})
    with torch.no_grad():
        tz = prior_sample_from_eps(tm.ball, torch.from_numpy(eps), tm.prior_scale)
        tx = tm.decode(tz)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


def test_generate_and_reconstruct_are_seeded_and_valid(pair):
    _, _, tm, x, _ = pair
    with torch.no_grad():
        g1 = tm.generate(8, torch.Generator().manual_seed(3))
        g2 = tm.generate(8, torch.Generator().manual_seed(3))
        r = tm.reconstruct(torch.from_numpy(x), torch.Generator().manual_seed(4))
    assert torch.equal(g1, g2)
    assert g1.shape == (8, 28, 28, 1) and r.shape == x.shape
    for a in (g1, r):
        assert torch.all((a >= 0) & (a <= 1))


def test_port_init_follows_jax_init_rules():
    """Seeded init: same seed -> same weights; gyroplane points inside the
    ball; bias in [-1, 1]; dense biases zero, weights truncated at 2 std."""
    m1 = GyroplaneVAE(generator=torch.Generator().manual_seed(7), device="cpu")
    m2 = GyroplaneVAE(generator=torch.Generator().manual_seed(7), device="cpu")
    for (k, a), (_, b) in zip(m1.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, b), k
    pts = m1.decoder[0].points
    assert isinstance(pts, ManifoldParameter)
    assert torch.all(torch.linalg.vector_norm(pts, dim=-1) <= (1 - 4e-3) + 1e-6)
    assert torch.all(m1.decoder[0].bias.abs() <= 1)
    w = m1.encoder[1].weight.detach()
    std = (1 / 784) ** 0.5 / 0.87962566103423978
    assert torch.all(w.abs() <= 2 * std + 1e-7)
    assert abs(float(w.std()) - (1 / 784) ** 0.5) < 0.1 * (1 / 784) ** 0.5
    assert torch.all(m1.encoder[1].bias == 0)
