"""The port's importance-weighted bound against the JAX package.

Both packages get the same JAX-initialised flagship parameters (carried
in with ``state_dict_from_jax_params``), the same numpy batches and the
same standard-normal draws eps (K, B, latent): the JAX bound is built from
JAX's own pieces on those draws. Tolerances:
  * the flagship's bound (B,): rtol 1e-5, atol 1e-4 (a sum of 784 pixel
    log densities of up to ~87 each, in two frameworks' f32 orders);
  * ``combine_chunked_bounds``: rtol 1e-6; chunks of (5, 5, 2) against one
    chunk of 12 on the same draws: rtol 1e-5;
  * ``gaussian_loglik`` and the Euclidean branch of ``latent_log_weights``:
    rtol 1e-6, atol 1e-5;
  * ``Trainer.evaluate_iwae`` against JAX's recombination of the port's own
    draws, reproduced in the documented order: rtol 1e-5;
  * the K = 1 bound's mean against -(recon_loss + kl_loss) of
    ``loss_from_eps`` on the same eps: rtol 1e-6.
The kernel test (marked ``cuda``) holds K1 at the IWAE decode's shape to
its tolerances on a card, where there is no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_port_iwae.py``.
"""

import types

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.data import ArrayDataModule, synthetic_mnist_arrays
from hyperbolic_vae_tpu_torch.interop import (
    gyroplane_vae_from_state_dict,
    state_dict_from_jax_params,
)
from hyperbolic_vae_tpu_torch.models import iwae as port_iwae
from hyperbolic_vae_tpu_torch.ops import gyroplane as port_gyro
from hyperbolic_vae_tpu_torch.train import Trainer

B, K, D = 6, 12, 2


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported only by the tests that compare with it (the
    card's machine has no JAX): jax, jax.numpy, ``models/iwae.py`` and
    ``bound(params, x, eps)``, the default flagship's bound (B,) from JAX's
    own pieces on the draw eps."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from hyperbolic_vae_tpu.distributions import (
        relaxed_bernoulli_log_prob,
        wrapped_normal_log_prob,
        wrapped_normal_rsample_from_eps,
    )
    from hyperbolic_vae_tpu.models import GyroplaneVAE
    from hyperbolic_vae_tpu.models import iwae

    jm = GyroplaneVAE()

    @jax.jit
    def bound(params, x, eps):
        ball = jm.ball
        k, b = eps.shape[:2]
        mu, scale = jm.apply({"params": params}, x, method="encode")
        z = wrapped_normal_rsample_from_eps(ball, mu, scale, eps)
        log_q = wrapped_normal_log_prob(ball, mu, scale, z)
        log_p = wrapped_normal_log_prob(ball, jnp.zeros((D,), jnp.float32),
                                        jnp.full((D,), jm.prior_scale, jnp.float32), z)
        xh = jm.apply({"params": params}, z.reshape(-1, D), method="decode").reshape(k, b, -1)
        log_px = jnp.sum(relaxed_bernoulli_log_prob(x.reshape(b, -1)[None], 1.0, probs=xh), axis=-1)
        return iwae.iwae_bound(log_px + log_p - log_q)

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, iwae=iwae, model=jm,
        bound=lambda params, x, eps: np.asarray(bound(params, jnp.asarray(x), jnp.asarray(eps))))


@pytest.fixture(scope="module")
def setup(jx):
    x = synthetic_mnist_arrays(40, 1, seed=3)[0]
    k1, k2 = jx.jax.random.split(jx.jax.random.PRNGKey(0))
    params = jx.jax.jit(jx.model.init)({"params": k1, "sample": k2}, jx.jnp.asarray(x[:2]))["params"]
    params = jx.jax.tree.map(np.asarray, params)
    model = gyroplane_vae_from_state_dict(state_dict_from_jax_params(params), device="cpu")
    return params, model, x


def _eps(seed, k, b):
    return np.random.default_rng(seed).normal(size=(k, b, D)).astype(np.float32)


def test_iwae_from_eps_equals_jax(jx, setup):
    params, model, x = setup
    eps = _eps(1, K, B)
    with torch.no_grad():
        got = model.iwae_from_eps(torch.from_numpy(x[:B]), torch.from_numpy(eps)).numpy()
    want = jx.bound(params, x[:B], eps)
    assert got.shape == (B,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("ks", [(3,), (5, 5, 2), (1, 7, 4, 500)])
def test_combine_chunked_bounds_equals_jax(jx, ks):
    rng = np.random.default_rng(len(ks))
    bounds = [rng.normal(-500.0, 30.0, size=(B,)).astype(np.float32) for _ in ks]
    got = port_iwae.combine_chunked_bounds([torch.from_numpy(b) for b in bounds], ks).numpy()
    want = np.asarray(jx.iwae.combine_chunked_bounds([jx.jnp.asarray(b) for b in bounds], ks))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_chunks_recombine_to_one_chunk(setup):
    """Chunks of (5, 5, 2) draws, recombined, equal one chunk of all 12."""
    _, model, x = setup
    eps = torch.from_numpy(_eps(2, K, B))
    xb = torch.from_numpy(x[:B])
    with torch.no_grad():
        whole = model.iwae_from_eps(xb, eps)
        parts = [model.iwae_from_eps(xb, eps[a:b]) for a, b in ((0, 5), (5, 10), (10, 12))]
    np.testing.assert_allclose(port_iwae.combine_chunked_bounds(parts, (5, 5, 2)).numpy(),
                               whole.numpy(), rtol=1e-5)


def test_euclidean_log_weights_and_gaussian_loglik_equal_jax(jx):
    """``latent_log_weights`` with ``ball=None`` (a diagonal Gaussian q and
    prior) and a Gaussian likelihood, against JAX's on JAX's own draw (its
    module's rng stands in for a fixed key)."""
    rng = np.random.default_rng(4)
    mu = rng.normal(size=(B, 3)).astype(np.float32)
    scale = rng.uniform(0.3, 1.5, size=(B, 3)).astype(np.float32)
    w = rng.normal(size=(3, 20)).astype(np.float32)
    xf = rng.normal(size=(B, 20)).astype(np.float32)
    jax, jnp = jx.jax, jx.jnp
    key = jax.random.PRNGKey(7)
    module = types.SimpleNamespace(make_rng=lambda name: key)

    def jax_loglik(zf):
        return jx.iwae.gaussian_loglik(jnp.asarray(xf), (zf @ w).reshape(K, B, -1), scale=0.7)

    want = np.asarray(jx.iwae.latent_log_weights(module, None, jnp.asarray(mu), jnp.asarray(scale),
                                                 K, 1.3, jax_loglik))
    eps = np.array(jax.random.normal(key, (K, B, 3), jnp.float32))

    def port_loglik(zf):
        return port_iwae.gaussian_loglik(torch.from_numpy(xf), (zf @ torch.from_numpy(w))
                                         .reshape(K, B, -1), scale=0.7)

    got = port_iwae.latent_log_weights_from_eps(None, torch.from_numpy(mu), torch.from_numpy(scale),
                                                torch.from_numpy(eps), 1.3, port_loglik).numpy()
    assert got.shape == (K, B)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    xh = rng.normal(size=(K, B, 20)).astype(np.float32)
    np.testing.assert_allclose(
        port_iwae.gaussian_loglik(torch.from_numpy(xf), torch.from_numpy(xh)).numpy(),
        np.asarray(jx.iwae.gaussian_loglik(jnp.asarray(xf), jnp.asarray(xh))), rtol=1e-6, atol=1e-5)


def test_latent_log_weights_draws_from_the_generator(setup):
    """``latent_log_weights`` (ball branch) is ``latent_log_weights_from_eps``
    on eps (k, B, latent) drawn from the generator."""
    _, model, x = setup
    mu, scale = model.encode(torch.from_numpy(x[:B]))
    mu, scale = mu.detach(), scale.detach()

    def loglik(zf):
        return -(zf * zf).sum(-1).reshape(K, B)

    got = port_iwae.latent_log_weights(model.ball, mu, scale, K, 1.0, loglik,
                                       torch.Generator().manual_seed(5))
    eps = torch.randn((K, B, D), generator=torch.Generator().manual_seed(5))
    want = port_iwae.latent_log_weights_from_eps(model.ball, mu, scale, eps, 1.0, loglik)
    assert torch.equal(got, want)


def test_evaluate_iwae_equals_jax_recombination_of_the_same_draws(jx, setup):
    """``Trainer.evaluate_iwae`` (k = 7 in chunks of 3, 3 and 1, batch chunks of
    5 of a 10-row split) against the JAX bound on the port's draws, reproduced in
    the documented order (seed + 2; batch chunks, then k chunks), recombined
    and averaged by JAX."""
    params, model, x = setup
    xs = x[:10]
    y = np.zeros(10, np.int32)
    dm = ArrayDataModule(xs, y, xs, y, xs, y, batch_size=4)
    trainer = Trainer(model, max_epochs=1, seed=11, device="cpu")
    got = trainer.evaluate_iwae(dm, k=7, batch_chunk=5, k_chunk=3)
    gen = torch.Generator().manual_seed(11 + 2)
    ks = [3, 3, 1]
    total = 0.0
    for start in range(0, 10, 5):
        xb = xs[start:start + 5]
        bounds = [jx.bound(params, xb, torch.randn((kc, len(xb), D), generator=gen).numpy())
                  for kc in ks]
        total += float(jx.jnp.sum(jx.iwae.combine_chunked_bounds(
            [jx.jnp.asarray(b) for b in bounds], ks)))
    np.testing.assert_allclose(got, total / 10, rtol=1e-5)


def test_k1_bound_mean_is_the_elbo(setup):
    """At K = 1 the bound is the single-sample ELBO: its batch mean equals
    -(recon_loss + kl_loss) of ``loss_from_eps`` on the same draw."""
    _, model, x = setup
    eps = _eps(6, 1, B)
    xb = torch.from_numpy(x[:B])
    with torch.no_grad():
        bound = model.iwae_from_eps(xb, torch.from_numpy(eps))
        m = model.loss_from_eps(xb, torch.from_numpy(eps[0]))
    np.testing.assert_allclose(float(bound.mean()), -float(m["recon_loss"] + m["kl_loss"]),
                               rtol=1e-6)


@pytest.mark.cuda
def test_k1_at_the_iwae_decode_shape_matches_plain_on_card():
    """K1 at the IWAE decode's shape (k * B = 128,000 latents, P = 16,
    D = 2) against the plain version on the card: interior atol 1e-5; near
    the boundary the kernel's error against float64 at most twice the plain
    version's, plus 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(8)
    for region, (lo, hi) in (("interior", (0.0, 0.7)), ("boundary", (0.95, 1.0 - 4e-3))):
        u = rng.normal(size=(128_000 + 16, D))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        pts = torch.from_numpy((u * rng.uniform(lo, hi, size=(len(u), 1))).astype(np.float32)).cuda()
        x, p = pts[:128_000].contiguous(), pts[128_000:].contiguous()
        bias = torch.from_numpy(rng.uniform(-1, 1, 16).astype(np.float32)).cuda()
        out = port_gyro.gyroplane_distances_cuda(x, p, 1.0, True, bias)
        torch.cuda.synchronize()
        ref = port_gyro.gyroplane_distances(x, p, 1.0, True, bias)
        assert torch.isfinite(out).all()
        if region == "interior":
            assert float((out - ref).abs().max()) <= 1e-5
            continue
        exact = port_gyro.gyroplane_distances(x.double(), p.double(), 1.0, True, bias.double())
        k_err = float((out.double() - exact).abs().max())
        p_err = float((ref.double() - exact).abs().max())
        assert k_err <= 2.0 * p_err + 1e-5, (k_err, p_err)
