"""PvaeMLPVAE and the distributions under it in the port against the JAX
package, on the CPU.

  * ``Euclidean``'s 13 methods equal JAX's bit for bit (plain additions
    and norms), within 1e-6 for the norm;
  * the Riemannian normal's pieces: the radius grid is JAX's
    ``linspace(0, 1, 512)`` bit for bit; the quadrature normaliser
    within 2e-6 of each value's magnitude (rtol; both sum 512 exponentials
    in another order) and its sigma-gradient within 1e-4 of the largest,
    at d in {2, 5, 10} over sigma in [0.1, 7]; the closed form at d in
    {2, 5} rtol 1e-4 (its alternating sum cancels in f32 in both
    packages) with its gradient 1e-3 of the largest, and at d = 10, where
    the cancellation takes whole nats, no farther from its float64 value
    than twice JAX's plus 1e-4; the quadrature's gradient finite on a
    dense sigma sweep at d = 10 (JAX's own lesson: the closed form's goes
    NaN there);
  * the inverse-CDF radius on JAX's own uniforms (the key JAX's
    ``sample_radius`` draws from): within 1e-5 of the largest radius, its
    sigma-gradient within 2e-3 of each element and within 1e-4 on all but
    1 % of them: the grid CDF is a cumulative sum, which the two libraries
    round in different orders, so where u lies within a few ulps of a
    knot or in the far tail (u > 0.99, segments a few ulps wide) the
    interpolation's slope moves by ~1e-4 relative (readings: at most 3e-4
    on 2 of 2,000 draws);
  * ``RiemannianNormal.rsample_from_noise`` on JAX's own normal(k_dir) and
    uniform(k_rad), its log density, and the sample's gradients in loc
    and scale against ``jax.grad``, at d in {2, 5, 10} (the same rules);
    ``HyperbolicRadius``, ``HypersphericalUniform``, ``expmap_polar`` and
    the ``WrappedNormal`` object likewise;
  * ``PvaeMLPVAE`` (wrapped and Riemannian posterior x geodesic and linear
    decoder x k_train 1 and 3) at 8 x 8 images, hidden 16, batch 4, from
    parameters in JAX's tree (numpy, ``test_torch_port_conv_models._init``)
    carried across by ``state_dict_from_jax_params``: JAX's own ``loss``
    and ``iwae`` run with the port's draws injected into
    ``jax.random.normal`` / ``uniform`` (``_jax_draws``): the loss parts
    rtol 2e-5, gradients within 1e-4 of each tensor's largest, the
    per-sample bound rtol 2e-5; five Riemannian Adam steps as
    ``test_torch_port_conv_models``' rule;
  * serving from a state_dict and from a checkpoint, and experiment 9's
    CLI (``--lane-sweep`` refused; a two-epoch run writes its results).

JAX's references run under ``jax.jit``.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.distributions import HyperbolicRadius as JaxRadius
from hyperbolic_vae_tpu.distributions import HypersphericalUniform as JaxSphere
from hyperbolic_vae_tpu.distributions import RiemannianNormal as JaxRN
from hyperbolic_vae_tpu.distributions import WrappedNormal as JaxWN
from hyperbolic_vae_tpu.distributions import expmap_polar as jax_expmap_polar
from hyperbolic_vae_tpu.distributions import riemannian_normal as jrn
from hyperbolic_vae_tpu.manifolds import Euclidean as JaxEuclidean
from hyperbolic_vae_tpu.manifolds import PoincareBall as JaxBall
from hyperbolic_vae_tpu.models import PvaeMLPVAE as JaxPvae
from hyperbolic_vae_tpu.optim import riemannian_adam
from hyperbolic_vae_tpu_torch.distributions import (
    HyperbolicRadius,
    HypersphericalUniform,
    RiemannianNormal,
    WrappedNormal,
    expmap_polar,
)
from hyperbolic_vae_tpu_torch.distributions import riemannian_normal as trn
from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params
from hyperbolic_vae_tpu_torch.manifolds import Euclidean, PoincareBall
from hyperbolic_vae_tpu_torch.models import PvaeMLPVAE
from hyperbolic_vae_tpu_torch.optim import RiemannianAdam
from test_torch_port_conv_models import _init

SHAPE, H, L, B, K = (8, 8, 1), 16, 2, 4, 6
SIGMAS = np.linspace(0.1, 7.0, 300).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@contextlib.contextmanager
def _jax_draws(normals=(), uniforms=()):
    """``jax.random.normal`` and ``uniform`` return the given arrays, in
    order, while JAX traces a reference: the port's draws injected into
    JAX's own sampling code. A call of another shape (flax checks a
    parameter's shape by tracing its init) goes to JAX's own draw."""
    normals, uniforms = list(normals), list(uniforms)
    orig = jax.random.normal, jax.random.uniform

    def take(queue, own):
        def draw(key, shape=(), *args, **kwargs):
            if queue and tuple(queue[0].shape) == tuple(shape):
                return queue.pop(0)
            return own(key, shape, *args, **kwargs)
        return draw

    jax.random.normal, jax.random.uniform = take(normals, orig[0]), take(uniforms, orig[1])
    try:
        yield
    finally:
        jax.random.normal, jax.random.uniform = orig
    assert not normals and not uniforms, "a draw was not taken"


# ---- Euclidean -----------------------------------------------------------------


def test_euclidean_manifold_equals_jax():
    rng = np.random.default_rng(0)
    x, y, u, v = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4))
    je, te = JaxEuclidean(), Euclidean()
    calls = [("project", (x,)), ("expmap", (x, u)), ("expmap0", (u,)), ("logmap", (x, y)),
             ("logmap0", (y,)), ("transp", (x, y, v)), ("transp0", (y, v)),
             ("egrad2rgrad", (x, u)), ("component_inner", (x, u)),
             ("component_inner", (x, u, v)), ("retr", (x, u))]
    for name, args in calls:
        np.testing.assert_array_equal(getattr(te, name)(*map(_t, args)).numpy(),
                                      np.asarray(getattr(je, name)(*args)), err_msg=name)
    for keep in (False, True):
        np.testing.assert_allclose(te.dist(_t(x), _t(y), keepdim=keep).numpy(),
                                   np.asarray(je.dist(x, y, keepdims=keep)), rtol=1e-6)
    for a, b in zip(te.retr_transp(_t(x), _t(u), _t(v)), je.retr_transp(x, u, v)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert te.origin(3).shape == (3,) and not te.origin((2, 3)).any()
    np.testing.assert_array_equal(te.origin((2, 3)).numpy(), np.asarray(je.origin((2, 3))))


# ---- the Riemannian normal's pieces ---------------------------------------------


def test_radius_grid_is_jax_linspace():
    want = np.asarray(jax.jit(lambda: jnp.linspace(0.0, 1.0, 512, dtype=jnp.float32))())
    np.testing.assert_array_equal(trn._unit_grid(512, "cpu").numpy(), want)


@pytest.mark.parametrize("dim", [2, 5, 10])
def test_radius_normalizers_equal_jax(dim):
    def reference(s):
        q = jrn.log_radius_normalizer(s, 1.0, dim)
        cf = jrn.log_radius_normalizer_closed_form(s, 1.0, dim)
        gq = jax.grad(lambda a: jrn.log_radius_normalizer(a, 1.0, dim).sum())(s)
        gc = jax.grad(lambda a: jrn.log_radius_normalizer_closed_form(a, 1.0, dim).sum())(s)
        return q, cf, gq, gc

    q_j, cf_j, gq_j, gc_j = map(np.asarray, jax.jit(reference)(jnp.asarray(SIGMAS)))
    s = _t(SIGMAS).requires_grad_()
    q = trn.log_radius_normalizer(s, 1.0, dim)
    (gq,) = torch.autograd.grad(q.sum(), s)
    np.testing.assert_allclose(q.detach().numpy(), q_j, rtol=2e-6, atol=1e-6)
    _close(gq, gq_j, 1e-4, "quadrature's gradient")
    s = _t(SIGMAS).requires_grad_()
    cf = trn.log_radius_normalizer_closed_form(s, 1.0, dim)
    if dim < 10:
        (gc,) = torch.autograd.grad(cf.sum(), s)
        np.testing.assert_allclose(cf.detach().numpy(), cf_j, rtol=1e-4)
        _close(gc, gc_j, 1e-3, "closed form's gradient")
        return
    # d = 10: below sigma ~ 0.45 the alternating sum cancels by up to a
    # factor e^15 (float64's reading), where both packages' f32 values are
    # rounding noise; elsewhere (the sum keeps 3 of f32's 7 digits) each
    # is held to float64, the port no farther than twice JAX
    s64 = _t(SIGMAS).double()
    exact = trn.log_radius_normalizer_closed_form(s64, 1.0, dim).numpy()
    k = torch.arange(dim, dtype=torch.float64)
    log_binom = torch.lgamma(torch.tensor(dim, dtype=torch.float64)) - torch.lgamma(k + 1) - (
        torch.lgamma(dim - k))
    log_terms = log_binom + trn._log_gauss_tail_term((dim - 1 - 2 * k) * s64[:, None] / 2 ** 0.5)
    lost = (torch.logsumexp(log_terms, -1) - trn._signed_logsumexp(
        log_terms, torch.where(k % 2 == 0, 1.0, -1.0).double())).numpy()
    kept = lost < np.log(1e3)
    assert kept.sum() >= 290 and np.isfinite(cf.detach().numpy()).all()
    err, err_j = (np.abs(a[kept] - exact[kept]) for a in (cf.detach().numpy(), cf_j))
    assert err.max() <= 2.0 * err_j.max() + 1e-4 and err_j.max() < 1e-3, (err.max(), err_j.max())
    # the quadrature lies near float64's closed form everywhere
    np.testing.assert_allclose(q.detach().numpy(), exact, rtol=0, atol=1e-3)


def test_quadrature_gradient_finite_at_high_dim():
    """The closed form's gradient is NaN at isolated sigma at d = 10
    (0.588, 1.047, ~5.25); the quadrature's is finite on a dense sweep
    and matches a central difference at those sigma."""
    s = torch.linspace(0.1, 7.0, 2000).requires_grad_()
    (g,) = torch.autograd.grad(trn.log_radius_normalizer(s, 1.0, 10).sum(), s)
    assert torch.isfinite(g).all()
    for s0 in (0.588, 1.047, 5.247):
        a = torch.tensor([s0], requires_grad=True)
        (an,) = torch.autograd.grad(trn.log_radius_normalizer(a, 1.0, 10).sum(), a)
        f = [float(trn.log_radius_normalizer(torch.tensor([s0 + d]), 1.0, 10)) for d in (1e-3, -1e-3)]
        fd = (f[0] - f[1]) / 2e-3
        assert abs(fd - float(an)) / max(abs(fd), 1.0) < 1e-3, (s0, fd, float(an))


def _radius_grad_close(got, want):
    """Each element within 2e-3 of its magnitude, all but 1 % within 1e-4
    (the module docstring's tie rule)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert rel.max() <= 2e-3 and (rel > 1e-4).mean() <= 0.01, (rel.max(), (rel > 1e-4).mean())


@pytest.mark.parametrize("dim", [2, 5, 10])
def test_sample_radius_on_jax_uniforms(dim):
    rng = np.random.default_rng(dim)
    sig = rng.uniform(0.1, 3.0, 500).astype(np.float32)
    key = jax.random.PRNGKey(dim)
    # the uniforms JAX's sample_radius draws from this key
    u = np.asarray(jax.random.uniform(key, sig.shape, jnp.float32, 1e-6, 1.0 - 1e-6))
    def reference(s):
        return (jrn.sample_radius(key, s, 1.0, dim),
                jax.grad(lambda a: jrn.sample_radius(key, a, 1.0, dim).sum())(s))

    r_j, g_j = map(np.asarray, jax.jit(reference)(jnp.asarray(sig)))
    s = _t(sig).requires_grad_()
    r = trn.sample_radius_from_uniform(_t(u), s, 1.0, dim)
    (g,) = torch.autograd.grad(r.sum(), s)
    _close(r.detach(), r_j, 1e-5, "radius")
    _radius_grad_close(g, g_j)


def _rn_inputs(dim, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, dim))
    loc = (0.6 * d / np.linalg.norm(d, axis=-1, keepdims=True)
           * rng.uniform(0, 1, (B, 1))).astype(np.float32)
    # some below the 0.1 clamp; large enough to reach the far tail of the radius
    scale = rng.uniform(0.05, 0.6, (B, 1)).astype(np.float32)
    return loc, scale


@pytest.mark.parametrize("dim", [2, 5, 10])
def test_riemannian_normal_equals_jax(dim):
    """rsample_from_noise on JAX's own draws (normal(k_dir), uniform(k_rad)
    of rsample's key split), the sample's gradients in loc and scale, and
    log_prob."""
    loc, scale = _rn_inputs(dim)
    ball, key = JaxBall(1.0), jax.random.PRNGKey(7)
    k_dir, k_rad = jax.random.split(key)
    g = np.asarray(jax.random.normal(k_dir, (K, B, dim), jnp.float32))
    u = np.asarray(jax.random.uniform(k_rad, (K, B), jnp.float32, 1e-6, 1.0 - 1e-6))

    def reference(loc, scale):
        def z_of(lc, sc):
            return JaxRN(lc, sc, ball).rsample(key, (K,))
        z = z_of(loc, scale)
        gl, gs = jax.grad(lambda lc, sc: z_of(lc, sc).sum(), argnums=(0, 1))(loc, scale)
        return z, gl, gs, JaxRN(loc, scale, ball).log_prob(z)

    z_j, gl_j, gs_j, lp_j = map(np.asarray, jax.jit(reference)(jnp.asarray(loc), jnp.asarray(scale)))
    lc, sc = _t(loc).requires_grad_(), _t(scale).requires_grad_()
    q = RiemannianNormal(lc, sc, PoincareBall(1.0))
    z = q.rsample_from_noise(_t(g), _t(u))
    gl, gs = torch.autograd.grad(z.sum(), (lc, sc))
    _close(z.detach(), z_j, 1e-5, "sample")
    _close(gl, gl_j, 1e-4, "d z / d loc")
    _radius_grad_close(gs, gs_j)
    with torch.no_grad():
        lp = q.log_prob(_t(z_j))
    np.testing.assert_allclose(lp.numpy(), lp_j, rtol=2e-5, atol=1e-5)
    # rsample draws the direction's normals, then the radius's uniforms
    gen = torch.Generator().manual_seed(3)
    g2 = torch.randn((K, B, dim), generator=gen)
    u2 = trn.radius_uniform(gen, (K, B))
    z2 = q.rsample(torch.Generator().manual_seed(3), (K,))
    torch.testing.assert_close(z2, q.rsample_from_noise(g2, u2), rtol=0, atol=0)


def test_hyperspherical_and_wrapped_objects_equal_jax():
    rng = np.random.default_rng(1)
    scale = rng.uniform(0.2, 2.0, (5,)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    # HyperbolicRadius: JAX's uniforms of its key; log_prob with the support
    u = np.asarray(jax.random.uniform(key, (3, 5), jnp.float32, 1e-6, 1.0 - 1e-6))
    r_j = np.asarray(jax.jit(lambda s: JaxRadius(3, 1.0, s).rsample(key, (3,)))(scale))
    tr = HyperbolicRadius(3, 1.0, _t(scale))
    r = tr.rsample_from_uniform(_t(u))
    _close(r, r_j, 1e-5, "HyperbolicRadius")
    pts = np.array([-1.0, 0.0, 0.5, 1.5, 3.0], np.float32)
    lp_j = np.asarray(jax.jit(lambda s, p: JaxRadius(3, 1.0, s).log_prob(p))(scale, pts))
    lp = tr.log_prob(_t(pts)).numpy()
    assert np.isneginf(lp[0]) and np.isneginf(lp_j[0])
    np.testing.assert_allclose(lp[1:], lp_j[1:], rtol=1e-5, atol=1e-5)
    # HypersphericalUniform: JAX's normal of its key
    gs = np.asarray(jax.random.normal(key, (7, 3), jnp.float32))
    want = np.asarray(jax.jit(lambda: JaxSphere(2).sample(key, (7,)))())
    _close(HypersphericalUniform(2).sample_from_noise(_t(gs)), want, 1e-6, "sphere")
    np.testing.assert_allclose(HypersphericalUniform(2).log_prob(_t(want)).numpy(),
                               np.asarray(JaxSphere(2).log_prob(want)), rtol=1e-6)
    np.testing.assert_allclose(float(HypersphericalUniform(2).entropy()),
                               float(JaxSphere(2).entropy()), rtol=1e-6)
    assert HypersphericalUniform(2).sample(torch.Generator().manual_seed(0), (4,)).shape == (4, 3)
    # expmap_polar and the WrappedNormal object
    loc, sc = _rn_inputs(3, seed=2)
    alpha = want[:B]  # unit directions in R^3
    rad = rng.uniform(0.1, 2.0, (B,)).astype(np.float32)
    _close(expmap_polar(PoincareBall(1.0), _t(loc), _t(alpha), _t(rad)),
           jax_expmap_polar(JaxBall(1.0), loc, alpha, rad), 1e-5, "expmap_polar")
    eps = rng.normal(size=(K, B, 3)).astype(np.float32)
    wsc = np.repeat(sc, 3, axis=-1)
    jw, tw = JaxWN(loc, wsc, JaxBall(1.0)), WrappedNormal(_t(loc), _t(wsc), PoincareBall(1.0))
    with _jax_draws(normals=[jnp.asarray(eps)]):
        z_j = np.asarray(jax.jit(lambda: jw.rsample(key, (K,)))())
    _close(tw.rsample_from_eps(_t(eps)), z_j, 1e-5, "WrappedNormal.rsample")
    np.testing.assert_allclose(tw.log_prob(_t(z_j)).numpy(),
                               np.asarray(jax.jit(jw.log_prob)(z_j)), rtol=2e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(2)
    torch.testing.assert_close(tw.rsample(gen, (K,)), tw.rsample_from_eps(
        torch.randn((K, B, 3), generator=torch.Generator().manual_seed(2))), rtol=0, atol=0)


# ---- PvaeMLPVAE ---------------------------------------------------------------


def _images(seed=0, b=B):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (b,) + SHAPE).astype(np.float32)


def _pvae(posterior, decoder, k_train=1):
    kw = dict(data_shape=SHAPE, hidden_dim=H, latent_dim=L, posterior=posterior,
              decoder_first=decoder, k_train=k_train)
    jm = JaxPvae(**kw)
    params = _init(jm, SHAPE)
    model = PvaeMLPVAE(**kw, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, model))
    return jm, params, model


def _noise(model, k, seed=1):
    """The port's posterior draws for k samples a row, as numpy."""
    return tuple(a.numpy() for a in model.noise(torch.zeros((B,) + SHAPE), k,
                                                torch.Generator().manual_seed(seed)))


def _jax_pvae(jm, method, noise, *args):
    """JAX's ``loss`` (with its gradients) or ``iwae`` on injected draws."""
    normals, uniforms = noise[:1], noise[1:]

    def run(params, x, *draws):
        with _jax_draws(normals=draws[:1], uniforms=draws[1:]):
            def f(p):
                out = jm.apply({"params": p}, x, *args, method=method,
                               rngs={"sample": jax.random.PRNGKey(0)})
                return (out["loss_total"], out) if method == "loss" else (out.sum(), out)
            (_, out), grads = jax.value_and_grad(f, has_aux=True)(params)
        return out, grads

    return run, tuple(map(jnp.asarray, normals + uniforms))


@pytest.mark.parametrize("k_train", [1, 3])
@pytest.mark.parametrize("decoder", ["geodesic", "linear"])
@pytest.mark.parametrize("posterior", ["wrapped", "riemannian"])
def test_pvae_loss_and_gradients_equal_jax(posterior, decoder, k_train):
    jm, params, model = _pvae(posterior, decoder, k_train)
    x = _images()
    noise = _noise(model, k_train)
    run, draws = _jax_pvae(jm, "loss", noise)
    want, jg = jax.jit(run)(params, jnp.asarray(x), *draws)
    got = model.loss_from_noise(_t(x), tuple(map(_t, noise)))
    assert set(got) == set(want) == {"loss_total", "loss_recon", "loss_kl", "elbo"}
    for k_ in want:
        np.testing.assert_allclose(float(got[k_].detach()), float(want[k_]), rtol=2e-5,
                                   atol=1e-6 * B * k_train if "kl" in k_ else 0.0, err_msg=k_)
    got["loss_total"].backward()
    want_g = state_dict_from_jax_params(jax.tree.map(np.asarray, jg), model)
    for name, p in model.named_parameters():
        _close(p.grad, want_g[name], 1e-4, f"grad {name}")
    assert model.loss_reduction == "per_sample_mean"
    # the loss draws the same noise from a generator
    gen_loss = model.loss(_t(x), torch.Generator().manual_seed(1))
    torch.testing.assert_close(gen_loss["loss_total"], got["loss_total"], rtol=0, atol=0)


@pytest.mark.parametrize("posterior,decoder", [("wrapped", "geodesic"), ("riemannian", "linear")])
def test_pvae_iwae_equals_jax(posterior, decoder):
    jm, params, model = _pvae(posterior, decoder)
    x = _images(2)
    noise = _noise(model, K, seed=5)
    run, draws = _jax_pvae(jm, "iwae", noise, K)
    want, _ = jax.jit(run)(params, jnp.asarray(x), *draws)
    with torch.no_grad():
        got = model.iwae_from_noise(_t(x), tuple(map(_t, noise)))
        assert got.shape == (B,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5)
        # the per-sample bound recombines exactly across chunks of K
        from hyperbolic_vae_tpu_torch.models.iwae import combine_chunked_bounds

        halves = [model.iwae_from_noise(_t(x), tuple(_t(a[s]) for a in noise))
                  for s in (slice(0, 2), slice(2, K))]
        np.testing.assert_allclose(combine_chunked_bounds(halves, [2, K - 2]).numpy(),
                                   got.numpy(), rtol=1e-6)
        assert model.iwae(_t(x), 5, torch.Generator().manual_seed(0)).shape == (B,)
        rec = model.reconstruct(_t(x), torch.Generator().manual_seed(0))
        assert rec.shape == (B,) + SHAPE and bool(((rec > 0) & (rec < 1)).all())
    assert not hasattr(model, "generate")


@pytest.mark.parametrize("posterior", ["wrapped", "riemannian"])
def test_pvae_riemannian_adam_steps_equal_jax(posterior):
    jm, params, model = _pvae(posterior, "geodesic")
    opt = riemannian_adam(learning_rate=1e-3, ball=jm.ball)
    state, update = opt.init(params), jax.jit(opt.update)
    topt = RiemannianAdam(model.parameters(), lr=1e-3, ball=model.ball)
    run, _ = _jax_pvae(jm, "loss", _noise(model, 1))
    step = jax.jit(run)
    p = jax.tree.map(jnp.asarray, params)
    for i in range(5):
        x, noise = _images(10 + i), _noise(model, 1, seed=20 + i)
        _, g = step(p, jnp.asarray(x), *map(jnp.asarray, noise))
        upd, state = update(g, state, p)
        p = jax.tree.map(lambda a, b: a + b, p, upd)
        topt.zero_grad()
        model.loss_from_noise(_t(x), tuple(map(_t, noise)))["loss_total"].backward()
        topt.step()
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, p), model)
    outside = total = 0
    for name, q in model.named_parameters():
        got = q.detach().numpy()
        np.testing.assert_allclose(got, want[name].numpy(), rtol=5e-3, atol=3e-4, err_msg=name)
        outside += int((~np.isclose(got, want[name].numpy(), rtol=1e-4, atol=1e-6)).sum())
        total += got.size
    assert outside <= 0.01 * total, (outside, total)


def test_pvae_state_dict_layout():
    """The port's own layout (JAX has no exporter for this family)."""
    for posterior in ("wrapped", "riemannian"):
        for decoder, first in (("geodesic", {"decoder.0._weight", "decoder.0._bias"}),
                               ("linear", {"decoder.0.weight", "decoder.0.bias"})):
            _, params, model = _pvae(posterior, decoder)
            sd = state_dict_from_jax_params(params, "PvaeMLPVAE")
            assert set(sd) == set(model.state_dict()) == (
                {f"{k}.{w}" for k in ("encoder.1", "mu.0", "scale.0", "decoder.2")
                 for w in ("weight", "bias")} | first)
            assert sd["scale.0.weight"].shape == ((L if posterior == "wrapped" else 1), H)
            if decoder == "geodesic":  # its tree needs no name
                assert state_dict_from_jax_params(params).keys() == sd.keys()


# ---- serving and the CLI --------------------------------------------------------


def test_pvae_serves_from_state_dict_and_checkpoint(tmp_path):
    from hyperbolic_vae_tpu_torch.data import make_data_module
    from hyperbolic_vae_tpu_torch.serve import Inferencer
    from hyperbolic_vae_tpu_torch.serve_http import load_engines, parse_args
    from hyperbolic_vae_tpu_torch.train import Trainer

    dm = make_data_module(batch_size=16, synthetic=True, n_train=200, n_test=13)
    model = PvaeMLPVAE(hidden_dim=H, posterior="riemannian", decoder_first="linear",
                       generator=torch.Generator().manual_seed(0), device="cpu")
    res = Trainer(model, max_epochs=2, epochs_per_dispatch=2, checkpoint_dir=str(tmp_path / "ck"),
                  device="cpu").fit(dm)
    x = dm.x_test
    with torch.no_grad():
        want = torch.cat([model.decode(model.posterior_mean(_t(x[:8]))),
                          model.decode(model.posterior_mean(_t(np.concatenate([x[8:], x[:3]]))))[:5]])
    inf = Inferencer.from_checkpoint(str(tmp_path / "ck"), "last", batch_size=8, device="cpu")
    assert inf.model.hparams() == model.hparams()
    np.testing.assert_array_equal(inf.reconstruct(x), want.numpy())
    assert not inf.supports_method("generate")
    best = Inferencer.from_checkpoint(str(tmp_path / "ck"), "best", batch_size=8, device="cpu")
    assert all(torch.equal(best.model.state_dict()[k], v) for k, v in res.best_params.items())
    # a state_dict file: the keys fit a Euclidean UnifiedVAE too, so the family is named
    path = tmp_path / "pvae.npz"
    np.savez(path, **{k: v.numpy() for k, v in model.state_dict().items()})
    with pytest.raises(ValueError, match="PvaeMLPVAE"):
        Inferencer.from_state_dict(path, device="cpu")
    args = parse_args(["--state-dict", str(path), "--batch-size", "8", "--model-config",
                       json.dumps({"family": "PvaeMLPVAE"})])
    served = load_engines(args, device="cpu")["default"]
    assert isinstance(served.model, PvaeMLPVAE) and served.model.hparams() == model.hparams()
    np.testing.assert_array_equal(served.embed(x), inf.embed(x))
    np.testing.assert_array_equal(served.reconstruct(x), want.numpy())


def test_replicate_cli(tmp_path, capsys):
    from hyperbolic_vae_tpu_torch.experiments import pvae_replicate as cli

    import torch.distributed as dist

    try:  # --seed-mesh spreads the lanes over the world's ranks: one here
        with pytest.raises(SystemExit, match="torchrun --nproc_per_node=4"):
            cli.main(["--device", "cpu", "--lane-sweep", "--seed-mesh", "4", "--n-train", "200",
                      "--n-test", "20", "--run-dir", str(tmp_path / "mesh")])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with pytest.raises(SystemExit, match="does not compose with --lane-sweep"):
        cli.main(["--device", "cpu", "--lane-sweep", "--use-mesh", "--run-dir", str(tmp_path)])
    assert cli.parse_args(["--lane-sweep"]).lane_sweep  # ported: tests/test_torch_port_experiments.py
    out = cli.main(["--device", "cpu", "--epochs", "2", "--n-train", "200", "--n-test", "20",
                    "--batch-size", "32", "--iwae-k", "10", "--curvatures", "1.4",
                    "--run-dir", str(tmp_path)])
    saved = json.loads((tmp_path / "replicate_results.json").read_text())
    assert saved == out and set(out) == {"wrapped_c1.4_d2", "riemannian_c1.4_d2"}
    for r in out.values():
        assert np.isfinite(r["best_val"]) and np.isfinite(r["iwae_10"]) and r["iwae_10"] < 0
    cmp = json.loads((tmp_path / "published_comparison.json").read_text())
    assert "SYNTHETIC" in cmp["warning"] and cmp["rows"][0]["latent_dim"] == 2
    for tag in out:
        assert (tmp_path / tag / "metrics.jsonl").exists()
    assert cli.parse_args([]).epochs == 80 and cli.parse_args([]).batch_size == 128
    assert cli.parse_args([]).lr == 5e-4 and cli.parse_args([]).synthetic
    assert not cli.parse_args(["--real-mnist", "x"]).synthetic
