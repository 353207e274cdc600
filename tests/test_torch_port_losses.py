"""The port's loss pieces against the JAX package: the training half of
the PoincareBall, the wrapped-normal and RelaxedBernoulli log densities,
and ``GyroplaneVAE.loss_from_eps``.

Inputs are made with numpy from a seed and fed to both sides; JAX
parameters are carried into the port with ``state_dict_from_jax_params``.
Tolerances, in f32:
  * values: rtol 1e-5, atol 1e-5 (the same formulas with the same clamps;
    the frameworks differ in last bits only);
  * near the boundary (norm in [0.95, 1] radius) the methods that take
    artanh of a norm (logmap, dist, logdetexp, the log densities) get
    rtol 1e-4: artanh's slope 1/(1 - c|y|^2) reaches ~250 at the
    projection margin and amplifies a last-bit difference in |y| that much;
  * gradients: rtol 1e-4, atol 1e-6;
  * RelaxedBernoulli at pixels of exactly 0 or 1: atol 3e-5. There
    y = log(tiny) - log1p(-tiny) = -87.3 and the density
    base - log(x) - log1p(-x) cancels two numbers of ~87, whose f32
    spacing is 7.6e-6: a last-bit difference in either is 1e-5 absolute;
  * the model's loss: rtol 1e-5 on loss_total and recon (sums over 784
    pixels in two summation orders), KL rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.distributions import relaxed_bernoulli_log_prob as jax_rb
from hyperbolic_vae_tpu.distributions import wrapped_normal_log_prob as jax_wn_log_prob
from hyperbolic_vae_tpu.manifolds import PoincareBall as JaxBall
from hyperbolic_vae_tpu.manifolds.poincare import log_sinh_ratio as jax_lsr
from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxVAE
from hyperbolic_vae_tpu_torch.distributions import (
    relaxed_bernoulli_log_prob,
    wrapped_normal_log_prob,
)
from hyperbolic_vae_tpu_torch.interop import gyroplane_vae_from_state_dict, state_dict_from_jax_params
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall, log_sinh_ratio

TOL = dict(rtol=1e-5, atol=1e-5)
BOUNDARY = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _pts(seed, n, d, c, region):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, d))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    lo, hi = {"interior": (0.0, 0.7), "boundary": (0.95, 1.0), "tangent": (0.0, 2.0)}[region]
    return (u * rng.uniform(lo, hi, size=(n, 1)) / np.sqrt(c)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# method -> the kinds of its arguments (p: a point, v: a tangent vector)
METHODS = {
    "logmap": "pp", "gyration": "ppp", "transp": "ppv", "transp0back": "pv", "dist": "pp",
    "egrad2rgrad": "pv", "component_inner": "pvv", "inner": "pvv", "retr": "pv",
    "logdetexp": "pp", "mobius_neg": "p",
}
ARTANH = {"logmap", "dist", "logdetexp"}


@pytest.mark.parametrize("region", ["interior", "boundary"])
@pytest.mark.parametrize("c", [0.5, 1.0])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_ball_methods_match_jax(method, c, region):
    args = []
    for i, kind in enumerate(METHODS[method]):
        # the first point is in `region`; other points interior; vectors tangent
        reg = region if (kind == "p" and i == 0) else ("interior" if kind == "p" else "tangent")
        if kind == "v":
            args.append(_pts(10 + i, 32, 3, 1.0, "tangent") * 0.3)
        else:
            args.append(_pts(10 + i, 32, 3, c, reg))
    # eager JAX, op by op as the port runs: under jit XLA fuses
    # 1 - c|x|^2, whose rounding the conformal factor amplifies past the
    # projection margin
    j = getattr(JaxBall(c=c), method)(*[jnp.asarray(a) for a in args])
    t = getattr(PoincareBall(c=c), method)(*[_t(a) for a in args])
    assert torch.isfinite(t).all()
    tol = BOUNDARY if (region == "boundary" and method in ARTANH) else TOL
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("c", [0.5, 1.0, 1.4])
def test_retr_transp_matches_jax(c):
    x = _pts(20, 32, 2, c, "interior")
    u = _pts(21, 32, 2, 1.0, "tangent") * 0.2
    v = _pts(22, 32, 2, 1.0, "tangent")
    jy, jv = JaxBall(c=c).retr_transp(jnp.asarray(x), jnp.asarray(u), jnp.asarray(v))
    ty, tv = PoincareBall(c=c).retr_transp(_t(x), _t(u), _t(v))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("keepdim", [False, True])
def test_keepdim_forms_match_jax(keepdim):
    x, y = _pts(30, 8, 2, 1.0, "interior"), _pts(31, 8, 2, 1.0, "interior")
    jb, tb = JaxBall(1.0), PoincareBall(1.0)
    for method in ("dist", "logdetexp"):
        j = getattr(jb, method)(jnp.asarray(x), jnp.asarray(y), keepdims=keepdim)
        t = getattr(tb, method)(_t(x), _t(y), keepdim=keepdim)
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    j = jb.inner(jnp.asarray(x), jnp.asarray(y), keepdims=keepdim)
    t = tb.inner(_t(x), _t(y), keepdim=keepdim)
    assert t.shape == j.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("method", ["logmap", "dist", "logdetexp", "transp", "gyration"])
def test_ball_grads_match_jax(method):
    """Gradients of sum(out * w) with respect to every argument, interior points."""
    c = 1.0
    kinds = METHODS[method]
    args = [(_pts(40 + i, 16, 2, 1.0, "tangent") * 0.3 if k == "v" else _pts(40 + i, 16, 2, c, "interior"))
            for i, k in enumerate(kinds)]
    jfn = getattr(JaxBall(c=c), method)
    shape = np.asarray(jfn(*[jnp.asarray(a) for a in args])).shape
    w = np.random.default_rng(49).normal(size=shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(args)))))(
        *[jnp.asarray(a) for a in args])
    targs = [_t(a).requires_grad_() for a in args]
    (getattr(PoincareBall(c=c), method)(*targs) * _t(w)).sum().backward()
    for ta, ga in zip(targs, jg):
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), **GRAD)


def test_log_sinh_ratio_both_sides_of_the_series_switch():
    """Values and gradients on both sides of t = 0.2, at 0 and far out."""
    t = np.array([0.0, 1e-4, 0.05, 0.1, 0.19, 0.1999, 0.2, 0.2001, 0.25, 1.0, 5.0, 30.0], np.float32)
    np.testing.assert_allclose(log_sinh_ratio(_t(t)).numpy(), np.asarray(jax_lsr(jnp.asarray(t))),
                               rtol=1e-5, atol=1e-7)
    jg = jax.grad(lambda a: jnp.sum(jax_lsr(a)))(jnp.asarray(t))
    tt = _t(t).requires_grad_()
    log_sinh_ratio(tt).sum().backward()
    assert torch.isfinite(tt.grad).all()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("region", ["interior", "boundary"])
@pytest.mark.parametrize("c", [0.5, 1.0, 1.4])
def test_wrapped_normal_log_prob_matches_jax(c, region):
    loc = _pts(50, 32, 2, c, region)
    scale = np.random.default_rng(51).uniform(0.05, 2.0, size=(32, 2)).astype(np.float32)
    x = _pts(52, 32, 2, c, "interior")
    j = jax.jit(lambda *a: jax_wn_log_prob(JaxBall(c), *a))(
        jnp.asarray(loc), jnp.asarray(scale), jnp.asarray(x))
    t = wrapped_normal_log_prob(PoincareBall(c), _t(loc), _t(scale), _t(x))
    assert t.shape == (32,)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(BOUNDARY if region == "boundary" else TOL))
    # the prior: loc at the origin, one scale for every row
    j0 = jax.jit(lambda a: jax_wn_log_prob(JaxBall(c), jnp.zeros(2), jnp.full(2, 1.5), a))(
        jnp.asarray(x))
    t0 = wrapped_normal_log_prob(PoincareBall(c), torch.zeros(2), torch.full((2,), 1.5), _t(x))
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), **TOL)


def test_wrapped_normal_log_prob_grads_match_jax():
    loc, x = _pts(53, 16, 2, 1.0, "interior"), _pts(54, 16, 2, 1.0, "interior")
    scale = np.random.default_rng(55).uniform(0.1, 1.5, size=(16, 2)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda a, s, b: jnp.sum(jax_wn_log_prob(JaxBall(1.0), a, s, b)),
                          argnums=(0, 1, 2)))(jnp.asarray(loc), jnp.asarray(scale), jnp.asarray(x))
    ta, ts, tx = (_t(a).requires_grad_() for a in (loc, scale, x))
    wrapped_normal_log_prob(PoincareBall(1.0), ta, ts, tx).sum().backward()
    for t, g in zip((ta, ts, tx), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD)


@pytest.mark.parametrize("temperature", [0.5, 1.0])
@pytest.mark.parametrize("given", ["probs", "logits"])
def test_relaxed_bernoulli_matches_jax_at_exact_0_and_1(given, temperature):
    rng = np.random.default_rng(60)
    x = rng.uniform(0, 1, size=(8, 100)).astype(np.float32)
    x[:, :30] = 0.0
    x[:, 30:40] = 1.0
    if given == "probs":
        q = rng.uniform(0, 1, size=(8, 100)).astype(np.float32)
        q[:, ::7] = 0.0  # probs of exactly 0 and 1 hit the 1e-7 clip
        q[:, 3::11] = 1.0
    else:
        q = rng.normal(scale=4.0, size=(8, 100)).astype(np.float32)
    j = jax.jit(lambda a, b: jax_rb(a, temperature, **{given: b}))(jnp.asarray(x), jnp.asarray(q))
    t = relaxed_bernoulli_log_prob(_t(x), temperature, **{given: _t(q)})
    assert torch.isfinite(t).all()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=3e-5)
    jg = jax.jit(jax.grad(lambda a: jnp.sum(jax_rb(jnp.asarray(x), temperature, **{given: a}))))(
        jnp.asarray(q))
    tq = _t(q).requires_grad_()
    relaxed_bernoulli_log_prob(_t(x), temperature, **{given: tq}).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)


def test_relaxed_bernoulli_needs_exactly_one_parameterisation():
    x = torch.rand(2, 3)
    with pytest.raises(ValueError):
        relaxed_bernoulli_log_prob(x, 1.0)
    with pytest.raises(ValueError):
        relaxed_bernoulli_log_prob(x, 1.0, logits=x, probs=x)


CONFIGS = {
    "flagship": dict(),
    "nondefault": dict(latent_dim=3, manifold_curvature=1.4, beta=0.5, prior_scale=2.0),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model_pair(request):
    kw = CONFIGS[request.param]
    jm = JaxVAE(**kw)
    B = 24
    rng = np.random.default_rng(70)
    x = rng.uniform(0, 1, size=(B, 28, 28, 1)).astype(np.float32)
    x[:, :4] = 0.0  # rows of exact-0 and exact-1 pixels, as in MNIST
    x[:, -2:] = 1.0
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                              jnp.asarray(x))["params"]
    params = jax.tree.map(np.asarray, params)
    tm = gyroplane_vae_from_state_dict(
        state_dict_from_jax_params(params), device="cpu",
        manifold_curvature=jm.manifold_curvature, prior_scale=jm.prior_scale, beta=jm.beta)
    eps = rng.normal(size=(B, jm.latent_dim)).astype(np.float32)
    return jm, params, tm, x, eps


def _assert_loss_close(t, j):
    np.testing.assert_allclose(float(t["recon_loss"]), float(j["recon_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(t["kl_loss"]), float(j["kl_loss"]), rtol=1e-4, atol=1e-5)
    scale = abs(float(j["recon_loss"])) + abs(float(j["kl_loss"]))
    assert abs(float(t["loss_total"]) - float(j["loss_total"])) <= 1e-5 * scale


def test_loss_from_eps_matches_jax(model_pair):
    jm, params, tm, x, eps = model_pair
    j = jax.jit(lambda p, a, e: jm.apply({"params": p}, a, e, method="loss_from_eps"))(
        params, jnp.asarray(x), jnp.asarray(eps))
    with torch.no_grad():
        t = tm.loss_from_eps(_t(x), _t(eps))
    assert sorted(t) == sorted(j) == ["kl_loss", "loss_total", "recon_loss"]
    _assert_loss_close(t, j)


def test_loss_from_eps_grads_match_jax(model_pair):
    """d loss_total / d params through the whole model (decoder through K1's
    plain path): rtol 1e-3, atol 3e-5 of each tensor's largest gradient.
    Two f32 backward passes in different summation orders; the gyroplane
    points' gradient also goes through the epilogue's cancellation (den,
    |diff|^2), which turns last-bit differences into ~1e-5 of the scale."""
    jm, params, tm, x, eps = model_pair
    jg = jax.jit(jax.grad(lambda p: jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(eps),
                                             method="loss_from_eps")["loss_total"]))(params)
    tm.zero_grad()
    tm.loss_from_eps(_t(x), _t(eps))["loss_total"].backward()
    jsd = state_dict_from_jax_params(jax.tree.map(np.asarray, jg))
    for name, p in tm.named_parameters():
        ref = jsd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-3,
                                   atol=3e-5 * float(np.abs(ref).max()), err_msg=name)


def test_loss_draws_eps_like_rsample(model_pair):
    """model.loss(x, generator) draws eps (B, latent) ~ N(0, I) from the
    generator, as wrapped_normal_rsample does: it equals loss_from_eps
    with that draw."""
    _, _, tm, x, _ = model_pair
    with torch.no_grad():
        a = tm.loss(_t(x), torch.Generator().manual_seed(5))
        eps = torch.randn((x.shape[0], tm.latent_dim), generator=torch.Generator().manual_seed(5))
        b = tm.loss_from_eps(_t(x), eps)
    for k in a:
        assert torch.equal(a[k], b[k]), k
