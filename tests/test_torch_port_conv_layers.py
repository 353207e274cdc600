"""The conv image families' manifold pieces against the JAX package, on
the CPU: ``PoincareBall.mobius_matvec`` (below and above its artanh clip,
and where Mx = 0), ``dist2plane`` / ``normdist2plane`` (signed, scaled),
``arsinh``, the Euclidean normal helpers, ``LogMap0``, and the
Riemannian layers ``GeodesicLayer`` and ``MobiusLayer`` (with and without
``over_param``, ``weight_norm``), at c in {1, 1.4}, from the same
parameters (``weight_t0``/``bias_scalar``/``mp_bias`` as ``_weight``/
``_bias``). Tolerances: values rtol 1e-5 / atol 1e-6 (f32 in both
frameworks, other summation orders); gradients within 1e-4 of each
tensor's largest magnitude. The layers' own init follows JAX's
distributions; ``over_param``'s bias point takes Riemannian Adam's
manifold path, step for step as JAX's (rtol 1e-5) off the projection
margin, and at JAX's own init (on the margin) equal to JAX's in float64
and no farther from float64 than twice JAX in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.distributions import normal as jax_normal
from hyperbolic_vae_tpu.manifolds import PoincareBall as JaxBall
from hyperbolic_vae_tpu.manifolds import poincare as jax_poincare
from hyperbolic_vae_tpu.nn import GeodesicLayer as JaxGeodesic
from hyperbolic_vae_tpu.nn import LogMap0 as JaxLogMap0
from hyperbolic_vae_tpu.nn import MobiusLayer as JaxMobius
from hyperbolic_vae_tpu.optim import riemannian_adam
from hyperbolic_vae_tpu_torch.distributions import (
    kl_normal_normal,
    kl_std_normal_from_logvar,
    normal_log_prob,
)
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall, arsinh, normdist2plane
from hyperbolic_vae_tpu_torch.nn import (
    GeodesicLayer,
    LogMap0,
    ManifoldParameter,
    MobiusLayer,
    kaiming_normal_a_sqrt5,
)
from hyperbolic_vae_tpu_torch.optim import RiemannianAdam


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _grads_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _ball_points(rng, shape, c, lo=0.05, hi=0.9):
    u = rng.normal(size=shape)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    return (u * rng.uniform(lo, hi, shape[:-1] + (1,)) / np.sqrt(c)).astype(np.float32)


@pytest.mark.parametrize("c", [1.0, 1.4])
@pytest.mark.parametrize("regime", ["inside", "saturated", "zero"])
def test_mobius_matvec_equals_jax(c, regime):
    """|x| well inside 1/sqrt(c) (artanh on its curve), |x| >> 1/sqrt(c)
    (the conv features of experiment 5's Mobius head: artanh at its clip
    1 - eps(f32), where both packages' gradient through it is 0), and rows
    with Mx = 0 (the origin)."""
    rng = np.random.default_rng(0)
    m = rng.normal(0.0, 0.3, (3, 40)).astype(np.float32)
    scale = {"inside": 0.3, "saturated": 8.0, "zero": 0.3}[regime] / np.sqrt(c)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    x = (x / np.linalg.norm(x, axis=-1, keepdims=True) * scale).astype(np.float32)
    if regime == "zero":
        x[1] = 0.0
        m[:, :20] = 0.0
        x[4, 20:] = 0.0  # M x = 0 with x != 0
    w = rng.normal(size=(6, 3)).astype(np.float32)
    ball, jball = PoincareBall(c), JaxBall(c)

    def jf(m_, x_):
        return jnp.sum(jball.mobius_matvec(m_, x_) * w)

    want = np.asarray(jax.jit(jball.mobius_matvec)(jnp.asarray(m), jnp.asarray(x)))
    tm, tx = _t(m, True), _t(x, True)
    got = ball.mobius_matvec(tm, tx)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    if regime == "zero":
        assert np.all(want[[1, 4]] == 0.0) and torch.all(got[[1, 4]] == 0.0)
        return
    assert np.all(np.linalg.norm(want, axis=-1) < 1.0 / np.sqrt(c))
    (got * _t(w)).sum().backward()
    gm, gx = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.asarray(m), jnp.asarray(x))
    _grads_close(tm.grad, gm, "d/dM")
    _grads_close(tx.grad, gx, "d/dx")


@pytest.mark.parametrize("c", [1.0, 1.4])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("scaled", [True, False])
def test_dist2plane_equals_jax(c, signed, scaled):
    rng = np.random.default_rng(1)
    x = _ball_points(rng, (5, 1, 3), c)
    p = _ball_points(rng, (7, 3), c)
    a = rng.normal(size=(7, 3)).astype(np.float32)
    ball, jball = PoincareBall(c), JaxBall(c)

    @jax.jit
    def reference(x, p, a, w):
        def f(*v):
            return jnp.sum(jball.dist2plane(*v, signed, scaled) * w)

        return (jball.dist2plane(x, p, a, signed, scaled),
                jax_poincare.normdist2plane(jball, x, a, p, signed, scaled, keepdims=True),
                jax.grad(f, argnums=(0, 1, 2))(x, p, a))

    w = rng.normal(size=(5, 7)).astype(np.float32)
    want, want_keep, g = reference(*map(jnp.asarray, (x, p, a, w)))
    tx, tp, ta = _t(x, True), _t(p, True), _t(a, True)
    got = ball.dist2plane(tx, tp, ta, signed, scaled)
    assert got.shape == (5, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the reference's argument order (normal a before point p), method and
    # free function, keepdim
    np.testing.assert_array_equal(
        normdist2plane(ball, tx, ta, tp, signed, scaled).detach().numpy(), got.detach().numpy())
    np.testing.assert_allclose(
        ball.normdist2plane(tx, ta, tp, signed, scaled, keepdim=True).detach().numpy(),
        np.asarray(want_keep), rtol=1e-5, atol=1e-6)
    (got * _t(w)).sum().backward()
    for mine, theirs, what in zip((tx.grad, tp.grad, ta.grad), g, "xpa"):
        _grads_close(mine, theirs, f"d/d{what}")
    v = np.linspace(-30, 30, 41, dtype=np.float32)
    np.testing.assert_allclose(arsinh(_t(v)).numpy(), np.asarray(jax_poincare.arsinh(v)),
                               rtol=1e-6)


def test_normal_helpers_equal_jax():
    rng = np.random.default_rng(2)
    x, loc, lv = (rng.normal(size=(4, 9)).astype(np.float32) for _ in range(3))
    sp, sq = (rng.uniform(0.1, 3.0, (4, 9)).astype(np.float32) for _ in range(2))
    loc_q = rng.normal(size=(4, 9)).astype(np.float32)
    pairs = (
        (normal_log_prob(_t(x), _t(loc), _t(sp)), jax_normal.normal_log_prob(x, loc, sp)),
        (kl_normal_normal(_t(loc), _t(sp), _t(loc_q), _t(sq)),
         jax_normal.kl_normal_normal(loc, sp, loc_q, sq)),
        (kl_std_normal_from_logvar(_t(loc), _t(lv)),
         jax_normal.kl_std_normal_from_logvar(loc, lv)),
    )
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _riemannian_params(rng, n_in, n_out, c, over_param, point_scale=1.0):
    """A Riemannian layer's parameters in JAX's names, drawn as JAX's init
    (``point_scale`` < 1 draws the bias points nearer the origin)."""
    jp = {"weight_t0": rng.normal(0.0, np.sqrt(1.0 / 3.0 / n_in), (n_out, n_in))}
    bound = 4.0 / np.sqrt(n_in)
    if over_param:
        u = point_scale * rng.uniform(-bound, bound, (n_out, n_in))
        jp["mp_bias"] = np.asarray(JaxBall(c).expmap0(u))
    else:
        jp["bias_scalar"] = rng.uniform(-bound, bound, (n_out, 1))
    return {k: np.asarray(v, np.float32) for k, v in jp.items()}


LAYER_CASES = [("geodesic", False, False), ("geodesic", True, False), ("geodesic", False, True),
               ("mobius", False, False), ("mobius", True, False)]


@pytest.mark.parametrize("c", [1.0, 1.4])
@pytest.mark.parametrize("kind,over_param,weight_norm", LAYER_CASES)
def test_riemannian_layers_equal_jax(kind, over_param, weight_norm, c):
    """Forward and gradients (at the parameters and the input) of
    GeodesicLayer (the reference's live convention: the plane through the
    transported weight, normal the bias point) and MobiusLayer."""
    rng = np.random.default_rng(3)
    n_in, n_out = (2, 24) if kind == "geodesic" else (12, 3)
    jp = _riemannian_params(rng, n_in, n_out, c, over_param)
    x = _ball_points(rng, (5, n_in), c) if kind == "geodesic" else rng.normal(
        0.0, 0.2, (5, n_in)).astype(np.float32)
    jball = JaxBall(c)
    jkw = dict(in_features=n_in, out_features=n_out, ball=jball, over_param=over_param)
    if kind == "geodesic":
        jl = JaxGeodesic(**jkw, weight_norm=weight_norm)
        layer = GeodesicLayer(n_in, n_out, PoincareBall(c), over_param=over_param,
                              weight_norm=weight_norm)
    else:
        jl = JaxMobius(**jkw)
        layer = MobiusLayer(n_in, n_out, PoincareBall(c), over_param=over_param)
    assert [n for n, _ in layer.named_parameters()] == ["_weight", "_bias"]
    assert isinstance(layer._bias, ManifoldParameter) == over_param
    with torch.no_grad():
        layer._weight.copy_(_t(jp["weight_t0"]))
        layer._bias.copy_(_t(jp["mp_bias" if over_param else "bias_scalar"]))
    w = rng.normal(size=(5, n_out)).astype(np.float32)

    def jf(params, x_):
        return jnp.sum(jl.apply({"params": params}, x_) * w)

    want = np.asarray(jax.jit(jl.apply)({"params": jp}, jnp.asarray(x)))
    tx = _t(x, True)
    got = layer(tx)
    assert got.shape == (5, n_out)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    (got * _t(w)).sum().backward()
    gp, gx = jax.jit(jax.grad(jf, argnums=(0, 1)))(jp, jnp.asarray(x))
    _grads_close(tx.grad, gx, "d/dx")
    _grads_close(layer._weight.grad, gp["weight_t0"], "d/d_weight")
    _grads_close(layer._bias.grad, gp["mp_bias" if over_param else "bias_scalar"], "d/d_bias")


def test_logmap0_and_the_layers_own_init():
    rng = np.random.default_rng(4)
    y = _ball_points(rng, (6, 3), 1.4)
    np.testing.assert_allclose(
        LogMap0(PoincareBall(1.4))(_t(y)).numpy(),
        np.asarray(JaxLogMap0(JaxBall(1.4)).apply({}, jnp.asarray(y))), rtol=1e-5, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    w = kaiming_normal_a_sqrt5((256, 512), g)
    assert abs(float(w.std()) / np.sqrt(1.0 / 3.0 / 512) - 1.0) < 0.02
    ball = PoincareBall(1.4)
    lay = MobiusLayer(512, 64, ball, generator=g)
    bound = 4.0 / np.sqrt(512)
    b = lay._bias.detach()
    assert b.shape == (64, 1) and float(b.abs().max()) <= bound
    assert float(b.std()) > 0.4 * bound  # U(-bound, bound): std bound / sqrt 3
    over = GeodesicLayer(8, 16, ball, over_param=True, generator=g)
    pts = over._bias.detach()
    assert pts.shape == (16, 8)
    assert torch.all(torch.linalg.vector_norm(pts, dim=-1) < ball.radius)
    torch.testing.assert_close(pts, ball.expmap0(ball.logmap0(pts)), rtol=1e-5, atol=1e-6)


def test_over_param_bias_takes_the_manifold_path_as_jax():
    """Five Riemannian Adam steps of an over-parameterised MobiusLayer from
    the same gradients: ``_bias`` (JAX ``mp_bias``) is retracted on the
    ball, ``_weight`` takes Adam, in both packages. JAX's init puts the
    points on the projection margin (|u| ~ 4/sqrt 3 before expmap0), where
    steps diverge by f32 rounding in both packages: here they
    start at a fifth of it."""
    rng = np.random.default_rng(5)
    c = 1.4
    jp = _riemannian_params(rng, 6, 4, c, True, point_scale=0.2)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in jp.items()}
             for _ in range(5)]
    opt = riemannian_adam(learning_rate=1e-2, ball=JaxBall(c))
    params = jax.tree.map(jnp.asarray, jp)
    state = opt.init(params)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
    layer = MobiusLayer(6, 4, PoincareBall(c), over_param=True)
    with torch.no_grad():
        layer._weight.copy_(_t(jp["weight_t0"]))
        layer._bias.copy_(_t(jp["mp_bias"]))
    topt = RiemannianAdam(layer.parameters(), lr=1e-2, ball=layer.ball)
    for g in grads:
        layer._weight.grad, layer._bias.grad = _t(g["weight_t0"]), _t(g["mp_bias"])
        topt.step()
    for mine, key in ((layer._weight, "weight_t0"), (layer._bias, "mp_bias")):
        np.testing.assert_allclose(mine.detach().numpy(), np.asarray(params[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    # the point stayed on the ball, and moved off its Euclidean Adam path
    assert torch.all(torch.linalg.vector_norm(layer._bias, dim=-1) < layer.ball.radius)


def test_over_param_bias_at_jax_init_as_accurate_as_jax():
    """The same five steps from JAX's own, unscaled init, where the bias
    points lie on the projection margin (|x| sqrt(c) ~ 0.996). In float64
    (JAX under ``enable_x64``, the port's layer and optimizer in float64)
    the two agree within 1e-9 of the largest magnitude. In f32 each
    package lands 1e-3 to 4e-2 from that float64 evaluation, by a rounding
    lottery whose winner changes from draw to draw: over eight draws the
    port's largest distance is no more than twice JAX's largest."""
    rng = np.random.default_rng(5)
    c = 1.4

    def run_jax(jp, grads, dtype):
        opt = riemannian_adam(learning_rate=1e-2, ball=JaxBall(c))
        params = jax.tree.map(lambda a: jnp.asarray(a, dtype), jp)
        state = opt.init(params)
        for g in grads:
            upd, state = opt.update(jax.tree.map(lambda a: jnp.asarray(a, dtype), g), state, params)
            params = jax.tree.map(lambda p, u: p + u, params, upd)
        return {k: np.asarray(v, np.float64) for k, v in params.items()}

    def run_port(jp, grads, dtype):
        layer = MobiusLayer(6, 4, PoincareBall(c), over_param=True).to(dtype)
        with torch.no_grad():
            layer._weight.copy_(_t(jp["weight_t0"]))
            layer._bias.copy_(_t(jp["mp_bias"]))
        topt = RiemannianAdam(layer.parameters(), lr=1e-2, ball=layer.ball)
        for g in grads:
            layer._weight.grad = _t(g["weight_t0"]).to(dtype)
            layer._bias.grad = _t(g["mp_bias"]).to(dtype)
            topt.step()
        return {"weight_t0": layer._weight.detach().double().numpy(),
                "mp_bias": layer._bias.detach().double().numpy()}

    err_port = err_jax = 0.0
    for _ in range(8):
        jp = _riemannian_params(rng, 6, 4, c, True)
        assert np.linalg.norm(jp["mp_bias"], axis=-1).max() * np.sqrt(c) > 0.98
        grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in jp.items()}
                 for _ in range(5)]
        with jax.enable_x64(True):
            exact = run_jax(jp, grads, jnp.float64)
        exact_port = run_port(jp, grads, torch.float64)
        want, got = run_jax(jp, grads, jnp.float32), run_port(jp, grads, torch.float32)
        for key, e in exact.items():
            np.testing.assert_allclose(exact_port[key], e, rtol=0,
                                       atol=1e-9 * np.abs(e).max(), err_msg=key)
            assert np.isfinite(got[key]).all(), key
        err_port = max(err_port, np.abs(got["mp_bias"] - exact["mp_bias"]).max())
        err_jax = max(err_jax, np.abs(want["mp_bias"] - exact["mp_bias"]).max())
        np.testing.assert_allclose(got["weight_t0"], want["weight_t0"], rtol=1e-5, atol=1e-6)
    assert 0.0 < err_port <= 2.0 * err_jax, (err_port, err_jax)
