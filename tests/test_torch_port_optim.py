"""The port's RiemannianAdam and training controllers against the JAX
package.

Both optimizers start from one state: JAX's ``riemannian_adam`` takes
three steps from the flagship's init, then its ``RiemannianAdamState`` is
carried into the port with ``optimizer_state_from_jax`` and the
parameters with ``state_dict_from_jax_params``. Then both take ten steps
on the same numpy gradients. Tolerance: rtol 1e-5, atol 1e-7 on
parameters and moments: the same f32 formulas in the same order, so the
frameworks differ at most in last bits. A manifold leaf near the ball's
boundary is compared in float64 (see that test for why).

The controllers compare in float32 on both sides, so scripted metric
sequences must give exactly JAX's lr sequence and stop epoch.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperbolic_vae_tpu.manifolds import PoincareBall as JaxBall
from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxVAE
from hyperbolic_vae_tpu.optim import EarlyStopping as JaxEarlyStopping
from hyperbolic_vae_tpu.optim import ReduceLROnPlateau as JaxPlateau
from hyperbolic_vae_tpu.optim import riemannian_adam
from hyperbolic_vae_tpu_torch.interop import (
    gyroplane_vae_from_state_dict,
    optimizer_state_from_jax,
    state_dict_from_jax_params,
)
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.optim import EarlyStopping, ReduceLROnPlateau, RiemannianAdam

TOL = dict(rtol=1e-5, atol=1e-7)


def _grads(rng, params):
    return jax.tree.map(lambda p: (0.1 * rng.normal(size=p.shape)).astype(np.float32), params)


def _flagship_params():
    jm = JaxVAE(latent_dim=2)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                              jnp.zeros((2, 28, 28, 1)))["params"]
    return jax.tree.map(np.array, params)


@pytest.fixture(scope="module")
def start():
    return _flagship_params()


def _to_port(params, state, c, weight_decay):
    """The JAX params and RiemannianAdamState carried into the port."""
    np_params = jax.tree.map(np.asarray, params)
    tm = gyroplane_vae_from_state_dict(state_dict_from_jax_params(np_params), device="cpu",
                                       manifold_curvature=c)
    topt = RiemannianAdam(tm.parameters(), lr=1e-3, weight_decay=weight_decay, ball=PoincareBall(c))
    topt.load_moments(optimizer_state_from_jax(jax.tree.map(np.asarray, state), tm))
    return tm, topt


def _set_grads(tm, g):
    named = dict(tm.named_parameters())
    for name, gt in state_dict_from_jax_params(g).items():
        named[name].grad = gt


def _jax_opt(start, c, weight_decay, near_boundary=False):
    """Eager JAX riemannian_adam (op by op, as the port runs) and the
    params, after three steps from the flagship's init."""
    opt = riemannian_adam(learning_rate=1e-3, ball=JaxBall(c), weight_decay=weight_decay)
    params = jax.tree.map(np.array, start)
    pts = params["gyroplanes"]["mp_points"]
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts *= np.linspace(0.1, 0.6, len(pts))[:, None]  # interior
    if near_boundary:
        pts[:6] *= 0.99 * (1 - 4e-3) / np.linalg.norm(pts[:6], axis=-1, keepdims=True)
    params["gyroplanes"]["mp_points"] = pts / np.sqrt(c)
    params = jax.tree.map(jnp.asarray, params)
    state = opt.init(params)
    rng = np.random.default_rng(3)
    for _ in range(3):
        upd, state = opt.update(_grads(rng, params), state, params)
        params = optax.apply_updates(params, upd)
    return opt, params, state, rng


def _assert_match(tm, topt, params, state, tol_m=TOL):
    jp = state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    jm = state_dict_from_jax_params(jax.tree.map(np.asarray, state.exp_avg))
    jv = state_dict_from_jax_params(jax.tree.map(np.asarray, state.exp_avg_sq))
    assert int(topt.count) == int(state.count)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(), err_msg=name, **TOL)
        np.testing.assert_allclose(topt.state[p]["exp_avg"].numpy(), jm[name].numpy(), err_msg=name, **tol_m)
        np.testing.assert_allclose(topt.state[p]["exp_avg_sq"].numpy(), jv[name].numpy(), err_msg=name, **TOL)


def _run(start, c, weight_decay):
    opt, params, state, rng = _jax_opt(start, c, weight_decay)
    tm, topt = _to_port(params, state, c, weight_decay)
    for _ in range(10):
        g = _grads(rng, params)
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        _set_grads(tm, g)
        topt.step()
    return params, state, tm, topt


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("c", [1.0, 0.5])
def test_riemannian_adam_matches_jax_over_10_steps(start, c, weight_decay):
    params, state, tm, topt = _run(start, c, weight_decay)
    assert int(state.count) == 13
    _assert_match(tm, topt, params, state)


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_riemannian_adam_near_boundary_in_float64(c):
    """Sixteen gyroplane points, six at 0.99 of the projection radius
    (conformal factor ~125), ten free-running steps, in float64 on both
    sides. In f32 the two agree bit for bit until one last-bit
    difference (the frameworks' tanh differ by an ulp), which the
    transport then decorrelates: gyr[y, -x] m is computed through Mobius
    additions of points near the boundary, where exp_avg is the small
    difference of numbers of ~1, and one ulp of the new point moves it by
    up to ~30 %. In float64 the same formulas agree to rtol 1e-9."""
    from hyperbolic_vae_tpu_torch.nn import ManifoldParameter

    rng = np.random.default_rng(4)
    pts = rng.normal(size=(16, 2))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts *= np.r_[np.full(6, 0.99 * (1 - 4e-3)), np.linspace(0.1, 0.8, 10)][:, None] / np.sqrt(c)
    grads = [0.1 * rng.normal(size=(16, 2)) for _ in range(10)]
    with jax.enable_x64(True):
        opt = riemannian_adam(learning_rate=1e-3, ball=JaxBall(c))
        params = {"mp_points": jnp.asarray(pts, jnp.float64)}
        state = opt.init(params)
        for g in grads:
            upd, state = opt.update({"mp_points": jnp.asarray(g, jnp.float64)}, state, params)
            params = optax.apply_updates(params, upd)
        want = [np.asarray(t["mp_points"]) for t in (params, state.exp_avg, state.exp_avg_sq)]
    p = ManifoldParameter(torch.tensor(pts, dtype=torch.float64))
    topt = RiemannianAdam([p], lr=1e-3, ball=PoincareBall(c))
    for g in grads:
        p.grad = torch.tensor(g)
        topt.step()
    got = [p.detach(), topt.state[p]["exp_avg"], topt.state[p]["exp_avg_sq"]]
    assert p.dtype == torch.float64
    for a_, b_ in zip(got, want):
        np.testing.assert_allclose(a_.numpy(), b_, rtol=1e-9, atol=1e-15)
    assert torch.all(p.detach().norm(dim=-1) <= (1 - 4e-3) / np.sqrt(c) * (1 + 1e-12))


def _snapshot(tm, opt):
    out = [p.detach().clone() for p in tm.parameters()]
    for p in tm.parameters():
        out += [opt.state[p]["exp_avg"].clone(), opt.state[p]["exp_avg_sq"].clone()]
    return out + [opt.count.clone()]


def test_masked_step_keeps_everything_when_not_ok(start):
    """step(ok=False) leaves every parameter, both moments and count
    bit-identical; step(ok=True) is bit-identical to a plain step."""
    _, _, tm, opt = _run(start, 1.0, 0.0)
    rng = np.random.default_rng(9)
    for p in tm.parameters():
        p.grad = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
    before = _snapshot(tm, opt)
    opt.step(ok=torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(before, _snapshot(tm, opt)))
    twin = gyroplane_vae_from_state_dict(tm.state_dict(), device="cpu")
    topt = RiemannianAdam(twin.parameters(), lr=1e-3, ball=PoincareBall(1.0))
    topt.load_state_dict(copy.deepcopy(opt.state_dict()))  # state_dict holds references
    for p, q in zip(tm.parameters(), twin.parameters()):
        q.grad = p.grad.clone()
    opt.step(ok=torch.tensor(True))
    topt.step()
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(tm, opt), _snapshot(twin, topt)))
    assert int(opt.count) == 14


def test_state_dict_round_trip_keeps_count_and_moments(start):
    _, _, tm, opt = _run(start, 1.0, 0.0)
    twin = gyroplane_vae_from_state_dict(tm.state_dict(), device="cpu")
    topt = RiemannianAdam(twin.parameters(), lr=1e-3)
    topt.load_state_dict(copy.deepcopy(opt.state_dict()))  # state_dict holds references
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(tm, opt), _snapshot(twin, topt)))


def test_manifold_dispatch_is_by_parameter_type():
    """The same tensor values: a ManifoldParameter moves along the ball,
    a plain Parameter by Euclidean Adam."""
    from hyperbolic_vae_tpu_torch.nn import ManifoldParameter

    x = torch.tensor([[0.5, 0.2]])
    mp, ep = ManifoldParameter(x.clone()), torch.nn.Parameter(x.clone())
    for p in (mp, ep):
        p.grad = torch.tensor([[1.0, -2.0]])
        RiemannianAdam([p], lr=0.1).step()
    # first step: direction = g_r / (lambda |g_r| + eps) = sign(g) / lambda
    ball = PoincareBall(1.0)
    ref = ball.project(ball.expmap(x, -0.1 * torch.tensor([[1.0, -1.0]]) / ball.lambda_x(x)))
    assert not torch.allclose(mp, ep)
    # sign(g) steps of lr; rtol 1e-5 for the f32 bias correction 1 - 0.999
    np.testing.assert_allclose(ep.detach().numpy(), [[0.4, 0.3]], rtol=1e-5)
    np.testing.assert_allclose(mp.detach().numpy(), ref.numpy(), rtol=1e-5)


SEQUENCES = {
    "falling": [5.0, 4.0, 3.0, 2.0, 1.0, 0.5, 0.25],
    "plateau": [3.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
    "below_threshold": [1.0, 0.99995, 0.9999, 0.99989, 0.99988, 0.99987, 0.99986, 0.99985],
    "noisy": [10.0, 9.0, 9.5, 9.2, 8.999, 9.1, 9.3, 9.4, 8.0, 8.5, 8.6, 8.7, 8.8],
}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_plateau_and_early_stopping_match_jax(seq):
    metrics = SEQUENCES[seq]
    jp, tp = JaxPlateau(lr=1e-3, factor=0.3, patience=2, min_lr=2e-4), \
        ReduceLROnPlateau(lr=1e-3, factor=0.3, patience=2, min_lr=2e-4)
    je, te = JaxEarlyStopping(patience=3), EarlyStopping(patience=3)
    j_lrs, t_lrs, j_stop, t_stop = [], [], None, None
    for epoch, m in enumerate(metrics):
        j_lrs.append(jp.step(m))
        t_lrs.append(tp.step(m))
        if je.step(m) and j_stop is None:
            j_stop = epoch
        if te.step(m) and t_stop is None:
            t_stop = epoch
    assert t_lrs == j_lrs
    assert t_stop == j_stop
    assert (tp.best, tp.num_bad_epochs, te.best, te.wait) == (jp.best, jp.num_bad_epochs, je.best, je.wait)


def test_plateau_never_raises_an_lr_below_min_lr():
    p = ReduceLROnPlateau(lr=1e-5, factor=0.2, patience=0, min_lr=5e-5)
    assert [p.step(1.0) for _ in range(4)] == [float(np.float32(1e-5))] * 4
