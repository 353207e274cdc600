"""The port's fused training step (K3) against the JAX package.

``flagship_grads_torch`` (the backward derived by hand) is held to
autograd of ``flagship_forward_torch`` and to ``jax.grad`` of the JAX
mirror; ``flagship_train_step_torch`` (the plain version of the whole
step) to JAX's ``make_fused_train_step`` (its Pallas kernel in interpret
mode, as JAX's own tests run it on the CPU) and to the optax reference
step; ``make_fused_train_step`` to the Trainer's ``train_step_fn`` hook.
JAX parameters come over with ``state_dict_from_jax_params``, moments with
``optimizer_state_from_jax``; inputs and draws come from numpy with a seed.
Tolerances:
  * hand-derived vs autograd gradients, float64: 1e-9 of each tensor's
    largest gradient (the same formulas; only the order of sums differs);
  * vs ``jax.grad`` in f32: rtol 1e-3, atol 3e-5 of each tensor's largest
    gradient (the K2 tests' gradient tolerance: two f32 backward passes in
    different summation orders);
  * one step vs JAX's K3: params and both moments rtol 5e-3, atol 3e-4,
    loss rtol 2e-4 (``tests/test_fused_train_step.py``), count equal. The
    transport of the points' exp_avg is also compared in float64 near the
    boundary, where f32 amplifies last-bit differences (rtol 1e-9);
  * five steps vs the optax reference: JAX's trajectory tolerances, loss
    rtol 5e-3, points rtol 2e-2 atol 1e-3;
  * a K3 fit vs a fit with the fused loss and RiemannianAdam (same seed,
    same draws): rtol 1e-3 on every history value.
The kernel runs only on a CUDA card (tests marked ``cuda``; on a machine
without JAX run them with ``python -m pytest --noconftest -m cuda
tests/test_torch_port_fused_train_step.py``).
"""

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff

CONFIGS = {
    "default": dict(),
    "nondefault": dict(latent_dim=3, manifold_curvature=1.4, beta=0.5, prior_scale=2.0),
    "boundary": dict(),  # posterior means pushed to the projection margin
}
B = 16


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, the JAX model class, the JAX fused module)."""
    jax = pytest.importorskip("jax")
    from hyperbolic_vae_tpu.models import GyroplaneVAE
    from hyperbolic_vae_tpu.ops import flagship_fused

    return jax, jax.numpy, GyroplaneVAE, flagship_fused


def _setup(jx, name, n=32):
    """The JAX model and params of a configuration, the port's model with
    the same weights, a batch x (n, 28, 28, 1) with exact-0 and exact-1
    pixels and eps (n, latent)."""
    jax, jnp, JaxVAE, _ = jx
    from hyperbolic_vae_tpu_torch.interop import (
        gyroplane_vae_from_state_dict,
        state_dict_from_jax_params,
    )

    jm = JaxVAE(**CONFIGS[name])
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (n, 28, 28, 1)).astype(np.float32)
    x[:, :5] = 0.0
    x[:, -3:] = 1.0
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                              jnp.asarray(x))["params"]
    params = jax.tree.map(np.array, params)
    if name == "boundary":
        params["mu"]["kernel"] *= 30.0
        params["mu"]["bias"] += 2.0
        params["scale"]["bias"] += 3.0
    tm = gyroplane_vae_from_state_dict(
        state_dict_from_jax_params(params), device="cpu", manifold_curvature=jm.manifold_curvature,
        prior_scale=jm.prior_scale, beta=jm.beta)
    eps = rng.normal(size=(n, jm.latent_dim)).astype(np.float32)
    return jm, params, tm, x, eps


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_hand_derived_grads_match_autograd_in_float64(jx, name):
    """The backward derived by hand against autograd of the plain forward,
    both in float64; the f32 forward values equal flagship_forward_torch's
    bit for bit (the same ops)."""
    _, _, tm, x, eps = _setup(jx, name)
    cfg = ff.fused_config(tm)
    xt, et = torch.from_numpy(x), torch.from_numpy(eps)
    p64 = [p.detach().double().requires_grad_() for p in ff.params_tuple(tm)]
    auto = torch.autograd.grad(ff.flagship_forward_torch(p64, xt.double(), et.double(), **cfg)[0], p64)
    with torch.no_grad():
        hand, _ = ff.flagship_grads_torch([p.detach() for p in p64], xt.double(), et.double(), **cfg)
        _, values = ff.flagship_grads_torch(ff.params_tuple(tm), xt, et, **cfg)
        want = ff.flagship_forward_torch(ff.params_tuple(tm), xt, et, **cfg)
    assert all(torch.equal(a, b) for a, b in zip(values, want))
    for i, (a, h) in enumerate(zip(auto, hand)):
        scale = float(a.abs().max())
        assert h.shape == a.shape
        assert float((a - h).abs().max()) <= 1e-9 * scale, i


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_hand_derived_grads_match_jax_grad(jx, name):
    """f32 gradients of loss_total: the port's hand-derived backward
    against jax.grad of flagship_forward_jnp, for every parameter."""
    jax, jnp, _, jff = jx
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params

    jm, params, tm, x, eps = _setup(jx, name)
    cfg = ff.fused_config(tm)
    jg = jax.jit(jax.grad(lambda p: jff.flagship_forward_jnp(
        p, jnp.asarray(x), jnp.asarray(eps), **cfg)[0]))(jff._params_tuple(params))
    jsd = state_dict_from_jax_params(jax.tree.map(np.asarray, jff._tuple_to_params(jg)))
    with torch.no_grad():
        hand, _ = ff.flagship_grads_torch(ff.params_tuple(tm), torch.from_numpy(x),
                                          torch.from_numpy(eps), **cfg)
    named = dict(tm.named_parameters())
    by_id = {id(p): k for k, p in named.items()}
    for p, g in zip(ff.params_tuple(tm), hand):
        ref = jsd[by_id[id(p)]].numpy().reshape(g.shape)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-3, atol=3e-5 * float(np.abs(ref).max()),
                                   err_msg=by_id[id(p)])


def _jax_reference_step(jm, jt, params, opt_state, x, eps):
    """JAX's optax step on the model's loss (tests/test_fused_train_step.py)."""
    import jax
    import optax

    def loss_fn(p):
        m = jm.apply({"params": p}, x, eps, method="loss_from_eps")
        return m["loss_total"], m

    (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, new_state = jt._optimizer.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), new_state, metrics


@pytest.fixture(scope="module")
def k3_runs(jx):
    """JAX's make_fused_train_step (Pallas in interpret mode) from a state
    two optax steps in (non-zero moments, count 2): one step on a clean
    batch and one on a batch with a NaN pixel. The only JAX-K3 calls of
    this file."""
    jax, jnp, JaxVAE, jff = jx
    from hyperbolic_vae_tpu.train import Trainer as JaxTrainer

    jm = JaxVAE()
    jt = JaxTrainer(jm, max_epochs=1, early_stopping_patience=None)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (B, 28, 28, 1)).astype(np.float32)
    x[:, :3] = 0.0
    params = jt.init_params(jnp.asarray(x))
    state = jt._optimizer.init(params)
    ref_step = jax.jit(lambda p, s, e: _jax_reference_step(jm, jt, p, s, jnp.asarray(x), e))
    for _ in range(2):
        params, state, _ = ref_step(params, state, jnp.asarray(rng.normal(size=(B, 2)).astype(np.float32)))
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(key, (B, 2), jnp.float32))
    step = jax.jit(jff.make_fused_train_step(jm))  # one compile for both batches
    x_bad = x.copy()
    x_bad[2, 5, 5, 0] = np.nan
    out = {}
    for tag, xb in (("clean", x), ("nan", x_bad)):
        p1, s1, m1 = step(params, state, jnp.asarray(xb), key)
        out[tag] = (jax.tree.map(np.asarray, p1), jax.tree.map(np.asarray, s1.inner_state),
                    {k: float(v) for k, v in m1.items()}, xb.copy())
    start = (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state.inner_state))
    return start, eps, out


def _port_state(start):
    """The JAX start state in the port: the model, its params_tuple, the
    moments in that order and count."""
    from hyperbolic_vae_tpu_torch.interop import (
        gyroplane_vae_from_state_dict,
        optimizer_state_from_jax,
        state_dict_from_jax_params,
    )

    params, inner = start
    tm = gyroplane_vae_from_state_dict(state_dict_from_jax_params(params), device="cpu")
    st = optimizer_state_from_jax(inner, tm)
    pt = ff.params_tuple(tm)
    return tm, pt, [st["state"][p]["exp_avg"] for p in pt], \
        [st["state"][p]["exp_avg_sq"] for p in pt], st["count"]


def _jax_in_port_order(tm, p_tree, inner):
    """JAX params and moments as port tensors in params_tuple order."""
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params

    by_id = {id(p): k for k, p in tm.named_parameters()}
    sds = [state_dict_from_jax_params(t) for t in (p_tree, inner.exp_avg, inner.exp_avg_sq)]
    return [[sd[by_id[id(p)]] for p in ff.params_tuple(tm)] for sd in sds]


def test_plain_step_matches_jax_fused_step(k3_runs):
    start, eps, out = k3_runs
    jp, jinner, jmet, x = out["clean"]
    tm, pt, mom, vel, count = _port_state(start)
    assert count == 2
    new_p, new_m, new_v, met, new_count = ff.flagship_train_step_torch(
        pt, mom, vel, torch.from_numpy(x), torch.from_numpy(eps), lr=1e-3, count=count,
        **ff.fused_config(tm))
    assert int(new_count) == int(jinner.count) == 3
    np.testing.assert_allclose(float(met[0]), jmet["loss_total"], rtol=2e-4)
    assert float(met[3]) == jmet["skipped_steps"] == 0.0
    want = _jax_in_port_order(tm, jp, jinner)
    for got, ref, what in zip((new_p, new_m, new_v), want, ("params", "exp_avg", "exp_avg_sq")):
        for i, (a, b) in enumerate(zip(got, ref)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3, atol=3e-4, err_msg=f"{what} {i}")


def test_skipped_step_keeps_state_and_advances_count_as_jax(k3_runs):
    """A NaN pixel: JAX's K3 keeps params and moments, counts the step as
    skipped and still advances count; the port's plain step does the same,
    bit for bit."""
    start, eps, out = k3_runs
    jp, jinner, jmet, x_bad = out["nan"]
    tm, pt, mom, vel, count = _port_state(start)
    new_p, new_m, new_v, met, new_count = ff.flagship_train_step_torch(
        pt, mom, vel, torch.from_numpy(x_bad), torch.from_numpy(eps), lr=1e-3, count=count,
        **ff.fused_config(tm))
    assert jmet["skipped_steps"] == float(met[3]) == 1.0
    assert int(new_count) == int(jinner.count) == count + 1
    assert all(torch.equal(a, b) for a, b in zip((*new_p, *new_m, *new_v), (*pt, *mom, *vel)))
    want = _jax_in_port_order(tm, jp, jinner)
    assert all(torch.equal(a, b) for a, b in zip((*pt, *mom, *vel), [t for ts in want for t in ts]))


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_points_update_matches_jax_inline_in_float64_near_boundary(jx, c):
    """riemannian_adam_update_inline of the gyroplane points (retraction,
    projection, transport of exp_avg) against JAX's inline update, both in
    float64, with six of sixteen points at 0.99 of the projection radius."""
    jax, jnp, _, jff = jx
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(16, 2))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts *= np.r_[np.full(6, 0.99 * (1 - 4e-3)), np.linspace(0.1, 0.8, 10)][:, None] / np.sqrt(c)
    g, m, v = 0.1 * rng.normal(size=(16, 2)), 0.01 * rng.normal(size=(16, 2)), 1e-4 * rng.random((16, 2))
    bc1, bc2 = 1 - 0.9**4, 1 - 0.999**4
    with jax.enable_x64(True):
        want = jff._riemannian_adam_update_inline(
            *(jnp.asarray(a, jnp.float64) for a in (pts, g, m, v)), 1e-3, bc1, bc2, True, c=c)
        want = [np.asarray(a) for a in want]
    got = ff.riemannian_adam_update_inline(*(torch.tensor(a) for a in (pts, g, m, v)), 1e-3, bc1, bc2,
                                           True, c=c)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-15)


def test_five_plain_steps_track_the_optax_reference(jx):
    """Five plain K3 steps against five optax steps on the model's loss,
    with the same draws (JAX's own trajectory test and tolerances)."""
    jax, jnp, JaxVAE, _ = jx
    from hyperbolic_vae_tpu.train import Trainer as JaxTrainer

    jm = JaxVAE()
    jt = JaxTrainer(jm, max_epochs=1, early_stopping_patience=None)
    x = np.random.default_rng(0).uniform(0, 1, (B, 28, 28, 1)).astype(np.float32)
    params = jt.init_params(jnp.asarray(x))
    state = jt._optimizer.init(params)
    tm, pt, mom, vel, count = _port_state((jax.tree.map(np.asarray, params),
                                           jax.tree.map(np.asarray, state.inner_state)))
    ref_step = jax.jit(lambda p, s, e: _jax_reference_step(jm, jt, p, s, jnp.asarray(x), e))
    rng = np.random.default_rng(7)
    for _ in range(5):
        eps = rng.normal(size=(B, 2)).astype(np.float32)
        params, state, jmet = ref_step(params, state, jnp.asarray(eps))
        pt, mom, vel, met, count = ff.flagship_train_step_torch(
            pt, mom, vel, torch.from_numpy(x), torch.from_numpy(eps), lr=1e-3, count=count,
            **ff.fused_config(tm))
    assert int(count) == int(state.inner_state.count) == 5
    np.testing.assert_allclose(float(met[0]), float(jmet["loss_total"]), rtol=5e-3)
    pts_ref = np.asarray(params["gyroplanes"]["mp_points"])
    np.testing.assert_allclose(pt[ff._MP_POINTS_IDX].numpy(), pts_ref, rtol=2e-2, atol=1e-3)
    assert np.all(np.linalg.norm(pts_ref, axis=-1) < 1.0)


def _tiny_dm(n=256, batch=32):
    from hyperbolic_vae_tpu_torch.data import ArrayDataModule, synthetic_mnist_arrays

    x, y, xt, yt = synthetic_mnist_arrays(n + 40, 8, seed=3)
    return ArrayDataModule(x[:n], y[:n], x[n:], y[n:], xt, yt, batch_size=batch)


def _model(**kw):
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE

    return GyroplaneVAE(generator=torch.Generator().manual_seed(0), device="cpu", **kw)


@pytest.fixture()
def one_thread():
    """torch on one thread for the test: beside the suite's other workers,
    these fits' small ops otherwise spend most of their time in the
    oversubscribed thread pool (a two-epoch flagship fit here: ~22 s on 8
    threads under load, ~2.2 s on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_trainer_hook_runs_k3_and_matches_the_fused_loss_fit(one_thread):
    """Trainer(train_step_fn=K3, loss_fn=K2) on the CPU: the default path's
    history keys, finite values, and (same seed, same batches and draws)
    the values of a fit with the fused loss, autograd and RiemannianAdam."""
    from hyperbolic_vae_tpu_torch.train import Trainer

    dm = _tiny_dm()
    hists = []
    for k3 in (False, True):
        m = _model()
        t = Trainer(m, max_epochs=2, early_stopping_patience=None, device="cpu",
                    loss_fn=ff.make_fused_loss_fn(m),
                    train_step_fn=ff.make_fused_train_step(m) if k3 else None)
        hists.append(t.fit(dm).history)
        if k3:
            assert int(t.optimizer.count) == 2 * (256 // 32)
    default = Trainer(_model(), max_epochs=1, early_stopping_patience=None, device="cpu").fit(dm)
    assert [sorted(h) for h in hists[1]] == [sorted(default.history[0])] * 2
    for a, b in zip(*hists):
        assert all(np.isfinite(v) for v in b.values())
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert hists[1][1]["val/loss_total"] < hists[1][0]["val/loss_total"]


def test_make_fused_train_step_checks_its_arguments():
    from hyperbolic_vae_tpu_torch.optim import RiemannianAdam

    with pytest.raises(ValueError, match="flagship"):
        ff.make_fused_train_step(_model(hidden_dims=(32, 8)))
    m = _model()
    step = ff.make_fused_train_step(m)
    x = torch.rand(4, 28, 28, 1)
    for bad, match in ((dict(weight_decay=0.01), "weight"), (dict(betas=(0.8, 0.999)), "betas")):
        opt = RiemannianAdam(m.parameters(), lr=1e-3, ball=m.ball, **bad)
        with pytest.raises(ValueError, match=match):
            step(m, opt, x, torch.Generator())
    with pytest.raises(ValueError, match="RiemannianAdam"):
        step(m, torch.optim.Adam(m.parameters()), x, torch.Generator())
    opt = RiemannianAdam(m.parameters(), lr=1e-3)
    with pytest.raises(ValueError, match="ball"):
        ff.make_fused_train_step(_model(manifold_curvature=0.5))(
            _model(manifold_curvature=0.5), opt, x, torch.Generator())
    with pytest.raises(ValueError, match="CUDA"):
        ff.flagship_train_cuda(ff.params_tuple(m), *[[torch.zeros_like(p) for p in ff.params_tuple(m)]] * 2,
                               x.reshape(4, -1), torch.randn(4, 2), torch.zeros((), dtype=torch.int32),
                               lr=1e-3, **ff.fused_config(m))


@pytest.mark.parametrize("b", [1, 37, 1024])
def test_wrapper_checks_accept_the_flagship_batch(b):
    """K3's shape and shared-memory checks take 784 pixels at any batch and
    raise, before any launch, for pixels past what one block can stage (K3
    stages d loss / d logit too, so its limit is below K2's)."""
    x, eps = torch.rand(b, 784), torch.randn(b, 2)
    ff._check_shapes("k3", x, eps, 2, 784, True)
    d = 784
    while ff._rows_smem_bytes(d + 1, True) <= ff._MAX_SMEM:
        d += 1
    assert d < max(e for e in range(784, 4000) if ff._rows_smem_bytes(e, False) <= ff._MAX_SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        ff._check_shapes("k3", torch.rand(b, d + 1), eps, 2, d + 1, True)
    with pytest.raises(ValueError, match="latent_dim"):
        ff._check_shapes("k3", x, torch.randn(b, 9), 9, 784, True)


# ---------------------------------------------------------------------- #
# On the card.


def _card_case(b: int, moments: bool):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = _model()
    cfg = ff.fused_config(m)
    g = torch.Generator().manual_seed(b)
    x = torch.rand(b, 784, generator=g)
    x[:, :100] = 0.0
    eps = torch.randn(b, 2, generator=g)
    params = [p.detach().clone() for p in ff.params_tuple(m)]
    if moments:
        mom = [0.01 * torch.randn(p.shape, generator=g) for p in params]
        vel = [1e-4 * torch.rand(p.shape, generator=g) for p in params]
    else:
        mom = [torch.zeros_like(p) for p in params]
        vel = [torch.zeros_like(p) for p in params]
    cuda = [t.cuda() for t in (x, eps)], [[t.cuda() for t in ts] for ts in (params, mom, vel)]
    return cfg, cuda, 3 if moments else 0


def _run_kernel(cfg, cuda, count0, x=None):
    (xc, ec), (p, m, v) = cuda
    kp, km, kv = ([t.clone() for t in ts] for ts in (p, m, v))
    count = torch.full((), count0, dtype=torch.int32, device="cuda")
    n0 = ff.train_launches.count
    out = ff.flagship_train_cuda(kp, km, kv, xc if x is None else x, ec, count, lr=1e-3, **cfg)
    torch.cuda.synchronize()
    assert ff.train_launches.count == n0 + 1
    return out, kp, km, kv, count


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 37, 256, 1024])
def test_kernel_matches_plain_on_card(b):
    """K3 against the plain version from non-zero moments: metrics by the
    K2 tolerances, params and moments rtol 5e-3 atol 3e-4, count + 1."""
    cfg, cuda, count0 = _card_case(b, True)
    out, kp, km, kv, count = _run_kernel(cfg, cuda, count0)
    (xc, ec), (p, m, v) = cuda
    ref = ff.flagship_train_step_torch(p, m, v, xc, ec, lr=1e-3, count=count0, **cfg)
    o, r = out.double().tolist(), ref[3].double().tolist()
    assert abs(o[1] - r[1]) <= 1e-5 * abs(r[1]) and abs(o[2] - r[2]) <= 1e-4 * abs(r[2]) + 1e-5
    assert abs(o[0] - r[0]) <= 1e-5 * (abs(r[1]) + abs(r[2])) and o[3] == r[3] == 0.0
    assert int(count) == int(ref[4]) == count0 + 1
    for got, want in zip((kp, km, kv), ref[:3]):
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=5e-3, atol=3e-4)


@pytest.mark.cuda
def test_kernel_first_step_moments_are_the_plain_gradients():
    """From zero moments exp_avg = (1 - b1) g: the kernel's backward against
    the plain version's, rtol 1e-3, atol 3e-5 of each tensor's largest."""
    cfg, cuda, count0 = _card_case(256, False)
    _, _, km, _, _ = _run_kernel(cfg, cuda, count0)
    (xc, ec), (p, _, _) = cuda
    grads, _ = ff.flagship_grads_torch(p, xc, ec, **cfg)
    for i, (mk, g) in enumerate(zip(km, grads)):
        if i != ff._MP_POINTS_IDX:
            torch.testing.assert_close(mk / (1.0 - 0.9), g, rtol=1e-3, atol=3e-5 * float(g.abs().max()))


@pytest.mark.cuda
def test_kernel_skips_a_nan_batch_and_is_deterministic():
    cfg, cuda, count0 = _card_case(64, True)
    (xc, _), (p, m, v) = cuda
    x_bad = xc.clone()
    x_bad[5, 300] = float("nan")
    out, kp, km, kv, count = _run_kernel(cfg, cuda, count0, x_bad)
    assert float(out[3]) == 1.0 and int(count) == count0 + 1
    assert all(torch.equal(a, b) for a, b in zip((*kp, *km, *kv), (*p, *m, *v)))
    first, second = _run_kernel(cfg, cuda, count0), _run_kernel(cfg, cuda, count0)
    assert all(torch.equal(a, b) for a, b in zip(
        [first[0], *first[1], *first[2], *first[3]], [second[0], *second[1], *second[2], *second[3]]))
