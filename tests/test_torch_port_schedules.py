"""The port's epoch schedules, device controllers and optimizer options
against the JAX package.

  * ``cosine_schedule``, ``exponential_schedule``, ``beta_warmup_schedule``
    against JAX's over epochs 0..N, in exact f32, from a Python int and
    from an int32 tensor epoch (how the chunk program calls them);
  * the chunk program's controller step (``step_controllers``), fed a
    scripted monitor sequence, against JAX's host ``ReduceLROnPlateau``
    and ``EarlyStopping``, whose in-graph twins are bit-identical to them
    (``tests/test_chunked_fit.py``): the same lr at every epoch, the same
    best, bad-epoch count, wait and stop epoch, exactly;
  * ``RiemannianAdam(moment_dtype="bfloat16")`` and ``ema_decay`` over
    five injected-gradient steps against JAX's ``riemannian_adam``:
    parameters and EMA rtol 1e-6 (atol 1e-7); bf16 moments within one
    bf16 ulp of the stored value (the two f32 computations may round to
    neighbouring bf16 values);
  * the Trainer's composition checks raise as JAX's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperbolic_vae_tpu.manifolds import PoincareBall as JaxBall
from hyperbolic_vae_tpu.optim import EarlyStopping as JaxES
from hyperbolic_vae_tpu.optim import ReduceLROnPlateau as JaxPL
from hyperbolic_vae_tpu.optim import riemannian_adam
from hyperbolic_vae_tpu.optim import schedules as jax_sched
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.nn import ManifoldParameter
from hyperbolic_vae_tpu_torch.ops import make_fused_loss_fn, make_fused_train_step
from hyperbolic_vae_tpu_torch.optim import (
    RiemannianAdam,
    beta_warmup_schedule,
    cosine_schedule,
    exponential_schedule,
)
from hyperbolic_vae_tpu_torch.train import Trainer
from hyperbolic_vae_tpu_torch.train.chunk_program import ControllerConfig, init_ctrl, step_controllers

SCHEDULES = [
    ("cosine", dict(base_lr=1e-3, total_epochs=10, warmup_epochs=2, min_lr=1e-5)),
    ("cosine", dict(base_lr=3e-3, total_epochs=7)),
    ("cosine", dict(base_lr=1e-3, total_epochs=3, warmup_epochs=5, min_lr=2e-4)),
    ("exponential", dict(base_lr=1e-3, gamma=0.5, min_lr=1e-4)),
    ("exponential", dict(base_lr=2e-3, gamma=0.93, warmup_epochs=3)),
    ("beta_warmup", dict(beta_end=1.0, warmup_epochs=4)),
    ("beta_warmup", dict(beta_end=0.7, warmup_epochs=5, beta_start=0.1)),
    ("beta_warmup", dict(beta_end=2.0, warmup_epochs=0)),
]
PORT = {"cosine": cosine_schedule, "exponential": exponential_schedule,
        "beta_warmup": beta_warmup_schedule}


@pytest.mark.parametrize("kind,kw", SCHEDULES, ids=[f"{k}{i}" for i, (k, _) in enumerate(SCHEDULES)])
def test_schedule_equals_jax_in_f32(kind, kw):
    want = getattr(jax_sched, f"{kind}_schedule")(**kw)
    got = PORT[kind](**kw)
    for e in range(14):
        w = np.float32(want(e))
        a = got(e)
        b = got(torch.tensor(e, dtype=torch.int32))
        assert a.dtype == b.dtype == torch.float32 and a.shape == ()
        assert float(a) == float(w) == float(b), (e, float(a), float(w), float(b))


def _jax_controllers(seq, lr, factor, patience, min_lr, es_patience):
    pl, es = JaxPL(lr=lr, factor=factor, patience=patience, min_lr=min_lr), JaxES(patience=es_patience)
    rows = []
    for mon in seq:
        used = pl.lr
        stopped = False
        if np.isfinite(mon):
            pl.step(float(mon))
            stopped = es.step(float(mon))
        rows.append((used, float(np.float32(pl.best)), pl.num_bad_epochs,
                     float(np.float32(es.best)), es.wait))
        if stopped:
            break
    return rows


class _Cfg:
    def __init__(self, lr, factor, patience, min_lr, es_patience):
        self._plateau_cfg = dict(lr=lr, factor=factor, patience=patience, min_lr=min_lr)
        self.plateau = JaxPL(lr=lr, factor=factor, patience=patience, min_lr=min_lr)
        self._early_patience = es_patience
        self.early_stopping = JaxES(patience=es_patience)


@pytest.mark.parametrize("case", [
    # plateaus, a NaN epoch, drops floored at min_lr, a stop
    dict(seq=[5.0, 4.0, 4.0, 3.9999, np.nan, 4.5, 4.2, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
         lr=1e-3, factor=0.2, patience=1, min_lr=5e-5, es_patience=6),
    # an lr below min_lr is never raised; patience 0 trips every flat epoch
    dict(seq=[2.0, 2.0, 2.0, 1.5, 1.5, 1.49995, 1.4, 1.4, 1.4],
         lr=1e-5, factor=0.5, patience=0, min_lr=5e-5, es_patience=3),
    # the relative threshold: improvements below 1e-4 relative are not improvements
    dict(seq=[-900.0, -900.05, -900.2, -900.21, -900.3, -900.31, -900.32, -900.33],
         lr=1e-3, factor=0.2, patience=2, min_lr=1e-8, es_patience=4),
], ids=["plateaus_nan_floor_stop", "below_min_lr", "threshold"])
def test_device_controllers_equal_jax(case):
    seq = [float(np.float32(m)) for m in case.pop("seq")]
    cfg = _Cfg(**case)
    want = _jax_controllers(seq, **case)
    ctrl = init_ctrl(cfg, 0, "cpu")
    ccfg = ControllerConfig.of(cfg)
    got = []
    for mon in seq:
        used = float(ctrl["pl_lr"])
        active = ~ctrl["stopped"]
        step_controllers(ctrl, torch.tensor(mon, dtype=torch.float32), active, ccfg)
        got.append((used, float(ctrl["pl_best"]), int(ctrl["pl_bad"]), float(ctrl["es_best"]),
                    int(ctrl["es_wait"])))
        if bool(ctrl["stopped"]):
            break
    assert got == want
    assert int(ctrl["epoch"]) == len(want)
    finite = [m for m in seq[:len(want)] if np.isfinite(m)]
    assert float(ctrl["best_val"]) == float(np.float32(min(finite)))
    # after a stop nothing moves, and the epoch counter freezes
    if bool(ctrl["stopped"]):
        before = {k: v.clone() for k, v in ctrl.items()}
        step_controllers(ctrl, torch.tensor(-1e9), ~ctrl["stopped"], ccfg)
        assert all(torch.equal(before[k], ctrl[k]) for k in ctrl)


def test_moment_dtype_bf16_and_ema_equal_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(16, 2))
    pts = 0.7 * pts / np.linalg.norm(pts, axis=-1, keepdims=True) * rng.uniform(0.2, 1.0, (16, 1))
    w = rng.normal(size=(8, 5))
    pts, w = pts.astype(np.float32), w.astype(np.float32)
    grads = [(rng.normal(size=pts.shape).astype(np.float32), rng.normal(size=w.shape).astype(np.float32))
             for _ in range(5)]
    opt = riemannian_adam(learning_rate=1e-2, ball=JaxBall(1.0), moment_dtype="bfloat16",
                          ema_decay=0.9)
    params = {"mp_points": jnp.asarray(pts), "w": jnp.asarray(w)}
    state = opt.init(params)
    upd_fn = jax.jit(opt.update)
    for gp, gw in grads:
        upd, state = upd_fn({"mp_points": jnp.asarray(gp), "w": jnp.asarray(gw)}, state, params)
        params = optax.apply_updates(params, upd)
    p = ManifoldParameter(torch.from_numpy(pts.copy()))
    q = torch.nn.Parameter(torch.from_numpy(w.copy()))
    topt = RiemannianAdam([p, q], lr=1e-2, ball=PoincareBall(1.0), moment_dtype="bfloat16",
                          ema_decay=0.9)
    for gp, gw in grads:
        p.grad, q.grad = torch.from_numpy(gp), torch.from_numpy(gw)
        topt.step()
    assert int(topt.count) == 5
    ema = topt.ema_params()
    for t, key in ((p, "mp_points"), (q, "w")):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(params[key]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ema[t].numpy(), np.asarray(state.ema[key]), rtol=1e-6, atol=1e-7)
        assert ema[t].dtype == torch.float32
        for mine, theirs in ((topt.state[t]["exp_avg"], state.exp_avg[key]),
                             (topt.state[t]["exp_avg_sq"], state.exp_avg_sq[key])):
            assert mine.dtype == torch.bfloat16 and theirs.dtype == jnp.bfloat16
            a = mine.float().numpy()
            b = np.asarray(theirs.astype(jnp.float32))
            # one bf16 ulp (8 significant bits) of the stored value
            ulp = np.where(b != 0, 2.0 ** (np.floor(np.log2(np.abs(b) + (b == 0))) - 7), 0.0)
            assert np.all(np.abs(a - b) <= ulp), float(np.abs(a - b).max())
    # the masked step keeps the EMA too
    before = {t: e.clone() for t, e in ema.items()}
    p.grad, q.grad = torch.full_like(p, float("nan")), torch.zeros_like(q)
    topt.step(ok=torch.tensor(False))
    assert all(torch.equal(before[t], topt.ema_params()[t]) for t in (p, q))
    with pytest.raises(ValueError, match="ema"):
        RiemannianAdam([torch.nn.Parameter(torch.zeros(2))]).ema_params()


def _model():
    return GyroplaneVAE(generator=torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("bad,match", [
    (lambda m: dict(ema_decay=0.99, train_step_fn=make_fused_train_step(m)), "ema_decay"),
    (lambda m: dict(moment_dtype="bfloat16", train_step_fn=make_fused_train_step(m)), "moment_dtype"),
    (lambda m: dict(beta_schedule=beta_warmup_schedule(1.0, 3), loss_fn=make_fused_loss_fn(m)),
     "beta_schedule"),
    (lambda m: dict(beta_schedule=beta_warmup_schedule(1.0, 3), train_step_fn=make_fused_train_step(m)),
     "beta_schedule"),
    (lambda m: dict(epochs_per_dispatch=0), "epochs_per_dispatch"),
], ids=["ema+train_step_fn", "moment_dtype+train_step_fn", "beta+loss_fn", "beta+train_step_fn",
        "k0"])
def test_composition_checks_raise(bad, match):
    m = _model()
    with pytest.raises(ValueError, match=match):
        Trainer(m, device="cpu", **bad(m))


def test_beta_schedule_needs_a_beta():
    class NoBeta(torch.nn.Module):
        device = torch.device("cpu")

    with pytest.raises(ValueError, match="beta attribute"):
        Trainer(NoBeta(), device="cpu", beta_schedule=beta_warmup_schedule(1.0, 2))
