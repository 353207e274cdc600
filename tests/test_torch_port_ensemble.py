"""The port's sweeps: ``fit_ensemble``, ``fit_lane_sweep`` and
``evaluate_lanes`` (``train/ensemble.py``).

Ports of ``tests/test_ensemble.py``'s contracts: every lane is exactly
what a sequential ``fit`` of that lane gives, bit for bit, across lr drops
and early stops inside chunks (K = 3), for seed ensembles, for
curvature x beta x lr lanes (JAX holds those to 2e-4: it traces the
curvature; each of the port's lanes is a concrete model) and for K3-path
lanes; EMA; per-seed and per-lane metric files; the guards, with JAX's
message fragments; the memory preflight. Against JAX: three lanes' models,
given JAX's lane parameters and the same eps, give JAX's
``jax.vmap``-over-lanes loss with traced curvature, and one Riemannian
Adam step each. Tiny data (96 train rows, batch 32, 40 val rows) on the
CPU, where the pieces run eagerly.

Tests marked ``cuda`` run sweeps on a card (CUDA graphs, a stream a lane):
graphed against eager, S streams against one, and the launch counts. JAX
is imported only inside the tests that compare with it, so that the card's
machine (no JAX) runs the ``cuda`` ones with ``--noconftest``.
"""

import json

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.data import ArrayDataModule, synthetic_mnist_arrays
from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.ops import launch_counters, make_fused_loss_fn, make_fused_train_step
from hyperbolic_vae_tpu_torch.optim import RiemannianAdam, beta_warmup_schedule, cosine_schedule
from hyperbolic_vae_tpu_torch.train import Trainer
from hyperbolic_vae_tpu_torch.train.cuda_graph import run_eagerly
from hyperbolic_vae_tpu_torch.train.ensemble import evaluate_lanes
from hyperbolic_vae_tpu_torch.train.factories import make_trainer_hyperbolic
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

SEEDS = [42, 7, 3]
LANES = [
    {"seed": 42, "manifold_curvature": 0.5, "beta": 1.0, "lr": 1e-3},
    {"seed": 7, "manifold_curvature": 0.5, "beta": 3.0, "lr": 1e-3},
    {"seed": 42, "manifold_curvature": 1.4, "beta": 1.0, "lr": 3e-3},
]


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny matrix products: one intra-op thread runs them faster and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dm(n_train: int = 96, n_val: int = 40, batch: int = 32) -> ArrayDataModule:
    x, y, xt, yt = synthetic_mnist_arrays(n_train + n_val, 40, seed=3)
    return ArrayDataModule(x[:n_train], y[:n_train], x[n_train:], y[n_train:], xt, yt,
                           batch_size=batch)


def _hp_model(hp, device="cpu"):
    return GyroplaneVAE(latent_dim=2, manifold_curvature=hp["manifold_curvature"],
                        beta=hp["beta"], device=device)


def _same(a, b) -> None:
    """Two TrainResults bit for bit: history, best, params, best params, EMA."""
    assert a.epochs_run == b.epochs_run and len(a.history) == len(b.history)
    for ha, hb in zip(a.history, b.history):
        assert sorted(ha) == sorted(hb)
        for key in ha:
            assert np.array_equal(ha[key], hb[key], equal_nan=True), (ha["epoch"], key)
    assert a.best_metric == b.best_metric
    for d in ("params", "best_params", "ema_params"):
        da, db = getattr(a, d), getattr(b, d)
        assert (da is None) == (db is None)
        for name in da or {}:
            assert torch.equal(da[name], db[name]), (d, name)


def _sequential(make_trainer, seed, **fit_kw):
    t = make_trainer(seed)
    return t.fit(_dm(), params=t.init_params(seed), **fit_kw)


# "drop": the plateau cuts lr each lane's own way and one lane stops
# inside a chunk; "stop": lr 0, so the monitor moves only with the eval
# draws and the lanes stop at different epochs
CASES = {"drop": dict(lr=5e-2, plateau_patience=0, early_stopping_patience=3),
         "stop": dict(lr=0.0, plateau_patience=1, early_stopping_patience=2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ensemble_matches_sequential(case):
    kw = dict(CASES[case], max_epochs=12, epochs_per_dispatch=3, check_finite=False, device="cpu")

    def make(seed):
        return Trainer(GyroplaneVAE(device="cpu"), seed=seed, **kw)

    ens = make(0).fit_ensemble(_dm(), SEEDS)
    assert len(ens) == len(SEEDS)
    for seed, r in zip(SEEDS, ens):
        _same(_sequential(make, seed), r)
        assert r.samples_per_sec > 0 and not r.interrupted
    runs = [r.epochs_run for r in ens]
    if case == "drop":
        assert all(len({h["lr"] for h in r.history}) > 1 for r in ens)
        assert any(e % 3 for e in runs)
    else:
        assert len(set(runs)) > 1 and any(e % 3 for e in runs)


def test_lane_sweep_matches_sequential():
    """Curvature x beta x lr lanes = each lane's own fit, bit for bit (JAX:
    rtol 2e-4, traced curvature)."""
    kw = dict(max_epochs=4, epochs_per_dispatch=2, early_stopping_patience=None,
              plateau_patience=50, check_finite=False, device="cpu")
    sweep_tr = Trainer(_hp_model(LANES[0]), hp_model_fn=_hp_model, **kw)
    sweep = sweep_tr.fit_lane_sweep(_dm(), LANES)
    assert sweep[0].samples_per_sec > 0
    for lane, r in zip(LANES, sweep):
        def make(seed, lane=lane):
            return Trainer(_hp_model(lane), lr=lane["lr"], seed=seed, **kw)

        _same(_sequential(make, lane["seed"]), r)
    # the lanes differ from each other: curvature, beta and lr reached them
    assert len({r.best_metric for r in sweep}) == len(LANES)


def test_k3_path_lanes_match_sequential():
    """Seed lanes on the K3 path (``train_step_fn``; its plain version on
    the CPU) = sequential fits."""
    kw = dict(max_epochs=3, epochs_per_dispatch=3, early_stopping_patience=None,
              check_finite=False, device="cpu")

    def make(seed):
        m = GyroplaneVAE(device="cpu")
        return Trainer(m, seed=seed, loss_fn=make_fused_loss_fn(m),
                       train_step_fn=make_fused_train_step(m), **kw)

    ens = make(0).fit_ensemble(_dm(), SEEDS[:2])
    for seed, r in zip(SEEDS[:2], ens):
        _same(_sequential(make, seed), r)


def test_ensemble_ema_matches_sequential():
    kw = dict(max_epochs=3, epochs_per_dispatch=3, early_stopping_patience=None,
              check_finite=False, ema_decay=0.9, device="cpu")

    def make(seed):
        return Trainer(GyroplaneVAE(device="cpu"), seed=seed, **kw)

    ens = make(0).fit_ensemble(_dm(), SEEDS[:2])
    for seed, r in zip(SEEDS[:2], ens):
        assert r.ema_params is not None
        _same(_sequential(make, seed), r)


def test_ensemble_writes_per_seed_and_per_lane_metrics(tmp_path):
    kw = dict(max_epochs=2, epochs_per_dispatch=2, early_stopping_patience=None,
              check_finite=False, device="cpu")
    t = Trainer(GyroplaneVAE(device="cpu"), log_dir=str(tmp_path / "seeds"), **kw)
    for seed, r in zip([5, 6], t.fit_ensemble(_dm(), [5, 6])):
        rows = [json.loads(line) for line in
                (tmp_path / "seeds" / f"seed_{seed}" / "metrics.jsonl").read_text().splitlines()]
        assert len(rows) == r.epochs_run
        assert [row["val/loss_total"] for row in rows] == [h["val/loss_total"] for h in r.history]
    lanes = [{"manifold_curvature": 0.5, "beta": 1.0}, {"manifold_curvature": 0.5, "beta": 3.0}]
    t = Trainer(_hp_model(lanes[0]), hp_model_fn=_hp_model, log_dir=str(tmp_path / "grid"), **kw)
    for i, r in enumerate(t.fit_lane_sweep(_dm(), lanes)):
        rows = (tmp_path / "grid" / f"lane_{i}" / "metrics.jsonl").read_text().splitlines()
        assert [json.loads(line)["val/loss_total"] for line in rows] == [
            h["val/loss_total"] for h in r.history]


def test_single_dispatch_sweep_reports_throughput():
    """max_epochs <= K: the sweep is one chunk, timed by a replay from its
    first state, which then leaves the result as it was."""
    kw = dict(max_epochs=3, early_stopping_patience=None, check_finite=False, device="cpu")
    t = Trainer(GyroplaneVAE(device="cpu"), epochs_per_dispatch=8, **kw)
    one = t.fit_ensemble(_dm(), [0, 1])
    assert all(r.epochs_run == 3 for r in one) and one[0].samples_per_sec > 0
    two = Trainer(GyroplaneVAE(device="cpu"), epochs_per_dispatch=1, **kw).fit_ensemble(
        _dm(), [0, 1])
    for a, b in zip(one, two):
        _same(a, b)


def test_hp_trainer_guards():
    rep = _hp_model(LANES[0])
    tr = Trainer(rep, hp_model_fn=_hp_model, max_epochs=2, check_finite=False, device="cpu")
    with pytest.raises(ValueError, match="fit_lane_sweep"):
        tr.fit(_dm())
    with pytest.raises(ValueError, match="lane_hparams"):
        tr.fit_ensemble(_dm(), [0, 1])
    with pytest.raises(ValueError, match="same hparam keys"):
        tr.fit_lane_sweep(_dm(), [{"manifold_curvature": 1.0, "beta": 1.0},
                                  {"manifold_curvature": 1.0}])
    plain = Trainer(GyroplaneVAE(device="cpu"), max_epochs=2, check_finite=False, device="cpu")
    with pytest.raises(ValueError, match="hp_model_fn"):
        plain.fit_lane_sweep(_dm(), [{"manifold_curvature": 1.0}])
    with pytest.raises(ValueError, match="hp_model_fn"):
        evaluate_lanes(plain, _dm(), [], [])
    sched = Trainer(rep, hp_model_fn=_hp_model, lr_schedule=cosine_schedule(1e-3, 2),
                    device="cpu")
    with pytest.raises(ValueError, match="per-lane lr"):
        sched.fit_lane_sweep(_dm(), [dict(LANES[0])])
    with pytest.raises(ValueError, match="loss_fn/train_step_fn"):
        Trainer(rep, hp_model_fn=_hp_model, loss_fn=make_fused_loss_fn(rep), device="cpu")
    with pytest.raises(ValueError, match="requires hp_model_fn"):
        Trainer(rep, hp_schedule=lambda e: {"beta": e}, device="cpu")
    with pytest.raises(ValueError, match="sugar"):
        Trainer(rep, hp_model_fn=_hp_model, beta_schedule=beta_warmup_schedule(1.0, 2),
                device="cpu")


def test_ensemble_rejects_unsupported_modes():
    t = Trainer(GyroplaneVAE(device="cpu"), max_epochs=2, callbacks=[object()], device="cpu")
    with pytest.raises(ValueError, match="callbacks"):
        t.fit_ensemble(_dm(), [0, 1])
    t = Trainer(GyroplaneVAE(device="cpu"), max_epochs=2, device="cpu")

    class _DataMesh:  # a mesh with a data axis where a seed axis belongs
        shape = {"data": 1, "model": 1}

    with pytest.raises(ValueError, match="seed_mesh needs a 'seed' axis"):
        t.fit_ensemble(_dm(), [0, 1], seed_mesh=_DataMesh())
    t.mesh = _DataMesh()
    with pytest.raises(ValueError, match="does not compose with a mesh"):
        t.fit_ensemble(_dm(), [0, 1])
    t.mesh = None
    t.monitor = "test/loss_total"
    with pytest.raises(ValueError, match="val/ or train/ monitor"):
        t.fit_ensemble(_dm(), [0, 1])


def test_scheduled_key_must_be_a_tensor_the_model_reads():
    """A schedule sets only keys the model reads at every call (beta);
    the curvature is baked in at build time, so scheduling it raises and
    names the key."""
    rep = _hp_model(LANES[0])
    with pytest.raises(ValueError, match="'manifold_curvature' is baked into"):
        Trainer(rep, hp_model_fn=_hp_model,
                hp_schedule=lambda e: {"manifold_curvature": e}, device="cpu")


def test_hp_schedule_lanes_match_beta_schedule_fits():
    """A generic ``hp_schedule`` of beta over curvature lanes overrides
    each lane's beta per epoch: each lane = the sequential
    ``beta_schedule`` fit of its model; ``evaluate_lanes`` takes the
    schedule's end, as that fit's ``evaluate``."""
    warm = beta_warmup_schedule(2.0, 3)
    kw = dict(max_epochs=3, epochs_per_dispatch=3, early_stopping_patience=None,
              check_finite=False, device="cpu")
    lanes = [{"manifold_curvature": 0.5, "beta": 1.0}, {"manifold_curvature": 1.4, "beta": 1.0}]
    tr = Trainer(_hp_model(lanes[0]), hp_model_fn=_hp_model,
                 hp_schedule=lambda e: {"beta": warm(e)}, **kw)
    sweep = tr.fit_lane_sweep(_dm(), lanes)
    tests = evaluate_lanes(tr, _dm(), sweep, lanes, "test")
    for lane, r, test in zip(lanes, sweep, tests):
        t = Trainer(_hp_model(lane), beta_schedule=warm, **kw)
        seq = t.fit(_dm(), params=t.init_params(42))
        _same(seq, r)
        assert t.model.beta == 1.0  # the float is back after the fit
        assert test == t.evaluate(_dm(), r.best_params, "test")


def test_evaluate_lanes_is_each_lanes_evaluate():
    kw = dict(max_epochs=2, epochs_per_dispatch=2, early_stopping_patience=None,
              check_finite=False, device="cpu")
    tr = Trainer(_hp_model(LANES[0]), hp_model_fn=_hp_model, **kw)
    sweep = tr.fit_lane_sweep(_dm(), LANES)
    tests = evaluate_lanes(tr, _dm(), sweep, LANES, "test")
    for lane, r, test in zip(LANES, sweep, tests):
        direct = Trainer(_hp_model(lane), **kw).evaluate(_dm(), r.best_params, "test")
        assert test == direct and set(test) >= {"test/loss_total"}


def test_ensemble_hbm_preflight_raises():
    """The preflight fails before staging, naming the port's remedies (the
    96-row, 3 KiB-a-row train split alone exceeds 2 MiB), and passes at
    16 GiB."""
    t = Trainer(GyroplaneVAE(device="cpu"), max_epochs=2, check_finite=False,
                hbm_limit_bytes=2 * 2 ** 20, device="cpu")
    dm = _dm(n_train=1024)
    with pytest.raises(RuntimeError, match="grad_accum_steps"):
        t.fit_ensemble(dm, [0, 1])
    with pytest.raises(RuntimeError, match="CUDA memory preflight"):
        t.fit(dm)
    t = Trainer(GyroplaneVAE(device="cpu"), max_epochs=2, check_finite=False,
                hbm_limit_bytes=16 * 2 ** 30, device="cpu")
    assert len(t.fit_ensemble(_dm(), [0, 1])) == 2


def test_profile_dir_traces_the_second_chunk(tmp_path):
    t = Trainer(GyroplaneVAE(device="cpu"), max_epochs=2, early_stopping_patience=None,
                check_finite=False, profile_dir=str(tmp_path / "prof"), device="cpu")
    t.fit(_dm())
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]


def test_make_trainer_hyperbolic_matches_jax():
    """The reference's canonical MNIST configuration, as JAX's factory."""
    from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxVAE
    from hyperbolic_vae_tpu.train import factories as jax_factories

    jt = jax_factories.make_trainer_hyperbolic(JaxVAE(), curvature=1.4)
    t = make_trainer_hyperbolic(GyroplaneVAE(manifold_curvature=1.4, device="cpu"),
                                curvature=1.4, device="cpu")
    assert (t.max_epochs, t.monitor, t._early_patience) == (jt.max_epochs, jt.monitor,
                                                            jt._early_patience)
    assert t._plateau_cfg == jt._plateau_cfg
    assert [type(cb).__name__ for cb in t.callbacks] == [type(cb).__name__ for cb in jt.callbacks]
    for a, b in zip(t.callbacks, jt.callbacks):
        assert a.every_n_epochs == b.every_n_epochs
        assert getattr(a, "range_xy", None) == getattr(b, "range_xy", None)
    assert t.callbacks[1].range_xy == 1.4 ** -0.5


# ---------------------------------------------------------------------- #
# Against JAX: the lanes' models and their first Riemannian Adam step.

RTOL = dict(rtol=1e-5, atol=1e-6)  # the loss and the step taken from JAX's gradient
# the gradients, per tensor against its largest element: f32 reduction
# orders differ (JAX's traced-c gradient and its concrete-c one differ by
# up to ~2e-6 of that scale themselves)
GRAD_SCALE_TOL = 1e-5
JAX_LANES = [(0.5, 1.0), (1.4, 3.0), (0.5, 3.0)]  # (curvature, beta)


def _jax_lane_step(params, c, beta, x, eps):
    """One lane under ``jax.vmap`` with traced c and beta: the loss's
    metrics, its gradient, and the parameters after one Riemannian Adam
    step on the lane's ball."""
    import jax
    import optax

    from hyperbolic_vae_tpu.manifolds import PoincareBall as JaxBall
    from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxVAE
    from hyperbolic_vae_tpu.optim import riemannian_adam

    model = JaxVAE(latent_dim=2, manifold_curvature=c, beta=beta)

    def loss(p):
        m = model.apply({"params": p}, x, eps, method="loss_from_eps")
        return m["loss_total"], m

    (_, metrics), grads = jax.value_and_grad(loss, has_aux=True)(params)
    opt = riemannian_adam(learning_rate=1e-3, ball=JaxBall(c))
    upd, _ = opt.update(grads, opt.init(params), params)
    return metrics, grads, optax.apply_updates(params, upd)


def test_lane_models_match_jax_vmapped_loss_and_step():
    """Each lane's port model (``hp_model_fn``) with JAX's lane parameters
    and eps: JAX's vmapped loss (traced curvature and beta) within 1e-5,
    its gradient within 1e-5 of each tensor's largest element (at step
    one Adam divides a gradient by its own size, so a last-bit difference
    would move a near-zero component's step by a few % of lr: the step is
    taken from JAX's gradient), and the step on the lane's ball within
    1e-5."""
    import jax
    import jax.numpy as jnp

    from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxVAE

    rng = np.random.default_rng(11)
    x = rng.uniform(size=(16, 28, 28, 1)).astype(np.float32)
    eps = rng.normal(size=(16, 2)).astype(np.float32)
    per_lane = []
    for i, (c, beta) in enumerate(JAX_LANES):
        jm = JaxVAE(latent_dim=2, manifold_curvature=c, beta=beta)
        keys = {"params": jax.random.PRNGKey(i), "sample": jax.random.PRNGKey(10 + i)}
        per_lane.append(jm.init(keys, jnp.asarray(x[:2]))["params"])
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *per_lane)
    cs = jnp.asarray([c for c, _ in JAX_LANES], jnp.float32)
    betas = jnp.asarray([b for _, b in JAX_LANES], jnp.float32)
    metrics, grads, stepped = jax.jit(jax.vmap(_jax_lane_step, in_axes=(0, 0, 0, None, None)))(
        stacked, cs, betas, jnp.asarray(x), jnp.asarray(eps))

    def lane_of(tree, i):
        return state_dict_from_jax_params(jax.tree.map(lambda a: np.asarray(a[i]), tree))

    for i, (c, beta) in enumerate(JAX_LANES):
        model = _hp_model({"manifold_curvature": c, "beta": beta})
        model.load_state_dict(lane_of(stacked, i))
        m = model.loss_from_eps(torch.from_numpy(x), torch.from_numpy(eps))
        for key, v in m.items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(metrics[key][i]),
                                       err_msg=f"lane {i} {key}", **RTOL)
        m["loss_total"].backward()
        jgrad, want = lane_of(grads, i), lane_of(stepped, i)
        opt = RiemannianAdam(model.parameters(), lr=1e-3, ball=model.ball)
        for name, p in model.named_parameters():
            scale = float(jgrad[name].abs().max())
            assert float((p.grad - jgrad[name]).abs().max()) <= GRAD_SCALE_TOL * scale, (i, name)
            p.grad = jgrad[name].clone()
        opt.step()
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       err_msg=f"lane {i} {name}", **RTOL)


# ---------------------------------------------------------------------- #
# On the card: lanes as CUDA graphs, each on its own stream.


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _card_sweep(dev, path="default", streams=True, seeds=(42, 7, 3), max_epochs=3):
    m = GyroplaneVAE(device=dev)
    kw = {}
    if path == "k3":
        kw = dict(loss_fn=make_fused_loss_fn(m), train_step_fn=make_fused_train_step(m))
    t = Trainer(m, max_epochs=max_epochs, epochs_per_dispatch=3, early_stopping_patience=None,
                monitor="train/skipped_steps", plateau_patience=0, plateau_factor=0.5,
                check_finite=False, device=dev, **kw)
    t._lane_streams = streams
    return t.fit_ensemble(_dm(), list(seeds))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "k3"])
def test_graphed_sweep_equals_eager_on_card(path):
    dev = _card()
    graphed = _card_sweep(dev, path)
    with run_eagerly():
        eager = _card_sweep(dev, path)
    for a, b in zip(graphed, eager):
        _same(a, b)
    # the plateau (patience 0 on a constant monitor) halves lr after epoch 1
    assert len({h["lr"] for h in graphed[0].history}) == 2


@pytest.mark.cuda
def test_lane_streams_equal_one_stream_with_counts():
    """A stream a lane against one stream: the same bits; launches are
    lanes x epochs x (steps + val batches) of K1 on the default path, and
    lanes x epochs x steps of the Riemannian Adam pair."""
    dev = _card()
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    many = _card_sweep(dev, streams=True)
    counts = {k: c.count for k, c in counters.items()}
    one = _card_sweep(dev, streams=False)
    for a, b in zip(many, one):
        _same(a, b)
    assert counts == {"gyroplane_distances": 3 * 3 * (3 + 2), "flagship_fused": 0,
                      "flagship_train": 0, "riemannian_adam": 3 * 3 * 3}
