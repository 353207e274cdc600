"""The port's training path against the JAX package: the train step, the
data module, and ``Trainer`` (fit, the finite guard, the controllers,
the hooks, evaluate).

JAX parameters are carried in with ``state_dict_from_jax_params`` and the
JAX optimizer state with ``optimizer_state_from_jax``; batches and eps
come from numpy with a seed. Tolerances:
  * one step: loss rtol 1e-5; parameters rtol 1e-4, atol 3e-5; moments
    rtol 1e-3 with atol 1e-4 of the tensor's largest entry. Adam's first step moves each element by
    lr g / (|g| + 1e-8): where |g| is within ~10x of that eps (~1e-7), the
    frameworks' last-bit gradient differences (~3e-8 there) change the
    step by a few % of lr = 1e-3; the moments carry the gradients'
    differences (two f32 backward passes in different summation orders;
    the gyroplane points' through the epilogue's cancellation);
  * five steps: rtol 5e-3, atol 3e-4 (JAX's own fused-step tolerance;
    for the moments, of the tensor's largest entry);
  * fused vs plain Trainer histories (same seed, same draws): rtol 1e-4.
"""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyperbolic_vae_tpu.data import core as jax_core
from hyperbolic_vae_tpu.data import mnist as jax_mnist
from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxVAE
from hyperbolic_vae_tpu.train import Trainer as JaxTrainer
from hyperbolic_vae_tpu_torch.data import (
    ArrayDataModule,
    load_mnist_arrays,
    make_data_module,
    split_train_val,
    synthetic_mnist_arrays,
)
from hyperbolic_vae_tpu_torch.interop import (
    gyroplane_vae_from_state_dict,
    optimizer_state_from_jax,
    state_dict_from_jax_params,
)
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.ops import make_fused_loss_fn
from hyperbolic_vae_tpu_torch.ops.flagship_fused import fused_config, fused_flagship_loss, params_tuple
from hyperbolic_vae_tpu_torch.optim import EarlyStopping, ReduceLROnPlateau, RiemannianAdam
from hyperbolic_vae_tpu_torch.train import Trainer
from hyperbolic_vae_tpu_torch.train.epoch_program import batch_indices, train_step

B = 32


@pytest.fixture(scope="module")
def jax_setup():
    jm = JaxVAE()
    jt = JaxTrainer(jm, max_epochs=1, early_stopping_patience=None)
    x = synthetic_mnist_arrays(5 * B, 1, seed=0)[0]
    params = jax.tree.map(np.asarray, jt.init_params(x, jax.random.PRNGKey(0)))
    return jm, jt, params, x


def _jax_steps(jm, jt, params, x, eps_list):
    def loss_fn(p, xb, e):
        m = jm.apply({"params": p}, xb, e, method="loss_from_eps")
        return m["loss_total"], m

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    update = jax.jit(jt._optimizer.update)
    opt_state = jt._optimizer.init(params)
    for i, eps in enumerate(eps_list):
        xb = jnp.asarray(x[i * B:(i + 1) * B])
        (_, metrics), grads = vg(params, xb, jnp.asarray(eps))
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return params, opt_state.inner_state, metrics


def _port_steps(params, x, eps_list, fused):
    tm = gyroplane_vae_from_state_dict(state_dict_from_jax_params(params), device="cpu")
    opt = RiemannianAdam(tm.parameters(), lr=float(np.float32(1e-3)), ball=tm.ball)
    cfg = fused_config(tm)
    for i, eps in enumerate(eps_list):
        e = torch.from_numpy(eps)
        if fused:
            def loss_fn(m, xb, g):
                lt, rm, km = fused_flagship_loss(params_tuple(m), xb, e, **cfg)
                return {"loss_total": lt, "recon_loss": rm, "kl_loss": km}
        else:
            def loss_fn(m, xb, g):
                return m.loss_from_eps(xb, e)
        metrics = train_step(tm, opt, torch.from_numpy(x[i * B:(i + 1) * B]), None, loss_fn)
    return tm, opt, metrics


def _compare(tm, opt, jparams, jstate, p_tol, m_tol, v_tol):
    """Parameters with ``p_tol``; moments with rtol and an atol that is the
    given fraction of the tensor's largest entry (``m_tol``, ``v_tol``:
    (rtol, fraction))."""
    jp = state_dict_from_jax_params(jax.tree.map(np.asarray, jparams))
    want = optimizer_state_from_jax(jax.tree.map(np.asarray, jstate), tm)
    assert int(opt.count) == want["count"]
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(), err_msg=name, **p_tol)
        for key, (rtol, frac) in (("exp_avg", m_tol), ("exp_avg_sq", v_tol)):
            ref = want["state"][p][key].numpy()
            np.testing.assert_allclose(opt.state[p][key].numpy(), ref, rtol=rtol,
                                       atol=frac * float(np.abs(ref).max()), err_msg=f"{name} {key}")


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_one_step_matches_jax(jax_setup, fused):
    jm, jt, params, x = jax_setup
    eps = [np.random.default_rng(1).normal(size=(B, 2)).astype(np.float32)]
    jparams, jstate, jmetrics = _jax_steps(jm, jt, params, x, eps)
    tm, opt, metrics = _port_steps(params, x, eps, fused)
    for k in ("loss_total", "recon_loss", "kl_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, atol=1e-6)
    assert float(metrics["skipped_steps"]) == 0.0
    _compare(tm, opt, jparams, jstate, dict(rtol=1e-4, atol=3e-5), (1e-3, 1e-4), (1e-3, 1e-4))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_five_steps_match_jax(jax_setup, fused):
    jm, jt, params, x = jax_setup
    rng = np.random.default_rng(2)
    eps = [rng.normal(size=(B, 2)).astype(np.float32) for _ in range(5)]
    jparams, jstate, _ = _jax_steps(jm, jt, params, x, eps)
    tm, opt, _ = _port_steps(params, x, eps, fused)
    _compare(tm, opt, jparams, jstate, dict(rtol=5e-3, atol=3e-4), (5e-3, 3e-4), (5e-3, 3e-4))


def test_history_keys_match_jax(jax_setup):
    """JAX's history rows are train/<m> for the train epoch's metrics,
    val/<m> for the eval's, lr and epoch (trainer.py _fit_chunked); the
    metric names come from abstract evaluation of its epoch bodies."""
    jm, jt, params, x = jax_setup
    jt._epoch_fns(4 * B, B, B)
    train_body, eval_full = jt._body_fns_cache[(4 * B, B, B)]
    xs, key = jnp.asarray(x[:4 * B]), jax.random.PRNGKey(0)
    opt_state = jt._optimizer.init(params)
    tms = jax.eval_shape(lambda p, o: train_body(p, o, xs, key)[2], params, opt_state)
    vms = jax.eval_shape(lambda p: eval_full(p, xs[:B], key), params)
    want = {f"train/{k}" for k in tms} | {f"val/{k}" for k in vms} | {"lr", "epoch"}
    dm = ArrayDataModule(x[:4 * B], np.zeros(4 * B, np.int32), x[4 * B:], np.zeros(B, np.int32),
                         x[:1], np.zeros(1, np.int32), batch_size=B)
    model = gyroplane_vae_from_state_dict(state_dict_from_jax_params(params), device="cpu")
    hist = Trainer(model, max_epochs=1, device="cpu").fit(dm).history
    assert set(hist[0]) == want


def test_data_module_and_split_equal_jax():
    jd = jax_mnist.make_data_module(batch_size=64, synthetic=True, n_train=500, n_test=50)
    td = make_data_module(batch_size=64, synthetic=True, n_train=500, n_test=50)
    for f in ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test"):
        a, b = getattr(td, f), getattr(jd, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (td.batch_size, td.name, list(td.label_names)) == (jd.batch_size, jd.name, list(jd.label_names))
    assert td.steps_per_epoch("train") == jd.steps_per_epoch("train")
    assert td.steps_per_epoch("val") == jd.steps_per_epoch("val")
    x = np.arange(37 * 3, dtype=np.float32).reshape(37, 3)
    y = np.arange(37, dtype=np.int32)
    for a, b in zip(split_train_val(x, y, 0.2, seed=7), jax_core.split_train_val(x, y, 0.2, seed=7)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
def test_mnist_idx_reader_equals_jax(tmp_path, gz):
    """Both packages read the same tiny IDX files (written here)."""
    rng = np.random.default_rng(0)

    def write(name, arr):
        header = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
        data = header + arr.astype(np.uint8).tobytes()
        if gz:
            with gzip.open(tmp_path / (name + ".gz"), "wb") as f:
                f.write(data)
        else:
            (tmp_path / name).write_bytes(data)

    write("train-images-idx3-ubyte", rng.integers(0, 256, (20, 28, 28)))
    write("train-labels-idx1-ubyte", rng.integers(0, 10, 20))
    write("t10k-images-idx3-ubyte", rng.integers(0, 256, (5, 28, 28)))
    write("t10k-labels-idx1-ubyte", rng.integers(0, 10, 5))
    got, want = load_mnist_arrays(tmp_path), jax_mnist.load_mnist_arrays(tmp_path)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[0].shape == (20, 28, 28, 1) and float(got[0].max()) <= 1.0
    with pytest.raises(FileNotFoundError):
        load_mnist_arrays(tmp_path / "missing")


def _tiny_dm(n=512, batch=64, poison=False):
    x, y, xt, yt = synthetic_mnist_arrays(n + n // 8, 64, seed=3)
    xtr, ytr, xv, yv = x[:n].copy(), y[:n], x[n:], y[n:]
    if poison:
        xtr[5] = np.nan
    return ArrayDataModule(xtr, ytr, xv, yv, xt, yt, batch_size=batch)


def _model(seed=0):
    return GyroplaneVAE(generator=torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("shuffle", ["row", "block"])
def test_fused_and_plain_fit_give_the_same_history(shuffle):
    """Same seed: the fused loss_fn draws eps as model.loss does, so both
    fits see the same batches and draws (val rows 64, tail of 0)."""
    dm = _tiny_dm()
    dm.x_val = dm.x_val[:40]  # n_val < batch: one eval batch of 40, no tail
    dm.y_val = dm.y_val[:40]
    hists = []
    for fused in (False, True):
        m = _model()
        t = Trainer(m, max_epochs=2, early_stopping_patience=None, device="cpu", shuffle=shuffle,
                    loss_fn=make_fused_loss_fn(m) if fused else None)
        hists.append(t.fit(dm).history)
    assert [sorted(h) for h in hists[0]] == [sorted(h) for h in hists[1]]
    for a, b in zip(*hists):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert hists[0][1]["val/loss_total"] < hists[0][0]["val/loss_total"]


def test_poisoned_batch_is_skipped_and_counted():
    """A NaN row poisons exactly one batch per epoch (row shuffle uses every
    row when n is a multiple of the batch): that step changes nothing and
    counts 1 of the epoch's 8 in train/skipped_steps. Without the guard
    the parameters go non-finite."""
    dm = _tiny_dm(poison=True)
    m = _model()
    res = Trainer(m, max_epochs=2, early_stopping_patience=None, device="cpu").fit(dm)
    for row in res.history:
        assert row["train/skipped_steps"] == pytest.approx(1 / 8)
        assert np.isfinite(row["val/loss_total"])
    assert all(torch.isfinite(p).all() for p in m.parameters())
    m2 = _model()
    Trainer(m2, max_epochs=1, early_stopping_patience=None, device="cpu", finite_guard=False).fit(dm)
    assert not all(torch.isfinite(p).all() for p in m2.parameters())


def test_controllers_and_best_params_follow_jax_semantics(tmp_path):
    """Monitoring train/skipped_steps (always 0): epoch 0 sets the best,
    later epochs never improve. The Trainer's lr column and stop epoch are
    those of JAX's controllers fed the same sequence; best_params are the
    epoch-0 weights; metrics.jsonl has one line per epoch."""
    dm = _tiny_dm(n=128)
    m = _model()
    t = Trainer(m, max_epochs=10, monitor="train/skipped_steps", early_stopping_patience=3,
                plateau_factor=0.5, plateau_patience=1, device="cpu", log_dir=str(tmp_path))
    res = t.fit(dm)
    from hyperbolic_vae_tpu.optim import EarlyStopping as JES
    from hyperbolic_vae_tpu.optim import ReduceLROnPlateau as JPL

    jp, je, lrs = JPL(lr=1e-3, factor=0.5, patience=1, min_lr=5e-5), JES(patience=3), []
    for _ in range(10):
        lrs.append(jp.lr)
        jp.step(0.0)
        if je.step(0.0):
            break
    assert [r["lr"] for r in res.history] == lrs
    assert res.epochs_run == len(lrs) == 4
    assert res.best_metric == 0.0
    m0 = _model()
    for k, v in res.best_params.items():
        assert torch.equal(v, m0.state_dict()[k]) is False or k  # moved after epoch 0
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4 and (tmp_path / "hparams.json").exists()
    # the host controllers are the port's own classes with JAX's state
    assert isinstance(t.plateau, ReduceLROnPlateau) and isinstance(t.early_stopping, EarlyStopping)
    assert (t.plateau.lr, t.early_stopping.wait) == (jp.lr, je.wait)


def test_best_params_are_the_best_epochs_weights():
    dm = _tiny_dm(n=256)
    m = _model()
    t = Trainer(m, max_epochs=3, early_stopping_patience=None, device="cpu")
    res = t.fit(dm)
    best = min(range(3), key=lambda e: res.history[e]["val/loss_total"])
    assert res.best_metric == pytest.approx(res.history[best]["val/loss_total"], rel=1e-7)
    if best == 2:
        assert all(torch.equal(res.best_params[k], v) for k, v in res.params.items())
    ev = t.evaluate(dm, res.best_params, split="val")
    assert sorted(ev) == ["val/kl_loss", "val/loss_total", "val/recon_loss"]
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(), res.params.values()))


def test_train_step_fn_hook_replaces_the_step():
    dm = _tiny_dm(n=128)
    m = _model()
    calls = []

    def step_fn(model, optimizer, batch, generator):
        calls.append(batch.shape[0])
        out = train_step(model, optimizer, batch, generator)
        out["custom"] = torch.ones(())
        return out

    res = Trainer(m, max_epochs=1, early_stopping_patience=None, device="cpu",
                  train_step_fn=step_fn).fit(dm)
    assert calls == [64, 64]
    assert res.history[0]["train/custom"] == 1.0


def test_batch_indices_row_and_block():
    g = torch.Generator().manual_seed(0)
    rows = batch_indices(100, 32, "row", g, "cpu")
    assert rows.shape == (3, 32) and len(set(rows.flatten().tolist())) == 96
    blocks = batch_indices(100, 32, "block", g, "cpu")
    assert blocks.shape == (3, 32)
    assert torch.equal(blocks - blocks[:, :1], torch.arange(32).expand(3, 32))
    assert int(blocks.max()) < 100
    with pytest.raises(ValueError):
        batch_indices(100, 32, "bogus", g, "cpu")


def test_trainer_runs_on_cuda_by_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_model())
    with pytest.raises(ValueError, match="monitor"):
        Trainer(_model(), monitor="loss_total", device="cpu")
    with pytest.raises(ValueError, match="shuffle"):
        Trainer(_model(), shuffle="bogus", device="cpu")
    fresh = Trainer(_model(), device="cpu", seed=3).init_params()
    again = Trainer(_model(), device="cpu", seed=3).init_params()
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)
