"""The port's streamed training (``Trainer.fit_streamed``,
``train/streaming.py``) and streamed evaluation
(``evaluate(stream_block_rows=...)``).

Port of ``tests/test_streaming.py`` (its two mesh tests belong to the
mesh, which the port does not have yet), on tiny data at the flagship's
widths on the CPU: one block of the whole split is ``fit`` bit for bit on
the default and the K3 path; several blocks train; ``rows`` mode deals
every row, the tail included; a memmap split trains as its array; the
tail warning; the block schedule follows the absolute epoch and a
streamed resume continues bit for bit; bad configurations are refused;
the memory preflight counts two blocks and names ``fit_streamed``.
Against JAX: the rows each block of epochs 0-2 holds are the ones JAX's
``make_streamed_epoch`` reads, in both reshuffle modes, and streamed
``evaluate`` of an Autoencoder (a deterministic loss) with JAX's
parameters is JAX's to 1e-5, and so is a two-epoch fit of 4 one-batch
blocks.
"""

import dataclasses
import logging
import types

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.data import ArrayDataModule, synthetic_mnist_arrays
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.ops import make_fused_loss_fn, make_fused_train_step
from hyperbolic_vae_tpu_torch.train import Trainer
from hyperbolic_vae_tpu_torch.train.streaming import block_schedule

N_TRAIN, N_VAL, BATCH = 128, 40, 32


@pytest.fixture(autouse=True)
def _one_thread():
    """A few tiny matrix products a step: one intra-op thread is faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dm():
    x, y, xt, yt = synthetic_mnist_arrays(N_TRAIN + N_VAL, 8, seed=3)
    return ArrayDataModule(x[:N_TRAIN].copy(), y[:N_TRAIN], x[N_TRAIN:], y[N_TRAIN:], xt, yt,
                           batch_size=BATCH)


def _trainer(path="default", **kw):
    m = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device="cpu")
    if path == "k3":
        kw.update(loss_fn=make_fused_loss_fn(m), train_step_fn=make_fused_train_step(m))
    kw.setdefault("max_epochs", 3)
    kw.setdefault("early_stopping_patience", None)
    return Trainer(m, check_finite=False, device="cpu", **kw)


def _same(ra, rb) -> None:
    assert ra.epochs_run == rb.epochs_run and len(ra.history) == len(rb.history)
    for ha, hb in zip(ra.history, rb.history):
        assert ha.keys() == hb.keys()
        for key in ha:
            assert np.array_equal(ha[key], hb[key], equal_nan=True), (ha["epoch"], key)
    assert ra.best_metric == rb.best_metric
    for name in ra.params:
        assert torch.equal(ra.params[name], rb.params[name]), name
        assert torch.equal(ra.best_params[name], rb.best_params[name]), name
    assert (ra.ema_params is None) == (rb.ema_params is None)
    for name in ra.ema_params or {}:
        assert torch.equal(ra.ema_params[name], rb.ema_params[name]), name


def _losses(r):
    return [h["train/loss_total"] for h in r.history]


class _Epochs:
    def __init__(self):
        self.seen = []

    def on_epoch_end(self, trainer, epoch, params, metrics):
        self.seen.append((epoch, metrics["val/loss_total"]))


@pytest.mark.parametrize("path", ["default", "k3", "ema"])
def test_single_block_bitmatches_resident_fit(dm, path):
    """One block of the whole split is fit, bit for bit: on the default
    path, the K3 path (train_step_fn), and with a parameter EMA and a
    callback."""
    kw = dict(ema_decay=0.9) if path == "ema" else {}
    calls = [_Epochs(), _Epochs()]
    resident = _trainer(path if path != "ema" else "default", callbacks=[calls[0]], **kw).fit(dm)
    streamed = _trainer(path if path != "ema" else "default", callbacks=[calls[1]],
                        **kw).fit_streamed(dm, block_rows=N_TRAIN)
    _same(resident, streamed)
    assert calls[0].seen == calls[1].seen and len(calls[0].seen) == 3


def test_multi_block_trains(dm):
    r = _trainer(max_epochs=4).fit_streamed(dm, block_rows=32)  # J = 4 blocks
    losses = _losses(r)
    assert r.epochs_run == 4 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert r.samples_per_sec > 0  # 4 blocks x 1 step x 32 rows an epoch, after the first


def test_rows_reshuffle_mixes_all_rows(dm):
    r = _trainer().fit_streamed(dm, block_rows=48, reshuffle="rows")  # J = 2, a 32-row tail
    losses = _losses(r)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    # a quarter of the rows sits out each epoch, a different quarter each time
    seen = np.concatenate([b for e in range(12)
                           for b in block_schedule(42, e, N_TRAIN, 48, "rows")])
    assert set(seen.tolist()) == set(range(N_TRAIN))


def test_memmap_backed_split(tmp_path, dm):
    path = tmp_path / "x_train.f32"
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=dm.x_train.shape)
    mm[:] = dm.x_train
    mm.flush()
    dm2 = dataclasses.replace(
        dm, x_train=np.memmap(path, dtype=np.float32, mode="r", shape=dm.x_train.shape))
    for reshuffle in ("block_order", "rows"):
        _same(_trainer().fit_streamed(dm2, block_rows=64, reshuffle=reshuffle),
              _trainer().fit_streamed(dm, block_rows=64, reshuffle=reshuffle))


def test_block_order_tail_exclusion_warns(dm, caplog):
    with caplog.at_level(logging.WARNING):
        _trainer(max_epochs=1).fit_streamed(dm, block_rows=48)
    assert any("excluded from every epoch" in r.getMessage() for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        _trainer(max_epochs=1).fit_streamed(dm, block_rows=48, reshuffle="rows")
    assert not any("excluded from every epoch" in r.getMessage() for r in caplog.records)


def test_streamed_schedule_and_resume_follow_the_absolute_epoch(dm, tmp_path):
    """The block order of an epoch depends on its absolute number
    (rng((seed, 0x5EED, epoch))), so a fit resumed at epoch 2 streams the
    blocks the uninterrupted fit streams, and continues it bit for bit."""
    orders = [[b.start for b in block_schedule(42, e, N_TRAIN, 32, "block_order")]
              for e in range(4)]
    assert orders[0] != orders[2]
    full = _trainer(max_epochs=4).fit_streamed(dm, block_rows=32)
    ckpt = str(tmp_path / "ckpt")
    _trainer(max_epochs=2, checkpoint_dir=ckpt).fit_streamed(dm, block_rows=32)
    rest = _trainer(max_epochs=4, checkpoint_dir=ckpt).fit_streamed(dm, block_rows=32,
                                                                    resume=True)
    assert [h["epoch"] for h in rest.history] == [2, 3]
    for ha, hb in zip(full.history[2:], rest.history):
        assert ha == hb
    for name in full.params:
        assert torch.equal(full.params[name], rest.params[name]), name


def test_streamed_rejects_bad_config(dm):
    with pytest.raises(ValueError, match="< batch_size"):
        _trainer().fit_streamed(dm, block_rows=16)
    with pytest.raises(ValueError, match="epochs_per_dispatch"):
        _trainer(epochs_per_dispatch=2).fit_streamed(dm, block_rows=64)
    with pytest.raises(ValueError, match="> n_train"):
        _trainer().fit_streamed(dm, block_rows=1024)
    with pytest.raises(ValueError, match="reshuffle"):
        _trainer().fit_streamed(dm, block_rows=64, reshuffle="blocks")
    lanes = Trainer(GyroplaneVAE(device="cpu"), device="cpu",
                    hp_model_fn=lambda hp: GyroplaneVAE(device="cpu"))
    with pytest.raises(ValueError, match="hp_model_fn"):
        lanes.fit_streamed(dm, block_rows=64)


def test_preflight_counts_two_blocks_and_names_fit_streamed(dm):
    """A limit between the streamed estimate (two 32-row blocks) and the
    resident one (all 128 rows): fit is refused with fit_streamed as the
    remedy, and fit_streamed runs."""
    t = _trainer()
    resident = t.memory_estimate(dm, [t.model])["total"]
    streamed = t.memory_estimate(dm, [t.model], stream_rows=32)["total"]
    assert resident - streamed == (N_TRAIN - 2 * 32) * 784 * 4
    limit = (resident + streamed) // 2
    with pytest.raises(RuntimeError, match="fit_streamed"):
        _trainer(hbm_limit_bytes=limit).fit(dm)
    r = _trainer(hbm_limit_bytes=limit, max_epochs=1).fit_streamed(dm, block_rows=32)
    assert r.epochs_run == 1


# ---- against JAX ----------------------------------------------------------


class _Reads:
    """A host split that records each read: the row indices of every
    block a streaming engine gathers, in order."""

    def __init__(self, x):
        self.x, self.shape, self.dtype, self.reads = x, x.shape, x.dtype, []

    def __len__(self):
        return len(self.x)

    def __getitem__(self, idx):
        rows = np.arange(len(self.x))[idx]
        self.reads.append(rows)
        return self.x[rows]


@pytest.mark.parametrize("reshuffle", ["block_order", "rows"])
def test_block_rows_equal_jax(dm, reshuffle):
    """Epochs 0-2 with 3 blocks of 40 rows (an 8-row tail): the rows of
    each block, in order, are those JAX's make_streamed_epoch reads; in
    ``rows`` mode (no block is ever reused) the port's fit reads exactly
    those."""
    import jax
    import jax.numpy as jnp

    from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxGyroplaneVAE
    from hyperbolic_vae_tpu.train import Trainer as JaxTrainer
    from hyperbolic_vae_tpu.train.streaming import make_streamed_epoch

    rows, epochs = 40, 3
    jt = JaxTrainer(JaxGyroplaneVAE(data_shape=(28, 28, 1), latent_dim=2), max_epochs=epochs,
                    early_stopping_patience=None, check_finite=False)
    jt._stream_reshuffle = reshuffle

    def block_fn(params, opt_state, block, key, hp=None):  # reads only: no training
        return params, opt_state, {"loss_total": jnp.zeros(())}

    jt._epoch_fns = lambda *a: (block_fn, None)
    jax_x = _Reads(dm.x_train)
    epoch = make_streamed_epoch(jt, types.SimpleNamespace(x_train=jax_x, batch_size=BATCH),
                                rows, N_VAL)
    for _ in range(epochs):
        epoch(None, None, None, jax.random.PRNGKey(0))
    want = [np.arange(N_TRAIN)[b] for e in range(epochs)
            for b in block_schedule(42, e, N_TRAIN, rows, reshuffle)]
    assert len(jax_x.reads) == len(want) == epochs * (N_TRAIN // rows)
    for got, w in zip(jax_x.reads, want):
        np.testing.assert_array_equal(got, w)
    if reshuffle == "rows":
        port_x = _Reads(dm.x_train)
        _trainer(max_epochs=epochs).fit_streamed(dataclasses.replace(dm, x_train=port_x), rows,
                                                 reshuffle="rows")
        assert len(port_x.reads) == len(want)
        for got, w in zip(port_x.reads, want):
            np.testing.assert_array_equal(got, w)


def _jax_autoencoder(shape, rng):
    """JAX's Autoencoder (base 4, latent 8) and parameters of its tree's
    shapes drawn from ``rng`` (numpy arrays; flax's eager init of the conv
    stack takes ~15 s on the CPU)."""
    import jax
    import jax.numpy as jnp

    from hyperbolic_vae_tpu.models import Autoencoder as JaxAE

    jm = JaxAE(data_shape=shape, base_channel_size=4, latent_dim=8)
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    tree = jax.eval_shape(jm.init, keys, jnp.zeros((2,) + shape))["params"]

    def draw(path, leaf):
        fan_in = np.prod(leaf.shape[:-1]) if str(path[-1].key) == "kernel" else 100.0
        return rng.normal(0.0, np.sqrt(1.0 / fan_in), leaf.shape).astype(np.float32)

    return jm, jax.tree_util.tree_map_with_path(draw, tree)


def test_streamed_evaluate_equals_jax():
    """``evaluate(stream_block_rows=m)`` of an Autoencoder (no draws) with
    JAX's parameters: 50 test rows in blocks of 20 (the last 10 rows a
    block of their own, weighted by its count), as JAX's, to 1e-5."""
    from hyperbolic_vae_tpu.data.core import ArrayDataModule as JaxDM
    from hyperbolic_vae_tpu.train import Trainer as JaxTrainer
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params
    from hyperbolic_vae_tpu_torch.models import Autoencoder

    shape, n = (16, 16, 3), 50
    rng = np.random.default_rng(5)
    jm, params = _jax_autoencoder(shape, rng)
    x = rng.uniform(0.0, 1.0, (3 * n,) + shape).astype(np.float32)
    y = np.zeros(3 * n, np.int32)
    arrays = (x[:n], y[:n], x[n:2 * n], y[n:2 * n], x[2 * n:], y[2 * n:])
    want = JaxTrainer(jm, early_stopping_patience=None).evaluate(
        JaxDM(*arrays, batch_size=8), params, "test", stream_block_rows=20)
    model = Autoencoder(shape, base_channel_size=4, latent_dim=8, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    trainer = Trainer(model, early_stopping_patience=None, device="cpu")
    port_dm = ArrayDataModule(*arrays, batch_size=8)
    got = trainer.evaluate(port_dm, split="test", stream_block_rows=20)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    # blocks of n or more rows: the resident path
    assert trainer.evaluate(port_dm, split="test", stream_block_rows=n) == trainer.evaluate(
        port_dm, split="test")


def test_multi_block_fit_equals_jax():
    """Two epochs of 4 blocks of an Autoencoder (a deterministic loss)
    from JAX's parameters, against JAX's ``fit_streamed``: one batch a block
    (block_rows == batch_size), so the shuffle inside a block reorders only
    a batch's own rows, and the blocks' order, the mean of the block means
    and the resident val pass are what is compared, to 1e-5 a metric."""
    from hyperbolic_vae_tpu.data.core import ArrayDataModule as JaxDM
    from hyperbolic_vae_tpu.train import Trainer as JaxTrainer
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params
    from hyperbolic_vae_tpu_torch.models import Autoencoder

    shape, batch, n = (8, 8, 3), 8, 32
    rng = np.random.default_rng(6)
    jm, params = _jax_autoencoder(shape, rng)
    x = rng.uniform(0.0, 1.0, (n + 2 * batch,) + shape).astype(np.float32)
    y = np.zeros(len(x), np.int32)
    arrays = (x[:n], y[:n], x[n:n + batch], y[n:n + batch], x[n + batch:], y[n + batch:])
    kw = dict(max_epochs=2, early_stopping_patience=None)
    want = JaxTrainer(jm, **kw).fit_streamed(JaxDM(*arrays, batch_size=batch), block_rows=batch,
                                             params=params)
    model = Autoencoder(shape, base_channel_size=4, latent_dim=8, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    got = Trainer(model, device="cpu", **kw).fit_streamed(
        ArrayDataModule(*arrays, batch_size=batch), block_rows=batch)
    assert len(got.history) == len(want.history) == 2
    for hg, hw in zip(got.history, want.history):
        for k in ("train/loss_total", "val/loss_total"):
            np.testing.assert_allclose(hg[k], hw[k], rtol=1e-5, err_msg=(hg["epoch"], k))
