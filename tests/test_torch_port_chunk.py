"""The port's chunk program: ``Trainer(epochs_per_dispatch=K)``, its
device controllers, schedules, EMA, bf16 moments, checkpoints and resume.

Ports of ``tests/test_chunked_fit.py`` and ``tests/test_lr_schedule.py``
(the JAX chunk program's contract), on the port alone: for every K the
history, the final and the best parameters are bit-identical to K = 1,
across an lr drop and an early stop inside a chunk, a trimmed tail chunk,
schedules, and a poisoned batch skipped and counted; a resumed fit
continues bit for bit. Tiny data (96 train rows, batch 32, 40 val rows:
one full val batch and an 8-row tail) at the flagship's widths, on the
CPU, where the chunk's pieces run eagerly.

Tests marked ``cuda`` run the same fits on a card, where the pieces are
CUDA graphs: graphed against the eager run of the same program, K = 5
against K = 1, and the kernels' launch counts through graph replays.
They need no JAX: on the card's machine run them with ``--noconftest``.
"""

import gc
import json
import weakref

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.data import ArrayDataModule, synthetic_mnist_arrays
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.ops import launch_counters, make_fused_loss_fn, make_fused_train_step
from hyperbolic_vae_tpu_torch.optim import beta_warmup_schedule, cosine_schedule
from hyperbolic_vae_tpu_torch.train import CheckpointManager, Trainer, restore_model
from hyperbolic_vae_tpu_torch.train.cuda_graph import (WARMUP_PASSES, GraphedProgram, Segment,
                                                       run_eagerly)


@pytest.fixture(autouse=True)
def _one_thread():
    """These fits are a few tiny matrix products a step: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dm(poison: bool = False, n_train: int = 96, n_val: int = 40, batch: int = 32):
    x, y, xt, yt = synthetic_mnist_arrays(n_train + n_val, 8, seed=3)
    xtr = x[:n_train].copy()
    if poison:
        xtr[5] = np.nan
    return ArrayDataModule(xtr, y[:n_train], x[n_train:], y[n_train:], xt, yt, batch_size=batch)


def _fit(k, dm=None, device="cpu", path="default", resume=False, **kw):
    m = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device=device)
    if path == "fused":
        kw["loss_fn"] = make_fused_loss_fn(m)
    elif path == "k3":
        kw.update(loss_fn=make_fused_loss_fn(m), train_step_fn=make_fused_train_step(m))
    kw.setdefault("early_stopping_patience", None)
    t = Trainer(m, epochs_per_dispatch=k, check_finite=False, device=device, **kw)
    return t.fit(dm or _dm(), resume=resume), t


def _same(a, b) -> None:
    """Bit-identical histories, parameters and best parameters."""
    ra, rb = a[0], b[0]
    assert ra.epochs_run == rb.epochs_run and len(ra.history) == len(rb.history)
    for ha, hb in zip(ra.history, rb.history):
        assert sorted(ha) == sorted(hb)
        for key in ha:
            assert np.array_equal(ha[key], hb[key], equal_nan=True), (ha["epoch"], key, ha[key], hb[key])
    assert ra.best_metric == rb.best_metric
    for d in ("params", "best_params", "ema_params"):
        da, db = getattr(ra, d), getattr(rb, d)
        assert (da is None) == (db is None)
        for name in da or {}:
            assert torch.equal(da[name], db[name]), (d, name)


def test_k_independent_across_lr_drop_and_early_stop():
    """Monitoring train/skipped_steps (always 0): epoch 0 is the best, the
    plateau (patience 0) halves the lr after epoch 1, so epoch 2 trains at
    the dropped lr inside the first chunk of 3; early stopping (patience
    3) fires at epoch 3, and epochs 4 and 5 of the second chunk run masked.
    K = 3 is bit-identical to K = 1, the stop epoch included."""
    kw = dict(monitor="train/skipped_steps", plateau_patience=0, plateau_factor=0.5,
              early_stopping_patience=3, max_epochs=8)
    r1, r3 = _fit(1, **kw), _fit(3, **kw)
    _same(r1, r3)
    res, t = r3
    lrs = [h["lr"] for h in res.history]
    assert res.epochs_run == 4 and len(lrs) == 4
    assert lrs[:2] == [float(np.float32(1e-3))] * 2 and lrs[2] == float(np.float32(5e-4))
    assert t.early_stopping.stopped and t.early_stopping.wait == 3
    assert t.plateau.lr == float(np.float32(1.25e-4))  # dropped after epochs 1, 2 and 3
    m0 = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device="cpu")
    # the best epoch is 0: its weights, not the initial ones, nor the last
    assert not all(torch.equal(res.best_params[k], v) for k, v in m0.state_dict().items())
    assert not all(torch.equal(res.best_params[k], v) for k, v in res.params.items())


def test_tail_chunk_trims_and_best_params_are_the_best_epochs():
    """max_epochs 3 with K = 2: the second chunk runs 1 epoch, so the
    final and best parameters are K = 1's. At lr 0.1 val/loss_total rises
    at epoch 2, so the best parameters are epoch 1's: a K = 1 fit stopped
    there."""
    r1, r2 = _fit(1, max_epochs=3, lr=0.1), _fit(2, max_epochs=3, lr=0.1)
    _same(r1, r2)
    hist = r2[0].history
    assert [h["epoch"] for h in hist] == [0, 1, 2]
    best = min(range(3), key=lambda e: hist[e]["val/loss_total"])
    assert best == 1 and r2[0].best_metric == hist[1]["val/loss_total"]
    upto, _ = _fit(1, max_epochs=2, lr=0.1)
    assert all(torch.equal(upto.params[k], v) for k, v in r2[0].best_params.items())
    assert not all(torch.equal(r2[0].params[k], v) for k, v in r2[0].best_params.items())


def test_poisoned_batch_skipped_and_counted_for_every_k():
    """One NaN row poisons one of the 3 batches of each epoch: skipped and
    counted (1/3), the parameters stay finite; K = 2 equals K = 1."""
    dm = _dm(poison=True)
    r1, r2 = _fit(1, dm, max_epochs=3), _fit(2, dm, max_epochs=3)
    _same(r1, r2)
    for row in r2[0].history:
        assert row["train/skipped_steps"] == pytest.approx(1 / 3)
        assert np.isfinite(row["val/loss_total"])
    assert all(torch.isfinite(v).all() for v in r2[0].params.values())


def test_schedules_ema_and_bf16_moments_in_chunks():
    """A cosine lr schedule (the plateau bypassed: patience 0 would drop
    it), a beta warm-up from 0, an EMA and bf16 moments: K = 3 equals
    K = 1; the lr column is the schedule's; at beta 0 the loss is the
    reconstruction alone; the model's beta is its own again after."""
    sched = cosine_schedule(1e-3, total_epochs=4, warmup_epochs=1, min_lr=1e-5)
    kw = dict(max_epochs=4, lr_schedule=sched, plateau_patience=0, ema_decay=0.9,
              moment_dtype="bfloat16", beta_schedule=beta_warmup_schedule(1.0, 2))
    r1, r3 = _fit(1, **kw), _fit(3, **kw)
    _same(r1, r3)
    res, t = r3
    assert [h["lr"] for h in res.history] == [float(sched(e)) for e in range(4)]
    h0, h1 = res.history[0], res.history[1]
    assert h0["train/loss_total"] == h0["train/recon_loss"]  # beta 0 at epoch 0
    assert h1["train/loss_total"] != h1["train/recon_loss"]  # beta 0.5 at epoch 1
    assert t.model.beta == 1.0 and isinstance(t.model.beta, float)
    assert all(s["exp_avg"].dtype == torch.bfloat16 for s in t.optimizer.state.values())
    assert sorted(res.ema_params) == sorted(n for n, _ in t.model.named_parameters())
    assert not any(torch.equal(res.ema_params[k], res.params[k]) for k in res.ema_params)


def test_resume_continues_bit_for_bit(tmp_path):
    """Four epochs in chunks of 2 against two epochs, then a new Trainer
    resuming from the state checkpoint: the resumed epochs, the final,
    best and EMA parameters are the uninterrupted fit's; the plateau's
    drops (monitor train/skipped_steps, patience 0) carry across. Also:
    callbacks at chunk boundaries, log_every_n_epochs, best/last/ema
    checkpoints and restore_model."""
    seen = []

    class Callback:
        def on_fit_start(self, trainer, dm):
            seen.append("start")

        def on_epoch_end(self, trainer, epoch, params, row):
            seen.append(epoch)

    kw = dict(monitor="train/skipped_steps", plateau_patience=0, plateau_factor=0.5,
              ema_decay=0.9)
    full = _fit(2, max_epochs=4, checkpoint_dir=str(tmp_path / "full"), callbacks=[Callback()],
                log_dir=str(tmp_path / "log"), log_every_n_epochs=2, **kw)
    assert seen == ["start", 1, 3]
    logged = [json.loads(line)["step"] for line in (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert logged == [0, 2]
    _fit(2, max_epochs=2, checkpoint_dir=str(tmp_path / "cut"), **kw)
    resumed = _fit(2, max_epochs=4, checkpoint_dir=str(tmp_path / "cut"), resume=True, **kw)
    res, want = resumed[0], full[0]
    assert [h["epoch"] for h in res.history] == [2, 3]
    assert res.history == want.history[2:]
    assert res.history[0]["lr"] < want.history[0]["lr"]  # a drop from before the cut
    for d in ("params", "best_params", "ema_params"):
        for k, v in getattr(want, d).items():
            assert torch.equal(getattr(res, d)[k], v), (d, k)
    mgr = CheckpointManager(str(tmp_path / "full"))
    assert mgr.metadata("last")["epoch"] == 3 and mgr.metadata("best")["epoch"] == 0
    model, params, meta = restore_model(str(tmp_path / "full"), "best", device="cpu")
    assert meta["model"]["__model_class__"] == "GyroplaneVAE"
    assert all(torch.equal(params[k], v) for k, v in want.best_params.items())
    assert all(torch.equal(model.state_dict()[k], v) for k, v in want.best_params.items())
    ema_model, _, _ = restore_model(str(tmp_path / "full"), "ema", device="cpu")
    assert all(torch.equal(ema_model.state_dict()[k], v) for k, v in want.ema_params.items())


def test_unknown_monitor_raises():
    with pytest.raises(KeyError, match="not among the metrics"):
        _fit(1, max_epochs=1, monitor="val/bogus")


# ---------------------------------------------------------------------- #
# On the card: the chunk program as CUDA graphs.


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "fused", "k3"])
def test_graphed_equals_eager_on_card(path):
    """The graphed fit against the eager run of the same program, with an
    lr drop inside a chunk of 3 (monitor train/skipped_steps, plateau
    patience 0): bit-identical histories and parameters."""
    dev = _card()
    kw = dict(device=dev, path=path, monitor="train/skipped_steps", plateau_patience=0,
              plateau_factor=0.5, max_epochs=3)
    graphed = _fit(3, **kw)
    with run_eagerly():
        eager = _fit(3, **kw)
    _same(graphed, eager)
    assert len({h["lr"] for h in graphed[0].history}) == 2


class _Cycle:
    """Keeps ``obj`` in a reference cycle: only the cyclic collector frees it."""

    def __init__(self, obj):
        self.obj, self.me = obj, self


def _graphed_matmul(dev, gen, extra=lambda: None):
    w = torch.randn(64, 64, device=dev)
    out = torch.zeros(64, 64, device=dev)

    def piece():
        out.copy_((w @ torch.randn(64, 64, device=dev, generator=gen)).tanh())
        extra()

    return GraphedProgram([Segment((piece,), 2, "step")], device=dev, generator=gen, state=[out])


@pytest.mark.cuda
def test_capture_survives_dead_graphs():
    """A finished program left in a reference cycle (as a finished fit
    leaves its chunk program) holds captured graphs; destroying a graph
    while another program captures invalidates that capture. So the
    capture runs with the cyclic collector held off: the piece below
    becomes the last holder of a dead program and collects whenever
    Python's collector could run, and the capture must still succeed,
    its program replay, and the dead program be freed afterwards."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    dead = _graphed_matmul(dev, gen)
    dead.run()
    gone = weakref.ref(dead)
    holder = [_Cycle(dead)]
    del dead
    calls = [0]

    def drop_and_collect():
        calls[0] += 1
        if calls[0] == WARMUP_PASSES + 1:  # the first call under capture
            holder.clear()
            if gc.isenabled():
                gc.collect()

    prog = _graphed_matmul(dev, gen, drop_and_collect)
    prog.run()
    prog.run()
    torch.cuda.synchronize()
    assert calls[0] == WARMUP_PASSES + 1 and not holder
    gc.collect()
    assert gone() is None


@pytest.mark.cuda
def test_k5_equals_k1_on_card_with_counts():
    """K3 path on the card: K = 5 equals K = 1 with an early stop inside
    the chunk; K3 launches = steps x epochs run (masked epochs included,
    as they run), K2 = (val batches + tail) x epochs, counted through
    graph replays."""
    dev = _card()
    kw = dict(device=dev, path="k3", monitor="train/skipped_steps", early_stopping_patience=2,
              max_epochs=5)
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    r1 = _fit(1, **kw)
    k1 = {k: c.count for k, c in counters.items()}
    r5 = _fit(5, **kw)
    _same(r1, r5)
    assert r1[0].epochs_run == 3
    assert k1 == {"gyroplane_distances": 0, "flagship_fused": 3 * 2, "flagship_train": 3 * 3,
                  "riemannian_adam": 0}
    k5 = {k: c.count - k1[k] for k, c in counters.items()}
    assert k5 == {"gyroplane_distances": 0, "flagship_fused": 5 * 2, "flagship_train": 5 * 3,
                  "riemannian_adam": 0}
