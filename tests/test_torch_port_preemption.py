"""Graceful stops in the port (``train/preemption.py`` and the Trainer's
``max_wall_seconds``, ``preempt_signals`` and ``state_every_n_epochs``).

Ports of ``tests/test_preemption.py``'s contracts: a stop ends ``fit`` (K
= 1 and chunked) or a sweep at a chunk boundary with the resume state
saved, and ``resume=True`` continues bit for bit (JAX holds the single
fit to 1e-6); a signal mid-fit stops it and its handler is gone after;
sweeps resume their lanes bit for bit and refuse another grid or other
seeds; the resume state's cadence. Tiny data on the CPU.
"""

import logging
import os
import signal
import threading

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.data import ArrayDataModule, synthetic_mnist_arrays
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.train import GracefulShutdown, Trainer


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dm() -> ArrayDataModule:
    x, y, xt, yt = synthetic_mnist_arrays(136, 8, seed=5)
    return ArrayDataModule(x[:96], y[:96], x[96:], y[96:], xt, yt, batch_size=32)


def _trainer(ckpt=None, model=None, **kw):
    kw.setdefault("max_epochs", 5)
    return Trainer(model or GyroplaneVAE(generator=torch.Generator().manual_seed(0), device="cpu"),
                   early_stopping_patience=None, plateau_patience=1000, check_finite=False,
                   checkpoint_dir=ckpt, device="cpu", **kw)


def _same_history(a: list, b: list) -> None:
    assert [h["epoch"] for h in a] == [h["epoch"] for h in b]
    for ha, hb in zip(a, b):
        for key in ha:
            assert np.array_equal(ha[key], hb[key], equal_nan=True), (ha["epoch"], key)


def _same_params(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_graceful_shutdown_flag_and_restore():
    prev = signal.getsignal(signal.SIGUSR1)
    with GracefulShutdown((signal.SIGUSR1,)) as g:
        assert not g.triggered
        os.kill(os.getpid(), signal.SIGUSR1)
        assert g.triggered and g.signum == signal.SIGUSR1
    assert signal.getsignal(signal.SIGUSR1) is prev


@pytest.mark.parametrize("k", [1, 2])
def test_wall_budget_stops_and_resumes(tmp_path, k):
    """max_wall_seconds=0 stops after each chunk with the resume state
    saved; restarted fits rebuild the uninterrupted run bit for bit."""
    ref = _trainer(max_epochs=6, epochs_per_dispatch=k).fit(_dm())
    ckpt = str(tmp_path / "ckpt")
    r = _trainer(ckpt, max_epochs=6, epochs_per_dispatch=k, max_wall_seconds=0).fit(_dm())
    assert r.interrupted and "wall-clock" in r.stop_reason
    assert r.epochs_run == k and len(r.history) == k  # one whole chunk ran
    history = list(r.history)
    for _ in range(10):
        r = _trainer(ckpt, max_epochs=6, epochs_per_dispatch=k, max_wall_seconds=0).fit(
            _dm(), resume=True)
        history += r.history
        if not r.interrupted:
            break
    assert not r.interrupted and r.stop_reason is None and r.epochs_run == 6
    _same_history(history, ref.history)
    _same_params(r.params, ref.params)
    _same_params(r.best_params, ref.best_params)


def test_preempt_signal_midfit():
    """A signal during training stops fit at the next chunk boundary; the
    handler is installed only while fit runs."""

    class KillAt:
        def on_epoch_end(self, trainer, epoch, params, metrics):
            if epoch == 1:
                os.kill(os.getpid(), signal.SIGUSR1)

    prev = signal.getsignal(signal.SIGUSR1)
    r = _trainer(max_epochs=10, preempt_signals=(signal.SIGUSR1,),
                 callbacks=[KillAt()]).fit(_dm())
    assert r.interrupted and "SIGUSR1" in r.stop_reason
    assert r.epochs_run == 2
    assert signal.getsignal(signal.SIGUSR1) is prev


def test_uninterrupted_result_flags_and_warning(caplog):
    r = _trainer(max_epochs=2).fit(_dm())
    assert not r.interrupted and r.stop_reason is None
    with caplog.at_level(logging.WARNING):
        r = _trainer(max_epochs=2, max_wall_seconds=1e9).fit(_dm())
    assert "no checkpoint_dir" in caplog.text and not r.interrupted


def test_state_every_n_epochs_cadence(tmp_path):
    """The resume state is saved when a chunk crosses the cadence and at
    stops and the end, not every chunk."""
    for k, want in ((1, [2, 4]), (2, [3, 4])):
        saved = []
        t = _trainer(str(tmp_path / f"k{k}"), state_every_n_epochs=3, epochs_per_dispatch=k)
        orig = t._save_resume_state
        t._save_resume_state = lambda run, epoch, orig=orig: (saved.append(epoch), orig(run, epoch))
        t.fit(_dm())
        assert saved == want, k
    saved = []
    t = _trainer(str(tmp_path / "stop"), state_every_n_epochs=100, max_wall_seconds=0)
    orig = t._save_resume_state
    t._save_resume_state = lambda run, epoch, orig=orig: (saved.append(epoch), orig(run, epoch))
    t.fit(_dm())
    assert saved == [0]  # the graceful stop saves


def test_ensemble_wall_budget_stops_and_resumes(tmp_path):
    seeds = [0, 1]
    ref = _trainer(max_epochs=6).fit_ensemble(_dm(), seeds, epochs_per_dispatch=2)
    ckpt = str(tmp_path / "ck")
    r = _trainer(ckpt, max_epochs=6, max_wall_seconds=0).fit_ensemble(
        _dm(), seeds, epochs_per_dispatch=2)
    assert all(x.interrupted and "wall-clock" in x.stop_reason for x in r)
    assert [x.epochs_run for x in r] == [2, 2]
    hist = [list(x.history) for x in r]
    for _ in range(10):
        r = _trainer(ckpt, max_epochs=6, max_wall_seconds=0).fit_ensemble(
            _dm(), seeds, epochs_per_dispatch=2, resume=True)
        for s in range(len(seeds)):
            hist[s] += r[s].history
        if not r[0].interrupted:
            break
    assert not r[0].interrupted and r[0].stop_reason is None
    for s in range(len(seeds)):
        _same_history(hist[s], ref[s].history)
        assert r[s].best_metric == ref[s].best_metric
        _same_params(r[s].params, ref[s].params)
        _same_params(r[s].best_params, ref[s].best_params)


def _hp_fn(hp):
    return GyroplaneVAE(latent_dim=2, manifold_curvature=hp["manifold_curvature"], device="cpu")


def _sweep_trainer(ckpt=None, **kw):
    return _trainer(ckpt, model=_hp_fn({"manifold_curvature": 1.0}), hp_model_fn=_hp_fn,
                    max_epochs=4, **kw)


def test_lane_sweep_resume_bitmatch(tmp_path):
    lanes = [{"manifold_curvature": 0.5}, {"manifold_curvature": 1.4}]
    ref = _sweep_trainer().fit_lane_sweep(_dm(), lanes, epochs_per_dispatch=2)
    ckpt = str(tmp_path / "ck")
    r = _sweep_trainer(ckpt, max_wall_seconds=0).fit_lane_sweep(_dm(), lanes,
                                                               epochs_per_dispatch=2)
    assert all(x.interrupted for x in r) and [x.epochs_run for x in r] == [2, 2]
    hist = [list(x.history) for x in r]
    r = _sweep_trainer(ckpt).fit_lane_sweep(_dm(), lanes, epochs_per_dispatch=2, resume=True)
    assert not r[0].interrupted
    for s in range(len(lanes)):
        _same_history(hist[s] + r[s].history, ref[s].history)
        _same_params(r[s].params, ref[s].params)


def test_lane_sweep_resume_grid_mismatch_raises(tmp_path):
    """Another grid (or another lane lr) must not resume the old grid's
    state; the same grid resumes."""
    ckpt = str(tmp_path / "ck")
    grid_a = [{"manifold_curvature": 0.5}, {"manifold_curvature": 1.4}]
    grid_b = [{"manifold_curvature": 2.0}, {"manifold_curvature": 3.0}]
    _sweep_trainer(ckpt, max_wall_seconds=0).fit_lane_sweep(_dm(), grid_a, epochs_per_dispatch=2)
    with pytest.raises(ValueError, match="lane hparams"):
        _sweep_trainer(ckpt).fit_lane_sweep(_dm(), grid_b, epochs_per_dispatch=2, resume=True)
    with pytest.raises(ValueError, match="lane hparams"):
        _sweep_trainer(ckpt).fit_lane_sweep(_dm(), [dict(lane, lr=9e-4) for lane in grid_a],
                                            epochs_per_dispatch=2, resume=True)
    r = _sweep_trainer(ckpt).fit_lane_sweep(_dm(), grid_a, epochs_per_dispatch=2, resume=True)
    assert [x.epochs_run for x in r] == [4, 4]


def test_ensemble_resume_seed_mismatch_raises(tmp_path):
    ckpt = str(tmp_path / "ck")
    _trainer(ckpt, max_epochs=4, max_wall_seconds=0).fit_ensemble(_dm(), [0, 1],
                                                                  epochs_per_dispatch=2)
    with pytest.raises(ValueError, match="saved seeds"):
        _trainer(ckpt, max_epochs=4).fit_ensemble(_dm(), [2, 3], epochs_per_dispatch=2,
                                                  resume=True)


def test_ensemble_preempt_signal(tmp_path):
    """A signal during a sweep stops it at the next chunk boundary, with
    the resume state saved; "state" and "ensemble_state" are two units."""
    ckpt = str(tmp_path / "ck")
    trainer = _trainer(ckpt, max_epochs=500, preempt_signals=(signal.SIGUSR1,))
    timer = threading.Timer(0.5, os.kill, (os.getpid(), signal.SIGUSR1))
    timer.start()
    try:
        r = trainer.fit_ensemble(_dm(), [0, 1], epochs_per_dispatch=1)
    finally:
        timer.cancel()
    assert all(x.interrupted and "SIGUSR1" in x.stop_reason for x in r)
    assert all(x.epochs_run < 500 for x in r)
    assert trainer._ckpt_mgr.has_state("ensemble_state") and not trainer._ckpt_mgr.has_state()
