"""The per-layer metrics that read the program's span recorder
(``harness/spans.py``, ``metrics/launch_gap_pct.py`` and the others) on a
synthetic recorder state, and nothing read where the program has no
recorder or it holds no fit."""

import sys

import pytest

import hyperbolic_vae_tpu_torch.train as port_train
from hyperbolic_vae_tpu_torch.train import tracing
from portbench.harness import spec

READERS = ("launch_gap_pct", "boundary_gap_pct", "issue_ms_per_step", "capture_s", "stage_s")
MS = 1e6  # ns


def _fit():
    """A fit of 5 chunks (0 captures, 1 is profiled), 3 steps a chunk;
    the counted chunks 2, 3, 4 each 10 ms on the card with 1 ms of gaps
    between replays, 2 ms between chunks; issue 0.6 ms a chunk."""
    fit = tracing.Fit(id=7, clock=(0, 0))
    spans = fit.spans

    def add(name, parent, start, end, **counters):
        spans.append(tracing.Span(len(spans), name, parent, start, end, counters))
        return spans[-1]

    root = add("fit", None, 0, 500 * MS)
    add("fit.preflight", root.id, 0, 1 * MS)
    add("fit.stage", root.id, 1 * MS, 21 * MS)
    add("fit.build", root.id, 21 * MS, 51 * MS)
    for i in range(5):
        c = add("chunk", root.id, 60 * MS + 20 * MS * i, 75 * MS + 20 * MS * i,
                index=i, epochs=1, steps=3)
        issue = add("chunk.issue", c.id, c.start, c.start + (100 if i == 0 else 0.6) * MS)
        if i == 0:
            add("chunk.capture", issue.id, c.start, c.start + 99 * MS, segments=5)
        t0 = 100 * MS + 12 * MS * i
        fit.chunks.append(tracing.ChunkDevice(i, c.id, 4, t0, t0 + 10 * MS, 9 * MS, 1 * MS))
    fit.chunks[1].gaps = 5 * MS  # the profiled chunk's gaps: not counted
    return fit


def _read(name):
    return spec.metric_reader(name)(None)


def test_readers_on_a_synthetic_fit(monkeypatch):
    monkeypatch.setattr(tracing, "_last", _fit())
    d = 34 * MS  # chunk 2's first replay (124 ms) to chunk 4's last end (158 ms)
    assert _read("launch_gap_pct") == pytest.approx(100 * 3 * MS / d)
    assert _read("boundary_gap_pct") == pytest.approx(100 * 2 * 2 * MS / d)
    assert _read("issue_ms_per_step") == pytest.approx(0.6 / 3)
    assert _read("capture_s") == pytest.approx(0.099)
    assert _read("stage_s") == pytest.approx(0.051)


def test_one_counted_chunk_has_no_boundary(monkeypatch):
    fit = _fit()
    fit.chunks = fit.chunks[:3]
    monkeypatch.setattr(tracing, "_last", fit)
    assert _read("boundary_gap_pct") == 0.0
    assert _read("launch_gap_pct") == pytest.approx(10.0)


def test_nothing_counted(monkeypatch):
    fit = _fit()
    fit.chunks = fit.chunks[:2]
    fit.spans = [s for s in fit.spans if s.name not in ("chunk.capture", "fit.stage",
                                                         "fit.preflight", "fit.build")]
    fit.spans = [s for s in fit.spans if s.counters.get("index", 0) < 2]
    monkeypatch.setattr(tracing, "_last", fit)
    for name in READERS:
        assert _read(name) is None, name


def test_no_fit_reads_nothing(monkeypatch):
    monkeypatch.setattr(tracing, "_last", None)
    for name in READERS:
        assert _read(name) is None, name


def test_no_recorder_reads_nothing(monkeypatch):
    """The parent program (no ``train/tracing.py``): every reader None."""
    monkeypatch.setattr(tracing, "_last", _fit())
    monkeypatch.delattr(port_train, "tracing")
    monkeypatch.setitem(sys.modules, "hyperbolic_vae_tpu_torch.train.tracing", None)
    for name in READERS:
        assert _read(name) is None, name
