"""The port's span recorder (``train/tracing.py``) on the Trainer's fits.

Off (no ``profile_dir``) a fit records nothing and makes no timing event;
on, a fit gives the span tree of the module's docstring, with parents
and counters, ``spans.json`` and the profiled chunk's host spans in
torch.profiler's trace, which leave the benchmark's reading of that trace
as it was. The spans on the card are placed and summed by the same code
on the CPU with a stand-in clock of events. Tests marked ``cuda`` run on
a card: every ``cudaGraphLaunch`` of the profiled chunk lies inside the
program's ``chunk.issue`` in both files, and the graph runner adds its
replays' launches without looking the counters up again. The file
imports no JAX, so the card's machine runs it with ``--noconftest``.
"""

import contextlib
import json
import sys
from pathlib import Path

import pytest
import torch

from hyperbolic_vae_tpu_torch.data import ArrayDataModule, synthetic_mnist_arrays
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.ops import gyroplane, launch_counters
from hyperbolic_vae_tpu_torch.train import Trainer, tracing
from hyperbolic_vae_tpu_torch.train import cuda_graph
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]
CHUNK_PARTS = ["chunk.issue", "chunk.fetch", "chunk.absorb", "chunk.checkpoint",
               "chunk.callbacks", "chunk.stop"]


def _dm(n_train=96, n_val=40, batch=32):
    x, y, xt, yt = synthetic_mnist_arrays(n_train + n_val, 8, seed=3)
    return ArrayDataModule(x[:n_train], y[:n_train], x[n_train:], y[n_train:], xt, yt,
                           batch_size=batch)


def _trainer(device="cpu", **kw):
    m = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device=device)
    kw.setdefault("early_stopping_patience", None)
    return Trainer(m, check_finite=False, device=device, **kw)


class _Launches:
    """A callback that adds ``n`` to K1's launch counter at each chunk's end."""

    def __init__(self, n):
        self.n = n

    def on_epoch_end(self, trainer, epoch, live, row):
        gyroplane.launches.add(self.n)


# ---------------------------------------------------------------------- #
# On the CPU: host spans.


def test_off_records_nothing_and_makes_no_event(monkeypatch):
    made = []
    real = torch.cuda.Event
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(k) or real(*a, **k))
    monkeypatch.setattr(tracing, "Recorder", lambda *a: pytest.fail("a recorder was made"))
    seen = []

    class Look:
        def on_epoch_end(self, trainer, epoch, live, row):
            seen.append(tracing.current)

    before = tracing.last_fit()
    res = _trainer(max_epochs=2, callbacks=[Look()]).fit(_dm())
    assert res.epochs_run == 2 and seen == [None, None]
    assert tracing.last_fit() is before and tracing.current is None and made == []


def test_two_chunk_fit_gives_the_span_tree(tmp_path):
    prof = tmp_path / "prof"
    t = _trainer(max_epochs=2, profile_dir=str(prof), checkpoint_dir=str(tmp_path / "ck"),
                 callbacks=[_Launches(5)])
    t.fit(_dm())
    fit = tracing.last_fit()
    assert fit is not None and tracing.current is None
    assert not any(s.on_card for s in fit.spans) and fit.chunks == []  # host spans only
    (root,) = [s for s in fit.spans if s.parent is None]
    assert root.name == "fit"
    assert [c.name for c in fit.children(root)] == [
        "fit.preflight", "fit.stage", "fit.build", "chunk", "chunk", "fit.result"]
    chunks = fit.named("chunk")
    for i, c in enumerate(chunks):
        assert [s.name for s in fit.children(c)] == CHUNK_PARTS
        assert c.counters == {"index": i, "epochs": 1, "steps": 3, "replays": 0,
                              "gyroplane_distances": 5}
        (cb,) = fit.children(c, "chunk.callbacks")
        assert cb.counters == {"replays": 0, "gyroplane_distances": 5}
        assert fit.children(c, "chunk.absorb")[0].counters == {"replays": 0}
    assert root.counters["gyroplane_distances"] == 10
    for s in fit.spans:
        assert s.end >= s.start
        if s.parent is not None:
            p = fit.spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    # spans.json: every span once, on one time base with the trace
    data = json.loads((prof / "spans.json").read_text())
    trace = json.loads((prof / "trace.json").read_text())
    assert data["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    named = [e for e in data["traceEvents"] if e["ph"] == "X"]
    assert sorted(e["args"]["span"] for e in named) == list(range(len(fit.spans)))
    issue = [e for e in named if e["name"] == "chunk.issue"][1]
    merged = [e for e in trace["traceEvents"] if e.get("cat") == "program"]
    assert [e["name"] for e in merged] == ["chunk.issue", "chunk.fetch"]
    # the trace's copy is the span, cut to the trace's own events where it reaches past them
    args = dict(merged[0]["args"])
    host = (args.pop("host_ts", merged[0]["ts"]), args.pop("host_dur", merged[0]["dur"]))
    assert args == issue["args"] and host == (pytest.approx(issue["ts"]), pytest.approx(issue["dur"]))
    assert issue["ts"] - 1e-3 <= merged[0]["ts"]
    assert merged[0]["ts"] + merged[0]["dur"] <= issue["ts"] + issue["dur"] + 1e-3


def test_profiled_merge_keeps_the_trace_readings(tmp_path):
    """The merged spans appear once each, inside the profiler's session;
    ``Trace``'s busy time, device events, span and the existing readers
    read as they did without them."""
    sys.path.insert(0, str(ROOT))
    from portbench.harness import spec, trace as tr
    from portbench.harness.cell import Context

    prof = tmp_path / "prof"
    _trainer(max_epochs=3, profile_dir=str(prof)).fit(_dm())
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    merged = [e for e in events if e.get("cat") == "program"]
    assert [e["name"] for e in merged] == ["chunk.issue", "chunk.fetch"]
    fit = tracing.last_fit()
    assert sorted(e["args"]["span"] for e in merged) == [
        s.id for s in fit.children(fit.named("chunk")[1]) if s.name in ("chunk.issue", "chunk.fetch")]
    (session,) = [e for e in events if e.get("cat") == "Trace" and e.get("ph") == "X"]
    for e in merged:
        assert session["ts"] <= e["ts"] and e["ts"] + e["dur"] <= session["ts"] + session["dur"]
    before = tr.Trace([e for e in events if e.get("cat") != "program"])
    after = tr.Trace(events)
    assert after.busy_us() == before.busy_us() and after.device == before.device
    assert after.span == before.span
    cell = spec.load_cell("flagship-train-autograd", ROOT)
    for name in ("busy_ms_per_step", "kernels_per_step", "idle_pct", "k1_roofline", "step_mfu"):
        ctx = [Context(config=dict(cell.config, name=cell.config_name), traffic=cell.traffic,
                       window={}, trace=t, traced_epochs=1, batch=32, steps_per_epoch=3,
                       eval_batch=32, eval_steps=1, val_rem=8) for t in (before, after)]
        read = spec.metric_reader(name)
        assert read(ctx[0]) == read(ctx[1])


def test_streamed_fit_spans(tmp_path):
    """``fit_streamed`` records the same tree; on the CPU its block copies
    and computes (spans on the card) are not recorded."""
    t = _trainer(max_epochs=2, profile_dir=str(tmp_path / "prof"))
    t.fit_streamed(_dm(), block_rows=48)
    fit = tracing.last_fit()
    assert [s.name for s in fit.children(fit.named("fit")[0])] == [
        "fit.preflight", "fit.stage", "fit.build", "chunk", "chunk", "fit.result"]
    assert all([c.name for c in fit.children(s)] == CHUNK_PARTS for s in fit.named("chunk"))
    assert [s.counters["steps"] for s in fit.named("chunk")] == [2, 2]  # 2 blocks of 1 step
    assert not fit.named("block.copy") and (tmp_path / "prof" / "spans.json").is_file()


def test_last_fit_stays_until_the_next_recorded_fit(tmp_path):
    t = _trainer(max_epochs=1, profile_dir=str(tmp_path / "a"))
    t.fit(_dm())
    first = tracing.last_fit()
    t.profile_dir = None
    t.fit(_dm())
    assert tracing.last_fit() is first
    t.profile_dir = str(tmp_path / "b")
    t.fit(_dm())
    assert tracing.last_fit() is not first and tracing.last_fit().id > first.id


# ---------------------------------------------------------------------- #
# The spans on the card, placed and summed: a stand-in clock of events.


class _Clock:
    now = 0.0  # ms on the stand-in card


class _Event:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.t = None

    def record(self):
        self.t = _Clock.now

    def elapsed_time(self, other):
        return other.t - self.t

    def query(self):
        return True


class _Graph:
    def __init__(self, ms):
        self.ms = ms

    def replay(self):
        _Clock.now += self.ms


def test_device_spans_placed_and_summed(monkeypatch):
    """Four chunks of two replays (2 ms and 1 ms, 0.5 ms apart inside a
    chunk, 4 ms of host work between chunks), the card's clock 1 s ahead
    of the host's: the spans land on the host's clock through each
    chunk's anchor, with their sums per chunk; per-replay spans only for
    the first ``KEEP_CHUNKS``; the events are recorded again, not made
    anew."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(tracing, "KEEP_CHUNKS", 2)
    monkeypatch.setattr(tracing.time, "perf_counter_ns", lambda: int((_Clock.now - 1000.0) * 1e6))
    _Clock.now, _Event.made = 1000.0, 0
    rec = tracing.Recorder(torch.device("cuda", 0))
    for i in range(4):
        with tracing._Chunk(rec, "chunk", {"index": i, "epochs": 1, "steps": 2}):
            with tracing._Open(rec, "chunk.issue", None):
                rec.replay(_Graph(2.0), "train step")
                _Clock.now += 0.5
                rec.replay(_Graph(1.0), "val batch")
            rec.read_queued()
            rec.anchor()
        _Clock.now += 4.0
    fit = rec.finish(read=True)
    assert [c.chunk for c in fit.chunks] == [0, 1, 2, 3]
    for i, c in enumerate(fit.chunks):  # chunk i starts 7.5 ms after chunk i - 1
        assert (c.replays, c.first, c.last) == (2, pytest.approx(7.5e6 * i),
                                                pytest.approx(7.5e6 * i + 3.5e6))
        assert c.busy == pytest.approx(3e6) and c.gaps == pytest.approx(0.5e6)
    replays = [s for s in fit.spans if s.name == "replay"]
    assert [s.counters["segment"] for s in replays] == ["train step", "val batch"] * 2
    assert [(s.start, s.end) for s in replays[2:]] == [
        (pytest.approx(7.5e6), pytest.approx(9.5e6)), (pytest.approx(10e6), pytest.approx(11e6))]
    assert all(s.on_card and fit.spans[s.parent].name == "chunk.issue" for s in replays)
    assert _Event.made == 2 * (2 * 2 + 1)  # two chunks' pairs and anchors in flight at most


@pytest.mark.parametrize("card", [True, False], ids=["events", "host_only"])
def test_lead_replays_timed_on_the_host(monkeypatch, card):
    """``chunk.issue``'s ``lead_ns``: the host's time from the chunk's
    first replay to its ``LEAD_REPLAYS + 1``-th (here 2 replays of 2 ms
    and 0.5 ms of host work each). Inside ``host_only`` (torch.profiler's
    block) the same, with no event recorded and nothing on the card."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(tracing, "LEAD_REPLAYS", 2)
    monkeypatch.setattr(tracing.time, "perf_counter_ns", lambda: int(_Clock.now * 1e6))
    _Clock.now, _Event.made = 0.0, 0
    rec = tracing.Recorder(torch.device("cuda", 0))
    with contextlib.nullcontext() if card else rec.host_only():
        with tracing._Chunk(rec, "chunk", {"index": 0, "epochs": 1, "steps": 4}):
            with tracing._Open(rec, "chunk.issue", None) as issue:
                for _ in range(4):
                    rec.replay(_Graph(2.0), "train step")
                    _Clock.now += 0.5
    fit = rec.finish(read=True)
    assert issue.counters == {"lead_replays": 2, "lead_ns": 5_000_000, "replays": 4}
    assert rec.card and (_Event.made > 0) == card
    assert [c.replays for c in fit.chunks] == ([4] if card else [])


def test_extent_leaves_out_the_profilers_events():
    """``_extent`` on a Chrome trace as torch.profiler writes it (an
    event's keys on lines of their own): the span of ``Trace``, the
    profiler's session and CUPTI's notes left out."""
    sys.path.insert(0, str(ROOT))
    from portbench.harness import trace as tr

    events = [{"ph": "X", "cat": "Trace", "ts": 10.0, "dur": 500.0, "pid": "Spans",
               "tid": "PyTorch Profiler", "name": "PyTorch Profiler (0)"},
              {"ph": "X", "cat": "overhead", "name": "Buffer Flush", "pid": 1, "tid": 1,
               "ts": 12.5, "dur": 3.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::zero_ {a}", "pid": 1, "tid": 1,
               "ts": 20.25, "dur": 4.0, "args": {"ts": 1}},
              {"ph": "X", "cat": "kernel", "name": "void k<{lambda()#1}>()", "pid": 0, "tid": 7,
               "ts": 30.0, "dur": 100.5},
              {"ph": "i", "s": "g", "name": "Record Window End", "ts": 900.0},
              {"ph": "X", "cat": "overhead", "name": "Activity Buffer Request", "pid": 1,
               "tid": 1, "ts": 400.0, "dur": 200.0}]
    text = json.dumps({"traceEvents": events}, indent=2).encode()
    assert tracing._extent(text) == tr.Trace(events).span == (20.25, 130.5)
    assert tracing._extent(b'{"traceEvents": []}') is None


# ---------------------------------------------------------------------- #
# On the card.


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_graph_launches_inside_chunk_issue_on_card(tmp_path, monkeypatch):
    dev = _card()
    monkeypatch.setattr(tracing, "LEAD_REPLAYS", 2)  # under an epoch's replays here
    prof = tmp_path / "prof"
    t = _trainer(dev, max_epochs=3, profile_dir=str(prof))
    t.fit(_dm())
    fit = tracing.last_fit()
    per_epoch = t.program.program.graph_launches
    # the profiled chunk 1 records no event: its trace times the card
    assert [(c.chunk, c.replays) for c in fit.chunks] == [(0, per_epoch), (2, per_epoch)]
    chunks = fit.named("chunk")
    assert [s.counters["replays"] for s in chunks] == [per_epoch] * 3
    assert not [s for s in fit.children(fit.children(chunks[1], "chunk.issue")[0]) if s.on_card]
    assert all(fit.children(c, "chunk.issue")[0].counters["lead_replays"] == 2 for c in chunks)
    assert fit.named("chunk.capture")[0].counters["segments"] == len(t.program.program.segments)
    trace = json.loads((prof / "trace.json").read_text())
    launches = [e for e in trace["traceEvents"]
                if e.get("ph") == "X" and e.get("name") == "cudaGraphLaunch"]
    assert len(launches) == per_epoch
    spans = json.loads((prof / "spans.json").read_text())["traceEvents"]
    for events in (trace["traceEvents"], spans):
        (issue,) = [e for e in events if e.get("name") == "chunk.issue"
                    and fit.spans[e["args"]["parent"]].counters["index"] == 1]
        for e in launches:
            assert issue["ts"] - 10 <= e["ts"] and e["ts"] + e["dur"] <= issue["ts"] + issue["dur"] + 10


@pytest.mark.cuda
def test_off_on_card_makes_no_timing_event(monkeypatch):
    dev = _card()
    timing = []
    real = torch.cuda.Event

    def event(*a, **k):
        if k.get("enable_timing"):
            timing.append(k)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", event)
    _trainer(dev, max_epochs=2).fit(_dm())
    assert timing == []


@pytest.mark.cuda
def test_replays_add_launches_to_counters_resolved_at_capture(monkeypatch):
    """K1's launches through graph replays counted as before, with
    ``launch_counters()`` looked up at the capture only: a fit of three
    epochs looks them up as often as a fit of one."""
    dev = _card()
    calls = []
    real = cuda_graph.launch_counters
    monkeypatch.setattr(cuda_graph, "launch_counters", lambda: calls.append(1) or real())
    counters = launch_counters()
    looked_up = []
    for epochs in (1, 3):
        before, n_calls = counters["gyroplane_distances"].count, len(calls)
        t = _trainer(dev, max_epochs=epochs)
        t.fit(_dm())
        ep = t.program.ep
        per_epoch = ep.steps + ep.eval_steps + (1 if ep.rem else 0)
        assert counters["gyroplane_distances"].count - before == epochs * per_epoch
        looked_up.append(len(calls) - n_calls)
    assert looked_up[0] == looked_up[1] > 0
