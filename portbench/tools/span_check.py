"""The program's spans (``hyperbolic_vae_tpu_torch/train/tracing.py``)
held against the host clock and the profiler's trace, in one cell:

    python3 portbench/tools/span_check.py --workload NAME --seed N --seconds S [--out DIR]

Set-up as a run of the cell (data, weights, one Trainer, a warm-up fit),
then three fits of S seconds from the same weights, each clocked by a
``ChunkClock`` callback: untraced; the recorder on for every other chunk
(from chunk 1; the two halves' chunk walls compared in the same fit, so
in the same speed state of the card); ``profile_dir`` set (the recorder
on, the second chunk under torch.profiler, as a ``--trace 1`` run has
it); and a short fit with ``profile_dir`` whose recorder records its
events under the profiler too. Prints one JSON object: the five
per-layer metrics read from the spans of the ``profile_dir`` fit; D (the
counted chunks' span on the card) against the host clock's walls of the
same chunks; the host's time a step issuing its replays (``chunk.issue``,
waits for a full launch queue included) against its time over each
chunk's first ``LEAD_REPLAYS`` replays onto an idle card (``lead_ns``)
and the card's time a step; from the short fit, the profiled chunk's
summed replay time against the busy time of its trace, split by the
trace's kernels of each graph launch (their extent, and the gaps inside
it); where the first and last host events of the trace lie inside
``chunk.issue`` and ``chunk.fetch``, and how far each ``cudaGraphLaunch``
lies outside ``chunk.issue`` in ``trace.json`` and in ``spans.json``; the
trace's span and idle gaps with and without the program's spans; the
recorder's cost (the median chunk wall with it on over the median with
it off, chunks 2 on; the traced fit's chunks from 2 on against the same
chunks of the untraced fit); and each chunk's replays on the card (busy,
gaps, the gap before it, the host's issue and lead times). With
``--out``, ``spans.json`` and the per-chunk series are written there.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
READERS = ("launch_gap_pct", "boundary_gap_pct", "issue_ms_per_step", "capture_s", "stage_s")


def _fit(p, seconds: float, profile_dir=None, extra=()):
    from portbench.harness.cell import ChunkClock

    tr = p.trainer
    tr.max_epochs, tr.max_wall_seconds = 10 ** 9, float(seconds)
    tr.profile_dir = profile_dir
    clock = ChunkClock()
    tr.callbacks = [clock, *extra]
    res = tr.fit(p.dm, params=p.params0)
    return res, clock.t


class _Toggle:
    """A callback that turns the recorder ``rec`` on for the next chunk
    when it is off and off when it is on; ``on[i]``: chunk i recorded."""

    def __init__(self, rec):
        self.rec, self.on = rec, []

    def on_fit_start(self, trainer, dm):
        from hyperbolic_vae_tpu_torch.train import tracing

        tracing.current, self.on = None, []

    def on_epoch_end(self, trainer, epoch, live, row):
        from hyperbolic_vae_tpu_torch.train import tracing

        self.on.append(tracing.current is not None)
        tracing.current = None if self.on[-1] else self.rec


@contextlib.contextmanager
def _events_under_profiler():
    """The recorder's events recorded under torch.profiler too (the
    replays of the profiled chunk, for the cross-check with its trace)."""
    from hyperbolic_vae_tpu_torch.train import tracing

    real = tracing.Recorder.host_only
    tracing.Recorder.host_only = lambda self: contextlib.nullcontext()
    try:
        yield
    finally:
        tracing.Recorder.host_only = real


def _lead_ms_per_step(fit, chunk) -> float:
    """The host's time a step over the chunk's first replays (``lead_ns``
    over ``lead_replays``, at the chunk's replays a step), or None."""
    issue = fit.children(chunk, "chunk.issue")[0].counters
    if not issue.get("lead_replays"):
        return None
    return issue["lead_ns"] * 1e-6 / issue["lead_replays"] * issue["replays"] / chunk.counters["steps"]


def _graphs(events) -> dict:
    """The trace's kernels of each graph launch (by correlation id): their
    extent (first start to last end) and their union, summed (ms)."""
    from portbench.harness.trace import covered

    launches = {e["args"].get("correlation") for e in events
                if e.get("name") == "cudaGraphLaunch" and "args" in e}
    by = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launches:
            by[e["args"]["correlation"]].append((e["ts"], e["ts"] + e["dur"]))
    return {"graphs": len(by),
            "extent_ms": sum(max(b for _, b in v) - min(a for a, _ in v) for v in by.values()) / 1e3,
            "busy_ms": sum(covered(v) for v in by.values()) / 1e3}


def _edges(events, span) -> list:
    """µs from ``span``'s start to the first host event that starts inside
    it, and from the last one's end to the span's end (the trace's own
    host events)."""
    lo, hi = span["ts"], span["ts"] + span["dur"]
    inside = [e for e in events if e.get("ph") == "X" and e.get("cat") not in ("program", "Trace")
              and e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset", "overhead")
              and lo <= e["ts"] <= hi]
    if not inside:
        return [None, None]
    return [min(e["ts"] for e in inside) - lo, hi - max(e["ts"] + e["dur"] for e in inside)]


def _outside_us(launches, issue) -> float:
    """The farthest any launch lies outside ``issue`` (µs; 0 inside)."""
    lo, hi = issue["ts"], issue["ts"] + issue["dur"]
    return max(max(lo - e["ts"], e["ts"] + e["dur"] - hi, 0.0) for e in launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from hyperbolic_vae_tpu_torch.train import tracing
    from portbench.harness import cell as cm, spans, spec, trace as trace_mod

    if not torch.cuda.is_available():
        print("span_check: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    p = cm.prepare(cell, args.seed % 2 ** 63, "cuda:0")
    p.trainer.fit(p.dm, params=p.params0)  # warm-up
    untraced, t_u = _fit(p, args.seconds)
    toggle = _Toggle(tracing.Recorder(p.device))
    try:
        _, t_r = _fit(p, args.seconds, extra=[toggle])
    finally:
        tracing.current = None
    toggle.rec.finish(read=True)
    prof = Path(tempfile.mkdtemp(prefix="span-check-"))
    traced, t_t = _fit(p, args.seconds, str(prof))
    torch.cuda.synchronize()
    fit = tracing.last_fit()
    ep = p.trainer.program.ep
    steps = p.trainer.epochs_per_dispatch * ep.steps
    out = {"workload": args.workload, "seed": args.seed, "card": torch.cuda.get_device_name(0),
           "power_limit_w": cm.power_limit_w(0)}

    out["metrics"] = {name: spec.metric_reader(name)(None) for name in READERS}

    counted = spans.counted_device(fit)
    if not counted:
        print(f"span_check: the traced fit stopped before chunk {spans.FIRST}; the trace's export "
              f"ate --seconds {args.seconds}: give more", file=sys.stderr)
        return 1
    d_ns = spans.device_span_ns(counted)
    first, last = counted[0].chunk, counted[-1].chunk
    host_s = t_t[last + 1] - t_t[first]  # the end of the chunk before the first to the last's end
    out["d_vs_host"] = {"d_s": d_ns * 1e-9, "host_s": host_s, "ratio": d_ns * 1e-9 / host_s,
                        "chunks": [first, last]}

    chunk_spans = {c.counters["index"]: c for c in fit.named("chunk")}
    lead = [_lead_ms_per_step(fit, chunk_spans[c.chunk]) for c in counted]
    lead = [v for v in lead if v is not None]
    out["host_ms_per_step"] = {
        "issue": out["metrics"]["issue_ms_per_step"],
        "lead_median": statistics.median(lead) if lead else None,
        "lead_range": [min(lead), max(lead)] if lead else None,
        "card": sum(c.busy for c in counted) * 1e-6 / sum(
            chunk_spans[c.chunk].counters["steps"] for c in counted)}

    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    with_spans = trace_mod.Trace(events)
    without = trace_mod.Trace([e for e in events if e.get("cat") != "program"])
    out["profiled_trace"] = {
        "busy_ms_per_step": without.busy_us() * 1e-3 / steps,
        "idle_share": 1 - without.busy_us() / without.window_us,
        "span_us": [without.window_us, with_spans.window_us],
        "span_change": with_spans.window_us / without.window_us - 1,
        "idle_gaps_before": trace_mod.breakdown(without)["idle_gaps"][:6],
        "idle_gaps_after": trace_mod.breakdown(with_spans)["idle_gaps"][:6]}
    launches = [e for e in events if e.get("ph") == "X" and e.get("name") == "cudaGraphLaunch"]
    spans_json = json.loads((prof / "spans.json").read_text())["traceEvents"]
    of_1 = lambda evs, name: next(  # noqa: E731
        e for e in evs if e.get("name") == name
        and fit.spans[e["args"]["parent"]].counters["index"] == 1)
    issue = of_1(spans_json, "chunk.issue")  # as recorded; trace.json's is cut to the trace
    out["launches_outside_issue_us"] = {
        "launches": len(launches),
        "trace.json": _outside_us(launches, of_1(events, "chunk.issue")) if launches else None,
        "spans.json": _outside_us(launches, issue) if launches else None}
    out["edges_us"] = {"issue": _edges(events, issue),
                       "fetch": _edges(events, of_1(spans_json, "chunk.fetch")),
                       "issue_last_launch": (issue["ts"] + issue["dur"]
                                             - max(e["ts"] + e["dur"] for e in launches))
                       if launches else None}

    per_sample = p.trainer.program.samples_per_epoch * p.trainer.epochs_per_dispatch
    n = min(len(t_u), len(t_t)) - 1  # chunks both fits ran
    rate = lambda t: per_sample * (n - 2) / (t[n] - t[2])  # noqa: E731
    walls = [b - a for a, b in zip(t_r, t_r[1:])]
    on = [w for i, w in enumerate(walls) if i >= 2 and toggle.on[i]]
    off = [w for i, w in enumerate(walls) if i >= 2 and not toggle.on[i]]
    out["recorder_cost"] = {
        "interleaved": {"chunks_on": len(on), "chunks_off": len(off),
                        "median_wall_s": [statistics.median(on), statistics.median(off)],
                        "ratio": statistics.median(on) / statistics.median(off)},
        "traced_vs_untraced": {"chunks": [2, n - 1], "untraced": rate(t_u), "traced": rate(t_t),
                               "ratio": rate(t_t) / rate(t_u)},
        "program_rate": [untraced.samples_per_sec, traced.samples_per_sec]}

    host_issue = {c.counters["index"]: fit.children(c, "chunk.issue")[0] for c in fit.named("chunk")}
    series, prev = [], None
    for c in fit.chunks:
        issue = host_issue[c.chunk]
        series.append({"chunk": c.chunk, "t_s": (c.first - fit.chunks[0].first) * 1e-9,
                       "busy_ms": c.busy * 1e-6, "gaps_ms": c.gaps * 1e-6,
                       "boundary_ms": None if prev is None else (c.first - prev.last) * 1e-6,
                       "issue_ms": (issue.end - issue.start) * 1e-6, "replays": c.replays,
                       "lead_ms_per_step": _lead_ms_per_step(fit, chunk_spans[c.chunk])})
        prev = c
    out["chunks"] = len(series)

    # the profiled chunk's replays on the card against its trace: a short fit
    prof2 = Path(tempfile.mkdtemp(prefix="span-check-"))
    with _events_under_profiler():
        _fit(p, 4.0, str(prof2))
    fit2 = tracing.last_fit()
    events2 = json.loads((prof2 / "trace.json").read_text())["traceEvents"]
    busy2 = trace_mod.Trace([e for e in events2 if e.get("cat") != "program"]).busy_us()
    c1 = next(c for c in fit2.chunks if c.chunk == 1)
    out["profiled_chunk"] = {
        "replay_ms_per_step": c1.busy * 1e-6 / steps, "busy_ms_per_step": busy2 * 1e-3 / steps,
        "ratio": (c1.busy * 1e-3) / busy2, "replays_ms": c1.busy * 1e-6,
        "replay_gaps_ms": c1.gaps * 1e-6, **_graphs(events2)}
    shutil.rmtree(prof2, ignore_errors=True)
    brief = series[:4] + series[4::max(1, len(series) // 12)]
    out["series"] = [{k: (round(v, 4) if isinstance(v, float) else v) for k, v in s.items()}
                     for s in brief]
    if args.out:
        o = Path(args.out)
        o.mkdir(parents=True, exist_ok=True)
        shutil.copy(prof / "spans.json", o / f"spans_{args.workload}_{args.seed}.json")
        (o / f"series_{args.workload}_{args.seed}.json").write_text(json.dumps(series))
    shutil.rmtree(prof, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
