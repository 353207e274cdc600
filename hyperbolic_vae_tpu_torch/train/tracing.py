"""Spans of a fit on the host's clock and the card's: the port's one span
recorder.

Process-wide, as the kernels' launch counters are, and off by default:
``Trainer.fit`` and ``fit_streamed`` record while ``profile_dir`` is set
(``recording``). Off, each instrumented site tests ``current`` (None) and
does nothing else: no CUDA event, no allocation. On, the spans stay in
memory; at the fit's end ``profile_dir/spans.json`` gets every one, and
``last_fit()`` keeps the fit in the process until the next recorded fit
starts. A fit's spans, by parent:

  fit
    fit.preflight, fit.stage (both splits), fit.build (``_Run``: the
    optimizer and the chunk or streamed program)
    chunk (``index``, ``epochs`` and ``steps`` it issued), one a chunk
      chunk.issue: the host queueing the chunk's graph replays, waits
        for a full launch queue included (``lead_ns``: the host's time
        over its first ``lead_replays`` replays, issued onto an idle card)
        chunk.capture (``segments``): the first chunk's warm-up passes
          and captures (``train/cuda_graph.py``)
        replay (``segment``): one a graph replay, timed on the card
        block.copy, block.compute: a streamed fit's block copies and its
          blocks' and val passes' compute, timed on the card
      chunk.fetch: the chunk's metrics to the host (it waits for the card)
      chunk.absorb, chunk.checkpoint (the best weights), chunk.callbacks,
      chunk.stop (the external-stop check and the resume state)
    fit.result: the last checkpoints and the result's assembly

Host spans are ``time.perf_counter_ns`` at their boundaries, with the
counters taken there: graph replays and each hand-written kernel's
launches (``ops.launch_counters()``), as deltas over the span. A span on
the card is a pair of timing events on the current stream around the
work; the events of a chunk are placed on the host's clock by an anchor
event recorded when the card is idle (after the previous chunk's fetch;
the first chunk's after a synchronise), and are read while the card runs
the next chunk, after its replays are queued and before its fetch waits.
Per-replay intervals are kept for the first ``KEEP_CHUNKS`` chunks, and
for every chunk their sums (``ChunkDevice``). Under torch.profiler
(``host_only``) no event is recorded: the trace times the card. All times
are nanoseconds on ``perf_counter_ns``'s clock; ``Fit.clock`` pairs it
with the wall clock, on which torch.profiler's ``trace.json`` counts
(``baseTimeNanoseconds``). ``merge_trace`` writes the host spans of a
profiled block into that trace.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import itertools
import json
import os
import re
import time
from pathlib import Path
from typing import List, Optional

import torch

from hyperbolic_vae_tpu_torch.ops import launch_counters

KEEP_CHUNKS = 4  # chunks whose per-replay intervals are kept (capture, profiled, two more)
LEAD_REPLAYS = 8  # a chunk's first replays, timed on the host before the launch queue can fill
HOST_TID, DEVICE_TID, COPY_TID = 1, 2, 3  # spans.json's tracks

current: Optional["Recorder"] = None  # the recording of the running fit, or None (off)
_last: Optional["Fit"] = None
_ids = itertools.count(1)
OFF = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    id: int
    name: str
    parent: Optional[int]
    start: float  # ns on perf_counter_ns's clock
    end: Optional[float] = None
    counters: dict = dataclasses.field(default_factory=dict)
    on_card: bool = False  # timed on the card (by CUDA events)


@dataclasses.dataclass
class ChunkDevice:
    """One chunk's graph replays on the card, summed (ns, host clock)."""

    chunk: int  # the chunk's index in the fit
    span: int  # the chunk span's id
    replays: int
    first: float  # the first replay's start
    last: float  # the last replay's end
    busy: float  # the replays' device time
    gaps: float  # from one replay's end to the next one's start, inside the chunk


@dataclasses.dataclass
class Fit:
    id: int
    clock: tuple  # (perf_counter_ns, time_ns) read together
    spans: List[Span] = dataclasses.field(default_factory=list)
    chunks: List[ChunkDevice] = dataclasses.field(default_factory=list)
    base_ns: Optional[int] = None  # trace.json's baseTimeNanoseconds, once merged

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, span: Span, name: Optional[str] = None) -> List[Span]:
        return [s for s in self.spans if s.parent == span.id and (name is None or s.name == name)]


def last_fit() -> Optional[Fit]:
    """The last recorded fit of this process (None before one, and while
    the next one records)."""
    return _last


def _clock() -> tuple:
    p0 = time.perf_counter_ns()
    wall = time.time_ns()
    return ((p0 + time.perf_counter_ns()) // 2, wall)


class _Batch:
    """A chunk's spans on the card, waiting to be read: (name, parent,
    start event, end event, tag) in the order they were queued."""

    __slots__ = ("chunk", "span", "anchor", "pending")

    def __init__(self, chunk: int, span: int, anchor):
        self.chunk, self.span, self.anchor, self.pending = chunk, span, anchor, []


class _Open:
    __slots__ = ("rec", "name", "counters", "span")

    def __init__(self, rec, name, counters):
        self.rec, self.name, self.counters = rec, name, counters

    def __enter__(self):
        self.span = self.rec.begin(self.name, self.counters)
        return self.span

    def __exit__(self, *exc):
        self.rec.end(self.span)


class _Chunk(_Open):
    def __enter__(self):
        self.span = self.rec.begin_chunk(self.counters)
        return self.span

    def __exit__(self, *exc):
        self.rec.end_chunk(self.span)


class _OnDevice:
    __slots__ = ("rec", "name", "tag", "start")

    def __init__(self, rec, name, tag):
        self.rec, self.name, self.tag = rec, name, tag

    def __enter__(self):
        self.start = self.rec._event()
        self.start.record()

    def __exit__(self, *exc):
        end = self.rec._event()
        end.record()
        self.rec._queue(self.name, self.start, end, self.tag)


class Recorder:
    """The spans of one fit (``recording`` makes one; the program's sites
    reach it as ``current``)."""

    def __init__(self, device):
        self.fit = Fit(next(_ids), _clock())
        self.device = torch.device(device)
        self.card = self.device.type == "cuda"  # record events (off under torch.profiler)
        self._counters = tuple(launch_counters().items())
        self._replays = 0
        self._stack: list = []  # (open span, counters at its start)
        self._free: list = []  # timing events to record again
        self._anchor = None  # (event, host ns) of the latest anchor
        self._in_chunk = 0  # replays of the open chunk so far
        self._lead_t0 = 0  # host ns at the open chunk's first replay
        self._open: Optional[_Batch] = None
        self._queued: List[_Batch] = []

    # ---- host spans -----------------------------------------------------

    def _snap(self) -> tuple:
        return (self._replays,) + tuple(c.count for _, c in self._counters)

    def begin(self, name: str, counters: Optional[dict] = None) -> Span:
        parent = self._stack[-1][0].id if self._stack else None
        span = Span(len(self.fit.spans), name, parent, time.perf_counter_ns(),
                    counters=dict(counters or {}))
        self.fit.spans.append(span)
        self._stack.append((span, self._snap()))
        return span

    def end(self, span: Span) -> None:
        """End ``span``, the innermost open one (spans nest as the blocks do)."""
        span.end = time.perf_counter_ns()
        _, before = self._stack.pop()
        delta = [b - a for a, b in zip(before, self._snap())]
        span.counters["replays"] = delta[0]
        span.counters.update((name, d) for (name, _), d in zip(self._counters, delta[1:]) if d)

    # ---- chunks and their spans on the card -----------------------------

    def begin_chunk(self, counters: dict) -> Span:
        span = self.begin("chunk", counters)
        self._in_chunk = 0
        if self.card:
            if self._anchor is None:  # the first chunk: the card made idle
                torch.cuda.synchronize(self.device)
                self.anchor()
            self._open = _Batch(counters["index"], span.id, self._anchor)
            self._anchor = None
        return span

    def end_chunk(self, span: Span) -> None:
        self.end(span)
        if self._open is not None:
            self._queued.append(self._open)
            self._open = None

    def anchor(self) -> None:
        """An event that places the next chunk's events on the host's
        clock: recorded when the card is idle (after a fetch), so it runs
        as it is queued."""
        if self.card:
            ev = self._event()
            t = time.perf_counter_ns()
            ev.record()
            self._anchor = (ev, t)

    def _event(self):
        return self._free.pop() if self._free else torch.cuda.Event(enable_timing=True)

    def _queue(self, name, start, end, tag) -> None:
        if self._open is not None:
            parent = self._stack[-1][0].id if self._stack else None
            self._open.pending.append((name, parent, start, end, tag))
        else:  # outside a chunk: not placed
            self._free += [start, end]

    def replay(self, graph, segment: str) -> None:
        """``graph.replay()`` (of the segment called ``segment``) between
        two timing events. The host's time from a chunk's first replay to
        its ``LEAD_REPLAYS + 1``-th goes on the open ``chunk.issue``."""
        if self._in_chunk <= LEAD_REPLAYS:
            self._lead(time.perf_counter_ns())
        self._in_chunk += 1
        self._replays += 1
        if not self.card:
            graph.replay()
            return
        start = self._event()
        start.record()
        graph.replay()
        end = self._event()
        end.record()
        self._queue("replay", start, end, segment)

    def _lead(self, t: int) -> None:
        if self._in_chunk == 0:
            self._lead_t0 = t
        elif self._in_chunk == LEAD_REPLAYS and self._stack:
            issue = self._stack[-1][0]
            if issue.name == "chunk.issue":
                issue.counters.update(lead_replays=LEAD_REPLAYS, lead_ns=t - self._lead_t0)

    def on_device(self, name: str, tag=None):
        return _OnDevice(self, name, tag) if self.card else OFF

    @contextlib.contextmanager
    def host_only(self):
        """Host spans only inside (torch.profiler's block: the trace times
        the card, and an event recorded there would be traced too)."""
        card, self.card = self.card, False
        try:
            yield
        finally:
            self.card = card

    def read_queued(self) -> None:
        """The queued chunks' spans on the card, placed and summed (their
        events done: each chunk was fetched)."""
        for batch in self._queued:
            self._read(batch)
        self._queued = []

    def _read(self, batch: _Batch) -> None:
        a, t_a = batch.anchor
        keep = batch.chunk < KEEP_CHUNKS
        n = 0
        first = last = busy = gaps = 0.0
        for name, parent, e0, e1, tag in batch.pending:
            if name != "replay" and not e1.query():  # another stream's work (a copy)
                e1.synchronize()
            s = t_a + a.elapsed_time(e0) * 1e6
            e = t_a + a.elapsed_time(e1) * 1e6
            if name == "replay":
                if n:
                    gaps += s - last
                else:
                    first = s
                busy += e - s
                last = e
                n += 1
            if keep:
                counters = {} if tag is None else {"segment" if name == "replay" else "what": tag}
                self.fit.spans.append(Span(len(self.fit.spans), name, parent, s, e, counters,
                                           on_card=True))
            self._free += [e0, e1]
        self._free.append(a)
        if n:
            self.fit.chunks.append(ChunkDevice(batch.chunk, batch.span, n, first, last, busy, gaps))

    # ---- the profiled block ---------------------------------------------

    def sample_clock(self) -> None:
        self.fit.clock = _clock()

    def wall_us(self, ns: float, base: int) -> float:
        perf, wall = self.fit.clock
        return (ns - perf + wall - base) / 1e3

    def merge_trace(self, path: Path, t0: int, t1: int) -> None:
        """Write the host spans that lie wholly inside [t0, t1] (the
        profiled block) into torch.profiler's Chrome trace at ``path``, as
        complete events of the category ``program`` on the trace's time
        base (``ts`` in microseconds after ``baseTimeNanoseconds`` on the
        wall clock), each cut to the trace's own events (``_extent``), so
        that the trace's span stays as the profiler recorded it; a cut
        span's ``args`` give its ``host_ts`` and ``host_dur``."""
        path = Path(path)
        data = path.read_bytes()
        head = data[:1 << 16].decode("utf-8", "replace")
        m = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
        base = int(m.group(1)) if m else 0
        self.fit.base_ns = base
        spans = [s for s in self.fit.spans
                 if not s.on_card and s.end is not None and s.start >= t0 and s.end <= t1]
        at = re.search(r'"traceEvents"\s*:\s*\[', head)
        if not spans or at is None:
            return
        lo, hi = _extent(data) or (-float("inf"), float("inf"))
        events = []
        for s in spans:
            ev = self._json(s, base, HOST_TID)
            ts, end = max(ev["ts"], lo), min(ev["ts"] + ev["dur"], hi)
            if end <= ts:
                continue
            if (ts, end) != (ev["ts"], ev["ts"] + ev["dur"]):
                ev["args"].update(host_ts=ev["ts"], host_dur=ev["dur"])
                ev["ts"], ev["dur"] = ts, end - ts
            events.append(ev)
        if not events:
            return
        rest = head[at.end():].lstrip()
        text = ", ".join(json.dumps(ev) for ev in events)
        text += "" if rest.startswith("]") else ", "
        cut = len(head[:at.end()].encode("utf-8"))
        tmp = path.with_name(path.name + ".merging")
        with open(tmp, "wb") as dst:
            dst.write(data[:cut])
            dst.write(text.encode("utf-8"))
            dst.write(memoryview(data)[cut:])
        os.replace(tmp, path)

    def _json(self, s: Span, base: int, tid: int) -> dict:
        ts = self.wall_us(s.start, base)
        return {"ph": "X", "cat": "program", "name": s.name, "pid": os.getpid(), "tid": tid,
                "ts": ts, "dur": self.wall_us(s.end, base) - ts,
                "args": dict(s.counters, span=s.id, parent=s.parent, fit=self.fit.id)}

    # ---- the end ---------------------------------------------------------

    def finish(self, read: bool) -> Fit:
        """With ``read`` (the fit ended cleanly), read every chunk's spans on
        the card."""
        if read and self._queued:
            torch.cuda.synchronize(self.device)
            self.read_queued()
        self._queued, self._free, self._anchor = [], [], None
        return self.fit

    def write(self, path: Path) -> None:
        """Every span as a Chrome trace (host, card and copy tracks), on
        ``trace.json``'s time base where one was merged; each chunk's
        replays on the card summed in a ``chunk.device`` span."""
        fit = self.fit
        base = fit.base_ns if fit.base_ns is not None else fit.clock[1] // 10 ** 9 * 10 ** 9
        pid = os.getpid()
        events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": name}}
                  for tid, name in ((HOST_TID, "program: host"), (DEVICE_TID, "program: card"),
                                    (COPY_TID, "program: card copies"))]
        for s in fit.spans:
            if s.end is not None:
                tid = (COPY_TID if s.name == "block.copy" else DEVICE_TID) if s.on_card else HOST_TID
                events.append(self._json(s, base, tid))
        for c in fit.chunks:
            ts = self.wall_us(c.first, base)
            events.append({"ph": "X", "cat": "program", "name": "chunk.device", "pid": pid,
                           "tid": DEVICE_TID, "ts": ts, "dur": self.wall_us(c.last, base) - ts,
                           "args": {"chunk": c.chunk, "span": c.span, "replays": c.replays,
                                    "busy_us": c.busy / 1e3, "gaps_us": c.gaps / 1e3,
                                    "fit": fit.id}})
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"traceEvents": events, "baseTimeNanoseconds": base,
                                    "displayTimeUnit": "ms"}))


_TS_DUR = re.compile(rb'"ts"\s*:\s*(-?[0-9.eE+]+)\s*,\s*"dur"\s*:\s*(-?[0-9.eE+]+)')
_PROFILER_CAT = re.compile(rb'"cat"\s*:\s*"(?:Trace|overhead)"')


def _extent(data: bytes) -> Optional[tuple]:
    """The first start and the last end (µs) of the complete events of a
    Chrome trace from torch.profiler, the profiler's own left out (its
    session, category ``Trace``, and CUPTI's notes, ``overhead``, whose
    ``"ts"`` and ``"dur"`` follow their ``"cat"``), or None. The text is
    scanned, not parsed: a trace of a step graph's replays holds ~10^5
    kernels."""
    found = list(_TS_DUR.finditer(data))
    at = [m.start() for m in found]
    own = {bisect.bisect_left(at, m.end()) for m in _PROFILER_CAT.finditer(data)}
    lo = hi = None
    for i, m in enumerate(found):
        if i in own:
            continue
        s = float(m.group(1))
        e = s + float(m.group(2))
        lo = s if lo is None or s < lo else lo
        hi = e if hi is None or e > hi else hi
    return None if lo is None else (lo, hi)


# ---- the sites' entry points: each a test of ``current`` when off --------


@contextlib.contextmanager
def recording(device, out_dir=None):
    """Record the spans of the work inside (one fit) on ``device``; at the
    end ``last_fit()`` holds them and, with ``out_dir``, so does
    ``out_dir/spans.json``. Inside another recording, that one records."""
    global current, _last
    if current is not None:
        yield current
        return
    _last = None
    rec = current = Recorder(device)
    ok = False
    try:
        yield rec
        ok = True
    finally:
        current = None
        _last = rec.finish(read=ok)
        if out_dir:
            rec.write(Path(out_dir) / "spans.json")


def span(name: str, counters: Optional[dict] = None):
    """A host span around the block, starting with ``counters`` (``OFF``
    when not recording)."""
    rec = current
    return OFF if rec is None else _Open(rec, name, counters)


def chunk(index: int, epochs: int, steps: int):
    """The ``chunk`` span of a fit's chunk ``index``, which issues
    ``epochs`` epochs of ``steps`` train steps in all."""
    rec = current
    return OFF if rec is None else _Chunk(rec, "chunk",
                                          {"index": index, "epochs": epochs, "steps": steps})


def on_device(name: str, tag=None):
    """A span on the card around the work the block queues on the current
    stream (``OFF`` when not recording or on the CPU)."""
    rec = current
    return OFF if rec is None else rec.on_device(name, tag)
