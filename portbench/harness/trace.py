"""Reading a torch.profiler Chrome trace (the Trainer's ``trace.json`` of
its second chunk).

Device operations are the complete events of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``. The profiler's own events are its
session span (``PyTorch Profiler (n)``, the category ``Trace``) and
CUPTI's notes of its work and of the host's waits (the category
``overhead``: ``Activity Buffer Request``, ``Buffer Flush``, ``Command
Buffer Full``); host events are the other complete events, the
program's (the profiler's one ``cudaDeviceSynchronize`` at its stop,
some 0.2 ms after the chunk's fetch, among them). The traced window spans the first start to the last end of
a device operation or a host event, so the profiler's session and its
flushes before and after the chunk stay out of it. Busy time is the
union of the device operations' intervals, so kernels that overlap (two
streams, programmatic dependent launch) count once; an idle gap is a
stretch of the window that no device operation covers, named by the
innermost host event under its middle, and by CUPTI's note there too
where one runs (a buffer flush inside the chunk stalls the host's
launches: the profiler's stretch).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROFILER_CATS = ("overhead", "Trace")
PROFILER_NAMES = ("PyTorch Profiler",)
Interval = Tuple[float, float]  # microseconds


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals as sorted, disjoint intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(intervals: Iterable[Interval]) -> float:
    """Microseconds covered by the union of intervals."""
    return sum(e - s for s, e in union(intervals))


class Trace:
    """The events of one trace: ``device`` and ``profiler`` [(name,
    start, end, cat)], ``host`` [(name, start, end)], times in
    microseconds."""

    def __init__(self, events: Sequence[dict]):
        self.device, self.host, self.profiler = [], [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"])
            e = s + float(ev["dur"])
            name, cat = ev.get("name", ""), ev.get("cat")
            if cat in DEVICE_CATS:
                self.device.append((name, s, e, cat))
            elif cat in PROFILER_CATS or name.startswith(PROFILER_NAMES):
                self.profiler.append((name, s, e, cat))
            else:
                self.host.append((name, s, e))
        ends = [e for _, _, e, _ in self.device] + [e for _, _, e in self.host]
        starts = [s for _, s, _, _ in self.device] + [s for _, s, _ in self.host]
        self.span = (min(starts), max(ends)) if starts else (0.0, 0.0)

    @classmethod
    def load(cls, path: Path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_us(self) -> float:
        return self.span[1] - self.span[0]

    def busy_us(self) -> float:
        return covered((s, e) for _, s, e, _ in self.device)

    def kernels(self, names: Sequence[str] = ()) -> list:
        """Kernel events, or those whose name contains one of ``names``."""
        ks = [ev for ev in self.device if ev[3] == "kernel"]
        if not names:
            return ks
        return [ev for ev in ks if any(n in ev[0] for n in names)]

    def by_name(self) -> List[Tuple[str, float]]:
        """(name, microseconds summed) of every device operation, largest first."""
        sums: dict = {}
        for name, s, e, _ in self.device:
            sums[name] = sums.get(name, 0.0) + (e - s)
        return sorted(sums.items(), key=lambda kv: -kv[1])

    def gaps(self) -> List[Interval]:
        """The stretches of the window no device operation covers, longest first."""
        out, t = [], self.span[0]
        for s, e in union((s, e) for _, s, e, _ in self.device):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.span[1] > t:
            out.append((t, self.span[1]))
        return sorted(out, key=lambda g: g[0] - g[1])

    def host_at(self, t: float, events=None) -> str:
        """The innermost (shortest) host event (or of ``events``) running
        at ``t``, or "none"."""
        best = None
        for name, s, e in self.host if events is None else events:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "none"

    def gap_name(self, t: float) -> str:
        """What the host was doing at ``t``: its innermost event, and
        CUPTI's note where one runs then."""
        name = f"host: {self.host_at(t)[:120]}"
        note = self.host_at(t, [ev[:3] for ev in self.profiler if ev[3] == "overhead"])
        return name if note == "none" else f"{name}, overhead: {note[:30]}"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The traced window's ``device_ops`` (the operations that took most
    time, [name, seconds]) and ``idle_gaps`` (the longest gaps, named by
    what the host was doing, [name, seconds])."""
    ops = [[name[:160], us * 1e-6] for name, us in trace.by_name()[:top]]
    gaps = [[trace.gap_name((s + e) / 2), (e - s) * 1e-6] for s, e in trace.gaps()[:top]]
    return {"device_ops": ops, "idle_gaps": gaps}
