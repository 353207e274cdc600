"""Run a program of pieces as captured CUDA graphs on the card.

The counterpart of JAX's ``jit`` around the chunk program's
``lax.scan``. A program is a list of :class:`Segment`: a tuple of pieces
(zero-argument callables that read and write tensors allocated before
capture, with no host sync) replayed ``repeat`` times in a row. On a CUDA
device each segment becomes one ``torch.cuda.CUDAGraph`` at the first
``run()``:

  1. warm-up: every segment's pieces run once, in order, on a side
     stream (PyTorch's recipe for whole-network capture: lazy allocations,
     the autograd engine's and cuBLAS's set-up), after which every tensor
     in ``state``, the generator and the kernels' launch counters are put
     back as they were; three such passes, so the warm-up leaves no trace
     (device counters in ``state`` stay in range);
  2. capture: each segment is captured into its own graph, with the
     program's ``torch.Generator`` registered, so the permutation and the
     eps draws advance on every replay as the eager calls would; a kernel
     wrapper's launch counter goes up once per captured launch while the
     capture runs, which is taken back and added on every replay instead
     (to the counter objects resolved at the capture).
     ``capture_stream`` (a sweep's lane stream) captures on that stream,
     so that the graphs of two lanes, replayed at once on their own
     streams, never share cuBLAS's per-stream workspace; each graph has
     its own memory pool. ``capture_error_mode`` is
     ``torch.cuda.graph``'s ("thread_local" where another thread, NCCL's
     watchdog, may query the card meanwhile). Python's cyclic garbage collector is held off
     during the capture: a collection there can destroy a dead program's
     graphs, which invalidates the capture in progress
     (``torch.cuda.graph`` no longer collects before it captures).

While a fit records its spans (``train/tracing.py``), the captures are
its ``chunk.capture`` span and each replay a ``replay`` span timed on the
card. A capture that fails raises: the program never falls back to running the
pieces eagerly. On the CPU, or inside :func:`run_eagerly` (the eager run
of the same program, for comparison), ``run()`` calls the pieces in the
same order without graphs.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from hyperbolic_vae_tpu_torch.ops import launch_counters
from hyperbolic_vae_tpu_torch.train import tracing

_EAGER = False
WARMUP_PASSES = 3


@contextlib.contextmanager
def run_eagerly():
    """Programs built inside this block run their pieces without graphs,
    also on a CUDA device: the eager run that a graphed one is compared
    with."""
    global _EAGER
    before, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = before


@contextlib.contextmanager
def no_collection():
    """Around a CUDA graph capture: no automatic garbage collection until
    the block ends (dead cycles wait until then)."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


class Segment(NamedTuple):
    pieces: tuple
    repeat: int
    name: str


def _counts() -> Dict[str, int]:
    return {name: c.count for name, c in launch_counters().items()}


def _set_counts(counts: Dict[str, int]) -> None:
    for name, c in launch_counters().items():
        c.reset()
        c.add(counts[name])


class GraphedProgram:
    """``segments`` run in order by ``run()``; ``state`` lists the tensors
    that a warm-up pass must leave unchanged (parameters, optimizer state,
    controllers); ``generator`` is the program's only source of draws.
    Graphed on a CUDA device unless built inside ``run_eagerly()``."""

    def __init__(self, segments: Sequence[Segment], *, device: torch.device,
                 generator: torch.Generator, state: Sequence[torch.Tensor],
                 capture_stream: Optional[torch.cuda.Stream] = None,
                 capture_error_mode: str = "global"):
        self.segments = [s for s in segments if s.repeat > 0 and s.pieces]
        self.device = torch.device(device)
        self.generator = generator
        self.state = list(state)
        self.graphed = self.device.type == "cuda" and not _EAGER
        self.capture_stream = capture_stream
        self.capture_error_mode = capture_error_mode
        self._graphs: Optional[List[tuple]] = None

    @property
    def graph_launches(self) -> int:
        """Graph replays in one ``run()`` (0 when eager)."""
        return sum(s.repeat for s in self.segments) if self.graphed else 0

    def run(self) -> None:
        for _ in self.replays():
            pass

    def replays(self):
        """``run()`` one segment replay at a time: each ``next()`` queues
        one more."""
        for i, seg in enumerate(self.segments):
            for _ in range(seg.repeat):
                self._replay(i)
                yield

    def replay(self, name: str) -> None:
        """The segment called ``name`` once (one graph replay, its launches
        counted; its pieces when eager): to time a part of the program."""
        self._replay(next(i for i, s in enumerate(self.segments) if s.name == name))

    def capture(self) -> None:
        """Capture the segments now (else the first ``run()`` does); a
        no-op when eager. A sweep captures every lane before it replays
        any, since a capture waits for the whole card."""
        if self.graphed and self._graphs is None:
            self._graphs = self._capture()

    def _replay(self, i: int) -> None:
        if not self.graphed:
            for piece in self.segments[i].pieces:
                piece()
            return
        self.capture()
        graph, added = self._graphs[i]
        rec = tracing.current
        if rec is None:
            graph.replay()
        else:
            rec.replay(graph, self.segments[i].name)
        for counter, n in added:
            counter.add(n)

    def _snapshot(self):
        return ([t.detach().clone() for t in self.state], self.generator.get_state(), _counts())

    def _restore(self, snap) -> None:
        tensors, gen_state, counts = snap
        with torch.no_grad():
            for t, s in zip(self.state, tensors):
                t.copy_(s)
        self.generator.set_state(gen_state)
        _set_counts(counts)

    def _capture(self) -> List[tuple]:
        with tracing.span("chunk.capture", {"segments": len(self.segments)}):
            return self._capture_segments()

    def _capture_segments(self) -> List[tuple]:
        snap = self._snapshot()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_PASSES):
                for seg in self.segments:
                    for piece in seg.pieces:
                        piece()
                self._restore(snap)
        current.wait_stream(side)
        graphs = []
        counters = launch_counters()  # added to on every replay
        with no_collection():
            for seg in self.segments:
                graph = torch.cuda.CUDAGraph()
                graph.register_generator_state(self.generator)
                before = _counts()
                try:
                    with torch.cuda.graph(graph, stream=self.capture_stream,
                                          capture_error_mode=self.capture_error_mode):
                        for piece in seg.pieces:
                            piece()
                except Exception as e:
                    raise RuntimeError(f"CUDA graph capture of {seg.name!r} failed: {e}") from e
                after = _counts()
                _set_counts(before)
                graphs.append((graph, tuple((counters[k], after[k] - before[k]) for k in after
                                            if after[k] != before[k])))
        self._restore(snap)
        return graphs

