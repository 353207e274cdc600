"""Graceful stops: preemption signals as a polled flag.

Port of ``hyperbolic_vae_tpu/train/preemption.py``. With
``Trainer(preempt_signals=(signal.SIGTERM,))`` the handlers are installed
while a fit (``fit``, ``fit_ensemble``, ``fit_lane_sweep``) runs; the fit
checks the flag at chunk boundaries, saves its resume state (with a
``checkpoint_dir``) and returns with ``TrainResult.interrupted=True``. A
later ``fit(resume=True)`` continues bit for bit. ``max_wall_seconds`` is
the same stop on a time budget.
"""

from __future__ import annotations

import signal
from typing import Sequence


class GracefulShutdown:
    """Context manager that turns the given signals into a flag
    (``triggered``, ``signum``) instead of the process's death. The
    previous handlers come back on exit. Python runs signal handlers on
    the main thread only: enter this on the thread that runs the fit."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.triggered = False
        self.signum = None
        self._prev = {}

    def _handler(self, signum, frame):
        del frame
        self.triggered = True
        self.signum = signum

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False
