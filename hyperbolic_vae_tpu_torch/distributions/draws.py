"""The batch-shaped draws of the models' losses and bounds, and the row
window that data parallelism draws them through.

Every draw whose shape holds the batch goes through :func:`randn` or
:func:`rand` with the axis that is the batch's. Outside a window they are
``torch.randn``/``torch.rand``. Inside ``row_window(lo, hi, total)`` (a
rank of a data mesh computing rows [lo, hi) of a ``total``-row batch,
``parallel/data_parallel.py``) each draws the whole batch's shape from
the generator and keeps rows [lo, hi): the rank's draws are the one-card
run's draws of its rows, and its generator advances as the one-card
run's does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch

_state = threading.local()


@contextlib.contextmanager
def row_window(lo: int, hi: int, total: int):
    """Draws made in this block (on this thread) are rows [lo, hi) of the
    ``total``-row batch's draws."""
    before = getattr(_state, "window", None)
    _state.window = (int(lo), int(hi), int(total))
    try:
        yield
    finally:
        _state.window = before


def _draw(fn, shape: Sequence[int], batch_axis: int, generator: Optional[torch.Generator],
          device) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    window = getattr(_state, "window", None)
    if window is None:
        return fn(shape, generator=generator, device=device, dtype=torch.float32)
    lo, hi, total = window
    if shape[batch_axis] != hi - lo:
        raise ValueError(f"a draw of shape {shape} inside a row window of {hi - lo} rows: its "
                         f"batch axis {batch_axis} does not hold them")
    full = shape[:batch_axis] + (total,) + shape[batch_axis + 1:]
    out = fn(full, generator=generator, device=device, dtype=torch.float32)
    return out.narrow(batch_axis, lo, hi - lo)


def randn(shape: Sequence[int], generator: Optional[torch.Generator], device,
          batch_axis: int = 0) -> torch.Tensor:
    """Standard normals of ``shape`` (f32), the batch along ``batch_axis``."""
    return _draw(torch.randn, shape, batch_axis, generator, device)


def rand(shape: Sequence[int], generator: Optional[torch.Generator], device,
         batch_axis: int = 0) -> torch.Tensor:
    """Uniforms on [0, 1) of ``shape`` (f32), the batch along ``batch_axis``."""
    return _draw(torch.rand, shape, batch_axis, generator, device)
