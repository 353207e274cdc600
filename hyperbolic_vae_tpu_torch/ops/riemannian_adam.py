"""Riemannian Adam and the finite guard as one kernel pair
(``csrc/riemannian_adam.cu``).

No Pallas kernel of the JAX package corresponds to it (XLA fuses JAX's
optax update into the jitted step). It replaces, on the card, the op
sequence of ``optim/riemannian_adam.py`` (~20 ATen launches a tensor) and
the guard's sum of squares in ``train/epoch_program.train_step`` (~3 a
tensor): ~500 launches of the flagship's step become 2.

  * ``takes(params, moment_dtype, ema_decay)``: the dispatch rule
    ``RiemannianAdam`` applies once, at construction: every parameter an
    f32 tensor on one CUDA device, f32 moments, no EMA. Anything else
    keeps the op sequence.
  * ``segment_table(optimizer)``: the table the kernels walk, as numpy
    records: a segment a parameter (data, exp_avg, exp_avg_sq pointers,
    size, row width of a ball point, group, the offset of its ball rows'
    scratch), the groups (lr's pointer, betas, 1 - betas, eps, weight
    decay in f32) and the tiles, a block each (a segment's elements
    [start, start + len)): a long tensor takes many tiles of
    ``TILE_ELEMS`` elements, a short one a tile of its own, ball rows
    (of any width) tiles of ``ROW_TILE`` rows (a thread a row).
    Raises on what the kernel does not take: a non-contiguous tensor.
  * ``KernelStep``: the table in device memory (built once; parameters and
    moments keep their addresses, so it holds under CUDA graph capture),
    the scratch, and ``__call__(guard=loss | ok=tensor | neither)``, which
    launches the pair on the current stream with each parameter's ``.grad``
    (each kernel once a batch of ``MAX_TENSORS`` gradients) and counts one
    step of the pair in ``launches``. Where a parameter, moment, lr or
    group setting changed since the table was built, the table is rebuilt
    (outside a capture) or the call raises (inside one).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.nn.layers import is_manifold_param
from hyperbolic_vae_tpu_torch.ops.gyroplane import LaunchCounter

TILE_ELEMS = 4096  # elements of a tile at most (256 threads x 4 runs of 4)
ROW_TILE = 256     # ball rows of a tile: a thread a row
MAX_TENSORS = 256  # gradients a launch takes by value
ROW_WORK = 11      # scratch floats a ball element: point_step's ten vectors and the gradient

SEG = np.dtype([("p", "<u8"), ("m", "<u8"), ("v", "<u8"), ("n", "<i8"), ("row", "<i4"),
                ("group", "<i4"), ("work", "<i8")])
GROUP = np.dtype([("lr", "<u8"), ("b1", "<f4"), ("omb1", "<f4"), ("b2", "<f4"),
                  ("omb2", "<f4"), ("eps", "<f4"), ("wd", "<f4")])
TILE = np.dtype([("seg", "<i4"), ("len", "<i4"), ("start", "<i8")])

launches = LaunchCounter()
_fns: dict = {}


def takes(params, moment_dtype: Optional[torch.dtype], ema_decay) -> bool:
    """Whether ``RiemannianAdam`` over ``params`` runs the kernel pair."""
    params = list(params)
    dev = params[0].device
    return (dev.type == "cuda" and ema_decay is None and moment_dtype in (None, torch.float32)
            and all(p.device == dev and p.dtype == torch.float32 for p in params))


def segment_table(optimizer) -> dict:
    """``{"segs", "groups", "tiles", "work"}``: the kernels' table over
    ``optimizer``'s parameters (numpy records; pointers as integers) and
    the floats of scratch its ball rows take."""
    segs, groups, work = [], [], 0
    for gi, group in enumerate(optimizer.param_groups):
        b1, b2 = group["betas"]
        groups.append((group["lr"].data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2, group["eps"],
                       group["weight_decay"]))
        for p in group["params"]:
            m, v = optimizer.moments(p)
            if not all(t.is_contiguous() for t in (p, m, v)):
                raise ValueError("Riemannian Adam kernel: parameters and moments must be "
                                 "contiguous")
            row = int(p.shape[-1]) if is_manifold_param(p) else 0
            segs.append((p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(), row, gi,
                         work if row else 0))
            work += ROW_WORK * p.numel() if row else 0
    tiles = []
    for s, (_, _, _, n, row, _, _) in enumerate(segs):
        step = ROW_TILE * row if row else TILE_ELEMS
        tiles += [(s, min(step, n - start), start) for start in range(0, n, step)]
    return {"segs": np.array(segs, SEG), "groups": np.array(groups, GROUP),
            "tiles": np.array(tiles, TILE), "work": work}


def _launcher():
    if "launch" not in _fns:
        from hyperbolic_vae_tpu_torch.ops._build import load_library

        lib = load_library("riemannian_adam")
        limits = (ctypes.c_int * 4)()
        lib.riemannian_adam_limits(limits)
        if tuple(limits) != (TILE_ELEMS, ROW_TILE, MAX_TENSORS, ROW_WORK):
            raise RuntimeError(f"Riemannian Adam kernel: the library's limits {tuple(limits)} are "
                               "not the wrapper's")
        fn = lib.riemannian_adam_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + [
            ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["launch"] = fn
    return _fns["launch"]


class KernelStep:
    """The kernel pair over ``optimizer``'s parameters (see the module)."""

    def __init__(self, optimizer):
        self.opt = optimizer
        self.device = optimizer.count.device
        self.ok = torch.ones((), dtype=torch.bool, device=self.device)
        self._build()

    def _signature(self) -> tuple:
        o = self.opt
        return tuple((g["lr"].data_ptr(), g["betas"], g["eps"], g["weight_decay"],
                      tuple((p.data_ptr(),) + tuple(t.data_ptr() for t in o.moments(p))
                            for p in g["params"]))
                     for g in o.param_groups)

    def _build(self) -> None:
        tab = segment_table(self.opt)
        parts, offs, at = [], [], 0
        for name in ("segs", "groups", "tiles"):
            raw = tab[name].tobytes()
            offs.append(at)
            pad = -len(raw) % 16
            parts.append(raw + b"\0" * pad)
            at += len(raw) + pad
        self.table = torch.frombuffer(bytearray(b"".join(parts)), dtype=torch.uint8).to(self.device)
        base = self.table.data_ptr()
        self._ptrs = [base + o for o in offs]
        self.n_segs, self.n_groups = len(tab["segs"]), len(tab["groups"])
        self.n_tiles = len(tab["tiles"])
        # the first tile of each segment, and n_tiles
        first = np.searchsorted(tab["tiles"]["seg"], np.arange(self.n_segs + 1))
        self.seg_tiles = (ctypes.c_int * (self.n_segs + 1))(*first.tolist())
        # partials, the ticket, ok and two corrections a group
        self.scratch = torch.zeros(self.n_tiles + 2 + 2 * self.n_groups, dtype=torch.float32,
                                   device=self.device)
        self.work = torch.empty(max(tab["work"], 1), dtype=torch.float32, device=self.device)
        self.sig = self._signature()

    def __call__(self, guard: Optional[torch.Tensor] = None,
                 ok: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step from each parameter's ``.grad``. ``guard`` (the loss):
        ok = isfinite(loss) & isfinite(sum g^2); else ``ok`` (a bool 0-d
        tensor) or, without it, true. Returns ok, a bool 0-d tensor the
        next call overwrites."""
        if self._signature() != self.sig:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("Riemannian Adam kernel: a parameter, moment or lr moved "
                                   "inside a CUDA graph capture")
            self._build()
        grads = []
        for p in (p for group in self.opt.param_groups for p in group["params"]):
            g = p.grad
            if g is not None and (g.device != self.device or g.dtype != torch.float32
                                  or not g.is_contiguous() or g.shape != p.shape):
                raise ValueError("Riemannian Adam kernel: gradients must be contiguous f32 "
                                 "tensors of their parameter's shape and device")
            grads.append(None if g is None else g.data_ptr())
        loss = ok_in = None
        if guard is not None:
            loss = guard if guard.dtype == torch.float32 else guard.float()
            if loss.device != self.device or loss.numel() != 1:
                raise ValueError("Riemannian Adam kernel: the guard's loss must be one value on "
                                 "the parameters' device")
        elif ok is not None:
            ok_in = ok if ok.dtype == torch.bool else ok.bool()
            if ok_in.device != self.device:
                raise ValueError("Riemannian Adam kernel: ok must be on the parameters' device")
        fn = _launcher()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = fn(*self._ptrs, self.n_segs, self.n_groups, self.n_tiles, self.seg_tiles,
                     (ctypes.c_void_p * self.n_segs)(*grads),
                     None if loss is None else loss.data_ptr(),
                     None if ok_in is None else ok_in.data_ptr(), self.opt.count.data_ptr(),
                     self.scratch.data_ptr(), self.work.data_ptr(), self.ok.data_ptr(),
                     float(self.opt.ball.c), stream)
        if err != 0:
            raise RuntimeError(f"Riemannian Adam kernel launch failed: cudaError {err}")
        launches.add()
        return self.ok
