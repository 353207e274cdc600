"""Gyroplane distances: the decoder's first op.

Port of ``hyperbolic_vae_tpu/ops/gyroplane.py``. For normals equal to the
points (the gyroplane layer's convention) every term of the distance
depends only on |x|^2 (B,), |p|^2 (P,) and <x, p> (B, P):

  den   = 1 - 2c<p,x> + c^2 |p|^2 |x|^2
  alpha = (1 - 2c<p,x> + c|x|^2) / den       (coefficient of -p)
  beta  = (1 - c|p|^2) / den                 (coefficient of  x)
  <diff, p> = -alpha |p|^2 + beta <x, p>
  |diff|^2  = alpha^2 |p|^2 - 2 alpha beta <p,x> + beta^2 |x|^2
  dist = arsinh(2 sqrt(c) <diff,p> / ((1 - c|diff|^2) |p|)) / sqrt(c)

Three functions:

  * ``gyroplane_distances``: the plain PyTorch version (any leading
    dims). The CPU path and the reference the kernel is checked against.
  * ``gyroplane_distances_cuda``: the wrapper of the hand-written CUDA
    kernel (``csrc/gyroplane.cu``), which replaces the TPU's Pallas
    ``_gyroplane_kernel``. CUDA tensors only. ``kernel_path`` names which
    of its three kernels a shape takes; ``gyroplane_distances_fallback_cuda``
    forces the fallback, which the others equal bit for bit.
  * ``gyroplane_distances_fast``: the dispatcher the layer calls. It
    calls ``gyroplane_op``, K1 registered with ``torch.library`` as
    ``torch.ops.hvae_torch.gyroplane_distances``: the kernel for CUDA
    tensors (the wrapper above, which counts the launch), the plain
    version for CPU tensors, a fake implementation giving (B, P) f32 for
    ``torch.export`` and ``torch.compile``, and a backward by autograd
    through the plain version, as JAX's ``_gdf_bwd`` differentiates its
    jnp version. Being an op, K1 survives ``torch.export`` (the serving
    bundles of ``serve.py``) and CUDA graph capture as an opaque node; a
    process that loads an exported program must import this module
    first, which registers the op. A tensor on another device raises; a
    failed build or launch raises, with no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from hyperbolic_vae_tpu_torch.manifolds import MIN_NORM


def _epilogue(xp, x2, p2, c: float, signed: bool, bias=None):
    """Elementwise tail: xp (B, P), x2 (B, 1), p2 (1, P) -> (B, P)."""
    sqrt_c = math.sqrt(c)
    den = (1.0 - 2.0 * c * xp + c * c * p2 * x2).clamp_min(MIN_NORM)
    alpha = (1.0 - 2.0 * c * xp + c * x2) / den
    beta = (1.0 - c * p2) / den
    sc_diff_a = -alpha * p2 + beta * xp
    # the true Mobius difference lies inside the ball: |diff|^2 < 1/c.
    # The analytic form cancels in f32 for near-boundary x, p — clamp
    # into the open ball so the (1 - c|diff|^2) factor keeps its sign.
    max_d2 = (1.0 - 1e-4) ** 2 / c
    diff_norm2 = torch.clamp(
        alpha * alpha * p2 - 2.0 * alpha * beta * xp + beta * beta * x2,
        MIN_NORM,
        max_d2,
    )
    if not signed:
        sc_diff_a = sc_diff_a.abs()
    p_norm = torch.sqrt(p2.clamp_min(MIN_NORM**2))
    num = 2.0 * sqrt_c * sc_diff_a
    denom = ((1.0 - c * diff_norm2) * p_norm).clamp_min(MIN_NORM)
    out = torch.asinh(num / denom) / sqrt_c
    if bias is not None:
        out = out + bias
    return out


def gyroplane_distances(
    x: torch.Tensor, points: torch.Tensor, c: float, signed: bool = True, bias=None
) -> torch.Tensor:
    """Signed distances from x (..., D) to the gyroplanes through
    ``points`` (P, D) with normals = points. Returns (..., P)."""
    # at least f32 (bf16 upcasts, f32 no-op); f64 inputs keep full width
    dt = torch.promote_types(torch.float32, torch.promote_types(x.dtype, points.dtype))
    x = x.to(dt)
    points = points.to(dt)
    x2 = (x * x).sum(dim=-1, keepdim=True)  # (..., 1)
    p2 = (points * points).sum(dim=-1)  # (P,)
    xp = x @ points.T  # (..., P)
    return _epilogue(xp, x2, p2, c, signed, bias)


# ---------------------------------------------------------------------- #
# The CUDA kernel.


class LaunchCounter:
    """Counts a kernel's launches (thread-safe: the HTTP dispatcher thread
    and the caller's thread may both launch). A CUDA graph replay launches
    what was captured without calling the wrapper, so the graph runner
    (``train/cuda_graph.py``) adds each captured kernel's launches itself
    with ``add(n)`` on every replay."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    def reset(self) -> None:
        with self._lock:
            self.count = 0


launches = LaunchCounter()
_fns: dict = {}


def _launcher(name: str = "gyroplane_distances_launch"):
    """The C entry ``name`` of the built library, with the launch's
    argument types (``gyroplane_distances_launch`` or ``..._launch_any``)."""
    if name not in _fns:
        from hyperbolic_vae_tpu_torch.ops._build import load_library

        fn = getattr(load_library("gyroplane"), name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def gyroplane_distances_cuda(
    x: torch.Tensor,
    points: torch.Tensor,
    c: float,
    signed: bool = True,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The CUDA kernel: x (B, D), points (P, D), bias (P,) or None, all
    contiguous f32 on one CUDA device -> (B, P) f32."""
    tensors = [x, points] + ([] if bias is None else [bias])
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("gyroplane kernel: tensors must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"gyroplane kernel: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("gyroplane kernel: tensors must be contiguous")
    if x.dim() != 2 or points.dim() != 2 or x.shape[1] != points.shape[1]:
        raise ValueError(
            f"gyroplane kernel: x (B, D) and points (P, D), got {tuple(x.shape)}, "
            f"{tuple(points.shape)}"
        )
    B, D = x.shape
    P = points.shape[0]
    if bias is not None and tuple(bias.shape) != (P,):
        raise ValueError(f"gyroplane kernel: bias must be ({P},), got {tuple(bias.shape)}")
    if 4 * (P * D + P) > 232448:
        raise ValueError(f"gyroplane kernel: {P} planes of width {D} exceed shared memory")
    out = torch.empty((B, P), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), points.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, P, D, float(c), int(bool(signed)), stream,
        )
    if err != 0:
        raise RuntimeError(f"gyroplane kernel launch failed: cudaError {err}")
    launches.add()
    return out


_KERNELS = ("d2", "wide", "fallback")  # gyroplane_path's codes 0, 1, 2


def kernel_path(x: torch.Tensor, points: torch.Tensor) -> str:
    """The kernel that ``gyroplane_distances_cuda(x, points, ...)`` launches:
    "d2" (D = 2, P a multiple of 4 up to 64), "wide" (D = 2, P a multiple
    of 4 above 64) or "fallback" (any other shape, or an x not 8-byte
    aligned). The output the wrapper allocates is always aligned. Needs the
    built library, not a card."""
    from hyperbolic_vae_tpu_torch.ops._build import load_library

    fn = load_library("gyroplane").gyroplane_path
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), 256, x.shape[0], points.shape[0], x.shape[1])
    if code < 0:
        raise ValueError(f"gyroplane kernel: no path for x {tuple(x.shape)}, points "
                         f"{tuple(points.shape)}")
    return _KERNELS[code]


def gyroplane_distances_fallback_cuda(
    x: torch.Tensor,
    points: torch.Tensor,
    c: float,
    signed: bool = True,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fallback kernel (``gyroplane_any_kernel``) at any shape, for the
    checks that hold the other kernels to it bit for bit. The tensors are
    the wrapper's (x (B, D), points (P, D), bias (P,) or None, contiguous
    f32 on one CUDA device, B > 0), unchecked. Not counted in ``launches``:
    no path of the port calls it."""
    B, D = x.shape
    P = points.shape[0]
    out = torch.empty((B, P), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher("gyroplane_distances_launch_any")(
            x.data_ptr(), points.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, P, D, float(c), int(bool(signed)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gyroplane fallback kernel launch failed: cudaError {err}")
    return out


# ---------------------------------------------------------------------- #
# The registered op (forward, fake, autograd) and the dispatcher.


@torch.library.custom_op("hvae_torch::gyroplane_distances", mutates_args=(), device_types="cpu")
def gyroplane_op(x: torch.Tensor, points: torch.Tensor, bias: Optional[torch.Tensor], c: float,
                 signed: bool) -> torch.Tensor:
    """K1 as ``torch.ops.hvae_torch.gyroplane_distances``: x (B, D),
    points (P, D), bias (P,) or None, contiguous f32 -> (B, P) f32. On
    CPU tensors the plain version."""
    return gyroplane_distances(x, points, c, signed, bias)


@gyroplane_op.register_kernel("cuda")
def _gyroplane_op_cuda(x, points, bias, c, signed):
    return gyroplane_distances_cuda(x, points, c, signed, bias)


@gyroplane_op.register_fake
def _gyroplane_op_fake(x, points, bias, c, signed):
    return x.new_empty((x.shape[0], points.shape[0]), dtype=torch.float32)


def _gyroplane_op_setup(ctx, inputs, output):
    x, points, bias, c, signed = inputs
    ctx.save_for_backward(x, points, bias)
    ctx.c, ctx.signed = c, signed


def _gyroplane_op_backward(ctx, g):
    """Autograd through the plain version, as JAX's ``_gdf_bwd``
    differentiates its jnp version."""
    x, points, bias = ctx.saved_tensors
    inputs = [x.detach().requires_grad_(), points.detach().requires_grad_()]
    if bias is not None:
        inputs.append(bias.detach().requires_grad_())
    with torch.enable_grad():
        out = gyroplane_distances(
            inputs[0], inputs[1], ctx.c, ctx.signed,
            None if bias is None else inputs[2],
        )
        grads = torch.autograd.grad(out, inputs, g)
    dbias = grads[2] if bias is not None else None
    return grads[0], grads[1], dbias, None, None


gyroplane_op.register_autograd(_gyroplane_op_backward, setup_context=_gyroplane_op_setup)


def gyroplane_distances_fast(
    x: torch.Tensor,
    points: torch.Tensor,
    c: float,
    signed: bool = True,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gyroplane distances for 2-D x (B, D), in f32, through the registered
    op: the kernel for CUDA tensors, the plain version for CPU tensors;
    autograd through the plain version. Traceable by ``torch.export``."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"gyroplane distances: no path for device {x.device}")
    x = x.float().contiguous()
    points = points.float().contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    return gyroplane_op(x, points, bias, float(c), bool(signed))
