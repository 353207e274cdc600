"""Tensor-parallel layers over a mesh's 'model' axis.

What JAX's partitioner makes of the TP layout (``sharding_rules``), done
by hand with the collectives as autograd functions whose backward is
explicit (Megatron's f and g operators):

  * ``ColumnParallelLinear`` holds rows [lo, hi) of a Linear's output (the
    flax ``enc`` kernel's P(None, 'model')). Its output is all-gathered
    over 'model' (exact: the other ranks' columns, concatenated) unless a
    row-parallel layer consumes it; the gather's backward is this rank's
    slice of the gradient. Its input is replicated, so the input's
    gradient (each rank's rows' part) is summed over 'model'.
  * ``PlaneShardedHyperplanes`` holds planes [lo, hi) of the gyroplanes
    and launches the gyroplane kernel on them (``ops.gyroplane_distances_fast``):
    K1 on a plane shard. Its input z is replicated; z's gradient is summed
    over 'model' (each rank's planes contribute their part). Its output
    stays split into a row-parallel ``dec_out`` (RNASeqVAE, UnifiedVAE),
    or is gathered (the flagship, whose next layer is replicated).
  * ``RowParallelLinear`` holds columns [lo, hi) of a Linear's weight (the
    contraction: flax ``dec_out``'s P('model', None)). Each rank computes
    its partial (B, out) product, the partials are summed over 'model',
    and the bias is added once: by model rank 0 inside its product, so at
    one model rank the layer is the unsharded Linear bit for bit. The
    other ranks add ``b - b.detach()`` (zero) so that every rank's bias
    gradient is computed as rank 0's and the replicated bias stays equal
    on every rank. A replicated input is cut to the rank's columns, its
    gradient summed over 'model'.

With more than one model rank the row-parallel sum adds the partials in
another order than one card's product does, so TP is held to a tolerance
(not bit for bit) there; the column gathers and the plane shards are
exact. ``TensorParallel`` swaps a model's layers for these in place
(``nn.Sequential`` slots) and puts the originals back after a fit. The
rows of the gyroplane points are independent points on the ball, so
Riemannian Adam updates each rank's rows on their own.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from hyperbolic_vae_tpu_torch.nn.layers import PoincareHyperplanes
from hyperbolic_vae_tpu_torch.ops.gyroplane import gyroplane_distances_fast
from hyperbolic_vae_tpu_torch.parallel.mesh import MODEL_AXIS, all_gather_flat, share

# the parameter-free modules a split activation may pass through unchanged
ELEMENTWISE = (nn.GELU, nn.ReLU, nn.Sigmoid, nn.Tanh, nn.SiLU, nn.ELU, nn.Softplus,
               nn.LeakyReLU, nn.Identity)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward: the gradient summed over 'model'."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the partials summed over 'model' (in place); backward:
    identity (every rank's downstream is the same)."""

    @staticmethod
    def forward(ctx, x, group):
        dist.all_reduce(x, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """Forward: the ranks' last-axis pieces concatenated in rank order;
    backward: this rank's piece of the gradient."""

    @staticmethod
    def forward(ctx, x, group, n: int, i: int):
        ctx.n, ctx.i = n, i
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        all_gather_flat(out, x, group)
        out = out.view((n,) + tuple(x.shape)).movedim(0, -2)
        return out.reshape(tuple(x.shape[:-1]) + (n * x.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        w = g.shape[-1] // ctx.n
        return g.narrow(-1, ctx.i * w, w).contiguous(), None, None, None


def _copy(t: torch.Tensor, like: nn.Parameter) -> nn.Parameter:
    return type(like)(t.detach().clone(memory_format=torch.contiguous_format),
                      requires_grad=like.requires_grad)


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def _compute_dtype(full: nn.Linear) -> Optional[torch.dtype]:
    """The dtype ``full`` computes in when it declares one (a layer that
    casts its input, weight and bias for the product, as RNASeqVAE's
    ``WideLinear``); None: its weight's own, as ``nn.Linear``."""
    return getattr(full, "compute_dtype", None)


class _ModelSplit(nn.Module):
    def __init__(self, mesh, size: int):
        super().__init__()
        self.group = mesh.group(MODEL_AXIS)
        self.n, self.i = mesh.shape[MODEL_AXIS], mesh.coord(MODEL_AXIS)
        self.lo, self.hi = share(size, self.n, self.i)

    def _gather(self, y: torch.Tensor) -> torch.Tensor:
        return _GatherFromModel.apply(y, self.group, self.n, self.i)


class ColumnParallelLinear(_ModelSplit):
    """Rows [lo, hi) of ``full``'s output; ``gather_output``: the whole
    output on every rank."""

    def __init__(self, full: nn.Linear, mesh, gather_output: bool = True):
        super().__init__(mesh, full.out_features)
        self.in_features, self.out_features = full.in_features, full.out_features
        self.gather_output = gather_output
        self.compute_dtype = _compute_dtype(full)
        self.weight = _copy(full.weight[self.lo:self.hi], full.weight)
        self.bias = _copy(full.bias[self.lo:self.hi], full.bias)

    def forward(self, x):
        dt = self.compute_dtype
        x = _CopyToModel.apply(_cast(x, dt), self.group)
        y = F.linear(x, _cast(self.weight, dt), _cast(self.bias, dt))
        return self._gather(y) if self.gather_output else y


class RowParallelLinear(_ModelSplit):
    """Columns [lo, hi) of ``full``'s weight (its contraction), the bias
    whole; ``input_sharded``: the input holds this rank's columns only."""

    def __init__(self, full: nn.Linear, mesh, input_sharded: bool = False):
        super().__init__(mesh, full.in_features)
        self.in_features, self.out_features = full.in_features, full.out_features
        self.input_sharded = input_sharded
        self.compute_dtype = _compute_dtype(full)
        self.weight = _copy(full.weight[:, self.lo:self.hi], full.weight)
        self.bias = _copy(full.bias, full.bias)

    def forward(self, x):
        dt = self.compute_dtype
        x = _cast(x, dt)
        if not self.input_sharded:
            x = _CopyToModel.apply(x, self.group)[..., self.lo:self.hi]
        b = _cast(self.bias, dt)
        if self.i != 0:
            b = b - b.detach()  # zero, with rank 0's bias gradient
        return _ReduceFromModel.apply(F.linear(x, _cast(self.weight, dt), b), self.group)


class PlaneShardedHyperplanes(_ModelSplit):
    """Planes [lo, hi) of ``full`` (a ``PoincareHyperplanes``): K1 on the
    shard's points and bias; ``gather_output``: every plane's distance on
    every rank."""

    def __init__(self, full: PoincareHyperplanes, mesh, gather_output: bool = True):
        super().__init__(mesh, full.points.shape[0])
        self.ball, self.signed = full.ball, full.signed
        self.gather_output = gather_output
        self.points = _copy(full.points[self.lo:self.hi], full.points)
        self.bias = _copy(full.bias[self.lo:self.hi], full.bias)

    def forward(self, z):
        z = _CopyToModel.apply(z, self.group)
        y = gyroplane_distances_fast(z, self.points, self.ball.c, self.signed, self.bias)
        return self._gather(y) if self.gather_output else y


def _kind(module: nn.Module, prefix: str, layout: Dict[str, tuple]) -> Optional[str]:
    """"column", "row", "planes" or None: what the layout makes of ``module``."""
    # the 'model' splits only: a 'data' split (FSDP) is storage, not compute
    specs = {name: tuple(a if a == MODEL_AXIS else None for a in layout[f"{prefix}.{name}"])
             for name, _ in module.named_parameters(recurse=False)}
    if not any(MODEL_AXIS in s for s in specs.values()):
        return None
    if isinstance(module, PoincareHyperplanes) and specs["points"] == (MODEL_AXIS, None) \
            and specs["bias"] == (MODEL_AXIS,):
        return "planes"
    if isinstance(module, nn.Linear) and specs["weight"] == (MODEL_AXIS, None) \
            and specs["bias"] == (MODEL_AXIS,):
        return "column"
    if isinstance(module, nn.Linear) and specs["weight"] == (None, MODEL_AXIS) \
            and MODEL_AXIS not in specs["bias"]:
        return "row"
    raise ValueError(f"{prefix} ({type(module).__name__}): no tensor-parallel layer for the "
                     f"specs {specs}")


class TensorParallel:
    """The layout's 'model'-split layers of ``model`` swapped in place for
    their sharded counterparts (each copying its piece of the current
    weights); ``restore()`` puts the originals back. A split output feeds
    a row-parallel layer directly when only elementwise modules stand
    between them in their ``nn.Sequential``; otherwise it is gathered."""

    def __init__(self, model: nn.Module, layout: Dict[str, tuple], mesh):
        self.model = model
        self.swaps: List[Tuple[nn.Sequential, int, nn.Module, nn.Module]] = []
        try:
            self._swap(layout, mesh)
        except BaseException:
            self.restore()  # a layout that fails half-way leaves the model as it was
            raise

    def _swap(self, layout: Dict[str, tuple], mesh) -> None:
        done = set()
        for sname, seq in list(self.model.named_modules()):
            if not isinstance(seq, nn.Sequential):
                continue
            kinds = [_kind(m, f"{sname}.{j}" if sname else str(j), layout)
                     for j, m in enumerate(seq)]
            for j, (m, kind) in enumerate(zip(seq, kinds)):
                if kind is None:
                    continue
                prefix = f"{sname}.{j}" if sname else str(j)
                if kind == "row":
                    new = RowParallelLinear(m, mesh, input_sharded=self._fed(seq, kinds, j, -1))
                else:
                    split = self._fed(seq, kinds, j, +1)
                    cls = PlaneShardedHyperplanes if kind == "planes" else ColumnParallelLinear
                    new = cls(m, mesh, gather_output=not split)
                seq[j] = new
                self.swaps.append((seq, j, m, new))
                done.update(f"{prefix}.{n}" for n, _ in m.named_parameters(recurse=False))
        missed = [k for k, s in layout.items() if MODEL_AXIS in s and k not in done]
        if missed:
            raise ValueError(f"no tensor-parallel layer holds {missed}")

    @staticmethod
    def _fed(seq, kinds, j: int, step: int) -> bool:
        """Whether the split neighbour of slot j (the next with step +1, the
        previous with -1) exchanges a split activation with it directly:
        a row layer after a column or plane layer, with only elementwise
        modules between."""
        k = j + step
        while 0 <= k < len(seq) and isinstance(seq[k], ELEMENTWISE):
            k += step
        if not 0 <= k < len(seq):
            return False
        pair = (kinds[j], kinds[k]) if step > 0 else (kinds[k], kinds[j])
        return pair in (("column", "row"), ("planes", "row"))

    def restore(self) -> None:
        for seq, j, orig, _ in self.swaps:
            seq[j] = orig

    @contextlib.contextmanager
    def unsharded(self):
        """The original layers in place for the block (``fsdp.ShardedState.whole``
        loads the fit's weights into them)."""
        for seq, j, orig, _ in self.swaps:
            seq[j] = orig
        try:
            yield self.model
        finally:
            for seq, j, _, new in self.swaps:
                seq[j] = new
