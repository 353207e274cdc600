"""A fit's parameters under a layout: FSDP over 'data', TP over 'model'.

The port's counterpart of what JAX's ``device_put`` of the params under
``param_sharding_fn`` and its partitioner do to the Trainer's step
(``train/epoch_program.py`` calls it). ``ShardedState`` holds, for each
parameter of the model:

  * its **working** tensor, the model's own parameter that the forward
    reads: whole, or this rank's 'model' piece where a tensor-parallel
    layer computes on it (``parallel/tensor_parallel.py``);
  * its **master**, the tensor the optimizer steps and the chunk program
    tracks (best, masked skip): the working tensor itself, or, for a leaf
    the layout splits over 'data' (FSDP), this rank's slice of it as a
    parameter of its own, which alone carries Adam's moments.

FSDP gathers per step, not per layer: after every optimizer update the
masters are all-gathered over 'data' into the working tensors (exact), so
the working copy is whole before every forward, train or val. The
gradients of the FSDP leaves are reduce-scattered over 'data' with the
data-parallel weights (``parallel/data_parallel.RowShard``: a rank's
share of the rows), the other leaves' all-reduced with the metrics as in
data parallelism. A sum of two ranks' terms is the same in either
collective and Adam is elementwise, so FSDP over two data ranks equals
data parallelism over two bit for bit. The finite guard and gradient
clipping read the **global** squared norm: each rank sums the squares of
the masters it counts (a leaf replicated over an axis is counted by that
axis's rank 0 only), and one all-reduce over the mesh adds them, so every
rank takes the same skip decision.

Steps that run the whole batch on every rank (K3's ``train_step_fn``,
K2's fused ``loss_fn``) compute on whole tensors, as XLA gathers a Pallas
call's operands: no tensor-parallel layer is swapped in, every split of
the layout (over 'model' too) is storage only, and the step gathers the
parameters (and, for K3, the moments) before it runs and keeps its
rank's slices after. Results, checkpoints and callbacks see whole tensors
in the reference layout (``full``), gathered on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from hyperbolic_vae_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_gather_flat,
    reduce_scatter_flat,
    share,
)
from hyperbolic_vae_tpu_torch.parallel.tensor_parallel import TensorParallel

# the order in which a leaf's splits are gathered: 'data' first (within a
# model rank), then 'model'
_AXES = (DATA_AXIS, MODEL_AXIS)


class _Leaf:
    """One parameter: its key, spec, working tensor and master, the
    (dim, axis) splits the master adds to the working tensor (``store``)
    and the split a tensor-parallel layer computes on (``tp``)."""

    def __init__(self, key: str, spec: tuple, working: nn.Parameter, store, tp):
        self.key, self.spec, self.working = key, spec, working
        self.store: List[Tuple[int, str]] = store
        self.tp: Optional[Tuple[int, str]] = tp
        self.master = working

    @property
    def splits(self) -> List[Tuple[int, str]]:
        """Every split of the full tensor that the master carries."""
        return sorted(self.store + ([self.tp] if self.tp else []),
                      key=lambda s: _AXES.index(s[1]))


def _narrow(t: torch.Tensor, splits, mesh) -> torch.Tensor:
    for d, axis in splits:
        lo, hi = share(t.shape[d], mesh.shape[axis], mesh.coord(axis))
        t = t.narrow(d, lo, hi - lo)
    return t


class ShardedState:
    """``model`` under ``layout`` (``sharding_rules``) on ``mesh``.
    ``whole_batch``: the step runs the whole batch on every rank (no
    tensor-parallel layers). The model must hold the fit's starting
    weights, whole."""

    def __init__(self, model: nn.Module, layout: Dict[str, tuple], mesh, whole_batch: bool):
        self.model, self.layout, self.mesh = model, dict(layout), mesh
        keys = set(model.state_dict())
        if set(self.layout) != keys:
            raise ValueError(f"the layout's keys are not the model's state_dict keys: missing "
                             f"{sorted(keys - set(self.layout))}, extra "
                             f"{sorted(set(self.layout) - keys)}")
        for key, _ in model.named_buffers():
            if any(a is not None for a in self.layout[key]):
                raise ValueError(f"{key} is a buffer; a layout splits parameters only")
        tp_on = not whole_batch and any(MODEL_AXIS in s for s in self.layout.values())
        self.tp = TensorParallel(model, self.layout, mesh) if tp_on else None
        self.leaves: List[_Leaf] = []
        for key, p in model.named_parameters():
            spec = self.layout[key]
            splits = [(d, a) for d, a in enumerate(spec) if a is not None]
            tp = next(((d, a) for d, a in splits if a == MODEL_AXIS and tp_on), None)
            leaf = _Leaf(key, spec, p, [s for s in splits if s != tp], tp)
            if leaf.store:
                leaf.master = type(p)(_narrow(p.detach(), leaf.store, mesh).clone(
                    memory_format=torch.contiguous_format), requires_grad=p.requires_grad)
            self.leaves.append(leaf)
        self.stored = [leaf for leaf in self.leaves if leaf.store]
        # what a rank counts in the global norm: a master replicated over an
        # axis is counted by that axis's rank 0
        self.counted = [all(mesh.coord(a) == 0 for a in mesh.axis_names
                            if a not in {s[1] for s in leaf.splits}) for leaf in self.leaves]

    # ---- the optimizer's side -------------------------------------------

    @property
    def masters(self) -> List[nn.Parameter]:
        return [leaf.master for leaf in self.leaves]

    def master_state(self) -> Dict[str, torch.Tensor]:
        """state_dict key -> the tensor the chunk program tracks (the
        master; a buffer as it is), in ``state_dict`` order."""
        by_key = {leaf.key: leaf.master.detach() for leaf in self.leaves}
        return {k: by_key.get(k, v) for k, v in self.model.state_dict().items()}

    def param_specs(self) -> Dict[nn.Parameter, tuple]:
        """master -> its spec (``opt_state_shardings`` reads it)."""
        return {leaf.master: leaf.spec for leaf in self.leaves}

    @property
    def working_copies(self) -> List[torch.Tensor]:
        """The working tensors that the gathers write (not masters)."""
        return [leaf.working for leaf in self.stored]

    # ---- collectives ------------------------------------------------------

    def _gather_axis(self, items: Sequence[Tuple[torch.Tensor, int]], axis: str) -> List[torch.Tensor]:
        """Each tensor's pieces along its dim, gathered over ``axis`` in one
        all-gather: new whole-along-dim tensors."""
        n = self.mesh.shape[axis]
        moved = [t.detach().movedim(d, 0).contiguous() for t, d in items]
        dtype = torch.float32  # bf16 leaves travel exactly as f32
        for m in moved:
            dtype = torch.promote_types(dtype, m.dtype)
        flat = torch.cat([m.reshape(-1).to(dtype) for m in moved])
        out = flat.new_empty(n * flat.numel())
        all_gather_flat(out, flat, self.mesh.group(axis))
        out = out.view(n, -1)
        res, off = [], 0
        for (t, d), m in zip(items, moved):
            piece = out[:, off:off + m.numel()].reshape((n * m.shape[0],) + tuple(m.shape[1:]))
            res.append(piece.movedim(0, d).to(t.dtype))
            off += m.numel()
        return res

    def _gather(self, tensors: Dict[_Leaf, torch.Tensor], which: str) -> Dict[_Leaf, torch.Tensor]:
        """``tensors`` (master-shaped, by leaf) gathered over the leaf's
        ``store`` splits (``which="store"``: working-shaped) or all its
        splits (``"full"``)."""
        cur = dict(tensors)
        for axis in _AXES:
            items = [(leaf, d) for leaf in cur
                     for d, a in (leaf.store if which == "store" else leaf.splits) if a == axis]
            if not items:
                continue
            got = self._gather_axis([(cur[leaf], d) for leaf, d in items], axis)
            for (leaf, _), t in zip(items, got):
                cur[leaf] = t
        return cur

    @torch.no_grad()
    def gather_working(self) -> None:
        """The masters all-gathered into the working tensors, in place."""
        if not self.stored:
            return
        got = self._gather({leaf: leaf.master for leaf in self.stored}, "store")
        for leaf, t in got.items():
            leaf.working.copy_(t)

    def reduce_grads(self, metrics: Dict[str, torch.Tensor], shard) -> Dict[str, torch.Tensor]:
        """The working gradients into the masters' gradients. ``shard`` (a
        ``RowShard``, data parallel): each rank's weighted gradients summed
        over 'data', reduce-scattered for the FSDP leaves and all-reduced
        (with the metrics) for the others. Without it (a whole-batch step)
        every rank holds the whole gradient: the FSDP leaves take their
        slice."""
        if shard is None:
            for leaf in self.stored:
                g = leaf.working.grad
                leaf.master.grad = None if g is None else _narrow(g, leaf.store, self.mesh).clone(
                    memory_format=torch.contiguous_format)
            return metrics
        rest = [leaf.working.grad for leaf in self.leaves
                if not leaf.store and leaf.working.grad is not None]
        metrics = shard.reduce(rest, metrics)
        split = [leaf for leaf in self.stored if leaf.working.grad is not None]
        if split:
            n = self.mesh.shape[DATA_AXIS]
            rows = []
            for leaf in split:
                (d, _), = leaf.store  # the data split of a leaf under a row split
                g = leaf.working.grad.detach().float().movedim(d, 0)
                rows.append(g.reshape(n, -1))
            flat = torch.cat(rows, dim=1).reshape(-1)
            flat.mul_(shard.weight)
            out = flat.new_empty(flat.numel() // n)
            reduce_scatter_flat(out, flat, shard.group)
            off = 0
            for leaf in split:
                (d, _), = leaf.store
                shape = leaf.master.movedim(d, 0).shape
                k = leaf.master.numel()
                g = out[off:off + k].view(shape).movedim(0, d)
                leaf.master.grad = g.to(leaf.master.dtype).contiguous()
                off += k
        return metrics

    def global_sq_norm(self) -> torch.Tensor:
        """The squared L2 norm of the whole (global) gradient: each rank's
        counted masters' sums of squares, added over the mesh in one
        all-reduce, then summed in parameter order."""
        parts = []
        for leaf, counted in zip(self.leaves, self.counted):
            g = leaf.master.grad
            if g is None:
                continue
            s = (g * g).sum()
            parts.append(s if counted else torch.zeros_like(s))
        v = torch.stack(parts)
        dist.all_reduce(v, group=self.mesh.group("*"))
        return v.sum()

    # ---- whole tensors ----------------------------------------------------

    def full(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Master-shaped tensors by key (parameters; buffers pass through)
        gathered whole on every rank, as new tensors."""
        by_key = {leaf.key: leaf for leaf in self.leaves}
        split = {by_key[k]: t for k, t in tensors.items() if k in by_key and by_key[k].splits}
        got = self._gather(split, "full")
        out = {}
        for k, t in tensors.items():
            leaf = by_key.get(k)
            out[k] = got[leaf] if leaf in got else t.detach().clone()
        return out

    def local(self, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors by key cut to this rank's master pieces."""
        by_key = {leaf.key: leaf for leaf in self.leaves}
        return {k: _narrow(t, by_key[k].splits, self.mesh) if k in by_key else t
                for k, t in full.items()}

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The model's parameters and buffers, whole, on every rank."""
        return self.full(self.master_state())

    def full_optimizer_state(self, optimizer) -> dict:
        """``optimizer.state_dict()`` with every moment (and EMA) whole: the
        state an unsharded optimizer over the model would hold."""
        sd = optimizer.state_dict()
        flat = {(int(i), name): t for i, st in sd["state"].items() for name, t in st.items()}
        aliases = {(i, name): _Alias(self.leaves[i], name) for i, name in flat}
        got = self._gather({aliases[k]: t for k, t in flat.items() if aliases[k].splits}, "full")
        state: dict = {}
        for k, t in flat.items():
            state.setdefault(k[0], {})[k[1]] = got[aliases[k]] if aliases[k] in got else t.clone()
        return dict(sd, state=state)

    def local_optimizer_state(self, sd: dict) -> dict:
        """A whole optimizer state (``full_optimizer_state``, or an unsharded
        fit's) cut to this rank's masters."""
        state = {}
        for i, st in sd["state"].items():
            leaf = self.leaves[int(i)]
            state[int(i)] = {name: _narrow(t, leaf.splits, self.mesh) for name, t in st.items()}
        return dict(sd, state=state)

    # ---- whole-batch steps ------------------------------------------------

    def wrap_train_step(self, fn: Callable, optimizer) -> Callable:
        """``train_step_fn`` (K3) on whole tensors: before each step the
        masters' moments are gathered into a working optimizer over the
        model's whole parameters (the parameters are whole already), the
        step updates them in place, and each rank keeps its slices. The lr
        and step count are the optimizer's own tensors."""
        from hyperbolic_vae_tpu_torch.optim import RiemannianAdam

        group = optimizer.param_groups[0]
        work = RiemannianAdam([leaf.working for leaf in self.leaves], lr=0.0,
                              betas=group["betas"], eps=group["eps"],
                              weight_decay=group["weight_decay"], ball=optimizer.ball,
                              moment_dtype=optimizer.moment_dtype)
        work.param_groups[0]["lr"] = group["lr"]
        work.count = optimizer.count
        for leaf in self.leaves:
            if not leaf.store:
                work.state[leaf.working] = optimizer.state[leaf.master]

        @torch.no_grad()
        def step(model, _optimizer, batch, generator):
            names = ("exp_avg", "exp_avg_sq")
            moments = {_Alias(leaf, n): optimizer.state[leaf.master][n]
                       for leaf in self.stored for n in names}
            for key, t in self._gather(moments, "store").items():
                work.state[key.leaf.working][key.name].copy_(t)
            out = fn(model, work, batch, generator)
            for leaf in self.stored:
                leaf.master.copy_(_narrow(leaf.working, leaf.store, self.mesh))
                for n in names:
                    optimizer.state[leaf.master][n].copy_(
                        _narrow(work.state[leaf.working][n], leaf.store, self.mesh))
            return out

        return step

    # ---- the end ---------------------------------------------------------

    @contextlib.contextmanager
    def whole(self):
        """The model as one process holds it, for the block: its own layers
        holding the fit's weights whole. The tensor-parallel layers' pieces
        are gathered into the original layers swapped back in; every other
        working tensor is whole already (gathered after each update), so
        loading it again writes the bits it holds."""
        if self.tp is None:
            yield self.model
            return
        full = self.full_params()
        with self.tp.unsharded() as model:
            model.load_state_dict(full)
            yield model

    @torch.no_grad()
    def restore(self, full: Optional[Dict[str, torch.Tensor]]) -> None:
        """The model's own layers back, holding ``full`` (whole tensors;
        None: left as they were before the fit)."""
        if self.tp is not None:
            self.tp.restore()
        if full is not None:
            self.model.load_state_dict(full)


class _Alias:
    """A leaf's optimizer-state tensor ``name``, gathered like the leaf."""

    def __init__(self, leaf: _Leaf, name: str):
        self.leaf, self.name = leaf, name
        self.store, self.splits = leaf.store, leaf.splits

    def __hash__(self):
        return hash((id(self.leaf), self.name))

    def __eq__(self, other):
        return isinstance(other, _Alias) and other.leaf is self.leaf and other.name == self.name
