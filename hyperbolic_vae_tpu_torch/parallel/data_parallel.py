"""Data parallelism over a mesh's 'data' axis: each rank trains on its
rows of every global batch, and the ranks' gradients are summed.

What JAX's partitioner does to the Trainer's epoch under a mesh, done
rank by rank (``train/epoch_program.py`` calls it):

  * **Rows.** Every rank draws the same global batch order (one generator
    seeded alike) and takes rows [lo, hi) of each microbatch of B / A rows
    (``mesh.share``'s cut; B need not divide by the data axis).
  * **Draws.** The loss runs inside ``distributions.draws.row_window``,
    so each batch-shaped draw is the global batch's draw cut to the rank's
    rows: the draws equal the one-card fit's.
  * **Gradients and metrics.** Before the finite guard, clipping and
    Riemannian Adam, one all-reduce (sum) over the data axis of the
    flattened gradients and the metric row, each scaled by the rank's
    weight: its share of the rows for a ``per_sample_mean`` loss, 1 for a
    ``batch_sum`` one (``models/*.py``: ``loss_reduction``). Every rank
    then holds the global step's gradients and metrics, and its
    parameters stay equal to every other rank's.

At world size 1 the weight is 1 and the all-reduce is still issued, so a
meshed fit equals the unmeshed one bit for bit. A loss that mixes the
two reductions (``mixed_loss_reduction``) cannot be split by rows, and
paths whose step is one kernel without a row split (K3's
``train_step_fn``, K2's fused loss: ``whole_batch``) run the whole
global batch on every rank with no collective, as XLA runs a Pallas
call, which has no partitioning rule, on the gathered batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from hyperbolic_vae_tpu_torch.distributions.draws import row_window
from hyperbolic_vae_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, share


def runs_whole_batch(trainer) -> bool:
    """True when the Trainer's step has no row split: a ``train_step_fn``
    (it owns its gradients), or a ``loss_fn`` marked ``whole_batch``."""
    return (trainer.train_step_fn is not None
            or bool(getattr(trainer.loss_fn, "whole_batch", False)))


def loss_weight_kind(model) -> str:
    """How the model's loss combines over rows: ``per_sample_mean`` or
    ``batch_sum``; a loss that mixes them raises."""
    if getattr(model, "mixed_loss_reduction", False):
        raise ValueError(f"{type(model).__name__}'s loss mixes a mean over rows with a sum over "
                         f"rows, so it cannot be split over a data mesh's ranks; train it "
                         f"without a mesh, or in a loss mode with one reduction")
    kind = getattr(model, "loss_reduction", "per_sample_mean")
    if kind not in ("per_sample_mean", "batch_sum"):
        raise ValueError(f"unknown loss_reduction {kind!r}")
    return kind


class RowShard:
    """One data rank's part of every global batch of ``batch_size`` rows
    in ``micro`` microbatches: its row positions in the batch, the draws'
    window, and the weighted all-reduce of its gradients and metrics."""

    def __init__(self, mesh: Mesh, batch_size: int, micro: int, kind: str, device):
        n, i = mesh.shape[DATA_AXIS], mesh.coord(DATA_AXIS)
        per = batch_size // micro
        if per < n:
            raise ValueError(f"a microbatch of {per} rows cannot give each of the {n} data "
                             f"ranks a row")
        self.lo, self.hi = share(per, n, i)
        self.per = per
        self.rows = (self.hi - self.lo) * micro
        self.positions = torch.tensor([m * per + j for m in range(micro)
                                       for j in range(self.lo, self.hi)], device=device)
        self.weight = (self.hi - self.lo) / per if kind == "per_sample_mean" else 1.0
        self.group = mesh.group(DATA_AXIS)

    def take(self, global_rows: torch.Tensor) -> torch.Tensor:
        """This rank's entries of the batch's (B,) row indices."""
        return global_rows.index_select(0, self.positions)

    def window(self):
        return row_window(self.lo, self.hi, self.per)

    def reduce(self, grads: List[torch.Tensor], metrics: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The gradients (in place) and the metrics summed over the data
        ranks, each rank's scaled by its weight, in one all-reduce."""
        vals = [v.detach().float().reshape(1) for v in metrics.values()]
        flat = torch.cat([g.detach().float().reshape(-1) for g in grads] + vals)
        flat.mul_(self.weight)
        dist.all_reduce(flat, group=self.group)
        off = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[off:off + n].view_as(g))
            off += n
        return {k: flat[off + j] for j, k in enumerate(metrics)}


def row_shard(trainer, batch_size: int) -> Optional[RowShard]:
    """The Trainer's row split of a ``batch_size`` batch under its mesh
    (None without a mesh, or for a whole-batch step)."""
    if trainer.mesh is None or runs_whole_batch(trainer):
        return None
    return RowShard(trainer.mesh, batch_size, trainer.grad_accum_steps,
                    loss_weight_kind(trainer.model), trainer.device)


class EvalShare:
    """One data rank's part of an evaluation over a mesh: its rows of
    each batch (draws cut from the batch's), weighted as in training, and
    the one all-reduce of the batches' metric rows. A batch of fewer rows
    than ranks runs whole on every rank, and rank 0's row alone counts."""

    def __init__(self, mesh: Mesh, kind: str):
        self.n, self.i = mesh.shape[DATA_AXIS], mesh.coord(DATA_AXIS)
        self.kind = kind
        self.group = mesh.group(DATA_AXIS)

    def span(self, rows: int) -> tuple:
        """This rank's [lo, hi) of a ``rows``-row batch (the whole batch
        when it has fewer rows than ranks)."""
        return share(rows, self.n, self.i) if rows >= self.n else (0, rows)

    def metrics(self, loss_fn, model, xb: torch.Tensor, generator):
        """(names, this rank's weighted metric row) for the batch ``xb``."""
        r = xb.shape[0]
        lo, hi = self.span(r)
        with row_window(lo, hi, r):
            m = loss_fn(model, xb[lo:hi], generator)
        row = torch.stack([v.detach().float().reshape(()) for v in m.values()])
        if r < self.n:
            row = row if self.i == 0 else torch.zeros_like(row)
        elif self.kind == "per_sample_mean":
            row = row * ((hi - lo) / r)
        return list(m), row

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.group)
        return t

    def gather(self, local: torch.Tensor, rows: int, axis: int = 0) -> torch.Tensor:
        """The whole batch's (``rows`` along ``axis``) values from each
        rank's ``span`` of them, in row order (all ranks get it)."""
        if rows < self.n:
            return local
        size = -(-rows // self.n)  # the longest span; shorter ones padded to it
        shape = list(local.shape)
        shape[axis] = size - local.shape[axis]
        full = gather_even(torch.cat([local, local.new_zeros(shape)], dim=axis), self.group,
                           self.n, axis)
        spans = [share(rows, self.n, j) for j in range(self.n)]
        return torch.cat([full.narrow(axis, j * size, hi - lo) for j, (lo, hi) in enumerate(spans)],
                         dim=axis)


def eval_share(trainer, loss_fn=None) -> Optional[EvalShare]:
    """The evaluation split of the Trainer's mesh (None without one, or
    for a whole-batch ``loss_fn``)."""
    if trainer.mesh is None or getattr(loss_fn, "whole_batch", False):
        return None
    return EvalShare(trainer.mesh, loss_weight_kind(trainer.model))


def gather_even(local: torch.Tensor, group, n: int, axis: int = 0) -> torch.Tensor:
    """The ``n`` ranks' equal pieces along ``axis``, concatenated in rank
    order (an all-gather)."""
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=axis)
