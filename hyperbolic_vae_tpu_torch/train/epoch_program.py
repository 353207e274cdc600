"""One training epoch and the split-exact eval, on the device.

Port of ``hyperbolic_vae_tpu/train/epoch_program.py`` (the single-model
path). JAX compiles the epoch into one ``lax.scan``; here it is
:class:`EpochProgram`, pieces of work on tensors allocated once that
queue work on the device and never wait for it: the batch order is drawn
on the device, each step's metrics go into a preallocated row, the
finite guard is a device-side flag handed to the optimizer, and the
caller fetches the means once per chunk. On the card the pieces are
replayed from CUDA graphs (``train/cuda_graph.py``). The default step
also takes JAX's gradient accumulation (A microbatches, one eps draw
each) and global-norm gradient clipping. Under a data mesh
(``parallel/data_parallel.py``) a step trains on this rank's rows of the
global batch, its draws cut from the global batch's, and sums the
gradients and metrics over the ranks before the guard and the update.
Under a parameter layout (``parallel/fsdp.py``) the optimizer steps the
layout's masters: the working gradients are reduced into theirs, the
guard and clipping read the global norm, and the updated masters are
gathered back into the working tensors.

Randomness: one ``torch.Generator`` on the device, drawn in a fixed
order: the epoch's batch order, then one eps (B, latent) per step from
the loss (one per microbatch with accumulation). The fused and the plain
loss and the fused train step draw eps alike, so with one seed they see
the same draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import contextlib

import torch


def default_loss_fn(model, batch, generator: Optional[torch.Generator] = None) -> dict:
    return model.loss(batch, generator)


def _stack(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([v.detach().float().reshape(()) for v in metrics.values()])


def _grads_and_metrics(model, optimizer, batch, generator, loss_fn, grad_accum_steps: int,
                       layout=None, nan_check: Optional[NanCheck] = None):
    """Fill each parameter's ``.grad`` and return the detached metrics.
    With ``grad_accum_steps`` A > 1 the batch is A equal microbatches in
    order, each with its own eps draw; their gradients are summed by
    backward and they and the metrics are scaled by 1/A (exact for the
    per-sample-mean losses of the port's models), as JAX's scan does.
    Under a ``layout`` the gradients land on the model's working tensors.
    ``nan_check``: each backward's gradients checked (``NanCheck``)."""
    backward = ((lambda loss: loss.backward()) if nan_check is None
                else (lambda loss: nan_check.backward(loss, model)))
    optimizer.zero_grad(set_to_none=True)
    if layout is not None:
        model.zero_grad(set_to_none=True)
    if grad_accum_steps == 1:
        metrics = loss_fn(model, batch, generator)
        backward(metrics["loss_total"])
        return {k: v.detach() for k, v in metrics.items()}
    sums = None
    for micro in batch.reshape(grad_accum_steps, -1, *batch.shape[1:]):
        m = loss_fn(model, micro, generator)
        backward(m["loss_total"])
        m = {k: v.detach() for k, v in m.items()}
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    inv = 1.0 / grad_accum_steps
    held = (list(model.parameters()) if layout is not None
            else [p for g in optimizer.param_groups for p in g["params"]])
    for p in held:
        if p.grad is not None:
            p.grad.mul_(inv)
    return {k: v * inv for k, v in sums.items()}


def train_step(model, optimizer, batch, generator, loss_fn: Callable = default_loss_fn,
               finite_guard: bool = True, grad_accum_steps: int = 1,
               grad_clip_norm: Optional[float] = None, shard=None,
               layout=None, nan_check: Optional[NanCheck] = None) -> Dict[str, torch.Tensor]:
    """Loss, backward, optimizer step. With ``finite_guard`` a step whose
    loss or global gradient norm is not finite changes nothing (params,
    moments, step count) and counts 1 in ``skipped_steps``; the decision
    stays on the device. ``grad_accum_steps``: see ``_grads_and_metrics``.
    ``grad_clip_norm`` c scales the (Euclidean) gradients by one shared
    min(1, c / ||g||) before the optimizer (torch ``clip_grad_norm_``
    semantics, as JAX's Trainer). ``shard`` (a ``data_parallel.RowShard``):
    ``batch`` is this rank's rows of the global batch; the draws are cut
    from the global batch's, and the gradients and metrics are summed over
    the data ranks before the guard. ``layout`` (a ``fsdp.ShardedState``):
    the optimizer holds the layout's masters; their gradients come from
    the working tensors', the norm is the global one, and the masters are
    gathered into the working tensors after the update. ``nan_check``
    (``debug_nans``): the gradients of each backward checked. Where nothing
    else needs the norm (no layout, no clipping), the optimizer computes the
    guard itself, ``optimizer.step(guard=loss)``: on the card the first
    launch of ``RiemannianAdam``'s kernel pair."""
    with shard.window() if shard is not None else contextlib.nullcontext():
        metrics = _grads_and_metrics(model, optimizer, batch, generator, loss_fn,
                                     grad_accum_steps, layout, nan_check)
    if layout is not None:
        metrics = layout.reduce_grads(metrics, shard)
    elif shard is not None:
        metrics = shard.reduce([p.grad for g in optimizer.param_groups for p in g["params"]
                                if p.grad is not None], metrics)
    loss = metrics["loss_total"]
    if finite_guard and layout is None and grad_clip_norm is None:
        ok = optimizer.step(guard=loss)
        metrics["skipped_steps"] = 1.0 - ok.float()
        return metrics
    if finite_guard or grad_clip_norm is not None:
        grads = [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
        g2 = (torch.stack([(g * g).sum() for g in grads]).sum() if layout is None
              else layout.global_sq_norm())
    if grad_clip_norm is not None:
        scale = (grad_clip_norm / torch.sqrt(g2).clamp_min(1e-12)).clamp_max(1.0)
        for g in grads:
            g.mul_(scale)
    if finite_guard:
        ok = torch.isfinite(loss) & torch.isfinite(g2)
        optimizer.step(ok=ok)
        skipped = 1.0 - ok.float()
    else:
        optimizer.step()
        skipped = torch.zeros((), device=loss.device)
    if layout is not None:
        layout.gather_working()
    metrics["skipped_steps"] = skipped
    return metrics


class NanCheck:
    """``Trainer(debug_nans=True)``'s check, the counterpart of JAX's
    ``jax_debug_nans``: every loss the fit computes (each train step's
    before its backward, each val batch's), every step's metrics (K3's
    loss among them) and every backward's gradients are read on the host,
    and a non-finite one raises ``FloatingPointError`` naming the epoch,
    the step and the metric or parameter. A backward whose gradients are
    not finite is run again on its retained graph under autograd's
    anomaly mode, which names the operation that returned NaN: anomaly
    mode over every step costs the flagship's eager step ~12x on an H100
    (``chip_smoke.py`` api (b)), this one host read a backward. The fit's
    epoch counter and a step counter are read only when it raises. Only
    for eager runs: a read on the host cannot be captured in a CUDA
    graph."""

    def __init__(self, epoch: torch.Tensor):
        self.epoch = epoch
        self.what, self.ctr = "step", None

    def at(self, what: str, ctr: Optional[torch.Tensor]) -> None:
        """The step the next checks belong to (``ctr``: its counter)."""
        self.what, self.ctr = what, ctr

    def where(self) -> str:
        step = "" if self.ctr is None else f" {int(self.ctr)}"
        return f"epoch {int(self.epoch)}, {self.what}{step}"

    def check(self, metrics: Dict[str, torch.Tensor]) -> None:
        if bool(torch.isfinite(_stack(metrics)).all()):
            return
        bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v).all())]
        raise FloatingPointError(f"debug_nans: non-finite {', '.join(bad)} at {self.where()}")

    def loss_fn(self, fn: Callable) -> Callable:
        """``fn`` with its metrics checked."""
        def checked(model, batch, generator=None):
            metrics = fn(model, batch, generator)
            self.check(metrics)
            return metrics
        return checked

    def backward(self, loss: torch.Tensor, model) -> None:
        """``loss.backward()``, its gradients checked; where one is not
        finite, the backward again under anomaly mode, then raise."""
        loss.backward(retain_graph=True)
        named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
        if not named or bool(torch.stack([torch.isfinite(g).all() for _, g in named]).all()):
            return
        bad = [n for n, g in named if not bool(torch.isfinite(g).all())]
        where = f"non-finite gradient of {', '.join(bad)} at {self.where()}"
        model.zero_grad(set_to_none=True)
        try:
            with torch.autograd.detect_anomaly(check_nan=True):
                loss.backward()
        except RuntimeError as e:
            if "nan values" not in str(e):
                raise
            raise FloatingPointError(f"debug_nans: {where}: {e}") from e
        raise FloatingPointError(f"debug_nans: {where}")


def batch_indices(n: int, batch_size: int, shuffle: str, generator, device) -> torch.Tensor:
    """(steps, batch_size) row indices of one epoch, drawn on the device:
    ``row`` is a fresh permutation cut to steps * batch_size rows;
    ``block`` gives each step a contiguous window at a uniform random start."""
    steps = n // batch_size
    if shuffle == "row":
        perm = torch.randperm(n, generator=generator, device=device)
        return perm[: steps * batch_size].view(steps, batch_size)
    if shuffle == "block":
        starts = torch.randint(0, n - batch_size + 1, (steps,), generator=generator, device=device)
        return starts[:, None] + torch.arange(batch_size, device=device)
    raise ValueError(f"shuffle must be 'row' or 'block', got {shuffle!r}")


class EpochProgram:
    """One epoch over staged splits as pieces on tensors allocated once,
    each free of host syncs, so that a piece, or a run of them, can be
    captured in a CUDA graph and replayed (``train/cuda_graph.py``):

      * ``begin``: the epoch's batch order into the static (steps, B)
        index matrix; the step counters to 0;
      * ``step``: the batch of the step counter's row, ``index_select``ed
        into the static batch buffer; one training step (``train_step``,
        or ``train_step_fn``, which replaces it with its own guard); its
        metrics into row ``counter`` of the (steps, n_metrics) rows; the
        counter + 1;
      * ``end_train``: the epoch's train means;
      * ``val_step``: one full val batch, the same way, into the val rows;
      * ``val_tail``: the n % b tail as one batch; ``end_val``: the val
        means, the tail folded in by sample count (``eval_full``'s math).

    The metric names come from the first step and the first val batch
    (``t_names``, ``v_names``); their rows are allocated then.
    ``nan_check`` (a :class:`NanCheck`): every loss and step checked on
    the host (eager runs only)."""

    def __init__(self, model, optimizer, x_train: torch.Tensor, x_val: torch.Tensor,
                 batch_size: int, generator, *, shuffle: str = "row",
                 loss_fn: Callable = default_loss_fn, train_step_fn: Optional[Callable] = None,
                 finite_guard: bool = True, grad_accum_steps: int = 1,
                 grad_clip_norm: Optional[float] = None, shard=None, layout=None,
                 nan_check: Optional[NanCheck] = None):
        self.model, self.optimizer, self.generator = model, optimizer, generator
        self.x_train, self.x_val = x_train, x_val
        self.shuffle, self.loss_fn, self.train_step_fn = shuffle, loss_fn, train_step_fn
        self.nan_check = nan_check
        self._loss = nan_check.loss_fn(loss_fn) if nan_check is not None else loss_fn
        self.finite_guard, self.grad_accum_steps = finite_guard, grad_accum_steps
        self.grad_clip_norm = grad_clip_norm
        self.shard = shard  # this rank's rows of every train batch (None: all of them)
        self.layout = layout  # the parameters' layout (None: the model's own tensors)
        dev = x_train.device
        self.batch_size = batch_size
        self.steps = x_train.shape[0] // batch_size
        n_val = x_val.shape[0]
        self.eval_batch = min(batch_size, n_val)
        self.eval_steps = max(n_val // self.eval_batch, 1)
        self.rem = n_val - self.eval_steps * self.eval_batch
        self.idx = torch.zeros((self.steps, batch_size), dtype=torch.long, device=dev)
        self.val_idx = torch.arange(self.eval_steps * self.eval_batch, device=dev).view(
            self.eval_steps, self.eval_batch)
        rows = shard.rows if shard is not None else batch_size
        self.batch = torch.empty((rows, *x_train.shape[1:]), dtype=x_train.dtype, device=dev)
        self.val_batch = torch.empty((self.eval_batch, *x_val.shape[1:]), dtype=x_val.dtype,
                                     device=dev)
        self.step_ctr = torch.zeros((), dtype=torch.long, device=dev)
        self.val_ctr = torch.zeros((), dtype=torch.long, device=dev)
        self.t_names = self.v_names = None
        self.t_rows = self.v_rows = self.v_tail = self.t_means = self.v_means = None

    def _record(self, which: str, ctr: torch.Tensor, metrics: Dict[str, torch.Tensor]) -> None:
        row = _stack(metrics)
        rows = getattr(self, f"{which}_rows")
        if rows is None:
            n = self.steps if which == "t" else self.eval_steps
            rows = torch.zeros((n, row.numel()), dtype=torch.float32, device=ctr.device)
            setattr(self, f"{which}_rows", rows)
            setattr(self, f"{which}_names", list(metrics))
            setattr(self, f"{which}_means", torch.zeros(row.numel(), dtype=torch.float32,
                                                       device=ctr.device))
        rows.index_copy_(0, ctr.view(1), row.view(1, -1))
        ctr.add_(1)

    def begin(self) -> None:
        self.idx.copy_(batch_indices(self.x_train.shape[0], self.batch_size, self.shuffle,
                                     self.generator, self.idx.device))
        self.step_ctr.zero_()
        self.val_ctr.zero_()

    def step(self) -> None:
        rows = self.idx.index_select(0, self.step_ctr.view(1)).view(-1)
        if self.shard is not None:
            rows = self.shard.take(rows)
        torch.index_select(self.x_train, 0, rows, out=self.batch)
        check = self.nan_check
        if check is not None:
            check.at("train step", self.step_ctr)
        if self.train_step_fn is not None:
            m = self.train_step_fn(self.model, self.optimizer, self.batch, self.generator)
        else:
            m = train_step(self.model, self.optimizer, self.batch, self.generator, self._loss,
                           self.finite_guard, self.grad_accum_steps, self.grad_clip_norm,
                           self.shard, self.layout, check)
        if check is not None:
            check.check(m)
        self._record("t", self.step_ctr, m)

    def end_train(self) -> None:
        self.t_means.copy_(self.t_rows.mean(dim=0))

    @torch.no_grad()
    def val_step(self) -> None:
        rows = self.val_idx.index_select(0, self.val_ctr.view(1)).view(-1)
        torch.index_select(self.x_val, 0, rows, out=self.val_batch)
        if self.nan_check is not None:
            self.nan_check.at("val batch", self.val_ctr)
        self._record("v", self.val_ctr, self._loss(self.model, self.val_batch, self.generator))

    @torch.no_grad()
    def val_tail(self) -> None:
        start = self.eval_steps * self.eval_batch
        if self.nan_check is not None:
            self.nan_check.at("val tail", None)
        tail = _stack(self._loss(self.model, self.x_val[start:], self.generator))
        if self.v_tail is None:
            self.v_tail = torch.zeros_like(tail)
        self.v_tail.copy_(tail)

    def end_val(self) -> None:
        means = self.v_rows.mean(dim=0)
        if self.rem:
            n = self.x_val.shape[0]
            done = self.eval_steps * self.eval_batch
            means = means * (done / n) + self.v_tail * (self.rem / n)
        self.v_means.copy_(means)


@torch.no_grad()
def eval_full(model, x_all: torch.Tensor, batch_size: int, generator,
              loss_fn: Callable = default_loss_fn, shard=None):
    """Mean metrics over the whole split, in order: n // b batches of
    b = min(batch_size, n) rows, then the n % b tail as one batch folded in
    by sample count. Returns (names, means) as ``train_epoch`` does.
    ``shard`` (a ``data_parallel.EvalShare``): each rank computes its rows
    of every batch and the batches' metric rows are summed over the data
    ranks in one all-reduce."""
    n = x_all.shape[0]
    eval_batch = min(batch_size, n)
    eval_steps = max(n // eval_batch, 1)
    rem = n - eval_steps * eval_batch
    spans = [(s * eval_batch, eval_batch) for s in range(eval_steps)]
    if rem:
        spans.append((eval_steps * eval_batch, rem))
    rows, names = [], None
    for start, r in spans:
        xb = x_all[start:start + r]
        if shard is None:
            m = loss_fn(model, xb, generator)
            names, row = names or list(m), _stack(m)
        else:
            names, row = shard.metrics(loss_fn, model, xb, generator)
        rows.append(row)
    rows = torch.stack(rows)
    if shard is not None:
        shard.reduce(rows)
    means = rows[:eval_steps].mean(dim=0)
    if rem:
        means = means * ((eval_steps * eval_batch) / n) + rows[eval_steps] * (rem / n)
    return names, means
