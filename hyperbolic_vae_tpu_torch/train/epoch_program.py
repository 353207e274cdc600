"""One training epoch and the split-exact eval, on the device.

Port of ``hyperbolic_vae_tpu/train/epoch_program.py`` (the single-model
path). JAX compiles the epoch into one ``lax.scan``; here it is a Python
loop over steps that queues work on the device and never waits for it:
the batch order is drawn on the device, each step's metrics stay device
tensors, the finite guard is a device-side flag handed to the optimizer,
and the caller fetches the epoch means once. The default step also takes
JAX's gradient accumulation (A microbatches, one eps draw each) and
global-norm gradient clipping.

Randomness: one ``torch.Generator`` on the device, drawn in a fixed
order: the epoch's batch order, then one eps (B, latent) per step from
the loss (one per microbatch with accumulation). The fused and the plain
loss and the fused train step draw eps alike, so with one seed they see
the same draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def default_loss_fn(model, batch, generator: Optional[torch.Generator] = None) -> dict:
    return model.loss(batch, generator)


def _stack(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([v.detach().float().reshape(()) for v in metrics.values()])


def _grads_and_metrics(model, optimizer, batch, generator, loss_fn, grad_accum_steps: int):
    """Fill each parameter's ``.grad`` and return the detached metrics.
    With ``grad_accum_steps`` A > 1 the batch is A equal microbatches in
    order, each with its own eps draw; their gradients are summed by
    backward and they and the metrics are scaled by 1/A (exact for the
    per-sample-mean losses of the port's models), as JAX's scan does."""
    optimizer.zero_grad(set_to_none=True)
    if grad_accum_steps == 1:
        metrics = loss_fn(model, batch, generator)
        metrics["loss_total"].backward()
        return {k: v.detach() for k, v in metrics.items()}
    sums = None
    for micro in batch.reshape(grad_accum_steps, -1, *batch.shape[1:]):
        m = loss_fn(model, micro, generator)
        m["loss_total"].backward()
        m = {k: v.detach() for k, v in m.items()}
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    inv = 1.0 / grad_accum_steps
    for g in optimizer.param_groups:
        for p in g["params"]:
            if p.grad is not None:
                p.grad.mul_(inv)
    return {k: v * inv for k, v in sums.items()}


def train_step(model, optimizer, batch, generator, loss_fn: Callable = default_loss_fn,
               finite_guard: bool = True, grad_accum_steps: int = 1,
               grad_clip_norm: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """Loss, backward, optimizer step. With ``finite_guard`` a step whose
    loss or global gradient norm is not finite changes nothing (params,
    moments, step count) and counts 1 in ``skipped_steps``; the decision
    stays on the device. ``grad_accum_steps``: see ``_grads_and_metrics``.
    ``grad_clip_norm`` c scales the (Euclidean) gradients by one shared
    min(1, c / ||g||) before the optimizer (torch ``clip_grad_norm_``
    semantics, as JAX's Trainer)."""
    metrics = _grads_and_metrics(model, optimizer, batch, generator, loss_fn, grad_accum_steps)
    loss = metrics["loss_total"]
    if finite_guard or grad_clip_norm is not None:
        grads = [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
        g2 = torch.stack([(g * g).sum() for g in grads]).sum()
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
    metrics["skipped_steps"] = skipped
    return metrics


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


def train_epoch(model, optimizer, x_all: torch.Tensor, batch_size: int, generator, *,
                shuffle: str = "row", loss_fn: Callable = default_loss_fn,
                train_step_fn: Optional[Callable] = None, finite_guard: bool = True,
                grad_accum_steps: int = 1, grad_clip_norm: Optional[float] = None):
    """One epoch over ``x_all`` (already on the device). Returns (names,
    means): the metric names and a device tensor of their epoch means.
    A ``train_step_fn`` replaces the whole step, its finite guard
    included: ``finite_guard``, ``grad_accum_steps`` and ``grad_clip_norm``
    apply to the default step only."""
    idx = batch_indices(x_all.shape[0], batch_size, shuffle, generator, x_all.device)
    rows, names = [], None
    for s in range(idx.shape[0]):
        batch = x_all.index_select(0, idx[s])
        if train_step_fn is not None:
            m = train_step_fn(model, optimizer, batch, generator)
        else:
            m = train_step(model, optimizer, batch, generator, loss_fn, finite_guard,
                           grad_accum_steps, grad_clip_norm)
        names = names or list(m)
        rows.append(_stack(m))
    return names, torch.stack(rows).mean(dim=0)


@torch.no_grad()
def eval_full(model, x_all: torch.Tensor, batch_size: int, generator,
              loss_fn: Callable = default_loss_fn):
    """Mean metrics over the whole split, in order: n // b batches of
    b = min(batch_size, n) rows, then the n % b tail as one batch folded in
    by sample count. Returns (names, means) as ``train_epoch`` does."""
    n = x_all.shape[0]
    eval_batch = min(batch_size, n)
    eval_steps = max(n // eval_batch, 1)
    rem = n - eval_steps * eval_batch
    rows, names = [], None
    for s in range(eval_steps):
        m = loss_fn(model, x_all[s * eval_batch:(s + 1) * eval_batch], generator)
        names = names or list(m)
        rows.append(_stack(m))
    means = torch.stack(rows).mean(dim=0)
    if rem:
        start = eval_steps * eval_batch
        tail = _stack(loss_fn(model, x_all[start:start + rem], generator))
        means = means * ((eval_steps * eval_batch) / n) + tail * (rem / n)
    return names, means
