"""Streamed training: a train split larger than the card's memory stays on
the host and passes through the device in double-buffered blocks.

Port of ``hyperbolic_vae_tpu/train/streaming.py`` on the port's chunk
program (``Trainer.fit_streamed`` is the public entry point). The epoch is
J = n_train // block_rows equal blocks:

  * ``x_train`` stays on the host (numpy or ``np.memmap``), never staged
    or pinned whole. A host thread gathers the next block into one of two
    pinned staging buffers; a copy stream moves it into one of two device
    block buffers at fixed addresses, behind events, while the compute
    stream trains on the other buffer.
  * Each buffer has its own ``EpochProgram``, so each block's steps are
    the same captured graphs (``train/cuda_graph.py``) replayed on that
    buffer; the controllers, best tracking, checkpoints, resume and
    graceful stops are ``ChunkProgram``'s at K = 1, so they are ``fit``'s
    code. The val split stays resident.
  * The epoch's train metrics are the plain mean of the blocks' means, as
    JAX's ``sum(xs) / j_blocks``.

Block order (and with ``reshuffle="rows"`` the row permutation) comes from
``np.random.default_rng((seed, 0x5EED, epoch))`` exactly as in JAX, seeded
with the absolute epoch, so a resumed run replays the uninterrupted run's
schedule. Within a block the rows are shuffled on the device from the
fit's generator, as ``fit`` shuffles its split. With J = 1 no extra draws
are made and ``block_rows == n_train`` reproduces ``fit`` bit for bit. In
``block_order`` mode rows never cross block boundaries, so the
n % block_rows tail sits out every epoch (a warning says so).
"""

from __future__ import annotations

import contextlib
import functools
import logging
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.train.chunk_program import ChunkProgram
from hyperbolic_vae_tpu_torch.train.cuda_graph import Segment
from hyperbolic_vae_tpu_torch.train.epoch_program import EpochProgram

logger = logging.getLogger(__name__)

RESHUFFLE_MODES = ("block_order", "rows")


def check_blocks(n_train: int, batch_size: int, block_rows: int, reshuffle: str) -> int:
    """J, the blocks an epoch trains; raises on a configuration JAX
    refuses and warns about the tail ``block_order`` leaves out."""
    if reshuffle not in RESHUFFLE_MODES:
        raise ValueError(f"reshuffle must be one of {RESHUFFLE_MODES}, got {reshuffle!r}")
    if block_rows < batch_size:
        raise ValueError(f"block_rows {block_rows} < batch_size {batch_size}")
    j_blocks = n_train // block_rows
    if j_blocks < 1:
        raise ValueError(f"block_rows {block_rows} > n_train {n_train}")
    if n_train % block_rows and reshuffle == "block_order":
        logger.warning(
            "fit_streamed(block_order): the %d-row tail (n_train %% block_rows) is excluded "
            "from every epoch; pass reshuffle='rows' to mix it in",
            n_train - j_blocks * block_rows)
    return j_blocks


def block_schedule(seed: int, epoch: int, n_train: int, block_rows: int,
                   reshuffle: str) -> List:
    """What each block of ``epoch`` holds, in order: a ``slice`` of the
    host split, or (``rows`` mode) an index array. JAX's draws."""
    j_blocks = n_train // block_rows
    rng = np.random.default_rng((seed, 0x5EED, epoch))
    if reshuffle == "rows" and j_blocks > 1:
        perm = rng.permutation(n_train)[: j_blocks * block_rows]
        return [perm[i * block_rows:(i + 1) * block_rows] for i in range(j_blocks)]
    order = rng.permutation(j_blocks) if j_blocks > 1 else np.arange(1)
    return [slice(int(j) * block_rows, (int(j) + 1) * block_rows) for j in order]


class StreamedProgram(ChunkProgram):
    """``ChunkProgram`` whose train epoch is J blocks streamed from the host
    split ``x_host``. Blocks are numbered across epochs (g = epoch * J + i);
    block g goes through staging buffer and device buffer g mod 2 and runs
    that buffer's epoch program. ``issue_steps`` queues the copies and the
    replays in the epoch's block order, gathering two blocks ahead and
    queueing the next epoch's first copies before this epoch's val batches.

    On the card, ``copy_spans`` and ``compute_spans`` keep CUDA timing
    events around the latest copies and the latest blocks' and val passes'
    compute, to measure how much of the copies the compute hides."""

    def __init__(self, trainer, model, optimizer, x_host, block_rows: int, reshuffle: str,
                 x_val, batch_size: int, generator, start_epoch: int, *, loss_fn, hp=None,
                 sharded=None):
        dev = x_val.device
        self.x_host, self.block_rows, self.reshuffle = x_host, int(block_rows), reshuffle
        self.n_train = int(x_host.shape[0])
        self.j_blocks = self.n_train // self.block_rows
        self.seed = trainer.seed
        self.next_epoch = start_epoch
        self.cuda = dev.type == "cuda"
        shape = (self.block_rows, *x_host.shape[1:])
        nbuf = min(2, self.j_blocks)
        self.dev_bufs = [torch.zeros(shape, dtype=torch.float32, device=dev) for _ in range(nbuf)]
        self.host_bufs = [torch.empty(shape, dtype=torch.float32, pin_memory=self.cuda)
                          for _ in range(nbuf)]
        self.loaded: list = [None] * nbuf  # the block spec each device buffer holds
        self.t_acc = torch.zeros((), dtype=torch.float32, device=dev)  # resized at the first block
        self.copy_spans: deque = deque(maxlen=64)
        self.compute_spans: deque = deque(maxlen=64)
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(dev)
            self.copied = [torch.cuda.Event() for _ in range(nbuf)]
            self.free = [torch.cuda.Event() for _ in range(nbuf)]
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="block-gather")
        self._pending: dict = {}  # block g -> (spec, the gather's future or None)
        self._copies: dict = {}  # block g -> whether a copy was queued for it
        # an epoch's schedule, drawn once (gathers run at most an epoch ahead)
        self._schedule = functools.lru_cache(maxsize=2)(
            lambda epoch: block_schedule(self.seed, epoch, self.n_train, self.block_rows,
                                         self.reshuffle))
        super().__init__(trainer, model, optimizer, self.dev_bufs[0], x_val, batch_size,
                         generator, start_epoch, loss_fn=loss_fn, hp=hp, sharded=sharded)

    def _train_segments(self) -> list:
        tr, ep = self.trainer, self.ep
        self.eps = [ep] + [
            EpochProgram(ep.model, ep.optimizer, buf, ep.x_val, ep.batch_size, ep.generator,
                         shuffle=ep.shuffle, loss_fn=ep.loss_fn, train_step_fn=ep.train_step_fn,
                         finite_guard=ep.finite_guard, grad_accum_steps=ep.grad_accum_steps,
                         grad_clip_norm=ep.grad_clip_norm, shard=ep.shard, layout=ep.layout)
            for buf in self.dev_bufs[1:]]
        zero = (lambda: self.t_acc.zero_(),) if self.j_blocks > 1 else ()
        segs = [Segment((self.begin_controls,) + zero, 1, "begin epoch")]
        for s, e in enumerate(self.eps):
            # J = 1: the block's means are the epoch's, as in fit
            acc = (self._accumulate(e),) if self.j_blocks > 1 else ()
            if tr.train_step_fn is not None:
                segs.append(Segment((e.begin, *(e.step,) * e.steps, e.end_train) + acc, 1,
                                    f"block {s}"))
            else:
                segs += [Segment((e.begin,), 1, f"block {s} begin"),
                         Segment((e.step,), e.steps, f"block {s} step"),
                         Segment((e.end_train,) + acc, 1, f"block {s} means")]
        if self.j_blocks > 1:
            segs.append(Segment((self._block_means,), 1, "train means"))
        return segs

    @property
    def samples_per_epoch(self) -> int:
        return self.j_blocks * self.ep.steps * self.ep.batch_size

    def _accumulate(self, e: EpochProgram):
        def piece():
            if self.t_acc.shape != e.t_means.shape:
                self.t_acc = torch.zeros_like(e.t_means)
            self.t_acc.add_(e.t_means)
        return piece

    def _block_means(self) -> None:
        self.ep.t_means.copy_(self.t_acc / self.j_blocks)

    # ---- the host's side ------------------------------------------------

    def _gather(self, s: int, spec) -> None:
        """Block ``spec`` of the host split into staging buffer s, once the
        copy out of it that was queued last has finished."""
        if self.cuda:
            self.copied[s].synchronize()
        self.host_bufs[s].numpy()[...] = self.x_host[spec]

    def _prefetch(self, g: int) -> None:
        """Start gathering block g (unless its device buffer holds it)."""
        epoch, i = divmod(g, self.j_blocks)
        if g in self._pending or g in self._copies or epoch >= self.trainer.max_epochs:
            return
        spec = self._schedule(epoch)[i]
        s = g % len(self.dev_bufs)
        if isinstance(spec, slice) and self.loaded[s] == spec:
            self._pending[g] = (spec, None)
            return
        self._pending[g] = (spec, self._pool.submit(self._gather, s, spec))

    def _issue_copy(self, g: int) -> None:
        """Block g into its device buffer (unless the buffer holds it): its
        gathered staging buffer copied on the copy stream once the block
        that used the buffer last is done; then the next block through this
        staging buffer may be gathered."""
        if g in self._copies:
            return
        self._prefetch(g)
        s = g % len(self.dev_bufs)
        spec, fut = self._pending.pop(g)
        if fut is not None:
            fut.result()
            if self.cuda:
                with torch.cuda.stream(self.copy_stream):
                    self.copy_stream.wait_event(self.free[s])
                    with self._span(self.copy_spans):
                        self.dev_bufs[s].copy_(self.host_bufs[s], non_blocking=True)
                    self.copied[s].record()
            else:
                self.dev_bufs[s].copy_(self.host_bufs[s])
            self.loaded[s] = spec if isinstance(spec, slice) else None
        self._copies[g] = fut is not None
        self._prefetch(g + len(self.dev_bufs))

    def _issue_block(self, g: int) -> None:
        """Block g's replays on the compute stream, behind its copy."""
        s = g % len(self.dev_bufs)
        self._issue_copy(g)
        if self._copies.pop(g) and self.cuda:
            torch.cuda.current_stream(self.device).wait_event(self.copied[s])
        names = ([f"block {s}"] if self.trainer.train_step_fn is not None
                 else [f"block {s} begin"] + [f"block {s} step"] * self.eps[s].steps
                 + [f"block {s} means"])
        with self._span(self.compute_spans):
            for name in names:
                self.program.replay(name)
        if self.cuda:
            self.free[s].record()

    @contextlib.contextmanager
    def _span(self, spans: deque):
        """On the card, timing events recorded on the current stream around
        the block, kept in ``spans``."""
        if not self.cuda:
            yield
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        spans.append((start, end))

    def issue_steps(self, k: int):
        self._after_caller()

        def steps():
            self.program.capture()
            self.krow.zero_()
            for _ in range(k):
                g0 = self.next_epoch * self.j_blocks
                self.next_epoch += 1
                for g in range(g0, g0 + len(self.dev_bufs)):
                    self._prefetch(g)
                self.program.replay("begin epoch")
                yield
                for g in range(g0, g0 + self.j_blocks):
                    self._issue_block(g)
                    yield
                # the next epoch's first copies overlap this epoch's val
                # and the host's fetch of its metrics
                for g in range(g0 + self.j_blocks, g0 + self.j_blocks + len(self.dev_bufs)):
                    if g // self.j_blocks < self.trainer.max_epochs:
                        self._issue_copy(g)
                with self._span(self.compute_spans):
                    if self.j_blocks > 1:
                        self.program.replay("train means")
                    for _ in range(self.ep.eval_steps):
                        self.program.replay("val batch")
                    self.program.replay("val tail and epoch end")
                yield

        return steps()

    def close(self) -> None:
        """Stop the gather thread (at the end of the fit)."""
        self._pool.shutdown(wait=True)
        self._pending.clear()
        self._copies.clear()
