"""Evaluation after training: split metrics, the K-importance-weighted
bound, latent probes and posterior-mean embeddings.

Port of ``hyperbolic_vae_tpu/train/evaluation.py`` for one model on one
device. Each function takes the Trainer (model, device, seed) and
``params`` (a state_dict; ``None``: the model's current weights), and
leaves the Trainer's model as it is. Randomness, as in JAX: ``evaluate``
draws from seed + 1, ``evaluate_iwae`` from seed + 2 (for each batch
chunk in order, for each k chunk in order, eps (kc, rows, latent) from
one generator), ``evaluate_probe``'s subsample from numpy's
``default_rng(seed)``, so both packages pick the same rows.

Under the Trainer's mesh each is a collective call, made by every rank
with the same split: each rank computes its rows of every batch, with the
draws of the whole batch cut to them (``parallel/data_parallel.py``);
``evaluate``'s metric rows are summed over the ranks and
``evaluate_iwae``'s bounds gathered in row order, and ``encode_split``
serves through ``Inferencer(mesh=...)``. Every rank returns the result.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule
from hyperbolic_vae_tpu_torch.distributions.draws import row_window
from hyperbolic_vae_tpu_torch.models.iwae import combine_chunked_bounds
from hyperbolic_vae_tpu_torch.parallel.data_parallel import eval_share
from hyperbolic_vae_tpu_torch.probe import knn_accuracy, nearest_mean_accuracy
from hyperbolic_vae_tpu_torch.train.epoch_program import default_loss_fn, eval_full

__all__ = ["encode_split", "evaluate", "evaluate_iwae", "evaluate_probe"]


def model_with_params(trainer, params):
    """The Trainer's model when ``params`` is None or its own live weights
    (a callback's case), else a copy of it holding ``params``."""
    if params is None:
        return trainer.model
    live = trainer.model.state_dict()
    if live.keys() == params.keys() and all(
            params[k].data_ptr() == v.data_ptr() for k, v in live.items()):
        return trainer.model
    model = copy.deepcopy(trainer.model)
    model.load_state_dict(params)
    return model


@contextlib.contextmanager
def _scheduled(trainer, model):
    """Under a schedule (``beta_schedule``, ``hp_schedule``), each
    scheduled key of the model is the schedule's end,
    ``hp_schedule(max_epochs)`` (as JAX evaluates), as a 0-d tensor for the
    call only."""
    if not trainer.hp_keys:
        yield
        return
    end = trainer.hp_schedule(trainer.max_epochs)
    static = {k: getattr(model, k) for k in trainer.hp_keys}
    for k in trainer.hp_keys:
        setattr(model, k, torch.as_tensor(end[k], dtype=torch.float32).to(trainer.device))
    try:
        yield
    finally:
        for k, v in static.items():
            setattr(model, k, v)


def evaluate(trainer, dm: ArrayDataModule, params=None, split: str = "test",
             stream_block_rows: Optional[int] = None) -> dict:
    """Mean loss metrics over a split (eval fold with its tail batch),
    with draws from seed + 1. ``stream_block_rows`` m < n: the host split
    is copied to the device m rows at a time, each block evaluated as a
    split of its own and weighted by its row count (JAX's streamed
    evaluate; the draws continue through the blocks from the one seeded
    generator, so stochastic metrics agree with the resident path's in
    distribution, not bit for bit)."""
    model = model_with_params(trainer, params)
    gen = torch.Generator(device=trainer.device).manual_seed(trainer.seed + 1)
    loss_fn = trainer.loss_fn or default_loss_fn
    shard = eval_share(trainer, loss_fn)
    x_host = getattr(dm, f"x_{split}")
    n = int(x_host.shape[0])
    with _scheduled(trainer, model):
        if stream_block_rows and stream_block_rows < n:
            m = int(stream_block_rows)
            acc, names = None, None
            for start in range(0, n, m):
                blk = trainer._resident(x_host[start:start + m])
                names, means = eval_full(model, blk, dm.batch_size, gen, loss_fn, shard)
                r = blk.shape[0]
                vals = [v * r for v in means.tolist()]
                acc = vals if acc is None else [a + v for a, v in zip(acc, vals)]
            return {f"{split}/{k}": v / n for k, v in zip(names, acc)}
        names, means = eval_full(model, trainer._resident(x_host), dm.batch_size, gen, loss_fn,
                                 shard)
    return {f"{split}/{k}": v for k, v in zip(names, means.tolist())}


@torch.no_grad()
def evaluate_iwae(trainer, dm: ArrayDataModule, params=None, k: int = 5000,
                  split: str = "test", batch_chunk: int = 256, k_chunk: int = 500) -> float:
    """Mean K-importance-weighted log p(x) bound over a split. The split
    streams in ``batch_chunk`` rows and K in ``k_chunk`` independent sample
    chunks, recombined exactly (``combine_chunked_bounds``), so no
    (K, B, data) tensor exists: a chunk's (k_chunk * rows, data) decode and
    its log density are the largest. The bound has no beta in it."""
    model = model_with_params(trainer, params)
    x = trainer._resident(np.asarray(getattr(dm, f"x_{split}"), np.float32))
    ks = [k_chunk] * (k // k_chunk) + ([k % k_chunk] if k % k_chunk else [])
    gen = torch.Generator(device=trainer.device).manual_seed(trainer.seed + 2)
    shard = eval_share(trainer)
    n = x.shape[0]
    sums = []
    for start in range(0, n, batch_chunk):
        xb = x[start:start + batch_chunk]
        if shard is None:
            bounds = [model.iwae(xb, kc, gen) for kc in ks]
            sums.append(combine_chunked_bounds(bounds, ks).sum())
            continue
        r = xb.shape[0]
        lo, hi = shard.span(r)
        with row_window(lo, hi, r):
            bounds = [model.iwae(xb[lo:hi], kc, gen) for kc in ks]
        sums.append(shard.gather(combine_chunked_bounds(bounds, ks), r).sum())
    # one fetch; each chunk's f32 sum added in order in float64, as JAX's
    # total += float(jnp.sum(chunk))
    return sum(torch.stack(sums).tolist()) / n


def encode_split(trainer, dm: ArrayDataModule, params=None, split: str = "val",
                 batch_size: Optional[int] = None):
    """Posterior means for a split (numpy (n, latent)) and its labels,
    through ``serve.Inferencer``'s padded fixed-batch path, so the largest
    activation is one batch. The Inferencer is cached on the Trainer (over
    its own copy of the model); ``params`` are swapped in for the call and
    released after it, so a one-off encode pins no weights for the
    Trainer's lifetime."""
    from hyperbolic_vae_tpu_torch.serve import Inferencer

    x = np.asarray(getattr(dm, f"x_{split}"), np.float32)
    bs = int(batch_size or dm.batch_size)
    if trainer.mesh is not None:
        # the Inferencer's rounding: its batch splits evenly over the data axis
        n_data = trainer.mesh.shape["data"]
        bs = -(-bs // n_data) * n_data
    inf = getattr(trainer, "_encode_inferencer", None)
    if inf is None or inf.batch_size != bs:
        inf = Inferencer(copy.deepcopy(trainer.model), batch_size=bs, device=trainer.device,
                         mesh=trainer.mesh)
        trainer._encode_inferencer = inf
    src = trainer.model.state_dict() if params is None else params
    weights = dict(inf.model.named_parameters())
    for name, p in weights.items():
        p.data = src[name].detach().to(device=inf.device, dtype=p.dtype)
    try:
        mu = inf.embed(x)
    finally:
        for p in weights.values():
            p.data = p.data.new_empty(0)
    return np.asarray(mu), np.asarray(getattr(dm, f"y_{split}"))


def evaluate_probe(trainer, dm: ArrayDataModule, params=None, k: int = 10,
                   train_split: str = "train", eval_split: str = "test",
                   max_train: int = 20000) -> dict:
    """Latent-probe accuracies (``probe.py``): kNN and nearest Frechet mean
    under the model's latent metric, on posterior-mean embeddings. The
    reference set is at most ``max_train`` rows, a subsample drawn as JAX
    draws it."""
    z_tr, y_tr = encode_split(trainer, dm, params, train_split)
    if len(z_tr) > max_train:
        idx = np.random.default_rng(trainer.seed).choice(len(z_tr), max_train, replace=False)
        z_tr, y_tr = z_tr[idx], np.asarray(y_tr)[idx]
    z_te, y_te = encode_split(trainer, dm, params, eval_split)
    ball = getattr(trainer.model, "ball", None)
    dev = trainer.device
    return {
        f"{eval_split}/probe_knn{k}_acc": float(
            knn_accuracy(z_tr, y_tr, z_te, y_te, ball=ball, k=k, device=dev)),
        f"{eval_split}/probe_nearest_mean_acc": float(
            nearest_mean_accuracy(z_tr, y_tr, z_te, y_te, ball=ball, device=dev)),
    }
