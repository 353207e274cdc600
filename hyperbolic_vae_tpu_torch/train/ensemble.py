"""Seed ensembles and hyperparameter-lane sweeps: S complete fits at once.

Port of ``hyperbolic_vae_tpu/train/ensemble.py``. The reference's real
workloads are sweeps: the 8-seed parity protocol, experiment 7's
curvature x beta grid, experiment 9's replication. JAX runs the S lanes as
one ``vmap`` of the chunk program. Here each lane is its own fit
(``trainer._Run``): its own concrete model (``hp_model_fn(lane)`` in lane
sweeps, a copy of the Trainer's in seed ensembles), ``RiemannianAdam``,
``torch.Generator`` seeded as ``fit(seed=s)`` seeds it, device
controllers and captured CUDA graphs, every lane on one staged copy of
``x_train`` and ``x_val``. A chunk queues every live lane's graph
replays, each lane on its own CUDA stream, and only then fetches each
lane's rows and controllers. So every lane is exactly what a sequential
``fit`` of that lane gives, bit for bit, curvature included (JAX traces
the curvature and holds lanes to 2e-4).

A lane that has stopped is no longer replayed (JAX keeps it in every
dispatch and masks its result: the same values). The sweep saves every
lane's resume state at each chunk boundary under ``"ensemble_state"``
(with a ``checkpoint_dir``), stops gracefully at a chunk boundary
(``preempt_signals``, ``max_wall_seconds``) and continues bit for bit
with ``resume=True``. Callbacks are not supported.

``seed_mesh`` (``parallel.make_seed_mesh``) spreads the lanes over its
ranks, S / N on each, each rank's lanes on its own streams as above, with
no collective until one gather of the results at the end, so every rank
returns every lane's ``TrainResult``. S must divide by N, and a Trainer
with a data mesh refuses a sweep, as in JAX. Each rank saves and resumes
its own lanes (``ensemble_state_rank<r>of<N>``; at N = 1 the unit is
``ensemble_state``, the unmeshed sweep's) and stops gracefully on its
own; each writes its own lanes' metric files.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import math
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule
from hyperbolic_vae_tpu_torch.optim import EarlyStopping, ReduceLROnPlateau
from hyperbolic_vae_tpu_torch.parallel.mesh import SEED_AXIS
from hyperbolic_vae_tpu_torch.train.evaluation import evaluate
from hyperbolic_vae_tpu_torch.train.metrics import MetricLogger
from hyperbolic_vae_tpu_torch.train.trainer import _Run, init_params_of

logger = logging.getLogger(__name__)

STATE_UNIT = "ensemble_state"
RESERVED_KEYS = ("seed", "lr")


def _lane_trainer(trainer, model, seed: int, lr: float):
    """The Trainer as a sequential fit of one lane sees it: ``model``,
    ``seed`` and ``lr``, and no callbacks, checkpoints or logger of its
    own (the sweep owns those)."""
    lane = copy.copy(trainer)
    lane.model, lane.seed, lane.lr = model, int(seed), float(lr)
    lane._plateau_cfg = dict(trainer._plateau_cfg, lr=float(lr))
    lane.callbacks, lane._ckpt_mgr, lane.hp_model_fn = [], None, None
    lane.metric_logger = MetricLogger(None)
    lane.optimizer = lane.program = None
    return lane


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_ensemble(trainer, dm: ArrayDataModule, seeds: Sequence[int],
                 epochs_per_dispatch: Optional[int] = None, seed_mesh=None, lane_hparams=None,
                 lane_lrs=None, resume: bool = False) -> list:
    """Train ``len(seeds)`` lanes at once; one ``TrainResult`` per lane, in
    order, each what ``Trainer(model, seed=s, lr=lr).fit(dm,
    params=init_params(s))`` gives, bit for bit.

    ``lane_hparams`` (with ``Trainer(hp_model_fn=...)``): one dict of
    scalars per lane, the same keys in each; lane i trains
    ``hp_model_fn(lane_hparams[i])``, initialised from its seed as that
    model's own fresh weights. ``lane_lrs``: each lane's first lr (the
    plateau controller's start). ``fit_lane_sweep`` is the front end.

    ``samples_per_sec`` on every result is the sweep's aggregate: train
    samples over all lanes a second after the first chunk (which
    captures the graphs); when the sweep is one chunk, the chunk is
    replayed once from its first state to time it, and put back; under a
    ``seed_mesh`` the ranks' aggregates summed. ``seed_mesh``: the lanes
    spread over its ranks (module docstring)."""
    if trainer.mesh is not None:
        raise ValueError("fit_ensemble is single-device; it does not compose with a mesh "
                         "(spread the lanes with seed_mesh instead)")
    if trainer.callbacks:
        raise ValueError("fit_ensemble does not support callbacks")
    if trainer.monitor.partition("/")[0] not in ("val", "train"):
        raise ValueError(f"fit_ensemble requires a val/ or train/ monitor, got {trainer.monitor}")
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("fit_ensemble needs at least one seed")
    n = len(seeds)
    n_ranks, rank, unit_name = 1, 0, STATE_UNIT
    if seed_mesh is not None:
        if SEED_AXIS not in seed_mesh.shape:
            raise ValueError(f"seed_mesh needs a {SEED_AXIS!r} axis (make_seed_mesh), got "
                             f"{seed_mesh.shape}")
        n_ranks, rank = seed_mesh.shape[SEED_AXIS], seed_mesh.coord(SEED_AXIS)
        if n % n_ranks:
            raise ValueError(f"{n} seeds do not shard evenly over {n_ranks} devices")
        if seed_mesh.device != trainer.device:
            raise ValueError(f"the seed mesh's rank runs on {seed_mesh.device}, the Trainer on "
                             f"{trainer.device}")
        if n_ranks > 1:
            unit_name = f"{STATE_UNIT}_rank{rank}of{n_ranks}"
    mine = range(rank * (n // n_ranks), (rank + 1) * (n // n_ranks))
    fingerprint = None
    if lane_hparams is not None:
        if trainer.hp_model_fn is None:
            raise ValueError("lane_hparams requires Trainer(hp_model_fn=...)")
        lane_hparams = [dict(h) for h in lane_hparams]
        if len(lane_hparams) != n:
            raise ValueError("need one hparam dict per lane")
        keys = sorted(lane_hparams[0])
        if any(sorted(h) != keys for h in lane_hparams):
            raise ValueError("every lane must carry the same hparam keys")
        fingerprint = [{k: float(h[k]) for k in keys} for h in lane_hparams]
        if lane_lrs is not None:
            for row, lr in zip(fingerprint, lane_lrs):
                row["lr"] = float(lr)
    elif trainer.hp_model_fn is not None:
        raise ValueError("hp_model_fn trainers need lane_hparams (fit_lane_sweep)")
    if lane_lrs is not None and len(lane_lrs) != n:
        raise ValueError("need one lr per lane")
    trainer._check_batch(dm)
    k = int(epochs_per_dispatch or trainer.epochs_per_dispatch)
    # fresh host mirrors, as fit() leaves them for a later fit
    trainer.plateau = ReduceLROnPlateau(**trainer._plateau_cfg)
    if trainer._early_patience:
        trainer.early_stopping = EarlyStopping(patience=trainer._early_patience)
    lrs = [float(lr) for lr in lane_lrs] if lane_lrs is not None else [trainer.lr] * n
    models = {}
    for i in mine:
        model = (trainer.hp_model_fn(lane_hparams[i]) if lane_hparams is not None
                 else copy.deepcopy(trainer.model))
        if model.device != trainer.device:
            raise ValueError(f"lane {i}'s model is on {model.device}, the Trainer on "
                             f"{trainer.device}")
        models[i] = model

    mgr = trainer._ckpt_mgr
    saved, start_chunk = None, 0
    if resume and mgr is not None and mgr.has_state(unit_name):
        saved, meta = mgr.restore_state(device=trainer.device, name=unit_name)
        if meta["seeds"] != seeds:
            raise ValueError(f"ensemble resume: saved seeds {meta['seeds']} != requested {seeds}")
        if meta["lanes"] != fingerprint:
            raise ValueError(
                f"ensemble resume: saved lane hparams {meta['lanes']} != requested "
                f"{fingerprint}: resuming a different grid against this checkpoint would "
                f"train the old grid's state under the new hyperparameters")
        start_chunk = int(meta["chunk_next"])

    trainer._preflight(dm, list(models.values()))
    x_train, x_val = trainer._stage(dm.x_train), trainer._stage(dm.x_val)
    on_streams = trainer.device.type == "cuda" and trainer._lane_streams and len(mine) > 1
    runs = []
    try:
        for j, i in enumerate(mine):
            lane = _lane_trainer(trainer, models[i], seeds[i], lrs[i])
            lane.epochs_per_dispatch = k
            unit = saved["lanes"][j] if saved is not None else None
            runs.append(_Run(
                lane, dm.batch_size, x_train, x_val,
                params=None if unit else init_params_of(models[i], seeds[i], trainer.device),
                state=unit and unit["state"], meta=unit and unit["meta"],
                stream=torch.cuda.Stream(trainer.device) if on_streams else None))
        trainer.lane_programs = [r.prog for r in runs]
        sps = _sweep(trainer, runs, k, start_chunk,
                     {"seeds": seeds, "lanes": fingerprint}, unit_name)
        if trainer.metric_logger.log_dir:
            # per-lane metric files (lanes of a grid may share a seed)
            for i, r in zip(mine, runs):
                sub = f"lane_{i}" if lane_hparams is not None else f"seed_{seeds[i]}"
                ml = MetricLogger(str(trainer.metric_logger.log_dir / sub))
                for row in r.history:
                    ml.log_scalars(int(row["epoch"]), row)
                ml.close()
        trainer.metric_logger.close()
        results = []
        for i, r in zip(mine, runs):
            # the in-graph best tracking must agree with the host's reading
            if (math.isfinite(r.best_metric) or math.isfinite(r.ig_best)) and (
                    r.ig_best != r.best_metric):
                raise RuntimeError(f"lane {i}: best {r.ig_best} on the device, "
                                   f"{r.best_metric} in the history")
            results.append(r.result(sps, trainer._stop_reason))
        return _gather_lanes(seed_mesh, results, trainer.device) if seed_mesh else results
    finally:
        for r in runs:
            r.close()


def _gather_lanes(seed_mesh, results: list, device) -> list:
    """Every rank's lanes, in lane order, on every rank (the sweep's one
    collective): tensors through the host, ``samples_per_sec`` the sum of
    the ranks' aggregates."""
    def host(tree):
        return {k: v.cpu() for k, v in tree.items()} if tree is not None else None

    mine = [dataclasses.replace(r, params=host(r.params), best_params=host(r.best_params),
                                ema_params=host(r.ema_params)) for r in results]
    parts = [None] * seed_mesh.shape[SEED_AXIS]
    dist.all_gather_object(parts, mine, group=seed_mesh.group(SEED_AXIS))
    total = sum(part[0].samples_per_sec for part in parts)

    def dev(tree):
        return {k: v.to(device) for k, v in tree.items()} if tree is not None else None

    return [dataclasses.replace(r, params=dev(r.params), best_params=dev(r.best_params),
                                ema_params=dev(r.ema_params), samples_per_sec=total)
            for part in parts for r in part]


def issue_lanes(programs: Sequence, k: int) -> None:
    """Queue every lane's chunk of k epochs (``ChunkProgram``s), a graph
    replay of each lane in turn, each on its lane's stream: a lane queued
    whole would fill the card's launch queue, and the host would wait for
    it to drain before it queued the next lane."""
    done = object()
    pending = [(prog, prog.issue_steps(k)) for prog in programs]
    while pending:
        left = []
        for prog, steps in pending:
            with prog.on_stream():
                if next(steps, done) is not done:
                    left.append((prog, steps))
        pending = left


def _sweep(trainer, runs: list, k: int, start_chunk: int, meta: dict,
           unit_name: str = STATE_UNIT) -> float:
    """The sweep's chunk loop; returns the aggregate train samples/s."""
    mgr = trainer._ckpt_mgr
    per_epoch = runs[0].samples_per_epoch
    first_live = [r for r in runs if not r.stopped]
    for r in first_live:  # every capture first: a capture waits for the whole card
        r.prog.prepare()
    # a sweep of one chunk has no second chunk to time: keep its first
    # state to replay it once
    single = trainer.max_epochs - start_chunk <= k
    initial = [r.prog.program._snapshot() for r in first_live] if single else None
    total, session, t_start = 0, 0, None
    for n, chunk_start in enumerate(range(start_chunk, trainer.max_epochs, k)):
        k_eff = min(k, trainer.max_epochs - chunk_start)
        live = [r for r in runs if not r.stopped]
        with trainer._profiled(n == 1):
            issue_lanes([r.prog for r in live], k_eff)
            fetched = [r.prog.fetch(k_eff) for r in live]
        first = t_start is None
        if first:
            t_start = time.perf_counter()
        for r, (rows, ctrl) in zip(live, fetched):
            before = r.epochs_run
            r.absorb(rows, ctrl)
            session += r.epochs_run - before
            if not first:
                total += per_epoch * (r.epochs_run - before)
        if mgr is not None:
            lanes = []
            for r in runs:
                state, lane_meta = r.resume_state()
                lanes.append({"state": state, "meta": lane_meta})
            mgr.save_state({"lanes": lanes}, dict(meta, chunk_next=chunk_start + k_eff),
                           name=unit_name)
        if all(r.stopped for r in runs):
            break
        # a completed sweep is never interrupted
        done = chunk_start + k_eff >= trainer.max_epochs
        reason = None if done else trainer._external_stop()
        if reason:
            trainer._stop_reason = reason
            logger.warning("graceful stop after the sweep's chunk ending at epoch %d: %s",
                           chunk_start + k_eff - 1, reason)
            break
    if total == 0 and single and session > 0:
        # replay the captured chunk from its first state to time it; the
        # final state (and the launch counts) are put back after
        final = [r.prog.program._snapshot() for r in first_live]
        for r, snap in zip(first_live, initial):
            r.prog.program._restore(snap)
        _sync(trainer.device)
        t0 = time.perf_counter()
        issue_lanes([r.prog for r in first_live], trainer.max_epochs - start_chunk)
        for r in first_live:
            r.prog.fetch(trainer.max_epochs - start_chunk)
        elapsed = time.perf_counter() - t0
        for r, snap in zip(first_live, final):
            r.prog.program._restore(snap)
        _sync(trainer.device)
        return per_epoch * session / elapsed
    elapsed = time.perf_counter() - t_start if t_start is not None else 0.0
    return total / elapsed if total else 0.0


def fit_lane_sweep(trainer, dm: ArrayDataModule, lanes: Sequence[dict],
                   epochs_per_dispatch: Optional[int] = None, seed_mesh=None,
                   resume: bool = False) -> list:
    """Hyperparameter lanes, one dict each, e.g. ``{"seed": 42, "lr":
    1e-3, "manifold_curvature": 0.5, "beta": 3.0}``: lane i trains
    ``trainer.hp_model_fn`` of its dict without the reserved keys
    ``seed`` (default ``trainer.seed``) and ``lr`` (default
    ``trainer.lr``). One ``TrainResult`` per lane, in order."""
    lanes = [dict(lane) for lane in lanes]
    seeds = [int(lane.pop("seed", trainer.seed)) for lane in lanes]
    lrs = [float(lane.pop("lr", trainer.lr)) for lane in lanes]
    return fit_ensemble(trainer, dm, seeds, epochs_per_dispatch, seed_mesh=seed_mesh,
                        lane_hparams=lanes, lane_lrs=lrs, resume=resume)


def evaluate_lanes(trainer, dm: ArrayDataModule, results, lanes: Sequence[dict],
                   split: str = "test") -> list:
    """Each lane's best params evaluated on ``split`` by its own
    ``hp_model_fn(lane)`` model (``Trainer.evaluate``: draws from
    ``trainer.seed + 1``, scheduled keys at the schedule's end). ``lanes``
    as given to ``fit_lane_sweep`` (``seed`` and ``lr`` are ignored).
    Returns one ``{split}/...`` dict per lane."""
    if trainer.hp_model_fn is None:
        raise ValueError("evaluate_lanes requires Trainer(hp_model_fn=...)")
    out = []
    for lane, r in zip(lanes, results):
        hp = {key: v for key, v in lane.items() if key not in RESERVED_KEYS}
        model = trainer.hp_model_fn(hp)
        model.load_state_dict(r.best_params)
        out.append(evaluate(_lane_trainer(trainer, model, trainer.seed, trainer.lr), dm,
                            None, split))
    return out
