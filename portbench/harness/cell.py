"""One run of one cell: set-up, the measured window, the check of what the
program produced, and the result line.

Set-up builds the data and the starting weights from the seed, the
program's model and one ``Trainer``, and drives that Trainer through
``Trainer.fit`` three times: one epoch at the cell's shapes (the
warm-up), then from the same weights and seed the check's two fits
(``harness/check.py``): one epoch over the train split's first batch
(one step) and one over its first three batches (three steps on rows
that all differ), each with the whole val split, on the cell's step
path, shuffle and epochs a dispatch. The window is one more ``fit`` of
the same Trainer from the same weights on the whole data, stopped by
``max_wall_seconds`` at the first chunk boundary past the run's seconds:
from the call of ``fit`` to its return, after a
``torch.cuda.synchronize()``. With ``--trace 1`` the Trainer's
``profile_dir`` is set for the window, and its trace of the second chunk
feeds the per-layer metrics; a callback clocks each chunk's end, so the
traced chunk's span can be set against the untraced chunks' wall (the
profiler's stretch). After the window and the reading of the peak
memory, the program's state is freed and the plain reference takes the
same two fits (``portbench/reference``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from portbench.harness import check, datagen, spec, trace as trace_mod, weights
from portbench.reference import _follow

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hyperbolic_vae_tpu")
CHECK_BATCHES = 3  # fit B: one epoch of this many steps


def forbidden_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole (the port's name starts with the JAX
    package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads (``metrics/<name>.py``)."""

    config: dict
    traffic: dict
    window: dict
    trace: Optional[trace_mod.Trace]
    traced_epochs: int
    batch: int
    steps_per_epoch: int
    eval_batch: int
    eval_steps: int
    val_rem: int
    counts: object = spec.counts

    @property
    def traced_steps(self) -> int:
        return self.traced_epochs * self.steps_per_epoch


def power_limit_w(index: int = 0) -> Optional[float]:
    """The card's power limit from nvidia-smi, or None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _step_fns(traffic: dict, model) -> dict:
    """The Trainer's arguments of the traffic's step path (``steps/<step>.py``)."""
    return importlib.import_module(f"portbench.steps.{traffic['step']}").fns(model)


class ChunkClock:
    """A Trainer callback: the host clock at the fit's start and at each
    chunk's end."""

    def __init__(self):
        self.t = []

    def on_fit_start(self, trainer, dm):
        self.t = [time.perf_counter()]

    def on_epoch_end(self, trainer, epoch, live, row):
        self.t.append(time.perf_counter())

    def untraced_chunk_s(self) -> Optional[float]:
        """The median wall of the chunks after the traced one (the first
        captures, the second is traced)."""
        walls = [b - a for a, b in zip(self.t, self.t[1:])][2:]
        return statistics.median(walls) if walls else None


def _data_module(x_train: np.ndarray, x_val: np.ndarray, batch: int):
    from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule

    z = lambda n: np.zeros(n, np.int32)  # noqa: E731
    return ArrayDataModule(x_train=x_train, y_train=z(len(x_train)), x_val=x_val,
                           y_val=z(len(x_val)), x_test=x_val[:0], y_test=z(0),
                           batch_size=batch, name="portbench")


def _readings(res, trainer, model, names) -> dict:
    """The check's readings of a fit: each epoch's train and val metrics,
    the first moments, the parameters (on the host)."""
    by_param = {p: n for n, p in model.named_parameters()}
    m1 = {by_param[p]: trainer.optimizer.moments(p)[0].detach().cpu().clone()
          for p in by_param}
    return {"loss": [h["train/loss_total"] for h in res.history],
            "val": [{k: h[f"val/{k}"] for k in names} for h in res.history],
            "m1": m1, "params": {k: v.detach().cpu().clone() for k, v in res.params.items()}}


@dataclasses.dataclass
class Prepared:
    """A cell's set-up: its data and starting weights, the program's model
    and the one Trainer that every fit of the run uses."""

    cell: spec.Cell
    device: torch.device
    fit_seed: int
    batch: int
    x_train: np.ndarray
    x_val: np.ndarray
    params0: dict
    model: object
    trainer: object
    dm: object
    dm_one: object
    dm_three: object

    @property
    def ref(self):
        return _follow.module(self.cell.config_name)


def prepare(cell: spec.Cell, seed: int, device: str, log=None) -> Prepared:
    """Data and weights from ``seed``, the program's model and Trainer."""
    log = log or (lambda *_: None)
    import hyperbolic_vae_tpu_torch.models as port_models
    from hyperbolic_vae_tpu_torch.train import Trainer

    log("program imported")
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    ref = _follow.module(cell.config_name)
    data_seed, weight_seed, fit_seed = (int(s) for s in np.random.SeedSequence(seed).generate_state(3))
    batch = int(tr["batch"])
    x_train, x_val = datagen.make(tr["data"], data_seed, dev)
    log("data")
    specs = ref.param_specs(cfg["model"])
    params0 = weights.make(specs, weight_seed, float(cfg["curvature"]), dev)
    log("weights")
    model = getattr(port_models, cfg["model"]["class"])(
        **cfg["model"]["kwargs"], generator=torch.Generator().manual_seed(0), device=dev)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if shapes != {name: tuple(shape) for name, shape, _, _ in specs}:
        raise RuntimeError(f"the program's parameters {shapes} are not the reference's {specs}")
    log("model")
    trainer = Trainer(model, lr=float(cfg["lr"]), max_epochs=1, seed=fit_seed,
                      early_stopping_patience=tr["early_stopping_patience"],
                      plateau_factor=tr["plateau"]["factor"],
                      plateau_patience=tr["plateau"]["patience"],
                      plateau_min_lr=tr["plateau"]["min_lr"], shuffle=tr["shuffle"],
                      epochs_per_dispatch=int(tr["epochs_per_dispatch"]), device=dev,
                      **_step_fns(tr, model))
    log("trainer")
    return Prepared(cell=cell, device=dev, fit_seed=fit_seed, batch=batch, x_train=x_train,
                    x_val=x_val, params0=params0, model=model, trainer=trainer,
                    dm=_data_module(x_train, x_val, batch),
                    dm_one=_data_module(x_train[:batch], x_val, batch),
                    dm_three=_data_module(x_train[:CHECK_BATCHES * batch], x_val, batch))


def check_fits(p: Prepared) -> dict:
    """The program's readings for the check: from the starting weights and
    the fit's seed, fit A (one epoch over the first batch: one step) and
    fit B (one epoch over the first ``CHECK_BATCHES`` batches), each with
    the whole val split."""
    tr = p.trainer
    tr.max_epochs = 1
    return {name: _readings(tr.fit(dm, params=p.params0), tr, p.model, p.ref.METRICS)
            for name, dm in (("a", p.dm_one), ("b", p.dm_three))}


def reference(p: Prepared, precision: str = "float32", fault: Optional[str] = None) -> dict:
    """The plain reference's readings of the same two fits (``_follow.follow``)."""
    cfg = p.cell.config
    x_val = torch.from_numpy(p.x_val).to(p.device)
    return {name: _follow.follow(p.cell.config_name, cfg, p.params0,
                                 torch.from_numpy(p.x_train[:n * p.batch]).to(p.device), x_val,
                                 p.batch, 1, p.fit_seed, float(cfg["lr"]), precision, fault)
            for name, n in (("a", 1), ("b", CHECK_BATCHES))}


def numbers(p: Prepared, prog: dict, ref: dict) -> dict:
    """``check.numbers`` of the two sides' readings."""
    return check.numbers(prog, ref, p.params0, p.ref.MANIFOLD)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, faults=None) -> dict:
    """Run ``cell`` once; returns the result line's object with a
    ``checks`` list [(name, value, limit)] last. ``t_start`` is the
    process's start on ``time.monotonic``'s clock. ``faults`` (tests
    only): a context manager entered around every program fit. Set-up's
    stages are timed on standard error."""
    faults = faults or contextlib.nullcontext

    def log(what):
        print(f"portbench: {what} at {time.monotonic() - t_start:.3f} s", file=sys.stderr,
              flush=True)

    log("harness imported")
    p = prepare(cell, seed, device, log)
    trainer, dev, batch = p.trainer, p.device, p.batch
    with faults():
        trainer.fit(p.dm, params=p.params0)  # warm-up: one epoch at the cell's shapes
        log("warm-up fit")
        prog = check_fits(p)
        log("check fits")

    trace_dir = Path(tempfile.mkdtemp(prefix="portbench-trace-")) if trace else None
    trainer.max_epochs = 10 ** 9
    trainer.max_wall_seconds = float(seconds)
    trainer.profile_dir = str(trace_dir) if trace else None
    clock = ChunkClock()
    trainer.callbacks = [clock] if trace else []
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    with faults():
        res = trainer.fit(p.dm, params=p.params0)
    if on_card:
        torch.cuda.synchronize(dev)
    t1 = time.monotonic()
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    log(f"window of {t1 - t0:.3f} s")

    prog_ep = trainer.program.ep
    steps_per_epoch, k = prog_ep.steps, trainer.epochs_per_dispatch
    window = {"wall_s": t1 - t0, "samples": res.epochs_run * steps_per_epoch * batch,
              "samples_per_epoch": steps_per_epoch * batch, "k": k,
              "program_samples_per_s": res.samples_per_sec, "epochs_run": res.epochs_run}
    skipped = sum(h.get("train/skipped_steps", 0.0) for h in res.history) * steps_per_epoch
    ctx = Context(config=cell.config, traffic=cell.traffic, window=window, trace=None,
                  traced_epochs=k, batch=batch, steps_per_epoch=steps_per_epoch,
                  eval_batch=prog_ep.eval_batch, eval_steps=prog_ep.eval_steps,
                  val_rem=prog_ep.rem)
    # the program's state freed before the reference runs
    p.model = p.trainer = p.dm = p.dm_one = p.dm_three = None
    del trainer, res, prog_ep
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if trace:
        path = trace_dir / "trace.json"
        ctx.trace = trace_mod.Trace.load(path) if path.exists() else None
        shutil.rmtree(trace_dir, ignore_errors=True)
        log("trace read")

    values = numbers(p, prog, reference(p))
    correct, rows = check.judge(values, cell.limits)
    log("reference")

    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is None:
                log(f"no reading of {m['name']}")
            else:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics["train_samples_per_s"] = {"value": window["samples"] / window["wall_s"],
                                          "unit": units["train_samples_per_s"]}
        metrics["setup_s"] = {"value": t0 - t_start, "unit": units["setup_s"]}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": 1, "memory_peak_bytes": peak,
                   "power_limit_w": power_limit_w(dev.index or 0) if on_card else None}
    out = {"correct": bool(correct), "attempted": int(window["epochs_run"] * steps_per_epoch),
           "failed": int(round(skipped)), "metrics": metrics, "device": device_info}
    if trace and ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_us() * 1e-6
        device_info["window_s"] = ctx.trace.window_us * 1e-6
        out["breakdown"] = trace_mod.breakdown(ctx.trace)
        untraced = clock.untraced_chunk_s()
        if untraced:  # the traced chunk's span over an untraced chunk's wall
            out["trace_stretch"] = ctx.trace.window_us * 1e-6 / untraced
    out["window"] = {"wall_s": window["wall_s"], "epochs": window["epochs_run"],
                     "program_samples_per_s": window["program_samples_per_s"]}
    out["checks"] = rows
    return out
