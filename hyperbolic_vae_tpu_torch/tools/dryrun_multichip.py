"""The multichip dry run: parameter sharding on n gloo ranks of the CPU.

Counterpart of ``__graft_entry__.dryrun_multichip(n)``. It spawns n ranks
(a (data, model) mesh: model 2 when n is even and at least 4, data the
rest), each training ``RNASeqVAE`` at the realistic width (20,480 genes,
hidden 256, latent 2) on JAX's dry-run data (512 uniform cells, 128 val,
batch 128) through the Trainer's chunk program:

  * dp x tp: ``tp_param_shardings``, 6 epochs, 3 a dispatch;
  * fsdp x tp: ``fsdp_tp_param_shardings``, 2 epochs, 2 a dispatch;
  * streamed: ``fit_streamed`` in blocks of half the cells under TP;
  * seed mesh: n flagship ``GyroplaneVAE`` lanes (seeds 0..n-1) as
    ``fit_ensemble`` over ``make_seed_mesh(n)``, a lane a rank, on JAX's
    seed-leg data (320 uniform 28 x 28 rows, 64 val, batch 64; 4 epochs, 2
    a dispatch; ``__graft_entry__.py:436-460``).

One process runs the same fit unsharded in f32 and, as the anchor, in
float64 (``Float64Anchor``: the same f32 init and draws, every operation
in float64, as JAX's anchor runs under x64), the streamed fit and the
ensemble without a mesh, the latter at a rank's torch thread count (the
CPU's products round by it). Lanes never communicate, so every lane's
val history must equal one process's bit for bit on every rank. JAX's
envelope holds the
sharded legs: each epoch's val loss drifts from the anchor by at most
``EPOCH0_TOL`` at epoch 0 and by at most ``C`` times the unsharded f32
fit's drift at the same epoch (floored at ``FLOOR``); the streamed leg is
held to the unsharded streamed fit the same way. It prints a rank's
bytes against one process's: its parameters (under FSDP the masters,
its slices), moments, best copy and the working copy FSDP gathers whole
for the forward, and their total, which must shrink from one process to
TP to FSDP x TP (FSDP shards the optimizer's side; the forward still
reads whole leaves); and the wall of the ranks' legs and of the
one-process legs: host CPU work, not a card's time.

    python -m hyperbolic_vae_tpu_torch.tools.dryrun_multichip 4 [--small]
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import multiprocessing
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from hyperbolic_vae_tpu_torch.models import GyroplaneVAE, RNASeqVAE
from hyperbolic_vae_tpu_torch.ops.gyroplane import gyroplane_distances

EPOCH0_TOL = 1e-2  # JAX's: ~5x the f32 rounding floor of these dynamics
C, FLOOR = 5.0, 1e-3  # a sharded leg tracks the unsharded f32 leg's drift


@dataclasses.dataclass(frozen=True)
class Config:
    genes: int = 20480
    hidden: int = 256
    latent: int = 2
    cells: int = 512
    val: int = 128
    batch: int = 128
    max_epochs: int = 6
    k: int = 3


def full_config() -> Config:
    """JAX's dry run (``__graft_entry__.py:63-65``)."""
    return Config()


def small_config() -> Config:
    """The same legs at a width the CPU tests afford."""
    return Config(genes=512, hidden=64, cells=256, val=64, batch=64, max_epochs=4, k=2)


# JAX's seed-mesh leg: rows, val rows, batch, epochs, epochs a dispatch
SEED_ROWS, SEED_VAL, SEED_BATCH, SEED_EPOCHS, SEED_K = 320, 64, 64, 4, 2


def make_dm(cfg: Config):
    from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule

    rng = np.random.default_rng(0)
    x_tr = rng.uniform(0, 1, (cfg.cells, cfg.genes)).astype(np.float32)
    x_va = rng.uniform(0, 1, (cfg.val, cfg.genes)).astype(np.float32)
    y_tr, y_va = np.zeros(cfg.cells, np.int32), np.zeros(cfg.val, np.int32)
    return ArrayDataModule(x_train=x_tr, y_train=y_tr, x_val=x_va, y_val=y_va, x_test=x_va,
                           y_test=y_va, batch_size=cfg.batch)


class Float64Anchor(RNASeqVAE):
    """``RNASeqVAE`` in float64 on the CPU, the drift anchor (JAX's dry run
    runs its model with ``compute_dtype="float64"`` under x64): drawn in
    f32 as the model is, then every parameter upcast and every product in
    float64, the gyroplane distances by their plain version (the kernel's
    op computes in f32)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.double()
        for layer in (self.encoder[0], self.decoder[2]):
            layer.compute_dtype = torch.float64

    def encode(self, x):
        h = self.encoder(x)
        scale = torch.clamp(F.softplus(self.scale(h)) + 1e-3, 1e-3, 10.0)
        return self.ball.expmap0(self.mu(h)), scale

    def decode(self, z):
        planes = self.decoder[0]
        d = gyroplane_distances(z, planes.points, planes.ball.c, planes.signed, planes.bias)
        return torch.sigmoid(self.decoder[2](self.decoder[1](d)))


def make_seed_dm():
    """The seed leg's data: uniform 28 x 28 images, the val and test split
    the first 64 of them (JAX's)."""
    from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule

    x = np.random.default_rng(1).uniform(0, 1, (SEED_ROWS, 28, 28, 1)).astype(np.float32)
    y = np.zeros(SEED_ROWS, np.int32)
    return ArrayDataModule(x_train=x, y_train=y, x_val=x[:SEED_VAL], y_val=y[:SEED_VAL],
                           x_test=x[:SEED_VAL], y_test=y[:SEED_VAL], batch_size=SEED_BATCH)


def seed_lanes(n: int, seed_mesh=None) -> list:
    """Every lane's val history of ``fit_ensemble`` over seeds 0..n-1
    (over ``seed_mesh`` when given: every rank returns every lane's)."""
    model = GyroplaneVAE(device="cpu", generator=torch.Generator().manual_seed(0))
    results = _trainer(model, SEED_EPOCHS, SEED_K).fit_ensemble(make_seed_dm(), list(range(n)),
                                                                seed_mesh=seed_mesh)
    return [[h["val/loss_total"] for h in r.history] for r in results]


def _model(cfg: Config, anchor: bool = False):
    cls = Float64Anchor if anchor else RNASeqVAE
    return cls(in_features=cfg.genes, hidden_dim=cfg.hidden, latent_dim=cfg.latent, device="cpu",
               generator=torch.Generator().manual_seed(0))


def _trainer(model, epochs: int, k: int = 1, mesh=None, rule=None):
    from hyperbolic_vae_tpu_torch.train import Trainer

    return Trainer(model, max_epochs=epochs, epochs_per_dispatch=k, early_stopping_patience=None,
                   plateau_patience=1000, check_finite=False, mesh=mesh, param_sharding_fn=rule,
                   device="cpu")


def _bytes(trainer, dm) -> dict:
    """A rank's bytes of parameters (masters), moments, best copy and
    gathered working copy, and their total, from the Trainer's memory
    preflight."""
    est = trainer.memory_estimate(dm, [trainer.model])
    half = est["params+best"] // 2
    out = {"params": half, "moments": est["opt"], "best": half, "gathered": est["gathered"]}
    return dict(out, total=sum(out.values()))


def rank_legs(mesh, cfg: Config) -> dict:
    """This rank's legs over ``mesh``: val losses of the dp x tp and
    fsdp x tp fits, train losses of the streamed fit, its bytes."""
    from hyperbolic_vae_tpu_torch.parallel import fsdp_tp_param_shardings, tp_param_shardings

    dm = make_dm(cfg)
    tp = tp_param_shardings if mesh.shape["model"] > 1 else None
    t0 = time.perf_counter()
    t = _trainer(_model(cfg), cfg.max_epochs, cfg.k, mesh, tp)
    out = {"dp_tp": [h["val/loss_total"] for h in t.fit(dm).history], "bytes_tp": _bytes(t, dm)}
    t = _trainer(_model(cfg), 2, 2, mesh, fsdp_tp_param_shardings)
    out["fsdp_tp"] = [h["val/loss_total"] for h in t.fit(dm).history]
    out["bytes_fsdp_tp"] = _bytes(t, dm)
    t = _trainer(_model(cfg), 2, 1, mesh, tp)
    out["streamed"] = [h["train/loss_total"]
                       for h in t.fit_streamed(dm, block_rows=cfg.cells // 2).history]
    from hyperbolic_vae_tpu_torch.parallel import make_seed_mesh

    world = dist.get_world_size()
    out["seed_mesh"] = seed_lanes(world, make_seed_mesh(world, device="cpu"))
    out["threads"] = torch.get_num_threads()
    out["seconds"] = time.perf_counter() - t0
    return out


def one_process_legs(cfg: Config, n_lanes: int, threads: int) -> dict:
    """The unsharded f32 fit, the float64 anchor, the unsharded streamed
    fit and the ensemble of ``n_lanes`` without a mesh (on ``threads``
    torch threads), in this process."""
    dm = make_dm(cfg)
    t0 = time.perf_counter()
    t = _trainer(_model(cfg), cfg.max_epochs, cfg.k)
    out = {"f32": [h["val/loss_total"] for h in t.fit(dm).history], "bytes": _bytes(t, dm)}
    out["f64"] = [h["val/loss_total"]
                  for h in _trainer(_model(cfg, anchor=True), cfg.max_epochs, cfg.k).fit(dm).history]
    out["streamed"] = [h["train/loss_total"] for h in _trainer(_model(cfg), 2).fit_streamed(
        dm, block_rows=cfg.cells // 2).history]
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        out["seed_mesh"] = seed_lanes(n_lanes)
    finally:
        torch.set_num_threads(before)
    out["seconds"] = time.perf_counter() - t0
    return out


def _drift(leg, ref) -> list:
    return [abs(a - b) / max(abs(b), 1e-9) for a, b in zip(leg, ref)]


def check(legs: list, cfg: Config, mesh_shape: tuple, single: Optional[dict] = None) -> dict:
    """JAX's envelope over the ranks' ``legs`` (one ``rank_legs`` each)
    against ``single`` (``one_process_legs``, run here when None), and the
    seed mesh's lanes to one process's bit for bit. Returns the report;
    ``ok`` is False with the failures in ``failures``."""
    first = legs[0]
    single = single or one_process_legs(cfg, len(legs), first["threads"])
    failures = []
    for i, leg in enumerate(legs[1:], 1):
        for key in ("dp_tp", "fsdp_tp", "streamed", "seed_mesh"):
            if leg[key] != first[key]:
                failures.append(f"rank {i}'s {key} losses differ from rank 0's")
    lanes = first["seed_mesh"]
    if len(lanes) != len(legs) or any(len(v) != SEED_EPOCHS or not np.all(np.isfinite(v))
                                      for v in lanes):
        failures.append(f"seed_mesh: {lanes}")
    for i, (got, want) in enumerate(zip(lanes, single["seed_mesh"])):
        if not np.array_equal(got, want):
            failures.append(f"seed_mesh: lane {i}'s val losses {got} differ from one "
                            f"process's {want}")
    s = _drift(single["f32"], single["f64"])
    env = np.maximum(s, FLOOR)
    report = {"mesh": {"data": mesh_shape[0], "model": mesh_shape[1]}, "drift_1dev": s,
              "ok": True}
    for key, ref in (("dp_tp", single["f64"]), ("fsdp_tp", single["f64"]),
                     ("streamed", single["streamed"])):
        d = _drift(first[key], ref)
        report[f"drift_{key}"] = d
        want = cfg.max_epochs if key == "dp_tp" else 2
        if len(first[key]) != want or not np.all(np.isfinite(first[key])):
            failures.append(f"{key}: {first[key]}")
            continue
        if d[0] > EPOCH0_TOL:
            failures.append(f"{key}: epoch-0 drift {d[0]:.2e} exceeds {EPOCH0_TOL:.0e}")
        for i, di in enumerate(d):
            if di > C * env[i]:
                failures.append(f"{key}: drift {di:.2e} at epoch {i} exceeds {C:.0f}x the "
                                f"unsharded f32 drift ({env[i]:.2e})")
    if s[0] > EPOCH0_TOL:
        failures.append(f"the unsharded f32 leg's epoch-0 drift {s[0]:.2e} exceeds {EPOCH0_TOL:.0e}")
    if not first["streamed"][1] < first["streamed"][0]:
        failures.append(f"the streamed leg's train loss did not fall: {first['streamed']}")
    if not (first["bytes_fsdp_tp"]["total"] < first["bytes_tp"]["total"]
            < single["bytes"]["total"]):
        failures.append("a rank's bytes (parameters, moments, best copy and gathered working "
                        "copy) do not shrink from one process to tp to fsdp x tp")
    report.update(seed_lanes=lanes, bytes_one_process=single["bytes"], bytes_tp=first["bytes_tp"],
                  bytes_fsdp_tp=first["bytes_fsdp_tp"], rank_seconds=max(l["seconds"] for l in legs),
                  one_process_seconds=single["seconds"], failures=failures,
                  ok=not failures)
    return report


def _rank_main(rank: int, world: int, store: str, out: str, small: bool) -> None:
    from hyperbolic_vae_tpu_torch.parallel import make_mesh

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        n_model = 2 if world % 2 == 0 and world >= 4 else 1
        mesh = make_mesh(n_data=world // n_model, n_model=n_model, device="cpu")
        cfg = small_config() if small else full_config()
        try:
            res = rank_legs(mesh, cfg)
        except Exception:  # noqa: BLE001 - the parent reports it
            res = {"error": traceback.format_exc()}
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run(n: int, small: bool = False, timeout: float = 3000.0) -> dict:
    """Spawn ``n`` gloo ranks, run their legs and one process's, check."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="hvae-dryrun-") as tmp:
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_rank_main, args=(r, n, os.path.join(tmp, "store"), tmp, small))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"the ranks exited with {[p.exitcode for p in procs]}")
        legs = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(n)]
        ranks_wall = time.perf_counter() - t0
    for r, leg in enumerate(legs):
        if "error" in leg:
            raise RuntimeError(f"rank {r} failed:\n{leg['error']}")
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    cfg = small_config() if small else full_config()
    report = check(legs, cfg, (n // n_model, n_model))
    report["ranks_wall_seconds"] = ranks_wall
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="?", default=4, help="gloo ranks (CPU processes)")
    p.add_argument("--small", action="store_true", help="512 genes, hidden 64 (the CPU tests')")
    args = p.parse_args(argv)
    report = run(args.n, args.small)
    mib = 2 ** 20
    fmt = lambda xs: " ".join(f"{v:.2e}" for v in xs)  # noqa: E731
    print(f"dryrun_multichip on {args.n} gloo ranks (CPU), mesh {report['mesh']}")
    for key in ("1dev", "dp_tp", "fsdp_tp", "streamed"):
        print(f"  drift {key:9s}: {fmt(report['drift_' + key])}")
    lanes = report["seed_lanes"]
    same = not any(f.startswith("seed_mesh") for f in report["failures"])
    print(f"  seed mesh: {len(lanes)} flagship lanes over {args.n} ranks, val histories "
          f"{'bit for bit' if same else 'NOT equal to'} one process's; final val "
          f"{fmt(v[-1] for v in lanes)}")
    for key in ("bytes_one_process", "bytes_tp", "bytes_fsdp_tp"):
        b = report[key]
        print(f"  {key:17s}: params {b['params'] / mib:.1f} MiB, moments {b['moments'] / mib:.1f} "
              f"MiB, best {b['best'] / mib:.1f} MiB, gathered {b['gathered'] / mib:.1f} MiB; "
              f"total {b['total'] / mib:.1f} MiB")
    print(f"  host CPU wall: ranks' legs {report['ranks_wall_seconds']:.1f} s, one process's "
          f"{report['one_process_seconds']:.1f} s")
    print(json.dumps({"ok": report["ok"], "failures": report["failures"]}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
