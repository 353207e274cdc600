"""Experiment 7: the grid over curvature x beta x latent dim x layer
choices of the conv hyperbolic VAE on MNIST padded to 32 x 32, each cell
isolated from the others' failures.

Port of ``experiments/train_vae_hyperbolic_mnist_grid.py``. By default
every cell is its own ``Trainer.fit`` (a cell that raises is recorded as
``null`` and the grid goes on). ``--lane-sweep``: the (curvature x beta)
cells of each shape group (latent dim, encoder head, decoder first
layer) are the lanes of one sweep (``Trainer(hp_model_fn=...)
.fit_lane_sweep``), evaluated by ``evaluate_lanes``; a group that raises
is recorded as ``null``. Each lane is its cell's fit, bit for bit.
``--seed-mesh N`` spreads each sweep's lanes over N ranks (``torchrun
--nproc_per_node=N``); ``--use-mesh`` trains each cell data parallel and
does not compose with ``--lane-sweep``, as in JAX. Test metrics of every
cell go to ``RUN_DIR/grid_results.json``.

    python -m hyperbolic_vae_tpu_torch.experiments.train_vae_hyperbolic_mnist_grid \\
        --synthetic --lane-sweep --encoder-lasts mobius --decoder-firsts geoopt_gyroplane
"""

from __future__ import annotations

import itertools
import json
import time
import traceback
from typing import Optional

import torch

from hyperbolic_vae_tpu_torch.data import pad_to_32
from hyperbolic_vae_tpu_torch.experiments.common import (
    base_parser,
    is_writer,
    mnist_data,
    seed_mesh_of,
    setup,
    trainer_extra,
)
from hyperbolic_vae_tpu_torch.models import HyperbolicImageVAE
from hyperbolic_vae_tpu_torch.train import Trainer
from hyperbolic_vae_tpu_torch.train.ensemble import evaluate_lanes


def _model(args, dm, latent_dim, enc, dec, c, beta, seed=None):
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    return HyperbolicImageVAE(data_shape=dm.input_shape, latent_dim=latent_dim,
                              manifold_curvature=c, encoder_last_layer_module=enc,
                              decoder_first_layer_module=dec, beta=beta, lr=args.lr,
                              generator=gen, device=args.device)


def _trainer(args, model, log_dir, **kw):
    return Trainer(model, lr=args.lr, max_epochs=args.epochs, seed=args.seed,
                   early_stopping_patience=None if args.no_early_stopping else 10,
                   log_dir=log_dir, **trainer_extra(args), **kw)


def lane_sweep_grid(args, run_dir, dm) -> dict:
    """One ``fit_lane_sweep`` a shape group, each group isolated."""
    if args.use_mesh:
        raise SystemExit("--use-mesh (data parallelism) does not compose with --lane-sweep; "
                         "shard the lanes themselves with --seed-mesh N")
    seed_mesh = seed_mesh_of(args)
    results = {}
    for latent_dim, enc, dec in itertools.product(args.latent_dims, args.encoder_lasts,
                                                  args.decoder_firsts):
        def model_fn(hp, _d=latent_dim, _e=enc, _x=dec):
            return _model(args, dm, _d, _e, _x, hp["manifold_curvature"], hp["beta"])

        lanes = [{"manifold_curvature": c, "beta": b, "seed": args.seed}
                 for c, b in itertools.product(args.curvatures, args.betas)]
        group = f"d{latent_dim}_{enc}_{dec}"
        try:
            trainer = _trainer(args, model_fn(lanes[0]), str(run_dir / group),
                               hp_model_fn=model_fn)
            t0 = time.perf_counter()
            sweep = trainer.fit_lane_sweep(dm, lanes, seed_mesh=seed_mesh)
            tests = evaluate_lanes(trainer, dm, sweep, lanes, "test")
            wall = time.perf_counter() - t0
            for lane, r, test in zip(lanes, sweep, tests):
                tag = f"c{lane['manifold_curvature']}_b{lane['beta']}_{group}"
                results[tag] = dict(test, epochs=r.epochs_run, best_val=r.best_metric)
                print(tag, results[tag], flush=True)
            print(f"[{group}] {len(lanes)} lanes in one sweep: {wall:.1f} s wall, "
                  f"{sweep[0].samples_per_sec:.0f} aggregate train samples/s", flush=True)
        except Exception:  # per-group isolation (the reference's per-run try/except)
            traceback.print_exc()
            for lane in lanes:
                results[f"c{lane['manifold_curvature']}_b{lane['beta']}_{group}"] = None
    return results


def sequential_grid(args, run_dir, dm) -> dict:
    """One ``fit`` a cell, each cell isolated."""
    results = {}
    for c, beta, latent_dim, enc, dec in itertools.product(
            args.curvatures, args.betas, args.latent_dims, args.encoder_lasts,
            args.decoder_firsts):
        tag = f"c{c}_b{beta}_d{latent_dim}_{enc}_{dec}"
        try:
            trainer = _trainer(args, _model(args, dm, latent_dim, enc, dec, c, beta, args.seed),
                               str(run_dir / tag))
            result = trainer.fit(dm)
            results[tag] = dict(trainer.evaluate(dm, result.best_params, "test"),
                                epochs=result.epochs_run, best_val=result.best_metric)
            print(tag, results[tag], flush=True)
        except Exception:  # per-run isolation
            traceback.print_exc()
            results[tag] = None
    return results


def parse_args(argv: Optional[list] = None):
    p = base_parser(__doc__.split("\n")[0])
    p.add_argument("--curvatures", type=float, nargs="+", default=[0.5, 1.0, 1.4])
    p.add_argument("--betas", type=float, nargs="+", default=[1.0, 3.0])
    p.add_argument("--latent-dims", type=int, nargs="+", default=[2])
    p.add_argument("--encoder-lasts", type=str, nargs="+", default=["linear", "mobius"])
    p.add_argument("--decoder-firsts", type=str, nargs="+",
                   default=["geoopt_gyroplane", "geodesic"])
    p.add_argument("--lane-sweep", action="store_true",
                   help="each shape group's (curvature x beta) cells as lanes of one sweep")
    p.add_argument("--seed-mesh", type=int, default=0,
                   help="with --lane-sweep: spread the lanes over this many ranks (torchrun)")
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    run_dir = setup(args, "vae_hyperbolic_mnist_grid")
    dm = pad_to_32(mnist_data(args))
    results = (lane_sweep_grid if args.lane_sweep else sequential_grid)(args, run_dir, dm)
    out = {k: ({m: float(v) for m, v in r.items()} if r else None) for k, r in results.items()}
    if is_writer():
        (run_dir / "grid_results.json").write_text(json.dumps(out, indent=2))
        print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
