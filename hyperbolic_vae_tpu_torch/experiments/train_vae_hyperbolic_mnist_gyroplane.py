"""Experiment 6 (the flagship): the MLP gyroplane VAE on MNIST, a 2-D
Poincare latent at c = 1.0.

Port of ``experiments/train_vae_hyperbolic_mnist_gyroplane.py``. One fit
with checkpoints (best, last) and the figure callbacks, then the test
split's metrics; or, with ``--seeds a b c ...``, every seed as a lane of
one sweep (``Trainer.fit_ensemble``: each seed's result is its own fit's,
bit for bit; no checkpoints or callbacks in that mode). Either way the
weights come from ``--seed`` (or each seed), so a seed's sweep lane and
its single fit agree.

    python -m hyperbolic_vae_tpu_torch.experiments.train_vae_hyperbolic_mnist_gyroplane \\
        --synthetic --seeds 42 43 44 45 46 47 48 49
"""

from __future__ import annotations

from typing import Optional

import torch

from hyperbolic_vae_tpu_torch.experiments.common import (
    base_parser,
    mnist_data,
    seed_mesh_of,
    setup,
    trainer_extra,
)
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.train import (
    GenerateCallback,
    LatentInterpolationCallback,
    LatentScatterCallback,
    Trainer,
)


def _model(args, dm, seed: int):
    return GyroplaneVAE(data_shape=dm.input_shape, latent_dim=args.latent_dim,
                        manifold_curvature=args.curvature, beta=args.beta,
                        prior_scale=args.prior_scale, lr=args.lr,
                        generator=torch.Generator().manual_seed(seed), device=args.device)


def train_seed_sweep(args, run_dir, dm) -> list:
    """``--seeds``: one lane a seed (``fit_ensemble``), spread over
    ``--seed-mesh`` ranks."""
    if args.use_mesh:
        raise SystemExit("--use-mesh (data parallelism) does not compose with --seeds; shard "
                         "the sweep itself with --seed-mesh N instead")
    model = _model(args, dm, args.seeds[0])
    trainer = Trainer(model, lr=args.lr, max_epochs=args.epochs,
                      early_stopping_patience=None if args.no_early_stopping else 10,
                      log_dir=str(run_dir), **trainer_extra(args, model))
    results = trainer.fit_ensemble(dm, args.seeds, seed_mesh=seed_mesh_of(args))
    for seed, r in zip(args.seeds, results):
        print(f"seed={seed} epochs={r.epochs_run} best {trainer.monitor}={r.best_metric:.4f}",
              flush=True)
    print(f"ensemble samples/sec={results[0].samples_per_sec:.0f} ({len(args.seeds)} seeds "
          f"as lanes of one sweep)", flush=True)
    return results


def train_single(args, run_dir, dm):
    model = _model(args, dm, args.seed)
    trainer = Trainer(
        model, lr=args.lr, max_epochs=args.epochs, seed=args.seed,
        early_stopping_patience=None if args.no_early_stopping else 10,
        log_dir=str(run_dir), checkpoint_dir=str(run_dir / "ckpt"),
        callbacks=[GenerateCallback(every_n_epochs=10),
                   LatentScatterCallback(every_n_epochs=10),  # range: the ball's radius
                   LatentInterpolationCallback(every_n_epochs=10)],
        **trainer_extra(args, model))
    result = trainer.fit(dm)
    print(f"epochs={result.epochs_run} best {trainer.monitor}={result.best_metric:.4f} "
          f"samples/sec={result.samples_per_sec:.0f}", flush=True)
    print("test:", trainer.evaluate(dm, result.best_params, "test"), flush=True)
    return result


def parse_args(argv: Optional[list] = None):
    p = base_parser(__doc__.split("\n")[0])
    p.add_argument("--latent-dim", type=int, default=2)
    p.add_argument("--curvature", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--prior-scale", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="a seed sweep: every seed a lane of one sweep (fit_ensemble)")
    p.add_argument("--seed-mesh", type=int, default=0,
                   help="with --seeds: spread the lanes over this many ranks (torchrun)")
    return p.parse_args(argv)


def main(argv: Optional[list] = None):
    args = parse_args(argv)
    run_dir = setup(args, "vae_hyperbolic_mnist_gyroplane")
    dm = mnist_data(args)
    if args.seeds:
        return train_seed_sweep(args, run_dir, dm)
    return train_single(args, run_dir, dm)


if __name__ == "__main__":
    main()
