"""Experiment 9: the pvae replication grid, WrappedNormal against
RiemannianNormal posteriors, with the importance-weighted bound.

Port of ``experiments/pvae_replicate.py``: for each posterior x
curvature x latent dim, ``PvaeMLPVAE`` (784 -> 600 ReLU -> d) is trained
with ``Trainer.fit`` (batch 128, lr 5e-4, 80 epochs by default, weights
from ``--seed``) and its best parameters are scored by ``evaluate_iwae``
on the test split (K = ``--iwae-k``, 5000 by default), beside the split's
mean ELBO (``test_elbo``, the bound's floor). The results go to
``RUN_DIR/replicate_results.json`` and, for the wrapped c = 1.4 cells,
beside Mathieu et al. 2019's MNIST table in
``RUN_DIR/published_comparison.json``. Synthetic MNIST by default (no
downloads); ``--real-mnist DIR`` reads the IDX files there.

    python -m hyperbolic_vae_tpu_torch.experiments.pvae_replicate --synthetic

``--lane-sweep``: the curvature cells of each (posterior, latent dim)
group are the lanes of one sweep (``Trainer(hp_model_fn=...)
.fit_lane_sweep``), each lane its cell's sequential fit bit for bit, and
each lane's best parameters get ``evaluate_iwae`` as the sequential path
gives them (the weights come from ``--seed`` either way). Runs on the
CUDA card (``--device cpu`` for a small run on the CPU). ``--seed-mesh N``
spreads each sweep's lanes over N ranks (``torchrun --nproc_per_node=N``);
``--use-mesh`` trains each cell data parallel over the world and does not
compose with ``--lane-sweep``, as in JAX.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import torch

from hyperbolic_vae_tpu_torch.data import make_data_module
from hyperbolic_vae_tpu_torch.experiments.common import is_writer, seed_mesh_of
from hyperbolic_vae_tpu_torch.models import PvaeMLPVAE
from hyperbolic_vae_tpu_torch.train import Trainer

# Mathieu et al., "Continuous Hierarchical Representations with Poincaré
# Variational Auto-Encoders", NeurIPS 2019 (arXiv:1901.06033), MNIST table:
# test negative log-likelihood (IWAE-5000, nats, lower is better) at 784 ->
# 600 -> d, batch 128, lr 5e-4, 80 epochs. Approximate values, transcribed
# without access to the paper: check them against the published PDF before
# using them as a formal bar. The d = 2 pair is the one to trust most.
MATHIEU_2019_NLL = {
    2: {"n_vae": 144.5, "pvae_c1.4": 142.5},
    5: {"n_vae": 114.7, "pvae_c1.4": 113.7},
    10: {"n_vae": 100.2, "pvae_c1.4": 99.7},
    20: {"n_vae": 97.6, "pvae_c1.4": 97.3},
}

SYNTHETIC_WARNING = ("trained on SYNTHETIC data: deltas against the published real-MNIST "
                     "numbers are not meaningful; rerun with --real-mnist <idx-dir>")


def published_comparison(results: dict, iwae_k: int) -> dict:
    """The measured bounds beside the published P-VAE MNIST table, for
    every wrapped (c = 1.4, d) cell in ``results``. The bound is a
    log-likelihood (higher is better), the paper's an NLL:
    measured_nll = -iwae."""
    rows = []
    for tag, r in results.items():
        if "_c1.4_" not in tag or not tag.startswith("wrapped"):
            continue
        d = int(tag.rsplit("_d", 1)[1])
        pub = MATHIEU_2019_NLL.get(d)
        if pub is None:
            continue
        measured_nll = -float(r[f"iwae_{iwae_k}"])
        rows.append({
            "latent_dim": d,
            "measured_nll_iwae": measured_nll,
            "published_pvae_nll": pub["pvae_c1.4"],
            "published_nvae_nll": pub["n_vae"],
            "delta_vs_published_pvae": measured_nll - pub["pvae_c1.4"],
        })
    return {
        "protocol": "784->600->d, batch 128, lr 5e-4, 80 epochs, "
                    f"IWAE-{iwae_k}, Bernoulli likelihood, WrappedNormal posterior, c=1.4",
        "source": "Mathieu et al. 2019 (arXiv:1901.06033), MNIST table; values "
                  "approximate (transcribed without the paper: verify against the PDF)",
        "acceptance": "expected |delta_vs_published_pvae| <~ 2 nats on real MNIST at 80 "
                      "epochs; qualitative bar: beats the published N-VAE NLL at d=2",
        "rows": sorted(rows, key=lambda r: r["latent_dim"]),
    }


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic", action="store_true", default=True,
                   help="seeded synthetic MNIST (the default; no downloads)")
    p.add_argument("--real-mnist", type=str, default=None, metavar="IDX_DIR",
                   help="train on the real MNIST IDX files in this directory instead")
    p.add_argument("--n-train", type=int, default=60000, help="synthetic train size")
    p.add_argument("--n-test", type=int, default=10000, help="synthetic test size")
    p.add_argument("--run-dir", type=str, default="runs_torch/pvae_replicate")
    p.add_argument("--no-early-stopping", action="store_true")
    p.add_argument("--epochs-per-dispatch", type=int, default=1,
                   help="K epochs a dispatch (histories are the same for every K)")
    p.add_argument("--posteriors", type=str, nargs="+", default=["wrapped", "riemannian"])
    p.add_argument("--curvatures", type=float, nargs="+", default=[1.0])
    p.add_argument("--latent-dims", type=int, nargs="+", default=[2])
    p.add_argument("--iwae-k", type=int, default=5000)
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    p.add_argument("--lane-sweep", action="store_true",
                   help="each (posterior, latent dim) group's curvatures as lanes of one sweep")
    p.add_argument("--seed-mesh", type=int, default=0,
                   help="with --lane-sweep: spread the lanes over this many ranks (torchrun)")
    p.add_argument("--use-mesh", action="store_true",
                   help="data parallel over the torch.distributed world (torchrun; world size 1 "
                        "without it)")
    args = p.parse_args(argv)
    if args.lane_sweep and args.use_mesh:
        raise SystemExit("--use-mesh does not compose with --lane-sweep")
    if args.real_mnist:
        args.synthetic = False
    return args


def _model(args, dm, posterior: str, c: float, d: int, seed=None):
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    return PvaeMLPVAE(data_shape=dm.input_shape, latent_dim=d, manifold_curvature=c,
                      posterior=posterior, lr=args.lr, generator=gen, device=args.device)


def _trainer(args, model, log_dir, **kw) -> Trainer:
    return Trainer(model, lr=args.lr, max_epochs=args.epochs, seed=args.seed,
                   early_stopping_patience=None if args.no_early_stopping else 10,
                   log_dir=log_dir, epochs_per_dispatch=args.epochs_per_dispatch,
                   use_mesh=args.use_mesh, device=args.device, **kw)


def _scores(args, trainer, dm, result) -> dict:
    """A cell's best val, the bound on the test split from its best
    parameters, and the test split's mean ELBO (the bound's floor)."""
    best = result.best_params
    return {"best_val": float(result.best_metric),
            f"iwae_{args.iwae_k}": float(trainer.evaluate_iwae(dm, best, k=args.iwae_k)),
            "test_elbo": float(trainer.evaluate(dm, best, "test")["test/elbo"])}


def sequential(args, run_dir, dm) -> dict:
    """One ``fit`` and ``evaluate_iwae`` a cell."""
    results = {}
    for posterior in args.posteriors:
        for c in args.curvatures:
            for d in args.latent_dims:
                tag = f"{posterior}_c{c}_d{d}"
                trainer = _trainer(args, _model(args, dm, posterior, c, d, args.seed),
                                   str(run_dir / tag))
                result = trainer.fit(dm)
                results[tag] = _scores(args, trainer, dm, result)
                print(tag, results[tag], flush=True)
    return results


def lane_sweep(args, run_dir, dm) -> dict:
    """The curvatures of each (posterior, latent dim) group as the lanes of
    one sweep; ``evaluate_iwae`` of each lane's best parameters by a
    Trainer of its own model (the sequential path's draws)."""
    seed_mesh = seed_mesh_of(args)
    results = {}
    for posterior in args.posteriors:
        for d in args.latent_dims:
            def model_fn(hp, _p=posterior, _d=d):
                return _model(args, dm, _p, hp["manifold_curvature"], _d)

            lanes = [{"manifold_curvature": c, "seed": args.seed} for c in args.curvatures]
            trainer = _trainer(args, model_fn(lanes[0]), str(run_dir / f"{posterior}_d{d}"),
                               hp_model_fn=model_fn)
            sweep = trainer.fit_lane_sweep(dm, lanes, seed_mesh=seed_mesh)
            for lane, r in zip(lanes, sweep):
                tag = f"{posterior}_c{lane['manifold_curvature']}_d{d}"
                results[tag] = _scores(args, _trainer(args, model_fn(lane), None), dm, r)
                print(tag, results[tag], flush=True)
    return results


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    if args.use_mesh or args.seed_mesh:
        from hyperbolic_vae_tpu_torch.parallel import init_distributed

        init_distributed(args.device)  # before the models: this rank's card
    run_dir = Path(args.run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    dm = make_data_module(batch_size=args.batch_size, data_dir=args.real_mnist or "data",
                          synthetic=args.synthetic, n_train=args.n_train, n_test=args.n_test)
    results = (lane_sweep if args.lane_sweep else sequential)(args, run_dir, dm)
    if not is_writer():
        return results
    (run_dir / "replicate_results.json").write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))
    cmp = published_comparison(results, args.iwae_k)
    if args.synthetic:
        cmp["warning"] = SYNTHETIC_WARNING
    if cmp["rows"]:
        (run_dir / "published_comparison.json").write_text(json.dumps(cmp, indent=2))
        print(json.dumps(cmp, indent=2))
    return results


if __name__ == "__main__":
    main()
