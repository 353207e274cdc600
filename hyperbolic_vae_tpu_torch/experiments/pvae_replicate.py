"""Experiment 9: the pvae replication grid, WrappedNormal against
RiemannianNormal posteriors, with the importance-weighted bound.

Port of ``experiments/pvae_replicate.py``'s sequential path: for each
posterior x curvature x latent dim, ``PvaeMLPVAE`` (784 -> 600 ReLU -> d)
is trained with ``Trainer.fit`` (batch 128, lr 5e-4, 80 epochs by
default) and its best parameters are scored by ``evaluate_iwae`` on the
test split (K = ``--iwae-k``, 5000 by default). The results go to
``RUN_DIR/replicate_results.json`` and, for the wrapped c = 1.4 cells,
beside Mathieu et al. 2019's MNIST table in
``RUN_DIR/published_comparison.json``. Synthetic MNIST by default (no
downloads); ``--real-mnist DIR`` reads the IDX files there.

    python -m hyperbolic_vae_tpu_torch.experiments.pvae_replicate --synthetic

Runs on the CUDA card (``--device cpu`` for a small run on the CPU).
``--lane-sweep`` and ``--seed-mesh`` (curvature lanes in one program, and
their mesh) are not ported yet.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from hyperbolic_vae_tpu_torch.data import make_data_module
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
    p.add_argument("--lane-sweep", action="store_true", help="not ported yet")
    p.add_argument("--seed-mesh", type=int, default=0, help="not ported yet")
    args = p.parse_args(argv)
    if args.lane_sweep or args.seed_mesh:
        raise SystemExit("--lane-sweep and --seed-mesh (curvature lanes in one program) are not "
                         "ported yet: ROADMAP.md Queue 1 item 7 (train/ensemble.py); run the "
                         "grid sequentially without them")
    if args.real_mnist:
        args.synthetic = False
    return args


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    run_dir = Path(args.run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    dm = make_data_module(batch_size=args.batch_size, data_dir=args.real_mnist or "data",
                          synthetic=args.synthetic, n_train=args.n_train, n_test=args.n_test)
    results = {}
    for posterior in args.posteriors:
        for c in args.curvatures:
            for d in args.latent_dims:
                tag = f"{posterior}_c{c}_d{d}"
                model = PvaeMLPVAE(data_shape=dm.input_shape, latent_dim=d, manifold_curvature=c,
                                   posterior=posterior, lr=args.lr, device=args.device)
                trainer = Trainer(
                    model, lr=args.lr, max_epochs=args.epochs, seed=args.seed,
                    early_stopping_patience=None if args.no_early_stopping else 10,
                    log_dir=str(run_dir / tag), epochs_per_dispatch=args.epochs_per_dispatch,
                    device=args.device)
                result = trainer.fit(dm)
                iwae = trainer.evaluate_iwae(dm, result.best_params, k=args.iwae_k)
                results[tag] = {"best_val": float(result.best_metric),
                                f"iwae_{args.iwae_k}": float(iwae)}
                print(tag, results[tag], flush=True)
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
