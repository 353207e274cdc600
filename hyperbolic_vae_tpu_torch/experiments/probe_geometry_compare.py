"""Hyperbolic against Euclidean latent space, as a number.

Port of ``experiments/probe_geometry_compare.py``: the same UnifiedVAE
architecture trained on the structured (hierarchical cell types) fake
RNA-seq data with a Poincare latent (c = ``--curvature``) and with a
Euclidean latent, each scored by its latent probes (kNN and nearest class
mean under the latent's metric) at the same latent size. The results go
to ``RUN_DIR/probe_compare.json``.

    python -m hyperbolic_vae_tpu_torch.experiments.probe_geometry_compare \\
        --epochs 60 --epochs-per-dispatch 20 --latent-dim 2
"""

from __future__ import annotations

import json
from typing import Optional

import torch

from hyperbolic_vae_tpu_torch.data import make_rnaseq_data_module
from hyperbolic_vae_tpu_torch.experiments.common import base_parser, setup, trainer_extra
from hyperbolic_vae_tpu_torch.models import UnifiedVAE
from hyperbolic_vae_tpu_torch.train import Trainer


def parse_args(argv: Optional[list] = None):
    p = base_parser(__doc__.split("\n")[0])
    p.add_argument("--latent-dim", type=int, default=2)
    p.add_argument("--curvature", type=float, default=1.0)
    p.add_argument("--hidden-dim", type=int, default=100)
    p.add_argument("--beta", type=float, default=0.5)
    p.add_argument("--probe-k", type=int, default=10)
    p.add_argument("--n-genes", type=int, default=2000)
    p.add_argument("--n-samples", type=int, default=2000)
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    run_dir = setup(args, "probe_geometry_compare")
    # hierarchical cell types: the case a hyperbolic latent is for
    dm = make_rnaseq_data_module(batch_size=args.batch_size, fake=True, structured_fake=True,
                                 n_samples=args.n_samples, n_genes=args.n_genes, seed=args.seed)
    results = {}
    for name, curv in (("hyperbolic", args.curvature), ("euclidean", 0.0)):
        model = UnifiedVAE(input_size=dm.input_shape, hidden_layer_dim=args.hidden_dim,
                           latent_dim=args.latent_dim, latent_curvature=curv or None,
                           prior_scale=2.0, posterior_scale="learned", learning_rate=args.lr,
                           beta=args.beta,
                           # valid for both geometries (mu_t = mu when flat)
                           kl_loss_method="logmap0_analytic", last_activation="sigmoid",
                           loss_recon_method="MSE",
                           generator=torch.Generator().manual_seed(args.seed), device=args.device)
        trainer = Trainer(model, lr=args.lr, max_epochs=args.epochs, seed=args.seed,
                          early_stopping_patience=None if args.no_early_stopping else 10,
                          log_dir=str(run_dir / name), **trainer_extra(args))
        res = trainer.fit(dm)
        results[name] = {"epochs": res.epochs_run, "best_val_loss_total": res.best_metric,
                         **trainer.evaluate_probe(dm, res.best_params, k=args.probe_k)}
        print(name, results[name], flush=True)
    (run_dir / "probe_compare.json").write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2), flush=True)
    return results


if __name__ == "__main__":
    main()
