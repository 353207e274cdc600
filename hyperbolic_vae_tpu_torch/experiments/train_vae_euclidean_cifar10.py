"""Experiment 2: the Euclidean conv VAE on CIFAR-10, latent 128.

Port of ``experiments/train_vae_euclidean_cifar10.py``: dataset ->
data module -> model -> trainer, then the test split from the best
checkpoint. ``--synthetic`` is the seeded CIFAR-10 stand-in; the results
go to ``RUN_DIR/results.json``.

    python -m hyperbolic_vae_tpu_torch.experiments.train_vae_euclidean_cifar10 --synthetic
"""

from __future__ import annotations

from typing import Optional

import torch

from hyperbolic_vae_tpu_torch.data import cifar10
from hyperbolic_vae_tpu_torch.experiments.common import base_parser, fit_and_test, setup, write_results
from hyperbolic_vae_tpu_torch.models import EuclideanVAE
from hyperbolic_vae_tpu_torch.train import GenerateCallback, LatentScatterCallback


def cifar_data(args):
    return cifar10.make_data_module(batch_size=args.batch_size, data_dir=args.data_dir,
                                    synthetic=args.synthetic, n_train=args.n_train,
                                    n_test=args.n_test)


def parse_args(argv: Optional[list] = None):
    p = base_parser(__doc__.split("\n")[0])
    p.add_argument("--latent-dim", type=int, default=128)
    p.add_argument("--beta", type=float, default=1.0)
    p.set_defaults(n_train=50000)
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    run_dir = setup(args, "vae_euclidean_cifar10")
    dm = cifar_data(args)
    model = EuclideanVAE(data_shape=dm.input_shape, latent_dim=args.latent_dim, beta=args.beta,
                         lr=args.lr, generator=torch.Generator().manual_seed(args.seed),
                         device=args.device)
    out = fit_and_test(args, run_dir, model, dm, [GenerateCallback(every_n_epochs=10),
                                                  LatentScatterCallback(every_n_epochs=10)])
    return write_results(run_dir, {"vae_euclidean_cifar10": out})["vae_euclidean_cifar10"]


if __name__ == "__main__":
    main()
