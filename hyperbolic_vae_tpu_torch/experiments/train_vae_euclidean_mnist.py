"""Experiment 3: the Euclidean conv VAE on MNIST padded to 32 x 32, a 2-D
latent: the Euclidean control of the latent-space figures.

Port of ``experiments/train_vae_euclidean_mnist.py`` (the reference
declares (1, 32, 32) while feeding 28 x 28; the padding is explicit).
The results go to ``RUN_DIR/results.json``.

    python -m hyperbolic_vae_tpu_torch.experiments.train_vae_euclidean_mnist --synthetic
"""

from __future__ import annotations

from typing import Optional

import torch

from hyperbolic_vae_tpu_torch.data import pad_to_32
from hyperbolic_vae_tpu_torch.experiments.common import (
    base_parser,
    fit_and_test,
    mnist_data,
    setup,
    write_results,
)
from hyperbolic_vae_tpu_torch.models import EuclideanVAE
from hyperbolic_vae_tpu_torch.train import GenerateCallback, LatentScatterCallback


def parse_args(argv: Optional[list] = None):
    p = base_parser(__doc__.split("\n")[0])
    p.add_argument("--latent-dim", type=int, default=2)
    p.add_argument("--beta", type=float, default=1.0)
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    run_dir = setup(args, "vae_euclidean_mnist")
    dm = pad_to_32(mnist_data(args))
    model = EuclideanVAE(data_shape=dm.input_shape, latent_dim=args.latent_dim, beta=args.beta,
                         lr=args.lr, generator=torch.Generator().manual_seed(args.seed),
                         device=args.device)
    out = fit_and_test(args, run_dir, model, dm, [GenerateCallback(every_n_epochs=10),
                                                  LatentScatterCallback(every_n_epochs=10,
                                                                        range_xy=4.0)])
    return write_results(run_dir, {"vae_euclidean_mnist": out})["vae_euclidean_mnist"]


if __name__ == "__main__":
    main()
