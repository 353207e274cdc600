"""Experiment 5: the conv hyperbolic VAE on MNIST padded to 32 x 32, a
Mobius encoder head and a geoopt gyroplane decoder (512 gyroplanes on the
c = 1.4 ball: K1 on the card), MSE; fit -> load best -> test.

Port of ``experiments/train_vae_hyperbolic_mnist.py``. The results go to
``RUN_DIR/results.json``.

    python -m hyperbolic_vae_tpu_torch.experiments.train_vae_hyperbolic_mnist --synthetic
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
from hyperbolic_vae_tpu_torch.models import HyperbolicImageVAE
from hyperbolic_vae_tpu_torch.train import GenerateCallback, LatentScatterCallback


def parse_args(argv: Optional[list] = None):
    p = base_parser(__doc__.split("\n")[0])
    p.add_argument("--latent-dim", type=int, default=2)
    p.add_argument("--curvature", type=float, default=1.4)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--encoder-last", type=str, default="mobius")
    p.add_argument("--decoder-first", type=str, default="geoopt_gyroplane")
    p.add_argument("--loss-recon", type=str, default="mse")
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    run_dir = setup(args, "vae_hyperbolic_mnist")
    dm = pad_to_32(mnist_data(args))
    model = HyperbolicImageVAE(data_shape=dm.input_shape, latent_dim=args.latent_dim,
                               manifold_curvature=args.curvature,
                               encoder_last_layer_module=args.encoder_last,
                               decoder_first_layer_module=args.decoder_first, beta=args.beta,
                               lr=args.lr, loss_recon=args.loss_recon,
                               generator=torch.Generator().manual_seed(args.seed),
                               device=args.device)
    # the scatter's range: the ball's radius c^-1/2
    out = fit_and_test(args, run_dir, model, dm, [GenerateCallback(every_n_epochs=10),
                                                  LatentScatterCallback(every_n_epochs=10)])
    return write_results(run_dir, {"vae_hyperbolic_mnist": out})["vae_hyperbolic_mnist"]


if __name__ == "__main__":
    main()
