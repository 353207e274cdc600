"""Experiment 1: the plain conv autoencoder on CIFAR-10, swept over the
latent size.

Port of ``experiments/train_ae_euclidean_cifar10.py``: latents 64, 128,
256 and 384 by default, each with its own checkpoints in
``RUN_DIR/latent_<d>/ckpt``; a latent whose best checkpoint exists is not
trained again (the reference's pretrained short-circuit) but evaluated
from it. Val and test metrics of each latent go to
``RUN_DIR/results.json`` (``epochs`` 0 where the fit was skipped).

    python -m hyperbolic_vae_tpu_torch.experiments.train_ae_euclidean_cifar10 --synthetic
"""

from __future__ import annotations

from typing import Optional

import torch

from hyperbolic_vae_tpu_torch.experiments.common import base_parser, setup, trainer_extra, write_results
from hyperbolic_vae_tpu_torch.experiments.train_vae_euclidean_cifar10 import cifar_data
from hyperbolic_vae_tpu_torch.models import Autoencoder
from hyperbolic_vae_tpu_torch.train import GenerateCallback, Trainer
from hyperbolic_vae_tpu_torch.train.checkpoint import CheckpointManager


def train_cifar(args, run_dir, dm, latent_dim: int) -> dict:
    model = Autoencoder(data_shape=dm.input_shape, latent_dim=latent_dim, lr=args.lr,
                        generator=torch.Generator().manual_seed(args.seed), device=args.device)
    log_dir = run_dir / f"latent_{latent_dim}"
    trainer = Trainer(model, lr=args.lr, max_epochs=args.epochs, seed=args.seed,
                      monitor="val/loss_total",
                      early_stopping_patience=None if args.no_early_stopping else 10,
                      log_dir=str(log_dir), checkpoint_dir=str(log_dir / "ckpt"),
                      callbacks=[GenerateCallback(every_n_epochs=10)], **trainer_extra(args))
    mgr = CheckpointManager(str(log_dir / "ckpt"))
    epochs = 0
    if mgr.best_metadata() is not None:
        print(f"latent {latent_dim}: best checkpoint found, fit skipped", flush=True)
    else:
        epochs = trainer.fit(dm).epochs_run
    best = mgr.restore("best", device=trainer.device)
    out = dict(trainer.evaluate(dm, best, "val"), **trainer.evaluate(dm, best, "test"),
               epochs=epochs)
    print({"latent_dim": latent_dim, **out}, flush=True)
    return out


def parse_args(argv: Optional[list] = None):
    p = base_parser(__doc__.split("\n")[0])
    p.add_argument("--latent-dims", type=int, nargs="+", default=[64, 128, 256, 384])
    p.set_defaults(n_train=50000)
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    run_dir = setup(args, "ae_euclidean_cifar10")
    dm = cifar_data(args)
    return write_results(run_dir, {f"latent_{d}": train_cifar(args, run_dir, dm, d)
                                   for d in args.latent_dims})


if __name__ == "__main__":
    main()
