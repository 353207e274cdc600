"""A Trainer with the reference's canonical MNIST configuration.

Port of ``hyperbolic_vae_tpu/train/factories.py``
(``make_trainer_hyperbolic(curvature)``): at most 300 epochs, best and
last on ``val/loss_total``, early stopping patience 10, the
reconstruction-grid callback and the latent scatter over +-c^-0.5 (the
ball's radius), each every 10 epochs.
"""

from __future__ import annotations

from typing import Optional

from hyperbolic_vae_tpu_torch.train.callbacks import GenerateCallback, LatentScatterCallback
from hyperbolic_vae_tpu_torch.train.trainer import Trainer


def make_trainer_hyperbolic(model, curvature: float = 1.0, max_epochs: int = 300,
                            log_dir: Optional[str] = None, checkpoint_dir: Optional[str] = None,
                            **kwargs) -> Trainer:
    return Trainer(
        model,
        max_epochs=max_epochs,
        monitor="val/loss_total",
        early_stopping_patience=kwargs.pop("early_stopping_patience", 10),
        log_dir=log_dir,
        checkpoint_dir=checkpoint_dir,
        callbacks=[
            GenerateCallback(every_n_epochs=10),
            LatentScatterCallback(every_n_epochs=10, range_xy=curvature ** -0.5),
        ],
        **kwargs,
    )
