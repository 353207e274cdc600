from hyperbolic_vae_tpu_torch.train.callbacks import (
    GenerateCallback,
    LatentGridCallback,
    LatentInterpolationCallback,
    LatentScatterCallback,
)
from hyperbolic_vae_tpu_torch.train.checkpoint import CheckpointManager, restore_model
from hyperbolic_vae_tpu_torch.train.metrics import MetricLogger
from hyperbolic_vae_tpu_torch.train.trainer import Trainer, TrainResult

__all__ = [
    "CheckpointManager",
    "GenerateCallback",
    "LatentGridCallback",
    "LatentInterpolationCallback",
    "LatentScatterCallback",
    "MetricLogger",
    "TrainResult",
    "Trainer",
    "restore_model",
]
