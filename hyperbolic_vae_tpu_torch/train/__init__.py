from hyperbolic_vae_tpu_torch.train.callbacks import (
    GenerateCallback,
    LatentGridCallback,
    LatentInterpolationCallback,
    LatentScatterCallback,
)
from hyperbolic_vae_tpu_torch.train.checkpoint import CheckpointManager, restore_model
from hyperbolic_vae_tpu_torch.train.ensemble import evaluate_lanes, fit_ensemble, fit_lane_sweep
from hyperbolic_vae_tpu_torch.train.factories import make_trainer_hyperbolic
from hyperbolic_vae_tpu_torch.train.metrics import MetricLogger
from hyperbolic_vae_tpu_torch.train.preemption import GracefulShutdown
from hyperbolic_vae_tpu_torch.train.trainer import Trainer, TrainResult

__all__ = [
    "CheckpointManager",
    "GenerateCallback",
    "GracefulShutdown",
    "LatentGridCallback",
    "LatentInterpolationCallback",
    "LatentScatterCallback",
    "MetricLogger",
    "TrainResult",
    "Trainer",
    "evaluate_lanes",
    "fit_ensemble",
    "fit_lane_sweep",
    "make_trainer_hyperbolic",
    "restore_model",
]
