from hyperbolic_vae_tpu_torch.train.metrics import MetricLogger
from hyperbolic_vae_tpu_torch.train.trainer import Trainer, TrainResult

__all__ = ["MetricLogger", "TrainResult", "Trainer"]
