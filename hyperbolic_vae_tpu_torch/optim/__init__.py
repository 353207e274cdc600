from hyperbolic_vae_tpu_torch.optim.riemannian_adam import RiemannianAdam
from hyperbolic_vae_tpu_torch.optim.schedules import (
    EarlyStopping,
    ReduceLROnPlateau,
    beta_warmup_schedule,
    cosine_schedule,
    exponential_schedule,
)

__all__ = [
    "EarlyStopping",
    "ReduceLROnPlateau",
    "RiemannianAdam",
    "beta_warmup_schedule",
    "cosine_schedule",
    "exponential_schedule",
]
