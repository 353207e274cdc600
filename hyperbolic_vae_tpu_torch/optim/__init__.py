from hyperbolic_vae_tpu_torch.optim.riemannian_adam import RiemannianAdam
from hyperbolic_vae_tpu_torch.optim.schedules import EarlyStopping, ReduceLROnPlateau

__all__ = ["EarlyStopping", "ReduceLROnPlateau", "RiemannianAdam"]
