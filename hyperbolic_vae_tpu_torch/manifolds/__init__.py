from hyperbolic_vae_tpu_torch.manifolds.poincare import (
    BOUNDARY_EPS,
    MIN_NORM,
    TANH_CLAMP,
    PoincareBall,
    artanh,
    log_sinh_ratio,
    tanh,
)

__all__ = [
    "BOUNDARY_EPS", "MIN_NORM", "TANH_CLAMP", "PoincareBall", "artanh", "log_sinh_ratio", "tanh",
]
