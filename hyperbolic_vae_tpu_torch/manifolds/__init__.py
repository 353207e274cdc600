from hyperbolic_vae_tpu_torch.manifolds.poincare import (
    BOUNDARY_EPS,
    MIN_NORM,
    TANH_CLAMP,
    PoincareBall,
    artanh,
    tanh,
)

__all__ = ["BOUNDARY_EPS", "MIN_NORM", "TANH_CLAMP", "PoincareBall", "artanh", "tanh"]
