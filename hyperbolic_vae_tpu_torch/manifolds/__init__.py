from hyperbolic_vae_tpu_torch.manifolds.euclidean import Euclidean
from hyperbolic_vae_tpu_torch.manifolds.poincare import (
    BOUNDARY_EPS,
    MIN_NORM,
    TANH_CLAMP,
    PoincareBall,
    PoincareBallWithExtras,
    arsinh,
    artanh,
    log_sinh_ratio,
    logdetexp,
    normdist2plane,
    tanh,
)
from hyperbolic_vae_tpu_torch.manifolds.stats import (
    class_means,
    frechet_mean,
    frechet_variance,
    geodesic,
)

__all__ = [
    "BOUNDARY_EPS", "MIN_NORM", "TANH_CLAMP", "Euclidean", "PoincareBall",
    "PoincareBallWithExtras", "arsinh", "artanh", "class_means", "frechet_mean",
    "frechet_variance", "geodesic", "log_sinh_ratio", "logdetexp", "normdist2plane", "tanh",
]
