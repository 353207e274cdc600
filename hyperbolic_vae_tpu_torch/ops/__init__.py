from hyperbolic_vae_tpu_torch.ops.gyroplane import (
    gyroplane_distances,
    gyroplane_distances_cuda,
    gyroplane_distances_fast,
)

__all__ = [
    "gyroplane_distances",
    "gyroplane_distances_cuda",
    "gyroplane_distances_fast",
]
