from hyperbolic_vae_tpu_torch.ops.flagship_fused import (
    FusedFlagshipLoss,
    flagship_forward_torch,
    flagship_fused_cuda,
    flagship_grads_torch,
    flagship_train_cuda,
    flagship_train_step_torch,
    fused_flagship_loss,
    make_fused_loss_fn,
    make_fused_train_step,
    params_tuple,
    supports_fused,
)
from hyperbolic_vae_tpu_torch.ops.gyroplane import (
    gyroplane_distances,
    gyroplane_distances_cuda,
    gyroplane_distances_fast,
)



def launch_counters() -> dict:
    """Each CUDA kernel's launch counter, by kernel name."""
    from hyperbolic_vae_tpu_torch.ops import flagship_fused, gyroplane, riemannian_adam

    return {"gyroplane_distances": gyroplane.launches, "flagship_fused": flagship_fused.launches,
            "flagship_train": flagship_fused.train_launches,
            "riemannian_adam": riemannian_adam.launches}


__all__ = [
    "FusedFlagshipLoss",
    "flagship_forward_torch",
    "flagship_fused_cuda",
    "flagship_grads_torch",
    "flagship_train_cuda",
    "flagship_train_step_torch",
    "fused_flagship_loss",
    "gyroplane_distances",
    "gyroplane_distances_cuda",
    "gyroplane_distances_fast",
    "launch_counters",
    "make_fused_loss_fn",
    "make_fused_train_step",
    "params_tuple",
    "supports_fused",
]
