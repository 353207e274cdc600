"""Weights and optimizer state in and out of the port."""

from hyperbolic_vae_tpu_torch.interop.state_dict import (
    gyroplane_vae_from_state_dict,
    load_state_dict_file,
    model_from_state_dict,
    optimizer_state_from_jax,
    state_dict_from_jax_params,
)

__all__ = [
    "gyroplane_vae_from_state_dict",
    "load_state_dict_file",
    "model_from_state_dict",
    "optimizer_state_from_jax",
    "state_dict_from_jax_params",
]
