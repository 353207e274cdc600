"""Weights and optimizer state in and out of the port: JAX parameter
trees (``state_dict``), the reference's own torch / Lightning / geoopt
checkpoints (``torch_import``) and back to its layout (``torch_export``)."""

from hyperbolic_vae_tpu_torch.interop.state_dict import (
    family_of_state_dict,
    gyroplane_vae_from_state_dict,
    load_state_dict_file,
    model_from_file,
    model_from_state_dict,
    optimizer_state_from_jax,
    state_dict_from_jax_params,
)
from hyperbolic_vae_tpu_torch.interop.torch_export import export_torch_state_dict
from hyperbolic_vae_tpu_torch.interop.torch_import import (
    config_from_lightning,
    import_torch_state_dict,
    load_lightning_hparams,
    load_torch_state_dict,
)

__all__ = [
    "config_from_lightning",
    "export_torch_state_dict",
    "family_of_state_dict",
    "gyroplane_vae_from_state_dict",
    "import_torch_state_dict",
    "load_lightning_hparams",
    "load_state_dict_file",
    "load_torch_state_dict",
    "model_from_file",
    "model_from_state_dict",
    "optimizer_state_from_jax",
    "state_dict_from_jax_params",
]
