from hyperbolic_vae_tpu_torch.nn.layers import (
    ExpMap0,
    ManifoldParameter,
    PoincareHyperplanes,
    is_manifold_param,
)

__all__ = ["ExpMap0", "ManifoldParameter", "PoincareHyperplanes", "is_manifold_param"]
