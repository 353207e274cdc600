from hyperbolic_vae_tpu_torch.nn.layers import (
    Distance2PoincareHyperplanes,
    Distance2StereographicHyperplanes,
    ExpMap0,
    GeodesicLayer,
    LogMap0,
    ManifoldParameter,
    MobiusLayer,
    PoincareHyperplanes,
    is_manifold_param,
    kaiming_normal_a_sqrt5,
)

__all__ = ["Distance2PoincareHyperplanes", "Distance2StereographicHyperplanes", "ExpMap0",
           "GeodesicLayer", "LogMap0", "ManifoldParameter", "MobiusLayer", "PoincareHyperplanes",
           "is_manifold_param", "kaiming_normal_a_sqrt5"]
