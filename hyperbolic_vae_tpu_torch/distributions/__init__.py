from hyperbolic_vae_tpu_torch.distributions.hyperspherical import (
    HyperbolicRadius,
    HypersphericalUniform,
    expmap_polar,
)
from hyperbolic_vae_tpu_torch.distributions.negative_binomial import (
    nb_mean_dispersion_to_logits,
    negative_binomial_log_prob,
)
from hyperbolic_vae_tpu_torch.distributions.normal import (
    kl_normal_normal,
    kl_std_normal_from_logvar,
)
from hyperbolic_vae_tpu_torch.distributions.relaxed_bernoulli import relaxed_bernoulli_log_prob
from hyperbolic_vae_tpu_torch.distributions.riemannian_normal import (
    RiemannianNormal,
    log_radius_normalizer,
    sample_radius,
    sample_radius_from_uniform,
)
from hyperbolic_vae_tpu_torch.distributions.wrapped_normal import (
    MAX_SAMPLE_RADIUS,
    WrappedNormal,
    max_chart_radius,
    normal_log_prob,
    wrapped_normal_log_prob,
    wrapped_normal_rsample,
    wrapped_normal_rsample_from_eps,
)

__all__ = [
    "HyperbolicRadius",
    "HypersphericalUniform",
    "MAX_SAMPLE_RADIUS",
    "RiemannianNormal",
    "WrappedNormal",
    "expmap_polar",
    "kl_normal_normal",
    "kl_std_normal_from_logvar",
    "log_radius_normalizer",
    "max_chart_radius",
    "nb_mean_dispersion_to_logits",
    "negative_binomial_log_prob",
    "normal_log_prob",
    "relaxed_bernoulli_log_prob",
    "sample_radius",
    "sample_radius_from_uniform",
    "wrapped_normal_log_prob",
    "wrapped_normal_rsample",
    "wrapped_normal_rsample_from_eps",
]
