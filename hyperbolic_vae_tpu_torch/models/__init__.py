from hyperbolic_vae_tpu_torch.models.sampling import prior_sample, prior_sample_from_eps
from hyperbolic_vae_tpu_torch.models.vae_gyroplane import GyroplaneVAE

__all__ = ["GyroplaneVAE", "prior_sample", "prior_sample_from_eps"]
