from hyperbolic_vae_tpu_torch.models.sampling import prior_sample, prior_sample_from_eps
from hyperbolic_vae_tpu_torch.models.vae_gyroplane import GyroplaneVAE
from hyperbolic_vae_tpu_torch.models.vae_rnaseq import RNASeqVAE

__all__ = ["GyroplaneVAE", "RNASeqVAE", "prior_sample", "prior_sample_from_eps"]
