from hyperbolic_vae_tpu_torch.models.autoencoder import Autoencoder
from hyperbolic_vae_tpu_torch.models.sampling import prior_sample, prior_sample_from_eps
from hyperbolic_vae_tpu_torch.models.vae_euclidean import ConvDecoder, ConvEncoder, EuclideanVAE
from hyperbolic_vae_tpu_torch.models.vae_gyroplane import GyroplaneVAE
from hyperbolic_vae_tpu_torch.models.vae_hyperbolic import HyperbolicImageVAE
from hyperbolic_vae_tpu_torch.models.vae_pvae import PvaeMLPVAE
from hyperbolic_vae_tpu_torch.models.vae_rnaseq import RNASeqVAE
from hyperbolic_vae_tpu_torch.models.vae_unified import VAE, UnifiedVAE

__all__ = ["Autoencoder", "ConvDecoder", "ConvEncoder", "EuclideanVAE", "GyroplaneVAE",
           "HyperbolicImageVAE", "PvaeMLPVAE", "RNASeqVAE", "UnifiedVAE", "VAE", "prior_sample",
           "prior_sample_from_eps"]
