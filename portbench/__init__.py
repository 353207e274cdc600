"""The benchmark of the PyTorch and CUDA port (``hyperbolic_vae_tpu_torch``)."""
