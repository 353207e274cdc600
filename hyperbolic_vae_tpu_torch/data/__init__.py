from hyperbolic_vae_tpu_torch.data.mnist import synthetic_mnist_arrays

__all__ = ["synthetic_mnist_arrays"]
