from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule, split_train_val
from hyperbolic_vae_tpu_torch.data.mnist import (
    load_mnist_arrays,
    make_data_module,
    synthetic_mnist_arrays,
)

__all__ = [
    "ArrayDataModule",
    "load_mnist_arrays",
    "make_data_module",
    "split_train_val",
    "synthetic_mnist_arrays",
]
