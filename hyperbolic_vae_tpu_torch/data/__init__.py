from hyperbolic_vae_tpu_torch.data import cifar10
from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule, split_three_way, split_train_val
from hyperbolic_vae_tpu_torch.data.jerby_arnon import (
    make_fake_arrays,
    make_rnaseq_data_module,
    normalize_rnaseq,
)
from hyperbolic_vae_tpu_torch.data.mnist import (
    load_mnist_arrays,
    make_data_module,
    pad_to_32,
    synthetic_mnist_arrays,
)

__all__ = [
    "ArrayDataModule",
    "cifar10",
    "load_mnist_arrays",
    "make_data_module",
    "make_fake_arrays",
    "make_rnaseq_data_module",
    "normalize_rnaseq",
    "pad_to_32",
    "split_three_way",
    "split_train_val",
    "synthetic_mnist_arrays",
]
