from hyperbolic_vae_tpu_torch.data import cifar10, jerby_arnon, mnist, native
from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule, split_three_way, split_train_val
from hyperbolic_vae_tpu_torch.data.jerby_arnon import (
    CELL_TYPES,
    columns,
    filter_gene_symbols,
    filter_single_cells,
    get_subset_dataset,
    load_jerby_arnon_arrays,
    make_fake_arrays,
    make_rnaseq_data_module,
    nice_to_weirds,
    normalize_rnaseq,
    read_annotations,
    read_tpm,
    weird_to_nice,
)
from hyperbolic_vae_tpu_torch.data.jerby_arnon_parquet import (
    load_parquet_data_module,
    save_split_parquet_datasets,
)
from hyperbolic_vae_tpu_torch.data.mnist import (
    load_mnist_arrays,
    make_data_module,
    pad_to_32,
    synthetic_mnist_arrays,
)

__all__ = [
    "ArrayDataModule",
    "CELL_TYPES",
    "cifar10",
    "columns",
    "filter_gene_symbols",
    "filter_single_cells",
    "get_subset_dataset",
    "jerby_arnon",
    "load_jerby_arnon_arrays",
    "load_mnist_arrays",
    "load_parquet_data_module",
    "make_data_module",
    "make_fake_arrays",
    "make_rnaseq_data_module",
    "mnist",
    "native",
    "nice_to_weirds",
    "normalize_rnaseq",
    "pad_to_32",
    "read_annotations",
    "read_tpm",
    "save_split_parquet_datasets",
    "split_three_way",
    "split_train_val",
    "synthetic_mnist_arrays",
    "weird_to_nice",
]
