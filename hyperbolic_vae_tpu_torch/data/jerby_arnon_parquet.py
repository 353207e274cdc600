"""Parquet splits of the Jerby-Arnon data.

Port of ``hyperbolic_vae_tpu/data/jerby_arnon_parquet.py``:
``save_split_parquet_datasets`` reads the CSVs (``data/jerby_arnon.py``),
keeps the cells both files hold and the genes the filters keep, and
writes a seeded 60/20/20 split as ``train``/``val``/``test.parquet``
(cells as rows, one column a gene and a ``cell_type`` column);
``load_parquet_data_module`` reads them back into an ``ArrayDataModule``,
each split normalised with its own statistics as JAX normalises it, the
labels indexed in the sorted vocabulary of all three splits.

pandas and pyarrow are imported where they are called. This is a host
path; the card's machine has neither, and trains from the CSVs
(``make_rnaseq_data_module(data_dir=...)``) instead.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule
from hyperbolic_vae_tpu_torch.data.jerby_arnon import (
    aligned_arrays,
    columns,
    filter_gene_symbols,
    normalize_rnaseq,
)

logger = logging.getLogger(__name__)

SPLIT_FRACTIONS = (0.6, 0.2, 0.2)


def save_split_parquet_datasets(csv_dir, parquet_dir, seed: int = 42,
                                fractions=SPLIT_FRACTIONS) -> None:
    """CSVs -> the filtered cells x genes frame with its cell types ->
    seeded splits of ``fractions`` as parquet files."""
    import pandas as pd

    parquet_dir = Path(parquet_dir)
    parquet_dir.mkdir(parents=True, exist_ok=True)
    x, cells, genes, cell_types = aligned_arrays(csv_dir)
    x, genes = filter_gene_symbols(x.astype(np.float32, copy=False), genes)
    index = pd.Index(cells, name=columns.SINGLE_CELL_ID)
    df = pd.DataFrame(x, index=index, columns=genes)
    df[columns.CELL_TYPE] = pd.Series(list(cell_types), index=index)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(df))
    n_train = int(fractions[0] * len(df))
    n_val = int(fractions[1] * len(df))
    splits = {"train": perm[:n_train], "val": perm[n_train:n_train + n_val],
              "test": perm[n_train + n_val:]}
    for name, idx in splits.items():
        df.iloc[idx].to_parquet(parquet_dir / f"{name}.parquet")
        logger.info("wrote %s split: %d rows", name, len(idx))


def load_parquet_data_module(parquet_dir, batch_size: int = 64,
                             rnaseq_normalize_method: str | None = "z_score") -> ArrayDataModule:
    """The three parquet splits as an ``ArrayDataModule``."""
    import pandas as pd

    parquet_dir = Path(parquet_dir)
    arrays, labels = {}, {}
    vocab: list[str] = []
    for name in ("train", "val", "test"):
        df = pd.read_parquet(parquet_dir / f"{name}.parquet")
        cell_types = df.pop(columns.CELL_TYPE).astype(str)
        vocab = sorted(set(vocab) | set(cell_types))
        arrays[name] = df.to_numpy(dtype=np.float32)
        labels[name] = cell_types.to_numpy()
    index = {v: i for i, v in enumerate(vocab)}

    def split(name):
        x = normalize_rnaseq(arrays[name], rnaseq_normalize_method).astype(np.float32)
        return x, np.asarray([index[c] for c in labels[name]], np.int32)

    (x_tr, y_tr), (x_va, y_va), (x_te, y_te) = split("train"), split("val"), split("test")
    return ArrayDataModule(x_train=x_tr, y_train=y_tr, x_val=x_va, y_val=y_va, x_test=x_te,
                           y_test=y_te, batch_size=batch_size, label_names=vocab,
                           name="jerby_arnon-parquet")
