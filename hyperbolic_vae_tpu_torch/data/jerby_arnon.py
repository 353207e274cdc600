"""The Jerby-Arnon melanoma scRNA-seq data (GSE115978).

Port of ``hyperbolic_vae_tpu/data/jerby_arnon.py`` (numpy, so one seed
gives the JAX package's arrays bit for bit): the column names and the
cell-type vocabulary, the gene and cell filters, the normalisations, the
CSV readers, the seeded fake dataset with the real schema (Poisson(100)
counts, flat or with a marker-gene module per cell type), the integer
labels and ``make_rnaseq_data_module``'s seeded 70/15/15 split, from the
fake data or from a directory holding GEO's ``annotations.csv`` and
``tpm.csv``.

The readers work on arrays, without pandas, so that the path a user
trains from (``load_jerby_arnon_arrays`` -> ``make_rnaseq_data_module(
data_dir=...)``) runs where pandas is not installed:

  * ``annotations.csv`` through the ``csv`` module. Every column's
    missing spellings are pandas' default NA values (``PANDAS_NA``), and
    in ``cell.types`` also ``?``; a missing cell type becomes "Unknown",
    then the vocabulary's synonyms their names; rows sorted by cell id.
  * ``tpm.csv`` (genes as rows, cells as columns) through the port's C++
    parser (``data/native.py``) for the numbers; the gene symbols and the
    cell ids as JAX reads them (each line's text up to its first comma;
    the header split on commas, its first field dropped when it has one
    field more than the matrix has columns, as GEO writes it); cells and
    genes sorted by label.
  * Sorting is numpy's stable argsort of the labels, the order pandas 3
    gives (its ``str`` labels sort with pyarrow's stable
    ``array_sort_indices``), duplicate labels included.
  * Where the C++ parser refuses a file (a ragged row, a quoted newline),
    the TPM is read with pandas, with a warning, when pandas imports;
    otherwise the parser's error is raised and says that pandas is
    absent. ``get_subset_dataset`` (pandas' ``skiprows``) and the
    DataFrames of ``read_annotations``/``read_tpm`` need pandas, imported
    where they are called.

The pandas-free reader refuses what it cannot read as pandas does: cell
ids that are all numbers (pandas would parse and sort them as numbers),
a missing cell id and, in ``load_jerby_arnon_arrays``, a cell id twice
in one file. Downloads are not ported (no network): the CSVs come from a
connected machine.
"""

from __future__ import annotations

import csv
import logging
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule, split_three_way

logger = logging.getLogger(__name__)

columns = SimpleNamespace(
    CELL_TYPE="cell_type",
    GENE_SYMBOL="gene_symbol",
    SAMPLE_ID="sample_id",
    SINGLE_CELL_ID="single_cell_id",
)

# the cell-type vocabulary and its synonyms in the data
nice_to_weirds = {
    "Malignant": ["Malignant.cell", "Mal", "Malignant cell"],
    "Endothelial": ["Endothelial.cell", "Endothelial cells", "Endo.", "Endothelial cell"],
    "CAF": [],
    "T CD8": ["T.CD8", "T cells CD8", "TCD8"],
    "NK": ["NK cells"],
    "Macrophage": ["Macrophages"],
    "T CD4": ["T.CD4", "T cells CD4", "TCD4"],
    "B": ["B.cell", "B cells", "B cell"],
    "T": ["T.cell", "T cell"],
}
weird_to_nice = {w: nice for nice, ws in nice_to_weirds.items() for w in ws}
CELL_TYPES = list(nice_to_weirds) + ["Unknown"]
_TYPES = CELL_TYPES[:-1]

# pandas' default NA spellings (``pandas._libs.parsers.STR_NA_VALUES``),
# which ``read_csv`` turns into NaN in every column
PANDAS_NA = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])
# annotations.csv's columns -> the module's names
_RENAME = {"cells": columns.SINGLE_CELL_ID, "cell.types": columns.CELL_TYPE,
           "samples": columns.SAMPLE_ID}
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\Z")


def normalize_rnaseq(x: np.ndarray, method: str | None) -> np.ndarray:
    """Normalise (n_cells, n_genes) floats. ``None`` / ``"counts"`` keeps
    the raw counts (what ``RNASeqVAE(recon="nb")`` expects);
    ``"sum_to_one"``, ``"sum_to_million"`` scale each cell; ``"z_score"``
    standardises each gene (ddof 0)."""
    if method is None or method == "counts":
        return x
    if method == "sum_to_one":
        return x / np.maximum(x.sum(axis=1, keepdims=True), 1e-12)
    if method == "sum_to_million":
        return x / np.maximum(x.sum(axis=1, keepdims=True), 1e-12) * 1_000_000
    if method == "z_score":
        mu = x.mean(axis=0, keepdims=True)
        sd = x.std(axis=0, keepdims=True, ddof=0)
        return (x - mu) / np.maximum(sd, 1e-12)
    raise ValueError(f"rnaseq_normalize_method {method} not recognized")


def filter_gene_symbols(x: np.ndarray, gene_symbols: list[str]):
    """Drop the mitochondrial genes (symbols starting with "MT") and the
    genes zero in more than 90 % of the cells."""
    genes = np.asarray(gene_symbols)
    keep = ~np.char.startswith(genes.astype(str), "MT")
    zero_rate = (x == 0).mean(axis=0)
    keep &= zero_rate <= 0.9
    return x[:, keep], [g for g, k in zip(gene_symbols, keep) if k]


def filter_single_cells(x: np.ndarray, annotations: np.ndarray):
    """Drop the cells whose expression is zero in more than 90 % of genes."""
    keep = (x == 0).mean(axis=1) <= 0.9
    return x[keep], annotations[keep]


def sort_order(labels) -> np.ndarray:
    """The indices that sort ``labels`` (strings) as pandas 3 sorts an
    index of them: ascending, equal labels in their order."""
    return np.argsort(np.asarray(labels, dtype=object), kind="stable")


# ---- annotations.csv -------------------------------------------------------


def annotation_table(path_csv) -> dict:
    """annotations.csv as ``{column: list}``, renamed (``cells`` ->
    single_cell_id, ``cell.types`` -> cell_type, ``samples`` -> sample_id),
    rows sorted by cell id: each missing value (pandas' NA spellings, and
    ``?`` in the cell types) is None, a missing cell type "Unknown", a
    synonym of the vocabulary its name. Cell ids stay strings: a file whose
    cell ids are all numbers, or that lacks one, raises."""
    with open(path_csv, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f) if r]  # pandas skips blank lines
    if not rows:
        raise ValueError(f"{path_csv}: empty file")
    header, body = rows[0], rows[1:]
    if len(set(header)) != len(header):
        raise ValueError(f"{path_csv}: a column name is repeated in the header {header}")
    table = {}
    for j, name in enumerate(header):
        na = PANDAS_NA | {"?"} if name == "cell.types" else PANDAS_NA
        col = []
        for i, r in enumerate(body):
            if len(r) > len(header):
                raise ValueError(f"{path_csv}: line {i + 2} has {len(r)} fields, the header "
                                 f"{len(header)}")
            v = r[j] if j < len(r) else ""  # a short row's missing fields are NA
            col.append(None if v in na else v)
        table[_RENAME.get(name, name)] = col
    ids = table.get(columns.SINGLE_CELL_ID)
    if ids is None:
        raise KeyError(f"{path_csv}: no 'cells' column (header {header})")
    if any(c is None for c in ids):
        raise ValueError(f"{path_csv}: a row has no cell id")
    if ids and all(_FLOAT.match(c) for c in ids):
        raise ValueError(f"{path_csv}: the cell ids are all numbers, which pandas would read and "
                         f"sort as numbers and the TPM header as text; name the cells")
    if columns.CELL_TYPE in table:
        table[columns.CELL_TYPE] = [weird_to_nice.get(t, t) if t is not None else "Unknown"
                                    for t in table[columns.CELL_TYPE]]
    order = sort_order(ids)
    return {k: [v[i] for i in order] for k, v in table.items()}


def _typed(values: list):
    """A column of strings (None: missing) typed as pandas' reader types
    it: int64 when every value is an integer, float64 (NaN for missing)
    when every present value is a number, else strings."""
    present = [v for v in values if v is not None]
    if present and all(_INT.match(v) for v in present) and len(present) == len(values):
        return np.asarray([int(v) for v in values], dtype=np.int64)
    if present and all(_FLOAT.match(v) for v in present):
        return np.asarray([float(v) if v is not None else np.nan for v in values], np.float64)
    return values


def read_annotations(path_csv) -> "pandas.DataFrame":
    """annotations.csv as a DataFrame, as JAX's ``read_annotations``
    returns it: ``annotation_table``'s columns (numbers typed as pandas
    types them), indexed by cell id (the column kept). Needs pandas."""
    import pandas as pd

    table = annotation_table(path_csv)
    df = pd.DataFrame({k: _typed(v) for k, v in table.items()})
    return df.set_index(columns.SINGLE_CELL_ID, drop=False)


# ---- tpm.csv ----------------------------------------------------------------


def tpm_matrix(path_csv, use_native: bool = True):
    """tpm.csv as (x (cells, genes) sorted by cell id and gene symbol, cell
    ids, gene symbols). ``x`` is float32 from the C++ parser; float64 from
    pandas (the fallback where the parser refuses the file or
    ``use_native`` is False, as JAX's reader gives it)."""
    if use_native:
        from hyperbolic_vae_tpu_torch.data import native

        if native.is_available():
            try:
                values = native.read_csv_matrix(path_csv)
            except RuntimeError as e:
                try:
                    import pandas  # noqa: F401
                except ImportError:
                    raise RuntimeError(f"{e}; pandas is not installed, so there is no other "
                                       f"reader for this file") from e
                logger.warning("native CSV parse failed (%s); falling back to pandas", e)
            else:
                with open(path_csv, encoding="utf-8") as f:
                    header = f.readline().rstrip("\n").split(",")
                    index = [line.split(",", 1)[0] for line in f]
                cell_ids = header[1:] if len(header) - 1 == values.shape[1] else header
                return _sorted_cells_by_genes(values, index, cell_ids)
        else:
            try:
                import pandas  # noqa: F401
            except ImportError:
                raise RuntimeError(f"the native CSV parser is not built ({native.build_error()}) "
                                   f"and pandas is not installed: no reader for {path_csv}")
    import pandas as pd

    df = pd.read_csv(path_csv, engine="pyarrow", index_col=0)
    return _sorted_cells_by_genes(df.to_numpy(), list(df.index), list(df.columns))


def _sorted_cells_by_genes(values: np.ndarray, genes: list, cells: list):
    """(genes, cells) values -> ((cells, genes) sorted both ways, cells, genes)."""
    gi, ci = sort_order(genes), sort_order(cells)
    x = np.ascontiguousarray(values[gi][:, ci].T)
    return x, [cells[i] for i in ci], [genes[i] for i in gi]


def read_tpm(path_csv, skiprows=None, use_native: bool = True) -> "pandas.DataFrame":
    """tpm.csv as JAX's ``read_tpm`` returns it: cells as rows (index
    ``single_cell_id``), genes as columns (``gene_symbol``), both sorted.
    ``skiprows`` (pandas' argument) reads with pandas. Needs pandas."""
    import pandas as pd

    if skiprows is None:
        x, cells, genes = tpm_matrix(path_csv, use_native)
        df = pd.DataFrame(x, index=cells, columns=genes)
        return df.rename_axis(index=columns.SINGLE_CELL_ID, columns=columns.GENE_SYMBOL)
    df = pd.read_csv(path_csv, index_col=0, skiprows=skiprows)
    df = df.rename_axis(index=columns.GENE_SYMBOL, columns=columns.SINGLE_CELL_ID)
    df = df.sort_index(axis="columns").sort_index(axis="index")
    return df.T


# ---- the arrays ---------------------------------------------------------------


def _csv_paths(data_dir):
    data_dir = Path(data_dir)
    ann_path, tpm_path = data_dir / "annotations.csv", data_dir / "tpm.csv"
    if not (ann_path.exists() and tpm_path.exists()):
        raise FileNotFoundError(
            f"Jerby-Arnon CSVs not found in {data_dir} (need annotations.csv, tpm.csv). "
            "There is no download here: copy them from a connected machine or use the fake "
            "dataset.")
    return ann_path, tpm_path


def aligned_arrays(data_dir):
    """The cells both files hold, in cell-id order: (x (cells, genes) as
    read, cell ids, gene symbols, cell types)."""
    ann_path, tpm_path = _csv_paths(data_dir)
    ann = annotation_table(ann_path)
    x, cells, genes = tpm_matrix(tpm_path)
    ann_ids = ann[columns.SINGLE_CELL_ID]
    for name, ids in (("annotations.csv", ann_ids), ("tpm.csv", cells)):
        if len(set(ids)) != len(ids):
            raise ValueError(f"{name} names a cell twice; its rows cannot be aligned")
    common, i_tpm, i_ann = np.intersect1d(np.asarray(cells, dtype=object),
                                          np.asarray(ann_ids, dtype=object),
                                          assume_unique=True, return_indices=True)
    types = np.asarray(ann[columns.CELL_TYPE], dtype=object)[i_ann]
    return x[i_tpm], list(common), genes, types


def load_jerby_arnon_arrays(data_dir, rnaseq_normalize_method: str | None = "z_score"):
    """The real-data path: annotations and TPM CSVs -> (x (n_cells,
    n_genes) float32, filtered and normalised; cell types; gene symbols)."""
    x, _, genes, cell_types = aligned_arrays(data_dir)
    x, genes = filter_gene_symbols(x.astype(np.float32, copy=False), genes)
    x = normalize_rnaseq(x, rnaseq_normalize_method).astype(np.float32)
    return x, cell_types, genes


def get_subset_dataset(data_dir, n_samples: int = 10, genes_keep_one_in: int = 100,
                       rnaseq_normalize_method: str | None = "sum_to_one"):
    """A cheap subset for interactive work: every Nth gene row and the
    first ``n_samples`` cells by id. Returns (x, cell types, genes). Needs
    pandas (its ``skiprows``)."""
    data_dir = Path(data_dir)
    ann = read_annotations(data_dir / "annotations.csv")
    tpm = read_tpm(data_dir / "tpm.csv", skiprows=lambda i: i % genes_keep_one_in)
    x = tpm.to_numpy(dtype=np.float32)
    x, genes = filter_gene_symbols(x, list(tpm.columns))
    keep = ann.index[:n_samples]
    mask = tpm.index.isin(keep)
    x = normalize_rnaseq(x[mask], rnaseq_normalize_method).astype(np.float32)
    return x, ann.loc[tpm.index[mask], columns.CELL_TYPE].to_numpy(), genes


def make_fake_arrays(n_samples: int = 1000, n_genes: int = 2000, seed: int = 42,
                     structured: bool = False):
    """(x counts (n_samples, n_genes) f32, cell types, gene symbols, cell
    ids) from Poisson(100) draws. ``structured=True`` gives each cell type
    a module of ~n_genes / 20 marker genes at rate 300, so a latent model
    that works separates the types."""
    rng = np.random.default_rng(seed)
    if structured:
        cell_types = rng.choice(_TYPES, size=n_samples)
        module = max(n_genes // 20, 1)
        rates = np.full((len(_TYPES), n_genes), 100.0)
        for t in range(len(_TYPES)):
            lo = (t * module) % max(n_genes - module, 1)
            rates[t, lo:lo + module] = 300.0
        type_idx = np.array([_TYPES.index(t) for t in cell_types])
        x = rng.poisson(rates[type_idx]).astype(np.float32)
    else:
        # the draw order (x, then labels) of the reference's factory
        x = rng.poisson(100, size=(n_samples, n_genes)).astype(np.float32)
        cell_types = rng.choice(_TYPES, size=n_samples)
    gene_symbols = [f"gene_{i:05d}" for i in range(n_genes)]
    cell_ids = [f"cell_{i}" for i in range(n_samples)]
    return x, cell_types, gene_symbols, cell_ids


def _labels_to_int(cell_types) -> tuple[np.ndarray, list[str]]:
    vocab = sorted(set(map(str, cell_types)))
    index = {v: i for i, v in enumerate(vocab)}
    return np.asarray([index[str(c)] for c in cell_types], dtype=np.int32), vocab


def make_rnaseq_data_module(
    batch_size: int = 64,
    data_dir: str | None = None,
    fake: bool = False,
    n_samples: int = 1000,
    n_genes: int = 2000,
    rnaseq_normalize_method: str | None = "z_score",
    seed: int = 42,
    structured_fake: bool = False,
) -> ArrayDataModule:
    """The CSVs in ``data_dir`` (``load_jerby_arnon_arrays``), or the fake
    dataset (``fake=True``, or no ``data_dir``), normalised, split
    70/15/15 with ``seed``. The fake counts are drawn with seed 42 whatever
    ``seed`` is, as in JAX."""
    is_fake = fake or data_dir is None
    if is_fake:
        x, cell_types, _, _ = make_fake_arrays(n_samples, n_genes, structured=structured_fake)
        x = normalize_rnaseq(x, rnaseq_normalize_method).astype(np.float32)
    else:
        x, cell_types, _ = load_jerby_arnon_arrays(data_dir, rnaseq_normalize_method)
    y, vocab = _labels_to_int(cell_types)
    (x_tr, y_tr), (x_va, y_va), (x_te, y_te) = split_three_way(x, y, seed=seed)
    return ArrayDataModule(x_train=x_tr, y_train=y_tr, x_val=x_va, y_val=y_va, x_test=x_te,
                           y_test=y_te, batch_size=batch_size, label_names=vocab,
                           name="jerby_arnon-fake" if is_fake else "jerby_arnon")
