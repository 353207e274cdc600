"""The Jerby-Arnon melanoma scRNA-seq data (GSE115978): the arrays path.

Port of the array half of ``hyperbolic_vae_tpu/data/jerby_arnon.py``
(numpy, so one seed gives the JAX package's arrays bit for bit): the
normalisations, the seeded fake dataset with the real schema (Poisson(100)
counts, flat or with a marker-gene module per cell type), the integer
labels and ``make_rnaseq_data_module``'s seeded 70/15/15 split. The CSV
readers need pandas and are not ported: ``data_dir=`` raises.
"""

from __future__ import annotations

import numpy as np

from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule, split_three_way

# the cell types of the dataset, in the JAX package's order (its
# ``nice_to_weirds`` keys), and "Unknown"
CELL_TYPES = ["Malignant", "Endothelial", "CAF", "T CD8", "NK", "Macrophage", "T CD4", "B", "T",
              "Unknown"]
_TYPES = CELL_TYPES[:-1]


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
    """The fake dataset (``fake=True``, or no ``data_dir``), normalised,
    split 70/15/15 with ``seed``. The fake counts are drawn with seed 42
    whatever ``seed`` is, as in JAX."""
    if data_dir is not None and not fake:
        raise NotImplementedError(
            "the Jerby-Arnon CSV readers need pandas and are not ported yet "
            "(ROADMAP Queue 1, item 6); use fake=True")
    x, cell_types, _, _ = make_fake_arrays(n_samples, n_genes, structured=structured_fake)
    x = normalize_rnaseq(x, rnaseq_normalize_method).astype(np.float32)
    y, vocab = _labels_to_int(cell_types)
    (x_tr, y_tr), (x_va, y_va), (x_te, y_te) = split_three_way(x, y, seed=seed)
    return ArrayDataModule(x_train=x_tr, y_train=y_tr, x_val=x_va, y_val=y_va, x_test=x_te,
                           y_test=y_te, batch_size=batch_size, label_names=vocab,
                           name="jerby_arnon-fake")
