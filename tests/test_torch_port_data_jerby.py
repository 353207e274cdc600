"""The Jerby-Arnon data paths of the port against the JAX package's.

The port's C++ parser (its own ``csrc/csv_etl.cpp``, built with g++ into
``_build/``) against ``hyperbolic_vae_tpu.data.native`` on JAX's
adversarial and ragged files; the readers (``read_annotations``,
``read_tpm``, ``load_jerby_arnon_arrays``, ``make_rnaseq_data_module(
data_dir=...)``, ``get_subset_dataset``) against JAX's on GEO's layout
with NA spellings, a duplicate gene symbol and a mitochondrial gene,
with pandas and with pandas made unimportable; the parquet splits'
round trip against JAX's. The card test parses a file at the realistic
width of 20,480 genes.
"""

from __future__ import annotations

import logging
import sys

import numpy as np
import pytest

from hyperbolic_vae_tpu_torch.data import jerby_arnon as port_ja
from hyperbolic_vae_tpu_torch.data import jerby_arnon_parquet as port_pq
from hyperbolic_vae_tpu_torch.data import native as port_native

# JAX's adversarial files (tests/test_native.py), each parsed by pandas and
# by both parsers alike, and its ragged files, refused with a code
CSV_CASES = {
    "crlf": "g,c1,c2\r\ng1,1.5,2.5\r\ng2,3.5,4.5\r\n",
    "quoted": 'g,c1,c2\n"g,1",1.5,"2.5"\n"g""2","3.5",4.5\n',
    "spaces": "g,c1,c2\ng1, 1.5 ,2.5\ng2,3.5, 4.5\n",
    "huge_denormal": "g,c1,c2\ng1,1e40,1e-45\ng2,-3e38,4.9e-324\n",
    "many_digits": "g,c1,c2\ng1,123456789012345678901.5,0.000123456789012345678901\n"
                   "g2,1.5,2.5\n",
    "no_final_newline": "g,c1,c2\ng1,1.5,2.5\ng2,3.5,4.5",
    "mixed_quote_rows": 'g,c1,c2\n"g,1","1.5",2.5\ng2,3.5,4.5\ng3,5.5,6.5\n',
    "trailing_delim_all": "g,c1,c2\ng1,1.5,2.5,\ng2,3.5,4.5,\n",
    "missing_values": "gene,c1,c2,c3\ng1,1.5,NA,3\ng2,,2.25e1,-4\n",
    "junk_suffix": "g,c1,c2\ng1,1.5x,2.5\ng2,3.5,4.5 7\n",
    "ragged_fewer": "g,c1,c2\ng1,1.5,2.5\ng2,3.5\n",
    "ragged_extra": "g,c1,c2\ng1,1.5,2.5\ng2,3.5,4.5,9.9\n",
    "ragged_noindex": "g,c1,c2\ng1,1.5,2.5\nnocommas\n",
    "embedded_newline_quoted": 'g,c1,c2\ng1,1.5,"a\nb,9,8"\ng2,3.5,4.5\n',
    "empty_file": "",
}


def _jax_native():
    from hyperbolic_vae_tpu.data import native

    if not native.is_available():
        pytest.skip("the JAX package's native parser did not build")
    return native


@pytest.mark.parametrize("name", sorted(CSV_CASES))
def test_read_csv_matrix_equals_jax(tmp_path, name):
    """Bit for bit JAX's parse (NaN positions included), or the same
    refusal with the same code."""
    jax_native = _jax_native()
    p = tmp_path / f"{name}.csv"
    p.write_bytes(CSV_CASES[name].encode())
    try:
        want = jax_native.read_csv_matrix(p)
    except RuntimeError as e:
        with pytest.raises(RuntimeError) as got:
            port_native.read_csv_matrix(p)
        assert str(got.value) == str(e)
        return
    got = port_native.read_csv_matrix(p)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_error_table_equals_jax():
    jax_native = _jax_native()
    assert port_native._READ_ERRORS == jax_native._READ_ERRORS


@pytest.mark.parametrize("ddof", [0, 1])
def test_zscore_columns_equals_jax(ddof):
    jax_native = _jax_native()
    x = np.random.default_rng(3).gamma(2.0, 3.0, (37, 11)).astype(np.float32)
    x[:, 4] = 2.5  # a constant column: zero variance -> 0
    want = jax_native.zscore_columns(x.copy(), ddof=ddof, n_threads=3)
    got = port_native.zscore_columns(x.copy(), ddof=ddof, n_threads=3)
    np.testing.assert_array_equal(got, want)


def test_library_builds_into_the_package_build_dir():
    assert port_native.is_available()
    so = port_native.library_path()
    assert so.parent.name == "_build" and so.parent.parent.name == "hyperbolic_vae_tpu_torch"
    assert so.exists()


def test_build_failure_leaves_the_parser_unavailable_and_says_why(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_failed", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with caplog.at_level(logging.WARNING):
        assert not port_native.is_available()
    assert "no-such-compiler" in port_native.build_error()
    assert any("could not be built" in r.getMessage() for r in caplog.records)
    with pytest.raises(RuntimeError, match="not built"):
        port_native.read_csv_matrix(tmp_path / "x.csv")


# ---- the readers ------------------------------------------------------------

GENES = ["AAA1", "BBB2", "MT-CO1", "CCC3", "DDD4", "ZERO9", "BBB2", "AAA0"]


def _write_geo_pair(d, n_cells=24, seed=2, types=None, first_header_field=True, genes=GENES):
    """JAX's fixture layout (tests/test_data_fixtures.py), plus NA
    spellings and '?' among the cell types and a second column with gaps,
    a duplicate gene symbol, cells written out of order, and an extra
    annotation with no TPM column."""
    rng = np.random.default_rng(seed)
    cells = [f"cell_{i:02d}" for i in range(n_cells)]
    order = rng.permutation(n_cells)
    if types is None:
        pool = ["Mal", "T.CD4", "?", "B.cell", "NA", "", "Macrophages", "N/A", "null", "T CD8"]
        types = [pool[i % len(pool)] for i in range(n_cells)]
    with open(d / "annotations.csv", "w") as f:
        f.write("cells,cell.types,samples,no.of.genes\n")
        for i in order:
            sample = "NA" if i % 7 == 3 else f"s{i % 3}"
            genes_n = "" if i % 5 == 1 else str(1000 + i)
            f.write(f'{cells[i]},"{types[i]}",{sample},{genes_n}\n')
        f.write("cell_zz,Mal,s9,7\n")
    tpm = rng.uniform(1.0, 9.0, (len(genes), n_cells))
    tpm[genes.index("ZERO9"), :] = 0.0
    tpm[genes.index("ZERO9"), 0] = 5.0  # 1 of 24 nonzero: dropped
    tpm[genes.index("AAA0"), 1::2] = 0.0
    with open(d / "tpm.csv", "w") as f:
        f.write(("," if first_header_field else "") + ",".join(cells[i] for i in order) + "\n")
        for g, row in zip(genes, tpm):
            f.write(g + "," + ",".join(f"{v:.4f}" for v in row[order]) + "\n")
    return d


@pytest.fixture()
def geo_dir(tmp_path):
    return _write_geo_pair(tmp_path)


def _no_pandas(monkeypatch):
    for name in [m for m in sys.modules if m == "pandas" or m.startswith("pandas.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pandas", None)


def test_read_annotations_equals_jax(geo_dir):
    import pandas as pd

    from hyperbolic_vae_tpu.data import jerby_arnon as jax_ja

    want = jax_ja.read_annotations(geo_dir / "annotations.csv")
    got = port_ja.read_annotations(geo_dir / "annotations.csv")
    pd.testing.assert_frame_equal(got, want)
    assert "Unknown" in set(got[port_ja.columns.CELL_TYPE])


# without GEO's empty first header field pandas reads one column short
# and refuses the file, so only the native reader takes that layout
@pytest.mark.parametrize("use_native,first_header_field", [(True, True), (True, False),
                                                          (False, True)])
def test_read_tpm_equals_jax(tmp_path, use_native, first_header_field):
    import pandas as pd

    from hyperbolic_vae_tpu.data import jerby_arnon as jax_ja

    d = _write_geo_pair(tmp_path, first_header_field=first_header_field)
    want = jax_ja.read_tpm(d / "tpm.csv", use_native=use_native)
    got = port_ja.read_tpm(d / "tpm.csv", use_native=use_native)
    pd.testing.assert_frame_equal(got, want)


def test_sort_order_equals_pandas_with_duplicates():
    """Equal labels keep their order, as pandas' sort_index keeps them."""
    import pandas as pd

    rng = np.random.default_rng(5)
    labels = [f"g{v}" for v in rng.integers(0, 7, 200)]
    df = pd.DataFrame({"row": np.arange(200)}, index=labels).sort_index()
    np.testing.assert_array_equal(port_ja.sort_order(labels), df["row"].to_numpy())


@pytest.mark.parametrize("normalize", ["z_score", "sum_to_one", None])
def test_load_arrays_and_data_module_equal_jax(geo_dir, normalize):
    from hyperbolic_vae_tpu.data import jerby_arnon as jax_ja

    xw, tw, gw = jax_ja.load_jerby_arnon_arrays(geo_dir, normalize)
    xg, tg, gg = port_ja.load_jerby_arnon_arrays(geo_dir, normalize)
    assert xg.dtype == xw.dtype == np.float32
    np.testing.assert_array_equal(xg, xw)
    assert list(tg) == list(tw) and gg == gw
    assert "MT-CO1" not in gg and "ZERO9" not in gg and gg.count("BBB2") == 2
    want = jax_ja.make_rnaseq_data_module(batch_size=8, data_dir=str(geo_dir),
                                          rnaseq_normalize_method=normalize)
    got = port_ja.make_rnaseq_data_module(batch_size=8, data_dir=str(geo_dir),
                                          rnaseq_normalize_method=normalize)
    _assert_modules_equal(got, want)


def _assert_modules_equal(got, want):
    for s in ("train", "val", "test"):
        for a in ("x", "y"):
            w, g = getattr(want, f"{a}_{s}"), getattr(got, f"{a}_{s}")
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert list(got.label_names) == list(want.label_names)
    assert (got.name, got.batch_size) == (want.name, want.batch_size)


def test_pandas_free_route_gives_the_same_arrays(geo_dir, monkeypatch):
    want = port_ja.make_rnaseq_data_module(batch_size=8, data_dir=str(geo_dir))
    arrays = port_ja.load_jerby_arnon_arrays(geo_dir)
    _no_pandas(monkeypatch)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    got = port_ja.make_rnaseq_data_module(batch_size=8, data_dir=str(geo_dir))
    _assert_modules_equal(got, want)
    again = port_ja.load_jerby_arnon_arrays(geo_dir)
    np.testing.assert_array_equal(again[0], arrays[0])
    assert list(again[1]) == list(arrays[1]) and again[2] == arrays[2]


def test_ragged_tpm_falls_back_to_pandas_or_says_pandas_is_absent(geo_dir, monkeypatch,
                                                                   caplog):
    """A file the C++ parser refuses goes to pandas (whose pyarrow engine
    refuses a ragged row too, in both packages alike); without pandas the
    parser's own error is raised and says that pandas is absent."""
    import pandas as pd

    from hyperbolic_vae_tpu.data import jerby_arnon as jax_ja

    with open(geo_dir / "tpm.csv", "a") as f:
        f.write("EEE5,1.0,2.0\n")  # fewer fields than the header
    with pytest.raises(pd.errors.ParserError) as want:
        jax_ja.load_jerby_arnon_arrays(geo_dir)
    with caplog.at_level(logging.WARNING), pytest.raises(pd.errors.ParserError) as got:
        port_ja.load_jerby_arnon_arrays(geo_dir)
    assert str(got.value) == str(want.value)
    assert any("falling back to pandas" in r.getMessage() for r in caplog.records)
    _no_pandas(monkeypatch)
    with pytest.raises(RuntimeError, match="FEWER value fields.*pandas is not installed"):
        port_ja.load_jerby_arnon_arrays(geo_dir)


def test_numeric_cell_ids_are_refused(tmp_path):
    (tmp_path / "annotations.csv").write_text("cells,cell.types\n3,Mal\n10,B\n")
    with pytest.raises(ValueError, match="all numbers"):
        port_ja.annotation_table(tmp_path / "annotations.csv")


def test_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="annotations.csv, tpm.csv"):
        port_ja.load_jerby_arnon_arrays(tmp_path)


def test_get_subset_dataset_equals_jax(tmp_path):
    from hyperbolic_vae_tpu.data import jerby_arnon as jax_ja

    d = _write_geo_pair(tmp_path, n_cells=30)
    want = jax_ja.get_subset_dataset(d, n_samples=12, genes_keep_one_in=2)
    got = port_ja.get_subset_dataset(d, n_samples=12, genes_keep_one_in=2)
    np.testing.assert_array_equal(got[0], want[0])
    assert list(got[1]) == list(want[1]) and got[2] == want[2]


def test_parquet_round_trip_equals_jax(tmp_path):
    """(parquet refuses a repeated column name: one symbol a gene here)"""
    pytest.importorskip("pyarrow")
    from hyperbolic_vae_tpu.data import jerby_arnon_parquet as jax_pq

    geo_dir = tmp_path / "csv"
    geo_dir.mkdir()
    _write_geo_pair(geo_dir, genes=[g for g in GENES if g != "BBB2"] + ["BBB3"])

    jax_pq.save_split_parquet_datasets(geo_dir, tmp_path / "jax", seed=3)
    port_pq.save_split_parquet_datasets(geo_dir, tmp_path / "port", seed=3)
    want = jax_pq.load_parquet_data_module(tmp_path / "jax", batch_size=4)
    got = port_pq.load_parquet_data_module(tmp_path / "port", batch_size=4)
    _assert_modules_equal(got, want)
    # each package reads the other's files alike
    _assert_modules_equal(port_pq.load_parquet_data_module(tmp_path / "jax", batch_size=4), want)


def test_fake_data_module_is_unchanged():
    from hyperbolic_vae_tpu.data import jerby_arnon as jax_ja

    _assert_modules_equal(port_ja.make_rnaseq_data_module(batch_size=16, fake=True, n_samples=90,
                                                          n_genes=30, structured_fake=True),
                          jax_ja.make_rnaseq_data_module(batch_size=16, fake=True, n_samples=90,
                                                         n_genes=30, structured_fake=True))


@pytest.mark.cuda
def test_native_parse_at_the_realistic_width(tmp_path):
    """On the card's host: a 20,480-gene TPM block, parsed and held bit for
    bit to Python's own parse of every value."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the parse runs on the card's host)")
    rng = np.random.default_rng(0)
    values = rng.poisson(100.0, (64, 20480)).astype(np.float32) / 7
    path = tmp_path / "tpm.csv"
    with open(path, "w") as f:
        f.write("," + ",".join(f"c{i}" for i in range(20480)) + "\n")
        for g, row in enumerate(values):
            f.write(f"G{g}," + ",".join(f"{v:.6g}" for v in row) + "\n")
    got = port_native.read_csv_matrix(path)
    with open(path) as f:
        f.readline()
        want = np.array([[float(v) for v in line.rstrip("\n").split(",")[1:]] for line in f],
                        np.float32)
    np.testing.assert_array_equal(got, want)


def test_exp8_trains_from_the_csvs(tmp_path):
    """Experiment 8's ``--rnaseq-dir``: UnifiedVAE on the filtered genes of
    GEO's pair (6 of 8 here), without pandas."""
    import math

    from hyperbolic_vae_tpu_torch.experiments import train_vaes_rnaseq
    from hyperbolic_vae_tpu_torch.train import restore_model

    d = tmp_path / "csv"
    d.mkdir()
    _write_geo_pair(d, n_cells=80)
    out = train_vaes_rnaseq.main(["--device", "cpu", "--rnaseq-dir", str(d), "--epochs", "2",
                                  "--batch-size", "16", "--hidden-dim", "8", "--run-dir",
                                  str(tmp_path / "run"), "--log-level", "WARNING"])
    assert out["epochs"] == 2 and all(math.isfinite(v) for v in out.values())
    _, _, meta = restore_model(str(tmp_path / "run" / "ckpt"), "best", device="cpu")
    assert meta["model"]["input_size"] == [6]
