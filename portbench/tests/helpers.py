"""Cells cut to sizes the CPU runs in seconds, for the benchmark's tests."""

import torch

from portbench.harness import spec


def small_cell(workload: str) -> spec.Cell:
    """``workload`` with a few hundred rows and, for the RNA-seq cell, 512
    genes (the widths of the flagship are kept)."""
    cell = spec.load_cell(workload)
    d = cell.traffic["data"]
    if d["kind"] == "blob_images":
        d["n_train"], d["n_val"] = 512, 300
    else:
        d["n_cells"], d["n_genes"] = 600, 512
        cell.config["model"]["kwargs"]["input_size"] = [512]
    return cell


def require_card():
    import pytest

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
