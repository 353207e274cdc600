"""The port against the plain references on the CPU at small sizes: the
check's numbers of a sound run lie within each cell's limits, and the
benchmark's inputs are the seed's alone."""

import time

import numpy as np
import pytest
import torch

from portbench.harness import cell as cm, check, datagen, weights
from portbench.reference import _follow
from portbench.tests.helpers import small_cell

WORKLOADS = ("flagship-train-autograd", "flagship-train-k3", "exp8-train-autograd")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_matches_reference(workload):
    cell = small_cell(workload)
    p = cm.prepare(cell, 2 ** 31 + 12345, "cpu")
    prog = cm.check_fits(p)
    values = cm.numbers(p, prog, cm.reference(p))
    correct, rows = check.judge(values, cell.limits)
    assert correct, rows
    assert all(len(prog[f]["loss"]) == 1 and len(prog[f]["val"]) == 1 for f in "ab")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_run_on_the_cpu(workload):
    out = cm.run_cell(small_cell(workload), 987_654_321_987, 0.5, False, "cpu", time.monotonic())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert not cm.forbidden_modules()


@pytest.mark.parametrize("workload", ("flagship-train-autograd", "exp8-train-autograd"))
def test_data_from_the_seed(workload):
    data = small_cell(workload).traffic["data"]
    a, b, c = (datagen.make(data, s, "cpu") for s in (5, 5, 6))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert [x.shape for x in a] == [x.shape for x in c] and not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.float32 and np.isfinite(a[0]).all()


def test_weights_from_the_seed():
    cell = small_cell("flagship-train-autograd")
    specs = _follow.module(cell.config_name).param_specs(cell.config["model"])
    w1, w2 = (weights.make(specs, 3, 1.0, "cpu") for _ in range(2))
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert float(w1["decoder.0.points"].norm(dim=-1).max()) < 1.0
    assert float(w1["encoder.1.weight"].std()) == pytest.approx(784 ** -0.5, rel=0.05)
