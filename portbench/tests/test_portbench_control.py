"""The control of ``correct``: the plain reference put in the program's
place and computed with TF32 products, the nearest precision below the
configurations' float32 with TF32 off, comes out not correct on every
seed; the reference itself in f32 comes out correct. On the CPU at a
small size the TF32 products are emulated (operands rounded to TF32);
on a card, at the cell's own size, they are torch's TF32 mode."""

import pytest

from portbench.harness import cell as cm, check, spec
from portbench.tests.helpers import require_card, small_cell

WORKLOADS = ("flagship-train-autograd", "flagship-train-k3", "exp8-train-autograd")
SEEDS = (1_000_003, 2_000_003, 3_000_003)


def _judge(p, limits):
    ref = cm.reference(p)
    control = check.judge(cm.numbers(p, cm.reference(p, "tf32"), ref), limits)
    sound = check.judge(cm.numbers(p, cm.reference(p), ref), limits)
    return control, sound


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_the_cpu(workload, seed):
    cell = small_cell(workload)
    (control_ok, rows), (sound_ok, _) = _judge(cm.prepare(cell, seed, "cpu"), cell.limits)
    assert sound_ok and not control_ok, rows


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_the_card(workload):
    require_card()
    cell = spec.load_cell(workload)
    for seed in SEEDS:
        (control_ok, rows), (sound_ok, _) = _judge(cm.prepare(cell, seed, "cuda:0"), cell.limits)
        assert sound_ok and not control_ok, (seed, rows)
