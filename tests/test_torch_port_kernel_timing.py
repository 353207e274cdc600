"""The port's kernel timing tools, on the CPU: what they insert into copies
of the kernel sources (the timing itself needs a card and nvcc), and that
they refuse to run without a card."""

from pathlib import Path

import pytest
import torch

from hyperbolic_vae_tpu_torch.ops import _build
from hyperbolic_vae_tpu_torch.tools import k1_compare, k3_path, kernel_timing

BARRIERS = kernel_timing.SYNCS


def _body(path: Path, fname: str) -> str:
    text = path.read_text()
    b0, b1 = kernel_timing._body(text, fname)
    return text[b0 + 1:b1]


@pytest.mark.parametrize("mode", ["phases", "timeline"])
def test_instrument_stamps_copies_and_leaves_the_sources(tmp_path, mode):
    before = {f.name: f.read_bytes() for f in _build.CSRC.iterdir()}
    kernel_timing.instrument(_build.CSRC, tmp_path, mode)
    assert {f.name: f.read_bytes() for f in _build.CSRC.iterdir()} == before
    common = tmp_path / "flagship_common.cuh"
    assert common.read_text().count("__device__ unsigned long long kt_tl") == 1
    for name in ("flagship_fused.cu", "flagship_train.cu"):
        assert "extern \"C\" int kt_read(" in (tmp_path / name).read_text()
    if mode == "phases":
        # one stamp after every barrier of the stamped bodies, one at entry, one at the end
        fwd = _body(_build.CSRC / "flagship_common.cuh", "cluster_forward")
        rows = _body(_build.CSRC / "flagship_train.cu", "train_rows_kernel")
        n_bar = sum(s.count(b) for s in (fwd, rows) for b in BARRIERS)
        stamped = (_body(common, "cluster_forward") + _body(tmp_path / "flagship_train.cu",
                                                            "train_rows_kernel"))
        assert stamped.count("KT_STAMP();") == n_bar + 2
    else:
        grad = _body(tmp_path / "flagship_train.cu", "train_grad_kernel")
        assert grad.count("KT_TL(1, 0)") == 1 and grad.count("KT_TL(1, 1)") == 1
        # every exit of the block records its end
        assert grad.count("KT_TL(1, 2)") == grad.count("return;") + 1


def test_tools_refuse_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_timing.main(["phases"]) == 1
    assert k3_path.main(["--tree", str(_build.CSRC.parents[1])]) == 1
    assert k1_compare.main(["--other", str(_build.CSRC)]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--planes", "512", "--c", "1.4"],
                                  ["--planes", "100", "256", "512", "--c", "1.0", "1.4"]])
def test_k1_compare_takes_planes_and_curvatures_and_refuses_without_a_card(
        monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k1_compare.main(["--other", str(_build.CSRC), *argv]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        k1_compare.main(["--other", str(_build.CSRC), "--planes", "wide"])
