"""The command: without the CUDA cards a cell asks for it exits 2 and
prints no result."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        return  # a card is present: the run would measure
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "flagship-train-autograd", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "CUDA" in proc.stderr
