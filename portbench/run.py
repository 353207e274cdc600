"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (from the Trainer's
torch.profiler trace of the window's second chunk). The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
then ``checks``: each number that decides ``correct`` with its limit);
the last lines of standard error repeat the checks. Exits 2 without the
CUDA cards the cell asks for, 3 if JAX or the JAX package was loaded,
and prints no result in either case.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The process's start on ``time.monotonic``'s clock (Linux: from
    /proc; elsewhere this module's first line)."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench.harness import cell as cell_mod, spec

    cell = spec.load_cell(args.workload, ROOT)
    chips = next(w["chips"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
                 if w["name"] == args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = cell_mod.run_cell(cell, args.seed % 2 ** 63, args.seconds, bool(args.trace), "cuda:0",
                            T_START)
    bad = cell_mod.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    print(json.dumps(out), flush=True)
    for name, value, limit in checks:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
