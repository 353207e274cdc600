"""The readings that the limits of ``correct`` are set from, for one cell,
at the cell's own size on a card:

  * sound: the program's check fits against the plain reference, on
    each seed;
  * control: the reference computed with TF32 products put in the
    program's place (the nearest precision below the configuration's
    float32 with TF32 off);
  * faults planted in the reference put in the program's place: half of
    each batch left out (``half_batch``), a step that leaves the state
    unchanged (``frozen``), every step of an epoch fed its first batch
    (``first_batch``), each reported loss altered by 1 % (``altered``).

    python3 portbench/tools/calibrate.py --workload NAME --seeds 16 [--first-seed N]

prints one JSON line a seed and a summary: for each number the largest
sound reading and the smallest reading of the control and of each fault.
Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=16)
    p.add_argument("--first-seed", type=int, default=7_000_000_001)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import cell as cell_mod, spec

    cell = spec.load_cell(args.workload, ROOT)
    variants = ("control", "half_batch", "frozen", "first_batch", "altered")
    table = {v: [] for v in ("sound",) + variants}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        prep = cell_mod.prepare(cell, seed, args.device)
        prog = cell_mod.check_fits(prep)
        prep.model = prep.trainer = prep.dm = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        ref = cell_mod.reference(prep)
        row = {"seed": seed, "sound": cell_mod.numbers(prep, prog, ref)}
        row["control"] = cell_mod.numbers(prep, cell_mod.reference(prep, "tf32"), ref)
        for fault in variants[1:]:
            row[fault] = cell_mod.numbers(prep, cell_mod.reference(prep, fault=fault), ref)
        for v in table:
            table[v].append(row[v])
        print(json.dumps(row), flush=True)
    summary = {n: {"sound_max": max(r[n] for r in table["sound"]),
                   **{f"{v}_min": min(r[n] for r in table[v]) for v in variants}}
               for n in table["sound"][0]}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
