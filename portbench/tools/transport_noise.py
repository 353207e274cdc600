"""The look behind ``change_gap``'s rule for a leaf of points on the ball:
for each seed, the check's fit B (three steps) of the program, of the
plain reference in f32 and of the plain reference in float64, from the
same weights, data and draws, and at the point whose change the program
and the f32 reference disagree on most:

  * the point's change over the three steps as a gap between each pair
    (program / f32, f32 / float64, program / float64), measured as the
    check measures a point;
  * at the coordinate of that point where the two f32 sides' first
    moments differ most: the second moment v and the first moment m
    after the three steps on each side, and the coordinate's change in
    learning rates.

    python3 portbench/tools/transport_noise.py --workload NAME --seeds 8 [--first-seed N]

prints one JSON line a seed. Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _reference_b(prep, dtype):
    """The reference's fit B in ``dtype``: (params, {leaf: (m, v)})."""
    import torch

    from portbench.harness import cell as cell_mod
    from portbench.reference import _follow

    captured = {}
    real = _follow.adam_step

    def spy(params, grads, moments, *args):
        real(params, grads, moments, *args)
        captured["moments"] = moments

    cfg, b = prep.cell.config, prep.batch
    _follow.adam_step = spy
    try:
        out = _follow.follow(
            prep.cell.config_name, cfg, {k: v.to(dtype) for k, v in prep.params0.items()},
            torch.from_numpy(prep.x_train[:cell_mod.CHECK_BATCHES * b]).to(prep.device, dtype),
            torch.from_numpy(prep.x_val).to(prep.device, dtype), b, 1, prep.fit_seed,
            float(cfg["lr"]))
    finally:
        _follow.adam_step = real
    return out["params"], captured["moments"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--first-seed", type=int, default=7_000_000_001)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import cell as cell_mod, check, spec

    cell = spec.load_cell(args.workload, ROOT)
    lr = float(cell.config["lr"])
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        prep = cell_mod.prepare(cell, seed, args.device)
        tr = prep.trainer
        tr.max_epochs = 1
        res = tr.fit(prep.dm_three, params=prep.params0)
        by_param = {n: q for n, q in prep.model.named_parameters()}
        prog = {k: (res.params[k].detach().cpu().double(),
                    tuple(t.detach().cpu().double() for t in tr.optimizer.moments(by_param[k])))
                for k in prep.ref.MANIFOLD}
        prep.model = prep.trainer = prep.dm = prep.dm_one = prep.dm_three = None
        del tr, res, by_param
        gc.collect()
        sides = {"program": prog}
        for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            params, moments = _reference_b(prep, dtype)
            sides[name] = {k: (params[k].detach().cpu().double(),
                               tuple(t.detach().cpu().double() for t in moments[k]))
                           for k in prep.ref.MANIFOLD}
        for leaf in prep.ref.MANIFOLD:
            p0 = prep.params0[leaf].detach().cpu().double()
            d = {s: sides[s][leaf][0] - p0 for s in sides}
            pairs = {"program/f32": ("program", "f32"), "f32/f64": ("f32", "f64"),
                     "program/f64": ("program", "f64")}
            gaps = {k: check.point_gaps(d[a], d[b]) for k, (a, b) in pairs.items()}
            worst = max(range(p0.shape[0]), key=lambda j: gaps["program/f32"][j])
            m = {s: sides[s][leaf][1][0][worst] for s in sides}
            v = {s: sides[s][leaf][1][1][worst] for s in sides}
            coord = int((m["program"] - m["f32"]).abs().argmax())
            row = {"seed": seed, "leaf": leaf, "point": worst,
                   "point_norm": float(p0[worst].norm()),
                   "gap_at_point": {k: g[worst] for k, g in gaps.items()},
                   "median_point_gap": {k: sorted(g)[len(g) // 2] for k, g in gaps.items()},
                   "coord": coord,
                   "v": {s: float(v[s][coord]) for s in sides},
                   "m": {s: float(m[s][coord]) for s in sides},
                   "change_lr": {s: float(d[s][worst, coord]) / lr for s in sides}}
            print(json.dumps(row), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
