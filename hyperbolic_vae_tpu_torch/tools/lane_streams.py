"""A stream a lane against one stream for every lane, in one sweep.

``fit_ensemble`` replays each lane's CUDA graphs on a stream of its own,
so that the card may run one lane's kernels in the gaps of another's.
This times the flagship's 8-seed sweep (the parity protocol's seeds,
synthetic MNIST: 54,000 train and 6,000 val rows, batch 256) both ways, in
turns (streams, one, one, streams), on the default path (K1 in every
decoder forward, ~1,000 kernels a step) and on the K3 path (one kernel a
step), and fails unless every run gives the same bits (histories,
parameters, best parameters). Aggregate train samples/s come from each
sweep's second chunk (``epochs_per_dispatch=1``: the first captures).

    python -m hyperbolic_vae_tpu_torch.tools.lane_streams [--epochs 2] [--seeds 42 7 ...]

On a CUDA card only. Prints the card's name and power limit, one line a
run, and a JSON line of the samples/s.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

SEEDS = [42, 7, 123, 0, 1, 2, 3, 11]  # the parity protocol's (PARITY.json)


def _sweep(dm, path: str, seeds, epochs: int, streams: bool):
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
    from hyperbolic_vae_tpu_torch.ops import make_fused_loss_fn, make_fused_train_step
    from hyperbolic_vae_tpu_torch.train import Trainer

    m = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device="cuda")
    kw = {}
    if path == "k3":
        kw = dict(loss_fn=make_fused_loss_fn(m), train_step_fn=make_fused_train_step(m))
    t = Trainer(m, max_epochs=epochs, epochs_per_dispatch=1, early_stopping_patience=None,
                device="cuda", **kw)
    t._lane_streams = streams
    return t.fit_ensemble(dm, seeds)


def _same(a, b) -> bool:
    return all(
        x.history == y.history
        and all(torch.equal(x.params[k], y.params[k]) for k in x.params)
        and all(torch.equal(x.best_params[k], y.best_params[k]) for k in x.best_params)
        for x, y in zip(a, b))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--seeds", type=int, nargs="+", default=SEEDS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("lane_streams: needs a CUDA card", file=sys.stderr)
        return 1
    from hyperbolic_vae_tpu_torch.data import make_data_module
    from hyperbolic_vae_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    _build.load_libraries(["gyroplane", "flagship_fused", "flagship_train"])
    dm = make_data_module(batch_size=256, synthetic=True)
    out = {}
    for path in ("default", "k3"):
        first, sps = None, {"streams": [], "one": []}
        for streams in (True, False, False, True):
            res = _sweep(dm, path, args.seeds, args.epochs, streams)
            key = "streams" if streams else "one"
            sps[key].append(res[0].samples_per_sec)
            print(f"{path}: {len(args.seeds)} lanes, {key}: {res[0].samples_per_sec:.1f} aggregate "
                  f"train samples/s", flush=True)
            if first is None:
                first = res
            elif not _same(first, res):
                print(f"{path}: a run differs from the first, bit for bit", file=sys.stderr)
                return 1
        out[path] = sps
    print(json.dumps({"lanes": len(args.seeds), "epochs": args.epochs, "samples_per_sec": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
