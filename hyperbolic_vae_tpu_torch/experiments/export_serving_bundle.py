"""Export a trained model as a serving bundle that needs no model code.

Port of ``experiments/export_serving_bundle.py``:

    python -m hyperbolic_vae_tpu_torch.experiments.export_serving_bundle \\
        --ckpt runs_torch/x/ckpt --out bundle/
    python -m hyperbolic_vae_tpu_torch.experiments.export_serving_bundle \\
        --state-dict flagship.pt --out bundle/ --platforms cuda

restores a Trainer's checkpoint (any family whose checkpoint embeds its
configuration) or a state_dict file (``Inferencer.from_state_dict``),
traces the whole bucketed program set with ``torch.export`` for each
device type in ``--platforms`` (``cuda`` needs the card) and writes the
programs, ``params.pt`` and ``manifest.json``. Serve it with
``python -m hyperbolic_vae_tpu_torch.serve_http --bundle bundle/`` or:

    from hyperbolic_vae_tpu_torch.serve import ExportedInferencer
    inf = ExportedInferencer.load("bundle/")
    mu = inf.embed(x)
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from hyperbolic_vae_tpu_torch.serve import Inferencer


def parse_args(argv: Optional[list] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", type=str, help="a Trainer's checkpoint_dir")
    src.add_argument("--state-dict", type=str,
                     help="a state_dict file (.npz, .pt or the reference's .ckpt) of any family")
    p.add_argument("--model-config", default="{}", metavar="JSON",
                   help="with --state-dict: what the state_dict does not hold, as the model's "
                        "constructor arguments (and \"family\" where the keys fit two)")
    p.add_argument("--name", type=str, default="best", help="checkpoint name (best/last/ema)")
    p.add_argument("--out", type=str, required=True, help="the bundle's directory")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--max-batches-per-dispatch", type=int, default=16)
    p.add_argument("--methods", type=str, nargs="+", default=["encode", "decode", "reconstruct"])
    p.add_argument("--data-shape", type=int, nargs="+", default=None,
                   help="the input's feature shape (default: the model's data_shape)")
    p.add_argument("--platforms", type=str, nargs="+", default=["cpu", "cuda"],
                   help="device types the bundle holds programs for")
    p.add_argument("--io-dtype", default=None, choices=["float16", "bfloat16"],
                   help="a half-precision wire format baked into the programs")
    p.add_argument("--no-sub-batch-buckets", action="store_true",
                   help="skip the power-of-two row-bucket programs for small requests")
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> Path:
    """Returns the bundle's directory."""
    args = parse_args(argv)
    # the live engine runs on the card when the bundle holds programs for it
    device = "cuda" if "cuda" in args.platforms else "cpu"
    kw = dict(batch_size=args.batch_size, max_batches_per_dispatch=args.max_batches_per_dispatch,
              io_dtype=args.io_dtype, sub_batch_buckets=not args.no_sub_batch_buckets,
              device=device)
    if args.ckpt:
        inf = Inferencer.from_checkpoint(args.ckpt, name=args.name, **kw)
    else:
        inf = Inferencer.from_state_dict(args.state_dict, **kw, **json.loads(args.model_config))
    out = inf.export_programs(
        args.out, methods=tuple(args.methods),
        data_shape=tuple(args.data_shape) if args.data_shape else None,
        platforms=tuple(args.platforms))
    # one file a program and device type (a JAX program holds every platform)
    n = len(list(Path(out).glob("*.pt2"))) // len(args.platforms)
    # generate's programs take draws: dispatch buckets only, no row buckets
    n_gen = sum(m == "generate" for m in args.methods)
    n_data = len(args.methods) - n_gen
    print(f"exported {n} programs ({n_data} data methods x "
          f"({len(inf._row_buckets)} row-buckets + {len(inf._buckets)} dispatch-buckets)"
          + (f" + {n_gen} generate x {len(inf._buckets)} dispatch-buckets" if n_gen else "")
          + f") -> {out} for {' '.join(args.platforms)}", flush=True)
    return Path(out)


if __name__ == "__main__":
    main()
