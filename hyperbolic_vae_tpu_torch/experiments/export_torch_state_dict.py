"""Export a port checkpoint to the reference's torch layout: a
self-describing checkpoint directory -> an ``.npz`` state_dict that the
matching reference module loads (``interop/torch_export.py`` has the
gyroplane-bias caveat).

Port of ``experiments/export_torch_state_dict.py``:

    python -m hyperbolic_vae_tpu_torch.experiments.export_torch_state_dict \\
        runs_torch/vae_hyperbolic_mnist_gyroplane/ckpt --out flagship_torch.npz
    # torch side: sd = {k: torch.from_numpy(v) for k, v in np.load(f).items()}
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from hyperbolic_vae_tpu_torch.experiments.common import base_parser, setup
from hyperbolic_vae_tpu_torch.interop import export_torch_state_dict
from hyperbolic_vae_tpu_torch.train.checkpoint import restore_model


def parse_args(argv: Optional[list] = None):
    p = base_parser(__doc__.split("\n")[0])
    p.add_argument("checkpoint", type=str, help="a self-describing checkpoint directory")
    p.add_argument("--name", type=str, default="best", help="best / last / ema / ...")
    p.add_argument("--out", type=str, default=None,
                   help="the .npz to write (default RUN_DIR/<name>.npz)")
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    """Returns the exported ``{name: array}``."""
    args = parse_args(argv)
    run_dir = setup(args, "export_torch_state_dict")
    model, _, _ = restore_model(args.checkpoint, args.name, device=args.device)
    sd = export_torch_state_dict(model)
    out = Path(args.out) if args.out else run_dir / f"{args.name}.npz"
    np.savez(out, **sd)
    print(f"exported {type(model).__name__} -> {out} ({len(sd)} tensors)", flush=True)
    return sd


if __name__ == "__main__":
    main()
