"""Import a reference (torch / Lightning / geoopt) checkpoint into the
port: its state_dict -> a port model -> a self-describing checkpoint
directory that ``restore_model``, ``Inferencer.from_checkpoint``,
``serve_http --checkpoint``, ``eval_checkpoints`` and fine-tuning
(``Trainer.fit(dm, params=...)``) read.

Port of ``experiments/import_torch_checkpoint.py``:

    python -m hyperbolic_vae_tpu_torch.experiments.import_torch_checkpoint epoch=99.ckpt \\
        --out runs_torch/imported
    python -m hyperbolic_vae_tpu_torch.experiments.import_torch_checkpoint weights.npz \\
        --model rnaseq --out runs_torch/imported_rnaseq

The family comes from the state_dict's keys (``--model`` names it where
they fit two), the widths from its shapes, the rest from the flags, else
from Lightning's ``hyper_parameters`` (``data_shape`` is stored (C, H,
W)): ``interop.model_from_file``. ``interop/torch_import.py`` has the
supported reference classes and the checks.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from hyperbolic_vae_tpu_torch.experiments.common import base_parser, setup
from hyperbolic_vae_tpu_torch.interop import model_from_file

FAMILIES = ("autoencoder", "euclidean", "gyroplane", "hyperbolic_image", "rnaseq", "unified")


def parse_args(argv: Optional[list] = None):
    p = base_parser(__doc__.split("\n")[0])
    p.add_argument("checkpoint", type=str, help=".ckpt / .pt / .npz source")
    p.add_argument("--out", dest="run_dir", help="the checkpoint directory to write "
                   "(default runs_torch/imported)")
    p.add_argument("--model", type=str, default=None, choices=FAMILIES,
                   help="the target family (default: told by the state_dict's layout; needed "
                        "where it fits two, e.g. 'rnaseq' or 'unified' for a vae_one_b layout "
                        "on a flat input)")
    p.add_argument("--name", type=str, default="best",
                   help="the checkpoint's name in --out (best: what eval and serving read)")
    p.add_argument("--data-shape", type=int, nargs=3, default=None, metavar=("H", "W", "C"))
    p.add_argument("--curvature", type=float, default=None)
    p.add_argument("--beta", type=float, default=None)
    p.add_argument("--decoder-first", type=str, default=None, choices=["geodesic", "mobius"])
    p.add_argument("--loss-recon", type=str, default=None, choices=["mse", "bernoulli"])
    p.add_argument("--allow-unsafe-pickle", action="store_true",
                   help="full-pickle torch.load for a ckpt the weights-only unpickler refuses "
                        "(EXECUTES code embedded in the file: only for your own checkpoints)")
    return p.parse_args(argv)


def main(argv: Optional[list] = None):
    """Returns the imported model; its checkpoint is ``--out``/``--name``."""
    from hyperbolic_vae_tpu_torch.train.checkpoint import CheckpointManager, model_hparams

    args = parse_args(argv)
    out = setup(args, "imported")
    src = Path(args.checkpoint)
    flags = {"manifold_curvature": args.curvature, "beta": args.beta,
             "decoder_first_layer_module": args.decoder_first, "loss_recon": args.loss_recon}
    model = model_from_file(src, device=args.device, data_shape=args.data_shape, family=args.model,
                            allow_unsafe_pickle=args.allow_unsafe_pickle,
                            hparams={k: v for k, v in flags.items() if v is not None})
    mgr = CheckpointManager(str(out))
    mgr.model_config = model_hparams(model)
    mgr.save_named(args.name, model.state_dict(), {"imported_from": str(src), "epoch": -1})
    n = sum(p.numel() for p in model.parameters())
    print(f"imported {type(model).__name__} ({n:,} params) from {src}", flush=True)
    print(f"-> {out}/{args.name}  (restore_model('{out}', '{args.name}'))", flush=True)
    return model


if __name__ == "__main__":
    main()
