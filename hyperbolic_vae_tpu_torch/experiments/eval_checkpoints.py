"""Evaluate saved checkpoints on a test split, any model family.

Port of ``experiments/eval_checkpoints.py`` (the runnable version of the
reference's ``_5_eval_on_mnist_test.py`` stub): every port checkpoint
embeds its model's class and constructor arguments, so ``restore_model``
rebuilds any family and one command evaluates them all, on the dataset
the model's input names. ``--iwae K`` adds the K-sample importance
weighted bound on log p(x) (``test/iwae_K``), ``--probe K`` the latent
probes. The results go to ``RUN_DIR/eval_results.json``.

    python -m hyperbolic_vae_tpu_torch.experiments.eval_checkpoints --synthetic \\
        --glob 'runs_torch/*/ckpt' --iwae 5000 --probe 10
"""

from __future__ import annotations

import glob as globlib
import json
from pathlib import Path
from typing import Optional

from hyperbolic_vae_tpu_torch.data import cifar10, make_rnaseq_data_module, pad_to_32
from hyperbolic_vae_tpu_torch.experiments.common import base_parser, mnist_data, setup
from hyperbolic_vae_tpu_torch.train import Trainer
from hyperbolic_vae_tpu_torch.train.checkpoint import restore_model


def data_module_for(model, args):
    """The dataset the restored model's input names: a flat vector other
    than 784 RNA-seq (fake), (32, 32, 3) CIFAR-10, (32, 32, 1) MNIST padded
    to 32, else MNIST."""
    shape = tuple(getattr(model, "data_shape", None) or getattr(model, "input_size", None)
                  or (model.in_features,))
    if len(shape) == 1 and shape[0] != 784:
        return make_rnaseq_data_module(batch_size=args.batch_size, fake=True, n_genes=shape[0])
    if shape == (32, 32, 3):
        return cifar10.make_data_module(batch_size=args.batch_size, data_dir=args.data_dir,
                                        synthetic=args.synthetic, n_train=args.n_train,
                                        n_test=args.n_test)
    if shape == (32, 32, 1):
        return pad_to_32(mnist_data(args))
    return mnist_data(args)


def evaluate_checkpoint(args, ckpt_dir: str) -> dict:
    model, params, meta = restore_model(ckpt_dir, args.which, device=args.device)
    dm = data_module_for(model, args)
    trainer = Trainer(model, max_epochs=1, seed=args.seed, device=args.device)
    metrics = trainer.evaluate(dm, params, "test")
    if args.iwae:
        if hasattr(model, "iwae"):
            metrics[f"test/iwae_{args.iwae}"] = trainer.evaluate_iwae(dm, params, k=args.iwae)
        else:  # the Autoencoder has no bound
            print(f"iwae unavailable for {ckpt_dir}: {type(model).__name__} has no likelihood")
    if args.probe:
        metrics.update(trainer.evaluate_probe(dm, params, k=args.probe))
    return {"model": meta["model"]["__model_class__"], "epoch": meta.get("epoch"), **metrics}


def parse_args(argv: Optional[list] = None):
    p = base_parser(__doc__.split("\n")[0])
    p.add_argument("--glob", type=str, default="runs_torch/*/ckpt", help="checkpoint dir glob")
    p.add_argument("--which", type=str, default="best", choices=["best", "last", "ema"])
    p.add_argument("--iwae", type=int, default=0, metavar="K",
                   help="also the K-importance-weighted log p(x) bound (test/iwae_K)")
    p.add_argument("--probe", type=int, default=0, metavar="K",
                   help="also the latent probes (kNN and nearest Frechet mean)")
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    run_dir = setup(args, "eval_checkpoints")
    results = {}
    for ckpt_dir in sorted(globlib.glob(args.glob)):
        if not (Path(ckpt_dir) / f"{args.which}.json").exists():
            print(f"skip {ckpt_dir}: no {args.which} checkpoint")
            continue
        results[ckpt_dir] = evaluate_checkpoint(args, ckpt_dir)
        print(ckpt_dir, results[ckpt_dir], flush=True)
    (run_dir / "eval_results.json").write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2), flush=True)
    return results


if __name__ == "__main__":
    main()
