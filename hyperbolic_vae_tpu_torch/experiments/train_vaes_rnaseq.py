"""Experiment 8: the unified configurable VAE on Jerby-Arnon scRNA-seq
(GEO's CSVs, or the fake Poisson data; or MNIST with ``--dataset mnist``).

Port of ``experiments/train_vaes_rnaseq.py``: z-score normalisation,
latent 2, c = 1.0 (K1 at ``--hidden-dim`` gyroplanes on the card),
prior scale 2.0, beta 0.5, ``kl_loss_method="logmap0_analytic"``, hidden
100, batch 64; ``--structured-fake`` draws per-cell-type marker-gene
modules, and ``--n-genes`` sets the fake data's width (2,000 genes by
default, over 1,000 cells; the realistic width is 20,480 genes).
``--rnaseq-dir DIR`` trains on ``DIR/annotations.csv`` and ``DIR/tpm.csv``
as GEO writes them (``make_rnaseq_data_module(data_dir=...)``: the C++
parser, no pandas needed). ``--stream-block-rows M`` trains with
``Trainer.fit_streamed``: the train split stays on the host and streams
through the device in blocks of M rows. ``--use-mesh`` trains data
parallel over the ``torch.distributed`` world; ``--tp``/``--fsdp``
(parameter sharding, ROADMAP Queue 1 item 8b) exit naming the item. The
results go to ``RUN_DIR/results.json``.

    python -m hyperbolic_vae_tpu_torch.experiments.train_vaes_rnaseq --fake --structured-fake
    torchrun --nproc_per_node=N -m hyperbolic_vae_tpu_torch.experiments.train_vaes_rnaseq \
        --rnaseq-dir DIR --use-mesh
"""

from __future__ import annotations

from typing import Optional

import torch

from hyperbolic_vae_tpu_torch.data import make_rnaseq_data_module
from hyperbolic_vae_tpu_torch.experiments.common import (
    base_parser,
    fit_and_test,
    mnist_data,
    setup,
    write_results,
)
from hyperbolic_vae_tpu_torch.models import UnifiedVAE
from hyperbolic_vae_tpu_torch.train import GenerateCallback, LatentScatterCallback


def parse_args(argv: Optional[list] = None):
    p = base_parser(__doc__.split("\n")[0])
    p.add_argument("--dataset", type=str, default="rnaseq", choices=["rnaseq", "mnist"])
    p.add_argument("--structured-fake", action="store_true",
                   help="fake data with per-type marker-gene modules (latent figures)")
    p.add_argument("--rnaseq-dir", type=str, default=None,
                   help="a directory holding GEO's annotations.csv and tpm.csv (GSE115978)")
    p.add_argument("--n-genes", type=int, default=2000, help="fake data: genes a cell")
    p.add_argument("--normalize", type=str, default="z_score")
    p.add_argument("--latent-dim", type=int, default=2)
    p.add_argument("--curvature", type=float, default=1.0)
    p.add_argument("--prior-scale", type=float, default=2.0)
    p.add_argument("--beta", type=float, default=0.5)
    p.add_argument("--hidden-dim", type=int, default=100)
    p.add_argument("--kl-method", type=str, default="logmap0_analytic")
    p.add_argument("--recon", type=str, default="MSE")
    p.add_argument("--last-activation", type=str, default="sigmoid")
    p.add_argument("--tp", type=int, default=1, help="not ported yet (Queue 1 item 8b)")
    p.add_argument("--fsdp", action="store_true", help="not ported yet (Queue 1 item 8b)")
    p.add_argument("--stream-block-rows", type=int, default=0,
                   help="keep the train split on the host and stream it in blocks of this "
                        "many rows (Trainer.fit_streamed)")
    p.set_defaults(batch_size=64)
    args = p.parse_args(argv)
    if args.tp > 1 or args.fsdp:
        raise SystemExit("--tp and --fsdp (parameter sharding over several cards) are not "
                         "ported yet: ROADMAP.md Queue 1 item 8b; --use-mesh trains data "
                         "parallel")
    return args


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    run_dir = setup(args, "vaes_rnaseq")
    if args.dataset == "mnist":
        dm = mnist_data(args)
        callbacks = [GenerateCallback(every_n_epochs=10), LatentScatterCallback(every_n_epochs=10)]
    else:
        dm = make_rnaseq_data_module(batch_size=args.batch_size, data_dir=args.rnaseq_dir,
                                     fake=args.synthetic or args.rnaseq_dir is None,
                                     n_genes=args.n_genes,
                                     rnaseq_normalize_method=args.normalize,
                                     structured_fake=args.structured_fake)
        callbacks = [LatentScatterCallback(every_n_epochs=10)]
    # the input shape comes from the data (the reference's _8:39)
    model = UnifiedVAE(input_size=dm.input_shape, hidden_layer_dim=args.hidden_dim,
                       latent_dim=args.latent_dim,
                       latent_curvature=args.curvature if args.curvature else None,
                       prior_scale=args.prior_scale, posterior_scale="learned",
                       learning_rate=args.lr, beta=args.beta, kl_loss_method=args.kl_method,
                       last_activation=args.last_activation, loss_recon_method=args.recon,
                       generator=torch.Generator().manual_seed(args.seed), device=args.device)
    out = fit_and_test(args, run_dir, model, dm, callbacks, block_rows=args.stream_block_rows)
    return write_results(run_dir, {f"vaes_{args.dataset}": out})[f"vaes_{args.dataset}"]


if __name__ == "__main__":
    main()
