"""What the port's experiment CLIs share: the common flags, the run
directory and the Trainer options the flags drive.

Port of ``experiments/common.py``. Every CLI takes ``--synthetic`` (or
``--fake``: seeded synthetic or fake data; nothing is downloaded) and
``--device`` (``cuda`` by default, ``cpu`` for a small run on the CPU),
and writes under ``runs_torch/<name>`` unless ``--run-dir`` says
otherwise. A training CLI's results (test metrics, epochs, best val) go
to ``RUN_DIR/results.json`` (``write_results``), which
``experiments/summarize_runs.py`` tabulates.

``--use-mesh`` trains data parallel over the ``torch.distributed`` world
(``Trainer(use_mesh=True)``): under ``torchrun --nproc_per_node=N`` one
process a card, without it a world of size 1. ``setup`` joins the world
first, so the model is built on this rank's card; rank 0 alone writes
the results, logs and checkpoints.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch.distributed as dist

from hyperbolic_vae_tpu_torch.data import make_data_module
from hyperbolic_vae_tpu_torch.utils.logging import configure_handler_for_script


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--data-dir", type=str, default="data", help="MNIST IDX files (without --synthetic)")
    p.add_argument("--synthetic", "--fake", dest="synthetic", action="store_true",
                   help="seeded synthetic (or fake RNA-seq) data (no downloads)")
    p.add_argument("--n-train", type=int, default=60000, help="synthetic train size")
    p.add_argument("--n-test", type=int, default=10000, help="synthetic test size")
    p.add_argument("--run-dir", type=str, default=None)
    p.add_argument("--no-early-stopping", action="store_true")
    p.add_argument("--epochs-per-dispatch", type=int, default=1,
                   help="K epochs a dispatch (histories are the same for every K)")
    p.add_argument("--moment-dtype", type=str, default=None, choices=[None, "bfloat16", "float32"],
                   help="storage type of Adam's moments (the math stays f32)")
    p.add_argument("--lr-schedule", type=str, default=None, choices=[None, "cosine", "exponential"],
                   help="epoch-indexed lr in place of the plateau controller: cosine to lr/100 "
                        "at --epochs, or exponential (gamma 0.97 an epoch)")
    p.add_argument("--warmup-epochs", type=int, default=0, help="linear lr warmup for --lr-schedule")
    p.add_argument("--beta-warmup-epochs", type=int, default=0,
                   help="KL annealing: beta from 0 to the model's over this many epochs")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="A > 1: each step sums the gradients of A microbatches of batch/A rows")
    p.add_argument("--grad-clip-norm", type=float, default=None,
                   help="clip the gradients to this global L2 norm")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="track an EMA of the parameters (the 'ema' checkpoint)")
    p.add_argument("--use-mesh", action="store_true",
                   help="data parallel over the torch.distributed world (torchrun; world size 1 "
                        "without it)")
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    p.add_argument("--log-level", type=str, default="INFO")
    return p


def setup(args, name: str) -> Path:
    """Logging, the process group when a mesh is asked for (``--use-mesh``,
    ``--seed-mesh``), and the run directory (created)."""
    configure_handler_for_script(args.log_level)
    if getattr(args, "use_mesh", False) or getattr(args, "seed_mesh", 0):
        from hyperbolic_vae_tpu_torch.parallel import init_distributed

        init_distributed(args.device)
    run_dir = Path(args.run_dir) if args.run_dir else Path("runs_torch") / name
    run_dir.mkdir(parents=True, exist_ok=True)
    return run_dir


def mnist_data(args):
    return make_data_module(batch_size=args.batch_size, data_dir=args.data_dir,
                            synthetic=args.synthetic, n_train=args.n_train, n_test=args.n_test)


def trainer_extra(args, model=None) -> dict:
    """Trainer keyword arguments from the common flags. ``model``: the one
    whose beta ``--beta-warmup-epochs`` ramps to."""
    from hyperbolic_vae_tpu_torch.optim import (
        beta_warmup_schedule,
        cosine_schedule,
        exponential_schedule,
    )

    extra = dict(epochs_per_dispatch=args.epochs_per_dispatch, moment_dtype=args.moment_dtype,
                 ema_decay=args.ema_decay, grad_accum_steps=args.grad_accum,
                 grad_clip_norm=args.grad_clip_norm, use_mesh=args.use_mesh, device=args.device)
    if args.beta_warmup_epochs:
        if model is None or not hasattr(model, "beta"):
            raise SystemExit("--beta-warmup-epochs needs a model with a beta attribute")
        extra["beta_schedule"] = beta_warmup_schedule(float(model.beta),
                                                      warmup_epochs=args.beta_warmup_epochs)
    if args.lr_schedule == "cosine":
        extra["lr_schedule"] = cosine_schedule(args.lr, args.epochs, warmup_epochs=args.warmup_epochs,
                                               min_lr=args.lr / 100.0)
    elif args.lr_schedule == "exponential":
        extra["lr_schedule"] = exponential_schedule(args.lr, gamma=0.97,
                                                    warmup_epochs=args.warmup_epochs)
    return extra


def write_results(run_dir: Path, results: dict) -> dict:
    """``results`` ({tag: {metric: number} or None}) as
    ``RUN_DIR/results.json`` and on stdout; returns it."""
    out = {k: ({m: float(v) for m, v in r.items()} if r else None) for k, r in results.items()}
    if is_writer():
        (Path(run_dir) / "results.json").write_text(json.dumps(out, indent=2))
        print(json.dumps(out, indent=2), flush=True)
    return out


def is_writer() -> bool:
    """True on the process that writes a run's files: rank 0 of the
    world, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def seed_mesh_of(args):
    """``--seed-mesh N``: the seed mesh over N ranks (None without it)."""
    if not getattr(args, "seed_mesh", 0):
        return None
    from hyperbolic_vae_tpu_torch.parallel import make_seed_mesh

    try:
        return make_seed_mesh(args.seed_mesh, device=args.device)
    except ValueError as e:
        raise SystemExit(f"--seed-mesh {args.seed_mesh}: {e}") from e


def fit_and_test(args, run_dir: Path, model, dm, callbacks=(), block_rows: int = 0,
                 **trainer_kw) -> dict:
    """One fit with checkpoints (best, last) in ``RUN_DIR/ckpt`` (with
    ``block_rows``, ``fit_streamed`` in blocks of that many rows), then the
    test split's metrics of the best checkpoint as restored from there:
    ``{test metrics..., "epochs", "best_val"}``."""
    from hyperbolic_vae_tpu_torch.train import Trainer
    from hyperbolic_vae_tpu_torch.train.checkpoint import CheckpointManager

    ckpt = Path(run_dir) / "ckpt"
    trainer = Trainer(model, lr=args.lr, max_epochs=args.epochs, seed=args.seed,
                      early_stopping_patience=None if args.no_early_stopping else 10,
                      log_dir=str(run_dir), checkpoint_dir=str(ckpt), callbacks=list(callbacks),
                      **trainer_extra(args, model), **trainer_kw)
    result = trainer.fit_streamed(dm, block_rows=block_rows) if block_rows else trainer.fit(dm)
    print(f"epochs={result.epochs_run} best {trainer.monitor}={result.best_metric:.4f} "
          f"samples/sec={result.samples_per_sec:.0f}", flush=True)
    best = CheckpointManager(str(ckpt)).restore("best", device=trainer.device)
    test = trainer.evaluate(dm, best, "test")
    print("test:", test, flush=True)
    return dict(test, epochs=result.epochs_run, best_val=result.best_metric)
