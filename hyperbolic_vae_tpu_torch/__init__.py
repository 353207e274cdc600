"""PyTorch / CUDA port of ``hyperbolic_vae_tpu``.

The JAX package beside it is the reference this port is held against.
The layout mirrors it module for module, so each counterpart sits at the
same relative path. Entry points run on ``cuda`` unless the caller asks
for the CPU (``device="cpu"``); see :func:`device.resolve_device`.

Ported so far, for the flagship GyroplaneVAE: the serving path (the
Poincare ball, the gyroplane-distance op with its hand-written CUDA
kernel ``csrc/gyroplane.cu``, the model, the bucketed ``Inferencer`` and
the HTTP front-end) and the training path (the ELBO, the fused
forward + ELBO op with its CUDA kernel ``csrc/flagship_fused.cu``, the
whole training step's kernel ``csrc/flagship_train.cu``, Riemannian Adam,
the plateau and early-stopping controllers, the data module and
``train.Trainer``) and the evaluation path (the importance-weighted
bound, ``train.evaluation``, the latent probes, statistics on the ball,
the figure callbacks); and every other model family of the JAX package
(``models``: the RNA-seq VAE, the conv image families, the pvae MLP VAE
with its wrapped or Riemannian normal posterior, the unified VAE), with
the experiments' command lines in ``experiments``; seed and lane sweeps,
streamed training and evaluation of host-resident splits
(``Trainer.fit_streamed``), and serving bundles that need no model code
(``serve.ExportedInferencer``, K1 being the registered op
``torch.ops.hvae_torch.gyroplane_distances``); the Jerby-Arnon CSVs read
without pandas (``data.native``'s C++ parser, ``csrc/csv_etl.cpp``), and
data and seed parallelism over ``torch.distributed`` (``parallel``),
with parameter sharding; and the JAX package's public names at the root:

    import hyperbolic_vae_tpu_torch as hvt
    trainer = hvt.Trainer(hvt.GyroplaneVAE())
"""

__version__ = "0.1.0"

from hyperbolic_vae_tpu_torch.device import resolve_device
from hyperbolic_vae_tpu_torch.manifolds import Euclidean, PoincareBall

__all__ = ["Euclidean", "PoincareBall", "__version__", "resolve_device"]

# the names the JAX package's root re-exports lazily, by the module that
# holds each: importing the package imports no model, optimizer or kernel
_LAZY = {
    "Trainer": "train",
    "make_trainer_hyperbolic": "train",
    "GyroplaneVAE": "models",
    "EuclideanVAE": "models",
    "HyperbolicImageVAE": "models",
    "UnifiedVAE": "models",
    "RNASeqVAE": "models",
    "Autoencoder": "models",
    "PvaeMLPVAE": "models",
    "WrappedNormal": "distributions",
    "RiemannianNormal": "distributions",
    "Inferencer": "serve",
}


def __getattr__(name):
    """Lazy top-level re-exports: ``Trainer``, ``make_trainer_hyperbolic``,
    the seven model classes, ``WrappedNormal``, ``RiemannianNormal`` and
    ``Inferencer``, each imported at its first use."""
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
