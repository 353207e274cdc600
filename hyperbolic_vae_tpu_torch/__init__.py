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
data and seed parallelism over ``torch.distributed`` (``parallel``).
"""

from hyperbolic_vae_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
