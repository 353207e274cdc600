"""PyTorch / CUDA port of ``hyperbolic_vae_tpu``.

The JAX package beside it is the reference this port is held against.
The layout mirrors it module for module, so each counterpart sits at the
same relative path. Entry points run on ``cuda`` unless the caller asks
for the CPU (``device="cpu"``); see :func:`device.resolve_device`.

This slice ports the flagship GyroplaneVAE serving path: the Poincare
ball, the gyroplane-distance op with its hand-written CUDA kernel
(``csrc/gyroplane.cu``), the model, the bucketed ``Inferencer`` and the
HTTP front-end.
"""

from hyperbolic_vae_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
