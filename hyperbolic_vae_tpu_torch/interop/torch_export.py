"""The port's models out to the reference's torch layout.

Port of ``hyperbolic_vae_tpu/interop/torch_export.py``: weights trained
with the port become a state_dict the reference's torch modules load,

    sd = export_torch_state_dict(model)
    np.savez("weights.npz", **sd)          # or torch.save(...)

for the families ``torch_import`` takes (``SUPPORTED_FAMILIES``). The
port keeps the reference's keys and its (C, H, W) feature order, so the
export is the model's own state_dict as f32 numpy arrays, without JAX's
limits (its conv exporter hard-codes HyperbolicImageVAE's 32 flattened
channels and always writes ``log_var``); ``import_torch_state_dict`` of
the export is the identity. RNASeqVAE's ``nb_log_theta`` (the negative
binomial's dispersion) has no reference key and is left out, as JAX
leaves it out (``torch_export.py:104-117``): an ``nb`` model's export
does not import back.

The gyroplane bias, JAX's caveat (``torch_export.py:11-18``): the port's
gyroplane layer has a trained Euclidean bias; geoopt's
Distance2StereographicHyperplanes (the reference flagship's
``decoder.0``) has none. The export keeps it under ``<layer>.bias``: load
it with the reference's own Distance2PoincareHyperplanes (identical
forward with the bias), or drop it with torch's ``strict=False`` (which
changes the outputs by the bias).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from hyperbolic_vae_tpu_torch.interop.torch_import import SUPPORTED_FAMILIES

__all__ = ["export_torch_state_dict"]

_NO_REFERENCE_KEY = ("nb_log_theta",)


def export_torch_state_dict(model) -> Dict[str, np.ndarray]:
    """``model``'s weights as a ``{name: f32 numpy array}`` in the matching
    reference module's layout."""
    name = type(model).__name__
    if name not in SUPPORTED_FAMILIES:
        raise ValueError(f"no torch exporter for model class {name!r}; supported: "
                         f"{sorted(SUPPORTED_FAMILIES)}")
    return {k: v.detach().float().cpu().numpy().copy() for k, v in model.state_dict().items()
            if k not in _NO_REFERENCE_KEY}
