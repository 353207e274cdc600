"""Carry weights from the JAX flagship into the port.

``state_dict_from_jax_params`` maps the JAX GyroplaneVAE's parameter
tree (nested dicts of numpy arrays: ``enc_0/kernel``, ..., ``mu``,
``scale``, ``gyroplanes/mp_points``, ``gyroplanes/bias``, ``dec_0``,
``out``) onto the port's state_dict, in the reference layout. Flax
kernels are (in, out) and become (out, in) weights. It is the same
mapping as the JAX package's ``interop/torch_export.py`` applies to the
flagship, so an ``.npz`` written by ``experiments/export_torch_state_dict.py``
loads with ``load_state_dict_file``.

``optimizer_state_from_jax`` carries a JAX ``RiemannianAdamState``
(``count``, ``exp_avg``, ``exp_avg_sq``) into the port's RiemannianAdam
by the same mapping, so both optimizers can start from one state.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.device import DeviceLike
from hyperbolic_vae_tpu_torch.models.vae_gyroplane import GyroplaneVAE

__all__ = [
    "gyroplane_vae_from_state_dict",
    "load_state_dict_file",
    "optimizer_state_from_jax",
    "state_dict_from_jax_params",
]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _linear(p: Mapping, key: str, sd: Dict[str, torch.Tensor]) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{key}.bias"] = _t(p["bias"])


def state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's GyroplaneVAE state_dict for a JAX flagship parameter
    tree (the ``params`` collection, as nested dicts of arrays)."""
    n_enc = sum(1 for k in params if k.startswith("enc_"))
    n_dec = sum(1 for k in params if k.startswith("dec_"))
    sd: Dict[str, torch.Tensor] = {}
    # reference Sequential indices: Flatten at 0, Linear at odd slots
    for i in range(n_enc):
        _linear(params[f"enc_{i}"], f"encoder.{2 * i + 1}", sd)
    _linear(params["mu"], "mu.0", sd)
    _linear(params["scale"], "scale.0", sd)
    sd["decoder.0.points"] = _t(params["gyroplanes"]["mp_points"])
    sd["decoder.0.bias"] = _t(params["gyroplanes"]["bias"])
    for i in range(n_dec):
        _linear(params[f"dec_{i}"], f"decoder.{2 * (i + 1)}", sd)
    _linear(params["out"], f"decoder.{2 * (n_dec + 1)}", sd)
    return sd


def optimizer_state_from_jax(opt_state_inner, model) -> dict:
    """The moments of a JAX ``RiemannianAdamState`` (``count``, and
    ``exp_avg`` / ``exp_avg_sq`` as parameter-shaped trees of arrays) for
    the port optimizer over ``model.parameters()``:
    ``{"count": int, "state": {param: {"exp_avg": t, "exp_avg_sq": t}}}``,
    the form ``RiemannianAdam.load_moments`` takes. Kernels are transposed
    as ``state_dict_from_jax_params`` transposes them."""
    m = state_dict_from_jax_params(opt_state_inner.exp_avg)
    v = state_dict_from_jax_params(opt_state_inner.exp_avg_sq)
    return {
        "count": int(np.asarray(opt_state_inner.count)),
        "state": {p: {"exp_avg": m[name], "exp_avg_sq": v[name]}
                  for name, p in model.named_parameters()},
    }


def load_state_dict_file(path) -> Dict[str, torch.Tensor]:
    """Read a state_dict from an ``.npz`` (``np.savez`` of name -> array)
    or a ``.pt`` file (``torch.save`` of a state_dict)."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as f:
            return {k: _t(f[k]) for k in f.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().contiguous() for k, v in sd.items()}


def gyroplane_vae_from_state_dict(
    sd: Mapping[str, torch.Tensor],
    data_shape: Sequence[int] = (28, 28, 1),
    manifold_curvature: float = 1.0,
    prior_scale: float = 1.0,
    device: DeviceLike = None,
    beta: float = 1.0,
) -> GyroplaneVAE:
    """A GyroplaneVAE holding ``sd``. Widths and the latent size come from
    the tensors' shapes; the curvature, KL weight, prior scale and data
    shape are not stored in a state_dict and are given here."""
    enc = sorted(int(k.split(".")[1]) for k in sd if k.startswith("encoder.") and k.endswith(".weight"))
    hidden = tuple(int(sd[f"encoder.{i}.weight"].shape[0]) for i in enc)
    model = GyroplaneVAE(
        data_shape=data_shape,
        latent_dim=int(sd["mu.0.weight"].shape[0]),
        manifold_curvature=manifold_curvature,
        beta=beta,
        prior_scale=prior_scale,
        hidden_dims=hidden,
        device=device,
    )
    model.load_state_dict(dict(sd))
    return model
