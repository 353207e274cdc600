"""Carry weights from the JAX package's models into the port.

``state_dict_from_jax_params`` maps a JAX parameter tree (nested dicts of
numpy arrays) onto the port's state_dict, in the reference layout, for
two families, told apart by the tree's keys or by ``model=``:

  * GyroplaneVAE (``enc_0/kernel``, ..., ``mu``, ``scale``,
    ``gyroplanes/mp_points``, ``gyroplanes/bias``, ``dec_0``, ``out``):
    ``encoder.1``, ``encoder.3``, ..., ``decoder.0.points/bias``,
    ``decoder.2``, ``decoder.4``, ...;
  * RNASeqVAE (``enc``, ``mu``, ``scale``, ``gyroplanes``, ``dec_out``,
    ``nb_log_theta``): ``encoder.0``, ``mu.0``, ``scale.0``,
    ``decoder.0.points/bias``, ``decoder.2`` and ``nb_log_theta``.

Flax kernels are (in, out) and become (out, in) weights. It is the
mapping the JAX package's ``interop/torch_export.py`` applies (for
RNASeqVAE its ``_export_unified``, which drops ``nb_log_theta``; this
keeps it), so an ``.npz`` written by
``experiments/export_torch_state_dict.py`` loads with
``load_state_dict_file``. A bf16 leaf (a numpy array whose dtype is named
``bfloat16``) becomes a ``torch.bfloat16`` tensor exactly, through its
16-bit pattern; every other leaf becomes f32.

``optimizer_state_from_jax`` carries a JAX ``RiemannianAdamState``
(``count``, ``exp_avg``, ``exp_avg_sq``) into the port's RiemannianAdam
by the same mapping, so both optimizers can start from one state.
The port never imports ``ml_dtypes``: a bf16 leaf is read by its bits.
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
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # the same bits: bf16 is the upper half of an f32
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.tensor(np.asarray(a, np.float32))


def _linear(p: Mapping, key: str, sd: Dict[str, torch.Tensor]) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{key}.bias"] = _t(p["bias"])


def _family(params: Mapping, model) -> str:
    """"gyroplane" or "rnaseq": from ``model`` (a name, or a port model)
    when given, else from the tree's keys."""
    if model is not None:
        name = model if isinstance(model, str) else type(model).__name__
        kind = {"GyroplaneVAE": "gyroplane", "RNASeqVAE": "rnaseq"}.get(name, name)
        if kind not in ("gyroplane", "rnaseq"):
            raise ValueError(f"no parameter mapping for model {name!r}")
        return kind
    return "rnaseq" if "enc" in params and "dec_out" in params else "gyroplane"


def state_dict_from_jax_params(params: Mapping, model=None) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX parameter tree (the ``params``
    collection, as nested dicts of arrays) of a GyroplaneVAE or an
    RNASeqVAE; ``model`` ("gyroplane", "rnaseq", or a port model) names
    the family, which otherwise comes from the tree's keys."""
    sd: Dict[str, torch.Tensor] = {}
    if _family(params, model) == "rnaseq":
        _linear(params["enc"], "encoder.0", sd)
        _linear(params["mu"], "mu.0", sd)
        _linear(params["scale"], "scale.0", sd)
        sd["decoder.0.points"] = _t(params["gyroplanes"]["mp_points"])
        sd["decoder.0.bias"] = _t(params["gyroplanes"]["bias"])
        _linear(params["dec_out"], "decoder.2", sd)
        if "nb_log_theta" in params:
            sd["nb_log_theta"] = _t(params["nb_log_theta"])
        return sd
    n_enc = sum(1 for k in params if k.startswith("enc_"))
    n_dec = sum(1 for k in params if k.startswith("dec_"))
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
    as ``state_dict_from_jax_params`` transposes them, and bf16 moments
    stay bf16 exactly."""
    m = state_dict_from_jax_params(opt_state_inner.exp_avg, model)
    v = state_dict_from_jax_params(opt_state_inner.exp_avg_sq, model)
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
