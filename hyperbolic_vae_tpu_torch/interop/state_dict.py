"""Carry weights from the JAX package's models into the port.

``state_dict_from_jax_params`` maps a JAX parameter tree (nested dicts of
numpy arrays) onto the port's state_dict, in the reference layout, for
seven families, told apart by the tree's keys or by ``model=``:

  * GyroplaneVAE (``enc_0/kernel``, ..., ``mu``, ``scale``,
    ``gyroplanes/mp_points``, ``gyroplanes/bias``, ``dec_0``, ``out``):
    ``encoder.1``, ``encoder.3``, ..., ``decoder.0.points/bias``,
    ``decoder.2``, ``decoder.4``, ...;
  * RNASeqVAE (``enc``, ``mu``, ``scale``, ``gyroplanes``, ``dec_out``,
    ``nb_log_theta``): ``encoder.0``, ``mu.0``, ``scale.0``,
    ``decoder.0.points/bias``, ``decoder.2`` and ``nb_log_theta``;
  * the conv image families: HyperbolicImageVAE (``conv1``, ...,
    ``mu``/``mu_mobius``, ``log_var``, ``dec_first``, ``deconv1``, ...),
    EuclideanVAE (``encoder/Conv_i``, ``mu``, ``log_var``, ``decoder``)
    and Autoencoder (``encoder``, ``latent``, ``decoder``);
  * UnifiedVAE (``enc``, ``mu``, ``scale`` when learned, ``gyroplanes``
    or ``dec_first``, ``dec_out``): ``encoder.1`` (a multi-dimensional
    ``input_size``, read from ``model``; a bare name means JAX's default
    (28, 28, 1)) or ``encoder.0``, ``mu.0``, ``scale.0``,
    ``decoder.0.points/bias`` or ``decoder.0.weight/bias``, ``decoder.2``;
  * PvaeMLPVAE (``enc``, ``mu``, ``scale``, ``dec_geodesic`` or
    ``dec_first``, ``dec_out``), in the port's own layout (JAX has no
    exporter for it): ``encoder.1``, ``mu.0``, ``scale.0``,
    ``decoder.0._weight/_bias`` (the GeodesicLayer's) or
    ``decoder.0.weight/bias``, ``decoder.2``.

Where the keys cannot tell the family, ``model=`` names it, and a tree
without it raises naming the candidates: ``enc``/``dec_first``/
``dec_out`` with ``scale`` is a Euclidean UnifiedVAE or a linear-decoder
PvaeMLPVAE. A tree with ``gyroplanes``, ``scale`` and ``dec_out`` keeps
its reading as an RNASeqVAE, whose layout is a UnifiedVAE's on a flat
input too (a UnifiedVAE on images passes ``model=``); without ``scale``
(a fixed posterior scale) it is a UnifiedVAE's.

Flax kernels are (in, out) and become (out, in) weights; conv kernels
(kh, kw, in, out) become (out, in, kh, kw); transposed-conv kernels are
flipped 180 degrees and become (in, out, kh, kw). The conv families'
layers that face the flattened conv features take the permutation from
JAX's (H, W, C) flattening to the reference's (C, H, W) (on their input
axis, or on their output axis for the decoder's first layer, gyroplane
points and bias included), with 2 x the family's base width as C and
H/8, W/8 from ``model``'s ``data_shape`` (square when ``model`` is only a
name); Riemannian layers keep the reference's ``_weight`` / ``_bias``. It
is the mapping the JAX package's ``interop/torch_export.py`` applies (for
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

import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.device import DeviceLike
from hyperbolic_vae_tpu_torch.interop.torch_import import _tensor as _t
from hyperbolic_vae_tpu_torch.interop.torch_import import (
    config_from_lightning,
    import_torch_state_dict,
    load_lightning_hparams,
    load_torch_state_dict,
)
from hyperbolic_vae_tpu_torch.models.vae_gyroplane import GyroplaneVAE

__all__ = [
    "family_of_state_dict",
    "gyroplane_vae_from_state_dict",
    "load_state_dict_file",
    "model_from_file",
    "model_from_state_dict",
    "optimizer_state_from_jax",
    "state_dict_from_jax_params",
]


_FAMILIES = {"GyroplaneVAE": "gyroplane", "RNASeqVAE": "rnaseq",
             "HyperbolicImageVAE": "hyperbolic_image", "EuclideanVAE": "euclidean",
             "Autoencoder": "autoencoder", "UnifiedVAE": "unified", "VAE": "unified",
             "PvaeMLPVAE": "pvae"}


def _kind(model) -> str:
    """The short name of ``model``: a class name, a short name or a port model."""
    name = model if isinstance(model, str) else type(model).__name__
    kind = _FAMILIES.get(name, name)
    if kind not in _FAMILIES.values():
        raise ValueError(f"no parameter mapping for model {name!r}")
    return kind


def _family(params: Mapping, model=None, family=None) -> str:
    """The family's short name: from ``family`` or ``model`` (a class
    name, a short name, or a port model) when given, else from the tree's
    keys; raises naming the candidates where the keys fit two families."""
    if family is not None or model is not None:
        return _kind(family if family is not None else model)
    if "conv1" in params:
        return "hyperbolic_image"
    if "latent" in params and "encoder" in params:
        return "autoencoder"
    if "encoder" in params and "log_var" in params:
        return "euclidean"
    if "enc" not in params or "dec_out" not in params:
        return "gyroplane"
    if "dec_geodesic" in params:
        return "pvae"
    if "dec_first" in params:
        if "scale" not in params:
            return "unified"  # a fixed posterior scale: no PvaeMLPVAE has one
        raise ValueError("the tree (enc, mu, scale, dec_first, dec_out) is a UnifiedVAE's with a "
                         "Euclidean latent or a PvaeMLPVAE's with a linear decoder: pass "
                         "model='UnifiedVAE' or model='PvaeMLPVAE'")
    # gyroplanes: an RNASeqVAE, or a UnifiedVAE on the ball, whose flat-input
    # layout is the same
    return "unified" if "scale" not in params else "rnaseq"


def _chw_to_hwc_perm(c: int, h: int, w: int) -> np.ndarray:
    """perm[(H, W, C)-flat index] = the (C, H, W)-flat index."""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).reshape(-1)


def _permuted(a, axis: int, perm) -> np.ndarray:
    """a with its ``axis`` taken in the (C, H, W) order (``perm`` None: a)."""
    a = np.asarray(a)
    return a if perm is None else np.take(a, np.argsort(perm), axis=axis)


def _linear(p: Mapping, key: str, sd, in_perm=None, out_perm=None) -> None:
    """A flax Dense (kernel (in, out)) as an (out, in) weight and a bias,
    with its input or output axis permuted by ``in_perm``/``out_perm``."""
    w = _permuted(_permuted(np.asarray(p["kernel"]).T, 1, in_perm), 0, out_perm)
    sd[f"{key}.weight"] = _t(np.ascontiguousarray(w))
    sd[f"{key}.bias"] = _t(_permuted(p["bias"], 0, out_perm))


def _conv(p: Mapping, key: str, sd) -> None:
    sd[f"{key}.weight"] = _t(np.ascontiguousarray(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)))
    sd[f"{key}.bias"] = _t(p["bias"])


def _conv_t(p: Mapping, key: str, sd) -> None:
    k = np.asarray(p["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    sd[f"{key}.weight"] = _t(np.ascontiguousarray(k))
    sd[f"{key}.bias"] = _t(p["bias"])


def _gyro(p: Mapping, key: str, sd, out_perm=None) -> None:
    """``mp_points`` and, when the layer has one (``use_bias``), ``bias``."""
    sd[f"{key}.points"] = _t(_permuted(p["mp_points"], 0, out_perm))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(_permuted(p["bias"], 0, out_perm))


def _riemannian(p: Mapping, key: str, sd, in_perm=None, out_perm=None) -> None:
    """``weight_t0`` -> ``_weight``; ``bias_scalar`` (out, 1) or the point
    ``mp_bias`` (out, in) -> ``_bias``."""
    w = _permuted(_permuted(p["weight_t0"], 1, in_perm), 0, out_perm)
    if "mp_bias" in p:  # a point in the input space: both axes permute
        b = _permuted(_permuted(p["mp_bias"], 1, in_perm), 0, out_perm)
    else:
        b = _permuted(p["bias_scalar"], 0, out_perm)
    sd[f"{key}._weight"] = _t(np.ascontiguousarray(w))
    sd[f"{key}._bias"] = _t(np.ascontiguousarray(b))


def _square_shape(n_features: int, channels2: int, in_channels: int = 1) -> tuple:
    """The square (H, W, C) whose three stride-2 convs give ``n_features``
    features of ``channels2`` channels."""
    side = int(round(np.sqrt(n_features // channels2))) * 8
    if channels2 * (side // 8) ** 2 != n_features:
        raise ValueError(f"{n_features} conv features are not {channels2} channels on a square "
                         "grid: pass data_shape")
    return (side, side, in_channels)


def _feature_perm(model, c2: int, n_features: int) -> np.ndarray:
    """The (H, W, C) -> (C, H, W) permutation of the flattened conv
    features: H/8, W/8 from the port model's data_shape, else square."""
    h, w = (getattr(model, "data_shape", None) or _square_shape(n_features, c2))[:2]
    return _chw_to_hwc_perm(c2, h // 8, w // 8)


def _conv_decoder(d: Mapping, prefix, sd) -> None:
    """The ConvDecoder's conv stack: ``prefix(i)`` names its i-th slot
    (ConvTranspose_0, Conv_0, ConvTranspose_1, Conv_1, ConvTranspose_2)."""
    for i, (name, kind) in enumerate((("ConvTranspose_0", _conv_t), ("Conv_0", _conv),
                                       ("ConvTranspose_1", _conv_t), ("Conv_1", _conv),
                                       ("ConvTranspose_2", _conv_t))):
        kind(d[name], prefix(i), sd)


def _conv_families(kind: str, params: Mapping, model, sd) -> None:
    if kind == "hyperbolic_image":
        c2 = np.asarray(params["conv3"]["kernel"]).shape[-1]
        n_feat = (np.asarray(params["mu"]["kernel"]).shape[0] if "mu" in params
                  else np.asarray(params["mu_mobius"]["weight_t0"]).shape[1])
        perm = _feature_perm(model, c2, n_feat)
        for i, name in enumerate(("conv1", "conv2", "conv3")):
            _conv(params[name], f"encoder.{2 * i}", sd)
        if "mu" in params:
            _linear(params["mu"], "mu", sd, in_perm=perm)
        else:
            _riemannian(params["mu_mobius"], "mu", sd, in_perm=perm)
        if "log_var" in params:
            _linear(params["log_var"], "log_var", sd, in_perm=perm)
        dec = params["dec_first"]
        if "mp_points" in dec:
            _gyro(dec, "decoder.0", sd, out_perm=perm)
        elif "weight_t0" in dec:
            _riemannian(dec, "decoder.0", sd, out_perm=perm)
        else:
            _linear(dec, "decoder.0", sd, out_perm=perm)
        for name, slot, fn in (("deconv1", 3, _conv_t), ("conv4", 5, _conv),
                               ("deconv2", 7, _conv_t), ("conv5", 9, _conv),
                               ("deconv3", 11, _conv_t)):
            fn(params[name], f"decoder.{slot}", sd)
        return
    enc, dec = params["encoder"], params["decoder"]
    c2 = np.asarray(enc["Conv_4"]["kernel"]).shape[-1]
    head = params["latent"] if kind == "autoencoder" else params["mu"]
    perm = _feature_perm(model, c2, np.asarray(head["kernel"]).shape[0])
    if kind == "autoencoder":
        for i in range(5):
            _conv(enc[f"Conv_{i}"], f"encoder.net.{2 * i}", sd)
        _linear(params["latent"], "encoder.net.11", sd, in_perm=perm)
        _linear(dec["Dense_0"], "decoder.linear.0", sd, out_perm=perm)
        _conv_decoder(dec, lambda i: f"decoder.net.{2 * i}", sd)
        return
    for i in range(5):
        _conv(enc[f"Conv_{i}"], f"encoder.{2 * i}", sd)
    _linear(params["mu"], "mu", sd, in_perm=perm)
    _linear(params["log_var"], "log_var", sd, in_perm=perm)
    _linear(dec["Dense_0"], "decoder.0", sd, out_perm=perm)
    _conv_decoder(dec, lambda i: f"decoder.{3 + 2 * i}", sd)


def _mlp_families(kind: str, params: Mapping, model, sd) -> None:
    """UnifiedVAE's and PvaeMLPVAE's trees."""
    if kind == "unified":
        multi = len(getattr(model, "input_size", (28, 28, 1))) > 1
        enc = "encoder.1" if multi else "encoder.0"
    else:
        enc = "encoder.1"
    _linear(params["enc"], enc, sd)
    _linear(params["mu"], "mu.0", sd)
    if "scale" in params:
        _linear(params["scale"], "scale.0", sd)
    if "gyroplanes" in params:
        _gyro(params["gyroplanes"], "decoder.0", sd)
    elif "dec_geodesic" in params:
        _riemannian(params["dec_geodesic"], "decoder.0", sd)
    else:
        _linear(params["dec_first"], "decoder.0", sd)
    _linear(params["dec_out"], "decoder.2", sd)


def state_dict_from_jax_params(params: Mapping, model=None) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX parameter tree (the ``params``
    collection, as nested dicts of arrays) of one of the seven families;
    ``model`` (a class name, "gyroplane", "rnaseq", ..., or a port model,
    whose ``data_shape`` the conv families and whose ``input_size`` a
    UnifiedVAE read) names the family, which otherwise comes from the
    tree's keys (see the module's note on the trees they cannot tell)."""
    sd: Dict[str, torch.Tensor] = {}
    kind = _family(params, model)
    if kind in ("hyperbolic_image", "euclidean", "autoencoder"):
        _conv_families(kind, params, model, sd)
        return sd
    if kind in ("unified", "pvae"):
        _mlp_families(kind, params, model, sd)
        return sd
    if kind == "rnaseq":
        _linear(params["enc"], "encoder.0", sd)
        _linear(params["mu"], "mu.0", sd)
        _linear(params["scale"], "scale.0", sd)
        _gyro(params["gyroplanes"], "decoder.0", sd)
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
    _gyro(params["gyroplanes"], "decoder.0", sd)
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


# the state_dict reader's earlier name: .npz, .pt, or a reference Lightning .ckpt
load_state_dict_file = load_torch_state_dict


def gyroplane_vae_from_state_dict(
    sd: Mapping[str, torch.Tensor],
    data_shape: Sequence[int] = (28, 28, 1),
    manifold_curvature: float = 1.0,
    prior_scale: float = 1.0,
    device: DeviceLike = None,
    beta: float = 1.0,
) -> GyroplaneVAE:
    """A GyroplaneVAE holding ``sd`` (``import_torch_state_dict``: geoopt's
    curvature entries checked and dropped, a missing gyroplane bias zero).
    Widths and the latent size come from the tensors' shapes; the
    curvature, KL weight, prior scale and data shape are not stored in a
    state_dict and are given here."""
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
    return import_torch_state_dict(model, sd)


def _default_shape(n_features: int, data_shape) -> tuple:
    """``data_shape`` if given, else JAX's default (28, 28, 1) where its
    size fits, else flat."""
    if data_shape:
        return tuple(data_shape)
    return (28, 28, 1) if n_features == 784 else (n_features,)


def _mlp_family_of(sd: Mapping) -> Optional[str]:
    """The UnifiedVAE / PvaeMLPVAE / RNASeqVAE layouts told by their keys
    (None: none of them); raises naming the candidates where the keys fit
    two families."""
    if "decoder.2.weight" not in sd or "decoder.4.weight" in sd:
        return None
    if "decoder.0._weight" in sd:
        return "pvae"
    flat, fixed = "encoder.0.weight" in sd, "scale.0.weight" not in sd
    if "decoder.0.points" in sd:
        if fixed:
            return "unified"
        if flat:
            raise ValueError("the state_dict (encoder.0, mu.0, scale.0, decoder.0.points, "
                             "decoder.2) is an RNASeqVAE's or a UnifiedVAE's on a flat input: "
                             "pass family='RNASeqVAE' or family='UnifiedVAE'")
        return None  # a one-hidden-layer GyroplaneVAE's layout, as before
    if flat or fixed:
        return "unified"  # a PvaeMLPVAE has encoder.1 and scale.0
    raise ValueError("the state_dict (encoder.1, mu.0, scale.0, decoder.0.weight, decoder.2) is "
                     "a UnifiedVAE's with a Euclidean latent or a PvaeMLPVAE's with a linear "
                     "decoder: pass family='UnifiedVAE' or family='PvaeMLPVAE'")


def family_of_state_dict(sd: Mapping, family: Optional[str] = None) -> str:
    """The short name ("gyroplane", "unified", "rnaseq", "pvae",
    "euclidean", "autoencoder", "hyperbolic_image") of the family
    ``family`` names (a class name or a short name), else of the one the
    keys tell (``model_from_state_dict``'s rules); raises naming the
    candidates where the keys fit two families."""
    if family is not None:
        return _kind(family)
    if "encoder.net.0.weight" in sd:
        return "autoencoder"
    if "encoder.8.weight" in sd:
        return "euclidean"
    if "encoder.4.weight" in sd:
        return "hyperbolic_image"
    return _mlp_family_of(sd) or "gyroplane"


def _square_image(sd: Mapping) -> tuple:
    """The square one-channel (H, W, 1) a GyroplaneVAE's first layer reads."""
    first = min((k for k in sd if k.startswith("encoder.") and k.endswith(".weight")),
                key=lambda k: int(k.split(".")[1]))
    n = int(sd[first].shape[1])
    side = math.isqrt(n)
    if side * side != n:
        raise ValueError(f"{n} input features are not a square image: pass data_shape")
    return (side, side, 1)


def _mlp_model(kind: str, sd: Mapping, device, data_shape, config: dict):
    """A UnifiedVAE, PvaeMLPVAE or RNASeqVAE shaped by ``sd``."""
    from hyperbolic_vae_tpu_torch.models import PvaeMLPVAE, RNASeqVAE, UnifiedVAE

    enc = sd["encoder.0.weight"] if "encoder.0.weight" in sd else sd["encoder.1.weight"]
    hidden, n_in = enc.shape
    latent = sd["mu.0.weight"].shape[0]
    if kind == "rnaseq":
        config.setdefault("recon", "nb" if "nb_log_theta" in sd else "mse")
        return RNASeqVAE(n_in, hidden, latent, device=device, **config)
    if kind == "pvae":
        config.setdefault("decoder_first",
                          "geodesic" if "decoder.0._weight" in sd else "linear")
        if sd["scale.0.weight"].shape[0] == 1 and latent > 1:
            config.setdefault("posterior", "riemannian")
        return PvaeMLPVAE(_default_shape(n_in, data_shape), hidden, latent, device=device,
                          **config)
    if "decoder.0.weight" in sd:
        config["latent_curvature"] = None
    if "scale.0.weight" not in sd:
        config.setdefault("posterior_scale", "fixed")
    shape = (n_in,) if "encoder.0.weight" in sd else _default_shape(n_in, data_shape)
    return UnifiedVAE(shape, hidden, latent, device=device, **config)


def model_from_state_dict(sd: Mapping[str, torch.Tensor], device: DeviceLike = None,
                          data_shape: Optional[Sequence[int]] = None,
                          family: Optional[str] = None, **config):
    """A port model holding ``sd``, the family named by ``family`` (a class
    name or a short name: "UnifiedVAE", "PvaeMLPVAE", "RNASeqVAE", ...) or
    told by its keys (the reference layouts): ``encoder.net.*`` an
    Autoencoder, five encoder convs an EuclideanVAE, three a
    HyperbolicImageVAE; ``encoder.1``/``decoder.0._weight``/``decoder.2`` a
    PvaeMLPVAE; ``encoder.0`` with a Linear ``decoder.0`` or any layout
    without ``scale.0`` a UnifiedVAE; else a GyroplaneVAE
    (``gyroplane_vae_from_state_dict``, data_shape default the square
    one-channel image its first layer reads: (28, 28, 1) at 784).
    Where the keys fit two families it raises naming them: an RNASeqVAE
    or a UnifiedVAE on a flat input; a Euclidean UnifiedVAE or a
    linear-decoder PvaeMLPVAE. Widths, the latent size and the conv
    families' heads come from the tensors' shapes and names; ``data_shape``
    of an image family defaults to square images, of a UnifiedVAE or
    PvaeMLPVAE to (28, 28, 1) where 784 features fit it; the rest
    (curvature, beta, ...) is not in a state_dict and comes from
    ``config``. A HyperbolicImageVAE whose ``decoder.0`` has
    ``_weight``/``_bias`` needs ``decoder_first_layer_module``
    ("geodesic" or "mobius"): both store the same tensors. Without
    ``log_var`` its ``loss_recon`` defaults to "bernoulli" (decode returns
    logits). Every family but PvaeMLPVAE loads through
    ``import_torch_state_dict``, so the reference's own checkpoints load:
    geoopt's curvature entries are checked against ``config``'s curvature
    (default 1.0) and dropped, a geoopt gyroplane layer's missing bias is
    zero."""
    from hyperbolic_vae_tpu_torch.models import Autoencoder, EuclideanVAE, HyperbolicImageVAE

    sd = dict(sd)
    kind = family_of_state_dict(sd, family)
    if kind == "gyroplane":
        return gyroplane_vae_from_state_dict(sd, data_shape=data_shape or _square_image(sd),
                                             device=device, **config)
    if kind in ("unified", "pvae", "rnaseq"):
        model = _mlp_model(kind, sd, device, data_shape, config)
    elif kind == "autoencoder":
        c, ch = sd["encoder.net.0.weight"].shape[:2]
        lat, feat = sd["encoder.net.11.weight"].shape
        model = Autoencoder(data_shape or _square_shape(feat, 2 * c, ch), base_channel_size=c,
                            latent_dim=lat, device=device, **config)
    elif kind == "euclidean":
        c, ch = sd["encoder.0.weight"].shape[:2]
        lat, feat = sd["mu.weight"].shape
        model = EuclideanVAE(data_shape or _square_shape(feat, 2 * c, ch), hidden_size=c,
                             latent_dim=lat, device=device, **config)
    else:
        m, ch = sd["encoder.0.weight"].shape[:2]
        mobius = "mu._weight" in sd
        lat, feat = sd["mu._weight" if mobius else "mu.weight"].shape
        if "decoder.0.points" in sd:
            config.setdefault("decoder_first_layer_module", "geoopt_gyroplane")
        elif "decoder.0.weight" in sd:
            config.setdefault("decoder_first_layer_module", "linear")
        elif config.get("decoder_first_layer_module") not in ("geodesic", "mobius"):
            raise ValueError("decoder.0 holds _weight/_bias: pass decoder_first_layer_module="
                             "'geodesic' or 'mobius'")
        if "log_var.weight" not in sd:
            config.setdefault("loss_recon", "bernoulli")
        model = HyperbolicImageVAE(
            data_shape or _square_shape(feat, 2 * m, ch), latent_dim=lat,
            encoder_last_layer_module="mobius" if mobius else "linear", base_channels=m,
            device=device, **config)
    if kind == "pvae":  # the port's own layout: no reference class to import from
        model.load_state_dict({k: _t(v) for k, v in sd.items()})
        return model
    return import_torch_state_dict(model, sd)


def model_from_file(path, device: DeviceLike = None, data_shape: Optional[Sequence[int]] = None,
                    family: Optional[str] = None, allow_unsafe_pickle: bool = False,
                    hparams: Optional[Mapping] = None, **config):
    """A port model holding the state_dict stored at ``path`` (``.npz``,
    ``.pt`` or a reference Lightning ``.ckpt``: ``load_torch_state_dict``),
    of the family ``family`` names or the keys tell
    (``family_of_state_dict``), configured from the file's Lightning
    ``hyper_parameters`` (``config_from_lightning``), over which
    ``hparams`` (in the same names) take precedence, and over both
    ``data_shape`` and ``config`` (``model_from_state_dict``'s)."""
    sd = load_torch_state_dict(path, allow_unsafe_pickle=allow_unsafe_pickle)
    kind = family_of_state_dict(sd, family)
    hp = {**load_lightning_hparams(path, allow_unsafe_pickle=allow_unsafe_pickle),
          **(hparams or {})}
    cfg = {**config_from_lightning(kind, sd, hp), **config}
    if data_shape:
        cfg["data_shape"] = tuple(data_shape)
    return model_from_state_dict(sd, device=device, family=kind, **cfg)
