"""Reference (Lightning / geoopt) checkpoints into the port.

Port of ``hyperbolic_vae_tpu/interop/torch_import.py``. A user of the
reference (grisaitis/hyperbolic-vae) has Lightning ``.ckpt`` files trained
with torch and geoopt; the port is torch and keeps the reference's
state_dict layout, so its models take those weights as they are:

    sd = load_torch_state_dict("epoch=99.ckpt")       # or .npz / .pt
    model = GyroplaneVAE(data_shape=(28, 28, 1))
    import_torch_state_dict(model, sd)                # in place; returns model
    Inferencer(model).warmup()

Supported source classes (reference file -> port class), as JAX's:

  VAEHyperbolicGyroplaneDecoder (models/vae_hyperbolic_gyroplane_decoder.py:42)
      -> GyroplaneVAE
  VAE / "vae_one_b" (models/vae_one_b.py:17) -> UnifiedVAE, RNASeqVAE
  VAEEuclidean / VAEEuclideanExperiment (models/vae_euclidean.py:21,105)
      -> EuclideanVAE
  Autoencoder (models/autoencoder_nonvariational.py:101) -> Autoencoder
  ImageVAEHyperbolic / VAEHyperbolicExperiment (models/vae_hyperbolic.py:38,133)
      -> HyperbolicImageVAE

PvaeMLPVAE has no reference class here, as in JAX: its state_dict is the
port's own (``interop.model_from_state_dict`` loads it).

What the import does, since the keys are already the reference's:

  * **Curvature entries.** geoopt registers the ball's curvature as a
    parameter under every module holding the manifold (``manifold.k``,
    ``decoder.0.ball.k``, ``latent_manifold.k``, ``isp_c`` in its
    softplus-inverse form). A one-element leaf ``k``, ``c``, ``isp_k`` or
    ``isp_c`` under a parent named ``manifold``, ``ball`` or
    ``latent_manifold`` is checked against the model's curvature and
    dropped: a mismatch, a positive ``k`` (spherical) or any such entry for
    a Euclidean target raises. JAX's list of parents lacks
    ``latent_manifold`` (``torch_import.py:411``), the reference's
    UnifiedVAE's; the port takes it.
  * **geoopt's gyroplane layer has no bias.** Its
    ``Distance2StereographicHyperplanes`` stores only ``points``; a
    missing ``<layer>.bias`` beside ``<layer>.points`` becomes a zero bias
    of the model's type, the identical forward.
  * **Every other key must match.** A key the model does not hold is
    refused ("not consumed"), a key it holds that the source lacks is
    refused ("missing"), and each shape that differs from the model's own
    ``state_dict()`` is named.
  * **No permutation.** JAX permutes the conv heads' flattened features
    (``_chw_to_hwc_perm``) because it computes NHWC; the port's convs run
    NCHW and its heads read the (C, H, W)-flattened features, the
    reference's own layout.
  * The reference flattens (C, H, W); the MLP GyroplaneVAE flattens the
    channels-last image, which is the same order for one channel only, so
    (as JAX) it takes single-channel images.

The activation caveat (JAX's, ``torch_import.py:51-54``): the reference
uses exact-erf GELU, the port tanh GELU, as JAX does; imported weights
reproduce the reference's forward to ~1e-3 through GELU stacks (exactly
against a tanh-GELU reference).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = [
    "SUPPORTED_FAMILIES",
    "config_from_lightning",
    "import_torch_state_dict",
    "load_lightning_hparams",
    "load_torch_state_dict",
]

SUPPORTED_FAMILIES = ("Autoencoder", "EuclideanVAE", "GyroplaneVAE", "HyperbolicImageVAE",
                      "RNASeqVAE", "UnifiedVAE")

_CURVATURE_LEAVES = ("k", "c", "isp_k", "isp_c")
_CURVATURE_PARENTS = ("manifold", "ball", "latent_manifold")


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of ``a`` (a tensor, or a numpy array: f32, or bf16 by
    its 16-bit pattern, since bf16 is the upper half of an f32)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.tensor(np.asarray(a, np.float32))


def _torch_load(path: Path, allow_unsafe_pickle: bool):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not allow_unsafe_pickle:
            raise ValueError(
                f"{path} is not loadable with torch.load(weights_only=True) ({e}). If this "
                "checkpoint is YOUR OWN artifact (e.g. a Lightning ckpt with non-tensor "
                "metadata), pass allow_unsafe_pickle=True: full pickle executes code embedded "
                "in the file, so never enable it for files from untrusted sources.") from e
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_state_dict(path, allow_unsafe_pickle: bool = False) -> Dict[str, torch.Tensor]:
    """A flat ``{name: CPU tensor}`` from an ``.npz`` export, a raw
    ``torch.save``d state_dict, or a Lightning ``.ckpt``: its
    ``"state_dict"`` unwrapped, its tensors kept, and the experiment
    wrapper's prefix stripped when every key has it (VAEEuclideanExperiment
    stores the net under ``vae.``, VAEHyperbolicExperiment under
    ``model.``).

    ``torch.load(weights_only=True)`` only, unless ``allow_unsafe_pickle``:
    a Lightning ckpt may carry metadata the weights-only unpickler
    refuses, and full pickle executes code embedded in the file, so it is
    for checkpoints you produced yourself."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            sd = {k: _tensor(z[k]) for k in z.files}
    else:
        raw = _torch_load(path, allow_unsafe_pickle)
        if isinstance(raw, Mapping) and "state_dict" in raw:
            raw = raw["state_dict"]
        if not isinstance(raw, Mapping):
            raise ValueError(f"{path} holds a {type(raw).__name__}, not a state_dict")
        sd = {k: v.detach().cpu() for k, v in raw.items() if isinstance(v, torch.Tensor)}
    for prefix in ("vae.", "model."):
        if sd and all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def load_lightning_hparams(path, allow_unsafe_pickle: bool = False) -> dict:
    """The ``hyper_parameters`` Lightning embeds in a ``.ckpt`` (the
    reference's ``save_hyperparameters()``, vae_hyperbolic.py:145-153):
    its scalar, string and list entries; ``{}`` for an ``.npz``, a file
    without them, or one the weights-only unpickler refuses (unless
    ``allow_unsafe_pickle``)."""
    path = Path(path)
    if path.suffix == ".npz":
        return {}
    try:
        raw = _torch_load(path, allow_unsafe_pickle)
    except Exception:
        return {}
    hp = raw.get("hyper_parameters", {}) if isinstance(raw, Mapping) else {}
    if not isinstance(hp, Mapping):
        return {}
    return {k: v for k, v in hp.items() if isinstance(v, (int, float, str, bool, list, tuple))}


def config_from_lightning(kind: str, sd: Mapping, hp: Mapping) -> dict:
    """The constructor arguments of a ``kind`` model (a family's short
    name: "gyroplane", "unified", "rnaseq", "euclidean", "autoencoder",
    "hyperbolic_image") that a ``.ckpt``'s Lightning ``hyper_parameters``
    ``hp`` hold and its state_dict ``sd`` does not: ``data_shape``, stored
    (C, H, W) by the reference and returned (H, W, C); the curvature
    (``manifold_curvature``, else ``latent_curvature``; a UnifiedVAE's only
    where ``sd`` holds gyroplanes); ``beta``; the flagship's
    ``prior_scale``; experiment 5's ``decoder_first_layer_module`` and
    ``loss_recon``. Only what ``hp`` holds: the rest keeps the model's
    defaults."""
    cfg = {}
    if "data_shape" in hp:
        shape = tuple(int(n) for n in hp["data_shape"])
        cfg["data_shape"] = (shape[1], shape[2], shape[0]) if len(shape) == 3 else shape
    if kind == "autoencoder":
        return cfg
    if "beta" in hp:
        cfg["beta"] = float(hp["beta"])
    c = hp.get("manifold_curvature", hp.get("latent_curvature"))
    if c and kind == "unified":
        if "decoder.0.points" in sd:
            cfg["latent_curvature"] = float(c)
    elif c and kind != "euclidean":
        cfg["manifold_curvature"] = float(c)
    if kind == "gyroplane" and "prior_scale" in hp:
        cfg["prior_scale"] = float(hp["prior_scale"])
    if kind == "hyperbolic_image":
        cfg.update({k: str(hp[k]) for k in ("decoder_first_layer_module", "loss_recon")
                    if hp.get(k)})
    return cfg


def _model_curvature(model):
    """The model's ball curvature c (> 0), or None for a Euclidean latent."""
    for attr in ("manifold_curvature", "latent_curvature", "curvature"):
        v = getattr(model, attr, None)
        if v:
            return float(v)
    return None


def _is_curvature_key(key: str, value: torch.Tensor) -> bool:
    """A geoopt curvature entry: a one-element leaf named k, c, isp_k or
    isp_c under a module named for the manifold. A stray scalar that only
    ends in .k or .c is not one."""
    parts = key.split(".")
    return (parts[-1] in _CURVATURE_LEAVES and len(parts) >= 2
            and parts[-2] in _CURVATURE_PARENTS and value.numel() == 1)


def _source_curvature(key: str, raw: float) -> float:
    """The ball curvature c (> 0) a geoopt entry declares: ``c`` directly;
    ``k`` the sectional curvature -c (a positive k is a sphere);
    ``isp_c``/``isp_k`` softplus-inverse storage, c = softplus(isp)."""
    leaf = key.split(".")[-1]
    if leaf in ("isp_c", "isp_k"):
        return float(np.logaddexp(0.0, raw))
    if leaf == "k":
        if raw > 0:
            raise ValueError(f"source curvature {key!r} is k={raw} > 0 (SPHERICAL geometry); the "
                             "target expects a Poincaré ball (k<0) — wrong source/target pairing")
        return -raw
    return raw


def _check_curvature(model, name: str, sd: Mapping[str, torch.Tensor], keys) -> None:
    c_model = _model_curvature(model)
    for k in sorted(keys):
        raw = float(sd[k].double().reshape(()))
        c_src = _source_curvature(k, raw)
        if c_model is None:
            raise ValueError(f"source checkpoint carries a manifold curvature parameter {k!r} "
                             f"(c={c_src}) but the target {name} has a Euclidean latent — wrong "
                             "source/target pairing")
        if not np.isclose(c_src, c_model, rtol=1e-5, atol=1e-6):
            raise ValueError(f"source curvature {k!r} is c={c_src:.6g} (raw {raw:.6g}) but the "
                             f"target {name} was constructed with curvature {c_model}; rebuild the "
                             "target with the checkpoint's curvature")


def import_torch_state_dict(model, sd: Mapping):
    """Load a reference-layout state_dict ``sd`` (tensors or numpy arrays)
    into the port ``model`` in place, after the checks of the module's
    note, and return the model. Raises, naming what differs, on an
    unsupported family, a wrong curvature, a key the model does not take
    or lacks, or a shape."""
    name = type(model).__name__
    if name not in SUPPORTED_FAMILIES:
        raise ValueError(f"no torch importer for model class {name!r}; supported: "
                         f"{sorted(SUPPORTED_FAMILIES)}")
    shape = getattr(model, "data_shape", ())
    if name == "GyroplaneVAE" and len(shape) >= 3 and shape[-1] != 1:
        raise ValueError("GyroplaneVAE import assumes single-channel images (flatten order is "
                         f"channel-sensitive); got data_shape={shape}")
    src = {k: _tensor(v) for k, v in sd.items()}
    own = model.state_dict()
    for k in [k for k in src if k.endswith(".points")]:
        bias = k[:-len("points")] + "bias"
        if bias in own and bias not in src:
            # geoopt's layer has no bias term; zero is the identical forward
            src[bias] = torch.zeros(src[k].shape[0], dtype=own[bias].dtype)
    leftover = set(src) - set(own)
    curvature = {k for k in leftover if _is_curvature_key(k, src[k])}
    _check_curvature(model, name, src, curvature)
    unconsumed = sorted(leftover - curvature)
    if unconsumed:
        raise ValueError(f"source weights not consumed by the {name} importer: {unconsumed} — the "
                         "checkpoint's architecture has layers the target model does not "
                         "(importing a subset would silently drop them)")
    missing = sorted(set(own) - set(src))
    if missing:
        raise ValueError(f"import structure mismatch for {name}: missing {missing}")
    bad = [(k, tuple(src[k].shape), tuple(v.shape)) for k, v in own.items()
           if tuple(src[k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"imported shapes differ from {name}'s params (key, source, model): {bad}")
    model.load_state_dict({k: src[k] for k in own})
    return model
