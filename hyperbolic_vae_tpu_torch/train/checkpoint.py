"""Checkpoints: best on the monitor, last, named (e.g. ``ema``) and the
resume state, each self-describing.

Port of ``hyperbolic_vae_tpu/train/checkpoint.py`` in the port's own
format (it does not read Orbax): ``<name>.pt`` written by ``torch.save``
beside ``<name>.json`` metadata, whose ``model`` entry holds the model's
class and constructor arguments, so ``restore_model`` rebuilds the model
from a checkpoint directory alone. The resume unit (``save_state``)
holds the parameters, the optimizer (moments, EMA, count, lr), the
on-device controllers and best parameters, and the generator's state;
``Trainer.fit(resume=True)`` continues from it bit for bit. Under a mesh
rank 0 writes; under a parameter layout every tensor is saved whole in
the reference layout (the Trainer gathers it), so a resume may take
another layout or none.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Any, Optional

import torch

from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device


def model_hparams(model) -> Optional[dict]:
    """The model's class and constructor arguments (``model.hparams()``),
    JSON-serializable, or None when the model has no ``hparams``."""
    if not hasattr(model, "hparams"):
        return None
    out = {"__model_class__": type(model).__name__, "__model_module__": type(model).__module__}
    for k, v in model.hparams().items():
        out[k] = list(v) if isinstance(v, tuple) else v
    return out


def build_model(config: dict, device: DeviceLike = None):
    """The inverse of :func:`model_hparams`: import the class and build it
    from the saved arguments, on ``device``."""
    config = dict(config)
    cls = getattr(importlib.import_module(config.pop("__model_module__")),
                  config.pop("__model_class__"))
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in config.items()}
    return cls(**kwargs, device=device)


def restore_model(ckpt_dir: str, name: str = "best", device: DeviceLike = None):
    """(model, params, meta) from a checkpoint directory: the model rebuilt
    from its embedded configuration, with the saved parameters loaded."""
    mgr = CheckpointManager(ckpt_dir)
    meta = mgr.metadata(name)
    if meta is None or "model" not in meta:
        raise ValueError(f"{ckpt_dir}/{name}.json has no embedded model config; "
                         "was it saved by a Trainer around a model with hparams()?")
    model = build_model(meta["model"], device)
    params = mgr.restore(name, device=model.device)
    model.load_state_dict(params)
    return model, params, meta


class CheckpointManager:
    """Checkpoints in ``directory``. ``read_only``: saves are skipped (the
    ranks of a mesh other than the one that writes read the same files)."""

    def __init__(self, directory: str, read_only: bool = False):
        self.directory = Path(directory).absolute()
        self.read_only = read_only
        if not read_only:
            self.directory.mkdir(parents=True, exist_ok=True)
        # set by the Trainer: embedded in every best/last/named metadata file
        self.model_config: Optional[dict] = None

    def _write(self, name: str, payload: Any, meta: dict) -> None:
        if self.read_only:
            return
        tmp = self.directory / f"{name}.pt.tmp"
        torch.save(payload, tmp)
        tmp.replace(self.directory / f"{name}.pt")  # a reader never sees half a file
        (self.directory / f"{name}.json").write_text(json.dumps(meta))

    def _save(self, name: str, params: dict, meta: dict) -> None:
        payload = {k: v.detach().cpu() for k, v in params.items()}
        meta = {k: v for k, v in meta.items() if isinstance(v, (int, float, str))}
        if self.model_config is not None:
            meta["model"] = self.model_config
        self._write(name, payload, meta)

    def save_best(self, epoch: int, params: dict, metrics: dict) -> None:
        self._save("best", params, {"epoch": epoch, **metrics})

    def save_last(self, epoch: int, params: dict, metrics: dict) -> None:
        self._save("last", params, {"epoch": epoch, **metrics})

    def save_named(self, name: str, params: dict, meta: dict) -> None:
        """A parameter checkpoint under any name (e.g. ``ema``), which
        ``restore_model(dir, name)`` rebuilds like best and last."""
        self._save(name, params, meta)

    def restore(self, name: str = "best", device: DeviceLike = "cpu") -> dict:
        return torch.load(self.directory / f"{name}.pt", map_location=resolve_device(device))

    def metadata(self, name: str) -> Optional[dict]:
        p = self.directory / f"{name}.json"
        return json.loads(p.read_text()) if p.exists() else None

    # ---- the resume units: params, optimizer, controllers, generator ----
    # ``name``: units live side by side in one directory: "state" is a
    # fit's, "ensemble_state" a sweep's (every lane's, train/ensemble.py)

    def save_state(self, state: dict, meta: dict, name: str = "state") -> None:
        # the metadata rides in the same file, so a stop between the two
        # writes cannot pair a state with another epoch's metadata
        self._write(name, {"state": state, "meta": meta}, meta)

    def restore_state(self, device: DeviceLike = "cpu", name: str = "state"):
        """(state, meta), or (None, None) when there is none."""
        if not self.has_state(name):
            return None, None
        saved = torch.load(self.directory / f"{name}.pt", map_location=resolve_device(device))
        return saved["state"], saved["meta"]

    def has_state(self, name: str = "state") -> bool:
        return (self.directory / f"{name}.pt").exists()
