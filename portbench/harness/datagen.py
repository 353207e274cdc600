"""The one generator of the cells' data: a traffic file's ``data`` block
in, the train and val splits out, made on the device from a seed in a
few large calls and handed back as numpy (the Trainer stages numpy).
The block's ``kind`` names the module under ``portbench/data/`` that
draws it. The same seed gives the same data; every seed gives the same
sizes.
"""

from __future__ import annotations

import importlib

import torch


def make(data: dict, seed: int, device) -> tuple:
    """(x_train, x_val) as f32 numpy arrays for the ``data`` block of a
    traffic file, drawn on ``device`` from ``seed``."""
    kind = importlib.import_module(f"portbench.data.{data['kind']}")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x_train, x_val = kind.make(data, gen, torch.device(device))
    return x_train.cpu().numpy(), x_val.cpu().numpy()
