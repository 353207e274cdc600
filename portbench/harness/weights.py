"""The cells' starting weights, made by the benchmark on the device from a
seed and handed to the program and to the plain reference alike. Each
leaf's init kind (``param_specs`` of the configuration's reference)
names the module under ``portbench/init/`` that draws it; one generator
serves the kinds in the order they first appear, each kind's leaves in
one call.
"""

from __future__ import annotations

import importlib

import torch


def make(specs: list, seed: int, curvature: float, device) -> dict:
    """name -> f32 tensor on ``device`` for every (name, shape, init,
    fan_in) of ``specs``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kinds = list(dict.fromkeys(kind for _, _, kind, _ in specs))
    out = {}
    for kind in kinds:
        leaves = [(name, tuple(shape), fan_in) for name, shape, k, fan_in in specs if k == kind]
        drawn = importlib.import_module(f"portbench.init.{kind}").draw(
            [(s, f) for _, s, f in leaves], gen, curvature, device)
        out.update(zip((name for name, _, _ in leaves), drawn))
    return {name: out[name] for name, _, _, _ in specs}
