"""Zeros (biases)."""

import torch


def draw(leaves, gen, curvature, device) -> list:
    return [torch.zeros(shape, device=device) for shape, _ in leaves]
