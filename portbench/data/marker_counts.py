"""Single-cell counts (the data kind ``marker_counts``) as a structured
fake of GSE115978. Each cell a type, uniform over ``n_types``; each type
a module of ``n_genes // 20`` marker genes at ``marker_rate``, the rest
at ``base_rate``; counts Poisson. Each gene z-scored over the cells
(ddof 0), then the cells split by a random permutation into
``fractions`` (train, val; the rest would be the test split)."""

from __future__ import annotations

import torch


def make(d: dict, gen: torch.Generator, dev) -> tuple:
    n, g, t = int(d["n_cells"]), int(d["n_genes"]), int(d["n_types"])
    module = max(g // 20, 1)
    rates = torch.full((t, g), float(d["base_rate"]), device=dev)
    for i in range(t):
        lo = (i * module) % max(g - module, 1)
        rates[i, lo:lo + module] = float(d["marker_rate"])
    types = torch.randint(0, t, (n,), generator=gen, device=dev)
    x = torch.poisson(rates[types], generator=gen)
    x = (x - x.mean(dim=0, keepdim=True)) / x.std(dim=0, correction=0, keepdim=True).clamp_min(1e-12)
    order = torch.randperm(n, generator=gen, device=dev)
    n_train, n_val = int(d["fractions"][0] * n), int(d["fractions"][1] * n)
    return x[order[:n_train]], x[order[n_train:n_train + n_val]]
