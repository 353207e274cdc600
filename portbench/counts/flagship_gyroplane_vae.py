"""The flagship's training work a sample, from its shapes: the forward
and the backward of K3's count (``k3.fwd_ops_per_row`` and
``bwd_ops_per_row``), whatever path computes them. No optimizer update
and nothing recomputed is counted."""

import math

from portbench.counts import k3


def train_flops_per_sample(config: dict) -> int:
    kw = config["model"]["kwargs"]
    data = math.prod(kw["data_shape"])
    h1, h2 = kw["hidden_dims"]
    lat = kw["latent_dim"]
    return k3.fwd_ops_per_row(data, h1, h2, lat) + k3.bwd_ops_per_row(data, h1, h2, lat)
