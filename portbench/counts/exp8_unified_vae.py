"""Experiment 8's UnifiedVAE's training work a sample, from its shapes.

Products: the encoder (genes x hidden), mu and scale (2 x hidden x
latent), the gyroplanes' <z, p> (planes x latent), the decoder (hidden x
genes): 2 operations a multiply-add forward, and backward the weight
gradients of every layer and the input gradients of every layer but the
first (the data needs none). Elementwise, forward and backward: per gene
the sigmoid and the squared error (``GENE_OPS``), per hidden unit the
tanh GELU (twice: encoder and decoder), per plane K1's epilogue and its
derivative, and the latent chain. No optimizer update and nothing
recomputed is counted.
"""

import math

from portbench.counts import k1

FWD_GENE_OPS, BWD_GENE_OPS = 8, 6
FWD_GELU_OPS, BWD_GELU_OPS = 10, 15
BWD_GYRO_OPS = 60
FWD_LATENT_OPS, BWD_LATENT_OPS = 300, 600


def train_flops_per_sample(config: dict) -> int:
    kw = config["model"]["kwargs"]
    genes = math.prod(kw["input_size"])
    h, lat = kw["hidden_layer_dim"], kw["latent_dim"]
    mac = genes * h + 2 * h * lat + h * lat + h * genes
    fwd = 2 * mac + genes * FWD_GENE_OPS + 2 * h * FWD_GELU_OPS + h * k1.EPILOGUE_OPS + FWD_LATENT_OPS
    bwd = (2 * (2 * mac - genes * h) + genes * BWD_GENE_OPS + 2 * h * BWD_GELU_OPS
           + h * BWD_GYRO_OPS + BWD_LATENT_OPS)
    return fwd + bwd
