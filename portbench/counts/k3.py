"""K3, the flagship's whole training step at batch B: the forward and its
ELBO, the gradient of all 14 parameters, the finite guard and the
Riemannian Adam update of parameters and both moments.

Bytes: the batch (B x data) and eps (B x latent) read once, each
parameter and its two moments read and written once (6 x the parameter
count), the four metrics written, lr and count. Operations a row: the
products of the forward (2 x the multiply-adds) and of the backward
(weight gradients of every layer and input gradients of every layer but
the first), and per element the elementwise chains as counted below;
then ``ADAM_OPS`` a parameter.
"""

from portbench.counts import k1, peaks

# the forward's f32 work beyond the products: per pixel the sigmoid, the
# clips and logits, softplus and the log density; per hidden unit of the
# MLP the tanh GELU; the latent chain (exp_0, the softplus scale, the
# wrapped-normal draw and both log densities)
FWD_PIXEL_OPS, FWD_GELU_OPS, FWD_LATENT_OPS = 30, 10, 300
# the backward's: per pixel the softplus, logit and sigmoid derivatives;
# per GELU unit; per gyroplane; the latent chain
BWD_PIXEL_OPS, BWD_GELU_OPS, BWD_GYRO_OPS, BWD_LATENT_OPS = 15, 15, 60, 600
ADAM_OPS = 12


def n_params(data: int, h1: int, h2: int, latent: int) -> int:
    planes = h2
    return (data * h1 + h1 + h1 * h2 + h2 + 2 * (h2 * latent + latent)
            + planes * latent + planes + planes * h1 + h1 + h1 * data + data)


def n_mac(data: int, h1: int, h2: int, latent: int) -> int:
    """Multiply-adds a row: the encoder, mu and scale, the gyroplanes'
    <z, p>, the decoder."""
    planes = h2
    return data * h1 + h1 * h2 + 2 * h2 * latent + planes * latent + planes * h1 + h1 * data


def fwd_ops_per_row(data: int, h1: int, h2: int, latent: int) -> int:
    return (2 * n_mac(data, h1, h2, latent) + data * FWD_PIXEL_OPS
            + (2 * h1 + 2 * h2) * FWD_GELU_OPS + h2 * k1.EPILOGUE_OPS + FWD_LATENT_OPS)


def bwd_ops_per_row(data: int, h1: int, h2: int, latent: int) -> int:
    mac = n_mac(data, h1, h2, latent)
    return (2 * (2 * mac - data * h1) + data * BWD_PIXEL_OPS
            + (2 * h1 + 2 * h2) * BWD_GELU_OPS + h2 * BWD_GYRO_OPS + BWD_LATENT_OPS)


def n_ops(b: int, data: int, h1: int, h2: int, latent: int) -> int:
    return (b * (fwd_ops_per_row(data, h1, h2, latent) + bwd_ops_per_row(data, h1, h2, latent))
            + n_params(data, h1, h2, latent) * ADAM_OPS)


def n_bytes(b: int, data: int, h1: int, h2: int, latent: int) -> int:
    return 4 * (b * data + b * latent + 6 * n_params(data, h1, h2, latent) + 4) + 8


def bound_s(b: int, data: int, h1: int, h2: int, latent: int) -> float:
    return peaks.bound_s(n_bytes(b, data, h1, h2, latent), n_ops(b, data, h1, h2, latent))
