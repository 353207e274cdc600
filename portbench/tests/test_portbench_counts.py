"""The counts from shapes reproduce the kernel table's figures (PERF.md)."""

from portbench.counts import exp8_unified_vae, flagship_gyroplane_vae, k1, k3, peaks
from portbench.harness import spec


def test_k1_bytes_and_bound():
    assert k1.n_bytes(256, 16, 2) == 18_624
    assert k1.n_bytes(128_000, 16, 2) == 9_216_192
    assert abs(k1.bound_s(256, 16, 2) - 18_624 / peaks.HBM_BYTES_PER_S) < 1e-15


def test_k3_step():
    assert k3.n_params(784, 64, 16, 2) == 103_444
    assert k3.n_ops(256, 784, 64, 16, 2) == 143_680_752
    assert k3.n_bytes(256, 784, 64, 16, 2) == 3_287_544
    assert abs(k3.bound_s(256, 784, 64, 16, 2) - 143_680_752 / peaks.F32_FLOP_PER_S) < 1e-15


def test_flops_per_sample_from_the_configurations():
    flagship = spec.load_cell("flagship-train-autograd").config
    assert flagship_gyroplane_vae.train_flops_per_sample(flagship) == 556_404
    exp8 = spec.load_cell("exp8-train-autograd").config
    # the products alone: 2 x (20,480 x 100 x 2 + 600) forward, twice that
    # backward less the encoder's input gradient
    mac = 20_480 * 100 * 2 + 600
    assert exp8_unified_vae.train_flops_per_sample(exp8) > 2 * mac + 2 * (2 * mac - 20_480 * 100)
    assert exp8_unified_vae.train_flops_per_sample(exp8) < 21_000_000
