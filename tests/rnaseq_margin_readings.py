"""Float64 readings of the RNA-seq loss at the projection margin, port and
JAX, on the CPU (the numbers behind
``test_torch_port_rnaseq.py::test_raw_counts_at_the_projection_margin_as_accurate_as_jax``).

    JAX_PLATFORMS=cpu python tests/rnaseq_margin_readings.py

JAX's own initialisation, unscaled, on raw counts (64 genes, hidden 8, 18
rows): every posterior mean lies on the projection margin. For each
``recon`` mode it prints each package's f32 distance from JAX's float64
evaluation (``compute_dtype="float64"``) of the loss, and of the KL's
gradient at the encoder's outputs (mu, scale) at those outputs and at
eight one-ulp changes of them, beside how far float64 itself moves under
the same changes.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE.parent), str(_HERE)]
import test_torch_port_rnaseq as t  # noqa: E402

from hyperbolic_vae_tpu_torch.distributions import wrapped_normal_rsample_from_eps  # noqa: E402


def _one_ulp(rng, a):
    step = rng.integers(-1, 2, a.shape)
    up, down = np.nextafter(a, np.float32(np.inf)), np.nextafter(a, np.float32(-np.inf))
    return np.where(step > 0, up, np.where(step < 0, down, a)).astype(np.float32)


def readings(recon: str) -> None:
    jm, params, model = t._init(recon, enc_scale=1.0)
    x, eps, _ = t._inputs(recon, 3 * t.B, raw=True)
    mu0, sc0 = (np.asarray(a) for a in jm.apply({"params": params}, jnp.asarray(x), method="encode"))
    with jax.enable_x64(True):
        jm64 = t.JaxRNASeqVAE(in_features=t.G, hidden_dim=t.H, recon=recon, compute_dtype="float64")
        loss64, _, at64 = t._jax_pieces(jm64, recon)
    loss32, _, at32 = t._jax_pieces(jm, recon)

    def f64(a):
        return jax.tree.map(lambda b: jnp.asarray(b, jnp.float64), a)

    radius = (1.0 - 4e-3) / np.sqrt(jm.manifold_curvature)
    print(f"{recon}: |mu| / projection radius {np.linalg.norm(mu0, axis=-1).min() / radius:.6f} "
          f"to {np.linalg.norm(mu0, axis=-1).max() / radius:.6f}")
    with jax.enable_x64(True):
        exact = {k: float(v) for k, v in loss64(f64(params), f64(x), f64(eps)).items()}
    want = {k: float(v) for k, v in loss32(params, jnp.asarray(x), jnp.asarray(eps)).items()}
    with torch.no_grad():
        got = {k: float(v) for k, v in model.loss_from_eps(t._t(x), t._t(eps)).items()}
    for k in exact:
        print(f"  {k}: float64 {exact[k]:.6f}; f32 off it by port {got[k] - exact[k]:+.4e}, "
              f"JAX {want[k] - exact[k]:+.4e}")

    def kl_grad(at, mu, sc, dt):
        return jax.grad(lambda a, b: at(params if dt is None else f64(params), x if dt is None
                                        else f64(x), a, b, eps if dt is None else f64(eps))
                        ["loss_kl"], argnums=0)(mu, sc)

    rng = np.random.default_rng(7)
    with jax.enable_x64(True):
        base = np.asarray(kl_grad(at64, f64(mu0), f64(sc0), jnp.float64))
    scale = np.abs(base).max()
    print(f"  d KL/d mu: largest magnitude {scale:.4e} (float64); distance from float64, "
          "as a share of it:")
    for draw in range(9):
        mu, sc = (mu0, sc0) if draw == 0 else (_one_ulp(rng, mu0), _one_ulp(rng, sc0))
        with jax.enable_x64(True):
            exact_g = np.asarray(kl_grad(at64, f64(mu), f64(sc), jnp.float64))
        want_g = np.asarray(kl_grad(at32, jnp.asarray(mu), jnp.asarray(sc), None))
        m, s = t._t(mu).requires_grad_(), t._t(sc).requires_grad_()
        z = wrapped_normal_rsample_from_eps(model.ball, m, s, t._t(eps))
        model._loss_parts(t._t(x), m, s, z, torch.full(x.shape, 0.5))["loss_kl"].backward()
        what = "at the encoder's outputs" if draw == 0 else f"one-ulp change {draw}"
        print(f"    {what}: port f32 {np.abs(m.grad.numpy() - exact_g).max() / scale:.4f}, "
              f"JAX f32 {np.abs(want_g - exact_g).max() / scale:.4f}, float64 itself moved "
              f"{np.abs(exact_g - base).max() / scale:.4f}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for recon in ("mse", "nb"):
        readings(recon)
