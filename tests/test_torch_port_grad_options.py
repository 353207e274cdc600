"""The Trainer's gradient accumulation and global-norm clipping against the
JAX package.

JAX's own epoch body (``build_epoch_fns``' unjitted ``train_epoch``) runs
one epoch of two steps with a loss that draws eps from its key; the port
runs the same two steps with ``train_step``, on JAX's batch order and with
JAX's draws injected: the permutation of ``perm_key``, one key per step
split from ``sample_key``, and with accumulation one key per microbatch
(``epoch_program.py`` of the JAX package). Parameters come over with
``state_dict_from_jax_params``. Tolerances: the epoch's mean loss rtol
1e-5; the moments, which carry the clip's scale and the accumulated
gradients directly, rtol 1e-3 with atol 1e-4 of the tensor's largest
entry (the one-step tolerance of ``tests/test_torch_port_train.py``: two
f32 backward passes in different summation orders); the parameters rtol
5e-3, atol 3e-4 (JAX's fused-step tolerance: Adam's first steps move an
element by lr g / (|g| + 1e-8), so where |g| is near 1e-8 a last-bit
difference of g moves it by a few % of lr, and Adam does not see a
uniform scale of the gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxVAE
from hyperbolic_vae_tpu.train import Trainer as JaxTrainer
from hyperbolic_vae_tpu_torch.data import ArrayDataModule, synthetic_mnist_arrays
from hyperbolic_vae_tpu_torch.interop import (
    gyroplane_vae_from_state_dict,
    optimizer_state_from_jax,
    state_dict_from_jax_params,
)
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.optim import RiemannianAdam
from hyperbolic_vae_tpu_torch.train import Trainer
from hyperbolic_vae_tpu_torch.train.epoch_program import train_step

B, STEPS = 32, 2


def _run_both(**opts):
    """One JAX epoch of STEPS steps with ``opts`` and the same steps in the
    port. Returns (JAX params, JAX inner state, JAX epoch means, port model,
    port optimizer, port metrics of each step)."""
    jm = JaxVAE()

    def jloss(p, batch, key):  # eps drawn from the key, handed to loss_from_eps
        eps = jax.random.normal(key, (batch.shape[0], jm.latent_dim), jnp.float32)
        return jm.apply({"params": p}, batch, eps, method="loss_from_eps")

    jt = JaxTrainer(jm, max_epochs=1, early_stopping_patience=None, loss_fn=jloss, **opts)
    x = synthetic_mnist_arrays(STEPS * B, 1, seed=0)[0]
    params = jax.tree.map(np.asarray, jt.init_params(x, jax.random.PRNGKey(0)))
    jt._epoch_fns(STEPS * B, B, B)
    train_body, _ = jt._body_fns_cache[(STEPS * B, B, B)]
    key = jax.random.PRNGKey(5)
    state0 = jt._optimizer.init(params)
    jp, jstate, jmeans = jax.jit(train_body)(params, state0, jnp.asarray(x), key)

    # JAX's draws, in the order its epoch body takes them
    perm_key, skey, _ = jax.random.split(key, 3)
    perm = np.asarray(jax.random.permutation(perm_key, jnp.arange(STEPS * B, dtype=jnp.int32)))
    accum = opts.get("grad_accum_steps", 1)
    draws = []
    for _ in range(STEPS):
        skey, sk = jax.random.split(skey)
        keys = jax.random.split(sk, accum) if accum > 1 else [sk]
        draws += [np.asarray(jax.random.normal(k, (B // accum, 2), jnp.float32)) for k in keys]
    draws = iter(draws)

    tm = gyroplane_vae_from_state_dict(state_dict_from_jax_params(params), device="cpu")
    opt = RiemannianAdam(tm.parameters(), lr=float(np.float32(1e-3)), ball=tm.ball)
    opt.load_moments(optimizer_state_from_jax(jax.tree.map(np.asarray, state0.inner_state), tm))

    def loss_fn(m, xb, g):
        return m.loss_from_eps(xb, torch.tensor(next(draws)))

    metrics = []
    for s in range(STEPS):
        xb = torch.from_numpy(x[perm[s * B:(s + 1) * B]])
        metrics.append(train_step(tm, opt, xb, None, loss_fn, True, accum, opts.get("grad_clip_norm")))
    return jp, jstate.inner_state, jmeans, tm, opt, metrics


def _compare(jp, jinner, jmeans, tm, opt, metrics):
    mean_loss = float(torch.stack([m["loss_total"] for m in metrics]).mean())
    np.testing.assert_allclose(mean_loss, float(jmeans["loss_total"]), rtol=1e-5)
    assert all(float(m["skipped_steps"]) == 0.0 for m in metrics)
    want_p = state_dict_from_jax_params(jax.tree.map(np.asarray, jp))
    want = optimizer_state_from_jax(jax.tree.map(np.asarray, jinner), tm)
    assert int(opt.count) == want["count"] == STEPS
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(), rtol=5e-3, atol=3e-4,
                                   err_msg=name)
        for k in ("exp_avg", "exp_avg_sq"):
            ref = want["state"][p][k].numpy()
            np.testing.assert_allclose(opt.state[p][k].numpy(), ref, rtol=1e-3,
                                       atol=1e-4 * float(np.abs(ref).max()), err_msg=f"{name} {k}")


def test_grad_clip_norm_matches_jax():
    """A clip that binds on every step (the flagship's gradient norm is
    ~30-45 here) and keeps the gradients near their size: a much smaller
    one shrinks the points' exp_avg to ~1e-6, where its transport
    (Mobius additions of points of norm ~0.5) keeps few f32 digits on
    either side."""
    _compare(*_run_both(grad_clip_norm=20.0))


def test_grad_accum_steps_matches_jax():
    """Two microbatches of 16 rows a step, one draw each."""
    _compare(*_run_both(grad_accum_steps=2))


def _dm(n=128, batch=32):
    x, y, xt, yt = synthetic_mnist_arrays(n + 32, 8, seed=3)
    return ArrayDataModule(x[:n], y[:n], x[n:], y[n:], xt, yt, batch_size=batch)


def _model():
    return GyroplaneVAE(generator=torch.Generator().manual_seed(0), device="cpu")


def test_options_train_and_huge_clip_is_identity():
    """Through Trainer.fit: a never-binding clip gives the unclipped
    history (rtol 1e-6: the scale is exactly 1), accumulation trains."""
    hist = {}
    for tag, kw in (("plain", {}), ("clip", dict(grad_clip_norm=1e9)), ("accum", dict(grad_accum_steps=4))):
        res = Trainer(_model(), max_epochs=2, early_stopping_patience=None, device="cpu", **kw).fit(_dm())
        hist[tag] = res.history
    for a, b in zip(hist["plain"], hist["clip"]):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, err_msg=k)
    assert all(np.isfinite(v) for row in hist["accum"] for v in row.values())
    assert hist["accum"][1]["train/loss_total"] < hist["accum"][0]["train/loss_total"]


def test_grad_clip_norm_rejects_train_step_fn():
    with pytest.raises(ValueError, match="train_step_fn"):
        Trainer(_model(), device="cpu", grad_clip_norm=1.0,
                train_step_fn=lambda m, o, b, g: {})


def test_grad_accum_steps_rejects_train_step_fn_and_indivisible_batches():
    with pytest.raises(ValueError, match="train_step_fn"):
        Trainer(_model(), device="cpu", grad_accum_steps=2,
                train_step_fn=lambda m, o, b, g: {})
    with pytest.raises(ValueError, match="not divisible"):
        Trainer(_model(), device="cpu", grad_accum_steps=3, max_epochs=1).fit(_dm())
    with pytest.raises(ValueError, match=">= 1"):
        Trainer(_model(), device="cpu", grad_accum_steps=0)
