"""The port's evaluation path against the JAX package: ``Trainer.evaluate``
under a beta schedule, ``encode_split``, ``evaluate_probe``, the probes,
and the ball's statistics (``manifolds/stats.py``, ``mobius_scalar_mul``).

JAX parameters are carried in with ``state_dict_from_jax_params``; data
comes from numpy with a seed. Tolerances: embeddings, statistics and
distances atol 1e-5 (f32 in two frameworks' orders; the Karcher loop runs
32 steps); probe accuracies equal; a scheduled ``evaluate`` equal bit for
bit to one at the schedule's end as a static beta.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.data import core as jax_core
from hyperbolic_vae_tpu.manifolds import PoincareBall as JaxBall
from hyperbolic_vae_tpu.manifolds import stats as jax_stats
from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxVAE
from hyperbolic_vae_tpu.optim import beta_warmup_schedule as jax_beta_warmup
from hyperbolic_vae_tpu import probe as jax_probe
from hyperbolic_vae_tpu.train import Trainer as JaxTrainer
from hyperbolic_vae_tpu_torch import probe as port_probe
from hyperbolic_vae_tpu_torch.data import ArrayDataModule, make_data_module
from hyperbolic_vae_tpu_torch.interop import (
    gyroplane_vae_from_state_dict,
    state_dict_from_jax_params,
)
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.manifolds import stats as port_stats
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.optim import beta_warmup_schedule
from hyperbolic_vae_tpu_torch.train import Trainer
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

ATOL = 1e-5


def _ball_points(rng, n, d, c, max_frac=0.9):
    u = rng.normal(size=(n, d))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    return (u * rng.uniform(0.0, max_frac, size=(n, 1)) / np.sqrt(c)).astype(np.float32)


# ---------------------------------------------------------------------- #
# evaluate under a beta schedule


@pytest.mark.parametrize("beta_end,warmup,beta_start,max_epochs", [
    (1.0, 10, 0.0, 3),   # warm-up longer than the fit: beta(3) = 0.3
    (0.5, 2, 0.1, 4),    # warm-up done: beta_end, not the model's 1.0
])
def test_scheduled_evaluate_uses_the_schedules_end(beta_end, warmup, beta_start, max_epochs):
    """JAX evaluates a beta-scheduled trainer at hp_schedule(max_epochs); the
    port's ``evaluate`` at beta_schedule(max_epochs), the same f32 value,
    equal bit for bit to an ``evaluate`` of the model with that static beta,
    and leaves the model's own beta as it was."""
    jt = JaxTrainer(JaxVAE(), max_epochs=max_epochs,
                    beta_schedule=jax_beta_warmup(beta_end, warmup, beta_start))
    jax_beta = float(jt.hp_schedule(jnp.asarray(max_epochs, jnp.int32))["beta"])
    sched = beta_warmup_schedule(beta_end, warmup, beta_start)
    assert float(sched(max_epochs)) == jax_beta

    dm = make_data_module(batch_size=16, synthetic=True, n_train=80, n_test=24)
    model = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device="cpu")
    static = copy.deepcopy(model)
    static.beta = jax_beta
    scheduled = Trainer(model, max_epochs=max_epochs, beta_schedule=sched, device="cpu")
    got = scheduled.evaluate(dm)
    want = Trainer(static, max_epochs=max_epochs, device="cpu").evaluate(dm)
    assert got == want
    assert model.beta == 1.0
    unscheduled = Trainer(model, max_epochs=max_epochs, device="cpu").evaluate(dm)
    assert got["test/loss_total"] != unscheduled["test/loss_total"]


# ---------------------------------------------------------------------- #
# encode_split and evaluate_probe


@pytest.fixture(scope="module")
def flagship():
    jm = JaxVAE()
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    x0 = np.zeros((2, 28, 28, 1), np.float32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)({"params": k1, "sample": k2}, x0)["params"])
    return jm, params, state_dict_from_jax_params(params)


def _cluster_images(rng, n, n_classes=4, noise=0.05):
    """Images of n_classes well-separated kinds: class c lights a 7-row
    band of its own, plus small noise."""
    y = rng.integers(0, n_classes, n).astype(np.int32)
    x = rng.uniform(0.0, noise, size=(n, 28, 28, 1)).astype(np.float32)
    for i, c in enumerate(y):
        x[i, 7 * c:7 * c + 7] += 0.9
    return np.clip(x, 0.0, 1.0), y


def _modules(batch_size=32):
    rng = np.random.default_rng(3)
    parts = [_cluster_images(rng, n) for n in (90, 30, 40)]
    args = [a for p in parts for a in p]
    return (jax_core.ArrayDataModule(*args, batch_size=batch_size),
            ArrayDataModule(*args, batch_size=batch_size))


def test_encode_split_equals_jax(flagship):
    jm, params, sd = flagship
    jdm, dm = _modules()
    z_j, y_j = JaxTrainer(jm).encode_split(jdm, params, "val")
    trainer = Trainer(gyroplane_vae_from_state_dict(sd, device="cpu"), device="cpu")
    z, y = trainer.encode_split(dm, sd, "val")
    assert z.shape == (30, 2) and np.array_equal(y, y_j)
    np.testing.assert_allclose(z, z_j, rtol=0, atol=ATOL)
    # the cached Inferencer's weights are released after the call
    assert all(p.numel() == 0 for p in trainer._encode_inferencer.model.parameters())
    z2, _ = trainer.encode_split(dm, None, "val")
    np.testing.assert_array_equal(z2, z)


def test_evaluate_probe_equals_jax_on_separated_clusters(flagship):
    """Both probes through ``evaluate_probe`` (60 of the 90 train rows,
    subsampled as JAX subsamples them) give JAX's accuracies."""
    jm, params, sd = flagship
    jdm, dm = _modules()
    want = JaxTrainer(jm).evaluate_probe(jdm, params, k=5, max_train=60)
    got = Trainer(gyroplane_vae_from_state_dict(sd, device="cpu"), device="cpu").evaluate_probe(
        dm, sd, k=5, max_train=60)
    assert got == pytest.approx(want, abs=0) and set(got) == set(want)
    assert got["test/probe_nearest_mean_acc"] > 0.5


@pytest.mark.parametrize("curved", [True, False], ids=["ball", "flat"])
def test_probes_equal_jax(curved):
    """kNN (query chunks of 16 with a padded tail) and nearest-mean on noisy
    clusters, with a test label unseen in train (not counted)."""
    rng = np.random.default_rng(5)
    centres = _ball_points(rng, 5, 2, 1.0, 0.7)
    y_tr = rng.integers(0, 5, 120)
    y_te = rng.integers(0, 5, 37)
    y_te[:3] = 9
    z_tr = (centres[y_tr] + rng.normal(0, 0.08, (120, 2))).astype(np.float32)
    z_te = (centres[y_te % 5] + rng.normal(0, 0.08, (37, 2))).astype(np.float32)
    jb, pb = (JaxBall(c=1.0), PoincareBall(c=1.0)) if curved else (None, None)
    knn = port_probe.knn_accuracy(z_tr, y_tr, z_te, y_te, ball=pb, k=7, chunk=16, device="cpu")
    assert knn == jax_probe.knn_accuracy(z_tr, y_tr, z_te, y_te, ball=jb, k=7, chunk=16)
    nm = port_probe.nearest_mean_accuracy(z_tr, y_tr, z_te, y_te, ball=pb, device="cpu")
    assert nm == jax_probe.nearest_mean_accuracy(z_tr, y_tr, z_te, y_te, ball=jb)


@pytest.mark.parametrize("curved", [True, False], ids=["ball", "flat"])
def test_pairwise_dist_equals_jax(curved):
    rng = np.random.default_rng(6)
    a, b = _ball_points(rng, 9, 3, 2.0), _ball_points(rng, 13, 3, 2.0)
    jb, pb = (JaxBall(c=2.0), PoincareBall(c=2.0)) if curved else (None, None)
    got = port_probe.pairwise_dist(pb, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_probe.pairwise_dist(jb, a, b)), rtol=0, atol=ATOL)


# ---------------------------------------------------------------------- #
# statistics on the ball


@pytest.mark.parametrize("c", [0.5, 1.0, 2.0])
def test_frechet_mean_and_variance_equal_jax(c):
    rng = np.random.default_rng(int(c * 10))
    x = _ball_points(rng, 20, 2, c)
    w = rng.uniform(0.0, 2.0, 20).astype(np.float32)
    w[:4] = 0.0  # padding
    jb, pb = JaxBall(c=c), PoincareBall(c=c)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)
        m = port_stats.frechet_mean(pb, torch.from_numpy(x), tw)
        np.testing.assert_allclose(m.numpy(), np.asarray(jax_stats.frechet_mean(jb, jnp.asarray(x), jw)),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            port_stats.frechet_variance(pb, torch.from_numpy(x), weights=tw).numpy(),
            np.asarray(jax_stats.frechet_variance(jb, jnp.asarray(x), weights=jw)), rtol=1e-5, atol=ATOL)


def test_class_means_equal_jax_and_an_empty_class_is_the_origin():
    rng = np.random.default_rng(7)
    x = _ball_points(rng, 30, 2, 1.0)
    labels = rng.integers(0, 4, 30)
    labels[labels == 2] = 3  # class 2 has no members
    got = port_stats.class_means(PoincareBall(c=1.0), torch.from_numpy(x), torch.from_numpy(labels), 4)
    want = np.asarray(jax_stats.class_means(JaxBall(c=1.0), jnp.asarray(x), jnp.asarray(labels), 4))
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert torch.equal(got[2], torch.zeros(2))


@pytest.mark.parametrize("c", [0.5, 1.0, 2.0])
def test_geodesic_and_mobius_scalar_mul_equal_jax(c):
    rng = np.random.default_rng(8)
    x, y = _ball_points(rng, 5, 2, c), _ball_points(rng, 5, 2, c)
    t = np.linspace(0.0, 1.0, 7, dtype=np.float32)
    jb, pb = JaxBall(c=c), PoincareBall(c=c)
    # pairs along a leading axis, times along the next: (5, 7, 2)
    got = port_stats.geodesic(pb, torch.from_numpy(x)[:, None], torch.from_numpy(y)[:, None],
                              torch.from_numpy(t)).numpy()
    want = np.asarray(jax.vmap(lambda a, b: jax_stats.geodesic(jb, a, b, jnp.asarray(t)))(x, y))
    assert got.shape == (5, 7, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    r = rng.uniform(-3.0, 3.0, size=(5, 1)).astype(np.float32)
    np.testing.assert_allclose(pb.mobius_scalar_mul(torch.from_numpy(r), torch.from_numpy(x)).numpy(),
                               np.asarray(jb.mobius_scalar_mul(jnp.asarray(r), jnp.asarray(x))),
                               rtol=0, atol=ATOL)
