"""The port's figure callbacks and image logging against the JAX package.

Both packages' callbacks run against a stand-in trainer whose metric
logger keeps the images, on the same JAX-initialised flagship parameters
(carried in with ``state_dict_from_jax_params``). Tolerances: the tiling
``_to_grid`` equal; the decoded mosaics atol 1e-5 (f32 decoders, and the
interpolation's geodesics, in two frameworks' orders, then a min-max
normalisation); a PNG written by ``MetricLogger.log_image`` decodes (with
``zlib``) to the array it was given.
"""

import struct
import sys
import types
import zlib

import jax
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.data import core as jax_core
from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxVAE
from hyperbolic_vae_tpu.train import callbacks as jax_cb
from hyperbolic_vae_tpu_torch.data import ArrayDataModule, make_data_module
from hyperbolic_vae_tpu_torch.interop import (
    gyroplane_vae_from_state_dict,
    state_dict_from_jax_params,
)
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.train import MetricLogger, Trainer
from hyperbolic_vae_tpu_torch.train import callbacks as port_cb


class _Images:
    """A metric logger that keeps what it is given: (step, tag, image)."""

    def __init__(self):
        self.images = []

    def log_image(self, step, tag, image):
        self.images.append((step, tag, np.asarray(image)))


@pytest.fixture(scope="module")
def flagship():
    jm = JaxVAE()
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    x0 = np.zeros((2, 28, 28, 1), np.float32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)({"params": k1, "sample": k2}, x0)["params"])
    model = gyroplane_vae_from_state_dict(state_dict_from_jax_params(params), device="cpu")
    return jm, params, model


def _trainers(flagship):
    jm, params, model = flagship
    jt = types.SimpleNamespace(model=jm, metric_logger=_Images())
    pt = types.SimpleNamespace(model=model, metric_logger=_Images())
    return jt, params, pt


def _modules():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=(24, 28, 28, 1)).astype(np.float32)
    y = (np.arange(24) % 5).astype(np.int32)
    return jax_core.ArrayDataModule(x, y, x, y, x, y, batch_size=8), ArrayDataModule(
        x, y, x, y, x, y, batch_size=8)


@pytest.mark.parametrize("n,nrow", [(8, 8), (10, 4), (1, 3)])
def test_to_grid_equals_jax(n, nrow):
    imgs = np.random.default_rng(n).uniform(size=(n, 5, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_cb._to_grid(imgs, nrow), jax_cb._to_grid(imgs, nrow))


def test_latent_grid_mosaic_equals_jax(flagship):
    jt, params, pt = _trainers(flagship)
    jax_cb.LatentGridCallback(every_n_epochs=1, range_lim=2.0, steps=5).on_epoch_end(jt, 0, params, {})
    port_cb.LatentGridCallback(every_n_epochs=1, range_lim=2.0, steps=5).on_epoch_end(pt, 0, None, {})
    (js, jtag, jimg), = jt.metric_logger.images
    (ps, ptag, pimg), = pt.metric_logger.images
    assert (ps, ptag) == (js, jtag) == (0, "latent_grid") and pimg.shape == jimg.shape == (140, 140, 1)
    np.testing.assert_allclose(pimg, jimg, rtol=0, atol=1e-5)


def test_latent_interpolation_mosaic_equals_jax(flagship):
    jt, params, pt = _trainers(flagship)
    jdm, dm = _modules()
    jcb = jax_cb.LatentInterpolationCallback(every_n_epochs=1, n_pairs=3, steps=6)
    pcb = port_cb.LatentInterpolationCallback(every_n_epochs=1, n_pairs=3, steps=6)
    jcb.on_fit_start(jt, jdm)
    pcb.on_fit_start(pt, dm)
    np.testing.assert_array_equal(pcb._x, jcb._x)
    jcb.on_epoch_end(jt, 0, params, {})
    pcb.on_epoch_end(pt, 0, pt.model.state_dict(), {})
    (_, jtag, jimg), = jt.metric_logger.images
    (_, ptag, pimg), = pt.metric_logger.images
    assert ptag == jtag == "latent_interpolation" and pimg.shape == jimg.shape == (84, 168, 1)
    np.testing.assert_allclose(pimg, jimg, rtol=0, atol=1e-5)


def test_generate_callback_grid_shape(flagship):
    _, _, pt = _trainers(flagship)
    _, dm = _modules()
    cb = port_cb.GenerateCallback(every_n_epochs=1, n=4)
    cb.on_fit_start(pt, dm)
    cb.on_epoch_end(pt, 0, None, {})
    (_, tag, img), = pt.metric_logger.images
    assert tag == "reconstructions" and img.shape == (56, 112, 1)
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0 + 1e-6
    x = dm.x_train[:4]
    np.testing.assert_allclose(img[:28, :28], (x[0] - x.min()) / (x.max() - x.min()), atol=1e-6)


@pytest.mark.parametrize("kind", ["float grey", "uint8 rgb"])
def test_log_image_writes_a_png_that_decodes_to_the_array(tmp_path, kind):
    rng = np.random.default_rng(1)
    if kind == "float grey":
        img = rng.uniform(-0.2, 1.2, size=(9, 13, 1)).astype(np.float32)
        want = (np.clip(img, 0, 1) * 255).astype(np.uint8)[..., 0]
        ctype, channels = 0, 1
    else:
        img = rng.integers(0, 256, size=(9, 13, 3)).astype(np.uint8)
        want, ctype, channels = img, 2, 3
    MetricLogger(str(tmp_path)).log_image(7, "a/b", img)
    data = (tmp_path / "a_b_00007.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    assert (w, h, depth, color) == (13, 9, 8, ctype)
    start = data.index(b"IDAT") + 4
    (n,) = struct.unpack(">I", data[start - 8:start - 4])
    rows = np.frombuffer(zlib.decompress(data[start:start + n]), np.uint8).reshape(h, 1 + w * channels)
    assert not rows[:, 0].any()
    np.testing.assert_array_equal(rows[:, 1:].reshape(want.shape), want)


def test_scatter_returns_without_matplotlib(flagship, monkeypatch):
    _, _, pt = _trainers(flagship)
    _, dm = _modules()
    pt.encode_split = lambda *a: pytest.fail("the scatter encoded without matplotlib")
    cb = port_cb.LatentScatterCallback(every_n_epochs=1)
    cb.on_fit_start(pt, dm)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cb.on_epoch_end(pt, 0, None, {})
    assert pt.metric_logger.images == []


def test_callbacks_keep_their_cadence(flagship):
    """Each callback draws on (epoch + 1) % every_n_epochs == 0 only."""
    pytest.importorskip("matplotlib")
    _, _, model = flagship
    _, dm = _modules()
    trainer = Trainer(model, device="cpu")
    trainer.metric_logger = _Images()
    cbs = [port_cb.GenerateCallback(every_n_epochs=3),
           port_cb.LatentScatterCallback(every_n_epochs=2, max_points=20),
           port_cb.LatentGridCallback(every_n_epochs=4, steps=3),
           port_cb.LatentInterpolationCallback(every_n_epochs=5, n_pairs=2, steps=3)]
    for cb in cbs:
        if hasattr(cb, "on_fit_start"):
            cb.on_fit_start(trainer, dm)
    for epoch in range(6):
        for cb in cbs:
            cb.on_epoch_end(trainer, epoch, trainer.model.state_dict(), {})
    got = sorted((tag, step) for step, tag, _ in trainer.metric_logger.images)
    assert got == [("latent_grid", 3), ("latent_interpolation", 4), ("posterior_means", 1),
                   ("posterior_means", 3), ("posterior_means", 5), ("reconstructions", 2),
                   ("reconstructions", 5)]
    scatter = [img for _, tag, img in trainer.metric_logger.images if tag == "posterior_means"]
    assert scatter[0].dtype == np.uint8 and scatter[0].ndim == 3 and scatter[0].shape[-1] == 3


def test_a_fit_writes_the_figures(tmp_path):
    """One epoch of ``Trainer.fit`` with the three decoder figures at
    every_n_epochs=1 writes their PNGs into log_dir."""
    dm = make_data_module(batch_size=32, synthetic=True, n_train=160, n_test=8)
    model = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device="cpu")
    trainer = Trainer(model, max_epochs=1, early_stopping_patience=None, log_dir=str(tmp_path),
                      device="cpu", callbacks=[
                          port_cb.GenerateCallback(every_n_epochs=1),
                          port_cb.LatentGridCallback(every_n_epochs=1, steps=4),
                          port_cb.LatentInterpolationCallback(every_n_epochs=1, n_pairs=2, steps=4)])
    trainer.fit(dm)
    names = sorted(p.name for p in tmp_path.glob("*.png"))
    assert names == ["latent_grid_00000.png", "latent_interpolation_00000.png",
                     "reconstructions_00000.png"]
