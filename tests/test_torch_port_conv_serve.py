"""The conv image families' data, checkpoints and serving in the port, on
the CPU.

  * synthetic CIFAR-10 (arrays and the 45k/5k/10k data module) and
    ``pad_to_32`` equal the JAX package's bit for bit; the CIFAR pickle
    reader on a fake batch set (and its archive) in ``tmp_path`` equals
    JAX's reader;
  * a CPU fit of experiment 5's configuration (Mobius head, 512 -> here
    64 gyroplanes, c = 1.4, 16 x 16 images), of the EuclideanVAE and of
    the Autoencoder -> their checkpoints -> ``restore_model``
    (``data_shape`` a tuple again) -> ``Inferencer.from_checkpoint`` ->
    ``InferenceServer`` on 127.0.0.1:
    embed, decode, reconstruct (JSON and octet-stream) and generate equal,
    bit for bit, the restored model run batch by batch (the engine's
    shapes); the Autoencoder's generate answers 404. The port's engine
    against JAX's ``Inferencer`` on the same weights: rtol 1e-5 / atol
    1e-5 (f32 convs in two libraries' orders);
  * ``serve_http --state-dict FILE --model-config JSON`` serves a
    HyperbolicImageVAE written by JAX's exporter;
  * the Trainer refuses ``grad_accum_steps > 1`` for the batch-sum loss
    modes (HyperbolicImageVAE ``mse``/``bernoulli``, EuclideanVAE);
  * the figure callbacks on a Euclidean latent and on [-1, 1] CIFAR images.
"""

import json
import pickle
import tarfile
import types
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.data import cifar10 as jax_cifar
from hyperbolic_vae_tpu.data import mnist as jax_mnist
from hyperbolic_vae_tpu.interop.torch_export import export_torch_state_dict
from hyperbolic_vae_tpu.models import Autoencoder as JaxAE
from hyperbolic_vae_tpu.models import EuclideanVAE as JaxEuclidean
from hyperbolic_vae_tpu.models import HyperbolicImageVAE as JaxHyp
from hyperbolic_vae_tpu.serve import Inferencer as JaxInferencer
from hyperbolic_vae_tpu.train import callbacks as jax_cb
from hyperbolic_vae_tpu_torch.data import cifar10, make_data_module, pad_to_32
from hyperbolic_vae_tpu_torch.interop import model_from_state_dict
from hyperbolic_vae_tpu_torch.models import Autoencoder, EuclideanVAE, HyperbolicImageVAE
from hyperbolic_vae_tpu_torch.serve import Inferencer
from hyperbolic_vae_tpu_torch.serve_http import InferenceServer, load_engines, parse_args
from hyperbolic_vae_tpu_torch.train import Trainer
from hyperbolic_vae_tpu_torch.train import callbacks as port_cb
from hyperbolic_vae_tpu_torch.train.checkpoint import restore_model

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"
ENGINE = dict(batch_size=8, max_batches_per_dispatch=4)
EXP5 = dict(latent_dim=2, manifold_curvature=1.4, encoder_last_layer_module="mobius",
            decoder_first_layer_module="geoopt_gyroplane", base_channels=8)


# ---- data --------------------------------------------------------------------


def test_synthetic_cifar_and_data_module_equal_jax():
    want = jax_cifar.synthetic_cifar10_arrays(60, 11, seed=4)
    got = cifar10.synthetic_cifar10_arrays(60, 11, seed=4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    kw = dict(batch_size=16, synthetic=True, n_train=70, n_test=9)
    want, got = jax_cifar.make_data_module(**kw), cifar10.make_data_module(**kw)
    assert (len(got.x_train), len(got.x_val), len(got.x_test)) == (63, 7, 9)
    for s in ("train", "val", "test"):
        for a in ("x", "y"):
            np.testing.assert_array_equal(getattr(got, f"{a}_{s}"), getattr(want, f"{a}_{s}"))
    assert got.x_train.min() >= -1.0 and got.x_train.max() <= 1.0
    assert list(got.label_names) == list(want.label_names) == cifar10.CIFAR10_LABELS
    assert got.name == want.name == "cifar10-synthetic"


def test_pad_to_32_equals_the_experiment_helper(monkeypatch):
    monkeypatch.syspath_prepend(str(EXPERIMENTS))
    from train_vae_euclidean_mnist import pad_to_32 as jax_pad

    kw = dict(batch_size=8, synthetic=True, n_train=30, n_test=5)
    want, got = jax_pad(jax_mnist.make_data_module(**kw)), pad_to_32(make_data_module(**kw))
    for s in ("train", "val", "test"):
        x = getattr(got, f"x_{s}")
        assert x.shape[1:] == (32, 32, 1) and x.dtype == np.float32
        np.testing.assert_array_equal(x, getattr(want, f"x_{s}"))
    assert got.input_shape == (32, 32, 1)


def _fake_cifar(directory: Path, n: int = 7) -> None:
    rng = np.random.default_rng(0)
    base = directory / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 b"labels": rng.integers(0, 10, n).tolist()}
        with open(base / name, "wb") as f:
            pickle.dump(batch, f)


@pytest.mark.parametrize("packed", [False, True])
def test_cifar_pickle_reader_equals_jax(tmp_path, packed):
    src = tmp_path / "src"
    _fake_cifar(src)
    if packed:  # only the archive: both readers extract it
        for who in ("jax", "port"):
            (tmp_path / who).mkdir()
            with tarfile.open(tmp_path / who / "cifar-10-python.tar.gz", "w:gz") as tf:
                tf.add(src / "cifar-10-batches-py", arcname="cifar-10-batches-py")
        want = jax_cifar.load_cifar10_arrays(tmp_path / "jax")
        got = cifar10.load_cifar10_arrays(tmp_path / "port")
    else:
        want, got = jax_cifar.load_cifar10_arrays(src), cifar10.load_cifar10_arrays(src)
    assert got[0].shape == (35, 32, 32, 3) and got[2].shape == (7, 32, 32, 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].min() >= -1.0 and got[0].max() <= 1.0
    with pytest.raises(FileNotFoundError, match="Nothing is downloaded"):
        cifar10.load_cifar10_arrays(tmp_path / "missing")


# ---- fit -> checkpoint -> serve ------------------------------------------------


def _mnist16():
    """Synthetic MNIST cut to 16 x 16 (a crop of the padded 32 x 32)."""
    dm = pad_to_32(make_data_module(batch_size=8, synthetic=True, n_train=72, n_test=13))
    for s in ("train", "val", "test"):
        setattr(dm, f"x_{s}", np.ascontiguousarray(getattr(dm, f"x_{s}")[:, 8:24, 8:24]))
    return dm


def _cifar16():
    dm = cifar10.make_data_module(batch_size=8, synthetic=True, n_train=72, n_test=13)
    for s in ("train", "val", "test"):
        setattr(dm, f"x_{s}", np.ascontiguousarray(getattr(dm, f"x_{s}")[:, ::2, ::2]))
    return dm


def _http(server, path, body=None, headers=None):
    req = urllib.request.Request(f"http://{server.host}:{server.port}{path}", data=body,
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return dict(r.headers), r.read()


@pytest.mark.parametrize("family", ["hyperbolic", "euclidean", "autoencoder"])
def test_fit_checkpoint_serve_round_trip(tmp_path, family):
    dm = _mnist16() if family == "hyperbolic" else _cifar16()
    gen = torch.Generator().manual_seed(0)
    if family == "hyperbolic":
        model = HyperbolicImageVAE((16, 16, 1), **EXP5, generator=gen, device="cpu")
    elif family == "euclidean":
        model = EuclideanVAE((16, 16, 3), hidden_size=4, latent_dim=2, generator=gen,
                             device="cpu")
    else:
        model = Autoencoder((16, 16, 3), base_channel_size=4, latent_dim=8, generator=gen,
                            device="cpu")
    res = Trainer(model, max_epochs=2, epochs_per_dispatch=2, checkpoint_dir=str(tmp_path),
                  device="cpu").fit(dm)
    assert res.epochs_run == 2 and all(np.isfinite(h["val/loss_total"]) for h in res.history)
    restored, _, meta = restore_model(str(tmp_path), "best", device="cpu")
    assert type(restored) is type(model) and restored.hparams() == model.hparams()
    assert restored.data_shape == model.data_shape and isinstance(restored.data_shape, tuple)
    inf = Inferencer.from_checkpoint(str(tmp_path), "best", device="cpu", **ENGINE)
    for k, v in res.best_params.items():
        assert torch.equal(inf.model.state_dict()[k], v), k
    x = np.ascontiguousarray(dm.x_test, "<f4")  # 13 rows: a full batch and a bucketed tail
    lat = inf.model.latent_dim
    z = np.random.default_rng(1).uniform(-0.5, 0.5, (5, lat)).astype(np.float32)
    with torch.no_grad():
        m = inf.model
        mean = lambda t: m.encode(t) if family == "autoencoder" else m.encode(t)[0]  # noqa: E731
        want_rec = torch.cat([m.decode(mean(torch.from_numpy(x[:8]))),
                              m.decode(mean(torch.from_numpy(np.concatenate([x[8:], x[:3]]))))[:5]])
        want_emb = torch.cat([mean(torch.from_numpy(x[:8])),
                              mean(torch.from_numpy(np.concatenate([x[8:], x[:3]])))[:5]])
        want_dec = m.decode(torch.from_numpy(np.concatenate([z, z[:3]])))[:5]
    server = InferenceServer(inf, host="127.0.0.1", port=0).start()
    try:
        octet = {"Content-Type": "application/octet-stream", "X-Shape": ",".join(map(str, x.shape))}
        h, body = _http(server, "/v1/reconstruct", x.tobytes(), octet)
        rec = np.frombuffer(body, "<f4").reshape([int(s) for s in h["X-Shape"].split(",")])
        np.testing.assert_array_equal(rec, want_rec.numpy())
        jhdr = {"Content-Type": "application/json"}
        _, body = _http(server, "/v1/embed", json.dumps({"data": x.tolist()}).encode(), jhdr)
        np.testing.assert_array_equal(np.asarray(json.loads(body)["outputs"][0], np.float32),
                                      want_emb.numpy())
        _, body = _http(server, "/v1/decode", json.dumps({"data": z.tolist()}).encode(), jhdr)
        dec = np.asarray(json.loads(body)["outputs"][0], np.float32)
        assert dec.shape == (5,) + model.data_shape
        np.testing.assert_array_equal(dec, want_dec.numpy())
        _, body = _http(server, "/v1/manifest")
        man = json.loads(body)
        assert man["data_shape"] == list(model.data_shape)
        gen_req = json.dumps({"n": 11, "seed": 3}).encode()
        if family != "autoencoder":
            assert "generate" in man["methods"]
            _, body = _http(server, "/v1/generate", gen_req, jhdr)
            g = np.asarray(json.loads(body)["outputs"][0], np.float32)
            assert g.shape == (11,) + model.data_shape
            # a sigmoid image (experiment 5), a tanh one (EuclideanVAE)
            assert np.all((g > 0) & (g < 1)) if family == "hyperbolic" else np.all(np.abs(g) <= 1)
            np.testing.assert_array_equal(g, inf.generate(11, seed=3))
        else:
            assert "generate" not in man["methods"]
            with pytest.raises(urllib.error.HTTPError) as e:
                _http(server, "/v1/generate", gen_req, jhdr)
            assert e.value.code == 404
    finally:
        server.shutdown()


@pytest.mark.parametrize("family", ["hyperbolic", "euclidean", "autoencoder"])
def test_engine_serves_as_jax(family):
    """The port's engine and JAX's over the same weights (JAX's tree,
    carried across), on both engines' bucketed paths."""
    from test_torch_port_conv_models import _init  # parameters in JAX's tree

    if family == "hyperbolic":
        shape = (16, 16, 1)
        jm = JaxHyp(data_shape=shape, **EXP5)
        model = HyperbolicImageVAE(shape, **EXP5, device="cpu")
        x = _mnist16().x_test
    elif family == "euclidean":
        shape = (16, 16, 3)
        jm = JaxEuclidean(data_shape=shape, hidden_size=4, latent_dim=2)
        model = EuclideanVAE(shape, hidden_size=4, latent_dim=2, device="cpu")
        x = _cifar16().x_test
    else:
        shape = (16, 16, 3)
        jm = JaxAE(data_shape=shape, base_channel_size=4, latent_dim=8)
        model = Autoencoder(shape, base_channel_size=4, latent_dim=8, device="cpu")
        x = _cifar16().x_test
    params = _init(jm, shape)
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params

    model.load_state_dict(state_dict_from_jax_params(params, model))
    inf, jinf = Inferencer(model, device="cpu", **ENGINE), JaxInferencer(jm, params, **ENGINE)
    z = np.random.default_rng(2).uniform(-0.5, 0.5, (13, model.latent_dim)).astype(np.float32)
    for n in (1, 13):  # a sub-batch row bucket; a two-batch dispatch
        np.testing.assert_allclose(inf.embed(x[:n]), jinf.embed(x[:n]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(inf.reconstruct(x[:n]), jinf.reconstruct(x[:n]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(inf.decode(z[:n]), jinf.decode(z[:n]), rtol=1e-5, atol=1e-5)
    assert inf.supports_method("generate") == jinf.supports_method("generate")


def test_serve_http_state_dict_with_model_config(tmp_path):
    """A HyperbolicImageVAE written by JAX's exporter (base 16, its one
    width) served from ``--state-dict`` with ``--model-config``."""
    from test_torch_port_conv_models import _init

    kw = dict(EXP5, base_channels=16)
    jm = JaxHyp(data_shape=(16, 16, 1), **kw)
    params = _init(jm, (16, 16, 1))
    path = tmp_path / "hyp.npz"
    np.savez(path, **export_torch_state_dict(jm, params))
    args = parse_args(["--state-dict", str(path), "--batch-size", "8",
                       "--model-config", json.dumps({"manifold_curvature": 1.4})])
    inf = load_engines(args, device="cpu")["default"]
    model = inf.model
    assert isinstance(model, HyperbolicImageVAE)
    assert model.hparams() == HyperbolicImageVAE((16, 16, 1), **kw, device="cpu").hparams()
    x = _mnist16().x_test[:8]
    with torch.no_grad():
        want = model.decode(model.encode(torch.from_numpy(x))[0]).numpy()
    np.testing.assert_array_equal(inf.reconstruct(x), want)
    np.testing.assert_allclose(want, JaxInferencer(jm, params, batch_size=8).reconstruct(x),
                               rtol=1e-5, atol=1e-5)
    # geodesic and mobius decoders store the same tensors: the caller says which
    sd = {k: v.clone() for k, v in HyperbolicImageVAE(
        (16, 16, 1), decoder_first_layer_module="geodesic", base_channels=4,
        device="cpu").state_dict().items()}
    with pytest.raises(ValueError, match="decoder_first_layer_module"):
        model_from_state_dict(sd, device="cpu")
    got = model_from_state_dict(sd, device="cpu", decoder_first_layer_module="geodesic")
    assert got.decoder_first_layer_module == "geodesic" and got.data_shape == (16, 16, 1)


# ---- the Trainer's loss_reduction check and the callbacks ---------------------------


@pytest.mark.parametrize("loss_recon,refused", [("mse", True), ("bernoulli", True),
                                                ("bernoulli_elbo", False)])
def test_loss_reduction_refusal(loss_recon, refused):
    model = HyperbolicImageVAE((16, 16, 1), loss_recon=loss_recon, base_channels=4, device="cpu")
    if refused:
        with pytest.raises(ValueError, match="HyperbolicImageVAE.loss_reduction is 'batch_sum'"):
            Trainer(model, grad_accum_steps=2, device="cpu")
        Trainer(model, grad_accum_steps=1, device="cpu")
    else:
        Trainer(model, grad_accum_steps=2, device="cpu")
    with pytest.raises(ValueError, match="EuclideanVAE.loss_reduction is 'batch_sum'"):
        Trainer(EuclideanVAE((16, 16, 3), hidden_size=4, device="cpu"), grad_accum_steps=2,
                device="cpu")
    Trainer(Autoencoder((16, 16, 3), base_channel_size=4, latent_dim=8, device="cpu"),
            grad_accum_steps=2, device="cpu")


class _Images:
    def __init__(self):
        self.images = []

    def log_image(self, step, tag, image):
        self.images.append((step, tag, np.asarray(image)))


def test_callbacks_on_cifar_images_and_a_euclidean_latent():
    """The reconstruction mosaic of [-1, 1] CIFAR images equals JAX's for
    the Autoencoder (deterministic) over the same weights; the latent
    scatter of a Euclidean latent (no ball) renders; so do the grid and
    interpolation mosaics of a EuclideanVAE and an Autoencoder."""
    from test_torch_port_conv_models import _init

    dm = _cifar16()
    jm = JaxAE(data_shape=(16, 16, 3), base_channel_size=4, latent_dim=8)
    params = _init(jm, (16, 16, 3))
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params

    ae = Autoencoder((16, 16, 3), base_channel_size=4, latent_dim=8, device="cpu")
    ae.load_state_dict(state_dict_from_jax_params(params, ae))
    jt = types.SimpleNamespace(model=jm, metric_logger=_Images())
    pt = types.SimpleNamespace(model=ae, metric_logger=_Images())
    jcb, pcb = jax_cb.GenerateCallback(every_n_epochs=1), port_cb.GenerateCallback(every_n_epochs=1)
    jcb.on_fit_start(jt, dm)
    pcb.on_fit_start(pt, dm)
    jcb.on_epoch_end(jt, 0, jax.tree.map(np.asarray, params), {})
    pcb.on_epoch_end(pt, 0, None, {})
    (_, jtag, jimg), = jt.metric_logger.images
    (_, ptag, pimg), = pt.metric_logger.images
    assert jtag == ptag == "reconstructions" and pimg.shape == (32, 16 * 8, 3)
    np.testing.assert_allclose(pimg, jimg, rtol=0, atol=1e-5)
    vae = EuclideanVAE((16, 16, 3), hidden_size=4, latent_dim=2, device="cpu")
    for model in (vae, ae):
        trainer = Trainer(model, device="cpu")
        trainer.metric_logger = _Images()
        cbs = [port_cb.LatentScatterCallback(every_n_epochs=1),
               port_cb.LatentGridCallback(every_n_epochs=1, steps=3),
               port_cb.LatentInterpolationCallback(every_n_epochs=1, n_pairs=2, steps=3)]
        for cb in cbs:
            if hasattr(cb, "on_fit_start"):
                cb.on_fit_start(trainer, dm)
            cb.on_epoch_end(trainer, 0, None, {})
        tags = [t for _, t, _ in trainer.metric_logger.images]
        want = {"latent_interpolation"} | ({"latent_grid"} if model is vae else set())
        assert want <= set(tags), tags
        if "posterior_means" in tags:  # matplotlib is there
            img = dict((t, i) for _, t, i in trainer.metric_logger.images)["posterior_means"]
            assert img.dtype == np.uint8 and img.ndim == 3
