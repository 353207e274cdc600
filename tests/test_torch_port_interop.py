"""The reference's own checkpoints into the port and back
(``interop/torch_import.py``, ``interop/torch_export.py``).

Torch stand-ins reproduce the reference modules' state_dict layouts
(Sequential indices; geoopt's gyroplane layer with ``points`` only; the
reference's own hyperplane layer with ``points`` and ``bias``) with tanh
GELU, so the forward parity isolates the weight mapping from the
reference's exact-erf GELU. Their parameters come from a numpy seed. For
each family the port's import equals JAX's import carried through
``state_dict_from_jax_params`` exactly, its forward the stand-in's within
1e-5, its export JAX's export exactly, and export -> import is the
identity. JAX's own importer cases (``tests/test_torch_import.py``) are
carried over by their messages."""

import argparse
import math

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn

from hyperbolic_vae_tpu import models as J
from hyperbolic_vae_tpu.interop import export_torch_state_dict as jax_export
from hyperbolic_vae_tpu.interop import import_torch_state_dict as jax_import
from hyperbolic_vae_tpu_torch import interop as pi
from hyperbolic_vae_tpu_torch import models as P
from hyperbolic_vae_tpu_torch.interop import (
    load_state_dict_file,
    model_from_state_dict,
    state_dict_from_jax_params,
)

GELU = lambda: tnn.GELU(approximate="tanh")  # noqa: E731
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Ball:
    """geoopt's PoincareBall (curvature c), the forward maps the stand-ins use."""

    def __init__(self, c):
        self.c, self.sc = c, math.sqrt(c)

    def mobius_add(self, x, y):
        xy = (x * y).sum(-1, keepdim=True)
        x2, y2 = (x * x).sum(-1, keepdim=True), (y * y).sum(-1, keepdim=True)
        num = (1 + 2 * self.c * xy + self.c * y2) * x + (1 - self.c * x2) * y
        return num / (1 + 2 * self.c * xy + self.c ** 2 * x2 * y2)

    def expmap0(self, u):
        n = u.norm(dim=-1, keepdim=True).clamp_min(1e-15)
        return torch.tanh(self.sc * n) * u / (self.sc * n)

    def dist2plane(self, x, p):
        """Signed distance from x (B, 1, D) to the gyroplanes through p
        (P, D) with normals p."""
        diff = self.mobius_add(-p, x)
        sc = (diff * p).sum(-1)
        den = (1 - self.c * (diff * diff).sum(-1)) * p.norm(dim=-1)
        return torch.asinh(2 * self.sc * sc / den) / self.sc


class _GeooptGyroplanes(tnn.Module):
    """geoopt's Distance2StereographicHyperplanes: ``points`` only."""

    def __init__(self, dim, planes, c=1.0):
        super().__init__()
        self.points = tnn.Parameter(torch.zeros(planes, dim))
        self.geometry = _Ball(c)

    def forward(self, x):
        return self.geometry.dist2plane(x[:, None, :], self.points)


class _RefHyperplanes(_GeooptGyroplanes):
    """The reference's own Distance2PoincareHyperplanes: ``points`` and ``bias``."""

    def __init__(self, dim, planes, c=1.0):
        super().__init__(dim, planes, c)
        self.bias = tnn.Parameter(torch.zeros(planes))

    def forward(self, x):
        return super().forward(x) + self.bias


class _TorchFlagship(tnn.Module):
    """VAEHyperbolicGyroplaneDecoder (vae_hyperbolic_gyroplane_decoder.py:59-85)."""

    def __init__(self, numel=784, latent=2, c=1.0):
        super().__init__()
        self.geometry = _Ball(c)
        self.encoder = tnn.Sequential(tnn.Flatten(), tnn.Linear(numel, 64), GELU(),
                                      tnn.Linear(64, 16), GELU())
        self.mu = tnn.Sequential(tnn.Linear(16, latent))
        self.scale = tnn.Sequential(tnn.Linear(16, latent), tnn.Softplus())
        self.decoder = tnn.Sequential(_GeooptGyroplanes(latent, 16, c), GELU(), tnn.Linear(16, 64),
                                      GELU(), tnn.Linear(64, numel), tnn.Sigmoid())

    def encode(self, x):
        h = self.encoder(x)
        return (self.geometry.expmap0(self.mu(h)),
                torch.clamp(self.scale(h) + 1e-3, 1e-3, 10.0))

    def decode(self, z):
        return self.decoder(z)


class _TorchOneB(tnn.Module):
    """vae_one_b.VAE (vae_one_b.py:50-73) on a flat input, on the ball."""

    def __init__(self, features=20, hidden=8, latent=2, c=1.0):
        super().__init__()
        self.geometry = _Ball(c)
        self.encoder = tnn.Sequential(tnn.Linear(features, hidden), GELU())
        self.mu = tnn.Sequential(tnn.Linear(hidden, latent))
        self.scale = tnn.Sequential(tnn.Linear(hidden, latent), tnn.Softplus())
        self.decoder = tnn.Sequential(_RefHyperplanes(latent, hidden, c), GELU(),
                                      tnn.Linear(hidden, features))

    def encode(self, x):
        h = self.encoder(x)
        return self.geometry.expmap0(self.mu(h)), torch.clamp(self.scale(h) + 1e-3, 1e-3, 10.0)

    def decode(self, z):
        return self.decoder(z)


def _conv_encoder(ch, c):
    return [tnn.Conv2d(ch, c, 3, padding=1, stride=2), GELU(),
            tnn.Conv2d(c, c, 3, padding=1), GELU(),
            tnn.Conv2d(c, 2 * c, 3, padding=1, stride=2), GELU(),
            tnn.Conv2d(2 * c, 2 * c, 3, padding=1), GELU(),
            tnn.Conv2d(2 * c, 2 * c, 3, padding=1, stride=2), GELU(), tnn.Flatten()]


def _conv_decoder(ch, c):
    return [tnn.ConvTranspose2d(2 * c, 2 * c, 3, output_padding=1, padding=1, stride=2), GELU(),
            tnn.Conv2d(2 * c, 2 * c, 3, padding=1), GELU(),
            tnn.ConvTranspose2d(2 * c, c, 3, output_padding=1, padding=1, stride=2), GELU(),
            tnn.Conv2d(c, c, 3, padding=1), GELU(),
            tnn.ConvTranspose2d(c, ch, 3, output_padding=1, padding=1, stride=2), tnn.Tanh()]


class _TorchEuclidean(tnn.Module):
    """VAEEuclidean (vae_euclidean.py:31-88)."""

    def __init__(self, side=16, ch=3, c=4, latent=2):
        super().__init__()
        self.grid = (2 * c, side // 8, side // 8)
        f = math.prod(self.grid)
        self.encoder = tnn.Sequential(*_conv_encoder(ch, c))
        self.mu, self.log_var = tnn.Linear(f, latent), tnn.Linear(f, latent)
        self.decoder = tnn.Sequential(tnn.Linear(latent, f), GELU(), tnn.Unflatten(1, self.grid),
                                      *_conv_decoder(ch, c))

    def encode(self, x):
        h = self.encoder(x)
        return self.mu(h), self.log_var(h)

    def decode(self, z):
        return self.decoder(z)


class _TorchAE(tnn.Module):
    """autoencoder_nonvariational.Autoencoder (:25-97): encoder.net,
    decoder.linear and decoder.net."""

    def __init__(self, side=16, ch=3, c=4, latent=16):
        super().__init__()
        self.grid = (2 * c, side // 8, side // 8)
        f = math.prod(self.grid)
        self.encoder, self.decoder = tnn.Module(), tnn.Module()
        self.encoder.net = tnn.Sequential(*_conv_encoder(ch, c), tnn.Linear(f, latent))
        self.decoder.linear = tnn.Sequential(tnn.Linear(latent, f), GELU())
        self.decoder.net = tnn.Sequential(*_conv_decoder(ch, c))

    def encode(self, x):
        return self.encoder.net(x)

    def decode(self, z):
        return self.decoder.net(self.decoder.linear(z).reshape((z.shape[0],) + self.grid))


class _TorchHImage(tnn.Module):
    """ImageVAEHyperbolic (vae_hyperbolic.py:57-109), linear head and
    geoopt gyroplane decoder, loss "mse"."""

    def __init__(self, side=16, ch=1, latent=2, c=1.0):
        super().__init__()
        self.geometry = _Ball(c)
        grid = (32, side // 8, side // 8)
        f = math.prod(grid)
        self.encoder = tnn.Sequential(tnn.Conv2d(ch, 16, 3, 2, 1), GELU(),
                                      tnn.Conv2d(16, 32, 3, 2, 1), GELU(),
                                      tnn.Conv2d(32, 32, 3, 2, 1), GELU(), tnn.Flatten())
        self.mu, self.log_var = tnn.Linear(f, latent), tnn.Linear(f, latent)
        self.decoder = tnn.Sequential(
            _GeooptGyroplanes(latent, f, c), GELU(), tnn.Unflatten(-1, grid),
            tnn.ConvTranspose2d(32, 32, 3, 2, 1, output_padding=1), GELU(),
            tnn.Conv2d(32, 32, 3, 1, 1), GELU(),
            tnn.ConvTranspose2d(32, 16, 3, 2, 1, output_padding=1), GELU(),
            tnn.Conv2d(16, 16, 3, 1, 1), GELU(),
            tnn.ConvTranspose2d(16, ch, 3, 2, 1, output_padding=1), tnn.Sigmoid())

    def encode(self, x):
        h = self.encoder(x)
        return (self.geometry.expmap0(self.mu(h)),
                torch.clamp(torch.exp(0.5 * self.log_var(h)), 1e-3, 10.0))

    def decode(self, z):
        return self.decoder(z)


def _seeded(module, seed):
    """``module`` with every parameter drawn from a numpy seed: weights
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), biases U(-0.1, 0.1), gyroplane
    points inside the ball (norm <= 0.6)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("points"):
                u = rng.normal(size=p.shape)
                u *= rng.uniform(0.1, 0.6, size=(p.shape[0], 1)) / np.linalg.norm(u, axis=-1,
                                                                                 keepdims=True)
            elif p.ndim >= 2:
                u = rng.uniform(-1, 1, size=p.shape) / math.sqrt(math.prod(p.shape[1:]))
            else:
                u = rng.uniform(-0.1, 0.1, size=p.shape)
            p.copy_(torch.from_numpy(u.astype(np.float32)))
    return module


def _np_sd(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# family -> (stand-in, port model, JAX model, the input's per-sample shape)
FAMILIES = {
    "GyroplaneVAE": (lambda: _TorchFlagship(),
                     lambda: P.GyroplaneVAE(data_shape=(28, 28, 1), device="cpu"),
                     lambda: J.GyroplaneVAE(data_shape=(28, 28, 1), latent_dim=2), (28, 28, 1)),
    "UnifiedVAE": (lambda: _TorchOneB(),
                   lambda: P.UnifiedVAE((20,), 8, 2, device="cpu"),
                   lambda: J.UnifiedVAE(input_size=(20,), hidden_layer_dim=8, latent_dim=2),
                   (20,)),
    "RNASeqVAE": (lambda: _TorchOneB(),
                  lambda: P.RNASeqVAE(in_features=20, hidden_dim=8, latent_dim=2, device="cpu"),
                  lambda: J.RNASeqVAE(in_features=20, hidden_dim=8, latent_dim=2), (20,)),
    "EuclideanVAE": (lambda: _TorchEuclidean(),
                     lambda: P.EuclideanVAE((16, 16, 3), hidden_size=4, latent_dim=2, device="cpu"),
                     lambda: J.EuclideanVAE(data_shape=(16, 16, 3), hidden_size=4, latent_dim=2),
                     (16, 16, 3)),
    "Autoencoder": (lambda: _TorchAE(),
                    lambda: P.Autoencoder((16, 16, 3), base_channel_size=4, latent_dim=16,
                                          device="cpu"),
                    lambda: J.Autoencoder(data_shape=(16, 16, 3), base_channel_size=4,
                                          latent_dim=16), (16, 16, 3)),
    "HyperbolicImageVAE": (lambda: _TorchHImage(),
                           lambda: P.HyperbolicImageVAE(
                               (16, 16, 1), latent_dim=2,
                               decoder_first_layer_module="geoopt_gyroplane", loss_recon="mse",
                               device="cpu"),
                           lambda: J.HyperbolicImageVAE(
                               data_shape=(16, 16, 1), latent_dim=2,
                               decoder_first_layer_module="geoopt_gyroplane", loss_recon="mse"),
                           (16, 16, 1)),
}


def _reference(family, seed=0):
    make_ref, make_port, make_jax, shape = FAMILIES[family]
    ref = _seeded(make_ref(), seed)
    return ref, _np_sd(ref), make_port(), make_jax(), shape


def _port_sd(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(torch.as_tensor(np.asarray(a[k])), torch.as_tensor(np.asarray(b[k]))), k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_import_equals_jax_import(family):
    """The port's import of a reference state_dict equals JAX's import
    carried through ``state_dict_from_jax_params``, bit for bit (for the
    flagship and experiment 5 geoopt's bias-less layer: a zero bias)."""
    _, sd, model, jmodel, _ = _reference(family)
    assert pi.import_torch_state_dict(model, sd) is model
    jparams = jax.tree.map(np.asarray, jax_import(jmodel, sd))
    _assert_same(model.state_dict(), state_dict_from_jax_params(jparams, model=model))
    if "decoder.0.points" in sd and "decoder.0.bias" not in sd:
        assert not model.state_dict()["decoder.0.bias"].any()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_reference(family):
    """The imported port model computes the stand-in's forward."""
    ref, sd, model, _, shape = _reference(family, seed=1)
    pi.import_torch_state_dict(model, sd)
    x = np.random.default_rng(2).random((4,) + shape, np.float32)
    xt = _nchw(x) if len(shape) == 3 and family != "GyroplaneVAE" else torch.from_numpy(x)
    with torch.no_grad():
        got, want = model.encode(torch.from_numpy(x)), ref.encode(xt)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        z = got[0]
        if family in ("UnifiedVAE", "RNASeqVAE"):  # the output head differs: compare before it
            dec, dec_ref = model.decoder[:3](z), ref.decode(z)
        else:
            dec, ref_out = model.decode(z), ref.decode(z)
            dec_ref = ref_out.reshape(dec.shape) if family == "GyroplaneVAE" else _nhwc(ref_out)
        np.testing.assert_allclose(np.asarray(dec), np.asarray(dec_ref), **TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_export_equals_jax_export_and_imports_back(family):
    """The port's export of the imported weights equals JAX's export of
    JAX's import exactly, and importing it into a fresh model is the
    identity."""
    _, sd, model, jmodel, _ = _reference(family, seed=3)
    pi.import_torch_state_dict(model, sd)
    ours = pi.export_torch_state_dict(model)
    theirs = jax_export(jmodel, jax_import(jmodel, sd))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    fresh = FAMILIES[family][1]()
    _assert_same(pi.import_torch_state_dict(fresh, ours).state_dict(), model.state_dict())


@pytest.mark.parametrize("case", ["port_init", "mobius_geodesic", "rnaseq_nb_dropped"])
def test_export_import_round_trip(case):
    """export -> import is the identity on the port's own weights, for the
    Riemannian-layer variant of experiment 5 too; an ``nb`` RNASeqVAE's
    export leaves out ``nb_log_theta`` (no reference key), as JAX's does."""
    gen = torch.Generator().manual_seed(4)
    if case == "mobius_geodesic":
        def make(g=None):
            return P.HyperbolicImageVAE((16, 16, 1), latent_dim=2, encoder_last_layer_module="mobius",
                                        decoder_first_layer_module="geodesic", generator=g,
                                        device="cpu")
    elif case == "rnaseq_nb_dropped":
        def make(g=None):
            return P.RNASeqVAE(in_features=20, hidden_dim=8, recon="nb", generator=g, device="cpu")
    else:
        def make(g=None):
            return P.GyroplaneVAE(generator=g, device="cpu")
    model = make(gen)
    sd = pi.export_torch_state_dict(model)
    if case == "rnaseq_nb_dropped":
        assert "nb_log_theta" not in sd and "nb_log_theta" in model.state_dict()
        with pytest.raises(ValueError, match="missing.*nb_log_theta"):
            pi.import_torch_state_dict(make(), sd)
        return
    _assert_same(pi.import_torch_state_dict(make(), sd).state_dict(), model.state_dict())


def test_pvae_has_no_importer_as_in_jax():
    model = P.PvaeMLPVAE((28, 28, 1), 8, 2, device="cpu")
    for fn in (lambda: pi.import_torch_state_dict(model, model.state_dict()),
               lambda: pi.export_torch_state_dict(model)):
        with pytest.raises(ValueError, match="supported: .*GyroplaneVAE"):
            fn()


# ---- JAX's importer cases (tests/test_torch_import.py:583-671) ---------------


def _flagship_sd(seed=10):
    return _np_sd(_seeded(_TorchFlagship(), seed))


def test_geoopt_curvature_entries_checked_and_dropped():
    sd = _flagship_sd()
    sd["manifold.k"] = np.asarray(-1.0, np.float32)
    sd["decoder.0.ball.k"] = np.asarray([-1.0], np.float32)
    # softplus-inverse storage: an authentic c = 1 checkpoint's isp_c
    sd["mu.1.manifold.isp_c"] = np.asarray(np.log(np.expm1(1.0)), np.float32)
    model = pi.import_torch_state_dict(P.GyroplaneVAE(device="cpu"), sd)
    plain = pi.import_torch_state_dict(P.GyroplaneVAE(device="cpu"), _flagship_sd())
    _assert_same(model.state_dict(), plain.state_dict())

    bad = dict(sd, **{"manifold.k": np.asarray(-2.5, np.float32)})
    with pytest.raises(ValueError, match="curvature"):
        pi.import_torch_state_dict(P.GyroplaneVAE(device="cpu"), bad)
    sph = dict(sd, **{"manifold.k": np.asarray(1.0, np.float32)})
    with pytest.raises(ValueError, match="SPHERICAL"):
        pi.import_torch_state_dict(P.GyroplaneVAE(device="cpu"), sph)
    # a scalar that only ends in .c is no curvature entry
    stray = dict(sd, **{"temperature.c": np.asarray(1.0, np.float32)})
    with pytest.raises(ValueError, match="not consumed"):
        pi.import_torch_state_dict(P.GyroplaneVAE(device="cpu"), stray)
    # the target's own curvature decides: c = 1.4 against k = -1.4
    at14 = dict(_flagship_sd(), **{"manifold.k": np.asarray(-1.4, np.float32)})
    pi.import_torch_state_dict(P.GyroplaneVAE(manifold_curvature=1.4, device="cpu"), at14)
    with pytest.raises(ValueError, match="curvature"):
        pi.import_torch_state_dict(P.GyroplaneVAE(device="cpu"), at14)


def test_curvature_entry_on_euclidean_target_raises():
    sd = _np_sd(_seeded(_TorchEuclidean(), 11))
    sd["manifold.k"] = np.asarray(-1.0, np.float32)
    with pytest.raises(ValueError, match="Euclidean"):
        pi.import_torch_state_dict(P.EuclideanVAE((16, 16, 3), hidden_size=4, latent_dim=2,
                                                  device="cpu"), sd)
    flat = P.UnifiedVAE((20,), 8, 2, latent_curvature=None, device="cpu")
    sd = {k: v.clone() for k, v in flat.state_dict().items()}
    sd["latent_manifold.k"] = torch.tensor(-1.0)
    with pytest.raises(ValueError, match="Euclidean"):
        pi.import_torch_state_dict(flat, sd)


def test_latent_manifold_accepted_where_jax_refuses():
    """The reference's UnifiedVAE holds its ball as ``latent_manifold``:
    the port checks and drops ``latent_manifold.k``; JAX's parents lack it
    (a recorded difference)."""
    sd = _np_sd(_seeded(_TorchOneB(), 12))
    sd["latent_manifold.k"] = np.asarray([-1.0], np.float32)
    model = pi.import_torch_state_dict(P.UnifiedVAE((20,), 8, 2, device="cpu"), sd)
    plain = pi.import_torch_state_dict(P.UnifiedVAE((20,), 8, 2, device="cpu"),
                                       _np_sd(_seeded(_TorchOneB(), 12)))
    _assert_same(model.state_dict(), plain.state_dict())
    with pytest.raises(ValueError, match="not consumed.*latent_manifold.k"):
        jax_import(J.UnifiedVAE(input_size=(20,), hidden_layer_dim=8, latent_dim=2), sd)
    with pytest.raises(ValueError, match="curvature"):
        pi.import_torch_state_dict(P.UnifiedVAE((20,), 8, 2, latent_curvature=0.5, device="cpu"),
                                   sd)


def test_missing_key_and_shapes_are_named():
    sd = _flagship_sd()
    del sd["decoder.2.bias"]
    with pytest.raises(ValueError, match=r"missing \['decoder.2.bias'\]"):
        pi.import_torch_state_dict(P.GyroplaneVAE(device="cpu"), sd)
    sd = _np_sd(_seeded(_TorchOneB(), 13))
    with pytest.raises(ValueError, match="shapes differ.*encoder.0.weight"):
        pi.import_torch_state_dict(P.RNASeqVAE(in_features=21, hidden_dim=8, device="cpu"), sd)
    with pytest.raises(ValueError, match="single-channel"):
        pi.import_torch_state_dict(P.GyroplaneVAE(data_shape=(28, 28, 3), device="cpu"), sd)


def test_unsafe_pickle_is_opt_in(tmp_path):
    """A file the weights-only unpickler refuses loads only with
    ``allow_unsafe_pickle``, through the loader and through serving."""
    from hyperbolic_vae_tpu_torch.serve_http import load_engines, parse_args

    ref = _seeded(_TorchOneB(), 14)
    path = tmp_path / "meta.ckpt"
    torch.save({"state_dict": ref.state_dict(), "meta": argparse.Namespace(x=1)}, path)
    with pytest.raises(ValueError, match="allow_unsafe_pickle"):
        pi.load_torch_state_dict(path)
    loaded = pi.load_torch_state_dict(path, allow_unsafe_pickle=True)
    _assert_same(loaded, ref.state_dict())
    assert pi.load_lightning_hparams(path) == {}
    cfg = ["--model-config", '{"family": "RNASeqVAE"}', "--batch-size", "8"]
    with pytest.raises(ValueError, match="allow_unsafe_pickle"):
        load_engines(parse_args(["--state-dict", str(path)] + cfg), device="cpu")
    served = load_engines(parse_args(["--state-dict", str(path), "--allow-unsafe-pickle"] + cfg),
                          device="cpu")["default"]
    assert isinstance(served.model, P.RNASeqVAE)


def _lightning(tmp_path, prefix, sd, name="epoch=3.ckpt", **extra):
    path = tmp_path / name
    torch.save({"state_dict": {f"{prefix}{k}": torch.as_tensor(v) for k, v in sd.items()},
                "epoch": 3, **extra}, path)
    return path


@pytest.mark.parametrize("prefix", ["model.", "vae."])
def test_lightning_ckpt_prefixes(tmp_path, prefix):
    """A ``.ckpt`` wraps the net under ``model.`` (VAEHyperbolicExperiment)
    or ``vae.`` (VAEEuclideanExperiment); its hyper_parameters read back."""
    sd = _flagship_sd(15)
    path = _lightning(tmp_path, prefix, sd, hyper_parameters={"data_shape": [1, 28, 28],
                                                              "beta": 2.0, "obj": {"x": 1}})
    loaded = pi.load_torch_state_dict(path)
    assert sorted(loaded) == sorted(sd)
    assert pi.load_lightning_hparams(path) == {"data_shape": [1, 28, 28], "beta": 2.0}
    npz = tmp_path / "w.npz"
    np.savez(npz, **sd)
    _assert_same(pi.load_torch_state_dict(npz), loaded)
    assert pi.load_lightning_hparams(npz) == {}
    # a prefix on only some keys is a layout, not a wrapper: kept
    mixed = tmp_path / "mixed.pt"
    torch.save({"model.a": torch.zeros(1), "b": torch.zeros(1)}, mixed)
    assert sorted(pi.load_torch_state_dict(mixed)) == ["b", "model.a"]


# ---- the three faults (each fails on the tree before this module) -----------


def test_fault_geoopt_curvature_entries_load():
    """geoopt's ``manifold.k`` and ``decoder.0.ball.k`` once raised
    "Unexpected key(s)" in ``model_from_state_dict``; a UnifiedVAE's
    ``latent_manifold.k`` too."""
    sd = _flagship_sd(16)
    plain = model_from_state_dict(dict(sd), device="cpu")
    sd["manifold.k"] = np.asarray(-1.0, np.float32)
    sd["decoder.0.ball.k"] = np.asarray([-1.0], np.float32)
    got = model_from_state_dict(sd, device="cpu")
    _assert_same(got.state_dict(), plain.state_dict())
    one_b = _np_sd(_seeded(_TorchOneB(), 16))
    one_b["latent_manifold.k"] = np.asarray(-1.0, np.float32)
    assert isinstance(model_from_state_dict(one_b, device="cpu", family="UnifiedVAE"),
                      P.UnifiedVAE)
    with pytest.raises(ValueError, match="curvature"):
        model_from_state_dict(sd, device="cpu", manifold_curvature=2.0)


@pytest.mark.parametrize("family", ["GyroplaneVAE", "HyperbolicImageVAE"])
def test_fault_biasless_geoopt_gyroplanes_load(family):
    """geoopt's gyroplane layer stores ``points`` only: the flagship's and
    experiment 5's reference checkpoints once failed with "Missing
    key(s)". The missing bias is zero, the reference's forward."""
    ref, sd, _, _, shape = _reference(family, seed=17)
    assert "decoder.0.points" in sd and "decoder.0.bias" not in sd
    model = model_from_state_dict(sd, device="cpu", data_shape=shape,
                                  **({"loss_recon": "mse"} if family != "GyroplaneVAE" else {}))
    assert type(model).__name__ == family
    assert not model.state_dict()["decoder.0.bias"].any()
    z = torch.from_numpy(np.random.default_rng(5).uniform(-0.4, 0.4, (3, 2)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(model.decoder[0](z).numpy(), ref.decoder[0](z).numpy(), **TOL)


def test_fault_lightning_ckpt_loads_and_serves(tmp_path):
    """``load_state_dict_file`` once failed on a Lightning ``.ckpt``
    ("'dict' object has no attribute 'float'"); now it, the family
    detection and ``serve_http --state-dict`` take one, geoopt's entries
    and bias-less layer included."""
    from hyperbolic_vae_tpu_torch.serve_http import load_engines, parse_args

    ref, sd, _, _, _ = _reference("GyroplaneVAE", seed=18)
    sd["manifold.k"] = np.asarray(-1.0, np.float32)
    sd["decoder.0.ball.k"] = np.asarray([-1.0], np.float32)
    path = _lightning(tmp_path, "model.", sd)
    loaded = load_state_dict_file(path)
    assert sorted(loaded) == sorted(sd)
    model = model_from_state_dict(loaded, device="cpu")
    assert isinstance(model, P.GyroplaneVAE)
    served = load_engines(parse_args(["--state-dict", str(path), "--batch-size", "8"]),
                          device="cpu")["default"]
    _assert_same(served.model.state_dict(), model.state_dict())
    x = np.random.default_rng(6).random((5, 28, 28, 1), np.float32)
    with torch.no_grad():
        want = ref.encode(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(served.embed(x), want, **TOL)


def test_ckpt_hyper_parameters_configure_serving(tmp_path):
    """``serve_http --state-dict`` reads what a ``.ckpt``'s
    hyper_parameters hold and its state_dict does not: experiment 5's
    c = 1.4 and its (C, H, W) data shape, against geoopt's own ``k``
    entries; ``--model-config`` takes precedence over them."""
    from hyperbolic_vae_tpu_torch.serve_http import load_engines, parse_args

    ref = _seeded(_TorchHImage(c=1.4), 19)
    sd = _np_sd(ref)
    sd["manifold.k"] = np.asarray(-1.4, np.float32)
    sd["decoder.0.ball.k"] = np.asarray([-1.4], np.float32)
    path = _lightning(tmp_path, "model.", sd, hyper_parameters={
        "data_shape": [1, 16, 16], "manifold_curvature": 1.4, "loss_recon": "mse"})
    served = load_engines(parse_args(["--state-dict", str(path), "--batch-size", "8"]),
                          device="cpu")["default"]
    assert isinstance(served.model, P.HyperbolicImageVAE)
    assert served.model.manifold_curvature == 1.4 and served.model.data_shape == (16, 16, 1)
    x = np.random.default_rng(7).random((5, 16, 16, 1), np.float32)
    with torch.no_grad():
        want = ref.encode(_nchw(x))[0].numpy()
    np.testing.assert_allclose(served.embed(x), want, **TOL)
    with pytest.raises(ValueError, match="curvature"):
        load_engines(parse_args(["--state-dict", str(path), "--model-config",
                                 '{"manifold_curvature": 2.0}']), device="cpu")
