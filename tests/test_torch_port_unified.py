"""UnifiedVAE in the port against the JAX package, on the CPU, and the
interop's explicit families.

  * ``UnifiedVAE`` over a parametrised set of options (each KL estimator,
    each reconstruction method with a compatible last activation, both
    posterior-scale modes, both geometries, both activations, flat and
    image inputs; experiment 8's configuration first) at 8 x 8 images or
    64 features, hidden 16, batch 4, from parameters in JAX's tree
    (``test_torch_port_conv_models._init``) carried across by
    ``state_dict_from_jax_params``: JAX's own ``loss``, ``iwae`` and
    ``generate`` run with the port's standard-normal draws injected
    (``test_torch_port_pvae._jax_draws``): encode and decode within 1e-5
    of each output's largest, the losses rtol 2e-5 (the KL also 1e-6 a
    term), gradients within 1e-4 of each tensor's largest, the per-sample
    bound rtol 2e-5, generate within 1e-5 of its largest; the state_dict
    conversion equal to JAX's ``export_torch_state_dict`` bit for bit;
    five Riemannian Adam steps on the ball within rtol 5e-3 / atol 3e-4 of
    JAX's, all but 1 % of the elements within rtol 1e-4 / atol 1e-6;
  * trees and state_dicts whose keys fit two families raise without
    ``model=`` / ``family=`` and resolve with it; the five families read
    before still resolve by their keys;
  * a UnifiedVAE served from a state_dict (its family named) and from a
    checkpoint.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.interop.torch_export import export_torch_state_dict
from hyperbolic_vae_tpu.models import Autoencoder as JaxAE
from hyperbolic_vae_tpu.models import EuclideanVAE as JaxEuclidean
from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxGyroplane
from hyperbolic_vae_tpu.models import HyperbolicImageVAE as JaxHyp
from hyperbolic_vae_tpu.models import PvaeMLPVAE as JaxPvae
from hyperbolic_vae_tpu.models import RNASeqVAE as JaxRNASeq
from hyperbolic_vae_tpu.models import UnifiedVAE as JaxUnified
from hyperbolic_vae_tpu.optim import riemannian_adam
from hyperbolic_vae_tpu_torch.interop import model_from_state_dict, state_dict_from_jax_params
from hyperbolic_vae_tpu_torch.models import (
    Autoencoder,
    EuclideanVAE,
    GyroplaneVAE,
    HyperbolicImageVAE,
    PvaeMLPVAE,
    RNASeqVAE,
    UnifiedVAE,
    VAE,
)
from hyperbolic_vae_tpu_torch.optim import RiemannianAdam
from test_torch_port_conv_models import _init
from test_torch_port_pvae import _close, _jax_draws, _t

IMAGE, FLAT, H, L, B, K, N = (8, 8, 1), (64,), 16, 2, 4, 6, 3

# (input, latent_curvature, posterior_scale, kl_loss_method, loss_recon_method,
#  last_activation, activation, prior_scale, beta)
CASES = [
    (FLAT, 1.0, "learned", "logmap0_analytic", "MSE", "sigmoid", "gelu", 2.0, 0.5),  # exp. 8
    (IMAGE, 1.0, "learned", "log_prob", "relaxed bernoulli", "none", "gelu", 1.0, 1.0),
    (IMAGE, 1.0, "fixed", "logmap0_log_prob", "binary_cross_entropy", "sigmoid", "relu", 1.0,
     1.0),
    (FLAT, None, "learned", "log_prob", "binary_cross_entropy_with_logits", "none", "relu", 1.5,
     1.0),
    (IMAGE, None, "fixed", "logmap0_analytic", "relaxed bernoulli", "sigmoid", "gelu", 1.0, 2.0),
    (FLAT, None, "learned", "logmap0_log_prob", "MSE", "softplus", "gelu", 1.0, 1.0),
]


def _kw(case):
    shape, c, scale, kl, recon, last, act, prior, beta = case
    return dict(input_size=shape, hidden_layer_dim=H, latent_dim=L, latent_curvature=c,
                posterior_scale=scale, kl_loss_method=kl, loss_recon_method=recon,
                last_activation=last, activation=act, prior_scale=prior, beta=beta)


def _unified(case, seed=0):
    kw = _kw(case)
    jm = JaxUnified(**kw)
    params = _init(jm, kw["input_size"], seed=seed)
    model = UnifiedVAE(**kw, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, model))
    return jm, params, model


def _data(shape, seed=0, b=B):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (b,) + shape).astype(np.float32)


def _eps(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_loss(jm):
    def run(params, x, eps):
        with _jax_draws(normals=[eps]):
            def f(p):
                out = jm.apply({"params": p}, x, method="loss",
                               rngs={"sample": jax.random.PRNGKey(0)})
                return out["loss_total"], out
            (_, out), grads = jax.value_and_grad(f, has_aux=True)(params)
        return out, grads
    return run


@pytest.mark.parametrize("case", CASES, ids=[f"{c[3]}-{c[4]}-{c[5]}-{c[1]}-{c[2]}" for c in CASES])
def test_unified_vae_equals_jax(case):
    jm, params, model = _unified(case)
    shape = case[0]
    x, eps, eps_k, eps_g = _data(shape), _eps(1, B, L), _eps(2, K, B, L), _eps(3, N, L)

    def reference(params, x, eps, eps_k, eps_g):
        v, rngs = {"params": params}, {"sample": jax.random.PRNGKey(0)}
        out, grads = _jax_loss(jm)(params, x, eps)
        mu, scale = jm.apply(v, x, method="encode")
        with _jax_draws(normals=[eps_k]):
            bound = jm.apply(v, x, K, method="iwae", rngs=rngs)
        with _jax_draws(normals=[eps_g]):
            gen = jm.apply(v, N, method="generate", rngs=rngs)
        return out, grads, mu, scale, jm.apply(v, mu, method="decode"), bound, gen

    want, jg, mu_j, sc_j, xh_j, bound_j, gen_j = jax.jit(reference)(
        params, *map(jnp.asarray, (x, eps, eps_k, eps_g)))
    with torch.no_grad():
        mu, sc = model.encode(_t(x))
        xh = model.decode(_t(mu_j))
        bound = model.iwae_from_eps(_t(x), _t(eps_k))
        gen = model.generate_from_eps(_t(eps_g))
    _close(mu, mu_j, 1e-5, "mu")
    _close(sc, sc_j, 1e-5, "scale")
    assert xh.shape == (B,) + shape and gen.shape == (N,) + shape
    _close(xh, xh_j, 1e-5, "decode")
    _close(gen, gen_j, 1e-5, "generate")
    np.testing.assert_allclose(bound.numpy(), np.asarray(bound_j), rtol=2e-5)
    got = model.loss_from_eps(_t(x), _t(eps))
    assert set(got) == set(want) == {"loss_total", "loss_reconstruction", "loss_kl"}
    for k_ in want:
        np.testing.assert_allclose(float(got[k_].detach()), float(want[k_]), rtol=2e-5,
                                   atol=1e-6 * B * L if "kl" in k_ else 0.0, err_msg=k_)
    got["loss_total"].backward()
    want_g = state_dict_from_jax_params(jax.tree.map(np.asarray, jg), model)
    for name, p in model.named_parameters():
        _close(p.grad, want_g[name], 1e-4, f"grad {name}")
    # the state_dict conversion is JAX's exporter's, bit for bit
    ref = export_torch_state_dict(jm, params)
    sd = state_dict_from_jax_params(params, model)
    assert set(sd) == set(ref) == set(model.state_dict())
    for k_, v in ref.items():
        np.testing.assert_array_equal(sd[k_].numpy(), v, err_msg=k_)
    # the generator paths draw what the _from_eps forms take
    torch.testing.assert_close(model.loss(_t(x), torch.Generator().manual_seed(4))["loss_total"],
                               model.loss_from_eps(_t(x), torch.randn(
                                   (B, L), generator=torch.Generator().manual_seed(4)))[
                                   "loss_total"], rtol=0, atol=0)
    assert model.loss_reduction == "per_sample_mean" and VAE is UnifiedVAE
    assert (model.ball is None) == (case[1] is None)
    rec = model.reconstruct(_t(x), torch.Generator().manual_seed(0))
    assert rec.shape == (B,) + shape and bool(torch.isfinite(rec).all())


def test_unified_riemannian_adam_steps_equal_jax():
    """Five steps on the ball (the gyroplane points on the manifold path)
    from the same weights, batches and draws."""
    jm, params, model = _unified(CASES[1])
    opt = riemannian_adam(learning_rate=1e-3, ball=jm.ball)
    state, update = opt.init(params), jax.jit(opt.update)
    topt = RiemannianAdam(model.parameters(), lr=1e-3, ball=model.ball)
    step = jax.jit(_jax_loss(jm))
    p = jax.tree.map(jnp.asarray, params)
    for i in range(5):
        x, eps = _data(IMAGE, 10 + i), _eps(20 + i, B, L)
        _, g = step(p, jnp.asarray(x), jnp.asarray(eps))
        upd, state = update(g, state, p)
        p = jax.tree.map(lambda a, b: a + b, p, upd)
        topt.zero_grad()
        model.loss_from_eps(_t(x), _t(eps))["loss_total"].backward()
        topt.step()
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, p), model)
    outside = total = 0
    for name, q in model.named_parameters():
        got = q.detach().numpy()
        np.testing.assert_allclose(got, want[name].numpy(), rtol=5e-3, atol=3e-4, err_msg=name)
        outside += int((~np.isclose(got, want[name].numpy(), rtol=1e-4, atol=1e-6)).sum())
        total += got.size
    assert outside <= 0.01 * total, (outside, total)


# ---- the interop's explicit families ----------------------------------------------


def test_ambiguous_trees_and_state_dicts_need_their_family():
    # a Euclidean UnifiedVAE's tree is a linear-decoder PvaeMLPVAE's too
    _, params, model = _unified((IMAGE, None, "learned", "log_prob", "MSE", "none", "gelu", 1.0,
                                 1.0))
    with pytest.raises(ValueError, match="UnifiedVAE.*PvaeMLPVAE"):
        state_dict_from_jax_params(params)
    assert state_dict_from_jax_params(params, model).keys() == model.state_dict().keys()
    pv = PvaeMLPVAE(IMAGE, H, L, decoder_first="linear", device="cpu")
    pv_sd = state_dict_from_jax_params(params, "PvaeMLPVAE")
    assert pv_sd.keys() == pv.state_dict().keys()
    # ... and so are their state_dicts (encoder.1, mu.0, scale.0, decoder.0.weight, decoder.2)
    sd = model.state_dict()
    with pytest.raises(ValueError, match="UnifiedVAE.*PvaeMLPVAE"):
        model_from_state_dict(sd, device="cpu")
    got = model_from_state_dict(sd, device="cpu", family="UnifiedVAE", data_shape=IMAGE,
                                kl_loss_method="log_prob")
    assert isinstance(got, UnifiedVAE) and got.hparams() == model.hparams()
    got = model_from_state_dict(pv.state_dict(), device="cpu", family="PvaeMLPVAE",
                                data_shape=IMAGE)
    assert isinstance(got, PvaeMLPVAE) and got.hparams() == pv.hparams()
    # a UnifiedVAE on a flat input with a ball stores what an RNASeqVAE stores
    _, params, model = _unified(CASES[0])
    sd = model.state_dict()
    with pytest.raises(ValueError, match="RNASeqVAE.*UnifiedVAE"):
        model_from_state_dict(sd, device="cpu")
    got = model_from_state_dict(sd, device="cpu", family="UnifiedVAE", prior_scale=2.0, beta=0.5,
                                last_activation="sigmoid")
    assert isinstance(got, UnifiedVAE) and got.hparams() == model.hparams()
    rna = model_from_state_dict(sd, device="cpu", family="RNASeqVAE")
    assert isinstance(rna, RNASeqVAE) and (rna.in_features, rna.hidden_dim) == (64, H)
    # its tree keeps the RNASeqVAE reading, the same layout as UnifiedVAE's on a flat input
    assert {k: v.tolist() for k, v in state_dict_from_jax_params(params).items()} == {
        k: v.tolist() for k, v in export_torch_state_dict(JaxUnified(**_kw(CASES[0])),
                                                          params).items()}
    # a fixed posterior scale tells a UnifiedVAE: no other family has none
    _, params, model = _unified(CASES[2])
    assert state_dict_from_jax_params(params, model).keys() == model.state_dict().keys()
    assert isinstance(model_from_state_dict(model.state_dict(), device="cpu", data_shape=IMAGE),
                      UnifiedVAE)
    # a geodesic PvaeMLPVAE needs no name, as a tree or as a state_dict
    jp = JaxPvae(data_shape=IMAGE, hidden_dim=H, latent_dim=L, posterior="riemannian")
    pp = _init(jp, IMAGE)
    psd = state_dict_from_jax_params(pp)
    got = model_from_state_dict(psd, device="cpu", data_shape=IMAGE)
    assert isinstance(got, PvaeMLPVAE) and got.posterior == "riemannian"
    with pytest.raises(ValueError, match="no parameter mapping"):
        state_dict_from_jax_params(pp, model="NoSuchVAE")


@pytest.mark.parametrize("family", ["gyroplane", "rnaseq", "hyperbolic", "euclidean",
                                    "autoencoder"])
def test_the_five_earlier_families_still_resolve_by_their_keys(family):
    if family == "gyroplane":
        jm, shape, cls = JaxGyroplane(), (28, 28, 1), GyroplaneVAE
    elif family == "rnaseq":
        jm, shape, cls = JaxRNASeq(in_features=64, hidden_dim=H), (64,), None
    elif family == "hyperbolic":
        jm, shape, cls = JaxHyp(data_shape=(16, 16, 1), base_channels=4), (16, 16, 1), (
            HyperbolicImageVAE)
    elif family == "euclidean":
        jm, shape, cls = JaxEuclidean(data_shape=(16, 16, 3), hidden_size=4), (16, 16, 3), (
            EuclideanVAE)
    else:
        jm, shape, cls = JaxAE(data_shape=(16, 16, 3), base_channel_size=4, latent_dim=8), (
            16, 16, 3), Autoencoder
    params = _init(jm, shape)
    sd = state_dict_from_jax_params(params)
    if cls is None:  # an RNASeqVAE's state_dict is read through its checkpoint or family
        model = RNASeqVAE(64, H, device="cpu")
        model.load_state_dict(sd)
        assert isinstance(model_from_state_dict(sd, device="cpu", family="RNASeqVAE"), RNASeqVAE)
        return
    model = model_from_state_dict(sd, device="cpu", data_shape=shape)
    assert type(model) is cls and model.state_dict().keys() == sd.keys()


# ---- serving ----------------------------------------------------------------------


def test_unified_serves_from_state_dict_and_checkpoint(tmp_path):
    from hyperbolic_vae_tpu_torch.data import make_rnaseq_data_module
    from hyperbolic_vae_tpu_torch.serve import Inferencer
    from hyperbolic_vae_tpu_torch.serve_http import InferenceServer, load_engines, parse_args
    from hyperbolic_vae_tpu_torch.train import Trainer

    dm = make_rnaseq_data_module(batch_size=16, fake=True, n_samples=200, n_genes=64)
    model = UnifiedVAE((64,), H, L, prior_scale=2.0, beta=0.5, last_activation="sigmoid",
                       generator=torch.Generator().manual_seed(0), device="cpu")
    res = Trainer(model, max_epochs=2, epochs_per_dispatch=2, checkpoint_dir=str(tmp_path / "ck"),
                  device="cpu").fit(dm)
    inf = Inferencer.from_checkpoint(str(tmp_path / "ck"), "best", batch_size=8, device="cpu")
    assert inf.model.hparams() == model.hparams()
    assert all(torch.equal(inf.model.state_dict()[k], v) for k, v in res.best_params.items())
    x = np.ascontiguousarray(dm.x_test[:13])
    with torch.no_grad():
        m = inf.model
        want = torch.cat([m.decode(m.posterior_mean(_t(x[:8]))),
                          m.decode(m.posterior_mean(_t(np.concatenate([x[8:], x[:3]]))))[:5]])
    np.testing.assert_array_equal(inf.reconstruct(x), want.numpy())
    g = inf.generate(11, seed=3)
    assert g.shape == (11, 64) and np.all((g > 0) & (g < 1))
    np.testing.assert_array_equal(g, inf.generate(11, seed=3))
    # a state_dict file, its family named (an RNASeqVAE's keys too)
    path = tmp_path / "unified.npz"
    np.savez(path, **{k: v.numpy() for k, v in inf.model.state_dict().items()})
    cfg = {"family": "UnifiedVAE", "prior_scale": 2.0, "beta": 0.5, "last_activation": "sigmoid"}
    served = load_engines(parse_args(["--state-dict", str(path), "--batch-size", "8",
                                      "--model-config", json.dumps(cfg)]), device="cpu")["default"]
    assert served.model.hparams() == model.hparams()
    np.testing.assert_array_equal(served.reconstruct(x), want.numpy())
    np.testing.assert_array_equal(served.generate(11, seed=3), g)
    server = InferenceServer(served, host="127.0.0.1", port=0).start()
    try:
        import urllib.request

        req = urllib.request.Request(
            f"http://{server.host}:{server.port}/v1/embed",
            data=json.dumps({"data": x.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            emb = np.asarray(json.loads(r.read())["outputs"][0], np.float32)
    finally:
        server.shutdown()
    np.testing.assert_array_equal(emb, inf.embed(x))
    assert emb.shape == (13, L) and np.linalg.norm(emb, axis=-1).max() < 1.0
