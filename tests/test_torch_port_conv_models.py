"""The conv image families of the port against the JAX package, on the CPU.

``HyperbolicImageVAE`` (every encoder head and decoder first layer, the
three loss modes, c in {1, 1.4}), ``EuclideanVAE`` and ``Autoencoder`` at
16 x 16 images, base width 4, batch 4, from parameters in JAX's tree
(drawn from the distributions of its init: ``_init``) carried across by
``state_dict_from_jax_params`` and the same
standard-normal draws. JAX's loss and bound are built from its own pieces
(``encode``, ``wrapped_normal_rsample_from_eps``, ``decode``, its
densities) on the injected draws, under ``jax.jit`` (eager JAX compiles
each op at each new shape, which costs more than one compile a case). Tolerances: encoder and decoder outputs
within 1e-5 of each output's largest magnitude; the losses and the
bound rtol 2e-5; each gradient within 1e-4 of its largest magnitude;
bf16 compute within JAX's own rule against f32, relative 0.1
(``tests/test_models.py``), and against JAX's bf16 model: the manifold
layers and the loss on the same inputs by the f32 rules, the bf16 conv
stacks within 5e-2 of their largest output; five Riemannian Adam steps of experiment 5's
configuration within rtol 5e-3 / atol 3e-4 of JAX's (Adam's normalised
step; ``chip_smoke.py``'s element rule), all but 1 % of the elements
within rtol 1e-4 / atol 1e-6. The state_dict
conversion equals JAX's ``export_torch_state_dict`` bit for bit at
``base_channels=16``; at 4 that exporter fails (it hard-codes 32
flattened channels), and the port's conversion is held by the forward
equality instead.
"""

import jax
import jax.numpy as jnp
from flax import linen as fnn
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.distributions import relaxed_bernoulli_log_prob as jax_rb
from hyperbolic_vae_tpu.distributions import wrapped_normal_log_prob as jax_wn_log_prob
from hyperbolic_vae_tpu.distributions import wrapped_normal_rsample_from_eps as jax_rsample
from hyperbolic_vae_tpu.distributions.normal import kl_std_normal_from_logvar as jax_kl
from hyperbolic_vae_tpu.distributions.normal import normal_log_prob as jax_normal_log_prob
from hyperbolic_vae_tpu.interop.torch_export import export_torch_state_dict
from hyperbolic_vae_tpu.models import Autoencoder as JaxAE
from hyperbolic_vae_tpu.models import EuclideanVAE as JaxEuclidean
from hyperbolic_vae_tpu.models import HyperbolicImageVAE as JaxHyp
from hyperbolic_vae_tpu.models.iwae import gaussian_loglik as jax_gaussian_loglik
from hyperbolic_vae_tpu.models.iwae import iwae_bound as jax_iwae_bound
from hyperbolic_vae_tpu.optim import riemannian_adam
from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params
from hyperbolic_vae_tpu_torch.models import Autoencoder, EuclideanVAE, HyperbolicImageVAE
from hyperbolic_vae_tpu_torch.nn import ManifoldParameter
from hyperbolic_vae_tpu_torch.optim import RiemannianAdam
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

S, M, B, K, L = 16, 4, 4, 6, 2

# each encoder head, each decoder first layer and each loss mode at least
# once (the encoder's head and the decoder's first layer share no code, so
# their cross product adds none), at experiment 5's c = 1.4 and at c = 1;
# experiment 5's own configuration first
HYP_CASES = [
    ("mobius", "geoopt_gyroplane", "mse", 1.4),
    ("linear", "linear", "mse", 1.4),
    ("mobius", "mobius", "bernoulli", 1.4),
    ("linear", "geodesic", "bernoulli_elbo", 1.0),
    ("linear", "geoopt_gyroplane", "bernoulli_elbo", 1.0),
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _images(channels, seed=0, lo=0.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, 1.0, (B, S, S, channels)).astype(np.float32)


def _expmap0(u, c):
    n = np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-15)
    return (np.tanh(np.sqrt(c) * n) * u / (np.sqrt(c) * n) * (1.0 - 4e-3)).astype(np.float32)


def _init(jm, shape, seed=0):
    """Parameters in JAX's tree for ``jm`` (its shapes from
    ``jax.eval_shape``, which compiles nothing), drawn in numpy from the
    distributions of JAX's init: lecun-normal kernels, kaiming (a = sqrt 5)
    Riemannian weights, U(+-4/sqrt(in)) scalar biases, gyroplane points
    expmap0(N(0, 1)), gyroplane biases U(-1, 1); but biases N(0, 0.1)
    where JAX's are zero, so that a misplaced bias shows."""
    c = getattr(jm, "manifold_curvature", 1.0)
    keys = {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(seed + 1)}
    tree = jax.eval_shape(jm.init, keys, jnp.zeros((2,) + shape))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shp = str(path[-1].key), leaf.shape
        if name == "kernel":
            return rng.normal(0.0, np.sqrt(1.0 / np.prod(shp[:-1])), shp)
        if name == "weight_t0":
            return rng.normal(0.0, np.sqrt(1.0 / 3.0 / shp[-1]), shp)
        if name == "bias_scalar":
            return rng.uniform(-4.0, 4.0, shp) / np.sqrt(shp[0])
        if name == "mp_bias":
            return _expmap0(rng.uniform(-4.0, 4.0, shp) / np.sqrt(shp[-1]), c)
        if name == "mp_points":
            d = rng.normal(size=shp)
            return _expmap0(d / np.linalg.norm(d, axis=-1, keepdims=True)
                            * rng.normal(size=shp[:-1] + (1,)), c)
        if "mp_points" in str(path):  # never: the gyroplane bias is keyed below
            raise AssertionError(path)
        return rng.normal(0.0, 0.1, shp)

    params = jax.tree_util.tree_map_with_path(draw, tree)
    if "dec_first" in params and "mp_points" in params["dec_first"]:
        params["dec_first"]["bias"] = rng.uniform(-1.0, 1.0, tree["dec_first"]["bias"].shape)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _hyp(enc, dec, loss_recon, c, dtype="float32", base=M):
    kw = dict(data_shape=(S, S, 1), latent_dim=L, manifold_curvature=c,
              encoder_last_layer_module=enc, decoder_first_layer_module=dec,
              loss_recon=loss_recon, compute_dtype=dtype, base_channels=base)
    jm = JaxHyp(**kw)
    params = _init(jm, (S, S, 1))
    model = HyperbolicImageVAE(**kw, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, model))
    return jm, params, model


def _hyp_loss_parts(jm, x, mu, scale, z, xh):
    """JAX's loss terms from the posterior (mu, scale), its draw z and the
    decoded z, by JAX's densities and reductions."""
    ball, lr = jm.ball, jm.loss_recon
    kl = (jax_wn_log_prob(ball, mu, scale, z)
          - jax_wn_log_prob(ball, jnp.zeros((L,)), jnp.ones((L,)), z))
    b = x.shape[0]
    loss_kl = jnp.sum(kl)
    if lr == "mse":
        rec = jnp.sum((xh - x) ** 2)
    else:
        lp = jax_rb(x.reshape(b, -1), 0.1, logits=xh.reshape(b, -1))
        rec = -jnp.mean(lp) if lr == "bernoulli" else -jnp.mean(jnp.sum(lp, axis=-1))
        if lr == "bernoulli_elbo":
            loss_kl = jnp.mean(kl)
    sq = (xh - x) ** 2
    mse = jnp.mean(jnp.sum(sq.reshape(b, -1), -1)) if lr == "bernoulli_elbo" else jnp.sum(sq)
    return {"loss_total": rec + jm.beta * loss_kl, "loss_recon": rec, "loss_kl": loss_kl,
            "mse": mse}


def _hyp_loss(jm):
    """JAX's loss from its own pieces on an injected draw: (loss_total,
    (the metric dict, mu, scale, z, decode(z)))."""

    def loss(params, x, eps):
        mu, scale = jm.apply({"params": params}, x, method="encode")
        z = jax_rsample(jm.ball, mu, scale, eps)
        xh = jm.apply({"params": params}, z, method="decode")
        metrics = _hyp_loss_parts(jm, x, mu, scale, z, xh)
        return metrics["loss_total"], (metrics, mu, scale, z, xh)

    return loss


def _hyp_bound(jm, params, x, eps):
    """JAX's bound from its own pieces on an injected draw (K, B, latent)."""
    ball, k, b = jm.ball, eps.shape[0], x.shape[0]
    mu, scale = jm.apply({"params": params}, x, method="encode")
    z = jax_rsample(ball, mu, scale, eps)
    log_q = jax_wn_log_prob(ball, mu, scale, z)
    log_p = jax_wn_log_prob(ball, jnp.zeros((L,)), jnp.ones((L,)), z)
    xh = jm.apply({"params": params}, z.reshape(-1, L), method="decode").reshape(k, b, -1)
    xf = x.reshape(b, -1)
    if jm.loss_recon == "mse":
        lpx = jax_gaussian_loglik(xf, xh)
    else:
        lpx = jnp.sum(jax_rb(xf[None], 0.1, logits=xh), axis=-1)
    return jax_iwae_bound(lpx + log_p - log_q)


def _draws(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L)).astype(np.float32),
            rng.normal(size=(K, B, L)).astype(np.float32))


def _losses_close(got, want):
    """Each loss entry rtol 2e-5; a KL entry also within 1e-6 a term (at
    the init's small posterior means the KL is a sum of O(1) terms that
    cancel to ~1e-3, so its f32 rounding is absolute)."""
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=2e-5,
                                   atol=1e-6 * B * L if "kl" in key else 0.0, err_msg=key)


@pytest.mark.parametrize("enc,dec,loss_recon,c", HYP_CASES)
def test_hyperbolic_image_vae_equals_jax(enc, dec, loss_recon, c):
    """encode, decode, loss_from_eps, its gradients and iwae_from_eps."""
    jm, params, model = _hyp(enc, dec, loss_recon, c)
    x = _images(1)
    eps, eps_k = _draws()

    def reference(params, x, eps, eps_k):
        (_, aux), grads = jax.value_and_grad(_hyp_loss(jm), has_aux=True)(params, x, eps)
        return aux, grads, _hyp_bound(jm, params, x, eps_k)

    (want, mu_j, sc_j, z, xh_j), jg, want_b = jax.jit(reference)(
        params, *map(jnp.asarray, (x, eps, eps_k)))
    with torch.no_grad():
        mu, sc = model.encode(_t(x))
        xh = model.decode(_t(z))
        bound = model.iwae_from_eps(_t(x), _t(eps_k))
    _close(mu, mu_j, 1e-5, "mu")
    _close(sc, sc_j, 1e-5, "scale")
    assert xh.shape == (B, S, S, 1) and xh.dtype == torch.float32
    _close(xh, xh_j, 1e-5, "decode")
    got = model.loss_from_eps(_t(x), _t(eps))
    _losses_close(got, want)
    np.testing.assert_allclose(bound.numpy(), np.asarray(want_b), rtol=2e-5)
    want_g = state_dict_from_jax_params(jax.tree.map(np.asarray, jg), model)
    got["loss_total"].backward()
    for name, p in model.named_parameters():
        _close(p.grad, want_g[name], 1e-4, f"grad {name}")
    assert model.loss_reduction == ("per_sample_mean" if loss_recon == "bernoulli_elbo"
                                    else "batch_sum")


@pytest.mark.parametrize("family", ["hyperbolic", "euclidean", "autoencoder"])
def test_bf16_compute_within_jax_rule(family):
    """bf16 conv stacks (the manifold layers and the loss in f32): finite
    gradients, f32 parameters, and the loss within 0.1 of JAX's f32 loss
    on the same weights and draws (JAX's own bf16 rule)."""
    x = _images(1 if family == "hyperbolic" else 3, lo=0.0 if family == "hyperbolic" else -1.0)
    eps, _ = _draws()
    if family == "hyperbolic":
        jm, params, model = _hyp("mobius", "geoopt_gyroplane", "mse", 1.4)
        want = float(jax.jit(_hyp_loss(jm))(params, jnp.asarray(x), jnp.asarray(eps))[0])
    else:
        jm, params, model = _euclidean_or_ae(family)
        want = float(jax.jit(_eu_ae_loss(jm, family))(params, jnp.asarray(x),
                                                      jnp.asarray(eps))["loss_total"])
    model.compute_dtype, model._compute = "bfloat16", torch.bfloat16
    got = (model.loss_from_eps(_t(x), _t(eps)) if family != "autoencoder"
           else model.loss(_t(x)))["loss_total"]
    got.backward()
    assert all(p.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in model.parameters())
    assert float(got) != want and abs(float(got) - want) / abs(want) < 0.1, (float(got), want)


def _chw_to_hwc(a, channels):
    """(B, C*H*W) in the port's order -> (B, H*W*C), JAX's."""
    a = np.asarray(a)
    return a.reshape(B, channels, S // 8, S // 8).transpose(0, 2, 3, 1).reshape(B, -1)


@pytest.mark.parametrize("enc,dec,loss_recon,c", [HYP_CASES[0], HYP_CASES[3]])
def test_bf16_keeps_manifold_layers_and_loss_in_f32_as_jax(enc, dec, loss_recon, c):
    """``compute_dtype="bfloat16"`` against JAX's bf16 model on the same
    weights and draws. The encoder's head and the decoder's first layer
    take f32 inputs and, on the port's own bf16-stack features and on z,
    equal JAX's layers within 1e-5 of their largest output (a head run in
    bf16 lands ~4e-3 off); the loss, from the port's posterior, draw and
    decode, equals JAX's densities and reductions on the same pieces (the
    f32 rule). The bf16 conv stacks themselves round in another order
    (XLA's against oneDNN's convolutions): the encoder's features and the
    decoded images within 5e-2 of their largest magnitude (readings over
    12 draws in 4 configurations: up to 1.3e-2)."""
    jm, params, model = _hyp(enc, dec, loss_recon, c, dtype="bfloat16")
    x = _images(1)
    eps, _ = _draws()
    seen = {}
    for name, layer in (("head", model.mu), ("dec_first", model.decoder[0])):
        layer.register_forward_hook(
            lambda mod, inp, out, name=name: seen.__setitem__(name, (inp[0], out)))
    with torch.no_grad():
        got = model.loss_from_eps(_t(x), _t(eps))
        mu, sc = model.encode(_t(x))
        z = jax_rsample(jm.ball, jnp.asarray(mu.numpy()), jnp.asarray(sc.numpy()),
                        jnp.asarray(eps))
        xh = model.decode(_t(z))
    assert all(t.dtype == torch.float32 for pair in seen.values() for t in pair)
    (h, head), (zin, first) = seen["head"], seen["dec_first"]
    np.testing.assert_array_equal(zin.numpy(), np.asarray(z))

    def features(m, a):
        a = fnn.gelu(m.conv1(a.astype(jnp.bfloat16)))
        return fnn.gelu(m.conv3(fnn.gelu(m.conv2(a)))).reshape(B, -1).astype(jnp.float32)

    @jax.jit
    def reference(params, x, h, z, mu, sc, xh):
        v = {"params": params}
        return (jm.apply(v, h, method=lambda m, a: m.mu_head(a)),
                jm.apply(v, z, method=lambda m, a: m.dec_first(a)),
                _hyp_loss_parts(jm, x, mu, sc, z, xh),
                jm.apply(v, x, method=features), jm.apply(v, z, method="decode"))

    ch = 2 * M
    head_j, first_j, want, features_j, xh_j = reference(
        params, *map(jnp.asarray, (x, _chw_to_hwc(h, ch), z, mu.numpy(), sc.numpy(), xh.numpy())))
    _close(head, head_j, 1e-5, "head on the same features")
    _close(_chw_to_hwc(first, ch), first_j, 1e-5, "decoder's first layer on the same z")
    _losses_close(got, want)
    _close(_chw_to_hwc(h, ch), features_j, 5e-2, "features")
    _close(xh, xh_j, 5e-2, "decode")


# ---- EuclideanVAE and Autoencoder -------------------------------------------


def _euclidean_or_ae(family, dtype="float32", width=M):
    shape = (S, S, 3)
    if family == "euclidean":
        jm = JaxEuclidean(data_shape=shape, hidden_size=width, latent_dim=L, compute_dtype=dtype)
        model = EuclideanVAE(shape, hidden_size=width, latent_dim=L, compute_dtype=dtype,
                             device="cpu")
    else:
        jm = JaxAE(data_shape=shape, base_channel_size=width, latent_dim=8, compute_dtype=dtype)
        model = Autoencoder(shape, base_channel_size=width, latent_dim=8, compute_dtype=dtype,
                            device="cpu")
    params = _init(jm, shape, seed=3)
    model.load_state_dict(state_dict_from_jax_params(params))
    return jm, params, model


def _eu_ae_loss(jm, family):
    """JAX's loss from its own pieces on an injected draw."""

    def loss(params, x, eps):
        if family == "autoencoder":
            xh = jm.apply({"params": params}, jm.apply({"params": params}, x, method="encode"),
                          method="decode")
            per = jnp.mean(jnp.sum((xh - x) ** 2, axis=(1, 2, 3)))
            return {"loss_total": per, "loss_recon": per}
        mu, lv = jm.apply({"params": params}, x, method="encode")
        xh = jm.apply({"params": params}, mu + eps * jnp.exp(0.5 * lv), method="decode")
        rec, kld = jnp.sum((xh - x) ** 2), jnp.sum(jax_kl(mu, lv))
        return {"loss_total": rec + jm.beta * kld, "loss_recon": rec, "loss_kld": kld}

    return loss


@pytest.mark.parametrize("family", ["euclidean", "autoencoder"])
def test_euclidean_and_autoencoder_equal_jax(family):
    jm, params, model = _euclidean_or_ae(family)
    x = _images(3, lo=-1.0)
    eps, eps_k = _draws()
    jloss = _eu_ae_loss(jm, family)

    def reference(params, x, eps, eps_k):
        enc = jm.apply({"params": params}, x, method="encode")
        enc = enc if isinstance(enc, tuple) else (enc,)
        xh = jm.apply({"params": params}, enc[0], method="decode")
        want = jloss(params, x, eps)
        grads = jax.grad(lambda p: jloss(p, x, eps)["loss_total"])(params)
        if family == "autoencoder":
            return enc, xh, want, grads, None
        # the bound: diagonal-Gaussian posterior and prior, unit Gaussian
        # likelihood
        mu, lv = enc
        sc = jnp.exp(0.5 * lv)
        z = mu[None] + sc[None] * eps_k
        log_q = jnp.sum(jax_normal_log_prob(z, mu[None], sc[None]), -1)
        log_p = jnp.sum(jax_normal_log_prob(z, 0.0, 1.0), -1)
        xh_k = jm.apply({"params": params}, z.reshape(-1, L), method="decode").reshape(K, B, -1)
        return enc, xh, want, grads, jax_iwae_bound(
            jax_gaussian_loglik(x.reshape(B, -1), xh_k) + log_p - log_q)

    enc_j, xh_j, want, jg, want_b = jax.jit(reference)(params, *map(jnp.asarray, (x, eps, eps_k)))
    with torch.no_grad():
        enc = model.encode(_t(x))
        enc = enc if isinstance(enc, tuple) else (enc,)
        xh = model.decode(_t(np.asarray(enc_j[0])))
    for a, b_ in zip(enc, enc_j):
        _close(a, b_, 1e-5, "encode")
    assert xh.shape == (B, S, S, 3)
    _close(xh, xh_j, 1e-5, "decode")
    got = model.loss_from_eps(_t(x), _t(eps)) if family == "euclidean" else model.loss(_t(x))
    _losses_close(got, want)
    want_g = state_dict_from_jax_params(jax.tree.map(np.asarray, jg))
    got["loss_total"].backward()
    for name, p in model.named_parameters():
        _close(p.grad, want_g[name], 1e-4, f"grad {name}")
    if family == "autoencoder":
        assert not hasattr(model, "generate") and model.loss_reduction == "per_sample_mean"
        return
    with torch.no_grad():
        bound = model.iwae_from_eps(_t(x), _t(eps_k))
    np.testing.assert_allclose(bound.numpy(), np.asarray(want_b), rtol=2e-5)
    assert model.generate(3, torch.Generator().manual_seed(0)).shape == (3, S, S, 3)


# ---- the state_dict conversion -----------------------------------------------


@pytest.mark.parametrize("family", ["hyperbolic_gyroplane", "hyperbolic_mobius",
                                    "hyperbolic_geodesic", "hyperbolic_linear", "euclidean",
                                    "autoencoder"])
def test_conversion_equals_jax_exporter_at_base_16(family):
    """At the reference width (base 16: 32 flattened channels, the only
    width JAX's exporter handles for HyperbolicImageVAE) the port's
    conversion equals ``export_torch_state_dict`` bit for bit."""
    if family.startswith("hyperbolic"):
        dec = family.split("_", 1)[1]
        dec = "geoopt_gyroplane" if dec == "gyroplane" else dec
        kw = dict(data_shape=(S, S, 1), encoder_last_layer_module="linear" if dec == "linear"
                  else "mobius", decoder_first_layer_module=dec, base_channels=16)
        jm, model = JaxHyp(**kw), HyperbolicImageVAE(**kw, device="cpu")
    elif family == "euclidean":
        jm = JaxEuclidean(data_shape=(S, S, 3), hidden_size=16)
        model = EuclideanVAE((S, S, 3), hidden_size=16, device="cpu")
    else:
        jm = JaxAE(data_shape=(S, S, 3), base_channel_size=16, latent_dim=8)
        model = Autoencoder((S, S, 3), base_channel_size=16, latent_dim=8, device="cpu")
    params = _init(jm, model.data_shape)
    ref = export_torch_state_dict(jm, params)
    got = state_dict_from_jax_params(params, model)
    assert set(got) == set(ref) == set(model.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_jax_exporter_fails_below_base_16():
    """JAX's exporter hard-codes 32 flattened channels for
    HyperbolicImageVAE and always exports ``log_var`` (recorded
    differences): at base 4, and on a bernoulli mode's tree, it raises;
    the port's conversion carries such models across (its forward
    equality is ``test_hyperbolic_image_vae_equals_jax``)."""
    jm, params, model = _hyp("mobius", "geoopt_gyroplane", "mse", 1.4)
    with pytest.raises(IndexError):
        export_torch_state_dict(jm, params)
    sd = state_dict_from_jax_params(params, model)
    assert set(sd) == set(model.state_dict())
    assert state_dict_from_jax_params(params).keys() == sd.keys()  # square images by default
    # nor a bernoulli mode's tree (no log_var) at the reference width
    jm16 = JaxHyp(data_shape=(S, S, 1), loss_recon="bernoulli", base_channels=16)
    p16 = _init(jm16, (S, S, 1))
    with pytest.raises(KeyError):
        export_torch_state_dict(jm16, p16)
    m16 = HyperbolicImageVAE((S, S, 1), loss_recon="bernoulli", base_channels=16, device="cpu")
    m16.load_state_dict(state_dict_from_jax_params(p16, m16))


# ---- Riemannian Adam on experiment 5's configuration ------------------------


def test_five_riemannian_adam_steps_equal_jax():
    """Five steps of the loss's gradient and Riemannian Adam (lr 1e-3):
    the gyroplane points take the manifold path, the rest Adam, in both
    packages from the same weights, batches and draws."""
    jm, params, model = _hyp("mobius", "geoopt_gyroplane", "mse", 1.4)
    grad = jax.jit(jax.grad(lambda p, x, e: _hyp_loss(jm)(p, x, e)[0]))
    opt = riemannian_adam(learning_rate=1e-3, ball=jm.ball)
    state = opt.init(params)
    update = jax.jit(opt.update)
    topt = RiemannianAdam(model.parameters(), lr=1e-3, ball=model.ball)
    assert isinstance(model.decoder[0].points, ManifoldParameter)
    p = jax.tree.map(jnp.asarray, params)
    for step in range(5):
        x, (eps, _) = _images(1, seed=10 + step), _draws(20 + step)
        upd, state = update(grad(p, jnp.asarray(x), jnp.asarray(eps)), state, p)
        p = jax.tree.map(lambda a, u: a + u, p, upd)
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
    # Adam's normalised step turns a rounding-level gradient difference on
    # an element whose moments are near zero into a step of up to lr in
    # either direction (chip_smoke.py's card rule); the rest agree to 1e-4
    assert outside <= 0.01 * total, (outside, total)
