"""The RNA-seq family of the port against the JAX package, on the CPU.

  * the fake Jerby-Arnon data (flat and structured, every normalisation)
    and ``make_rnaseq_data_module``'s 70/15/15 split: bit for bit;
  * the negative-binomial log density (logits and probs; large counts,
    small total counts): within 1e-5 of the largest of its terms (both
    packages cancel lgamma terms of up to ~1e6 in f32); its slope in the
    logits at 0, where the stable softplus must pass 1/2;
  * ``RNASeqVAE`` at 64 genes, hidden 8, in both ``recon`` modes, from
    JAX-initialised weights carried by ``state_dict_from_jax_params`` (the
    encoder's kernel scaled so that the posterior means lie inside the
    ball, away from the projection margin where f32 cancels) and the same
    standard-normal draws: encode, decode, the loss, the IWAE
    bound and the gradients of the loss against ``jax.grad`` of the loss
    built from JAX's own pieces (encode, ``wrapped_normal_rsample_from_eps``,
    decode, its NB and wrapped-normal densities). f32: activations atol
    1e-5, the loss and the bound rtol 1e-5, each gradient within 1e-4 of
    its largest magnitude. The same unscaled on raw counts (posterior means
    on the projection margin) held to JAX's float64 evaluation: no farther
    than twice JAX's f32 distance. bf16 compute and storage: within 2e-2 of each
    output's largest magnitude (the two frameworks round bf16 at other
    places); one forward at the full 20,480 genes and hidden 256, batch 4;
  * Riemannian Adam on bf16 parameters (the stored update, the EMA of the
    rounded sum) beside f32 manifold points: five steps equal JAX's
    op-by-op steps, the bf16 parameters' values, moments and EMA, or lie
    one bf16 ulp apart on at most 0.1 % of elements (where an f32 op
    rounds differently); the f32 points as the moments' test holds them
    (rtol 1e-6);
  * the Trainer's ``loss_reduction`` check; a checkpoint round trip of an
    ``nb`` + bf16 model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.data import jerby_arnon as jax_ja
from hyperbolic_vae_tpu.distributions import wrapped_normal_log_prob as jax_wn_log_prob
from hyperbolic_vae_tpu.distributions import wrapped_normal_rsample_from_eps as jax_rsample
from hyperbolic_vae_tpu.distributions.negative_binomial import (
    nb_mean_dispersion_to_logits as jax_nb_logits,
)
from hyperbolic_vae_tpu.distributions.negative_binomial import (
    negative_binomial_log_prob as jax_nb,
)
from hyperbolic_vae_tpu.manifolds import PoincareBall as JaxBall
from hyperbolic_vae_tpu.models.iwae import gaussian_loglik as jax_gaussian_loglik
from hyperbolic_vae_tpu.models.iwae import iwae_bound as jax_iwae_bound
from hyperbolic_vae_tpu.models.vae_rnaseq import RNASeqVAE as JaxRNASeqVAE
from hyperbolic_vae_tpu.optim import riemannian_adam
from hyperbolic_vae_tpu_torch.data import jerby_arnon as port_ja
from hyperbolic_vae_tpu_torch.distributions import (
    nb_mean_dispersion_to_logits,
    negative_binomial_log_prob,
)
from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params
from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.models import RNASeqVAE
from hyperbolic_vae_tpu_torch.nn import ManifoldParameter
from hyperbolic_vae_tpu_torch.optim import RiemannianAdam
from hyperbolic_vae_tpu_torch.train import Trainer
from hyperbolic_vae_tpu_torch.train.checkpoint import model_hparams, restore_model

G, H, L, B, K = 64, 8, 2, 6, 12
ENC_SCALE = {"mse": 0.3, "nb": 0.003}


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- data ---------------------------------------------------------------


@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("method", [None, "sum_to_one", "sum_to_million", "z_score"])
def test_fake_arrays_and_normalisation_equal_jax(structured, method):
    want = jax_ja.make_fake_arrays(37, 50, seed=3, structured=structured)
    got = port_ja.make_fake_arrays(37, 50, seed=3, structured=structured)
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]
    np.testing.assert_array_equal(port_ja.normalize_rnaseq(got[0], method),
                                  jax_ja.normalize_rnaseq(want[0], method))


@pytest.mark.parametrize("method", [None, "z_score"])
def test_data_module_and_split_equal_jax(method):
    kw = dict(batch_size=16, fake=True, n_samples=83, n_genes=40, rnaseq_normalize_method=method,
              seed=5, structured_fake=True)
    want, got = jax_ja.make_rnaseq_data_module(**kw), port_ja.make_rnaseq_data_module(**kw)
    assert (len(got.x_train), len(got.x_val), len(got.x_test)) == (58, 12, 13)
    for s in ("train", "val", "test"):
        for a in ("x", "y"):
            w, g = getattr(want, f"{a}_{s}"), getattr(got, f"{a}_{s}")
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert list(got.label_names) == list(want.label_names) and got.name == want.name
    # the CSV path is ported (tests/test_torch_port_data_jerby.py)
    with pytest.raises(FileNotFoundError, match="annotations.csv, tpm.csv"):
        port_ja.make_rnaseq_data_module(data_dir="/nonexistent")


# ---- the negative binomial ----------------------------------------------


@pytest.mark.parametrize("given", ["logits", "probs"])
def test_negative_binomial_log_prob_equals_jax(given):
    rng = np.random.default_rng(0)
    n = 400
    k = np.concatenate([rng.poisson(3.0, n // 2), rng.integers(1_000, 200_000, n // 2)])
    r = np.concatenate([rng.uniform(1e-3, 1e-2, n // 4), rng.uniform(0.05, 50.0, 3 * n // 4)])
    rng.shuffle(r)
    p = rng.uniform(1e-4, 1.0 - 1e-4, n)
    arg = np.log(p) - np.log1p(-p) if given == "logits" else p
    k, r, arg = (a.astype(np.float32) for a in (k, r, arg))
    want = np.asarray(jax_nb(jnp.asarray(k), jnp.asarray(r), **{given: jnp.asarray(arg)}))
    got = negative_binomial_log_prob(_t(k), _t(r), **{given: _t(arg)}).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    # relative to the largest of the density's terms, each of which both
    # packages round in f32: at counts ~1e5, lgamma(k + r) ~ 1e6 (an f32
    # ulp of 0.06) cancels against lgamma(k + 1); at small r, lgamma(r)
    k64, r64 = _t(k).double(), _t(r).double()
    lg = _t(arg).double() if given == "logits" else torch.logit(_t(arg).double())
    terms = torch.stack([torch.lgamma(k64 + r64), torch.lgamma(r64), torch.lgamma(k64 + 1.0),
                         r64 * torch.nn.functional.softplus(lg),
                         k64 * torch.nn.functional.softplus(-lg), _t(want).double()])
    scale = terms.abs().amax(dim=0).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * scale), float((np.abs(got - want) / scale).max())
    mean, theta = rng.uniform(0.0, 50.0, n).astype(np.float32), r
    np.testing.assert_allclose(nb_mean_dispersion_to_logits(_t(mean), _t(theta)).numpy(),
                               np.asarray(jax_nb_logits(jnp.asarray(mean), jnp.asarray(theta))),
                               rtol=1e-6, atol=1e-6)  # log(mean) - log(theta) cancels
    with pytest.raises(ValueError, match="exactly one"):
        negative_binomial_log_prob(_t(k), _t(r))


def test_negative_binomial_slope_at_even_odds_equals_jax():
    """The density's gradient in its logits at and around logits 0 (probs
    1/2: a sigmoid decoder's output wherever its hidden layer is all zero),
    and the stable softplus's slope: 1/2 at 0, as ``jax.nn.softplus``."""
    from hyperbolic_vae_tpu_torch.distributions.relaxed_bernoulli import softplus

    k = np.array([0.0, 3.0, 308.0, 7.0, 1.0, 50.0], np.float32)
    r = np.array([0.9, 2.0, 0.5, 30.0, 1e-3, 4.0], np.float32)
    lg = np.array([0.0, -0.0, 1e-3, -2.0, 40.0, -120.0], np.float32)
    want = jax.grad(lambda a: jnp.sum(jax_nb(jnp.asarray(k), jnp.asarray(r), logits=a)))(
        jnp.asarray(lg))
    got = _t(lg).requires_grad_()
    negative_binomial_log_prob(_t(k), _t(r), logits=got).sum().backward()
    np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-6)
    x = _t(lg).requires_grad_()
    softplus(x).sum().backward()
    np.testing.assert_allclose(softplus(_t(lg)).numpy(), np.asarray(jax.nn.softplus(lg)), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jax.vmap(jax.grad(jax.nn.softplus))(lg)),
                               rtol=1e-6)


# ---- the model ------------------------------------------------------------


def _jax_pieces(jm, recon):
    """JAX's loss and bound built from its own pieces on given draws, and
    the loss from the encoder's outputs on."""
    ball = jm.ball

    def nb_loglik(params, x, xh):
        probs = jnp.clip(xh, 1e-6, 1.0 - 1e-6)
        logits = jnp.log(probs) - jnp.log1p(-probs)
        lp = jnp.sum(jax_nb(x, jnp.exp(params["nb_log_theta"]), logits=logits), axis=-1)
        return jnp.where(jnp.any(x < 0, axis=-1), jnp.nan, lp)

    def loss_at(params, x, mu, scale, eps):
        """The loss from the encoder's outputs (mu, scale) on."""
        z = jax_rsample(ball, mu, scale, eps)
        xh = jm.apply({"params": params}, z, method="decode")
        rec = -nb_loglik(params, x, xh) if recon == "nb" else jnp.sum((xh - x) ** 2, axis=-1)
        kl = (jax_wn_log_prob(ball, mu, scale, z)
              - jax_wn_log_prob(ball, jnp.zeros((L,)), jnp.ones((L,)), z))
        return {"loss_total": jnp.mean(rec + jm.beta * kl), "loss_recon": jnp.mean(rec),
                "loss_kl": jnp.mean(kl)}

    def loss(params, x, eps):
        return loss_at(params, x, *jm.apply({"params": params}, x, method="encode"), eps)

    def bound(params, x, eps):
        k, b = eps.shape[:2]
        mu, scale = jm.apply({"params": params}, x, method="encode")
        z = jax_rsample(ball, mu, scale, eps)
        log_q = jax_wn_log_prob(ball, mu, scale, z)
        log_p = jax_wn_log_prob(ball, jnp.zeros((L,)), jnp.ones((L,)), z)
        xh = jm.apply({"params": params}, z.reshape(-1, L), method="decode").reshape(k, b, -1)
        lpx = nb_loglik(params, x[None], xh) if recon == "nb" else jax_gaussian_loglik(x, xh)
        return jax_iwae_bound(lpx + log_p - log_q)

    return jax.jit(loss), jax.jit(bound), jax.jit(loss_at)


def _init(recon, dtype="float32", genes=G, hidden=H, seed=0, enc_scale=None):
    jm = JaxRNASeqVAE(in_features=genes, hidden_dim=hidden, recon=recon, compute_dtype=dtype,
                      param_dtype=dtype)
    params = jm.init({"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1)},
                     jnp.zeros((2, genes)))["params"]
    params = jax.tree.map(np.asarray, dict(params))
    # the encoder scaled so that the posterior means lie well inside the
    # ball: at the init's scale (raw counts ~100 into 64 genes) they sit on
    # the projection margin, where both packages' KL cancels in f32
    # (``test_raw_counts_at_the_projection_margin_as_accurate_as_jax``)
    enc_scale = ENC_SCALE[recon] if enc_scale is None else enc_scale
    params["enc"] = dict(params["enc"], kernel=np.asarray(
        jnp.asarray(params["enc"]["kernel"]) * enc_scale))
    if recon == "nb":  # away from the zero init, so the dispersion matters
        params["nb_log_theta"] = np.random.default_rng(seed).normal(0.0, 0.7, genes).astype(np.float32)
    model = RNASeqVAE(genes, hidden, recon=recon, compute_dtype=dtype, param_dtype=dtype,
                      device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    return jm, params, model


def _inputs(recon, n, genes=G, seed=0, raw=False):
    x = port_ja.make_fake_arrays(n, genes, seed=seed, structured=True)[0]
    if recon == "mse" and not raw:
        x = port_ja.normalize_rnaseq(x, "z_score").astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    return x, rng.normal(size=(n, L)).astype(np.float32), rng.normal(size=(K, n, L)).astype(np.float32)


@pytest.fixture(scope="module", params=["mse", "nb"])
def f32_pair(request):
    recon = request.param
    jm, params, model = _init(recon)
    x, eps, eps_k = _inputs(recon, 3 * B)
    return recon, jm, params, model, x, eps, eps_k


def test_state_dict_layout(f32_pair):
    recon, _, params, model, *_ = f32_pair
    sd = state_dict_from_jax_params(params)
    assert sd.keys() == model.state_dict().keys()
    assert set(sd) >= {"encoder.0.weight", "mu.0.weight", "scale.0.bias", "decoder.0.points",
                       "decoder.0.bias", "decoder.2.weight"}
    assert ("nb_log_theta" in sd) == (recon == "nb")
    assert state_dict_from_jax_params(params, model="rnaseq").keys() == sd.keys()
    np.testing.assert_array_equal(sd["encoder.0.weight"].numpy(), params["enc"]["kernel"].T)
    assert sd["encoder.0.weight"].shape == (H, G) and sd["decoder.2.weight"].shape == (G, H)


def test_encode_decode_loss_and_bound_equal_jax(f32_pair):
    recon, jm, params, model, x, eps, eps_k = f32_pair
    jloss, jbound, _ = _jax_pieces(jm, recon)
    mu_j, sc_j = jm.apply({"params": params}, jnp.asarray(x), method="encode")
    z = np.asarray(jax_rsample(jm.ball, mu_j, sc_j, jnp.asarray(eps)))
    with torch.no_grad():
        mu, sc = model.encode(_t(x))
        xh = model.decode(_t(z))
        loss = model.loss_from_eps(_t(x), _t(eps))
        bound = model.iwae_from_eps(_t(x[:B]), _t(eps_k[:, :B]))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(sc.numpy(), np.asarray(sc_j), rtol=0, atol=1e-5)
    xh_j = np.asarray(jm.apply({"params": params}, jnp.asarray(z), method="decode"))
    assert xh.shape == (3 * B, G) and xh.dtype == torch.float32
    np.testing.assert_allclose(xh.numpy(), xh_j, rtol=0, atol=1e-5)
    want = jloss(params, jnp.asarray(x), jnp.asarray(eps))
    assert set(loss) == set(want)
    for key in want:
        np.testing.assert_allclose(float(loss[key]), float(want[key]), rtol=1e-5)
    want_b = np.asarray(jbound(params, jnp.asarray(x[:B]), jnp.asarray(eps_k[:, :B])))
    assert bound.shape == (B,) and np.isfinite(bound.numpy()).all()
    np.testing.assert_allclose(bound.numpy(), want_b, rtol=1e-5)


def test_gradients_equal_jax(f32_pair):
    recon, jm, params, model, x, eps, _ = f32_pair
    jloss, *_ = _jax_pieces(jm, recon)
    jg = jax.grad(lambda p: jloss(p, jnp.asarray(x), jnp.asarray(eps))["loss_total"])(params)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jg))
    model.zero_grad()
    model.loss_from_eps(_t(x), _t(eps))["loss_total"].backward()
    for name, p in model.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_nb_poisons_negative_rows_to_nan():
    jm, params, model = _init("nb")
    x, eps, eps_k = _inputs("nb", B)
    x[2, 5] = -1.0
    with torch.no_grad():
        loss = model.loss_from_eps(_t(x), _t(eps))
        bound = model.iwae_from_eps(_t(x), _t(eps_k))
    assert all(np.isnan(float(v)) for k, v in loss.items() if k != "loss_kl")
    assert np.isfinite(float(loss["loss_kl"]))
    b = bound.numpy()
    assert np.isnan(b[2]) and np.isfinite(np.delete(b, 2)).all()
    _, jbound, _ = _jax_pieces(jm, "nb")
    np.testing.assert_allclose(b, np.asarray(jbound(params, jnp.asarray(x), jnp.asarray(eps_k))),
                               rtol=1e-5)


def _as_accurate(got, want, exact, rel, what):
    """``got`` (the port, f32) no farther from the float64 evaluation
    ``exact`` than twice ``want`` (JAX, f32) is, plus ``rel`` of exact's
    largest magnitude (K1's rule near the ball's boundary)."""
    got, want, exact = (np.asarray(a, np.float64) for a in (got, want, exact))
    assert np.isfinite(got).all(), what
    err_p, err_j = np.abs(got - exact).max(), np.abs(want - exact).max()
    assert err_p <= 2.0 * err_j + rel * np.abs(exact).max(), (what, err_p, err_j)


@pytest.mark.parametrize("recon", ["mse", "nb"])
def test_raw_counts_at_the_projection_margin_as_accurate_as_jax(recon):
    """JAX's own initialisation, unscaled, on raw counts: every posterior
    mean on the projection margin, as an ``nb`` model starts training.
    There the KL cancels in f32 in both packages (its gradient at the
    encoder's outputs lies 7-61 % of its largest magnitude from float64:
    ``tests/rnaseq_margin_readings.py``), so
    the port is held to JAX's float64 evaluation (``compute_dtype=
    "float64"``, the same weights) by K1's rule: no farther than twice
    JAX's f32 distance, plus 1e-5 of the value (loss, bound) or 1e-4 of
    each gradient's largest magnitude. Gradients: of the whole loss at the
    encoder's outputs (mu, scale; the KL's path), and of the
    reconstruction term at every parameter (the decoder's, and the
    encoder's through the reparameterised sample). The KL's gradient at
    the encoder's outputs is held to JAX's in float64 (the port's density
    pieces run in float64), since no f32 evaluation of it is accurate
    there."""
    from hyperbolic_vae_tpu_torch.distributions import wrapped_normal_rsample_from_eps

    jm, params, model = _init(recon, enc_scale=1.0)
    x, eps, eps_k = _inputs(recon, 3 * B, raw=True)
    jloss, jbound, jloss_at = _jax_pieces(jm, recon)
    mu_j, sc_j = (np.asarray(a) for a in jm.apply({"params": params}, jnp.asarray(x), method="encode"))
    radius = (1.0 - 4e-3) / np.sqrt(jm.manifold_curvature)
    assert np.all(np.linalg.norm(mu_j, axis=-1) >= 0.999 * radius)

    def both(f, *args):
        """f at f32 and at float64 (JAX's compute_dtype="float64")."""
        with jax.enable_x64(True):
            jm64 = JaxRNASeqVAE(in_features=G, hidden_dim=H, recon=recon, compute_dtype="float64")
            exact = f(jm64, *(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), a) for a in args))
            exact = jax.tree.map(np.asarray, exact)
        return jax.tree.map(np.asarray, f(jm, *(jax.tree.map(jnp.asarray, a) for a in args))), exact

    want, exact = both(lambda m, p, x_, e: _jax_pieces(m, recon)[0](p, x_, e), params, x, eps)
    want_b, exact_b = both(lambda m, p, x_, e: _jax_pieces(m, recon)[1](p, x_, e), params, x[:B],
                           eps_k[:, :B])
    with torch.no_grad():
        loss = model.loss_from_eps(_t(x), _t(eps))
        bound = model.iwae_from_eps(_t(x[:B]), _t(eps_k[:, :B]))
    for key in want:
        _as_accurate(float(loss[key]), want[key], exact[key], 1e-5, key)
    _as_accurate(bound.numpy(), want_b, exact_b, 1e-5, "bound")

    # the KL at the encoder's outputs, in float64: in f32 a one-ulp change
    # of (mu, scale) moves either package's error there by tens of percent
    # of the gradient's largest magnitude, float64 itself by well under one
    # (tests/rnaseq_margin_readings.py)
    want_g, exact_g = both(lambda m, p, x_, mu, sc, e: jax.grad(
        lambda a, b: _jax_pieces(m, recon)[2](p, x_, a, b, e)["loss_kl"], argnums=(0, 1))(mu, sc),
        params, x, mu_j, sc_j, eps)
    mu, sc = (torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (mu_j, sc_j))
    z = wrapped_normal_rsample_from_eps(model.ball, mu, sc, _t(eps).double())
    model._loss_parts(_t(x), mu, sc, z, torch.full(x.shape, 0.5))["loss_kl"].backward()
    for got, e, what in zip((mu.grad, sc.grad), exact_g, ("d kl/d mu", "d kl/d scale")):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), e, rtol=1e-9, atol=1e-9 * np.abs(e).max(), err_msg=what)

    # the reconstruction term at every parameter
    want_r, exact_r = both(lambda m, p, x_, e: jax.grad(
        lambda q: _jax_pieces(m, recon)[0](q, x_, e)["loss_recon"])(p), params, x, eps)
    # (the float64 gradients rounded to f32 by the layout's conversion: 6e-8
    # of each, far inside the allowance)
    want_r, exact_r = state_dict_from_jax_params(want_r), state_dict_from_jax_params(exact_r)
    model.zero_grad()
    model.loss_from_eps(_t(x), _t(eps))["loss_recon"].backward()
    for name, p in model.named_parameters():
        _as_accurate(p.grad.numpy(), want_r[name].numpy(), exact_r[name].numpy(), 1e-4, name)


def _scale_close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("recon", ["mse", "nb"])
def test_bf16_compute_and_storage_near_jax(recon):
    jm, params, model = _init(recon, "bfloat16")
    assert params["enc"]["kernel"].dtype.name == "bfloat16"
    for name in ("encoder.0.weight", "encoder.0.bias", "decoder.2.weight", "decoder.2.bias"):
        p = model.state_dict()[name]
        assert p.dtype == torch.bfloat16
    want_w = np.asarray(jnp.asarray(params["dec_out"]["kernel"]).astype(jnp.float32)).T
    np.testing.assert_array_equal(model.decoder[2].weight.detach().float().numpy(), want_w)
    assert model.mu[0].weight.dtype == model.decoder[0].points.dtype == torch.float32
    x, eps, eps_k = _inputs(recon, 2 * B)
    jloss, jbound, _ = _jax_pieces(jm, recon)
    mu_j, _ = jm.apply({"params": params}, jnp.asarray(x), method="encode")
    z = np.asarray(jax_rsample(jm.ball, mu_j, jnp.ones_like(mu_j) * 0.3, jnp.asarray(eps)))
    with torch.no_grad():
        mu, _ = model.encode(_t(x))
        xh = model.decode(_t(z))
        loss = model.loss_from_eps(_t(x), _t(eps))
        bound = model.iwae_from_eps(_t(x[:B]), _t(eps_k[:, :B]))
    assert mu.dtype == xh.dtype == torch.float32
    _scale_close(mu.numpy(), mu_j, 2e-2)
    _scale_close(xh.numpy(), jm.apply({"params": params}, jnp.asarray(z), method="decode"), 2e-2)
    want = jloss(params, jnp.asarray(x), jnp.asarray(eps))
    for key in want:
        np.testing.assert_allclose(float(loss[key]), float(want[key]), rtol=2e-2)
    _scale_close(bound.numpy(), jbound(params, jnp.asarray(x[:B]), jnp.asarray(eps_k[:, :B])), 2e-2)
    model.loss_from_eps(_t(x), _t(eps))["loss_total"].backward()
    assert model.encoder[0].weight.grad.dtype == torch.bfloat16


def test_full_width_forward_equals_jax():
    """The realistic width (20,480 genes, hidden 256: K1 at 256 planes),
    batch 4, f32."""
    genes, hidden, n = 20480, 256, 4
    jm, params, model = _init("mse", genes=genes, hidden=hidden)
    x, eps, _ = _inputs("mse", n, genes=genes)
    x = x[:n]
    jloss, *_ = _jax_pieces(jm, "mse")
    with torch.no_grad():
        mu, _ = model.encode(_t(x))
        loss = model.loss_from_eps(_t(x), _t(eps[:n]))
        xh = model.decode(mu)
    mu_j, _ = jm.apply({"params": params}, jnp.asarray(x), method="encode")
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=0, atol=1e-5)
    xh_j = np.asarray(jm.apply({"params": params}, mu_j, method="decode"))
    assert xh.shape == (n, genes)
    np.testing.assert_allclose(xh.numpy(), xh_j, rtol=0, atol=1e-5)
    want = jloss(params, jnp.asarray(x), jnp.asarray(eps[:n]))
    for key in want:
        np.testing.assert_allclose(float(loss[key]), float(want[key]), rtol=1e-5)


# ---- Riemannian Adam on bf16 storage ---------------------------------------


def _bf16_ulp(b: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8 significant bits) of each value."""
    return np.where(b != 0, 2.0 ** (np.floor(np.log2(np.abs(b) + (b == 0))) - 7), 2.0 ** -133)


def _equal_or_one_ulp(got: np.ndarray, want: np.ndarray, what: str) -> None:
    differ = got != want
    assert differ.mean() <= 1e-3, f"{what}: {int(differ.sum())} of {differ.size} elements differ"
    assert np.all(np.abs(got - want) <= _bf16_ulp(want)), f"{what}: more than one bf16 ulp apart"


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16", "float32"])
@pytest.mark.parametrize("with_ok", [False, True])
def test_bf16_parameter_storage_steps_equal_jax(moment_dtype, with_ok):
    rng = np.random.default_rng(0)
    bf = jnp.bfloat16
    w = np.asarray(jnp.asarray(rng.normal(0.0, 0.05, (64, 256)), bf))
    b = np.asarray(jnp.asarray(rng.normal(0.0, 0.5, (256,)), bf))
    pts = rng.normal(size=(16, 2))
    pts = (0.7 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)
           * rng.uniform(0.2, 1.0, (16, 1))).astype(np.float32)
    grads = [(np.asarray(jnp.asarray(rng.normal(0.0, 1e-2, w.shape), bf)),
              np.asarray(jnp.asarray(rng.normal(0.0, 1.0, b.shape), bf)),
              rng.normal(size=pts.shape).astype(np.float32)) for _ in range(5)]

    # JAX, op by op (no jit, so no fusion keeps a bf16 sum in f32)
    opt = riemannian_adam(learning_rate=1e-2, ball=JaxBall(1.0), moment_dtype=moment_dtype,
                          ema_decay=0.9)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b), "mp_points": jnp.asarray(pts)}
    state = opt.init(params)
    for gw, gb, gp in grads:
        upd, state = opt.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb),
                                 "mp_points": jnp.asarray(gp)}, state, params)
        params = jax.tree.map(lambda p, u: (p + u).astype(p.dtype), params, upd)

    from hyperbolic_vae_tpu_torch.interop.state_dict import _t as from_jax

    tw, tb = torch.nn.Parameter(from_jax(w)), torch.nn.Parameter(from_jax(b))
    tp = ManifoldParameter(torch.from_numpy(pts.copy()))
    assert tw.dtype == torch.bfloat16
    topt = RiemannianAdam([tw, tb, tp], lr=1e-2, ball=PoincareBall(1.0), moment_dtype=moment_dtype,
                          ema_decay=0.9)
    for gw, gb, gp in grads:
        tw.grad, tb.grad, tp.grad = from_jax(gw), from_jax(gb), torch.from_numpy(gp)
        topt.step(ok=torch.tensor(True) if with_ok else None)
    assert int(topt.count) == 5
    ema = topt.ema_params()

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    for t, key in ((tw, "w"), (tb, "b"), (tp, "mp_points")):
        if key == "mp_points":  # f32 storage: the f32 rule of the moments' test
            assert t.dtype == torch.float32
            close = lambda a, b, what: np.testing.assert_allclose(  # noqa: E731
                a, b, rtol=1e-6, atol=1e-7, err_msg=what)
        else:
            assert t.dtype == torch.bfloat16
            close = _equal_or_one_ulp
        close(t.detach().float().numpy(), f32(params[key]), f"param {key}")
        assert ema[t].dtype == torch.float32
        close(ema[t].numpy(), f32(state.ema[key]), f"ema {key}")
        for mine, theirs, what in ((topt.state[t]["exp_avg"], state.exp_avg[key], "exp_avg"),
                                   (topt.state[t]["exp_avg_sq"], state.exp_avg_sq[key], "exp_avg_sq")):
            assert str(mine.dtype).removeprefix("torch.") == jnp.dtype(theirs.dtype).name
            close(mine.float().numpy(), f32(theirs), f"{what} {key}")
    # a masked step changes nothing
    before = [t.detach().clone() for t in (tw, tb, tp, *ema.values())]
    tw.grad = torch.full_like(tw, float("nan"))
    topt.step(ok=torch.tensor(False))
    after = [tw, tb, tp, *topt.ema_params().values()]
    assert all(torch.equal(a, c) for a, c in zip(before, after)) and int(topt.count) == 5


def test_optimizer_state_from_jax_keeps_bf16_moments():
    from hyperbolic_vae_tpu_torch.interop import optimizer_state_from_jax

    jm, params, model = _init("nb", "bfloat16")
    opt = riemannian_adam(learning_rate=1e-3, ball=JaxBall(1.0))
    state = opt.init(params)
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype), params)
    _, state = opt.update(grads, state, params)
    moments = optimizer_state_from_jax(state, model)
    assert moments["count"] == 1
    topt = RiemannianAdam(model.parameters(), lr=1e-3, ball=model.ball)
    topt.load_moments(moments)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, state.exp_avg_sq))
    for name, p in model.named_parameters():
        m, v = topt.moments(p)
        assert v.dtype == p.dtype == want[name].dtype, name
        assert torch.equal(v, want[name]), name
    assert topt.moments(model.encoder[0].weight)[0].dtype == torch.bfloat16


# ---- the Trainer and checkpoints ---------------------------------------------


def test_loss_reduction_check():
    class BatchSum(RNASeqVAE):
        loss_reduction = "batch_sum"

    gen = torch.Generator().manual_seed(0)
    summed = BatchSum(G, H, generator=gen, device="cpu")
    with pytest.raises(ValueError, match=r"grad_accum_steps>1 requires a per-sample-mean loss "
                                         r"dict, but BatchSum.loss_reduction is 'batch_sum'"):
        Trainer(summed, grad_accum_steps=2, device="cpu")
    Trainer(summed, grad_accum_steps=1, device="cpu")
    model = RNASeqVAE(G, H, generator=gen, device="cpu")
    assert model.loss_reduction == "per_sample_mean"
    Trainer(model, grad_accum_steps=2, device="cpu")


def test_checkpoint_round_trip_nb_bf16(tmp_path):
    dm = port_ja.make_rnaseq_data_module(batch_size=16, fake=True, n_samples=90, n_genes=G,
                                         rnaseq_normalize_method=None)
    kw = dict(in_features=G, hidden_dim=H, latent_dim=3, manifold_curvature=0.7, beta=0.5,
              lr=2e-3, recon="nb", compute_dtype="bfloat16", param_dtype="bfloat16")
    model = RNASeqVAE(**kw, generator=torch.Generator().manual_seed(0), device="cpu")
    res = Trainer(model, max_epochs=2, checkpoint_dir=str(tmp_path), device="cpu").fit(dm)
    assert all(np.isfinite(h["train/loss_total"]) for h in res.history)
    assert model_hparams(model)["__model_class__"] == "RNASeqVAE"
    for name, params in (("best", res.best_params), ("last", res.params)):
        restored, loaded, meta = restore_model(str(tmp_path), name, device="cpu")
        assert type(restored) is RNASeqVAE and restored.hparams() == kw
        assert meta["epoch"] in (0, 1)
        for k, v in params.items():
            assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k
            assert torch.equal(restored.state_dict()[k], v), k
    assert restored.state_dict()["encoder.0.weight"].dtype == torch.bfloat16
    assert restored.state_dict()["nb_log_theta"].dtype == torch.float32
