"""Serving the RNA-seq family from the port's own checkpoints, on the CPU.

A JAX-initialised ``RNASeqVAE`` (256 genes, hidden 16; and an ``nb`` +
bf16 one) is carried into the port by ``state_dict_from_jax_params`` and
written as a Trainer writes its best checkpoint; ``Inferencer.from_checkpoint``
then serves it:

  * embed, decode and reconstruct against the JAX package's ``Inferencer``
    over the same weights: rtol 1e-5, atol 1e-5 (matmul summation order),
    or within 2e-2 for bf16 compute (the two frameworks round bf16 at
    other places); the counts of the ``nb`` model scaled by 1/100, which
    keeps its posterior means inside the ball;
    the f32 model's reconstruct of two full batches equals, bit for bit,
    the restored model's decode of its posterior mean batch by batch
    (``reconstruct`` is the deterministic endpoint);
  * the same engine behind ``InferenceServer`` on 127.0.0.1: reconstruct as
    octet-stream equals the engine's, bit for bit;
  * ``serve_http``'s arguments: ``--checkpoint DIR [--name]`` and
    ``--state-dict`` exclude each other, and ``--also MODEL=DIR:NAME``
    serves another checkpoint.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.models.vae_rnaseq import RNASeqVAE as JaxRNASeqVAE
from hyperbolic_vae_tpu.serve import Inferencer as JaxInferencer
from hyperbolic_vae_tpu_torch.data import make_fake_arrays, normalize_rnaseq
from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params
from hyperbolic_vae_tpu_torch.models import RNASeqVAE
from hyperbolic_vae_tpu_torch.serve import Inferencer
from hyperbolic_vae_tpu_torch.serve_http import InferenceServer, load_engines, parse_args
from hyperbolic_vae_tpu_torch.train.checkpoint import CheckpointManager, model_hparams

G, H = 256, 16
TOL = dict(rtol=1e-5, atol=1e-5)
ENGINE = dict(batch_size=16, max_batches_per_dispatch=4)
CONFIGS = {"mse": dict(recon="mse"),
           "nb_bf16": dict(recon="nb", compute_dtype="bfloat16", param_dtype="bfloat16")}


def _checkpoint(directory, cfg):
    """A JAX-initialised RNASeqVAE written as the Trainer writes ``best``
    (and ``last``); returns the JAX model and parameters."""
    jm = JaxRNASeqVAE(in_features=G, hidden_dim=H, **cfg)
    params = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                     jnp.zeros((2, G)))["params"]
    params = jax.tree.map(np.asarray, dict(params))
    model = RNASeqVAE(G, H, device="cpu", **cfg)
    model.load_state_dict(state_dict_from_jax_params(params))
    mgr = CheckpointManager(str(directory))
    mgr.model_config = model_hparams(model)
    mgr.save_best(3, model.state_dict(), {"val/loss_total": 1.0})
    mgr.save_last(4, model.state_dict(), {"val/loss_total": 2.0})
    return jm, params


@pytest.fixture(scope="module")
def data():
    x = make_fake_arrays(40, G, seed=2, structured=True)[0]
    z = np.random.default_rng(1).uniform(-0.6, 0.6, size=(21, 2)).astype(np.float32)
    return normalize_rnaseq(x, "z_score").astype(np.float32), x, z


@pytest.mark.parametrize("name", list(CONFIGS))
def test_from_checkpoint_serves_as_jax(tmp_path, data, name):
    cfg = CONFIGS[name]
    jm, params = _checkpoint(tmp_path, cfg)
    inf = Inferencer.from_checkpoint(str(tmp_path), "best", device="cpu", **ENGINE)
    assert isinstance(inf.model, RNASeqVAE) and inf.model.hparams()["recon"] == cfg["recon"]
    assert inf.model.encoder[0].weight.dtype == (torch.bfloat16 if "param_dtype" in cfg
                                                 else torch.float32)
    jinf = JaxInferencer(jm, params, **ENGINE)
    x = data[1] if cfg["recon"] == "nb" else data[0]
    x = x / 100.0 if cfg["recon"] == "nb" else x  # counts scaled into the ball's interior
    z = data[2]
    tol = TOL if "compute_dtype" not in cfg else dict(rtol=0, atol=2e-2)
    for n in (1, 5, 21, 40):
        np.testing.assert_allclose(inf.embed(x[:n]), jinf.embed(x[:n]), **tol)
        np.testing.assert_allclose(inf.reconstruct(x[:n]), jinf.reconstruct(x[:n]), **tol)
        np.testing.assert_allclose(inf.decode(z[:n]), jinf.decode(z[:n]), **tol)
    gen = inf.generate(18, seed=3)
    assert gen.shape == (18, G) and np.all((gen > 0) & (gen < 1))
    np.testing.assert_array_equal(gen, inf.generate(18, seed=3))
    if name == "mse":  # two full batches: the engine's shapes, so its bits
        with torch.no_grad():
            want = [inf.model.decode(inf.model.encode(torch.from_numpy(x[i:i + 16]))[0])
                    for i in (0, 16)]
        np.testing.assert_array_equal(inf.reconstruct(x[:32]), torch.cat(want).numpy())
    last = Inferencer.from_checkpoint(str(tmp_path), "last", device="cpu", **ENGINE)
    np.testing.assert_array_equal(last.embed(x[:5]), inf.embed(x[:5]))


def test_http_reconstruct_from_checkpoint(tmp_path, data):
    _checkpoint(tmp_path, CONFIGS["mse"])
    inf = Inferencer.from_checkpoint(str(tmp_path), device="cpu", **ENGINE)
    server = InferenceServer(inf, host="127.0.0.1", port=0).start()
    try:
        x = np.ascontiguousarray(data[0][:37], "<f4")
        req = urllib.request.Request(
            f"http://{server.host}:{server.port}/v1/reconstruct", data=x.tobytes(),
            headers={"Content-Type": "application/octet-stream",
                     "X-Shape": ",".join(map(str, x.shape))})
        with urllib.request.urlopen(req, timeout=60) as r:
            shape = tuple(int(s) for s in r.headers["X-Shape"].split(","))
            out = np.frombuffer(r.read(), "<f4").reshape(shape)
        np.testing.assert_array_equal(out, inf.reconstruct(x))
        with urllib.request.urlopen(
                f"http://{server.host}:{server.port}/v1/manifest", timeout=60) as r:
            assert json.loads(r.read())["data_shape"] == [G]
    finally:
        server.shutdown()


def test_serve_http_arguments(tmp_path, data):
    a = parse_args(["--checkpoint", str(tmp_path)])
    assert a.checkpoint == str(tmp_path) and a.name == "best" and a.state_dict is None
    a = parse_args(["--checkpoint", str(tmp_path), "--name", "last", "--batch-size", "16"])
    assert a.name == "last" and a.batch_size == 16
    assert parse_args(["--state-dict", "f.npz"]).state_dict == "f.npz"
    for bad in ([], ["--checkpoint", "d", "--state-dict", "f.npz"]):
        with pytest.raises(SystemExit):
            parse_args(bad)
    _checkpoint(tmp_path, CONFIGS["mse"])
    args = parse_args(["--checkpoint", str(tmp_path), "--name", "last", "--batch-size", "16",
                       "--also", f"other={tmp_path}:best", "--also", f"plain={tmp_path}"])
    engines = load_engines(args, device="cpu")
    assert sorted(engines) == ["default", "other", "plain"]
    x = data[0][:3]
    for e in engines.values():
        assert isinstance(e.model, RNASeqVAE) and e.batch_size == 16
        np.testing.assert_array_equal(e.embed(x), engines["default"].embed(x))
