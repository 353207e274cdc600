"""The port's Inferencer and HTTP server against the JAX package's.

Both engines serve the same full-width flagship (JAX-initialised, carried
across with ``state_dict_from_jax_params``) at a small batch (16, up to 4
batches a dispatch), on the CPU. Tolerances: f32 outputs rtol 1e-5,
atol 1e-5 (matmul summation order); with ``io_dtype="float16"`` the
outputs are float16 values, so the two agree within one float16 ulp
(2**-11 below 1.0) where a value straddles a rounding boundary.
"""

import ast
import json
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxVAE
from hyperbolic_vae_tpu.serve import Inferencer as JaxInferencer
from hyperbolic_vae_tpu_torch.data import synthetic_mnist_arrays
from hyperbolic_vae_tpu_torch.interop import (
    gyroplane_vae_from_state_dict,
    state_dict_from_jax_params,
)
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.serve import Inferencer, generate_seed
from hyperbolic_vae_tpu_torch.serve_http import InferenceServer

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
F16_TOL = dict(rtol=0, atol=2.0**-11)
SIZES = (0, 1, 5, 16, 40)
ENGINE = dict(batch_size=16, max_batches_per_dispatch=4)


@pytest.fixture(scope="module")
def flagship():
    jm = JaxVAE()
    params = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                     jnp.zeros((2, 28, 28, 1)))["params"]
    params = jax.tree.map(np.asarray, params)
    sd = state_dict_from_jax_params(params)
    x = synthetic_mnist_arrays(n_train=64, n_test=1, seed=0)[0]
    z = np.random.default_rng(1).uniform(-0.6, 0.6, size=(64, 2)).astype(np.float32)
    return jm, params, sd, x, z


def _port(sd, **kw):
    return Inferencer(gyroplane_vae_from_state_dict(sd, device="cpu"), device="cpu",
                      **{**ENGINE, **kw})


def _close(a, b, tol):
    if isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b)
        for ai, bi in zip(a, b):
            _close(ai, bi, tol)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == np.float32
    np.testing.assert_allclose(a, b, **tol)


def test_engines_agree_on_every_size_and_method(flagship):
    jm, params, sd, x, z = flagship
    jinf = JaxInferencer(jm, params, **ENGINE)
    tinf = _port(sd)
    assert tinf._buckets == jinf._buckets == [1, 2, 4]
    assert tinf._row_buckets == jinf._row_buckets == [1, 2, 4, 8]
    for method in ("encode", "embed", "decode", "reconstruct"):
        data = z if method == "decode" else x
        for n in SIZES:
            _close(getattr(tinf, method)(data[:n]), getattr(jinf, method)(data[:n]), TOL)
            assert tinf.n_programs == jinf.n_programs, (method, n)


def test_split_above_cap_and_program_bound(flagship):
    jm, params, sd, x, z = flagship
    jinf = JaxInferencer(jm, params, **ENGINE)
    tinf = _port(sd)
    xx = np.concatenate([x, x[:20]])  # 84 rows > 4 * 16: two dispatches
    _close(tinf.reconstruct(xx), jinf.reconstruct(xx), TOL)
    _close(tinf.encode(xx), jinf.encode(xx), TOL)
    assert tinf.n_programs == jinf.n_programs
    tinf.warmup()
    # every (method, bucket) once: per x-method 4 rows + 3 k-buckets + base,
    # generate 2 k-programs + base
    assert tinf.n_programs == 3 * (4 + 2 + 1) + (2 + 1)


def test_io_dtype_float16(flagship):
    jm, params, sd, x, z = flagship
    jinf = JaxInferencer(jm, params, io_dtype="float16", **ENGINE)
    tinf = _port(sd, io_dtype="float16")
    for method, data in (("reconstruct", x), ("decode", z), ("embed", x)):
        for n in (1, 5, 40):
            _close(getattr(tinf, method)(data[:n]), getattr(jinf, method)(data[:n]), F16_TOL)
    assert tinf.n_programs == jinf.n_programs


def test_io_dtype_bfloat16_is_cast_on_the_host(flagship):
    *_, sd, x, _ = flagship
    tinf = _port(sd, io_dtype="bfloat16")
    assert tinf._to_wire("reconstruct", x[:2]).dtype == torch.bfloat16
    assert tinf._to_wire("decode", x[:2, 0, 0]).dtype == torch.float32
    full = _port(sd).reconstruct(x[:5])
    out = tinf.reconstruct(x[:5])
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, full, rtol=0, atol=2e-2)
    with pytest.raises(ValueError):
        _port(sd, io_dtype="float64")


def test_generate_replays_and_appends(flagship):
    *_, sd, _, _ = flagship
    tinf = _port(sd)
    a = tinf.generate(20, seed=3)
    b = tinf.generate(20, seed=3)
    c = tinf.generate(70, seed=3)
    d = tinf.generate(20, seed=4)
    assert a.shape == (20, 28, 28, 1) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c[:20])
    assert not np.array_equal(a, d)
    assert np.all((a >= 0) & (a <= 1))
    assert generate_seed(3, 1) == generate_seed(3, 1) != generate_seed(3, 2)


def _post(server, path, body, headers):
    req = urllib.request.Request(f"http://{server.host}:{server.port}{path}",
                                 data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.headers, r.read()


def test_http_round_trip_json_and_octet_stream(flagship):
    *_, sd, x, z = flagship
    tinf = _port(sd)
    server = InferenceServer(tinf, host="127.0.0.1", port=0).start()
    try:
        with urllib.request.urlopen(
                f"http://{server.host}:{server.port}/v1/health", timeout=60) as r:
            assert json.loads(r.read())["status"] == "ok"
        _, body = _post(server, "/v1/embed", json.dumps({"data": x[:3].tolist()}).encode(),
                        {"Content-Type": "application/json"})
        np.testing.assert_allclose(np.asarray(json.loads(body)["outputs"][0]),
                                   tinf.embed(x[:3]), **TOL)
        xr = np.ascontiguousarray(x[:21], "<f4")
        h, body = _post(server, "/v1/reconstruct", xr.tobytes(),
                        {"Content-Type": "application/octet-stream",
                         "X-Shape": ",".join(map(str, xr.shape))})
        shape = tuple(int(s) for s in h["X-Shape"].split(","))
        out = np.frombuffer(body, "<f4").reshape(shape)
        np.testing.assert_allclose(out, tinf.reconstruct(x[:21]), **TOL)
        _, body = _post(server, "/v1/decode", json.dumps({"data": z[:4].tolist()}).encode(),
                        {"Content-Type": "application/json"})
        assert np.asarray(json.loads(body)["outputs"][0]).shape == (4, 28, 28, 1)
        replies = [
            _post(server, "/v1/generate", json.dumps({"n": 18, "seed": 3}).encode(),
                  {"Content-Type": "application/json"})[1]
            for _ in range(2)
        ]
        assert replies[0] == replies[1]
        np.testing.assert_array_equal(np.asarray(json.loads(replies[0])["outputs"][0],
                                                 np.float32), tinf.generate(18, 3))
        with urllib.request.urlopen(
                f"http://{server.host}:{server.port}/v1/metrics", timeout=60) as r:
            snap = json.loads(r.read())
        assert snap["endpoints"]["reconstruct"]["requests"] == 1
        assert snap["endpoints"]["generate"]["requests"] == 2
        with urllib.request.urlopen(
                f"http://{server.host}:{server.port}/v1/manifest", timeout=60) as r:
            man = json.loads(r.read())
        assert man["data_shape"] == [28, 28, 1] and "generate" in man["methods"]
    finally:
        server.shutdown()


_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "hyperbolic_vae_tpu"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((REPO / "hyperbolic_vae_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        bad = _FORBIDDEN.intersection(_imported_roots(f))
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"


def test_default_device_raises_without_cuda(monkeypatch, flagship):
    from hyperbolic_vae_tpu_torch import resolve_device
    from hyperbolic_vae_tpu_torch.serve_http import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    *_, sd, _, _ = flagship
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        GyroplaneVAE()
    with pytest.raises(RuntimeError, match="CUDA"):
        Inferencer(gyroplane_vae_from_state_dict(sd, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--state-dict", "unused.npz"])
    assert resolve_device("cpu") == torch.device("cpu")
