"""The port's exported serving bundles (``Inferencer.export_programs``,
``ExportedInferencer``, ``serve_http --bundle``,
``experiments/export_serving_bundle.py``) and K1 as a ``torch.library``
op, which the bundles' programs call.

Port of ``tests/test_serve_export.py`` and the bundle tests of
``tests/test_serve_http.py``, on the CPU at batch 8 with at most 2
batches a dispatch (buckets {1, 2}, row buckets {1, 2, 4}): a bundle
answers as the live engine bit for bit, ``generate`` included; its
program count is bounded; bf16 parameters round-trip; a fresh process
serves it without the model's code; ``io_dtype`` is baked in;
``serve_http --bundle`` answers over a socket and 404s a method it lacks;
the CLI. Against JAX: a port bundle of JAX-initialised flagship
parameters answers as JAX's ``ExportedInferencer`` with them.
"""

import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.models import GyroplaneVAE, RNASeqVAE
from hyperbolic_vae_tpu_torch.ops import gyroplane as g
from hyperbolic_vae_tpu_torch.serve import ExportedInferencer, Inferencer

REPO = Path(__file__).resolve().parent.parent
B, CAP = 8, 2


def _x(n, seed=0):
    return np.random.default_rng(seed).random((n, 28, 28, 1), np.float32)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    model = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device="cpu")
    inf = Inferencer(model, batch_size=B, max_batches_per_dispatch=CAP, device="cpu")
    out = inf.export_programs(tmp_path_factory.mktemp("bundle"),
                              methods=("encode", "decode", "reconstruct", "generate"),
                              platforms=("cpu",))
    return inf, out, ExportedInferencer.load(out, device="cpu")


def test_exported_matches_live(bundle):
    inf, _, exp = bundle
    for n in (1, 3, 8, 9, 16, 21):  # row bucket, exact, ragged, two batches, over the cap
        x = _x(n)
        np.testing.assert_array_equal(exp.embed(x), inf.embed(x))
        for a, b in zip(exp.encode(x), inf.encode(x)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(exp.reconstruct(x), inf.reconstruct(x))
    z = inf.embed(_x(5))
    np.testing.assert_array_equal(exp.decode(z), inf.decode(z))
    assert exp.embed(_x(0)).shape == (0, 2)


def test_generate_matches_live(bundle):
    inf, _, exp = bundle
    for n in (1, 8, 20, 40):
        np.testing.assert_array_equal(exp.generate(n, seed=3), inf.generate(n, seed=3))


def test_program_count_is_bounded(bundle):
    _, out, _ = bundle
    # 3 data methods x (buckets {1, 2} + row buckets {1, 2, 4}) + generate x {1, 2}
    assert len(list(Path(out).glob("*.cpu.pt2"))) == 17
    exp = ExportedInferencer.load(out, device="cpu")
    assert exp.n_programs == 0  # a program is loaded on its first use
    exp.embed(_x(3))
    assert exp.n_programs == 1
    with pytest.raises(KeyError, match="not exported"):
        exp._fn("loss")
    with pytest.raises(RuntimeError, match="CUDA"):
        ExportedInferencer.load(out)  # the card unless the caller asks for the CPU
    manifest = json.loads((Path(out) / "manifest.json").read_text())
    assert manifest["platforms"] == ["cpu"] and manifest["buckets"] == [1, 2]


def test_export_for_the_card_needs_one(bundle, tmp_path, monkeypatch):
    inf, _, _ = bundle
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        inf.export_programs(tmp_path, methods=("encode",), platforms=("cpu", "cuda"))
    assert not list(tmp_path.glob("*.cuda.pt2"))


def test_bf16_params_roundtrip_through_bundle(tmp_path):
    model = RNASeqVAE(in_features=64, hidden_dim=16, latent_dim=2, param_dtype="bfloat16",
                      generator=torch.Generator().manual_seed(1), device="cpu")
    inf = Inferencer(model, batch_size=B, max_batches_per_dispatch=1, device="cpu")
    inf.export_programs(tmp_path, methods=("encode",), platforms=("cpu",))
    exp = ExportedInferencer.load(tmp_path, device="cpu")
    sd = model.state_dict()
    assert exp.params.keys() == sd.keys()
    assert any(v.dtype == torch.bfloat16 for v in exp.params.values())
    for k, v in sd.items():
        assert exp.params[k].dtype == v.dtype and torch.equal(exp.params[k], v), k
    x = np.random.default_rng(0).random((5, 64), np.float32)
    np.testing.assert_array_equal(exp.embed(x), inf.embed(x))


def test_bundle_serves_in_fresh_process_without_model_code(bundle, tmp_path):
    inf, out, _ = bundle
    np.save(tmp_path / "x.npy", _x(7))
    np.save(tmp_path / "want.npy", inf.reconstruct(_x(7)))
    np.save(tmp_path / "gen.npy", inf.generate(9, seed=4))
    code = f"""
import sys; sys.path.insert(0, {str(REPO)!r})
import numpy as np
from hyperbolic_vae_tpu_torch.serve import ExportedInferencer
exp = ExportedInferencer.load({str(out)!r}, device="cpu")
x = np.load({str(tmp_path / "x.npy")!r})
assert np.array_equal(exp.reconstruct(x), np.load({str(tmp_path / "want.npy")!r}))
assert np.array_equal(exp.generate(9, seed=4), np.load({str(tmp_path / "gen.npy")!r}))
bad = [m for m in sys.modules if m.startswith(("hyperbolic_vae_tpu_torch.models", "jax"))]
assert not bad, bad
print("SERVED")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "SERVED" in proc.stdout


@pytest.fixture(scope="module")
def half_bundle(bundle, tmp_path_factory):
    """A float16-wire bundle of reconstruct alone, without row buckets."""
    inf, _, _ = bundle
    half = Inferencer(inf.model, batch_size=B, max_batches_per_dispatch=CAP,
                      io_dtype="float16", sub_batch_buckets=False, device="cpu")
    out = half.export_programs(tmp_path_factory.mktemp("bundle_f16"), methods=("reconstruct",),
                               platforms=("cpu",))
    return half, out


def test_io_dtype_bundle_roundtrip(half_bundle):
    half, out = half_bundle
    exp = ExportedInferencer.load(out, device="cpu")
    assert exp._manifest["io_dtype"] == "float16" and exp.io_dtype == torch.float16
    for n in (1, 9, 16):
        a, b = exp.reconstruct(_x(n)), half.reconstruct(_x(n))
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert not exp.supports_method("encode") and not exp.supports_method("embed")


def _post(server, method, x):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/v1/{method}",
        data=json.dumps({"data": np.asarray(x).tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_http_bundle_answers_and_404s(bundle, half_bundle):
    """``serve_http --bundle``'s engines behind the server: embed answers
    as the live engine, the manifest is the bundle's, and a method the
    bundle lacks answers 404 up front."""
    from hyperbolic_vae_tpu_torch.serve_http import InferenceServer, load_engines, parse_args

    inf, out, _ = bundle
    for src in ("--checkpoint", "--state-dict"):
        with pytest.raises(SystemExit):
            parse_args(["--bundle", str(out), src, "x"])
    engines = load_engines(parse_args(["--bundle", str(out)]), device="cpu")
    server = InferenceServer(engines, host="127.0.0.1", port=0).start()
    try:
        got = _post(server, "embed", _x(5))["outputs"][0]
        np.testing.assert_array_equal(np.asarray(got, np.float32), inf.embed(_x(5)))
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/v1/manifest",
                                    timeout=10) as r:
            m = json.loads(r.read())
        assert m["data_shape"] == [28, 28, 1] and "generate" in m["methods"]
    finally:
        server.shutdown()
    half, half_out = half_bundle
    server = InferenceServer(load_engines(parse_args(["--bundle", str(half_out)]), device="cpu"),
                             host="127.0.0.1", port=0).start()
    try:
        got = _post(server, "reconstruct", _x(3))["outputs"][0]
        np.testing.assert_array_equal(np.asarray(got, np.float32), half.reconstruct(_x(3)))
        for method, x in (("encode", _x(2)), ("decode", np.zeros((2, 2), np.float32))):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server, method, x)
            assert e.value.code == 404 and "unavailable" in json.loads(e.value.read())["error"]
    finally:
        server.shutdown()


def test_export_cli(bundle, tmp_path, capsys):
    from hyperbolic_vae_tpu_torch.experiments import export_serving_bundle

    inf, _, _ = bundle
    torch.save(inf.model.state_dict(), tmp_path / "flagship.pt")
    out = export_serving_bundle.main([
        "--state-dict", str(tmp_path / "flagship.pt"), "--out", str(tmp_path / "b"),
        "--batch-size", str(B), "--max-batches-per-dispatch", str(CAP), "--methods", "encode",
        "--platforms", "cpu"])
    assert "exported 5 programs (1 data methods x (3 row-buckets + 2 dispatch-buckets))" in (
        capsys.readouterr().out)
    exp = ExportedInferencer.load(out, device="cpu")
    np.testing.assert_array_equal(exp.embed(_x(11)), inf.embed(_x(11)))


def test_port_bundle_answers_as_jax_bundle(tmp_path):
    """JAX-initialised flagship parameters, exported by each package
    (JAX's for the CPU) with one batch a dispatch and no row buckets:
    every method's reply agrees."""
    import jax

    from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxGyroplaneVAE
    from hyperbolic_vae_tpu.serve import ExportedInferencer as JaxExported
    from hyperbolic_vae_tpu.serve import Inferencer as JaxInferencer
    from hyperbolic_vae_tpu_torch.interop import gyroplane_vae_from_state_dict
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params

    jm = JaxGyroplaneVAE(data_shape=(28, 28, 1), latent_dim=2)
    # JAX's tree (shapes by jax.eval_shape, which compiles nothing), drawn
    # in numpy: N(0, 0.1) puts the gyroplane points well inside the ball
    keys = {"params": jax.random.PRNGKey(3), "sample": jax.random.PRNGKey(4)}
    tree = jax.eval_shape(jm.init, keys, np.zeros((2, 28, 28, 1), np.float32))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda leaf: rng.normal(0.0, 0.1, leaf.shape).astype(np.float32), tree)
    kw = dict(batch_size=B, max_batches_per_dispatch=1, sub_batch_buckets=False)
    JaxInferencer(jm, params, **kw).export_programs(tmp_path / "jax", platforms=("cpu",))
    want = JaxExported.load(tmp_path / "jax")
    model = gyroplane_vae_from_state_dict(
        state_dict_from_jax_params(jax.tree.map(np.asarray, params)), device="cpu")
    Inferencer(model, device="cpu", **kw).export_programs(tmp_path / "port", platforms=("cpu",))
    got = ExportedInferencer.load(tmp_path / "port", device="cpu")
    tol = dict(rtol=1e-5, atol=1e-6)
    for n in (3, 16):
        x = _x(n, seed=2)
        np.testing.assert_allclose(got.reconstruct(x), want.reconstruct(x), **tol)
        for a, b in zip(got.encode(x), want.encode(x)):
            np.testing.assert_allclose(a, np.asarray(b), **tol)
    z = np.asarray(want.embed(_x(4, seed=5)))
    np.testing.assert_allclose(got.decode(z), want.decode(z), **tol)


# ---- K1 as a torch.library op ---------------------------------------------


def _k1_inputs(b=6, p=5, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, d)) * 0.2
    pts = rng.normal(size=(p, d)) * 0.2
    bias = rng.uniform(-1, 1, p)
    return [torch.tensor(a, dtype=torch.float32) for a in (x, pts, bias)]


def test_k1_op_fake_and_opcheck():
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, pts, bias = _k1_inputs()
    with FakeTensorMode() as mode:
        fx, fp, fb = (mode.from_tensor(t) for t in (x, pts, bias))
        out = torch.ops.hvae_torch.gyroplane_distances(fx, fp, fb, 1.0, True)
        assert out.shape == (6, 5) and out.dtype == torch.float32
    torch.library.opcheck(g.gyroplane_op, (x.requires_grad_(), pts, bias, 1.3, True),
                          test_utils=("test_schema", "test_autograd_registration",
                                      "test_faketensor"))


@pytest.mark.parametrize("with_bias", [True, False])
def test_k1_op_forward_and_grad_equal_plain(with_bias):
    """The op's forward is the plain version's; its gradient is autograd
    through the plain version (what the former autograd.Function's
    backward computed), bit for bit."""
    x, pts, bias = _k1_inputs(seed=1)
    bias = bias if with_bias else None
    w = torch.randn(6, 5, generator=torch.Generator().manual_seed(2))

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (x, pts) + ((bias,) if with_bias else ())]
        out = fn(ins[0], ins[1], 1.2, True, ins[2] if with_bias else None)
        (out * w).sum().backward()
        return out.detach(), [t.grad for t in ins]

    out_op, g_op = grads(g.gyroplane_distances_fast)
    out_plain, g_plain = grads(g.gyroplane_distances)
    assert torch.equal(out_op, out_plain)
    for a, b in zip(g_op, g_plain):
        assert torch.equal(a, b)


def test_k1_op_exports_in_a_layer():
    from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
    from hyperbolic_vae_tpu_torch.nn import PoincareHyperplanes

    layer = PoincareHyperplanes(2, 16, PoincareBall(c=1.0),
                                generator=torch.Generator().manual_seed(0))
    x = torch.rand(7, 2) * 0.5
    with torch.no_grad():
        prog = torch.export.export(layer, (x,))
    targets = [n.target for n in prog.graph.nodes if n.op == "call_function"]
    assert torch.ops.hvae_torch.gyroplane_distances.default in targets
    with torch.no_grad():
        assert torch.equal(prog.module()(x), layer(x))
