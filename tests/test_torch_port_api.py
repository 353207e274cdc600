"""The JAX package's public surface in the port: the root's names, the
layer's options and aliases, the ball's helpers, the wrapped normal
object, the checkpoint manager's monitor, ``Inferencer.from_checkpoint(
mesh=)`` and ``Trainer(debug_nans=True)``, each against the JAX package
on the CPU; and the port's own rules: ``import hyperbolic_vae_tpu_torch``
loads no model, kernel build or JAX, no module of the port (nor
``chip_smoke.py``) imports JAX or the JAX package, and every entry point
defaults to ``cuda``.

JAX's ``Trainer(debug_nans=True)`` on a batch holding a NaN raises
``FloatingPointError`` inside the first dispatch (its message names only
the chunk's ``scan``), before any epoch is recorded, and leaves the
process-wide ``jax_debug_nans`` on. The port raises it at the same point
(no epoch recorded), naming the epoch, the step and the metrics, and
turns nothing on past the fit.
"""

from __future__ import annotations

import ast
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyperbolic_vae_tpu as jroot
import hyperbolic_vae_tpu_torch as hvt
from hyperbolic_vae_tpu.manifolds import poincare as jpoincare
from hyperbolic_vae_tpu.nn import layers as jlayers
from hyperbolic_vae_tpu_torch.data import ArrayDataModule
from hyperbolic_vae_tpu_torch.distributions import wrapped_normal_rsample_from_eps
from hyperbolic_vae_tpu_torch.manifolds import poincare as tpoincare
from hyperbolic_vae_tpu_torch.nn import layers as tlayers
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
LAZY = ["Trainer", "make_trainer_hyperbolic", "GyroplaneVAE", "EuclideanVAE",
        "HyperbolicImageVAE", "UnifiedVAE", "RNASeqVAE", "Autoencoder", "PvaeMLPVAE",
        "WrappedNormal", "RiemannianNormal", "Inferencer"]


# ---- the root's names ------------------------------------------------------------


@pytest.mark.parametrize("name", ["PoincareBall", "Euclidean", "__version__"] + LAZY)
def test_every_jax_root_name_resolves_in_the_port(name):
    """Each name of JAX's root (its ``__all__`` and its lazy re-exports)
    is the port's object of the same role: the class or function of that
    name from the port's module of that role."""
    got, want = getattr(hvt, name), getattr(jroot, name)
    if name == "__version__":
        assert got == want
        return
    assert got.__name__ == want.__name__ == name
    module = want.__module__.replace("hyperbolic_vae_tpu.", "hyperbolic_vae_tpu_torch.", 1)
    assert got.__module__.startswith(module.rsplit(".", 1)[0]), (got.__module__, module)
    assert name in dir(hvt) or name in hvt._LAZY


def test_an_unknown_root_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="no attribute 'Trainerr'"):
        hvt.Trainerr  # noqa: B018


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=240, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_root_import_loads_no_model_kernel_build_or_jax():
    """A fresh process: ``import hyperbolic_vae_tpu_torch`` alone imports
    the ball and the device helper, and no model module, optimizer,
    trainer, kernel wrapper or build, no JAX and nothing of the JAX
    package."""
    res = _run("import json, sys\nimport hyperbolic_vae_tpu_torch as hvt\n"
               "print(json.dumps({'mods': sorted(sys.modules), 'version': hvt.__version__,"
               " 'ball': hvt.PoincareBall.__module__}))")
    mods = res["mods"]
    port = [m for m in mods if m.startswith("hyperbolic_vae_tpu_torch")]
    for prefix in ("hyperbolic_vae_tpu_torch.models", "hyperbolic_vae_tpu_torch.ops",
                   "hyperbolic_vae_tpu_torch.train", "hyperbolic_vae_tpu_torch.serve",
                   "hyperbolic_vae_tpu_torch.optim"):
        assert not [m for m in port if m.startswith(prefix)], (prefix, port)
    assert "hyperbolic_vae_tpu_torch.ops._build" not in mods
    assert not [m for m in mods if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))]
    assert not [m for m in mods if m == "hyperbolic_vae_tpu" or m.startswith("hyperbolic_vae_tpu.")]
    assert res["version"] == "0.1.0" and res["ball"].endswith("manifolds.poincare")


def test_no_module_imports_jax_and_every_entry_point_defaults_to_cuda():
    """Every module of the port imported in a fresh process brings in no
    JAX and nothing of the JAX package; every public function and method
    with a device parameter defaults it to None (``cuda``,
    ``resolve_device``). ``CheckpointManager.restore`` and
    ``restore_state`` defaulted to the CPU until this check found them."""
    res = _run(r"""
import importlib, inspect, json, pkgutil, sys
import hyperbolic_vae_tpu_torch as pkg
bad = []
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    mod = importlib.import_module(info.name)
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
            continue
        fns = [(name, obj)] if inspect.isfunction(obj) else []
        if inspect.isclass(obj):
            for mn, mo in vars(obj).items():
                f = getattr(mo, "__func__", mo)
                if inspect.isfunction(f) and (mn == "__init__" or not mn.startswith("_")):
                    fns.append((f"{name}.{mn}", f))
        for qn, f in fns:
            for p in inspect.signature(f).parameters.values():
                if "device" in p.name and p.default not in (inspect.Parameter.empty, None):
                    bad.append(f"{mod.__name__}.{qn}({p.name}={p.default!r})")
jaxish = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
          or m == "hyperbolic_vae_tpu" or m.startswith("hyperbolic_vae_tpu.")]
print(json.dumps({"bad": bad, "jax": jaxish, "n": len([m for m in sys.modules
                                                       if m.startswith(pkg.__name__)])}))
""")
    assert res["bad"] == []
    assert res["jax"] == []
    assert res["n"] > 60  # every module was imported


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    """Statically, imports inside functions included: no file of the port
    and not ``chip_smoke.py``."""
    files = sorted((REPO / "hyperbolic_vae_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "hyperbolic_vae_tpu"), \
                (f, name)


def test_checkpoint_restore_defaults_to_cuda(tmp_path):
    from hyperbolic_vae_tpu_torch.train import CheckpointManager

    mgr = CheckpointManager(str(tmp_path))
    mgr.save_named("x", {"w": torch.ones(2)}, {})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            mgr.restore("x")
    assert torch.equal(mgr.restore("x", device="cpu")["w"], torch.ones(2))


# ---- aliases -----------------------------------------------------------------------


def test_aliases_are_the_same_objects():
    from hyperbolic_vae_tpu_torch import manifolds, nn

    assert nn.Distance2PoincareHyperplanes is nn.PoincareHyperplanes
    assert nn.Distance2StereographicHyperplanes is nn.PoincareHyperplanes
    assert manifolds.PoincareBallWithExtras is manifolds.PoincareBall is hvt.PoincareBall
    assert manifolds.logdetexp is tpoincare.logdetexp
    assert jlayers.Distance2StereographicHyperplanes is jlayers.PoincareHyperplanes
    assert jpoincare.PoincareBallWithExtras is jpoincare.PoincareBall


def test_data_exposes_its_submodules():
    from hyperbolic_vae_tpu_torch import data

    for name in ("mnist", "cifar10", "jerby_arnon"):
        assert getattr(data, name).__name__ == f"hyperbolic_vae_tpu_torch.data.{name}"
        assert name in data.__all__
    assert "pandas" not in vars(data.jerby_arnon)  # pandas stays lazy


# ---- the ball's helpers --------------------------------------------------------------


def test_origin_and_check_point_on_manifold_equal_jax():
    c = 0.7
    tb, jb = tpoincare.PoincareBall(c), jpoincare.PoincareBall(c)
    assert torch.equal(tb.origin(3), torch.zeros(3))
    o = tb.origin((2, 3), dtype=torch.float64)
    assert o.dtype == torch.float64 and o.shape == (2, 3)
    np.testing.assert_array_equal(tb.origin((4, 2)).numpy(), np.asarray(jb.origin((4, 2))))
    r = 1 / np.sqrt(c)
    x = np.array([[0.0, 0.0], [0.5 * r, 0.1], [r, 0.0], [r * (1 + 3e-6), 0.0], [r * 1.01, 0.0],
                  [-2.0, 3.0]], np.float32)
    for atol in (1e-5, 1e-7):
        got = tb.check_point_on_manifold(torch.from_numpy(x), atol=atol)
        assert got.dtype == torch.bool and got.shape == (6,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jb.check_point_on_manifold(
            jnp.asarray(x), atol=atol)))


@pytest.mark.parametrize("keepdim", [False, True])
def test_logdetexp_free_function_equals_jax(keepdim):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(5, 3)) * 0.3).astype(np.float32)
    y = (rng.normal(size=(5, 3)) * 0.4).astype(np.float32)
    got = tpoincare.logdetexp(tpoincare.PoincareBall(1.3), torch.from_numpy(x),
                              torch.from_numpy(y), keepdim=keepdim)
    want = jax.jit(lambda a, b: jpoincare.logdetexp(jpoincare.PoincareBall(1.3), a, b,
                                                     keepdims=keepdim))(x, y)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _jax_normal(monkeypatch, eps: np.ndarray) -> None:
    """JAX's next standard-normal draws are ``eps`` (the port's)."""
    def normal(key, shape=(), dtype=jnp.float32):
        assert tuple(shape) == eps.shape
        return jnp.asarray(eps, dtype)
    monkeypatch.setattr(jax.random, "normal", normal)


def test_wrapped_normal_method_equals_jax_on_the_same_draws(monkeypatch):
    """``ball.wrapped_normal``: the port's draw from its generator, JAX's
    method on that draw (injected), through each package's
    ``rsample_from_eps``."""
    c, shape = 0.9, (6, 2)
    tb, jb = tpoincare.PoincareBall(c), jpoincare.PoincareBall(c)
    mean = np.array([0.3, -0.2], np.float32)
    std = np.array([[0.5], [1.2], [0.8], [2.0], [0.1], [1.0]], np.float32)
    got = tb.wrapped_normal(torch.Generator().manual_seed(4), shape, torch.from_numpy(mean),
                            torch.from_numpy(std))
    eps = torch.randn(shape, generator=torch.Generator().manual_seed(4))
    same = wrapped_normal_rsample_from_eps(tb, torch.from_numpy(mean),
                                           torch.from_numpy(np.broadcast_to(std, shape).copy()),
                                           eps)
    assert torch.equal(got, same)
    _jax_normal(monkeypatch, eps.numpy())
    want = jax.jit(lambda m, s: jb.wrapped_normal(jax.random.PRNGKey(0), shape, m, s))(mean, std)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert tb.check_point_on_manifold(got).all()


# ---- the wrapped normal object --------------------------------------------------------


def test_wrapped_normal_softplus_equals_jax(monkeypatch):
    """``WrappedNormal(softplus=True)``: the scale through softplus; the
    sample on injected draws and its log density as JAX's; ``mean``,
    ``batch_shape`` and ``event_shape`` as JAX's; ``sample`` carries no
    gradient."""
    rng = np.random.default_rng(3)
    loc = (rng.normal(size=(4, 2)) * 0.3).astype(np.float32)
    scale = rng.normal(size=(4, 2)).astype(np.float32)
    scale[0, 0] = 0.0  # softplus's kink
    tball, jball = tpoincare.PoincareBall(1.0), jpoincare.PoincareBall(1.0)
    t = hvt.WrappedNormal(torch.from_numpy(loc), torch.from_numpy(scale), tball, softplus=True)
    j = jroot.WrappedNormal(jnp.asarray(loc), jnp.asarray(scale), jball, softplus=True)
    eps = rng.normal(size=(3, 4, 2)).astype(np.float32)
    got = t.rsample_from_eps(torch.from_numpy(eps))
    _jax_normal(monkeypatch, eps)
    want = jax.jit(lambda: j.rsample(jax.random.PRNGKey(0), (3,)))()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.log_prob(got).numpy(), np.asarray(j.log_prob(jnp.asarray(got.numpy()))),
                               rtol=1e-5, atol=1e-5)
    assert tuple(t.batch_shape) == tuple(j.batch_shape) == (4,)
    assert tuple(t.event_shape) == tuple(j.event_shape) == (2,)
    np.testing.assert_array_equal(t.mean.numpy(), np.asarray(j.mean))
    plain = hvt.WrappedNormal(torch.from_numpy(loc), torch.from_numpy(scale), tball)
    assert not torch.equal(plain.rsample_from_eps(torch.from_numpy(eps)), got)
    lt = torch.from_numpy(loc).requires_grad_()
    s = hvt.WrappedNormal(lt, torch.ones(4, 2), tball).sample(torch.Generator().manual_seed(0),
                                                             (2,))
    assert s.shape == (2, 4, 2) and s.grad_fn is None and not s.requires_grad
    r = hvt.WrappedNormal(lt, torch.ones(4, 2), tball).rsample(torch.Generator().manual_seed(0),
                                                              (2,))
    assert torch.equal(s, r.detach()) and r.grad_fn is not None


# ---- the layer's options -------------------------------------------------------------


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("use_bias", [True, False])
def test_poincare_hyperplanes_options_equal_jax(signed, squared, use_bias):
    """The 8 signed x squared x bias layers: JAX's parameters carried into
    the port; the forward within 1e-5, and the parameters the layer
    holds as JAX's (no bias without ``use_bias``)."""
    c = 0.8
    kw = dict(signed=signed, squared=squared, use_bias=use_bias)
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(9, 2)) * 0.5).astype(np.float32)
    jl = jlayers.PoincareHyperplanes(plane_shape=2, num_planes=6, ball=jpoincare.PoincareBall(c),
                                     **kw)
    params = jax.jit(jl.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jax.jit(jl.apply)(params, jnp.asarray(x))
    tl = tlayers.PoincareHyperplanes(2, 6, tpoincare.PoincareBall(c), **kw)
    p = params["params"]
    assert sorted(p) == (["bias", "mp_points"] if use_bias else ["mp_points"])
    sd = {"points": torch.tensor(np.asarray(p["mp_points"]))}
    if use_bias:
        sd["bias"] = torch.tensor(np.asarray(p["bias"]))
    tl.load_state_dict(sd)
    assert sorted(tl.state_dict()) == sorted(sd)
    got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if squared and not signed:
        floor = tl.bias.detach().numpy() if use_bias else 0.0
        assert (got.detach().numpy() >= floor - 1e-7).all()


def test_init_radius_spread_follows_std():
    """The init radius is ``std`` x N(0, 1): on one generator's draws, the
    points' tangent radii at ``std=0.25`` are a quarter of the default's,
    and their spread about 0.25 (JAX's about the same)."""
    ball = tpoincare.PoincareBall(1.0)
    n = 4000
    radius = {}
    for std in (1.0, 0.25):
        layer = tlayers.PoincareHyperplanes(2, n, ball, std=std,
                                            generator=torch.Generator().manual_seed(0))
        radius[std] = torch.linalg.vector_norm(ball.logmap0(layer.points.detach()), dim=-1)
    inside = radius[1.0] < 2.5  # the default's draws past ~3.1 are clipped to the margin
    assert inside.float().mean() > 0.98
    np.testing.assert_allclose(radius[0.25][inside].numpy(), 0.25 * radius[1.0][inside].numpy(),
                               rtol=2e-4, atol=1e-6)
    spread = float(torch.sqrt((radius[0.25] ** 2).mean()))
    jl = jlayers.PoincareHyperplanes(plane_shape=2, num_planes=n,
                                     ball=jpoincare.PoincareBall(1.0), std=0.25)
    jp = jl.init(jax.random.PRNGKey(0), jnp.zeros((1, 2)))["params"]["mp_points"]
    jr = np.linalg.norm(np.asarray(jpoincare.PoincareBall(1.0).logmap0(jp)), axis=-1)
    assert abs(spread - 0.25) < 0.02 and abs(float(np.sqrt((jr ** 2).mean())) - 0.25) < 0.02


def test_a_layer_without_bias_through_the_interop():
    """JAX's flagship tree with its gyroplanes' bias removed goes through
    ``state_dict_from_jax_params`` (no ``decoder.0.bias``) into a port
    model whose layer has none; the importer puts no zero bias into such
    a layer; its forward is JAX's bias-less layer's."""
    from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxGyroplaneVAE
    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params
    from hyperbolic_vae_tpu_torch.interop.torch_import import import_torch_state_dict

    shape = (4, 4, 1)
    jm = JaxGyroplaneVAE(data_shape=shape, hidden_dims=(8, 4))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)({"params": jax.random.PRNGKey(2),
                                                        "sample": jax.random.PRNGKey(3)},
                                                       jnp.zeros((1,) + shape))["params"])
    del params["gyroplanes"]["bias"]
    sd = state_dict_from_jax_params(params, "gyroplane")
    assert "decoder.0.points" in sd and "decoder.0.bias" not in sd
    model = hvt.GyroplaneVAE(data_shape=shape, hidden_dims=(8, 4), device="cpu")
    old = model.decoder[0]
    model.decoder[0] = tlayers.PoincareHyperplanes(2, 4, old.ball, use_bias=False)
    model.load_state_dict(sd)
    import_torch_state_dict(model, {k: v.clone() for k, v in sd.items()})
    assert "decoder.0.bias" not in model.state_dict()
    z = (np.random.default_rng(0).normal(size=(5, 2)) * 0.4).astype(np.float32)
    jl = jlayers.PoincareHyperplanes(plane_shape=2, num_planes=4,
                                     ball=jpoincare.PoincareBall(1.0), use_bias=False)
    want = jax.jit(jl.apply)({"params": {"mp_points": params["gyroplanes"]["mp_points"]}},
                             jnp.asarray(z))
    np.testing.assert_allclose(model.decoder[0](torch.from_numpy(z)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


# ---- checkpoints, serving ------------------------------------------------------------


def _dm(rows=96, val=32, batch=32, seed=0, poison=None):
    x = np.random.default_rng(seed).uniform(0, 1, (rows + val, 4, 4, 1)).astype(np.float32)
    if poison is not None:
        x[poison, 1, 2, 0] = np.nan
    y = np.zeros(rows + val, np.int32)
    return ArrayDataModule(x[:rows], y[:rows], x[rows:], y[rows:], x[rows:], y[rows:],
                           batch_size=batch)


def _model(**kw):
    return hvt.GyroplaneVAE(data_shape=(4, 4, 1), hidden_dims=(8, 4), device="cpu",
                            generator=torch.Generator().manual_seed(0), **kw)


def test_checkpoint_manager_monitor_and_best_metadata(tmp_path):
    """The Trainer hands its monitor to the manager; ``best_metadata()`` is
    the best checkpoint's metadata, naming the history's best epoch on the
    monitor; ``wait_until_finished()`` returns at once (the port writes
    synchronously). JAX's manager has the same default monitor."""
    from hyperbolic_vae_tpu.train.checkpoint import CheckpointManager as JaxManager
    from hyperbolic_vae_tpu_torch.train import CheckpointManager

    default = inspect.signature(CheckpointManager).parameters["monitor"].default
    assert default == inspect.signature(JaxManager).parameters["monitor"].default
    t = hvt.Trainer(_model(), max_epochs=3, early_stopping_patience=None, device="cpu",
                    monitor="train/loss_total", checkpoint_dir=str(tmp_path))
    res = t.fit(_dm())
    mgr = CheckpointManager(str(tmp_path), monitor="train/loss_total")
    assert mgr.monitor == t._ckpt_mgr.monitor == "train/loss_total"
    assert mgr.wait_until_finished() is None
    best = mgr.best_metadata()
    assert best == mgr.metadata("best")
    losses = [h["train/loss_total"] for h in res.history]
    assert best["epoch"] == int(np.argmin(losses))
    assert best["train/loss_total"] == min(losses)
    assert CheckpointManager(str(tmp_path / "none")).best_metadata() is None


@pytest.fixture()
def world_of_one():
    import torch.distributed as dist

    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_inferencer_from_checkpoint_under_a_mesh(tmp_path, world_of_one):
    """``Inferencer.from_checkpoint(..., mesh=)`` at world size 1 (gloo):
    its replies are the unmeshed engine's at the same full batches bit for
    bit (JAX's ``from_checkpoint`` takes the same ``mesh``)."""
    from hyperbolic_vae_tpu_torch.parallel import make_mesh

    assert "mesh" in inspect.signature(jroot.Inferencer.from_checkpoint).parameters
    hvt.Trainer(_model(), max_epochs=1, early_stopping_patience=None, device="cpu",
                checkpoint_dir=str(tmp_path)).fit(_dm())
    mesh = make_mesh(device="cpu")
    meshed = hvt.Inferencer.from_checkpoint(str(tmp_path), batch_size=16, mesh=mesh)
    # a mesh serves full batches (no sub-batch row buckets): the twin too
    plain = hvt.Inferencer.from_checkpoint(str(tmp_path), batch_size=16, device="cpu",
                                           sub_batch_buckets=False)
    assert meshed.mesh is mesh and meshed.device == torch.device("cpu")
    x = _dm().x_val[:21]
    np.testing.assert_array_equal(meshed.embed(x), plain.embed(x))
    np.testing.assert_array_equal(meshed.reconstruct(x), plain.reconstruct(x))


# ---- debug_nans ----------------------------------------------------------------------


def _k3_step(model):
    from hyperbolic_vae_tpu_torch.ops import make_fused_train_step

    return make_fused_train_step(model)


def _fit(debug: bool, k3: bool, dm=None, **kw):
    m = hvt.GyroplaneVAE(device="cpu", generator=torch.Generator().manual_seed(0))
    t = hvt.Trainer(m, max_epochs=2, early_stopping_patience=None, device="cpu", seed=7,
                    debug_nans=debug, train_step_fn=_k3_step(m) if k3 else None, **kw)
    return t, t.fit(dm if dm is not None else _flagship_dm())


def _flagship_dm(poison=None):
    x = np.random.default_rng(4).uniform(0, 1, (160, 28, 28, 1)).astype(np.float32)
    if poison is not None:
        x[poison, 5, 9, 0] = np.nan
    y = np.zeros(160, np.int32)
    return ArrayDataModule(x[:128], y[:128], x[128:], y[128:], x[128:], y[128:], batch_size=32)


@pytest.mark.parametrize("k3", [False, True], ids=["default", "k3"])
def test_debug_nans_finite_fit_is_the_eager_fit_bit_for_bit(k3):
    """On finite data ``debug_nans`` (eager, every loss, step and gradient
    read on the host) changes no bit of the history or the parameters, and
    leaves anomaly mode off after the fit."""
    from hyperbolic_vae_tpu_torch.train.cuda_graph import run_eagerly

    with run_eagerly():
        _, want = _fit(False, k3)
    t, got = _fit(True, k3)
    assert not torch.is_anomaly_enabled()
    assert got.history == want.history and len(got.history) == 2
    for d in ("params", "best_params"):
        for k, v in getattr(want, d).items():
            assert torch.equal(getattr(got, d)[k], v), (d, k)


class _Epochs:
    def __init__(self):
        self.ends = []

    def on_epoch_end(self, trainer, epoch, params, metrics):
        self.ends.append(epoch)


POISON = 45  # a train row; its step is where the epoch's order puts it


@pytest.mark.parametrize("k3", [False, True], ids=["default", "k3"])
def test_debug_nans_raises_at_the_poisoned_step(k3, tmp_path):
    """A NaN pixel in one train row: ``FloatingPointError`` in epoch 0 at
    the train step whose batch holds the row (read from the epoch's
    order), naming ``loss_total`` (on the K3 path, K3's loss output),
    before any epoch is recorded or checkpointed: where JAX raises
    (``test_debug_nans_poisoned_batch_as_jax``). Without ``debug_nans``
    the finite guard skips that step each epoch."""
    cb = _Epochs()
    with pytest.raises(FloatingPointError) as err:
        _fit(True, k3, _flagship_dm(POISON), callbacks=[cb], checkpoint_dir=str(tmp_path))
    msg = str(err.value)
    assert "debug_nans: non-finite" in msg and "loss_total" in msg
    assert cb.ends == [] and not (tmp_path / "best.json").exists()
    assert not torch.is_anomaly_enabled()
    _, res = _fit(False, k3, _flagship_dm(POISON))
    assert all(h["train/skipped_steps"] > 0 for h in res.history)
    assert f"at epoch 0, train step {_poisoned_step()}" in msg, msg


def _poisoned_step() -> int:
    """The step of epoch 0 whose batch holds ``POISON``: the fit's first
    draw is epoch 0's row order (``epoch_program.batch_indices``)."""
    from hyperbolic_vae_tpu_torch.train.epoch_program import batch_indices

    idx = batch_indices(128, 32, "row", torch.Generator().manual_seed(7), "cpu")
    return int((idx == POISON).nonzero()[0, 0])


def test_debug_nans_names_a_nan_gradient():
    """A finite loss whose backward returns NaN (sqrt at 0 times 0): the
    gradients' check finds the parameter, the backward again under anomaly
    mode the operation, raised as ``FloatingPointError`` naming the epoch
    and the step."""
    def loss_fn(model, batch, generator=None):
        m = model.loss(batch, generator)
        m["loss_total"] = m["loss_total"] + (model.mu[0].weight * 0.0).sqrt().sum() * 0.0
        return m

    with pytest.raises(FloatingPointError, match=r"gradient of mu\.0\.weight at epoch 0, train "
                                                 r"step 0: Function 'SqrtBackward0' returned nan"):
        _fit(True, False, loss_fn=loss_fn)
    assert not torch.is_anomaly_enabled()


def test_debug_nans_poisoned_batch_as_jax():
    """JAX's ``Trainer(debug_nans=True)`` on a batch holding a NaN raises
    ``FloatingPointError`` in its first dispatch, before any epoch is
    recorded; the port's raises there too (``jax_debug_nans`` is put back
    afterwards: JAX leaves it on)."""
    from hyperbolic_vae_tpu.data import ArrayDataModule as JaxDataModule
    from hyperbolic_vae_tpu.train import Trainer as JaxTrainer

    dm = _dm(rows=64, val=16, batch=16, poison=21)
    jdm = JaxDataModule(dm.x_train, dm.y_train, dm.x_val, dm.y_val, dm.x_test, dm.y_test,
                        batch_size=16)
    jcb, tcb = _Epochs(), _Epochs()
    try:
        jt = JaxTrainer(jroot.GyroplaneVAE(data_shape=(4, 4, 1), hidden_dims=(8, 4)),
                        max_epochs=1, early_stopping_patience=None, callbacks=[jcb],
                        debug_nans=True)
        with pytest.raises(FloatingPointError, match="invalid value"):
            jt.fit(jdm)
    finally:
        jax.config.update("jax_debug_nans", False)
    t = hvt.Trainer(_model(), max_epochs=1, early_stopping_patience=None, device="cpu",
                    callbacks=[tcb], debug_nans=True)
    with pytest.raises(FloatingPointError, match="at epoch 0, train step"):
        t.fit(dm)
    assert jcb.ends == tcb.ends == []
