"""Parameter sharding (``parallel/sharding_rules.py``, ``tensor_parallel.py``,
``fsdp.py``): tensor parallelism, FSDP and FSDP x TP.

The layouts are held to JAX's ``tp_param_shardings``,
``fsdp_param_shardings`` and ``fsdp_tp_param_shardings`` key by key
(exactly), on ``jax.eval_shape`` parameters over a (data 4, model 2) and a
(data 8) mesh, for the four dense families and, under FSDP, a conv family:
each flax leaf's axes are found in the port's tensor by carrying index
arrays through ``state_dict_from_jax_params``.

One gloo world of four ranks on the CPU (data 2 x model 2), spawned once
for the module on a ``FileStore``, runs every scenario; the test process
holds the ranks' results to the one-process run of the same thing:

  * FSDP over the two data ranks equals data parallelism over them bit
    for bit (the model axis replicates);
  * TP and FSDP x TP fits of ``RNASeqVAE`` (512 genes, hidden 64) equal one
    process within rtol 1e-3 on the history (JAX's bound,
    ``tests/test_parallel.py``) and ``_assert_fit_close`` on the
    parameters, with ``epochs_per_dispatch`` 1 and 2, and ``fit_streamed``
    under TP;
  * a poisoned row on one rank skips the step on every rank, with the
    gradients clipped to the global norm;
  * elastic resume: a one-process checkpoint resumed under FSDP, and an
    FSDP checkpoint resumed by one process;
  * K3's ``train_step_fn`` and K2's fused ``loss_fn`` under a layout run on
    gathered whole tensors: the one-process fit bit for bit;
  * the sharded layers' forward and backward against the unsharded
    modules; the memory preflight's per-rank bytes; a callback under a
    layout handed the model's own layers and whole weights;
  * the multichip dry run's legs at a small width.

A spawned world waits at most 60 s in a collective and 150 s in all
before its processes are killed.
"""

from __future__ import annotations

import datetime
import multiprocessing
import sys
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hyperbolic_vae_tpu_torch.data import make_data_module
from hyperbolic_vae_tpu_torch.data.core import ArrayDataModule
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE, RNASeqVAE
from hyperbolic_vae_tpu_torch.parallel import (
    fsdp_param_shardings,
    fsdp_tp_param_shardings,
    make_mesh,
    opt_state_shardings,
    tp_param_shardings,
)
from hyperbolic_vae_tpu_torch.train import Trainer

WORLD = 4
TIMEOUT = 60
JOIN_SECONDS = 150
GENES, HIDDEN = 512, 64
RULES = {"tp": tp_param_shardings, "fsdp": fsdp_param_shardings,
         "fsdp_tp": fsdp_tp_param_shardings}


def _rna_dm(n_train=256, n_val=64, batch=64, counts=False):
    rng = np.random.default_rng(0)
    if counts:  # raw counts with one negative (poisoned) row
        x = rng.poisson(1.0, (n_train, GENES)).astype(np.float32)
        x[37, 3] = -1.0
    else:
        x = rng.normal(0, 1, (n_train, GENES)).astype(np.float32)
    y = np.zeros(n_train, np.int32)
    return ArrayDataModule(x_train=x, y_train=y, x_val=x[:n_val], y_val=y[:n_val],
                           x_test=x[:n_val], y_test=y[:n_val], batch_size=batch)


def _rna(**kw):
    return RNASeqVAE(in_features=GENES, hidden_dim=HIDDEN, device="cpu",
                     generator=torch.Generator().manual_seed(0), **kw)


def _flagship():
    return GyroplaneVAE(device="cpu", generator=torch.Generator().manual_seed(0))


def _mnist():
    return make_data_module(batch_size=64, synthetic=True, n_train=256, n_test=66)


def _trainer(model, mesh=None, rule=None, **kw):
    kw = dict(dict(max_epochs=2, early_stopping_patience=None, seed=5, plateau_patience=1000,
                   device="cpu"), **kw)
    return Trainer(model, mesh=mesh, param_sharding_fn=RULES[rule] if mesh and rule else None,
                   **kw)


def _record(r):
    return {"history": r.history, "params": r.params, "best": r.best_params,
            "best_metric": r.best_metric, "epochs": r.epochs_run}


def _tail(rec):
    return dict(rec, history=rec["history"][1:], epochs=rec["epochs"])


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


# ---- the scenarios, each run by every rank (mesh) and by one process (None) ----


def _fit(rule, k=1):
    def run(mesh, out):
        return _record(_trainer(_rna(), mesh, rule, epochs_per_dispatch=k).fit(_rna_dm()))
    return run


def _guard(mesh, out):
    """nb counts with a poisoned row, clipped to the global norm."""
    t = _trainer(_rna(recon="nb"), mesh, "fsdp_tp", grad_clip_norm=1.0)
    return _record(t.fit(_rna_dm(counts=True)))


def _streamed(mesh, out):
    return _record(_trainer(_rna(), mesh, "tp").fit_streamed(_rna_dm(), block_rows=128))


def _resume_up(mesh, out):
    """One process saves after one epoch; the mesh resumes under FSDP."""
    if mesh is None:
        return _tail(_record(_trainer(_rna()).fit(_rna_dm())))
    ckpt = str(out / "resume_up")
    if _rank() == 0:
        _trainer(_rna(), max_epochs=1, checkpoint_dir=ckpt).fit(_rna_dm())
    dist.barrier()
    return _record(_trainer(_rna(), mesh, "fsdp", checkpoint_dir=ckpt).fit(_rna_dm(), resume=True))


def _resume_down(mesh, out):
    """The mesh saves under FSDP after one epoch; one process resumes."""
    if mesh is None:
        return _tail(_record(_trainer(_rna()).fit(_rna_dm())))
    ckpt = str(out / "resume_down")
    _trainer(_rna(), mesh, "fsdp", max_epochs=1, checkpoint_dir=ckpt).fit(_rna_dm())
    dist.barrier()
    rec = None
    if _rank() == 0:
        rec = _record(_trainer(_rna(), checkpoint_dir=ckpt).fit(_rna_dm(), resume=True))
    dist.barrier()
    return rec


def _k3(mesh, out):
    from hyperbolic_vae_tpu_torch.ops import make_fused_train_step

    m = _flagship()
    return _record(_trainer(m, mesh, "tp", train_step_fn=make_fused_train_step(m)).fit(_mnist()))


def _k2(mesh, out):
    from hyperbolic_vae_tpu_torch.ops import make_fused_loss_fn

    m = _flagship()
    return _record(_trainer(m, mesh, "fsdp_tp", loss_fn=make_fused_loss_fn(m)).fit(_mnist()))


SCENARIOS = {
    "dp": _fit(None),
    "fsdp": _fit("fsdp"),
    "tp_k1": _fit("tp"),
    "tp_k2": _fit("tp", k=2),
    "fsdp_tp_k1": _fit("fsdp_tp"),
    "fsdp_tp_k2": _fit("fsdp_tp", k=2),
    "guard": _guard,
    "streamed": _streamed,
    "resume_up": _resume_up,
    "resume_down": _resume_down,
    "k3": _k3,
    "k2": _k2,
}


def _layers(mesh, out):
    """The sharded layers on one input against the unsharded modules:
    outputs, the input's gradient and each rank's piece of the weights'."""
    from torch import nn

    from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
    from hyperbolic_vae_tpu_torch.nn import PoincareHyperplanes
    from hyperbolic_vae_tpu_torch.parallel import (
        ColumnParallelLinear,
        PlaneShardedHyperplanes,
        RowParallelLinear,
    )

    g = torch.Generator().manual_seed(3)
    lin, lin_t = nn.Linear(12, 8), nn.Linear(8, 8)
    planes = PoincareHyperplanes(2, 8, PoincareBall(1.0), generator=g)
    with torch.no_grad():
        for p in list(lin.parameters()) + list(lin_t.parameters()):
            p.copy_(torch.randn(p.shape, generator=g))
    x = torch.randn(5, 12, generator=g)
    z = torch.randn(5, 2, generator=g) * 0.3
    w_out = torch.randn(5, 8, generator=g)

    def run(module, inp):
        inp = inp.clone().requires_grad_()
        y = module(inp)
        (y * w_out).sum().backward()
        return y.detach(), inp.grad, {n: p.grad for n, p in module.named_parameters()}

    res = {"column": run(ColumnParallelLinear(lin, mesh, gather_output=True), x),
           "full_linear": run(lin, x),
           "row": run(RowParallelLinear(lin_t, mesh), x[:, :8]),
           "full_row": run(lin_t, x[:, :8]),
           "planes": run(PlaneShardedHyperplanes(planes, mesh, gather_output=True), z),
           "full_planes": run(planes, z)}
    res["lo_hi"] = (mesh.coord("model") * 4, mesh.coord("model") * 4 + 4)
    return res


def _memory(mesh, out):
    t = _trainer(_rna(), mesh, "fsdp_tp")
    est = t.memory_estimate(_rna_dm(), [t.model])
    r = t.fit(_rna_dm(n_train=128))
    specs = opt_state_shardings(t.optimizer, mesh)
    return {"estimate": est, "opt_specs": specs, "params": {k: tuple(v.shape)
                                                            for k, v in r.params.items()}}


class _Seen:
    """A callback recording what it is handed at each epoch's end."""

    def __init__(self, dm):
        self.dm, self.seen = dm, []

    def on_epoch_end(self, trainer, epoch, params, metrics):
        model = trainer.model
        self.seen.append({
            "layers": [type(m).__name__ for m in (*model.encoder, *model.decoder)],
            "live": all(params[k].data_ptr() == v.data_ptr()
                        for k, v in model.state_dict().items()),
            "params": {k: v.detach().clone() for k, v in params.items()},
            "mu": trainer.encode_split(self.dm)[0]})


def _callbacks(mesh, out):
    """A callback during an FSDP x TP fit, which encodes the val split."""
    dm = _rna_dm()
    cb = _Seen(dm)
    t = _trainer(_rna(), mesh, "fsdp_tp", callbacks=[cb])
    r = t.fit(dm)
    return {"seen": cb.seen, "params": r.params, "mu": t.encode_split(dm)[0]}


def _dryrun(mesh, out):
    from hyperbolic_vae_tpu_torch.tools import dryrun_multichip

    return dryrun_multichip.rank_legs(mesh, dryrun_multichip.small_config())


def _refusals(mesh, out):
    def message(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - the message is the result
            return f"{type(e).__name__}: {e}"
        return None

    odd = RNASeqVAE(in_features=GENES, hidden_dim=63, device="cpu")
    return {
        "uneven": message(lambda: _trainer(odd, mesh, "tp").fit(_rna_dm())),
        "ensemble": message(lambda: _trainer(_rna(), mesh, "fsdp").fit_ensemble(_rna_dm(), [1])),
        "conv_tp": message(lambda: tp_param_shardings(_conv(), mesh)),
    }


def _conv():
    from hyperbolic_vae_tpu_torch.models import EuclideanVAE

    return EuclideanVAE((16, 16, 1), hidden_size=16, device="cpu")


WORLD_ONLY = {"layers": _layers, "memory": _memory, "dryrun": _dryrun, "refusals": _refusals,
              "callbacks": _callbacks}


def _rank_main(rank: int, store_path: str, out: str) -> None:
    from pathlib import Path

    out = Path(out)
    torch.set_num_threads(1)  # four ranks beside the other test workers
    sys.modules["tensorflow"] = None  # a log_dir would import it (~13 s)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=TIMEOUT))
    results = {}
    try:
        mesh = make_mesh(n_data=2, n_model=2, device="cpu")
        for name, fn in dict(SCENARIOS, **WORLD_ONLY).items():
            try:
                results[name] = fn(mesh, out)
            except Exception:  # noqa: BLE001 - reported by the test that reads it
                results[name] = {"error": traceback.format_exc()}
        results["mesh"] = {"coord": (mesh.coord("data"), mesh.coord("model"))}
    finally:
        torch.save(results, out / f"rank{rank}.pt")
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's results: {scenario: result}."""
    out = tmp_path_factory.mktemp("world")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(out / "store"), str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=JOIN_SECONDS)
    for p in procs:
        p.join(max((deadline - datetime.datetime.now()).total_seconds(), 0.1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"the gloo world did not finish in {JOIN_SECONDS} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, out


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The one-process results of the same scenarios (no mesh), by name."""
    out = tmp_path_factory.mktemp("single")
    cache = {}

    def get(name):
        if name not in cache:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)  # the ranks' threads: the CPU's products round alike
            try:
                cache[name] = SCENARIOS[name](None, out)
            finally:
                torch.set_num_threads(threads)
        return cache[name]

    return get


def _ok(result):
    if isinstance(result, dict) and "error" in result:
        pytest.fail(result["error"])
    return result


def _assert_same(a, b):
    """Bit for bit: the history (NaN where NaN) and every parameter."""
    assert len(a["history"]) == len(b["history"])
    for ha, hb in zip(a["history"], b["history"]):
        assert ha.keys() == hb.keys()
        np.testing.assert_array_equal([ha[k] for k in hb], [hb[k] for k in hb])
    for which in ("params", "best"):
        assert a[which].keys() == b[which].keys()
        for k in a[which]:
            assert torch.equal(a[which][k], b[which][k]), (which, k)


def _assert_fit_close(got, want, rtol=1e-3, lr=1e-3):
    """The history within ``rtol`` (JAX's bound for TP); the parameters as
    ``tests/test_torch_port_parallel.py::_assert_fit_close`` holds them
    (rtol, atol 1e-6, but for at most 0.01 % of the elements, none of which
    is off by more than lr a step)."""
    assert got["epochs"] == want["epochs"]
    assert len(got["history"]) == len(want["history"])
    for hg, hw in zip(got["history"], want["history"]):
        assert hg.keys() == hw.keys()
        np.testing.assert_allclose([hg[k] for k in hw], [hw[k] for k in hw], rtol=rtol)
    steps = got["epochs"] * 4
    for which in ("params", "best"):
        for k, v in want[which].items():
            g, w = got[which][k].numpy(), v.numpy()
            assert g.shape == w.shape, (which, k)
            off = ~np.isclose(g, w, rtol=rtol, atol=1e-6)
            assert off.mean() <= 1e-4, (which, k, int(off.sum()), off.size)
            assert np.abs(g - w).max() <= steps * lr, (which, k)


# ---- the layouts against JAX's -----------------------------------------------


class _Grid:
    """A mesh's shape alone: what the rules read."""

    def __init__(self, **shape):
        self.shape = shape


def _jax_pair(family):
    """(JAX model, its input shape, the port model) of one configuration."""
    import hyperbolic_vae_tpu.models as jm
    import hyperbolic_vae_tpu_torch.models as pm

    if family == "flagship":
        return jm.GyroplaneVAE(data_shape=(28, 28, 1), latent_dim=2), (28, 28, 1), _flagship()
    if family == "rnaseq":
        return (jm.RNASeqVAE(in_features=GENES, hidden_dim=HIDDEN, recon="nb"), (GENES,),
                _rna(recon="nb"))
    if family == "unified":
        kw = dict(input_size=(GENES,), hidden_layer_dim=HIDDEN, latent_dim=2)
        return jm.UnifiedVAE(**kw), (GENES,), pm.UnifiedVAE(**kw, device="cpu")
    if family == "pvae":
        kw = dict(data_shape=(28, 28, 1), hidden_dim=600, latent_dim=2, posterior="wrapped",
                  decoder_first="geodesic")
        return jm.PvaeMLPVAE(**kw), (28, 28, 1), pm.PvaeMLPVAE(**kw, device="cpu")
    if family == "conv":
        return (jm.EuclideanVAE(data_shape=(16, 16, 1), hidden_size=16), (16, 16, 1), _conv())
    raise KeyError(family)


def _expected_specs(family, rule, grid):
    """JAX's specs for the port's keys: each flax leaf's spec carried onto
    the torch dimensions its axes become."""
    import jax
    import jax.numpy as jnp

    from hyperbolic_vae_tpu.parallel import make_mesh as jax_make_mesh
    from hyperbolic_vae_tpu.parallel import sharding_rules as jr

    from hyperbolic_vae_tpu_torch.interop import state_dict_from_jax_params

    jmodel, shape, port = _jax_pair(family)
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    tree = jax.eval_shape(jmodel.init, keys, jnp.zeros((2,) + shape))["params"]
    mesh = jax_make_mesh(**grid)
    shardings = getattr(jr, f"{rule}_param_shardings")(tree, mesh)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree_util.tree_leaves(shardings)
    offsets, arrays = [], []
    off = 0
    for _, leaf in leaves:
        offsets.append(off)
        arrays.append(np.arange(off, off + int(np.prod(leaf.shape)), dtype=np.float64)
                      .reshape(leaf.shape))
        off += int(np.prod(leaf.shape))
    assert off < 2 ** 24  # f32 holds every index exactly
    index_tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree), arrays)
    sd = state_dict_from_jax_params(index_tree, port)
    want = {}
    for key, t in sd.items():
        t = t.double().numpy()
        j = int(np.searchsorted(offsets, t.reshape(-1)[0], side="right")) - 1
        fshape = leaves[j][1].shape
        jspec = tuple(specs[j].spec) + (None,) * (len(fshape) - len(tuple(specs[j].spec)))
        spec = []
        for d in range(t.ndim):
            line = np.moveaxis(t, d, 0).reshape(t.shape[d], -1)[:, 0] - offsets[j]
            coords = np.array(np.unravel_index(line.astype(np.int64), fshape))
            moving = [a for a in range(len(fshape)) if len(set(coords[a])) > 1]
            spec.append(jspec[moving[0]] if moving else None)
        want[key] = tuple(spec)
    return port, want


@pytest.mark.parametrize("family,rule", [(f, r) for f in ("flagship", "rnaseq", "unified", "pvae")
                                         for r in ("tp", "fsdp", "fsdp_tp")] + [("conv", "fsdp")])
@pytest.mark.parametrize("grid", [{"n_data": 4, "n_model": 2}, {"n_data": 8}],
                         ids=["data4xmodel2", "data8"])
def test_layouts_equal_jax_key_by_key(family, rule, grid):
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs the virtual CPU devices of tests/conftest.py")
    port, want = _expected_specs(family, rule, grid)
    got = RULES[rule](port, _Grid(data=grid["n_data"], model=grid.get("n_model", 1)))
    assert set(got) == set(port.state_dict())
    for key in want:
        assert got[key] == want[key], (key, got[key], want[key])
    for key in set(got) - set(want):  # keys JAX has no leaf for stay replicated
        assert all(a is None for a in got[key]), key


def test_uneven_dimension_refused_naming_key_and_sizes():
    odd = RNASeqVAE(in_features=GENES, hidden_dim=63, device="cpu")
    with pytest.raises(ValueError, match=r"encoder\.0\.weight: dimension 0 of size 63 does not "
                                         r"split evenly over the 2 ranks of the 'model' axis"):
        tp_param_shardings(odd, _Grid(data=2, model=2))


def test_tp_layout_follows_the_declared_roles():
    """The TP rule reads the layers a model declares (``tp_roles``), not its
    class's name: a renamed subclass gets its family's layout, a model
    that declares none is refused."""
    class Renamed(RNASeqVAE):
        pass

    class Undeclared(RNASeqVAE):
        tp_roles = None

    grid = _Grid(data=2, model=2)
    want = tp_param_shardings(_rna(), grid)
    assert want["decoder.0.points"] == ("model", None)
    assert want["decoder.2.weight"] == (None, "model")
    assert tp_param_shardings(Renamed(in_features=GENES, hidden_dim=HIDDEN, device="cpu"),
                              grid) == want
    with pytest.raises(ValueError, match="Undeclared declares no tensor-parallel roles"):
        tp_param_shardings(Undeclared(in_features=GENES, hidden_dim=HIDDEN, device="cpu"), grid)


def test_layout_needs_a_mesh():
    with pytest.raises(ValueError, match="param_sharding_fn lays the parameters out over a mesh"):
        Trainer(_rna(), param_sharding_fn=tp_param_shardings, device="cpu")


# ---- the four ranks ---------------------------------------------------------------


def test_fsdp_equals_data_parallel_bit_for_bit(world):
    """FSDP over two data ranks: each rank's fit is data parallelism's over
    the same two ranks, bit for bit (a sum of two terms is the same in the
    reduce-scatter and the all-reduce; Adam is elementwise)."""
    ranks, _ = world
    for r in ranks:
        _assert_same(_ok(r["fsdp"]), _ok(r["dp"]))


@pytest.mark.parametrize("name", ["tp_k1", "tp_k2", "fsdp_tp_k1", "fsdp_tp_k2", "streamed"])
def test_sharded_fit_matches_one_process(world, single, name):
    """TP and FSDP x TP over data 2 x model 2: one process's fit within
    rtol 1e-3; every rank returns the same whole parameters."""
    ranks, _ = world
    recs = [_ok(r[name]) for r in ranks]
    for r in recs[1:]:
        _assert_same(r, recs[0])
    _assert_fit_close(recs[0], single(name))


def test_epochs_per_dispatch_is_bit_for_bit_under_a_layout(world):
    ranks, _ = world
    for r in ranks:
        _assert_same(_ok(r["tp_k1"]), _ok(r["tp_k2"]))
        _assert_same(_ok(r["fsdp_tp_k1"]), _ok(r["fsdp_tp_k2"]))


def test_poisoned_row_skips_the_step_on_every_rank(world, single):
    """One rank's rows hold the poisoned row: its NaN reaches every rank
    through the global norm, so every rank skips the step (the one-process
    fit's skips), with the gradients clipped to the global norm."""
    ranks, _ = world
    want = single("guard")
    recs = [_ok(r["guard"]) for r in ranks]
    for r in recs[1:]:
        _assert_same(r, recs[0])
    skipped = [h["train/skipped_steps"] for h in recs[0]["history"]]
    assert skipped == [h["train/skipped_steps"] for h in want["history"]]
    assert all(s > 0 for s in skipped)
    _assert_fit_close(recs[0], want)
    for v in recs[0]["params"].values():
        assert torch.isfinite(v).all()


@pytest.mark.parametrize("name", ["resume_up", "resume_down"])
def test_elastic_resume(world, single, name):
    """One process -> FSDP over the mesh, and FSDP -> one process: the
    resumed epoch and parameters are the uninterrupted fit's within the
    data-parallel tolerance."""
    ranks, _ = world
    got = [_ok(r[name]) for r in ranks]
    if name == "resume_down":
        got = got[:1]  # rank 0 alone resumes
    for g in got:
        assert [h["epoch"] for h in g["history"]] == [1]
        _assert_fit_close(g, single(name), rtol=1e-4)


@pytest.mark.parametrize("name", ["k3", "k2"])
def test_whole_batch_steps_under_a_layout_equal_one_process(world, single, name):
    """K3 (``train_step_fn``) under TP and K2 (the fused ``loss_fn``) under
    FSDP x TP run on gathered whole tensors, as JAX runs a Pallas call under
    a layout (ROADMAP Queue 3): the one-process fit bit for bit."""
    ranks, _ = world
    for r in ranks:
        _assert_same(_ok(r[name]), single(name))


def test_sharded_layers_against_the_unsharded_modules(world):
    ranks, _ = world
    for r in ranks:
        res = _ok(r["layers"])
        lo, hi = res["lo_hi"]
        y, gx, gp = res["column"]
        fy, fgx, fgp = res["full_linear"]
        assert torch.equal(y, fy)  # the gather is exact
        torch.testing.assert_close(gx, fgx, rtol=1e-6, atol=1e-6)
        assert torch.equal(gp["weight"], fgp["weight"][lo:hi])
        y, gx, gp = res["row"]
        fy, fgx, fgp = res["full_row"]
        torch.testing.assert_close(y, fy, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(gx, fgx, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(gp["weight"], fgp["weight"][:, lo:hi])
        assert torch.equal(gp["bias"], fgp["bias"])  # every rank's bias gradient is rank 0's
        y, gz, gp = res["planes"]
        fy, fgz, fgp = res["full_planes"]
        # the plain version's product rounds by its shape on the CPU (the
        # kernel's plane shards are the whole launch's columns bit for bit:
        # chip_smoke.py's shard_phase)
        torch.testing.assert_close(y, fy, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(gz, fgz, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(gp["points"], fgp["points"][lo:hi], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gp["bias"], fgp["bias"][lo:hi], rtol=1e-5, atol=1e-6)


def test_memory_preflight_counts_a_ranks_pieces(world):
    """Under FSDP x TP (data 2 x model 2) a rank holds a quarter of each
    wide weight, its moments and best copy, and gathers its 'model' piece
    whole over 'data' for the forward."""
    ranks, _ = world
    res = _ok(ranks[0]["memory"])
    est = res["estimate"]
    wide = 2 * (GENES * HIDDEN // 4) * 4  # encoder.0 and decoder.2, a quarter each
    small = (HIDDEN // 2 + 2 * (HIDDEN * 2 + 2) + HIDDEN // 2 * 2 + HIDDEN // 2 + GENES) * 4
    assert est["params+best"] == 2 * (wide + small)
    assert est["opt"] == 2 * (wide + small)
    assert est["gathered"] == 2 * (GENES * HIDDEN // 2) * 4
    specs = res["opt_specs"]["state"]
    assert specs[0] == {"exp_avg": ("model", "data"), "exp_avg_sq": ("model", "data")}
    assert res["opt_specs"]["count"] == ()
    assert res["params"]["encoder.0.weight"] == (HIDDEN, GENES)  # results are whole


def test_callbacks_see_the_whole_model_under_a_layout(world):
    """Under FSDP x TP a callback is handed the model one process holds:
    its own layers (no tensor-parallel layer), its live weights whole (no
    copy), the last epoch's equal to the fit's result, and an encode of
    the val split inside it equal to one after the fit."""
    ranks, _ = world
    for r in ranks:
        res = _ok(r["callbacks"])
        assert len(res["seen"]) == 2
        for s in res["seen"]:
            assert s["layers"] == ["WideLinear", "GELU", "PoincareHyperplanes", "GELU",
                                   "WideLinear", "Sigmoid"]
            assert s["live"]
        last = res["seen"][-1]
        assert last["params"].keys() == res["params"].keys()
        for k, v in res["params"].items():
            assert torch.equal(last["params"][k], v), k
        np.testing.assert_array_equal(last["mu"], res["mu"])


def test_dryrun_legs_at_a_small_width(world):
    """``tools/dryrun_multichip``'s legs on the four ranks, checked by its
    own envelope against one process (run here)."""
    from hyperbolic_vae_tpu_torch.tools import dryrun_multichip

    ranks, _ = world
    legs = [_ok(r["dryrun"]) for r in ranks]
    report = dryrun_multichip.check(legs, dryrun_multichip.small_config(), mesh_shape=(2, 2))
    assert report["ok"], report


@pytest.mark.slow
def test_dryrun_multichip_full_width():
    """The dry run at JAX's width (20,480 genes, hidden 256) on four gloo
    ranks, as ``python -m hyperbolic_vae_tpu_torch.tools.dryrun_multichip 4``
    runs it (JAX marks its own dry run slow too)."""
    from hyperbolic_vae_tpu_torch.tools import dryrun_multichip

    report = dryrun_multichip.run(4)
    assert report["ok"], report["failures"]


def test_refusals(world):
    ranks, _ = world
    msgs = _ok(ranks[0]["refusals"])
    assert "encoder.0.weight: dimension 0 of size 63 does not split evenly" in msgs["uneven"]
    assert "does not compose with param_sharding_fn" in msgs["ensemble"]
    assert "EuclideanVAE declares no tensor-parallel roles" in msgs["conv_tp"]


def test_world_of_four(world):
    ranks, _ = world
    assert [r["mesh"]["coord"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


# ---- on the card -----------------------------------------------------------------


@pytest.fixture()
def world_of_one():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("rule", ["tp", "fsdp", "fsdp_tp"])
def test_world_of_one_layout_equals_unsharded_bit_for_bit(world_of_one, rule):
    """At one rank every layout keeps its collectives and changes no bit."""
    mesh = make_mesh(device="cpu")
    want = _record(_trainer(_rna()).fit(_rna_dm(n_train=128)))
    _assert_same(_record(_trainer(_rna(), mesh, rule).fit(_rna_dm(n_train=128))), want)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["tp", "fsdp_tp"])
def test_nccl_world_of_one_graphed_layout_equals_unsharded(world_of_one, rule):
    """NCCL at world size 1: the graphed fit under a layout (its gathers,
    reduce-scatters and all-reduces captured with the step; K1 on the
    plane shard) equals the unsharded fit and its own eager run bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mesh = make_mesh()

    def fit(m, r):
        model = RNASeqVAE(in_features=GENES, hidden_dim=HIDDEN, device="cuda",
                          generator=torch.Generator().manual_seed(0))
        t = Trainer(model, max_epochs=2, early_stopping_patience=None, seed=5, mesh=m,
                    param_sharding_fn=RULES[r] if r else None)
        return _record(t.fit(_rna_dm()))

    from hyperbolic_vae_tpu_torch.train.cuda_graph import run_eagerly

    graphed = fit(mesh, rule)
    _assert_same(graphed, fit(None, None))
    with run_eagerly():  # the same program's pieces without graphs
        _assert_same(graphed, fit(mesh, rule))
