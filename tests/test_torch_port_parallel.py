"""Data and seed parallelism over ``torch.distributed`` (``parallel/``).

Two ranks of gloo on the CPU, spawned once for the module on a
``FileStore`` under a temporary directory, run every scenario; the test
process holds each rank's results to the one-process run of the same
thing: a data-parallel flagship fit (``epochs_per_dispatch`` 1 and 2,
gradient accumulation, resume, a streamed fit) within rtol 1e-4 with the
two ranks' parameters bit for bit equal; ``evaluate``, ``evaluate_iwae``,
``encode_split`` and ``Inferencer(mesh=...)`` under the mesh; four seed
lanes over two ranks bit for bit the one-process ``fit_ensemble``; the
refusals JAX pins. The padded staging of an odd split is held to JAX's
``Trainer(mesh=make_mesh(n_data=2))._stage`` on the 8 virtual CPU devices
of ``tests/conftest.py``. A world of size 1 (gloo here, NCCL on the
card) equals the unmeshed run bit for bit.

A spawned world waits at most 60 s in a collective and 110 s in all
before its processes are killed, so a hang fails the module in under
two minutes.
"""

from __future__ import annotations

import datetime
import json
import math
import multiprocessing
import sys
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hyperbolic_vae_tpu_torch.data import make_data_module
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.parallel import make_mesh, make_seed_mesh
from hyperbolic_vae_tpu_torch.parallel.mesh import share
from hyperbolic_vae_tpu_torch.serve import Inferencer
from hyperbolic_vae_tpu_torch.train import Trainer

WORLD = 2
SEEDS = [1, 2, 3, 4]
TIMEOUT = 60
JOIN_SECONDS = 110


def _dm(n_train=256, n_test=66, batch=64):
    return make_data_module(batch_size=batch, synthetic=True, n_train=n_train, n_test=n_test)


def _model():
    return GyroplaneVAE(device="cpu", generator=torch.Generator().manual_seed(0))


def _trainer(mesh=None, **kw):
    kw = dict(dict(max_epochs=2, early_stopping_patience=None, seed=7, device="cpu"), **kw)
    return Trainer(_model(), mesh=mesh, **kw)


def _fit_record(r):
    return {"history": r.history, "params": r.params, "best": r.best_params,
            "best_metric": r.best_metric, "epochs": r.epochs_run}


def _message(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the message is the result
        return f"{type(e).__name__}: {e}"
    return None


# ---- the scenarios, each run by every rank and by one process ----------------


def _fit(mesh, out, k):
    ckpt = out / f"ckpt_k{k}" if mesh is not None else None
    t = _trainer(mesh, epochs_per_dispatch=k, checkpoint_dir=ckpt and str(ckpt),
                 log_dir=ckpt and str(ckpt))
    return _fit_record(t.fit(_dm()))


def _fit_accum(mesh, out):
    return _fit_record(_trainer(mesh, grad_accum_steps=2).fit(_dm()))


def _fit_streamed(mesh, out):
    return _fit_record(_trainer(mesh).fit_streamed(_dm(), block_rows=128))


def _resume(mesh, out):
    ckpt = str(out / "resume")
    _trainer(mesh, max_epochs=1, checkpoint_dir=ckpt).fit(_dm())
    return _fit_record(_trainer(mesh, checkpoint_dir=ckpt).fit(_dm(), resume=True))


def _evaluate(mesh, out):
    t = _trainer(mesh)
    dm = _dm()
    z, y = t.encode_split(dm, None, "val")
    return {"test": t.evaluate(dm, None, "test"), "iwae": t.evaluate_iwae(dm, None, k=6,
                                                                          batch_chunk=25),
            "encode": torch.from_numpy(z), "labels": torch.from_numpy(y)}


def _inferencer(mesh, out):
    # under the mesh 9 rounds up to 10, the one-process engine's batch
    inf = Inferencer(_model(), batch_size=9 if mesh is not None else 10, device="cpu", mesh=mesh)
    x = _dm().x_test[:47]
    return {"embed": torch.from_numpy(inf.embed(x)), "recon": torch.from_numpy(inf.reconstruct(x)),
            "generate": torch.from_numpy(inf.generate(23, seed=3)), "batch": inf.batch_size,
            "programs": inf.n_programs}


def _ensemble(mesh, out):
    seed_mesh = make_seed_mesh(WORLD, device="cpu") if mesh is not None else None
    res = _trainer().fit_ensemble(_dm(n_train=128), SEEDS, seed_mesh=seed_mesh)
    return [_fit_record(r) for r in res]


def _ensemble_resume(mesh, out):
    """One epoch, stopped, then resumed to two: each rank saves and resumes
    its own lanes."""
    seed_mesh = make_seed_mesh(WORLD, device="cpu") if mesh is not None else None
    ckpt = str(out / "ensemble_resume")
    _trainer(max_epochs=1, checkpoint_dir=ckpt).fit_ensemble(_dm(n_train=128), SEEDS,
                                                             seed_mesh=seed_mesh)
    res = _trainer(checkpoint_dir=ckpt).fit_ensemble(_dm(n_train=128), SEEDS,
                                                      seed_mesh=seed_mesh, resume=True)
    return [_fit_record(r) for r in res]


def _refusals(mesh, out):
    seed_mesh = make_seed_mesh(WORLD, device="cpu")
    return {
        "uneven_lanes": _message(lambda: _trainer().fit_ensemble(_dm(), [1, 2, 3],
                                                                 seed_mesh=seed_mesh)),
        "block_rows": _message(lambda: _trainer(mesh).fit_streamed(_dm(), block_rows=65)),
        "ensemble_on_data_mesh": _message(lambda: _trainer(mesh).fit_ensemble(_dm(), [1, 2])),
        "param_sharding": _message(lambda: _trainer(mesh, param_sharding_fn=lambda p, m: p)),
        "seed_mesh_as_data_mesh": _message(lambda: _trainer(seed_mesh)),
    }


SCENARIOS = {
    "fit_k1": lambda mesh, out: _fit(mesh, out, 1),
    "fit_k2": lambda mesh, out: _fit(mesh, out, 2),
    "fit_accum": _fit_accum,
    "fit_streamed": _fit_streamed,
    "resume": _resume,
    "evaluate": _evaluate,
    "inferencer": _inferencer,
    "ensemble": _ensemble,
    "ensemble_resume": _ensemble_resume,
}


def _rank_main(rank: int, store_path: str, out: str) -> None:
    from pathlib import Path

    out = Path(out)
    torch.set_num_threads(1)  # two ranks beside the other test workers: no oversubscription
    # rank 0's log_dir imports torch.utils.tensorboard, which imports TensorFlow
    # (~13 s) unless it is hidden (tensorboard's own writer then writes the
    # events), while rank 1 waits in the first collective
    sys.modules["tensorflow"] = None
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=TIMEOUT))
    results = {}
    try:
        mesh = make_mesh(device="cpu")
        for name, fn in dict(SCENARIOS, refusals=_refusals).items():
            try:
                results[name] = fn(mesh, out)
            except Exception:  # noqa: BLE001 - reported by the test that reads it
                results[name] = {"error": traceback.format_exc()}
        results["mesh"] = {"shape": mesh.shape, "coord": mesh.coord("data"), "size": mesh.size}
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


def _assert_fit_close(got, want, rtol=1e-4, lr=1e-3):
    """The history within ``rtol``; the parameters within ``rtol`` (atol
    1e-6) but for at most 0.01 % of their elements, none of which is off by
    more than lr a step: Adam divides a gradient by its own running RMS, so
    an element whose gradient is rounding noise (a pixel that is 0 in
    every image) moves by up to lr whichever way the noise rounds."""
    assert got["epochs"] == want["epochs"]
    for hg, hw in zip(got["history"], want["history"]):
        assert hg.keys() == hw.keys()
        np.testing.assert_allclose([hg[k] for k in hw], [hw[k] for k in hw], rtol=rtol)
    steps = sum(1 for _ in got["history"]) * 4  # 4 steps an epoch at these sizes
    for which in ("params", "best"):
        for k, v in want[which].items():
            g, w = got[which][k].numpy(), v.numpy()
            off = ~np.isclose(g, w, rtol=rtol, atol=1e-6)
            assert off.mean() <= 1e-4, (which, k, int(off.sum()), off.size)
            assert np.abs(g - w).max() <= steps * lr, (which, k)


def _assert_ranks_equal(a, b):
    assert a["history"] == b["history"]
    for which in ("params", "best"):
        for k in a[which]:
            assert torch.equal(a[which][k], b[which][k]), (which, k)


@pytest.mark.parametrize("name", ["fit_k1", "fit_k2", "fit_accum", "fit_streamed", "resume"])
def test_data_parallel_fit_matches_one_process(world, single, name):
    """Two ranks, each on its half of every batch with the global batch's
    draws, summing gradients: the one-process fit within rtol 1e-4, the
    ranks bit for bit equal."""
    ranks, _ = world
    r0, r1 = _ok(ranks[0][name]), _ok(ranks[1][name])
    _assert_ranks_equal(r0, r1)
    _assert_fit_close(r0, single(name))


def test_epochs_per_dispatch_is_bit_for_bit_under_a_mesh(world):
    ranks, _ = world
    _assert_ranks_equal(_ok(ranks[0]["fit_k1"]), _ok(ranks[0]["fit_k2"]))


def test_rank_zero_alone_writes_logs_and_checkpoints(world):
    """The metrics file has one line an epoch (rank 0's), and the best
    checkpoint holds rank 0's best parameters."""
    ranks, out = world
    d = out / "ckpt_k1"
    lines = (d / "metrics.jsonl").read_text().splitlines()
    epochs = [json.loads(line)["epoch"] for line in lines if '"epoch"' in line]
    assert epochs == [0, 1]
    best = torch.load(d / "best.pt")
    for k, v in _ok(ranks[0]["fit_k1"])["best"].items():
        assert torch.equal(best[k], v)


def test_evaluate_and_encode_under_the_mesh(world, single):
    ranks, _ = world
    want = single("evaluate")
    for r in ranks:
        got = _ok(r["evaluate"])
        assert got["test"].keys() == want["test"].keys()
        np.testing.assert_allclose([got["test"][k] for k in want["test"]],
                                   [want["test"][k] for k in want["test"]], rtol=1e-5)
        assert math.isclose(got["iwae"], want["iwae"], rel_tol=1e-6)
        np.testing.assert_allclose(got["encode"].numpy(), want["encode"].numpy(), rtol=1e-6,
                                   atol=1e-7)
        assert torch.equal(got["labels"], want["labels"])
    assert _ok(ranks[0]["evaluate"])["test"] == _ok(ranks[1]["evaluate"])["test"]


def test_inferencer_under_the_mesh(world, single):
    """The batch rounded up to the data axis (9 -> 10), no sub-batch
    buckets; every rank returns the whole answer."""
    ranks, _ = world
    want = single("inferencer")
    for r in ranks:
        got = _ok(r["inferencer"])
        assert got["batch"] == 10
        for k in ("embed", "recon", "generate"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6)
    a, b = _ok(ranks[0]["inferencer"]), _ok(ranks[1]["inferencer"])
    assert all(torch.equal(a[k], b[k]) for k in ("embed", "recon", "generate"))


def test_seed_lanes_over_two_ranks_equal_one_process(world, single):
    """Lanes 0-1 on rank 0, 2-3 on rank 1, gathered: bit for bit the
    one-process sweep's lanes, on both ranks."""
    ranks, _ = world
    want = single("ensemble")
    for r in ranks:
        got = _ok(r["ensemble"])
        assert len(got) == len(SEEDS)
        for g, w in zip(got, want):
            _assert_ranks_equal(g, w)
            assert g["best_metric"] == w["best_metric"]


def test_seed_lanes_resume_per_rank(world, single):
    """A sweep stopped after one epoch resumes on each rank from that
    rank's own state: the lanes' second epoch and parameters are the
    uninterrupted one-process sweep's, bit for bit."""
    ranks, out = world
    want = single("ensemble")
    for r in ranks:
        for g, w in zip(_ok(r["ensemble_resume"]), want):
            assert g["history"] == w["history"][1:]
            assert all(torch.equal(g["params"][k], v) for k, v in w["params"].items())
    names = sorted(p.name for p in (out / "ensemble_resume").glob("ensemble_state*.pt"))
    assert names == ["ensemble_state_rank0of2.pt", "ensemble_state_rank1of2.pt"]


def test_refusals_kept(world):
    ranks, _ = world
    msgs = _ok(ranks[0]["refusals"])
    assert "3 seeds do not shard evenly over 2 devices" in msgs["uneven_lanes"]
    assert "block_rows must shard evenly over the mesh 'data' axis" in msgs["block_rows"]
    assert "does not compose with a mesh" in msgs["ensemble_on_data_mesh"]
    assert "item 8b" in msgs["param_sharding"]
    assert "'data' axis" in msgs["seed_mesh_as_data_mesh"]


def test_mesh_of_two(world):
    ranks, _ = world
    assert [r["mesh"]["coord"] for r in ranks] == [0, 1]
    assert ranks[0]["mesh"]["shape"] == {"data": 2, "model": 1}


def test_padded_staging_equals_jax():
    """An odd split is staged padded with its own first rows, row for row
    JAX's ``_stage`` on a 2-device data mesh."""
    import jax

    from hyperbolic_vae_tpu.models import GyroplaneVAE as JaxGyroplaneVAE
    from hyperbolic_vae_tpu.parallel import make_mesh as jax_make_mesh
    from hyperbolic_vae_tpu.train import Trainer as JaxTrainer

    if jax.device_count() < 2:
        pytest.skip("needs the virtual CPU devices of tests/conftest.py")
    x = np.random.default_rng(0).normal(size=(13, 5)).astype(np.float32)
    jt = JaxTrainer(JaxGyroplaneVAE(data_shape=(5,), latent_dim=2), mesh=jax_make_mesh(n_data=2))
    want = np.asarray(jt._stage(x))

    class _TwoRanks:  # the staging reads only the data axis's size
        shape = {"data": 2, "model": 1}

    t = _trainer()
    t.mesh = _TwoRanks()
    got = t._stage(x)
    assert got.shape == (14, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert t._resident(x).shape == (13, 5)


# ---- a world of size 1, in this process -------------------------------------


@pytest.fixture()
def world_of_one():
    """make_mesh() starts a gloo world of size 1 here; torn down after."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_world_of_one_equals_unmeshed_bit_for_bit(world_of_one):
    """The all-reduce is issued at world size 1 and changes no bit."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and dist.get_backend() == "gloo"
    want = _fit_record(_trainer().fit(_dm()))
    got = _fit_record(_trainer(mesh).fit(_dm()))
    _assert_ranks_equal(got, want)
    seeds = _trainer().fit_ensemble(_dm(n_train=128), SEEDS[:2],
                                    seed_mesh=make_seed_mesh(1, device="cpu"))
    for g, w in zip(seeds, _trainer().fit_ensemble(_dm(n_train=128), SEEDS[:2])):
        _assert_ranks_equal(_fit_record(g), _fit_record(w))


def test_mesh_layouts(world_of_one):
    mesh = make_mesh(device="cpu")
    from hyperbolic_vae_tpu_torch.parallel import data_sharding, replicated, shard_batch

    x = torch.arange(12.0).view(6, 2)
    assert torch.equal(shard_batch(mesh, x), x)
    assert torch.equal(replicated(mesh).shard(x), x)
    assert data_sharding(mesh, 2).spec == ("data", None)
    assert [share(7, 3, i) for i in range(3)] == [(0, 3), (3, 5), (5, 7)]
    with pytest.raises(ValueError, match="needs 2 ranks but the world has 1"):
        make_seed_mesh(2, device="cpu")


def test_mixed_loss_reduction_is_refused():
    from hyperbolic_vae_tpu_torch.models import HyperbolicImageVAE
    from hyperbolic_vae_tpu_torch.parallel.data_parallel import loss_weight_kind

    m = HyperbolicImageVAE(data_shape=(8, 8, 1), base_channels=2, loss_recon="bernoulli",
                           device="cpu")
    with pytest.raises(ValueError, match="mixes a mean over rows with a sum"):
        loss_weight_kind(m)
    m = HyperbolicImageVAE(data_shape=(8, 8, 1), base_channels=2, loss_recon="mse", device="cpu")
    assert loss_weight_kind(m) == "batch_sum"


# ---- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "k3"])
def test_nccl_world_of_one_graphed_fit_equals_unmeshed(world_of_one, path):
    """NCCL at world size 1: the graphed data-parallel fit (the all-reduce
    captured with the step) equals the same fit without a mesh, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hyperbolic_vae_tpu_torch.ops import make_fused_train_step

    mesh = make_mesh()
    assert dist.get_backend() == "nccl"

    def fit(m):
        model = GyroplaneVAE(device="cuda", generator=torch.Generator().manual_seed(0))
        kw = {"train_step_fn": make_fused_train_step(model)} if path == "k3" else {}
        t = Trainer(model, max_epochs=2, early_stopping_patience=None, seed=7, mesh=m, **kw)
        r = t.fit(_dm(n_train=1024, n_test=256))
        return {"history": r.history, "params": r.params, "best": r.best_params}

    _assert_ranks_equal(fit(mesh), fit(None))


def test_common_parser_takes_use_mesh():
    """The training CLIs' shared ``--use-mesh`` (JAX's common flag)."""
    from hyperbolic_vae_tpu_torch.experiments.common import base_parser, trainer_extra

    args = base_parser("x").parse_args(["--use-mesh", "--device", "cpu"])
    assert args.use_mesh and trainer_extra(args)["use_mesh"] is True
    assert trainer_extra(base_parser("x").parse_args([]))["use_mesh"] is False
