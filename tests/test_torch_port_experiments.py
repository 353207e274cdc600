"""The port's experiment CLIs on the CPU (``--device cpu --synthetic``,
tiny sizes): experiment 6's ``--seeds``, experiment 7's ``--lane-sweep``
and experiment 9's ``--lane-sweep`` each run, and each lane's best value
(and experiment 7's test metrics, experiment 9's bound) equals the same
CLI's sequential mode."""

import json

import pytest
import torch

from hyperbolic_vae_tpu_torch.experiments import pvae_replicate
from hyperbolic_vae_tpu_torch.experiments import train_vae_hyperbolic_mnist_gyroplane as exp6
from hyperbolic_vae_tpu_torch.experiments import train_vae_hyperbolic_mnist_grid as exp7


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leave_world():
    """Tear down the world of size 1 that a mesh flag started here."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _common(tmp_path, name):
    return ["--device", "cpu", "--synthetic", "--epochs", "2", "--n-train", "120",
            "--n-test", "40", "--batch-size", "32", "--run-dir", str(tmp_path / name),
            "--log-level", "WARNING"]


def test_exp6_seeds_equal_single_fits(tmp_path):
    sweep = exp6.main(_common(tmp_path, "sweep") + ["--seeds", "42", "7"])
    for seed, r in zip((42, 7), sweep):
        single = exp6.main(_common(tmp_path, f"single{seed}") + ["--seed", str(seed)])
        assert r.best_metric == single.best_metric
        assert r.history == single.history
        assert (tmp_path / "sweep" / f"seed_{seed}" / "metrics.jsonl").exists()
    assert (tmp_path / "single42" / "ckpt" / "best.pt").exists()
    # --seed-mesh: the lanes over the world's ranks (one here), the same fits
    try:
        meshed = exp6.main(_common(tmp_path, "mesh1") + ["--seeds", "42", "7", "--seed-mesh", "1"])
        with pytest.raises(SystemExit, match="torchrun --nproc_per_node=2"):
            exp6.main(_common(tmp_path, "mesh") + ["--seeds", "1", "2", "--seed-mesh", "2"])
    finally:
        _leave_world()
    assert [r.history for r in meshed] == [r.history for r in sweep]


def test_exp7_lane_sweep_equals_sequential_grid(tmp_path):
    grid = ["--curvatures", "0.5", "1.4", "--betas", "3.0", "--encoder-lasts", "mobius",
            "--decoder-firsts", "geoopt_gyroplane"]
    lanes = exp7.main(_common(tmp_path, "lanes") + grid + ["--lane-sweep"])
    seq = exp7.main(_common(tmp_path, "seq") + grid)
    assert set(lanes) == {"c0.5_b3.0_d2_mobius_geoopt_gyroplane",
                          "c1.4_b3.0_d2_mobius_geoopt_gyroplane"}
    assert lanes == seq
    assert json.loads((tmp_path / "lanes" / "grid_results.json").read_text()) == lanes
    try:
        with pytest.raises(SystemExit, match="torchrun --nproc_per_node=2"):
            exp7.main(_common(tmp_path, "mesh") + ["--lane-sweep", "--seed-mesh", "2"])
        with pytest.raises(SystemExit, match="does not compose with --lane-sweep"):
            exp7.main(_common(tmp_path, "mesh") + ["--lane-sweep", "--use-mesh"])
    finally:
        _leave_world()


def test_exp7_lane_sweep_isolates_a_failing_group(tmp_path):
    out = exp7.main(_common(tmp_path, "bad") + ["--curvatures", "1.0", "--betas", "1.0",
                                                "--encoder-lasts", "mobius",
                                                "--decoder-firsts", "no_such_layer",
                                                "--lane-sweep"])
    assert out == {"c1.0_b1.0_d2_mobius_no_such_layer": None}


def test_exp9_lane_sweep_equals_sequential(tmp_path):
    args = ["--device", "cpu", "--epochs", "2", "--n-train", "120", "--n-test", "20",
            "--batch-size", "32", "--iwae-k", "8", "--curvatures", "0.5", "1.4",
            "--posteriors", "riemannian"]
    lanes = pvae_replicate.main(args + ["--lane-sweep", "--run-dir", str(tmp_path / "lanes")])
    seq = pvae_replicate.main(args + ["--run-dir", str(tmp_path / "seq")])
    assert set(lanes) == {"riemannian_c0.5_d2", "riemannian_c1.4_d2"}
    assert lanes == seq
    for r in lanes.values():
        assert r["iwae_8"] <= 0 and r["best_val"] > 0 and r["iwae_8"] >= r["test_elbo"]
    assert (tmp_path / "lanes" / "riemannian_d2" / "lane_1" / "metrics.jsonl").exists()
