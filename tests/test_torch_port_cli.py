"""The port's remaining experiment CLIs on the CPU, in-process through
``main(argv)`` with ``--device cpu`` on tiny data: a reference Lightning
``.ckpt`` imported, evaluated and exported back unchanged; experiments 5,
3, 2 and 8 fit -> best -> test; experiment 1's checkpoint short-circuit;
experiment 8's flags of later Queue 1 items; the geometry probe
comparison; and the JAX package's result readers (``summarize_runs.py``,
``pvae_grid_figure.py``, which import no JAX) on the port's
``runs_torch/`` results."""

import json
import logging
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.experiments import (
    eval_checkpoints,
    export_torch_state_dict,
    import_torch_checkpoint,
    probe_geometry_compare,
    pvae_replicate,
    train_ae_euclidean_cifar10,
    train_vae_euclidean_cifar10,
    train_vae_euclidean_mnist,
    train_vae_hyperbolic_mnist,
    train_vaes_rnaseq,
)
from hyperbolic_vae_tpu_torch.interop import export_torch_state_dict as export_sd
from hyperbolic_vae_tpu_torch.models import (
    Autoencoder,
    EuclideanVAE,
    GyroplaneVAE,
    HyperbolicImageVAE,
    RNASeqVAE,
    UnifiedVAE,
)
from hyperbolic_vae_tpu_torch.train.checkpoint import restore_model

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _common(run_dir, epochs=1, n_train=200, n_test=40, batch=32):
    return ["--device", "cpu", "--synthetic", "--epochs", str(epochs), "--n-train", str(n_train),
            "--n-test", str(n_test), "--batch-size", str(batch), "--run-dir", str(run_dir),
            "--log-level", "WARNING"]


def _reference_ckpt(path: Path, prefix="model."):
    """A reference flagship checkpoint in geoopt's form, built from a
    seeded port model: its export with a zero gyroplane bias, the bias
    dropped, geoopt's curvature entries added, wrapped as Lightning does."""
    model = GyroplaneVAE(generator=torch.Generator().manual_seed(21), device="cpu")
    with torch.no_grad():
        model.decoder[0].bias.zero_()
    src = export_sd(model)
    sd = {k: torch.from_numpy(v) for k, v in src.items() if k != "decoder.0.bias"}
    sd["manifold.k"] = torch.tensor(-1.0)
    sd["decoder.0.ball.k"] = torch.tensor([-1.0])
    torch.save({"state_dict": {prefix + k: v for k, v in sd.items()},
                "hyper_parameters": {"data_shape": [1, 28, 28], "manifold_curvature": 1.0},
                "epoch": 3}, path)
    return model, src


def test_ckpt_import_eval_export_is_the_identity(tmp_path):
    source, src = _reference_ckpt(tmp_path / "epoch=3.ckpt")
    out = tmp_path / "imported"
    model = import_torch_checkpoint.main([str(tmp_path / "epoch=3.ckpt"), "--device", "cpu",
                                          "--out", str(out), "--log-level", "WARNING"])
    restored, params, meta = restore_model(str(out), "best", device="cpu")
    assert isinstance(restored, GyroplaneVAE) and restored.data_shape == (28, 28, 1)
    assert meta["imported_from"].endswith("epoch=3.ckpt") and meta["epoch"] == -1
    for k, v in source.state_dict().items():
        assert torch.equal(params[k], v) and torch.equal(model.state_dict()[k], v), k

    res = eval_checkpoints.main(_common(tmp_path / "eval", n_train=300, n_test=50, batch=64)
                                + ["--glob", str(out), "--iwae", "8", "--probe", "3"])
    row = res[str(out)]
    assert row["model"] == "GyroplaneVAE" and row["epoch"] == -1
    assert math.isfinite(row["test/iwae_8"]) and row["test/iwae_8"] >= -row["test/loss_total"]
    assert 0.0 <= row["test/probe_knn3_acc"] <= 1.0
    assert json.loads((tmp_path / "eval" / "eval_results.json").read_text()) == res

    npz = tmp_path / "back.npz"
    sd = export_torch_state_dict.main([str(out), "--device", "cpu", "--out", str(npz),
                                       "--run-dir", str(tmp_path / "exp"), "--log-level", "WARNING"])
    with np.load(npz) as back:
        assert sorted(back.files) == sorted(src) == sorted(sd)
        for k in src:
            np.testing.assert_array_equal(back[k], src[k], err_msg=k)


def _gen():
    return torch.Generator().manual_seed(2)


# family -> (a port model, the .ckpt's hyper_parameters, the CLI's extra flags)
IMPORTS = {
    "GyroplaneVAE": (lambda: GyroplaneVAE(data_shape=(28, 28, 1), manifold_curvature=1.4,
                                          beta=2.0, generator=_gen(), device="cpu"),
                     {"data_shape": [1, 28, 28], "manifold_curvature": 1.4, "beta": 2.0}, []),
    "UnifiedVAE": (lambda: UnifiedVAE((20,), 8, 2, latent_curvature=0.5, generator=_gen(),
                                      device="cpu"), {"latent_curvature": 0.5},
                   ["--model", "unified"]),
    "RNASeqVAE": (lambda: RNASeqVAE(in_features=30, hidden_dim=6, generator=_gen(), device="cpu"),
                  {}, ["--model", "rnaseq"]),
    "EuclideanVAE": (lambda: EuclideanVAE((16, 16, 3), hidden_size=4, latent_dim=2, beta=3.0,
                                          generator=_gen(), device="cpu"), {}, ["--beta", "3"]),
    "Autoencoder": (lambda: Autoencoder((16, 16, 3), base_channel_size=4, latent_dim=8,
                                        generator=_gen(), device="cpu"), {}, []),
    "HyperbolicImageVAE": (lambda: HyperbolicImageVAE(
        (16, 16, 1), latent_dim=2, manifold_curvature=1.4, encoder_last_layer_module="mobius",
        decoder_first_layer_module="geodesic", base_channels=4, generator=_gen(), device="cpu"),
        {"manifold_curvature": 1.4}, ["--decoder-first", "geodesic"]),
}


@pytest.mark.parametrize("family", sorted(IMPORTS))
def test_import_cli_rebuilds_each_family(tmp_path, family):
    """A ``vae.``-wrapped .ckpt of each family imports to the same
    configuration and weights, from its keys, shapes, hyper_parameters
    and flags."""
    make, hp, flags = IMPORTS[family]
    source = make()
    path = tmp_path / "src.ckpt"
    torch.save({"state_dict": {f"vae.{k}": v for k, v in source.state_dict().items()},
                "hyper_parameters": hp}, path)
    model = import_torch_checkpoint.main([str(path), "--device", "cpu", "--out",
                                          str(tmp_path / "out"), "--log-level", "WARNING"] + flags)
    assert type(model).__name__ == family and model.hparams() == source.hparams()
    restored, params, _ = restore_model(str(tmp_path / "out"), "best", device="cpu")
    assert restored.hparams() == source.hparams()
    for k, v in source.state_dict().items():
        assert torch.equal(params[k], v), k


def test_import_cli_refuses_a_wrong_curvature(tmp_path):
    rna = IMPORTS["RNASeqVAE"][0]()
    bad = tmp_path / "bad.ckpt"
    torch.save({"state_dict": dict(rna.state_dict(), **{"manifold.k": torch.tensor(-1.0)})}, bad)
    with pytest.raises(ValueError, match="curvature"):
        import_torch_checkpoint.main([str(bad), "--device", "cpu", "--model", "rnaseq",
                                      "--curvature", "2.0", "--out", str(tmp_path / "b")])
    # a vae_one_b layout on a flat input is an RNASeqVAE's or a UnifiedVAE's: --model says which
    with pytest.raises(ValueError, match="RNASeqVAE.*UnifiedVAE"):
        import_torch_checkpoint.main([str(bad), "--device", "cpu", "--out", str(tmp_path / "b")])


@pytest.mark.parametrize("cli,extra,model", [
    (train_vae_hyperbolic_mnist, ["--n-train", "120"], "HyperbolicImageVAE"),
    (train_vae_euclidean_mnist, ["--n-train", "120"], "EuclideanVAE"),
    (train_vae_euclidean_cifar10, ["--n-train", "120", "--latent-dim", "8"], "EuclideanVAE"),
])
def test_image_experiments_fit_best_test(tmp_path, cli, extra, model):
    out = cli.main(_common(tmp_path, n_test=20) + extra)
    assert out["epochs"] == 1 and math.isfinite(out["best_val"])
    assert all(math.isfinite(v) for v in out.values())
    assert json.loads((tmp_path / "results.json").read_text()).popitem()[1] == out
    _, _, meta = restore_model(str(tmp_path / "ckpt"), "best", device="cpu")
    assert meta["model"]["__model_class__"] == model


def test_exp1_short_circuits_a_trained_latent(tmp_path):
    args = _common(tmp_path, n_train=120, n_test=20) + ["--latent-dims", "8"]
    first = train_ae_euclidean_cifar10.main(args)["latent_8"]
    second = train_ae_euclidean_cifar10.main(args)["latent_8"]
    assert first["epochs"] == 1 and second["epochs"] == 0
    assert {k: v for k, v in first.items() if k != "epochs"} == \
        {k: v for k, v in second.items() if k != "epochs"}
    assert (tmp_path / "latent_8" / "ckpt" / "best.pt").exists()


def test_exp8_fake_rnaseq_and_mnist(tmp_path):
    rna = train_vaes_rnaseq.main(_common(tmp_path / "rna") + [
        "--n-genes", "40", "--hidden-dim", "8", "--structured-fake"])
    assert all(math.isfinite(v) for v in rna.values())
    mnist = train_vaes_rnaseq.main(_common(tmp_path / "mnist", n_train=120, n_test=20)
                                   + ["--dataset", "mnist", "--hidden-dim", "8"])
    assert all(math.isfinite(v) for v in mnist.values())
    _, _, meta = restore_model(str(tmp_path / "rna" / "ckpt"), "best", device="cpu")
    assert meta["model"]["input_size"] == [40] and meta["model"]["latent_curvature"] == 1.0


@pytest.mark.parametrize("flag,item", [(["--tp", "2"], "item 8"), (["--fsdp"], "item 8"),
                                       (["--use-mesh"], "item 8")])
def test_exp8_later_items_exit_naming_them(tmp_path, flag, item):
    """``--tp``/``--fsdp`` (parameter sharding) exit naming Queue 1 item
    8b; ``--use-mesh`` (item 8a, data parallel) trains, here at world
    size 1, as the run without it does."""
    if flag != ["--use-mesh"]:
        with pytest.raises(SystemExit, match=item + "b"):
            train_vaes_rnaseq.main(_common(tmp_path) + flag)
        return
    import torch.distributed as dist

    args = ["--n-genes", "40", "--hidden-dim", "8"]
    want = train_vaes_rnaseq.main(_common(tmp_path / "plain") + args)
    try:
        got = train_vaes_rnaseq.main(_common(tmp_path / "mesh") + args + flag)
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert got == want


def test_exp8_streamed_fit(tmp_path, caplog):
    """``--stream-block-rows``: experiment 8 trains through fit_streamed on
    the fake cells (800 train rows in blocks of 300: two blocks, the
    200-row tail left out with a warning) and writes its results."""
    with caplog.at_level(logging.WARNING):
        out = train_vaes_rnaseq.main(_common(tmp_path, epochs=2) + [
            "--n-genes", "40", "--hidden-dim", "8", "--stream-block-rows", "300"])
    assert any("excluded from every epoch" in r.getMessage() for r in caplog.records)
    res = json.loads((tmp_path / "results.json").read_text())["vaes_rnaseq"]
    assert res == out and res["epochs"] == 2
    assert all(math.isfinite(v) for v in res.values())


def test_probe_geometry_compare(tmp_path):
    res = probe_geometry_compare.main(_common(tmp_path, batch=64) + [
        "--n-genes", "40", "--n-samples", "240", "--hidden-dim", "8", "--probe-k", "3"])
    assert set(res) == {"hyperbolic", "euclidean"}
    for r in res.values():
        assert 0.0 <= r["test/probe_knn3_acc"] <= 1.0 and math.isfinite(r["best_val_loss_total"])
    assert json.loads((tmp_path / "probe_compare.json").read_text()) == res


def _run_script(monkeypatch, name, argv):
    """Run experiments/<name>.py's main() with ``argv`` (they parse sys.argv)."""
    monkeypatch.syspath_prepend(str(EXPERIMENTS))
    monkeypatch.setattr(sys, "argv", [name] + argv)
    module = __import__(name)
    module.main()


def test_summarize_runs_reads_port_results(tmp_path, monkeypatch, capsys):
    train_vaes_rnaseq.main(_common(tmp_path) + ["--n-genes", "40", "--hidden-dim", "8"])
    capsys.readouterr()
    _run_script(monkeypatch, "summarize_runs", [str(tmp_path / "results.json")])
    table = capsys.readouterr().out
    assert table.startswith("| config | best_val | epochs |") and "| vaes_rnaseq |" in table


def test_pvae_grid_figure_reads_port_results(tmp_path, monkeypatch):
    """Experiment 9's 18 cells (posterior x c x d) from the port's CLI at a
    tiny size, drawn by the JAX package's figure script."""
    pytest.importorskip("matplotlib")
    run = tmp_path / "runs_torch" / "pvae_replicate"
    pvae_replicate.main(["--device", "cpu", "--epochs", "1", "--n-train", "40", "--n-test", "1",
                         "--batch-size", "32", "--iwae-k", "5000", "--curvatures", "0.5", "1.0",
                         "1.4", "--latent-dims", "2", "5", "10", "--run-dir", str(run)])
    png = tmp_path / "grid.png"
    _run_script(monkeypatch, "pvae_grid_figure",
                ["--results", str(run / "replicate_results.json"), "--out", str(png)])
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
