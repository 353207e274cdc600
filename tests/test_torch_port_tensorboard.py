"""TensorBoard in the port's ``MetricLogger`` (``train/metrics.py``), as
JAX's: event files beside ``metrics.jsonl`` where
``torch.utils.tensorboard`` imports, JSONL and PNG only with
``use_tensorboard=False``."""

import json
import sys

import numpy as np
import pytest

from hyperbolic_vae_tpu_torch.train.metrics import MetricLogger, read_png


def test_tensorboard_event_files(tmp_path, monkeypatch):
    """With TensorFlow hidden, as on a machine without it:
    ``torch.utils.tensorboard`` then writes through tensorboard's own stub
    and imports in ~3 s instead of ~15 s."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    pytest.importorskip("torch.utils.tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    log = MetricLogger(str(tmp_path))
    log.log_scalars(0, {"train/loss_total": 2.5, "val/loss_total": 3.0})
    log.log_scalars(1, {"train/loss_total": 1.5, "val/loss_total": 2.0})
    log.log_image(1, "samples/grid", np.full((4, 6, 3), 128, np.uint8))
    log.close()
    assert list(tmp_path.glob("events.out.tfevents.*"))
    acc = EventAccumulator(str(tmp_path)).Reload()
    assert [e.value for e in acc.Scalars("train/loss_total")] == [2.5, 1.5]
    assert acc.Tags()["images"] == ["samples/grid"]
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["val/loss_total"] for r in rows] == [3.0, 2.0]
    assert read_png(tmp_path / "samples_grid_00001.png").shape == (4, 6, 3)


def test_without_tensorboard_jsonl_and_png_only(tmp_path):
    log = MetricLogger(str(tmp_path), use_tensorboard=False)
    log.log_scalars(0, {"train/loss_total": 2.5})
    log.log_image(0, "a/b", np.zeros((3, 3, 1), np.float32))
    log.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a_b_00000.png", "metrics.jsonl"]
