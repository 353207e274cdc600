"""The reader of the Trainer's trace, on a small synthetic trace with
overlapping kernels, and the per-layer metrics read from it."""

import json

import pytest

from portbench.harness import spec, trace as tr
from portbench.harness.cell import Context


def _events():
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}  # noqa: E731
    h = lambda name, ts, dur: {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur}  # noqa: E731
    return [
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "overhead", "name": "Buffer Flush", "ts": 66.0, "dur": 10.0},
        {"ph": "X", "cat": "overhead", "name": "Activity Buffer Request", "ts": 86.0, "dur": 12.0},
        h("cudaGraphLaunch", 1.0, 4.0),
        k("(anonymous namespace)::train_rows_kernel(float const*)", 10.0, 20.0),
        k("(anonymous namespace)::train_grad_kernel(Jobs)", 25.0, 10.0),  # overlaps the rows kernel
        k("(anonymous namespace)::train_update_kernel(Upd)", 35.0, 5.0),
        h("cudaStreamSynchronize", 40.0, 30.0),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60.0, "dur": 2.0},
        k("gyroplane_wide_kernel(float2 const*)", 80.0, 4.0),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1.0},
    ]


def test_union_busy_and_gaps():
    t = tr.Trace(_events())
    # the profiler's session and its flush after the chunk are not the chunk's
    assert t.span == (1.0, 84.0)
    assert t.busy_us() == pytest.approx(30.0 + 2.0 + 4.0)  # [10, 40), [60, 62), [80, 84)
    assert t.gaps() == [(40.0, 60.0), (62.0, 80.0), (1.0, 10.0)]
    assert len(t.kernels()) == 4 and len(t.kernels(("train_",))) == 3
    assert t.host_at(50.0) == "cudaStreamSynchronize"
    b = tr.breakdown(t)
    assert b["device_ops"][0] == ["(anonymous namespace)::train_rows_kernel(float const*)", pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["host: cudaStreamSynchronize", pytest.approx(20e-6)]
    assert b["idle_gaps"][1] == ["host: none, overhead: Buffer Flush", pytest.approx(18e-6)]
    assert b["idle_gaps"][2] == ["host: none", pytest.approx(9e-6)]


def test_load(tmp_path):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": _events()}))
    assert tr.Trace.load(p).busy_us() == pytest.approx(36.0)


def _ctx(trace, workload, steps=1, eval_steps=0, rem=0):
    cell = spec.load_cell(workload)
    cfg = dict(cell.config, name=cell.config_name)
    return Context(config=cfg, traffic=cell.traffic,
                   window={"wall_s": 10.0, "samples": 1000, "samples_per_epoch": 100, "k": 1,
                           "program_samples_per_s": 110.0, "epochs_run": 10},
                   trace=trace, traced_epochs=1, batch=256, steps_per_epoch=steps,
                   eval_batch=256, eval_steps=eval_steps, val_rem=rem)


def test_metrics_read_the_trace():
    t = tr.Trace(_events())
    k3 = _ctx(t, "flagship-train-k3")
    # one K3 call: its bound over the union of its three kernels (30 us)
    from portbench.counts import k3 as k3c

    assert spec.metric_reader("k3_roofline")(k3) == pytest.approx(
        100 * k3c.bound_s(256, 784, 64, 16, 2) / 30e-6)
    assert spec.metric_reader("busy_ms_per_step")(k3) == pytest.approx(0.036)
    assert spec.metric_reader("kernels_per_step")(k3) == 4
    assert spec.metric_reader("idle_pct")(k3) == pytest.approx(100.0 * (1.0 - 36.0 / 83.0))
    assert spec.metric_reader("fit_overhead_s")(k3) == pytest.approx(10.0 - 900 / 110.0)
    assert spec.metric_reader("step_mfu")(k3) == pytest.approx(
        100 * 556_404 * 256 / 83e-6 / 67e12)
    # two K3 steps expected, one traced: nothing is read
    assert spec.metric_reader("k3_roofline")(_ctx(t, "flagship-train-k3", steps=2)) is None
    # K1: one call (the train step) of B = 256, P = 16, D = 2
    from portbench.counts import k1

    auto = _ctx(t, "flagship-train-autograd")
    assert spec.metric_reader("k1_roofline")(auto) == pytest.approx(100 * k1.bound_s(256, 16, 2) / 4e-6)
    assert spec.metric_reader("k1_roofline")(_ctx(t, "flagship-train-autograd", eval_steps=1)) is None


def test_nothing_to_read():
    empty = tr.Trace([])
    ctx = _ctx(empty, "flagship-train-autograd")
    for name in ("busy_ms_per_step", "kernels_per_step", "idle_pct", "k1_roofline", "step_mfu"):
        assert spec.metric_reader(name)(ctx) is None
    assert spec.metric_reader("k3_roofline")(_ctx(None, "flagship-train-k3")) is None
