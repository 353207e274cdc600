"""step_mfu (%), layer "whole step": the configuration's forward and
backward operations a sample (``counts/<config>.py``) times the samples
the traced chunk trained, over the chunk's span in the trace, over the
f32 peak outside the tensor cores (the configurations run in f32 with
TF32 off). The traced run's host-clock window holds the trace's export,
so the chunk's own span is the time base; the profiler's instrumentation
stretches it (PERF.md gives by how much in each cell)."""

from portbench.counts import peaks


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or ctx.trace.window_us <= 0:
        return None
    flops = ctx.counts(ctx.config["name"]).train_flops_per_sample(ctx.config)
    rate = ctx.traced_steps * ctx.batch / (ctx.trace.window_us * 1e-6)
    return 100.0 * flops * rate / peaks.F32_FLOP_PER_S
