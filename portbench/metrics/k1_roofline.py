"""k1_roofline (%), layer "kernel K1": K1's bound over its device time in
the traced chunk. K1 runs once a train step and once a val batch (the
tail too); the bound of each call from its shape (``counts/k1.py``, B
the call's rows, P the configuration's gyroplanes, D its latent width),
summed, over the union of K1's kernel intervals. Nothing is read when
the trace holds another number of K1 calls than the chunk makes."""

from portbench.counts import k1
from portbench.harness.trace import union

KERNELS = ("gyroplane_d2_kernel", "gyroplane_wide_kernel", "gyroplane_any_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    events = ctx.trace.kernels(KERNELS)
    p, d = ctx.config["gyroplanes"], ctx.config["latent_dim"]
    calls = [ctx.batch] * ctx.steps_per_epoch + [ctx.eval_batch] * ctx.eval_steps
    calls += [ctx.val_rem] if ctx.val_rem else []
    if not events or len(events) != len(calls) * ctx.traced_epochs:
        return None
    bound = ctx.traced_epochs * sum(k1.bound_s(b, p, d) for b in calls)
    busy = sum(e - s for s, e in union((s, e) for _, s, e, _ in events)) * 1e-6
    return 100.0 * bound / busy
