"""k3_roofline (%), layer "kernel K3": the bound of one flagship training
step at the cell's batch (``counts/k3.py``) times K3's calls in the
traced chunk, over the union of K3's kernel intervals (its rows,
gradient and update kernels, which programmatic dependent launch lets
overlap). A call is one rows kernel; nothing is read when the trace
holds another number than the chunk's train steps."""

import math

from portbench.counts import k3
from portbench.harness.trace import union

KERNELS = ("train_rows_kernel", "train_grad_kernel", "train_update_kernel")
CALL = "train_rows_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    events = ctx.trace.kernels(KERNELS)
    calls = sum(1 for name, *_ in events if CALL in name)
    if not calls or calls != ctx.traced_steps:
        return None
    kw = ctx.config["model"]["kwargs"]
    h1, h2 = kw["hidden_dims"]
    bound = calls * k3.bound_s(ctx.batch, math.prod(kw["data_shape"]), h1, h2, kw["latent_dim"])
    busy = sum(e - s for s, e in union((s, e) for _, s, e, _ in events)) * 1e-6
    return 100.0 * bound / busy
