"""kernels_per_step (kernels), layer "training step": the kernel
launches in the traced chunk (inside graphs too) over its train steps."""


def read(ctx):
    if ctx.trace is None:
        return None
    n = len(ctx.trace.kernels())
    return n / ctx.traced_steps if n else None
