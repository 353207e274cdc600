"""busy_ms_per_step (ms), layer "training step": the union of the device
operations' intervals in the traced chunk over the train steps in it
(the val pass's work counted in)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return ctx.trace.busy_us() * 1e-3 / ctx.traced_steps
