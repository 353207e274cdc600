"""stage_s (s), layer "Trainer staging": the window's fit's
``fit.preflight``, ``fit.stage`` (both splits to the card) and
``fit.build`` (``_Run``: the optimizer and the chunk program) spans,
summed. From the program's span recorder (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    fit = spans.window_fit()
    if fit is None:
        return None
    return spans.seconds(fit, ("fit.preflight", "fit.stage", "fit.build"))
