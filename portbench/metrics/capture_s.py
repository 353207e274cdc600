"""capture_s (s), layer "graph capture": the window's fit's
``chunk.capture`` span (``GraphedProgram._capture``: the warm-up passes
and the captures of its segments). Every fit captures anew, so each of
set-up's fits pays it too. From the program's span recorder
(``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    fit = spans.window_fit()
    return None if fit is None else spans.seconds(fit, ("chunk.capture",))
