"""launch_gap_pct (%), layer "graph replays": inside each counted chunk of
the window's fit, the card's time from one graph replay's end event to
the next replay's start event (the host's launches not keeping up),
summed, over D, the counted chunks' span on the card (their first
replay's start to their last one's end). From the program's span
recorder (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    fit = spans.window_fit()
    if fit is None:
        return None
    chunks = spans.counted_device(fit)
    d = spans.device_span_ns(chunks)
    return None if d is None else 100.0 * sum(c.gaps for c in chunks) / d
