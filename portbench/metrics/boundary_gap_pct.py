"""boundary_gap_pct (%), layer "Trainer chunk loop": the card's time from
one counted chunk's last replay end to the next chunk's first replay
start (the fetch's kernels and copy, the host's absorb, checkpoint,
callbacks and stop check, the next chunk's first launch), summed, over
D, the counted chunks' span on the card. From the program's span
recorder (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    fit = spans.window_fit()
    if fit is None:
        return None
    chunks = spans.counted_device(fit)
    d = spans.device_span_ns(chunks)
    if d is None:
        return None
    return 100.0 * sum(b.first - a.last for a, b in zip(chunks, chunks[1:])) / d
