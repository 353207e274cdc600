"""issue_ms_per_step (ms), layer "graph replays": the host's time in the
counted chunks' ``chunk.issue`` spans (queueing their graph replays)
over their train steps. It holds the host's waits for a full launch
queue: once the host runs ahead of the card by the queue's depth, each
launch waits for the card, and the span follows the card's time (a
faster card shortens it). So it bounds the host's own cost from above;
``chunk.issue``'s ``lead_ns`` times the host alone, on a chunk's first
replays onto an idle card. From the program's span recorder
(``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    fit = spans.window_fit()
    if fit is None:
        return None
    pairs = spans.counted_host(fit, "chunk.issue")
    steps = sum(c.counters.get("steps", 0) for c, _ in pairs)
    ns = sum(s.end - s.start for _, issue in pairs for s in issue)
    return ns * 1e-6 / steps if steps else None
