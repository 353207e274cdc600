"""What the program's span recorder (``hyperbolic_vae_tpu_torch/train/tracing.py``)
holds of the window's fit, for the per-layer metrics that read it: the
only fit of a ``--trace 1`` run that records (its ``profile_dir`` is set).

Chunk 0 (its graph capture) and chunk 1 (under torch.profiler) are left
out, and with them the boundary after chunk 1 (the trace's export): the
counted chunks start at ``FIRST``. Each function returns None where the
program has no recorder (an older program) or it holds no fit.
"""

from __future__ import annotations

FIRST = 2  # the first counted chunk


def window_fit():
    """The recorder's last fit, or None."""
    try:
        from hyperbolic_vae_tpu_torch.train import tracing
    except ImportError:
        return None
    return tracing.last_fit()


def counted_device(fit) -> list:
    """The counted chunks' replays on the card, summed (``ChunkDevice``)."""
    return [c for c in fit.chunks if c.chunk >= FIRST]


def device_span_ns(chunks: list):
    """D: the first counted chunk's first replay start to the last one's
    last replay end (ns), or None."""
    if not chunks:
        return None
    d = chunks[-1].last - chunks[0].first
    return d if d > 0 else None


def counted_host(fit, name: str) -> list:
    """(chunk span, its child spans called ``name``) of each counted chunk."""
    return [(c, fit.children(c, name)) for c in fit.named("chunk")
            if c.counters.get("index", -1) >= FIRST]


def seconds(fit, names) -> float:
    """The host spans called one of ``names``, their durations summed (s),
    or None when there is none."""
    spans = [s for s in fit.spans if s.name in names and not s.on_card and s.end is not None]
    return sum(s.end - s.start for s in spans) * 1e-9 if spans else None
