"""The program's own spans (``pcs.*``, which the port opens through
``utils/profiling.annotate``) in a traced span's host operations: what the
readers of the ``program_span`` metrics of the stitch step take.

A stage's host time is its spans' inclusive time less the part that the
``pcs.sync`` spans inside them cover (the blocking reads, read apart as
``sync_wait_ms``). Each reading is per traced frame, and None where the
trace holds no such span (a program without them)."""
from __future__ import annotations

SYNC = "pcs.sync"


def _spans(span, name: str) -> list:
    return [(a, b) for n, a, b in span.cpu_ops if n == name]


def host_ms(span, name: str):
    """Mean host ms a frame in the spans ``name``, less their syncs."""
    outer = _spans(span, name)
    if not outer:
        return None
    syncs = _spans(span, SYNC)
    tot = 0.0
    for a, b in outer:
        tot += (b - a) - sum(min(b, d) - max(a, c)
                             for c, d in syncs if c < b and d > a)
    return tot * 1e-3 / span.frames


def sync_ms(span):
    """Mean host ms a frame spent in the step's blocking reads."""
    syncs = _spans(span, SYNC)
    if not syncs:
        return None
    return sum(b - a for a, b in syncs) * 1e-3 / span.frames


def syncs(span):
    """The step's blocking reads a frame."""
    n = len(_spans(span, SYNC))
    return n / span.frames if n else None
