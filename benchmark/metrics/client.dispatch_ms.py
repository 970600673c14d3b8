"""client.dispatch_ms: mean host ms of the streaming client's ``dispatch``
stage (enqueueing one stitch: the step's host work) over the window's
frames outside the traced span (runtime/client.py's own stage timer)."""


def read(span):
    v = span.stages.get("dispatch")
    return sum(v) / len(v) * 1e3 if v else None
