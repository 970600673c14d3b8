"""client.snapshot_ms: mean host ms of the streaming client's ``snapshot``
stage (the cameras' slots copied into the pinned staging ring) over the
window's frames outside the traced span (runtime/client.py's own stage
timer)."""


def read(span):
    v = span.stages.get("snapshot")
    return sum(v) / len(v) * 1e3 if v else None
