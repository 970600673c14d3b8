"""client.frame_age_ms: mean ms from the oldest live camera frame's
receipt to the snapshot that takes it (the client's ``frame_age`` stage)
over the window's dispatched frames outside the traced span
(runtime/client.py's own stage timer)."""


def read(span):
    v = span.stages.get("frame_age")
    return sum(v) / len(v) * 1e3 if v else None
