"""client.held_ms: mean ms the streaming client held a frame between the
end of its dispatch and the start of its sync (its ``held`` stage: the
pace wait and the next frame's snapshot, H2D and dispatch) over the
window's synced frames outside the traced span (runtime/client.py's own
stage timer)."""


def read(span):
    v = span.stages.get("held")
    return sum(v) / len(v) * 1e3 if v else None
