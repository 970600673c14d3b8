"""client.early_drain_pct: the share, in %, of the frames the overlapped,
paced streaming client drained over the window outside the traced span
that it synced and delivered before its pace wait, with the next tick
still ahead (its ``drain_early`` stage), rather than after the next
frame's dispatch (``drain_piped``) (runtime/client.py's own stage timer).
None where the client records neither."""


def read(span):
    early = len(span.stages.get("drain_early", ()))
    piped = len(span.stages.get("drain_piped", ()))
    return 100.0 * early / (early + piped) if early + piped else None
