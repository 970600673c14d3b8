"""client.recv_ms: mean host ms from a camera's pull sent to its frame's
bytes received (the ingest threads' ``recv`` stage), per camera frame,
over the window's samples outside the traced span (runtime/client.py's
own stage timer); None where the client records no such stage."""


def read(span):
    v = span.stages.get("recv")
    return sum(v) / len(v) * 1e3 if v else None
