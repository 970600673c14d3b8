"""client.decode_ms: mean host ms from a camera frame's bytes received to
its slot written (the ingest threads' ``decode`` stage: decompression,
parse and the copy under the slot's lock), per camera frame, over the
window's samples outside the traced span (runtime/client.py's own stage
timer); None where the client records no such stage."""


def read(span):
    v = span.stages.get("decode")
    return sum(v) / len(v) * 1e3 if v else None
