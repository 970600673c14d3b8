"""kernels.k1_packed_passes: global voxel passes that took the packed route
on the card (``pcs.voxel.k1_packed`` spans: the pack kernel, the sort and K1
on rows it builds itself) per traced frame; None where the trace holds no
such span (a program without that route)."""

SPAN = "pcs.voxel.k1_packed"


def read(span):
    n = sum(1 for name, _, _ in span.cpu_ops if name == SPAN)
    return n / span.frames if n else None
