"""stitcher.icp_replays: replays of the captured ICP stage (``pcs.icp.graph``
spans, one around each CUDA graph replay inside ``pcs.icp``) per traced
frame; None where the trace holds no such span (an eager stage)."""

GRAPH = "pcs.icp.graph"


def read(span):
    n = sum(1 for name, _, _ in span.cpu_ops if name == GRAPH)
    return n / span.frames if n else None
