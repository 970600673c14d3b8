"""stitcher.prepare_host_ms: host ms a traced frame in the step's
``pcs.prepare`` span (``_prepare``: decimation, deprojection, normals, the
ICP subsample), less the blocking reads inside it."""
from benchmark import spans


def read(span):
    return spans.host_ms(span, "pcs.prepare")
