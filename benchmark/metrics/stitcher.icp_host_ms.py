"""stitcher.icp_host_ms: host ms a traced frame in the step's ``pcs.icp``
span (the ICP voxel pass, K2, and the ring point-to-plane ICP with its
iterations), less the blocking read of the voxel pass inside it."""
from benchmark import spans


def read(span):
    return spans.host_ms(span, "pcs.icp")
