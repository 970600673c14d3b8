"""stitcher.output_host_ms: host ms a traced frame in the step's
``pcs.output`` span (the camera pass, SE(3), fusion, the crop and the
global voxel pass: sort + K1), less the blocking read of the voxel pass
inside it."""
from benchmark import spans


def read(span):
    return spans.host_ms(span, "pcs.output")
