"""The work of the colour map (``ops/deproject.py::map_color``, CUDA kernel
``map_color_kernel``) at a traced frame's data, for
``metrics/kernels.map_color_roofline.py``: the yardstick beside
``roofline.py``'s, counted so that the share cannot pass 100% by the
count.

Bytes: every point's mask byte read and its rgb (three float32) written,
since the output is dense over all cameras' pixels, and the xyz (three
float32) read of each of the frame's ``rows``, the valid points inside the
crop box: a lower bound on the points whose position any colour map must
read. The colour gathered from the frames is not counted: how many points
land in the colour frame depends on the data, and the colour sensor's
field of view is narrower than the depth's.

Operations: the float32 instructions of one point's transform and
projection, for each of the ``rows``: the depth-to-colour transform (three
rows of one multiply, two fused multiply-adds and one add), the test of z,
two divisions, two fused multiply-adds of the pinhole, two roundings and
four bounds tests.
"""
from __future__ import annotations

MASK_BYTES = 1
RGB_BYTES = 3 * 4
XYZ_BYTES = 3 * 4
OPS_PER_POINT = 3 * 4 + 1 + 2 + 2 + 2 + 4


def map_color_work(cfg: dict, rows: float):
    """(bytes, operations) of one frame's colour map: ``cfg`` is the
    StitchConfig fields, ``rows`` the frame's valid points in the crop."""
    points = cfg["num_cameras"] * cfg["height"] * cfg["width"]
    return (points * (MASK_BYTES + RGB_BYTES) + rows * XYZ_BYTES,
            rows * OPS_PER_POINT)
