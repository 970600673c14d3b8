"""kernels.map_color_roofline: the colour map's share of its roofline, in
%: ``ops/deproject.py::map_color`` (CUDA kernel ``map_color_kernel``) at
the traced frames' own points; None where no kernel of that name ran."""
from benchmark import color_roofline, roofline


def _work(cfg, counts):
    return color_roofline.map_color_work(cfg, counts["rows"])


def read(span):
    if not span.work:
        return None
    return roofline.share_pct(span.least_s(_work),
                              span.device_s("map_color_kernel"))
