"""kernels.k3_roofline: K3's share of its roofline, in %: the ring ICP's
batched nearest neighbours (``nn_batched_prepared``, CUDA kernel
``nn_batched_split``), all of a frame's iterations at the traced frames'
own ICP cloud sizes."""
from benchmark import roofline


def _work(cfg, counts):
    return roofline.k3_work(cfg, counts["icp_points"])


def read(span):
    if not span.work or "icp_points" not in span.work[0]:
        return None
    return roofline.share_pct(span.least_s(_work),
                              span.device_s("nn_batched_split"))
