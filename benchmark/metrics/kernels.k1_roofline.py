"""kernels.k1_roofline: K1's share of its roofline, in %: the global voxel
pass's segment sum (``segment_sum_from_flags``, CUDA kernel
``segsum_flags_kernel``) at the traced frames' own rows and voxels."""
from benchmark import roofline


def _work(cfg, counts):
    return roofline.k1_work(cfg, counts["rows"], counts["voxels"])


def read(span):
    if not span.work:
        return None
    return roofline.share_pct(span.least_s(_work),
                              span.device_s("segsum_flags_kernel"))
