"""The yardstick of the kernel metrics: the card's published peaks and the
work each kernel's function needs, counted from the cell's shapes.

A kernel's roofline share is the least time the card could take for the
function's work (the larger of its bytes over the memory rate and its
operations over the float32 instruction rate) over the device time its
kernels took, in %. Bytes count each input read once and each output
written once; operations count what the function must compute, whatever
implements it. Peaks: NVIDIA H100 SXM data sheet (dense, no sparsity);
they assume the full 700 W power limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# float32 instructions per second outside the tensor cores: 132 SMs x 128
# lanes x 1.98 GHz boost
F32_INSTR_PER_S = 132 * 128 * 1.98e9


def bound_s(nbytes: float, ops: float) -> float:
    """Least seconds to move ``nbytes`` and issue ``ops`` instructions."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_INSTR_PER_S)


def k1_work(cfg: dict, rows: float, voxels: float):
    """(bytes, operations) of one global voxel pass's segment sum (K1,
    ``segment_sum_from_flags``) at its data: the ``rows`` fused points that
    are valid and inside the crop box read once (their channels and flag
    byte), the ``voxels`` occupied output slots written once, one add per
    row and channel. Rows that reach no voxel and slots that stay empty are
    no part of the function, so a kernel that skips them still reads under
    100%. The pass takes its packed branch (7 integer channels) at a leaf
    of 3 cm or less, else the exact one (4); colour adds 3."""
    ch = 7 if cfg["out_voxel_leaf"] <= 0.03 else 4
    if cfg.get("with_color"):
        ch += 3
    return rows * (4 * ch + 1) + voxels * 4 * ch, rows * ch


def k3_work(cfg: dict, points: list[int]):
    """(bytes, operations) of one frame's ICP nearest-neighbour searches
    (K3, ``nn_batched_prepared``) at its data: in each of the
    ``icp_iterations`` calls, each ring pair's valid query points (camera
    i) against its valid reference points (camera i - 1), ``points`` being
    each camera's ICP cloud size, 9 float32 instructions a pair (three
    differences, three squares, two adds and the compare); both clouds
    read and an (index, distance) written for each query once a call. The
    padding up to ``icp_capacity`` is no part of the function."""
    n = len(points)
    closure = cfg["icp_ring_closure"] and n >= 3
    pairs = [(i, (i - 1) % n) for i in (range(n) if closure
                                        else range(1, n))]
    it = cfg["icp_iterations"]
    nbytes = sum((points[a] + points[b]) * 3 * 4 + points[a] * 8
                 for a, b in pairs)
    return it * nbytes, it * 9 * sum(points[a] * points[b]
                                     for a, b in pairs)


def share_pct(least_s: float, device_s: float) -> float | None:
    """The roofline share in %, of the least time ``least_s`` over the
    time the kernels took, or None where they took none."""
    if device_s <= 0:
        return None
    return least_s / device_s * 100.0
