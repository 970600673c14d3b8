"""The reduction from traced events to per-layer metrics, on made-up
events and shapes."""
from __future__ import annotations

import itertools
import math

import pytest

import torch

from benchmark import harness, reference, roofline, trace

ICP = harness.config("rig8_ring_icp")["stitch"]


def _span(device_ops, cpu_ops=(), frames=2, stages=None):
    return trace.Span(frames=frames, device_ops=list(device_ops),
                      cpu_ops=list(cpu_ops), stages=stages or {},
                      cfg=dict(ICP))


def test_busy_is_the_union_and_the_window_spans_every_event():
    s = _span([("k", 0.0, 10.0), ("k", 5.0, 15.0), ("m", 30.0, 40.0)],
              [("aten::x", -10.0, 50.0)])
    assert s.busy_s == pytest.approx(25e-6)
    assert s.window_s == pytest.approx(60e-6)
    assert trace.idle_share_pct(s) == pytest.approx((1 - 25 / 60) * 100)
    assert harness.reader("stitcher.busy_ms")(s) == pytest.approx(
        (10 + 10 + 10) * 1e-3 / 2)
    assert harness.reader("stitcher.device_ops")(s) == 1.5
    assert harness.reader("device.idle_share.closed")(s) == \
        harness.reader("device.idle_share.stream")(s)


def test_readers_with_nothing_to_read_return_nothing():
    s = _span([], [("aten::x", 0.0, 1.0)])
    for m in harness.benchmark_spec()["per_layer"]:
        assert harness.reader(m["name"])(s) is None, m["name"]


def test_stage_means_ignore_nothing_but_what_they_are_given():
    s = _span([], stages={"dispatch": [0.010, 0.020],
                          "snapshot": [0.002]})
    assert harness.reader("client.dispatch_ms")(s) == pytest.approx(15.0)
    assert harness.reader("client.snapshot_ms")(s) == pytest.approx(2.0)


def test_k1_work_counts_each_row_and_voxel_once():
    rows, voxels = 880_000, 165_000
    nbytes, ops = roofline.k1_work(ICP, rows, voxels)
    assert nbytes == rows * (7 * 4 + 1) + voxels * 7 * 4
    assert ops == rows * 7
    assert roofline.bound_s(nbytes, ops) == pytest.approx(
        nbytes / 3.35e12)
    # every pixel of the rig into every slot: the old, padded count
    full = roofline.k1_work(ICP, 8 * 480 * 848, 262144)
    assert roofline.bound_s(*full) * 1e3 == pytest.approx(0.0304, rel=0.01)
    assert roofline.k1_work(dict(ICP, out_voxel_leaf=0.06), 1, 1)[1] == 4


def test_k3_work_counts_nine_instructions_a_valid_pair():
    pts = [1000 + 10 * c for c in range(8)]
    nbytes, ops = roofline.k3_work(ICP, pts)
    pairs = sum(pts[i] * pts[i - 1] for i in range(8))
    assert ops == 5 * 9 * pairs
    assert roofline.bound_s(nbytes, ops) == pytest.approx(
        ops / (132 * 128 * 1.98e9))
    open_ring = dict(ICP, icp_ring_closure=False)
    assert roofline.k3_work(open_ring, pts)[1] == 5 * 9 * (
        pairs - pts[0] * pts[7])
    # full clouds give the padded count: the most any data can ask
    assert roofline.k3_work(ICP, [2048] * 8)[1] == 5 * 8 * 2048 ** 2 * 9


def test_a_roofline_share_reads_the_named_kernels_per_frame():
    pts = [1000] * 8
    work = [{"rows": 880_000, "voxels": 165_000, "icp_points": pts}] * 2
    t = roofline.bound_s(*roofline.k3_work(ICP, pts))  # a perfect frame
    us = t * 1e6 / 5
    ops = [("void nn_batched_split(float const*)", i * 100.0,
            i * 100.0 + us) for i in range(10)]
    ops.append(("void segsum_flags_kernel<256>(float const*)", 0.0, 50.0))
    s = _span(ops, frames=2)
    assert harness.reader("kernels.k3_roofline")(s) is None  # no counts
    s.work = work
    assert harness.reader("kernels.k3_roofline")(s) == pytest.approx(100.0)
    k1 = harness.reader("kernels.k1_roofline")(s)
    assert k1 == pytest.approx(roofline.bound_s(*roofline.k1_work(
        ICP, 880_000, 165_000)) / 25e-6 * 100)
    fixed = _span(ops, frames=2)
    fixed.work = [{"rows": 1, "voxels": 1}]
    assert harness.reader("kernels.k3_roofline")(fixed) is None
    assert roofline.share_pct(t, 0.0) is None


def test_the_work_counts_valid_rows_in_the_crop_and_their_voxels():
    cfg = dict(ICP, num_cameras=2, height=4, width=6, icp_stride=1,
               crop_lo=[-10.0, -10.0, 0.0], crop_hi=[10.0, 10.0, 1.5])
    depths = torch.full((2, 4, 6), 1000, dtype=torch.int32)
    depths[0, :, :3] = 2000          # beyond the crop's top after ext
    depths[1, 0, 0] = 0              # no depth
    depths[1, 1, 1] = 5              # under z_min
    ext = torch.eye(4).repeat(2, 1, 1)
    intr = {"fx": 500.0, "fy": 500.0, "ppx": 3.0, "ppy": 2.0}
    w = reference.work(depths.to(torch.uint16), ext, intr, cfg)
    keys = set()
    for c, v, u in itertools.product(range(2), range(4), range(6)):
        z = int(depths[c, v, u]) * 1e-3
        if 0.1 < z <= 1.5:
            p = ((u - 3.0) / 500.0 * z, (v - 2.0) / 500.0 * z, z)
            keys.add(tuple(math.floor(x / 0.01) for x in p))
    assert w["rows"] == 12 + 22
    assert w["voxels"] == len(keys)
    assert len(w["icp_points"]) == 2


def test_the_breakdown_names_gaps_by_the_innermost_host_op():
    dev = [("void k(int)", 0.0, 10.0), ("void k(int)", 20.0, 30.0),
           ("memcpy", 40.0, 41.0)]
    cpu = [("stitch", 0.0, 45.0), ("aten::sort", 12.0, 19.0),
           ("cudaLaunchKernel", 35.0, 39.0)]
    b = trace.breakdown(_span(dev, cpu))
    assert b["device_ops"][0] == ["k", pytest.approx(20e-6)]
    gaps = dict((n, s) for n, s in b["idle_gaps"])
    assert gaps == {"aten::sort": pytest.approx(10e-6),
                    "cudaLaunchKernel": pytest.approx(10e-6)}
