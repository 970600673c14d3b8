"""The ICP stage as one CUDA graph (``models/stitcher.py``: ``_ICPGraph``).

On the CPU: the voxel pass decides its branch on the host where the leaf
allows it (no ``pcs.sync``, the exact branch bit for bit), keeps its sync
elsewhere, and the engagement rule says "eager" for every CPU pipeline,
which then equals ``stitch_step``. On the card (``-m cuda``): a pipeline
that replays equals one forced eager, bit for bit, over 100 frames of the
benchmark's ICP rig in every update mode and backend, through a dropped
camera and a capture forced by a new shape; the kernels' launch counts are
those of the eager stage, the capturing frame's too; an overlapped stream
delivers what direct calls give. The file imports no JAX, so on the card it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_icp_graph.py
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu_torch import (Intrinsics, PointCloud,
                                            StitchConfig, StitchingPipeline,
                                            stitch_step)
from pointcloud_stitching_tpu_torch.kernels import build as kb
from pointcloud_stitching_tpu_torch.models import stitcher
from pointcloud_stitching_tpu_torch.ops import voxel
from oracle import synth_depth_frame

NCAM, H, W = 3, 48, 64


def _cloud(batched: bool, rgb: bool = False):
    g = torch.Generator().manual_seed(11)
    shape = (2, 600, 3) if batched else (900, 3)
    xyz = torch.rand(shape, generator=g) * torch.tensor([1.5, 1.0, 0.8])
    mask = torch.rand(shape[:-1], generator=g) > 0.2
    n = (torch.rand(shape, generator=g) - 0.5) if rgb else None
    return PointCloud(xyz=xyz, mask=mask, rgb=n)


def _syncs(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.name == "pcs.sync" for e in prof.events())


def _equal(a, b):
    for name in ("xyz", "mask", "rgb"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        assert x is None or torch.equal(x, y), name


@pytest.mark.parametrize("rgb", [False, True], ids=["xyz", "normals"])
@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("leaf", [0.0301, 0.07, np.float64(0.1), 1])
def test_a_python_leaf_above_3cm_takes_the_exact_branch_without_a_sync(
        leaf, batched, rgb):
    pc = _cloud(batched, rgb)
    out, n = _syncs(lambda: voxel.voxel_downsample(pc, leaf, capacity=256))
    assert n == 0
    _equal(out, voxel.voxel_downsample(pc, leaf, capacity=256,
                                       packed="never"))


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("leaf, packed", [
    (0.03, True), (0.01, True), (0.03000000001, True),
    (torch.tensor(0.01), True), (torch.tensor(0.07), False)],
    ids=["3cm", "1cm", "3cm-in-float32", "tensor-1cm", "tensor-7cm"])
def test_a_leaf_of_3cm_or_less_or_a_tensor_leaf_still_syncs(leaf, packed,
                                                             batched):
    """One read a pass, and the branch it chose: the packed centroids are
    quantised at leaf/2048, so they differ from the exact branch's."""
    pc = _cloud(batched)
    out, n = _syncs(lambda: voxel.voxel_downsample(pc, leaf, capacity=256))
    assert n == 1
    exact = voxel.voxel_downsample(pc, leaf, capacity=256, packed="never")
    assert torch.equal(out.mask, exact.mask)
    assert torch.equal(out.xyz, exact.xyz) is not packed


@pytest.mark.parametrize("leaf, impossible", [
    (0.07, True), (0.0301, True), (np.float64(0.05), True),
    (np.float32(0.05), True), (1, True), (float("inf"), True),
    (0.03, False), (0.03000000001, False), (0.01, False),
    (float("nan"), False), (torch.tensor(0.07), False),
    (torch.tensor(0.01), False)])
def test_packed_impossible_reads_the_leaf_as_the_device_compares_it(
        leaf, impossible):
    assert voxel.packed_impossible(leaf) is impossible


@pytest.mark.parametrize("device, icp_on, ncam, leaf, p2plane, want", [
    ("cuda", True, 8, 0.07, True, True),
    ("cuda:1", True, 2, 0.031, True, True),
    (torch.device("cuda", 0), True, 8, 0.07, True, True),
    ("cpu", True, 8, 0.07, True, False),
    ("cuda", False, 8, 0.07, True, False),
    ("cuda", True, 1, 0.07, True, False),
    ("cuda", True, 8, 0.03, True, False),
    ("cuda", True, 8, 0.01, True, False),
    ("cuda", True, 8, torch.tensor(0.07), True, False),
    ("cuda", True, 8, 0.07, False, False)],
    ids=["flagship", "two-cams", "device-object", "cpu", "icp-off",
         "one-cam", "leaf-3cm", "leaf-1cm", "tensor-leaf", "point-to-point"])
def test_the_engagement_rule(device, icp_on, ncam, leaf, p2plane, want):
    assert stitcher.icp_graph_engages(device, icp_on, ncam, leaf,
                                      p2plane) is want


def _pipeline(device, update_mode="anchored", **kw):
    base = dict(num_cameras=NCAM, height=H, width=W, out_voxel_leaf=0.02,
                out_capacity=8192, icp_voxel_leaf=0.07, icp_capacity=256,
                icp_iterations=2, icp_max_corr_dist=0.3, icp_stride=2)
    base.update(kw)
    cfg = StitchConfig(**base)
    i0 = Intrinsics.create(fx=30.0, fy=30.0, ppx=W / 2, ppy=H / 2,
                           width=W, height=H)
    ext = np.tile(np.eye(4, dtype=np.float32), (NCAM, 1, 1))
    ext[:, :3, 3] = np.random.default_rng(3).uniform(-0.05, 0.05, (NCAM, 3))
    return StitchingPipeline(cfg, i0.stack([i0] * (NCAM - 1)), ext,
                             update_mode=update_mode, device=device)


def _assert_same(a, b):
    _equal(a.cloud, b.cloud)
    assert torch.equal(a.extrinsics, b.extrinsics)
    for x, y in zip(a.metrics, b.metrics):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_a_cpu_pipeline_runs_the_eager_stage_and_equals_stitch_step():
    pipe = _pipeline(torch.device("cpu"))
    assert pipe._icp_stage is stitcher._icp_stage
    d = torch.from_numpy(np.stack([synth_depth_frame(H, W, seed=s)
                                   for s in range(NCAM)]))
    want = stitch_step(pipe.cfg, pipe.intr, pipe.extrinsics, d)
    _assert_same(pipe(d), want)
    assert int(want.metrics.icp_inliers.sum()) > 0


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The first GPU; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


def _rig(dev):
    """The benchmark's ICP rig: 8 × 848×480, its configuration, its
    miscalibrated extrinsics and its 33-frame cycle, rendered on ``dev``."""
    from benchmark import harness, scene
    cfg = harness.config("rig8_ring_icp")
    rig = scene.make_rig(cfg, 20261018)
    frames = scene.render_cycle(cfg, rig, 20261018, dev)
    r = cfg["rig"]
    i0 = Intrinsics.create(fx=r["fx"], fy=r["fy"], ppx=r["width"] / 2.0,
                           ppy=r["height"] / 2.0, width=r["width"],
                           height=r["height"], device=dev)
    return (StitchConfig(**cfg["stitch"]), i0.stack([i0] * (r["cameras"] - 1)),
            rig.calib, frames)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("mode", ["anchored", "track", "ema"])
def test_replays_equal_the_eager_stage_over_100_frames(cuda_device, mode,
                                                       impl):
    """100 frames of the ICP rig: camera 3 drops at frame 40 and is back at
    60; at frame 80 a coarser ICP stride changes the ICP cloud's shape,
    which captures anew. Every output equal bit for bit; K3 five times and
    K2 once a frame with the kernels, nothing without."""
    cfg, intr, calib, frames = _rig(cuda_device)
    cfg = dataclasses.replace(cfg, kernel_impl=impl)
    pipes = [StitchingPipeline(cfg, intr, calib, update_mode=mode,
                               device=cuda_device) for _ in range(2)]
    graph, eager = pipes
    assert isinstance(graph._icp_stage, stitcher._ICPGraph)
    eager._icp_stage = stitcher._icp_stage
    live = torch.ones(cfg.num_cameras, dtype=torch.bool, device=cuda_device)
    dropped = live.clone()
    dropped[3] = False
    first = None
    for i in range(100):
        if i == 80:
            first = graph._icp_stage.graph
            for p in pipes:
                p.cfg = dataclasses.replace(cfg, icp_stride=7)
        mask = dropped if 40 <= i < 60 else live
        kb.reset_launches()
        got = graph(frames[i % frames.shape[0]], cam_mask=mask)
        torch.cuda.synchronize()
        counts = dict(kb.LAUNCHES)
        want = eager(frames[i % frames.shape[0]], cam_mask=mask)
        _assert_same(got, want)
        if i in (40, 59):
            assert int(got.metrics.icp_inliers[2:4].sum()) == 0
        if impl == "auto":
            assert counts == {"nn_batched_prepared": 5,
                              "segment_sum_sorted": 1,
                              "segment_sum_from_keys": 1,
                              "voxel_pack": 1}, i
        else:
            assert not counts
    assert graph._icp_stage.graph is not first
    assert graph._icp_stage.key[1] == (cfg.num_cameras, 69 * 122, 3)
    assert torch.equal(graph.extrinsics, eager.extrinsics)


@pytest.mark.cuda
def test_the_capturing_frame_runs_the_stage_once_on_the_card(cuda_device):
    """Under a profiler, the first frame (eager on the capture stream, then
    captured) and a replayed one launch the same kernels: K3 five times,
    K2 and K1 once."""
    cfg, intr, calib, frames = _rig(cuda_device)
    pipe = StitchingPipeline(cfg, intr, calib, device=cuda_device)
    names = {"nn_batched_split": 5, "segsum_sorted_kernel": 1,
             "segsum_flags_kernel": 1}
    for i in range(2):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            pipe(frames[i])
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        seen = collections.Counter(
            k for e in prof.events() if e.device_type == cuda
            for k in names if k in e.name)
        assert dict(seen) == names, i


@pytest.mark.cuda
def test_an_overlapped_stream_delivers_what_direct_calls_give(cuda_device):
    """The client holds frame N while it dispatches frame N+1: each frame's
    outputs are clones, so what it delivers equals a direct eager call on
    the depths that frame carried, though every camera's frame changes
    from one tick to the next."""
    from pointcloud_stitching_tpu_torch.runtime import (
        Codec, FakeCameraServer, MulticameraClient, synthetic_frames)
    h, w = 120, 212
    servers = [FakeCameraServer(synthetic_frames(5, h, w, seed=s),
                                codec=Codec.SNAPPY).start()
               for s in range(NCAM)]
    client = None
    try:
        cfg = StitchConfig(num_cameras=NCAM, height=h, width=w,
                           out_voxel_leaf=0.02, out_capacity=65536,
                           icp_voxel_leaf=0.05, icp_capacity=1024)
        i0 = Intrinsics.create(fx=106.0, fy=106.0, ppx=w / 2, ppy=h / 2,
                               width=w, height=h)
        ext = np.tile(np.eye(4, dtype=np.float32), (NCAM, 1, 1))
        ext[:, :3, 3] = np.random.default_rng(3).uniform(-0.05, 0.05,
                                                         (NCAM, 3))
        intr = i0.stack([i0] * (NCAM - 1))
        pipe = StitchingPipeline(cfg, intr, ext, device=cuda_device)
        eager = StitchingPipeline(cfg, intr, ext, device=cuda_device)
        eager._icp_stage = stitcher._icp_stage
        assert isinstance(pipe._icp_stage, stitcher._ICPGraph)
        client = MulticameraClient([("127.0.0.1", s.port) for s in servers],
                                   pipe).start()
        assert client.wait_for_first_frames(timeout=20)
        outs = []
        client.run(num_frames=12, sync_every=1,
                   on_frame=lambda i, o: outs.append(o))
        torch.cuda.synchronize()
        assert len(outs) == 12
        seen = collections.Counter(bytes(o.depth.cpu().numpy())
                                   for o in outs)
        assert len(seen) > 1
        for o in outs:
            want = eager(o.depth, cam_mask=o.cam_mask)
            _assert_same(o, want)
    finally:
        if client is not None:
            client.stop()
        for s in servers:
            s.stop()
