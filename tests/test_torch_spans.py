"""The port's named spans (``utils/profiling.annotate``) in the stitch step.

One profiled frame holds each span of the step the expected number of
times, none of them a user scope; the outputs with a profiler on equal
those with it off, bit for bit. On the card (``-m cuda``), no device-typed
event carries a span's name and the spans change no device operation. The
file imports no JAX, so on the card it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""
import collections
import contextlib
import importlib

import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu_torch import (Intrinsics, StitchConfig,
                                            StitchingPipeline)
from pointcloud_stitching_tpu_torch.utils import profiling
from oracle import synth_depth_frame

NCAM, H, W = 4, 60, 106
ITERS = 3
# every module that opens a span (by module: ``ops.icp`` is also a function)
SPAN_MODULES = [importlib.import_module("pointcloud_stitching_tpu_torch." + m)
                for m in ("models.stitcher", "ops.icp", "ops.voxel",
                          "kernels.segment_reduce", "runtime.client")]


def _pipeline(icp_on: bool, device, ncam=NCAM, h=H, w=W):
    cfg = StitchConfig(num_cameras=ncam, height=h, width=w,
                       out_voxel_leaf=0.02, out_capacity=16384,
                       icp_enabled=icp_on, icp_voxel_leaf=0.1,
                       icp_capacity=512, icp_iterations=ITERS,
                       icp_max_corr_dist=0.3, icp_trim_fraction=0.1,
                       icp_stride=2, icp_variant="point_to_plane")
    i0 = Intrinsics.create(fx=53.0 * w / W, fy=53.0 * w / W, ppx=w / 2,
                           ppy=h / 2, width=w, height=h)
    ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    ext[:, :3, 3] = np.random.default_rng(3).uniform(-0.05, 0.05, (ncam, 3))
    return StitchingPipeline(cfg, i0.stack([i0] * (ncam - 1)), ext,
                             device=device)


def _depths(device, ncam=NCAM, h=H, w=W):
    return torch.from_numpy(np.stack(
        [synth_depth_frame(h, w, seed=s) for s in range(ncam)])).to(device)


def _step(pipe, depths, points: bool):
    if not points:
        return pipe(depths)
    n = depths.shape[0]
    pts = torch.rand((n, 2000, 3), generator=torch.Generator().manual_seed(
        5)).to(depths.device) * 2.0 - 1.0
    pts[..., 2] += 2.0
    return pipe.step_points(pts, torch.ones(pts.shape[:2], dtype=torch.bool,
                                            device=depths.device))


def _profile(fn, device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return out, prof.events()


def _same(a, b):
    for name in ("xyz", "mask", "rgb"):
        x, y = getattr(a.cloud, name), getattr(b.cloud, name)
        assert (x is None) == (y is None), name
        assert x is None or torch.equal(x, y), name
    assert torch.equal(a.extrinsics, b.extrinsics)
    for x, y in zip(a.metrics, b.metrics):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


@pytest.mark.parametrize("points", [False, True], ids=["depth", "points"])
@pytest.mark.parametrize("icp_on", [True, False], ids=["icp", "fixed"])
def test_a_profiled_frame_holds_each_stitch_span(icp_on, points):
    dev = torch.device("cpu")
    pipe, d = _pipeline(icp_on, dev), _depths(dev)
    _step(pipe, d, points)
    _, events = _profile(lambda: _step(pipe, d, points), dev)
    spans = [e for e in events if e.name.startswith("pcs.")]
    count = collections.Counter(e.name for e in spans)
    want = {"pcs.output": 1, "pcs.output.voxel": 1,
            # one blocking read, the global voxel pass's: the ICP pass's
            # 10 cm leaf rules the packed branch out on the host
            "pcs.sync": 1}
    if not points:
        want["pcs.prepare"] = 1
    if icp_on:
        want.update({"pcs.icp": 1, "pcs.icp.iter": ITERS})
    assert dict(count) == want
    assert not any(e.is_user_annotation for e in spans)

    def inside(outer, name):
        return [e for e in spans if e.name == name
                and outer.time_range.start <= e.time_range.start
                and e.time_range.end <= outer.time_range.end]
    out = next(e for e in spans if e.name == "pcs.output")
    assert len(inside(out, "pcs.output.voxel")) == 1
    assert len(inside(out, "pcs.sync")) == 1
    if icp_on:
        ic = next(e for e in spans if e.name == "pcs.icp")
        assert len(inside(ic, "pcs.icp.iter")) == ITERS
        assert not inside(ic, "pcs.sync")


@pytest.mark.parametrize("points", [False, True], ids=["depth", "points"])
@pytest.mark.parametrize("icp_on", [True, False], ids=["icp", "fixed"])
def test_outputs_with_a_profiler_on_equal_those_with_it_off(icp_on, points):
    dev = torch.device("cpu")
    pipe, d = _pipeline(icp_on, dev), _depths(dev)
    off = _step(pipe, d, points)
    on, _ = _profile(lambda: _step(pipe, d, points), dev)
    _same(on, off)


def test_annotate_is_the_fast_span_under_a_profiler_else_nothing(
        monkeypatch):
    assert isinstance(profiling.annotate("pcs.x"), contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.annotate("pcs.x"),
                          torch._C._profiler._RecordFunctionFast)
        monkeypatch.setattr(profiling, "_SPAN", None)
        assert isinstance(profiling.annotate("pcs.x"),
                          contextlib.nullcontext)


@pytest.mark.parametrize("edge", ["start", "stop"])
def test_a_profiler_may_start_or_stop_inside_a_span(edge):
    """The streaming client's ``on_frame`` runs inside a span and may
    start a profiler, or a caller may stop one while a span is open."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    if edge == "stop":
        prof.__enter__()
    with profiling.annotate("pcs.edge"):
        if edge == "start":
            prof.__enter__()
        else:
            prof.__exit__(None, None, None)
        torch.ones(2).sum()
    if edge == "start":
        prof.__exit__(None, None, None)
    # what ran while the profiler did
    want = "aten::sum" if edge == "start" else "pcs.edge"
    assert want in [e.name for e in prof.events()]


@pytest.fixture
def cuda_device():
    """The first GPU; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device trace of the spans")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("icp_on", [True, False], ids=["icp", "fixed"])
def test_spans_add_no_device_event_on_the_card(cuda_device, monkeypatch,
                                               icp_on):
    """At 8 × 848×480: no CUDA-typed event carries a ``pcs.`` name, and
    the device operations a frame are those with every span made a null
    context."""
    pipe = _pipeline(icp_on, cuda_device, ncam=8, h=480, w=848)
    d = _depths(cuda_device, 8, 480, 848)
    frames = 3

    def run():
        for _ in range(frames):
            out = pipe(d)
        return out

    def device_ops(events):
        cuda = torch.autograd.DeviceType.CUDA
        return [e for e in events if e.device_type == cuda]

    run()
    _profile(run, cuda_device)   # the profiler's own first start
    out_spans, events = _profile(run, cuda_device)
    with_spans = device_ops(events)
    assert with_spans
    assert not [e.name for e in with_spans if e.name.startswith("pcs.")]
    host = collections.Counter(e.name for e in events
                               if e.name.startswith("pcs."))
    assert host["pcs.sync"] == frames
    assert host["pcs.voxel.k1_packed"] == frames
    # the ICP stage replays as one CUDA graph
    assert host["pcs.icp.graph"] == (frames if icp_on else 0)
    for mod in SPAN_MODULES:
        monkeypatch.setattr(mod, "annotate",
                            lambda name: contextlib.nullcontext())
    out_null, events = _profile(run, cuda_device)
    assert not [e for e in events if e.name.startswith("pcs.")]
    assert len(device_ops(events)) == len(with_spans)
    _same(out_spans, out_null)


@pytest.mark.parametrize("on", ["cpu", pytest.param("cuda",
                                                    marks=pytest.mark.cuda)])
def test_the_packed_k1_span_opens_in_the_global_pass_on_the_card(request,
                                                                 on):
    """A profiled frame on the card holds one ``pcs.voxel.k1_packed`` span
    (the pack kernel, the sort and K1 on packed rows), inside
    ``pcs.output.voxel``; a frame on the CPU, whose pass is the plain
    composition, holds none."""
    dev = (request.getfixturevalue("cuda_device") if on == "cuda"
           else torch.device("cpu"))
    pipe, d = _pipeline(False, dev), _depths(dev)
    _step(pipe, d, False)
    _, events = _profile(lambda: _step(pipe, d, False), dev)
    voxel = [e for e in events if e.name == "pcs.output.voxel"]
    packed = [e for e in events if e.name == "pcs.voxel.k1_packed"]
    assert len(voxel) == 1
    assert len(packed) == (1 if on == "cuda" else 0)
    for e in packed:
        assert not e.is_user_annotation
        assert (voxel[0].time_range.start <= e.time_range.start
                and e.time_range.end <= voxel[0].time_range.end)
