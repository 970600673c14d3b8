"""The XYZRGB rig (the benchmark's configuration ``rig8_ring_icp_color``:
eight D435s whose 1280x720 RGB is texture-mapped onto every point under
ring ICP) through the port.

On the CPU: the configuration's files, the port's coloured stitch against
the benchmark's plain reference at a small size, and a coloured stream's
ingest stages and colour span. On the card (``-m cuda``): the colour map's
kernel (``kernels/map_color.py``) against the torch composition it stands
in for (``ops/deproject.py::map_color`` with ``impl='torch'``). The file
imports no JAX, so on the card it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_color_config.py
"""
import collections
import threading
import time

import numpy as np
import pytest
import torch

from benchmark import check, harness, scene
from benchmark.tests.planted import plant, shrink, with_color
from pointcloud_stitching_tpu_torch import (Intrinsics, StitchConfig,
                                            StitchingPipeline)
from pointcloud_stitching_tpu_torch.kernels import build as kb
from pointcloud_stitching_tpu_torch.ops.deproject import (deproject,
                                                          map_color, project)
from pointcloud_stitching_tpu_torch.ops.se3 import se3_apply
from pointcloud_stitching_tpu_torch.runtime import (FakeCameraServer,
                                                    MulticameraClient)
from pointcloud_stitching_tpu_torch.runtime.fake_server import \
    synthetic_frames
from pointcloud_stitching_tpu_torch.utils.types import DistortionModel

NAME = "rig8_ring_icp_color"
SEED = 2 ** 32 + 29
# what identifies a deployment, not the words that describe it
DESCRIPTIVE = ("name", "source", "deployment", "assumed")


@pytest.fixture
def cuda_device():
    """The first GPU; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_the_configuration_is_the_icp_rig_with_a_d435s_colour():
    cfg = harness.config(NAME)
    want = with_color(harness.config("rig8_ring_icp"))
    assert {k: v for k, v in cfg.items() if k not in DESCRIPTIVE} == \
        {k: v for k, v in want.items() if k not in DESCRIPTIVE}
    assert cfg["name"] == NAME and cfg["reduced"] == []
    assert len(cfg["source"]) <= 200
    col = harness.color_of(cfg)
    assert not col["aligned"]
    assert (col["width"], col["height"]) == (1280, 720)
    spec = harness.benchmark_spec()
    assert next(c for c in spec["configs"] if c["name"] == NAME)["file"] \
        == f"benchmark/configs/{NAME}.json"
    # the 6 FPS mix is the 15 FPS one at the D435's 6 FPS mode
    assert harness.traffic("stream6") == dict(
        harness.traffic("stream15"), camera_fps=6, client_fps=6)


def test_the_coloured_stitch_matches_the_reference(monkeypatch):
    """At ``planted.shrink`` size on the CPU, the coloured
    ``StitchingPipeline`` judged against ``benchmark.reference.stitch`` by
    the benchmark's own check."""
    small = shrink(harness.config(NAME), cameras=4, cycle=2)
    mix = dict(harness.traffic("closed"), window_frames=2, sample_range=2,
               samples=2)
    plant(monkeypatch, {NAME: small}, {"closed": mix})
    line, lines = harness.run_cell(f"{NAME}.closed", SEED, 0.1, False, "cpu",
                                   time.perf_counter())
    assert line["correct"], lines
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["checks"][check.COLOR]["value"] <= 0.05, lines


class _ByThread:
    """A stage timer that keeps which threads recorded each stage."""

    def __init__(self):
        self.threads = collections.defaultdict(set)

    def record(self, stage, seconds):
        assert seconds >= 0, (stage, seconds)
        self.threads[stage].add(threading.current_thread().name)


def test_a_coloured_stream_records_ingest_stages_and_the_colour_span():
    ncam, h, w, hc, wc = 2, 30, 40, 36, 64
    servers = [FakeCameraServer(synthetic_frames(4, h, w, seed=s),
                                color_shape=(hc, wc)).start()
               for s in range(ncam)]
    cfg = StitchConfig(num_cameras=ncam, height=h, width=w,
                       out_voxel_leaf=0.02, out_capacity=4096,
                       icp_enabled=False, with_color=True, color_height=hc,
                       color_width=wc)
    di = Intrinsics.create(fx=26.0, fy=26.0, ppx=w / 2, ppy=h / 2, width=w,
                           height=h)
    ci = Intrinsics.create(fx=40.0, fy=40.0, ppx=wc / 2, ppy=hc / 2,
                           width=wc, height=hc)
    pipe = StitchingPipeline(cfg, di.stack([di] * (ncam - 1)),
                             np.tile(np.eye(4, dtype=np.float32),
                                     (ncam, 1, 1)),
                             color_intr=ci.stack([ci] * (ncam - 1)),
                             device=torch.device("cpu"))
    client = MulticameraClient([("127.0.0.1", s.port) for s in servers],
                               pipe).start()
    try:
        assert client.wait_for_first_frames(timeout=10)
        client.run(num_frames=2)
        # swapped in while the ingest threads run, as the benchmark does:
        # they must record into the timer that is there now
        client.stages = timer = _ByThread()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            client.run(num_frames=3, overlap=True)
        deadline = time.time() + 5
        cams = {f"ingest-cam{i}" for i in range(ncam)}
        while timer.threads["decode"] != cams and time.time() < deadline:
            time.sleep(0.05)
    finally:
        client.stop()
        for s in servers:
            s.stop()
    assert timer.threads["recv"] == cams
    assert timer.threads["decode"] == cams
    # the main thread's stages are not the ingest threads'
    assert all(not n.startswith("ingest-") for k in ("snapshot", "dispatch")
               for n in timer.threads[k])
    spans = [e for e in prof.events() if e.name.startswith("pcs.")]
    names = collections.Counter(e.name for e in spans)
    assert names["pcs.prepare.color"] == names["pcs.prepare"] >= 3
    # every span is opened by the thread that runs the loop: the ingest
    # threads open none, so the trace's gaps are the loop's own
    assert len({e.thread for e in spans}) == 1


def test_ingest_records_from_many_threads_at_once_all_land():
    """Every ingest thread records through the client into the timer that
    is there when it records, and none of 8 threads recording at once
    loses a sample."""
    from benchmark.stream import Stages
    ncam = 8
    cfg = StitchConfig(num_cameras=ncam, height=6, width=8,
                       out_voxel_leaf=0.02, out_capacity=64,
                       icp_enabled=False)
    di = Intrinsics.create(fx=5.0, fy=5.0, ppx=4.0, ppy=3.0, width=8,
                           height=6)
    pipe = StitchingPipeline(cfg, di.stack([di] * (ncam - 1)),
                             np.tile(np.eye(4, dtype=np.float32),
                                     (ncam, 1, 1)),
                             device=torch.device("cpu"))
    # never started: no camera is reached
    client = MulticameraClient([("127.0.0.1", 1)] * ncam, pipe)
    client.stages = stages = Stages()
    records = [t._record for t in client._threads]

    def ingest(record):
        for _ in range(2000):
            record("recv", 1e-6)
            record("decode", 2e-6)

    threads = [threading.Thread(target=ingest, args=(r,)) for r in records]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert {k: len(v) for k, v in stages.stages.items()} == {
        "recv": 2000 * ncam, "decode": 2000 * ncam}


# The agreement rule of the kernel and the torch composition. Both project
# as ops/deproject.py's project does (the distortion model operation by
# operation, then u = x * fx + ppx as one fused multiply-add) and round
# half to even, but the composition's depth-to-colour transform is a
# cuBLAS matmul whose summation order is not the kernel's. The last bit of
# the transformed point may differ, and that can move u or v across a half
# pixel, and so the pixel the point takes, but nowhere else. So on the
# seeded full-width scene at least 99.99% of the points take the same
# colour, and every point that differs has the composition's own u or v
# within 1e-3 px of a half pixel.
AGREE_SHARE = 0.9999
HALF_PX = 1e-3
# a D435's colour stream reports a Brown-Conrady model (librealsense's
# model 1 or 2); these are of a lens's size, each camera's its own
COEFFS = (0.12, -0.25, 1e-3, -5e-4, 0.1)
MODELS = {"none": [DistortionModel.NONE],
          "brown_conrady": [DistortionModel.BROWN_CONRADY],
          "inverse_brown_conrady": [DistortionModel.INVERSE_BROWN_CONRADY],
          "mixed": [DistortionModel.NONE, DistortionModel.BROWN_CONRADY,
                    DistortionModel.INVERSE_BROWN_CONRADY]}


def _rig_colour(col, ncam, models, dev):
    """Colour intrinsics and depth-to-colour extrinsics [ncam, 4, 4] of
    ``ncam`` cameras, each moved off the configuration's own by its index
    (focal length, principal point, a turn about y and a shift), and with
    the models taken in turn."""
    cams, exts = [], []
    for c in range(ncam):
        cams.append(Intrinsics.create(
            col["fx"] * (1 + 0.01 * c), col["fy"] * (1 - 0.007 * c),
            col["ppx"] + 3.0 * c, col["ppy"] - 2.0 * c,
            coeffs=[k * (1 + 0.05 * c) for k in COEFFS],
            width=col["width"], height=col["height"],
            model=models[c % len(models)], device=dev))
        a = np.radians(0.3 * c)
        turn = torch.tensor([[np.cos(a), 0, np.sin(a), 0.002 * c],
                             [0, 1, 0, -0.001 * c],
                             [-np.sin(a), 0, np.cos(a), 0], [0, 0, 0, 1]],
                            dtype=torch.float64)
        exts.append(turn @ col["ext"].to(torch.float64))
    return (cams[0].stack(cams[1:]),
            torch.stack(exts).to(torch.float32).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("models", list(MODELS))
def test_the_kernel_agrees_with_the_composition_at_full_widths(cuda_device,
                                                              models):
    cfg = harness.config(NAME)
    st, col = cfg["stitch"], harness.color_of(cfg)
    rig = scene.make_rig(cfg, SEED)
    depths = scene.render_cycle(cfg, rig, SEED, cuda_device)[:2]
    colors = scene.render_color(cfg, rig, SEED, cuda_device)[:2]
    intr = harness.intr_of(cfg)
    ncam = st["num_cameras"]
    di = Intrinsics.create(intr["fx"], intr["fy"], intr["ppx"], intr["ppy"],
                           width=st["width"], height=st["height"],
                           device=cuda_device)
    di = di.stack([di] * (ncam - 1))
    ci, ext = _rig_colour(col, ncam, MODELS[models], cuda_device)
    total = differ = 0
    for d, c in zip(depths, colors):
        pc = deproject(d, di, st["depth_scale"], st["z_min"], st["z_max"])
        kb.reset_launches()
        got = map_color(pc, c, ci, ext, impl="cuda").rgb
        assert kb.LAUNCHES["map_color"] == 1
        want = map_color(pc, c, ci, ext, impl="torch").rgb
        assert got.shape == want.shape == (ncam, st["height"] * st["width"],
                                           3)
        bad = (got != want).any(-1)
        total += bad.numel()
        differ += int(bad.sum())
        if bad.any():
            uv, _ = project(se3_apply(ext, pc.xyz), ci)
            uv = uv[bad].double()
            near = (uv - uv.floor() - 0.5).abs().min(-1).values
            assert float(near.max()) < HALF_PX, float(near.max())
        # most valid points take a colour, in every camera
        assert ((got > 0).any(-1).sum(-1) > 0.5 * pc.mask.sum(-1)).all()
    assert differ <= (1 - AGREE_SHARE) * total, (differ, total)


def _edge_case(case: str):
    """Two cameras of 8 x 12 colour pixels at fx = fy = 1, ppx = ppy = 0
    and the identity extrinsic, points at z = 1 unless the case says
    otherwise: the arithmetic is exact, so kernel and composition must
    agree bit for bit. Camera 1 holds the same points, masked where the
    case says. Returns (xyz, mask, colour intrinsics, extrinsics, hc, wc,
    want) with ``want`` [2, P] the (v, u) pixel of each point, or None
    where it takes no colour."""
    hc, wc = 8, 12
    pts, coloured = {
        # z <= 1e-9 is behind; 2e-9 is in front but maps far outside
        "behind": ([(3, 3, 0.0), (3, 3, -1.0), (3, 3, 1e-10), (3, 3, 2e-9),
                    (3, 3, 1.0)], [False, False, False, False, True]),
        # just outside and just inside each edge (rint(-0.5) = -0: inside)
        "edges": ([(-0.6, 3, 1), (-0.5, 3, 1), (-0.4, 3, 1),
                   (wc - 0.6, 3, 1), (wc - 0.5, 3, 1), (wc - 0.4, 3, 1),
                   (3, -0.6, 1), (3, -0.4, 1), (3, hc - 0.6, 1),
                   (3, hc - 0.5, 1), (3, hc - 0.4, 1)],
                  [False, True, True, True, False, False, False, True,
                   True, False, False]),
        # exactly half a pixel: half to even
        "half": ([(2.5, 3, 1), (3.5, 3, 1), (4, 4.5, 1), (4, 5.5, 1),
                  (0.5, 0.5, 1)], [True] * 5),
        "masked": ([(3, 3, 1), (5, 2, 1)], [True, True]),
        "empty_camera": ([(3, 3, 1), (5, 2, 1)], [True, True]),
        "per_camera": ([(3, 3, 1), (5, 2, 1), (9, 6, 1), (10.5, 1, 1)],
                       [True] * 4),
    }[case]
    xyz = torch.tensor(pts, dtype=torch.float32).expand(2, -1, -1).clone()
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool)
    c0 = Intrinsics.create(1.0, 1.0, 0.0, 0.0, width=wc, height=hc)
    ci, ext = c0.stack([c0]), torch.eye(4).repeat(2, 1, 1)
    want = [[(round(y), round(x)) if ok else None
             for (x, y, _), ok in zip(pts, coloured)]] * 2
    if case == "masked":
        mask[:, 1] = False
        want = [[want[0][0], None]] * 2
    if case == "empty_camera":
        mask[1] = False
        want = [want[0], [None] * len(pts)]
    if case == "per_camera":
        # camera 1 sits 1 m behind and 1 m left of the depth sensor at
        # fx = fy = 2, ppx = 1, ppy = 0.5: u = x + 2 and v = y + 0.5,
        # exactly, so its points take other pixels than camera 0's, and
        # its last leaves the frame
        ci = c0.stack([Intrinsics.create(2.0, 2.0, 1.0, 0.5, width=wc,
                                         height=hc)])
        ext[1, :3, 3] = torch.tensor([1.0, 0.0, 1.0])
        want = [want[0], [(4, 5), (2, 7), (6, 11), None]]
    return xyz, mask, ci, ext, hc, wc, want


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["behind", "edges", "half", "masked",
                                  "empty_camera", "per_camera"])
def test_the_kernel_maps_the_edge_cases_as_the_composition(cuda_device,
                                                          case):
    from pointcloud_stitching_tpu_torch.utils.types import PointCloud
    xyz, mask, ci, ext, hc, wc, pixels = _edge_case(case)
    gen = torch.Generator().manual_seed(7)
    # no black pixel, so a colour of 0 says "not mapped"
    color = torch.randint(1, 256, (2, hc, wc, 3), generator=gen,
                          dtype=torch.uint8)
    want = map_color(PointCloud(xyz=xyz, mask=mask), color, ci, ext).rgb
    dev = cuda_device
    got = map_color(PointCloud(xyz=xyz.to(dev), mask=mask.to(dev)),
                    color.to(dev), ci.to(dev), ext.to(dev),
                    impl="cuda").rgb.cpu()
    assert torch.equal(got, want)
    for c in range(2):
        for i, vu in enumerate(pixels[c]):
            assert torch.equal(got[c, i], torch.zeros(3) if vu is None
                               else color[c, vu[0], vu[1]].float()), (c, i)
