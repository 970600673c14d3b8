"""The port's scene-analysis CLI and stitch CLI options against the JAX
package's.

``segment_cli`` runs from both packages on the same saved ``.ply``
(in-process, ``PCS_PLATFORM=cpu`` for the port): with ``--drop-plane``,
``--exact``, ``--smooth-angle`` and ``--changed-vs`` the cluster files
are byte for byte the same (``--drop-plane`` splits the key of
``--seed`` before each plane as the JAX CLI does, so both draw the same
hypotheses and remove the same planes). ``stitch_cli --drop-plane`` runs on the constant
depth wall of ``tests/test_tools.py::test_stitch_cli_drop_plane``. Both
CLIs' parsers hold every option string of the JAX CLIs'. The publisher
sends the JAX publisher's bytes, the viewer renders its images, and the
trace hook writes a Chrome trace; the stitch CLI options that use them
run end to end in ``tests/test_torch_runtime.py``.
"""
import argparse
import contextlib
import filecmp
import io
import json
import os
import re
import socket
import time

import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu.runtime import stitch_cli as jax_stitch_cli
from pointcloud_stitching_tpu.tools import segment_cli as jax_segment_cli
from pointcloud_stitching_tpu_torch.io import load_ply, save_ply
from pointcloud_stitching_tpu_torch.runtime import (FakeCameraServer,
                                                    stitch_cli, wire)
from pointcloud_stitching_tpu_torch.tools import segment_cli
from pointcloud_stitching_tpu_torch.utils.config import StitchConfig


def _scene(seed, shift=0.0):
    """A floor, a wall and three objects on the floor (1,500 points)."""
    rng = np.random.default_rng(seed)
    floor = np.c_[rng.uniform(-1, 1, (600, 2)), rng.normal(0, 0.002, 600)]
    wall = np.c_[rng.uniform(-1, 1, 600), 1.0 + rng.normal(0, 0.002, 600),
                 rng.uniform(0.05, 1, 600)]
    objs = [rng.normal(0, [0.05, 0.08, 0.04], (100, 3)) + np.array(c)
            for c in ([0.3 + shift, 0.2, 0.2], [-0.4, -0.3, 0.15],
                      [0.5, -0.5, 0.3])]
    return np.concatenate([floor, wall] + objs).astype(np.float32)


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("segment")
    save_ply(str(d / "scene.ply"), _scene(0))
    # the baseline: the same room with the first object 30 cm away
    save_ply(str(d / "before.ply"), _scene(0, shift=-0.6))
    return d


@pytest.mark.parametrize("flags", [
    ["--drop-plane", "0.01", "--planes", "2", "--obb", "--hull"],
    ["--drop-plane", "0.01", "--planes", "2", "--seed", str(2 ** 32 + 9)],
    ["--exact", "--tolerance", "0.04"],
    ["--smooth-angle", "20", "--max-curvature", "0.05"],
    ["--changed-vs", "before.ply", "--change-leaf", "0.05", "--hull",
     "--hull-alpha", "0.2"]],
    ids=["drop-plane", "drop-plane-seed", "exact", "smooth-angle",
         "changed-vs"])
def test_segment_cli_matches_jax(scene_files, monkeypatch, flags):
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    flags = [str(scene_files / f) if f.endswith(".ply") else f
             for f in flags]
    outs = {}
    for tag, run in (("jax", jax_segment_cli.main),
                     ("port", segment_cli._run)):
        out = scene_files / f"{tag}-{flags[0]}-{len(flags)}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            num = run([str(scene_files / "scene.ply"), str(out),
                       "--min-size", "20", "--seed", "3"] + flags)
        outs[tag] = (num, out, buf.getvalue())
    (nj, dj, tj), (np_, dp, tp) = outs["jax"], outs["port"]
    # the changed-vs baseline differs only by the moved object
    assert nj == np_
    assert np_ == 1 if "--changed-vs" in flags else np_ >= 3
    files = sorted(os.listdir(dj))
    assert files == sorted(os.listdir(dp)) and len(files) >= nj
    for f in files:
        assert filecmp.cmp(dj / f, dp / f, shallow=False), f
    # the printed tables agree but for the output paths and an OBB axis'
    # sign (its yaw mod 180); the planes' lines too (the same draws)
    def table(text):
        text = re.sub(r"\S*(jax|port)-\S*", "", text)
        text = re.sub(r"yaw ([-+][\d.]+) deg",
                      lambda m: f"yaw {float(m.group(1)) % 180:.1f}", text)
        return text.splitlines()

    assert table(tj) == table(tp)
    planes = [re.findall(r"(\d+) inliers", t) for t in (tj, tp)]
    assert planes[0] == planes[1] and len(planes[0]) == (
        2 if "--planes" in flags else 0)


def test_stitch_cli_drop_plane_on_a_wall(tmp_path, monkeypatch):
    """The constant-depth rig of the JAX package's test (one wall at 1 m):
    --drop-plane leaves nearly nothing in every saved cloud."""
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    h, w = 60, 106
    cfg = StitchConfig(num_cameras=1, height=h, width=w,
                       out_voxel_leaf=0.03, out_capacity=8192,
                       icp_enabled=False)
    cfgp = tmp_path / "cfg.json"
    cfg.save(str(cfgp))
    frames = np.full((3, h, w), 1000, np.uint16)

    def run(extra, sub):
        d = tmp_path / sub
        srv = FakeCameraServer(frames).start()
        try:
            stitch_cli.main(["--camera", f"127.0.0.1:{srv.port}",
                             "--config", str(cfgp), "--frames", "2",
                             "--print-every", "0", "--save-dir", str(d),
                             "--save-every", "1"] + extra)
        finally:
            srv.stop()
        return [len(load_ply(str(d / f))[0]) for f in sorted(os.listdir(d))]

    full = run([], "plain")
    rest = run(["--drop-plane", "0.01"], "dropped")
    assert len(full) == len(rest) == 2
    assert min(full) > 40, full
    assert max(rest) < 0.2 * min(full), (rest, full)


def _options(main, argv, monkeypatch):
    """Every option string of the parser a CLI's main builds (read where
    it parses, which then exits as --help does)."""
    seen = set()

    def parse(self, args=None, namespace=None):
        seen.update(self._option_string_actions)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(SystemExit) as e:
        main(argv + ["--help"])
    monkeypatch.undo()
    assert e.value.code == 0
    return seen


@pytest.mark.parametrize("cli", ["stitch_cli", "segment_cli"])
def test_cli_help_lists_every_jax_option(cli, monkeypatch):
    mains = {"stitch_cli": (jax_stitch_cli.main, stitch_cli.main, []),
             "segment_cli": (jax_segment_cli.main, segment_cli.main,
                             ["in.ply", "out"])}[cli]
    want = _options(mains[0], mains[2], monkeypatch)
    got = _options(mains[1], mains[2], monkeypatch)
    assert len(want) > 10
    assert want <= got, sorted(want - got)


def _frames_from(publisher_cls, xyz, rgb, n):
    """The raw bytes a subscriber reads after ``n`` publishes."""
    pub = publisher_cls(port=0, host="127.0.0.1").start()
    try:
        sub = socket.create_connection(("127.0.0.1", pub.port), timeout=10)
        for _ in range(500):
            if pub.num_subscribers:
                break
            time.sleep(0.01)
        sizes = [pub.publish(xyz, rgb) for _ in range(n)]
        want = sum(len(wire.encode_frame(
            wire.pack_points_i16mm(xyz, rgb), wire.Kind.POINTS_I16MM,
            pub.codec, i, flags=wire.FLAG_HAS_RGB if rgb is not None else 0))
            for i in range(n))
        data = b""
        while len(data) < want:
            data += sub.recv(1 << 20)
        sub.close()
    finally:
        pub.stop()
    return sizes, data


def test_publisher_sends_the_jax_packages_bytes():
    """The port's CloudPublisher sends the JAX publisher's frames byte for
    byte; publish_cloud sends a PointCloud's valid rows (one copy)."""
    from pointcloud_stitching_tpu.runtime.publisher import \
        CloudPublisher as JaxPublisher
    from pointcloud_stitching_tpu_torch import PointCloud
    from pointcloud_stitching_tpu_torch.runtime import CloudPublisher
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (500, 3)).astype(np.float32)
    for colour in (None, rgb):
        got = _frames_from(CloudPublisher, xyz, colour, 3)
        assert got == _frames_from(JaxPublisher, xyz, colour, 3)
        assert got[0] == [1, 1, 1]
    mask = rng.random(500) > 0.3
    pc = PointCloud(xyz=torch.from_numpy(xyz), mask=torch.from_numpy(mask),
                    rgb=torch.from_numpy(rgb))
    sent = []
    pub = CloudPublisher(port=0)
    pub.publish = lambda x, c=None: sent.append((x, c)) or 0
    pub.publish_cloud(pc)
    np.testing.assert_array_equal(sent[0][0], xyz[mask])
    np.testing.assert_array_equal(sent[0][1], rgb[mask])
    pub.stop()


def test_cloud_view_renders_the_jax_packages_images():
    """CloudView (stitch_cli --view, the stream viewer) renders the JAX
    package's images through a sequence of steering commands."""
    from pointcloud_stitching_tpu.runtime.view_cli import \
        CloudView as JaxView
    from pointcloud_stitching_tpu_torch import PointCloud
    from pointcloud_stitching_tpu_torch.runtime.view_cli import CloudView
    rng = np.random.default_rng(2)
    xyz = rng.normal(0, 1, (2000, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (2000, 3)).astype(np.float32)
    views = [CloudView(axis="x", size=96), JaxView(axis="x", size=96)]
    for cmd in (None, "az+", "el-", "shade", "reset", "el+"):
        for v in views:
            assert v.apply_command(cmd) == (cmd is not None)
        imgs = [v.render(xyz, rgb) for v in views]
        np.testing.assert_array_equal(imgs[0], imgs[1])
    mask = rng.random(2000) > 0.5
    pc = PointCloud(xyz=torch.from_numpy(xyz), mask=torch.from_numpy(mask),
                    rgb=torch.from_numpy(rgb))
    np.testing.assert_array_equal(views[0].render_cloud(pc),
                                  views[1].render(xyz[mask], rgb[mask]))


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    from pointcloud_stitching_tpu_torch.utils.profiling import (annotate,
                                                                trace)
    with trace(str(tmp_path / "t")):
        with annotate("pcs-span"):
            torch.ones(8).cumsum(0)
    with open(tmp_path / "t" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pcs-span", "aten::cumsum"} <= names
