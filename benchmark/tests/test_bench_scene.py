"""The scene, the sequence tag and the camera generator's clock."""
from __future__ import annotations

import json
import math
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import harness, scene, stream
from benchmark.tests.planted import shrink

CFG = shrink(harness.config("rig8_ring_icp"), factor=8, cycle=2)
CPU = torch.device("cpu")


def _cycle(seed):
    rig = scene.make_rig(CFG, seed)
    return rig, scene.render_cycle(CFG, rig, seed, CPU)


def test_one_seed_gives_the_same_scene_and_two_seeds_differ():
    rig_a, a = _cycle(2 ** 33 + 7)
    rig_b, b = _cycle(2 ** 33 + 7)
    rig_c, c = _cycle(2 ** 33 + 8)
    assert torch.equal(a, b) and torch.equal(rig_a.calib, rig_b.calib)
    assert not torch.equal(a, c)
    assert not torch.equal(rig_a.calib, rig_c.calib)
    assert torch.equal(rig_a.true_pose, rig_c.true_pose)
    # the seed moves the calibration error's direction, not its size
    for r in (rig_a, rig_c):
        t = (r.calib.double()[:, :3, 3] - r.true_pose[:, :3, 3]).norm(dim=1)
        assert torch.allclose(t, torch.full_like(t, 1e-3 * CFG["sensor"][
            "cal_err_mm"]), atol=1e-6)
    assert a.dtype == torch.uint16
    hit = (a.to(torch.int32) > 0).double().mean()
    assert 0.1 < float(hit) < 0.9


def test_the_encoded_frames_differ_by_seed_and_repeat_for_one():
    _, a = _cycle(11)
    _, b = _cycle(12)
    ea = stream.encode(a.numpy(), 99)
    assert ea == stream.encode(a.numpy(), 99)
    assert ea != stream.encode(b.numpy(), 99)
    assert len(ea) == CFG["rig"]["cameras"] and len(ea[0]) == math.lcm(2, 99)


def test_clock_phases_are_one_spread_in_a_seeded_order():
    a, b = scene.clock_phases(8, 1), scene.clock_phases(8, 2)
    assert sorted(a) == sorted(b) and a != b
    assert sorted(a) == [(i + 0.5) / 8 for i in range(8)]


@pytest.mark.parametrize("seq", [0, 1, 98, 99, 2 ** 32 + 5])
def test_the_tag_is_masked_by_deprojection_and_decodes_back(seq):
    from pointcloud_stitching_tpu_torch import Intrinsics
    from pointcloud_stitching_tpu_torch.ops.deproject import deproject
    _, frames = _cycle(3)
    d = frames[0, 0].clone()
    d[0, 0] = scene.tag_depth(seq, 99)
    assert scene.untag(int(d[0, 0]), 99) == seq % 99
    rig = CFG["rig"]
    intr = Intrinsics.create(rig["fx"], rig["fy"], rig["width"] / 2,
                             rig["height"] / 2, width=rig["width"],
                             height=rig["height"])
    st = CFG["stitch"]
    pc = deproject(d, intr, st["depth_scale"], st["z_min"], st["z_max"])
    assert not bool(pc.mask[0])
    with pytest.raises(ValueError):
        scene.untag(0, 99)


def _pull(sock):
    sock.sendall(b"\x01")
    head = b""
    while len(head) < 16:
        head += sock.recv(16 - len(head))
    size, _, _, _, _, seq, _, _ = struct.unpack("<IBBBBIHH", head)
    body = b""
    while len(body) < size:
        body += sock.recv(size - len(body))
    return seq, body


def test_the_generator_serves_the_newest_frame_on_its_clock():
    fps = 20.0
    frames = [[stream._header(3, 1, 1) + bytes([c, v, 7])
               for v in range(5)] for c in range(2)]
    proc = subprocess.Popen([sys.executable, str(harness.BENCH /
                                                 "camera.py")],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        spec = {"fps": fps, "phases": [0.25, 0.75],
                "sizes": [[len(b) for b in cam] for cam in frames]}
        proc.stdin.write((json.dumps(spec) + "\n").encode())
        for cam in frames:
            for b in cam:
                proc.stdin.write(b)
        proc.stdin.flush()
        head = json.loads(proc.stdout.readline())
        t0 = head["t0"]
        s = socket.create_connection(("127.0.0.1", head["ports"][1]))
        seq0, body = _pull(s)
        now = time.monotonic()
        newest = int(np.floor((now - t0) * fps - 0.75))
        assert seq0 in (max(newest, 0), newest + 1)
        assert body == bytes([1, seq0 % 5, 7])
        seq1, _ = _pull(s)          # already sent: waits for the next
        assert seq1 == seq0 + 1
        time.sleep(4.2 / fps)       # frames captured meanwhile are skipped
        seq2, _ = _pull(s)
        assert seq2 >= seq1 + 3
        rep = [proc.stdout.readline().split() for _ in range(3)]
        assert [int(r[1]) for r in rep] == [seq0, seq1, seq2]
        for r in rep:
            k, t_cap, t_sent = int(r[1]), float(r[2]), float(r[3])
            assert r[0] == b"1"
            assert t_cap == pytest.approx(t0 + (0.75 + k) / fps, abs=1e-5)
            assert t_sent >= t_cap
        s.close()
    finally:
        proc.stdin.close()
        proc.wait(timeout=10)
    assert proc.returncode == 0
