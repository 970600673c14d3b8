"""Colour through the benchmark: the reference's colour map against the
port's, sound and faulty coloured runs at a small size on the CPU (and at
the full widths on the card), and the depth-only configurations reading
what they read before colour came in."""
from __future__ import annotations

import hashlib
import time

import pytest
import torch

from benchmark import check, control, harness, reference, scene, stream
from benchmark.tests.planted import (COLOR_FAULTS, COLOR_LIMIT, faults,
                                     plant, shrink, with_color)

CPU = torch.device("cpu")
SEED = 2 ** 32 + 17
ICP = harness.config("rig8_ring_icp")
MODES = ("native", "aligned")
SMALL = {m: shrink(with_color(ICP, aligned=m == "aligned")) for m in MODES}
MIXES = {"closed": dict(harness.traffic("closed"), window_frames=3,
                        sample_range=3, samples=2),
         "stream15": dict(harness.traffic("stream15"), camera_fps=10,
                          client_fps=10, warmup_frames=2, sample_range=3,
                          samples=2, stale_timeout_s=5.0)}
SECONDS = {"closed": 0.1, "stream15": 8.0}


def _run(monkeypatch, cfg, mix, fault=None, device="cpu",
         seed=SEED, seconds=None):
    """One run of the coloured copy ``cfg`` of rig8_ring_icp under the
    cell of the mix ``mix``, with ``fault`` planted."""
    plant(monkeypatch, {"rig8_ring_icp": cfg},
          None if device != "cpu" else {mix: MIXES[mix]}, fault)
    return harness.run_cell(f"rig8_ring_icp.{mix}", seed,
                            SECONDS[mix] if seconds is None else seconds,
                            False, device, time.perf_counter())


@pytest.mark.parametrize("mode", MODES)
def test_the_reference_maps_colour_as_the_port_does(mode):
    from pointcloud_stitching_tpu_torch import Intrinsics
    from pointcloud_stitching_tpu_torch.ops.deproject import (
        deproject, deproject_with_color, map_color)
    cfg = SMALL[mode]
    rig = scene.make_rig(cfg, SEED)
    depths = scene.render_cycle(cfg, rig, SEED, CPU)[0]
    colors = scene.render_color(cfg, rig, SEED, CPU)[0]
    col, st, intr = harness.color_of(cfg), cfg["stitch"], harness.intr_of(cfg)
    di = Intrinsics.create(intr["fx"], intr["fy"], intr["ppx"], intr["ppy"],
                           width=st["width"], height=st["height"])
    n = len(depths)
    di = di.stack([di] * (n - 1))
    args = (st["depth_scale"], st["z_min"], st["z_max"])
    if col["aligned"]:
        pc = deproject_with_color(depths, colors, di, *args)
    else:
        ci = Intrinsics.create(col["fx"], col["fy"], col["ppx"], col["ppy"],
                               width=col["width"], height=col["height"])
        pc = map_color(deproject(depths, di, *args), colors,
                       ci.stack([ci] * (n - 1)),
                       col["ext"].to(torch.float32).repeat(n, 1, 1))
    mapped = 0
    for c in range(n):
        xyz, valid = reference.deproject(depths[c], intr["fx"], intr["fy"],
                                         intr["ppx"], intr["ppy"],
                                         st["depth_scale"], st["z_min"],
                                         st["z_max"])
        ref = reference.map_color(xyz, valid, colors[c], col)
        assert torch.equal(ref.reshape(-1, 3), pc.rgb[c].double())
        mapped += int((ref.reshape(-1, 3) > 0).any(-1).sum())
    # most points take a colour; native colour sees less than the depth
    assert mapped > 0.5 * int(pc.mask.sum())


def test_each_seed_textures_the_scene_its_own_way_and_repeats():
    cfg = SMALL["native"]
    rig = scene.make_rig(cfg, SEED)
    a = scene.render_color(cfg, rig, SEED, CPU)
    assert a.dtype == torch.uint8
    assert a.shape == (3, 8, cfg["rig"]["color"]["height"],
                       cfg["rig"]["color"]["width"], 3)
    assert torch.equal(a, scene.render_color(cfg, rig, SEED, CPU))
    other = scene.make_rig(cfg, SEED + 1)
    assert not torch.equal(a, scene.render_color(cfg, other, SEED + 1, CPU))
    # the frames move with the scene, and noise leaves snappy little
    assert not torch.equal(a[0], a[1])
    assert stream._ratio(a[0].numpy()) < 1.5


@pytest.mark.parametrize("mix", ("closed", "stream15"))
@pytest.mark.parametrize("mode", MODES)
def test_a_sound_coloured_run_is_correct(monkeypatch, mode, mix):
    line, lines = _run(monkeypatch, SMALL[mode], mix)
    assert line["correct"], lines
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(check.NAMES) | {check.COLOR,
                                                      "wrong_frames"}
    assert list(line["checks"])[-2:] == [check.COLOR, "wrong_frames"]


@pytest.mark.parametrize("mode,fault", [
    (m, f) for m in MODES for f in faults(SMALL[m]) if f in COLOR_FAULTS])
def test_a_colour_fault_fails_color_off_pct(monkeypatch, mode, fault):
    line, lines = _run(monkeypatch, SMALL[mode], "closed", fault)
    assert not line["correct"], lines
    table = line["checks"]
    assert table[check.COLOR]["value"] > 10 * COLOR_LIMIT
    # the colour number catches it: the geometry stays within its limits
    assert all(v["value"] <= v["limit"] for k, v in table.items()
               if k != check.COLOR)


def test_faults_of_colour_come_only_with_colour():
    assert faults(ICP) == ("unchanged", "half", "altered")
    assert set(faults(SMALL["native"])) - set(faults(ICP)) == set(
        COLOR_FAULTS)
    assert "no_color_ext" not in faults(SMALL["aligned"])


# what the depth-only configurations read at the small size on the CPU,
# taken from the benchmark before it served colour: the rendered cycle with
# its calibration and the served bytes (sha256), and a closed run's checks
PARENT = {
    "rig8_ring_icp": (
        "022170a7fd050767dbaad37296a2ae27436edb44c754496df073b1d78bdae83d",
        "a47197a1875d562dffbff68c63eaf0a3f8ee0038de0e9fcf69a49d8b8a7e9dcc",
        {"pose_gap_mm": 0.0008981294702381036, "pose_far_frames": 0,
         "voxel_mismatch_pct": 0.00533931336430135,
         "moved_voxels_pct": 0.0, "wrong_frames": 0}),
    "rig8_fixed_cal": (
        "891ef756ae48e6067aa6cd167920f4e5cdbe05c99018eb030ff06cf97d5346c9",
        "a47197a1875d562dffbff68c63eaf0a3f8ee0038de0e9fcf69a49d8b8a7e9dcc",
        {"pose_gap_mm": 0.0, "pose_far_frames": 0,
         "voxel_mismatch_pct": 0.010305028854080791,
         "moved_voxels_pct": 0.005152514427040396, "wrong_frames": 0}),
}


@pytest.mark.parametrize("name", sorted(PARENT))
def test_a_depth_only_configuration_reads_as_before_colour(monkeypatch,
                                                           name):
    cfg = shrink(harness.config(name))
    rig = scene.make_rig(cfg, SEED)
    cycle = scene.render_cycle(cfg, rig, SEED, CPU)
    served = b"".join(b for cam in stream.encode(cycle.numpy(), 99)
                      for b in cam)
    plant(monkeypatch, {name: cfg}, {"closed": MIXES["closed"]})
    line, _ = harness.run_cell(f"{name}.closed", SEED, 0.1, False, "cpu",
                               time.perf_counter())
    want_cycle, want_served, want_checks = PARENT[name]
    assert hashlib.sha256(cycle.numpy().tobytes()
                          + rig.calib.numpy().tobytes()
                          ).hexdigest() == want_cycle
    assert hashlib.sha256(served).hexdigest() == want_served
    assert {k: v["value"] for k, v in line["checks"].items()} == want_checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the coloured copy's full widths")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", (None,) + COLOR_FAULTS)
@pytest.mark.parametrize("mix", ("closed", "stream15"))
def test_the_coloured_copy_at_its_full_widths(card, monkeypatch, mix, fault):
    cfg = with_color(ICP)
    line, lines = _run(monkeypatch, cfg, mix, fault, card,
                       seed=4200000101, seconds=12.0 if mix != "closed"
                       else 4.0)
    print(mix, fault, line["checks"])
    assert line["attempted"] > 0
    assert line["correct"] == (fault is None), lines
    if fault is not None:
        assert line["checks"][check.COLOR]["value"] > \
            line["checks"][check.COLOR]["limit"]


@pytest.mark.cuda
def test_the_colour_control_fails_color_off_pct_at_the_full_widths(card):
    cfg = with_color(ICP)
    for seed in (1, 2, 3):
        sound = check.worst(control.readings(cfg, seed, 2, False, card),
                            cfg["limits"])
        tf32 = check.worst(control.readings(cfg, seed, 2, True, card),
                           cfg["limits"])
        print(seed, sound[check.COLOR], tf32[check.COLOR])
        assert sound[check.COLOR] <= COLOR_LIMIT < tf32[check.COLOR]
