"""bench_torch.py and scripts/roofline_torch.py, the port's benchmark, on
the CPU, with bench_card.py, the helpers they share.

The scene builder against __graft_entry__._flagship, the structured row's
output-leaf autofit against the JAX package's stitch step and controller
on the same inputs (2 cameras of 60x106, a 2048-slot grid, the JAX side on
its XLA backend), every row function at a tiny size under
``PCS_PLATFORM=cpu``, the last line's length and keys against bench.py's,
the roofline's bound arithmetic at the flagship's counts, and the scripts'
imports and refusal without a GPU. The card runs them at full size
(chip_smoke.py phase 16).
"""
import ast
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pointcloud_stitching_tpu import Intrinsics as JIntrinsics
from pointcloud_stitching_tpu.models import stitch_step as jax_step
from pointcloud_stitching_tpu.models.stitcher import (
    autofit_out_leaf as jax_autofit)
from pointcloud_stitching_tpu.runtime import (
    synthetic_frames as jax_synthetic_frames)
from pointcloud_stitching_tpu.utils.config import StitchConfig as JConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import bench_card as C  # noqa: E402
import bench_torch as B  # noqa: E402
import roofline_torch as R  # noqa: E402

CPU = torch.device("cpu")
TINY = dict(ncam=2, h=60, w=106)
NPX = 8 * 480 * 848          # the flagship's pixels
LEAF_RTOL = 1e-6             # float32 leaf, port against JAX


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PCS_PLATFORM", "cpu")


@pytest.mark.parametrize("ncam", [4, 8, 16])
def test_flagship_is_graft_entrys(ncam, monkeypatch):
    """The numpy scene builder gives __graft_entry__._flagship's arrays
    bit for bit, its intrinsics and its config. __graft_entry__ turns on
    JAX's persistent compile cache for bench.py, which would then hold for
    the rest of the process: it is kept off here."""
    monkeypatch.setattr(graft, "_enable_compile_cache", lambda: None)
    jcfg, jintr, jext, jdepths = graft._flagship(ncam)
    cfg, intr, ext, depths = C._flagship(ncam)
    assert B._flagship is C._flagship
    assert ext.dtype == np.float32 and depths.dtype == np.uint16
    assert np.array_equal(ext, np.asarray(jext))
    assert np.array_equal(depths, np.asarray(jdepths))
    for k in ("fx", "fy", "ppx", "ppy", "coeffs"):
        assert np.array_equal(getattr(intr, k).numpy(),
                              np.asarray(getattr(jintr, k))), k
    assert (intr.width, intr.height) == (jintr.width, jintr.height)
    shared = {f.name for f in dataclasses.fields(cfg)}
    want = {k: v for k, v in dataclasses.asdict(jcfg).items()
            if k in shared}
    assert dataclasses.asdict(cfg) == want


def test_occupied_1cm_matches_a_set_of_voxels():
    """bench.py's linearised-key count equals a count of distinct voxel
    index triples on a small scene (2 cameras, holes and far points)."""
    rng = np.random.default_rng(5)
    ncam, h, w = 2, 30, 40
    depths = rng.integers(0, 12000, (ncam, h, w)).astype(np.uint16)
    ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    ext[:, :3, 3] = rng.uniform(-0.3, 0.3, (ncam, 3)).astype(np.float32)
    voxels = set()
    for i in range(ncam):
        for v in range(h):
            for u in range(w):
                z = np.float32(depths[i, v, u]) * np.float32(0.001)
                if not (z > 0.1 and z < 10.0):
                    continue
                p = np.array([np.float32(u - w / 2.0) * z / np.float32(C.FX),
                              np.float32(v - h / 2.0) * z / np.float32(C.FY),
                              z], np.float32)
                q = p @ ext[i, :3, :3].T + ext[i, :3, 3]
                voxels.add(tuple(np.floor(q / np.float32(0.01)).astype(int)))
    assert B.occupied_1cm(depths, ext) == len(voxels) > 100


@functools.lru_cache(maxsize=None)
def _jax_structured(capacity, fit_frames):
    """JAX's stitch step + autofit_out_leaf over bench.py's structured
    scene at TINY: the leaf after each frame, and frames_to_fit."""
    ncam, h, w = TINY["ncam"], TINY["h"], TINY["w"]
    jcfg = JConfig(**{**C.flagship_fields(ncam, h, w),
                      "out_capacity": capacity, "kernel_impl": "xla"})
    i0 = JIntrinsics.create(fx=C.FX, fy=C.FY, ppx=w / 2.0, ppy=h / 2.0,
                            width=w, height=h)
    intr = i0.stack([i0] * (ncam - 1))
    _, _, ext, _ = C._flagship(ncam, h, w)
    sd = jnp.asarray(np.stack([jax_synthetic_frames(1, h, w, seed=s)[0]
                               for s in range(ncam)]))
    fn = jax.jit(functools.partial(jax_step, jcfg))
    leaf = jnp.float32(jcfg.out_voxel_leaf)
    leaves, frames_to_fit = [], None
    for i in range(fit_frames):
        out = fn(intr, jnp.asarray(ext), sd, out_leaf=leaf)
        n = int(out.metrics.points_out)
        leaf = jax_autofit(out.metrics.points_out, leaf, capacity=capacity,
                           floor=jcfg.out_voxel_leaf, ceil=0.04)
        leaves.append(float(leaf))
        if frames_to_fit is None and n < capacity:
            frames_to_fit = i + 1
    return leaves, frames_to_fit


def test_structured_row_autofit_matches_jax(cpu_platform):
    """The structured row's leaf trajectory and frames_to_fit are JAX's
    on the same scene, with a capacity small enough to saturate at 1 cm;
    then the row's keys."""
    cap, fit = 2048, 12
    row = B.structured_row(CPU, **TINY, fit_frames=fit, frames=2, turns=2,
                           out_capacity=cap)
    leaves, frames_to_fit = _jax_structured(cap, fit)
    assert frames_to_fit is not None and frames_to_fit > 2   # autofit acted
    assert row["frames_to_fit"] == frames_to_fit
    np.testing.assert_allclose(row["leaves"], leaves, rtol=LEAF_RTOL)
    assert row["out_leaf"] == row["leaves"][-1]
    assert row["fused_voxels"] < cap and row["capacity"] == cap
    assert len(row["frame_s_turns"]) == 2 and row["frame_s"] > 0
    occ = row["occupied"]
    assert occ["flagship_scene"] > occ["structured_scene"] > 0


def test_flagship_and_colored_rows(cpu_platform):
    """bench.py's first and third rows at TINY: the row's seconds per
    frame are all its windows' time over all their frames (windows of
    equal frames: the mean of the per-window values); the refined
    extrinsics come back for the coloured row."""
    row, ext = B.flagship_row(CPU, **TINY, warmup=1, frames=2, turns=3)
    assert len(row["frame_s_turns"]) == 3
    assert row["frame_s"] == pytest.approx(
        float(np.mean(row["frame_s_turns"])), rel=1e-12)
    assert row["frame_s"] > 0
    assert row["pixels"] == 2 * 60 * 106 and row["compile_s"] > 0
    assert 0 < row["fused_voxels"] <= row["capacity"] == 262144
    assert ext.shape == (2, 4, 4) and torch.isfinite(ext).all()
    col = B.colored_row(CPU, ext, **TINY, frames=2, turns=2)
    assert col["frame_s"] > 0 and col["pixels"] == row["pixels"]


def test_cams_row(cpu_platform):
    row = B.cams_row(CPU, ncam=3, h=60, w=106, frames=2, turns=2)
    assert row["pixels"] == 3 * 60 * 106 and row["frame_s"] > 0


def test_p50_row(cpu_platform):
    row = B.p50_row(CPU, **TINY, frames=3)
    assert len(row["latencies_s"]) == 3
    assert row["p50_device_ms"] == max(row["p50_raw_ms"] - row["rtt_ms"], 0)
    assert row["p50_raw_ms"] > 0 and row["rtt_ms"] >= 0


def test_stream_row(cpu_platform):
    """One round of 2 frames through loopback servers and the client."""
    row = B.stream_row(CPU, **TINY, rounds=1, frames=2)
    assert row["codec"] in ("snappy", "raw")
    assert len(row["fps_e2e_windows"]) == len(
        row["fps_e2e_pipelined_windows"]) == 1
    for k in ("fps_e2e", "fps_e2e_pipelined", "p50_latency_ms_e2e",
              "efficiency_vs_bound_sync", "efficiency_vs_bound_pipelined"):
        assert math.isfinite(row[k]) and row[k] > 0, k
    assert row["env_bounds"]["bytes_per_frame"] == 2 * 60 * 106 * 2
    assert "dispatch" in row["stages_ms"]


def test_tsdf_row_pruned_equals_dense(cpu_platform):
    """A 32^3 volume over bench.py's scene box (8 cm leaf): the pruned
    path equals the dense one bit for bit, and every time is there."""
    row = B.tsdf_row(CPU, ncam=4, h=60, w=106, grid=(32, 32, 32), leaf=0.08,
                     reps=(1,) * 6)
    assert row["integrate_bitwise_mxu_vs_dense"] is True
    assert set(row) == {
        "integrate_ms_mxu_pallas", "integrate_ms_dense",
        "integrate_ms_mxu_pallas_rgb", "integrate_bitwise_mxu_vs_dense",
        "raycast_prior_ms", "raycast_full_ms", "track_ms"}
    assert all(v >= 0 for k, v in row.items() if k.endswith("_ms"))


def _bench_py_extras() -> set:
    """The keys of bench.py's ``extras`` dict, read from its source."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
            if "extras" in keys:
                extras = node.values[keys.index("extras")]
                return {k.value for k in extras.keys}
    raise AssertionError("bench.py has no extras dict")


def _full_size_results() -> dict:
    """Rows' results with H100-sized values and long unrounded floats."""
    x = 1.0 / 3.0
    rows = [{"stage": "deproject+mask", "ms": x}] * 4 + [
        {"stage": "FULL FRAME", "ms": 14.123456789, "sol_ms": 0.00104795,
         "alg_ms": 0.2031234567, "x_alg": 69.5312345678}]
    return {
        "card": "NVIDIA H100 80GB HBM3, 700.00 W",
        "sync_rtt_s": 2.34567891e-5,
        "flagship": {"frame_s": 0.0146789123, "pixels": NPX,
                     "compile_s": 1.23456789, "fused_voxels": 262144,
                     "capacity": 262144},
        "cams16": {"frame_s": 0.0291234567, "pixels": 2 * NPX},
        "colored": {"frame_s": 0.0191234567, "pixels": NPX},
        "structured": {"frame_s": 0.0131234567, "fused_voxels": 243210,
                       "capacity": 262144, "out_leaf": 0.01953124813,
                       "frames_to_fit": 4,
                       "occupied": {"flagship_scene": 2812345,
                                    "structured_scene": 1234567}},
        "p50": {"p50_raw_ms": 8.123456789, "rtt_ms": 0.0234567,
                "p50_device_ms": 8.1012345678},
        "stream": {"fps_e2e": 38.37123456, "fps_e2e_pipelined": 41.2345678,
                   "p50_latency_ms_e2e": 53.9912345, "codec": "snappy",
                   "efficiency_vs_bound_sync": 0.012345678,
                   "efficiency_vs_bound_pipelined": 0.0123456789},
        "tsdf": {"integrate_ms_mxu_pallas": 16.4161234,
                 "integrate_ms_dense": 12.0741234,
                 "integrate_ms_mxu_pallas_rgb": 21.123456789,
                 "integrate_bitwise_mxu_vs_dense": True,
                 "raycast_prior_ms": 107.5123456, "raycast_full_ms":
                 202.7761234, "track_ms": 345.6789123},
        "roofline": {"rows": rows},
        "cpu_pps": 5734060,
    }


def test_last_line_is_short_and_has_bench_pys_keys():
    """Given full-size results the line is at most 1800 characters, loads
    back with bench.py's top-level keys and metric, and its extras are
    bench.py's keys plus the card; value is the flagship's pixels over its
    seconds per frame."""
    r = _full_size_results()
    line = B.last_line(r)
    assert len(line) <= B.MAX_LINE
    got = json.loads(line)
    assert set(got) == {"metric", "value", "unit", "vs_baseline", "extras"}
    assert got["metric"] == ("stitched points/sec/chip (8cam 848x480, 5 ICP "
                             "iters/pair/frame)")
    assert got["unit"] == "points/s"
    assert got["value"] == round(NPX / r["flagship"]["frame_s"], 0)
    assert got["vs_baseline"] == round(got["value"] / 97_689_600, 3)
    assert set(got["extras"]) == _bench_py_extras() | {"card"}
    assert got["extras"]["fused_voxels_at_capacity"] is True
    assert got["extras"]["tsdf"]["integrate_bitwise_mxu_vs_dense"] is True
    assert set(got["extras"]["roofline"]) == {"ms", "sol_ms", "alg_ms",
                                              "x_alg"}
    assert set(got["extras"]["streaming_4cam"]) == {
        "fps_e2e", "fps_e2e_pipelined", "p50_latency_ms_e2e", "codec",
        "efficiency_vs_bound_sync", "efficiency_vs_bound_pipelined"}
    r["card"] = "x" * 600
    with pytest.raises(ValueError, match="characters"):
        B.last_line(r)


def test_roofline_bounds_at_the_flagship_counts():
    """_row's arithmetic through the one bound(), and the stage counts
    against PERF.md's kernel table: K3 at 8 pairs 3.0e8 operations, 0.0090
    ms; K1 with every one of the frame's 3,256,320 rows read 0.0304 ms."""
    dep = NPX * (2 + R.XYZ_MASK)
    row = R._row("deproject+mask", (0.05, 0.4, 12.0), dep, dep, NPX * 11)
    assert (row["ms"], row["host_ms"], row["launches"]) == (0.05, 0.4, 12.0)
    assert row["sol_ms"] == pytest.approx(dep / 3.35e12 * 1e3, rel=1e-12)
    assert row["alg_by"] == "bytes" and row["alg_ms"] == row["sol_ms"]
    assert row["x_sol"] == pytest.approx(0.05 / row["sol_ms"], rel=1e-12)
    assert row["sol_mb"] == pytest.approx(dep / 1e6)
    alg_b, ops = R.icp_work(7, 5, 2048)
    assert ops == 7 * 5 * 2048 ** 2 * 9
    icp = R._row("icp", (0.1, 9.0, 600.0), 1.0, alg_b, ops)
    f32 = 132 * 128 * 1.98e9
    assert icp["alg_by"] == "operations"
    assert icp["alg_ms"] == pytest.approx(ops / f32 * 1e3, rel=1e-12)
    assert icp["x_alg"] == pytest.approx(0.1 / icp["alg_ms"], rel=1e-12)
    k3_ms, by = C.bound(0, R.icp_work(8, 1, 2048)[1])
    assert by == "operations" and round(k3_ms, 4) == 0.0090
    k1_rows = NPX * (7 * 4 + 1) + 262144 * 7 * 4
    assert round(C.bound(k1_rows, 0)[0], 4) == 0.0304
    assert R.voxel_alg_bytes(NPX, 4, 7, 262144, 1) == (
        NPX * 13 + R.sort_bytes(NPX, 4) + k1_rows + 262144 * 13)
    assert R.sort_bytes(1000, 4) == 4 * 1000 * 12 * 2     # 4 digit passes
    assert R.sort_bytes(1000, 8) == 8 * 1000 * 16 * 2     # int64: 8


def test_scripts_import_no_jax():
    """bench_torch.py, scripts/roofline_torch.py and bench_card.py import
    in a process where jax, __graft_entry__ and the JAX package cannot be
    imported, and no line of theirs imports them; the roofline imports
    the shared helpers and not the bench script."""
    bad = ("jax", "jaxlib", "flax", "pointcloud_stitching_tpu",
           "__graft_entry__")
    paths = [os.path.join(REPO, "bench_torch.py"),
             os.path.join(REPO, "bench_card.py"),
             os.path.join(REPO, "scripts", "roofline_torch.py")]
    for path in paths:
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]):
                    assert words[1].split(".")[0] not in bad, (path, line)
    code = ("import sys\n"
            f"for m in {bad!r}:\n"
            "    sys.modules[m] = None\n"
            "sys.path.insert(0, 'scripts')\n"
            "import roofline_torch\n"
            "assert 'bench_torch' not in sys.modules\n"
            "import bench_card, bench_torch\n"
            "assert roofline_torch.bound is bench_card.bound\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["ok"]


@pytest.mark.parametrize("platform", [None, "cpu"])
def test_bench_refuses_to_run_without_a_gpu(platform):
    """Without a GPU, and under PCS_PLATFORM=cpu, `python bench_torch.py`
    exits non-zero before any row, printing nothing to stdout."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the script would run for real")
    env = {k: v for k, v in os.environ.items() if k != "PCS_PLATFORM"}
    if platform is not None:
        env["PCS_PLATFORM"] = platform
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "bench_torch:" in proc.stderr
    if platform is None:
        assert "PCS_PLATFORM" in proc.stderr
