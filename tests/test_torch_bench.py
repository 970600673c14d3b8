"""scripts/roofline_torch.py on the CPU, with bench_card.py, the helpers
it shares with chip_smoke.py.

The scene builder against __graft_entry__._flagship, the roofline's bound
arithmetic at the flagship's counts, and the scripts' imports.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import __graft_entry__ as graft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import bench_card as C  # noqa: E402
import roofline_torch as R  # noqa: E402

NPX = 8 * 480 * 848          # the flagship's pixels


@pytest.mark.parametrize("ncam", [4, 8, 16])
def test_flagship_is_graft_entrys(ncam, monkeypatch):
    """The numpy scene builder gives __graft_entry__._flagship's arrays
    bit for bit, its intrinsics and its config. __graft_entry__ turns on
    JAX's persistent compile cache for bench.py, which would then hold for
    the rest of the process: it is kept off here."""
    monkeypatch.setattr(graft, "_enable_compile_cache", lambda: None)
    jcfg, jintr, jext, jdepths = graft._flagship(ncam)
    cfg, intr, ext, depths = C._flagship(ncam)
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
    """scripts/roofline_torch.py and bench_card.py import in a process
    where jax, __graft_entry__ and the JAX package cannot be imported, and
    no line of theirs imports them; the roofline takes its bound from the
    shared helpers."""
    bad = ("jax", "jaxlib", "flax", "pointcloud_stitching_tpu",
           "__graft_entry__")
    paths = [os.path.join(REPO, "bench_card.py"),
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
            "import bench_card\n"
            "assert roofline_torch.bound is bench_card.bound\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["ok"]
