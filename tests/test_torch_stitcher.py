"""The port's stitch step and pipeline against the JAX package's.

The slice runs at the size of tests/test_stitcher.py's ``_small_cfg``
(3 cameras of 120x212, ring point-to-plane ICP on) with the JAX side on its
XLA backend and the state carried over by ``utils/convert.py``.
"""
import dataclasses
import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu import Intrinsics as JIntrinsics
from pointcloud_stitching_tpu import PointCloud as JPointCloud
from pointcloud_stitching_tpu.models import StitchingPipeline as JPipeline
from pointcloud_stitching_tpu.models import stitch_points_step as jax_points
from pointcloud_stitching_tpu.models import stitch_step as jax_step
from pointcloud_stitching_tpu.models.stitcher import (
    _compose_ring_corrections as jax_compose, autofit_out_leaf as jax_autofit)
from pointcloud_stitching_tpu.runtime import (
    synthetic_frames as jax_synthetic_frames)
from pointcloud_stitching_tpu.utils.config import StitchConfig as JConfig
import pointcloud_stitching_tpu_torch as P
from pointcloud_stitching_tpu_torch.models.stitcher import (
    _compose_ring_corrections, autofit_out_leaf)
from pointcloud_stitching_tpu_torch.utils.convert import (
    extrinsics_from_numpy, intrinsics_from_numpy)
from oracle import random_se3, synth_depth_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import bench_card  # noqa: E402
NCAM, H, W = 3, 120, 212
# one compiled JAX step shared by every test of this file
_jax_step = jax.jit(jax_step, static_argnums=0)


def _jax_cfg(**kw):
    base = dict(num_cameras=NCAM, height=H, width=W,
                cam_voxel_leaf=0.02, cam_capacity=32768,
                out_voxel_leaf=0.02, out_capacity=65536,
                icp_voxel_leaf=0.04, icp_capacity=4096,
                icp_iterations=3, icp_max_corr_dist=0.3,
                icp_query_tile=256, icp_ref_tile=512, kernel_impl="xla")
    base.update(kw)
    return JConfig(**base)


@functools.lru_cache(maxsize=None)
def _scene():
    depths = np.stack([synth_depth_frame(H, W, seed=s) for s in range(NCAM)])
    i0 = JIntrinsics.create(fx=106.0, fy=106.0, ppx=W / 2, ppy=H / 2,
                            width=W, height=H)
    ji = i0.stack([i0] * (NCAM - 1))
    ext = np.stack([random_se3(seed=10 + i, max_angle=0.1, max_trans=0.2)
                    for i in range(NCAM)]).astype(np.float32)
    return depths, ji, ext


def _port_state(ji, jcfg):
    fields = {k: np.asarray(getattr(ji, k))
              for k in ("fx", "fy", "ppx", "ppy", "coeffs")}
    return (intrinsics_from_numpy(fields, ji.width, ji.height, ji.model),
            P.StitchConfig.from_jax_json(jcfg.to_json()))


def _sorted_cloud(cloud):
    xyz, mask = np.asarray(cloud.xyz), np.asarray(cloud.mask)
    return np.sort(xyz[mask], axis=0)


def test_stitch_step_matches_jax():
    """The whole step at the small config, ICP on.

    The refined extrinsics agree within 1e-4 (they differ at ~1e-7: the
    summation orders differ, and the JAX XLA NN measures |q|^2+|r|^2-2qr).
    A 1e-7 shift can move a point across a voxel boundary, so the output
    cloud is held against JAX given the same extrinsics: the port's step
    with ICP off, fed JAX's refined extrinsics, must give JAX's cloud.
    """
    depths, ji, ext = _scene()
    jcfg = _jax_cfg()
    want = _jax_step(jcfg, ji, jnp.asarray(ext), jnp.asarray(depths))
    pi, pcfg = _port_state(ji, jcfg)
    got = P.stitch_step(pcfg, pi, extrinsics_from_numpy(ext),
                        torch.from_numpy(depths))
    assert int(got.metrics.points_in) == int(want.metrics.points_in)
    np.testing.assert_allclose(got.extrinsics.numpy(),
                               np.asarray(want.extrinsics), atol=1e-4)
    np.testing.assert_allclose(got.metrics.icp_mean_error.numpy(),
                               np.asarray(want.metrics.icp_mean_error),
                               rtol=0.05)
    assert np.abs(got.metrics.icp_inliers.numpy()
                  - np.asarray(want.metrics.icp_inliers)).max() <= 0.02 * \
        np.asarray(want.metrics.icp_inliers).max()
    assert float(got.metrics.loop_error) == pytest.approx(
        float(want.metrics.loop_error), rel=0.05, abs=1e-9)

    tail = P.stitch_step(dataclasses.replace(pcfg, icp_enabled=False), pi,
                         extrinsics_from_numpy(np.asarray(want.extrinsics)),
                         torch.from_numpy(depths))
    assert int(tail.metrics.points_out) == int(want.metrics.points_out)
    np.testing.assert_allclose(_sorted_cloud(tail.cloud),
                               _sorted_cloud(want.cloud), atol=1e-4)


@pytest.mark.parametrize("mode", ["anchored", "track", "ema"])
def test_pipeline_update_modes_match_jax(mode):
    """Two frames of a static scene. (On some changed frames this small
    ICP problem is ill-conditioned enough that JAX itself turns a 2e-7
    change of its starting extrinsics into a 7e-4 change of the result.)"""
    depths, ji, ext = _scene()
    jcfg = _jax_cfg()
    jpipe = JPipeline(jcfg, ji, jnp.asarray(ext), update_mode=mode,
                      ema_alpha=0.3)
    jpipe._step = functools.partial(_jax_step, jcfg)
    pi, pcfg = _port_state(ji, jcfg)
    ppipe = P.StitchingPipeline(pcfg, pi, ext, device="cpu",
                                update_mode=mode, ema_alpha=0.3)
    for _ in range(2):
        want = jpipe(jnp.asarray(depths))
        got = ppipe(torch.from_numpy(depths))
        assert int(got.metrics.points_in) == int(want.metrics.points_in)
        np.testing.assert_allclose(got.extrinsics.numpy(),
                                   np.asarray(want.extrinsics), atol=1e-4)
        np.testing.assert_allclose(ppipe.extrinsics.numpy(),
                                   np.asarray(jpipe.extrinsics), atol=1e-4)
    if mode == "anchored":
        np.testing.assert_array_equal(ppipe.extrinsics.numpy(), ext)


def test_stitch_points_step_and_normals_output_match_jax():
    """The legacy points payload, and the with_normals output (normals
    quantised into rgb so the global pass takes the packed branch) with a
    decimated depth grid; ICP off so both sides see equal extrinsics."""
    depths, ji, ext = _scene()
    jcfg = _jax_cfg(icp_enabled=False)
    pi, pcfg = _port_state(ji, jcfg)
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-1, 1, (NCAM, 3000, 3)).astype(np.float32)
    mask = rng.random((NCAM, 3000)) > 0.1
    cam_mask = np.array([True, False, True])
    want = jax_points(jcfg, jnp.asarray(ext),
                      JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)),
                      jnp.asarray(cam_mask))
    got = P.stitch_points_step(pcfg, extrinsics_from_numpy(ext),
                               P.PointCloud(xyz=torch.from_numpy(xyz),
                                            mask=torch.from_numpy(mask)),
                               torch.from_numpy(cam_mask))
    assert int(got.metrics.points_in) == int(want.metrics.points_in)
    assert int(got.metrics.points_out) == int(want.metrics.points_out)
    np.testing.assert_allclose(_sorted_cloud(got.cloud),
                               _sorted_cloud(want.cloud), atol=1e-4)

    jcfg = _jax_cfg(icp_enabled=False, with_normals=True, decimation=2)
    pi, pcfg = _port_state(ji, jcfg)
    want = jax_step(jcfg, ji, jnp.asarray(ext), jnp.asarray(depths))
    got = P.stitch_step(pcfg, pi, extrinsics_from_numpy(ext),
                        torch.from_numpy(depths))
    np.testing.assert_array_equal(got.cloud.mask.numpy(),
                                  np.asarray(want.cloud.mask))
    np.testing.assert_allclose(got.cloud.xyz.numpy(),
                               np.asarray(want.cloud.xyz), atol=1e-5)
    np.testing.assert_allclose(got.cloud.rgb.numpy(),
                               np.asarray(want.cloud.rgb), atol=1e-4)


@pytest.mark.parametrize("closure,gate,gate_rot", [
    (False, float("inf"), float("inf")), (True, float("inf"), float("inf")),
    (True, 0.25, 0.26), (True, 1e-4, 0.26), (True, 0.25, 1e-5)])
def test_compose_ring_corrections_matches_jax(closure, gate, gate_rot):
    rng = np.random.default_rng(21)
    deltas = np.stack([random_se3(seed=int(s), max_angle=0.02, max_trans=0.02)
                       for s in rng.integers(0, 10_000, 5)])
    wc, wl = jax_compose(jnp.asarray(deltas), closure, gate, gate_rot)
    gc, gl = _compose_ring_corrections(torch.from_numpy(deltas), closure,
                                       gate, gate_rot)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-6)
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-4, atol=1e-9)


def test_autofit_out_leaf_matches_jax():
    kw = dict(capacity=1000, floor=0.01, ceil=0.08)
    for pts, leaf in [(1000, 0.01), (1000, 0.07), (400, 0.03), (800, 0.02),
                      (10, 0.01), (5000, 0.079)]:
        want = jax_autofit(jnp.int32(pts), jnp.float32(leaf), **kw)
        got = autofit_out_leaf(torch.tensor(pts), leaf, **kw)
        assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_pipeline_autofit_grows_a_saturated_leaf():
    depths, ji, ext = _scene()
    jcfg = _jax_cfg(icp_enabled=False, out_capacity=500,
                    out_leaf_autofit=True)
    pi, pcfg = _port_state(ji, jcfg)
    pipe = P.StitchingPipeline(pcfg, pi, ext, device="cpu")
    leaves = []
    for _ in range(3):
        out = pipe(torch.from_numpy(depths))
        assert int(out.metrics.points_out) == 500
        leaves.append(float(pipe.out_leaf))
    np.testing.assert_allclose(leaves, [0.025, 0.03125, 0.0390625],
                               rtol=1e-6)


def test_pipeline_autofit_trajectory_matches_jax():
    """bench.py's structured scene (``synthetic_frames`` at the flagship's
    extrinsics, 2 cameras of 60x106, ring ICP on) into a 2048-slot grid,
    which saturates at 1 cm: over 12 frames the pipeline's output leaf
    grows as JAX's stitch step and controller grow it on the same inputs,
    and the scene first fits at the same frame, after the leaf has grown."""
    ncam, h, w, cap, frames = 2, 60, 106, 2048, 12
    fields = {**bench_card.flagship_fields(ncam, h, w), "out_capacity": cap,
              "out_leaf_autofit": True, "out_leaf_max": 0.04}
    _, intr, ext, _ = bench_card._flagship(ncam, h, w)
    sd = np.stack([jax_synthetic_frames(1, h, w, seed=s)[0]
                   for s in range(ncam)])
    jcfg = JConfig(**fields, kernel_impl="xla")
    i0 = JIntrinsics.create(fx=bench_card.FX, fy=bench_card.FY, ppx=w / 2.0,
                            ppy=h / 2.0, width=w, height=h)
    ji = i0.stack([i0] * (ncam - 1))
    jleaf = jnp.float32(jcfg.out_voxel_leaf)
    pipe = P.StitchingPipeline(P.StitchConfig(**fields), intr, ext,
                               device="cpu")
    want, got = [], []
    for _ in range(frames):
        jout = _jax_step(jcfg, ji, jnp.asarray(ext), jnp.asarray(sd),
                         out_leaf=jleaf)
        jleaf = jax_autofit(jout.metrics.points_out, jleaf, capacity=cap,
                            floor=jcfg.out_voxel_leaf, ceil=0.04)
        out = pipe(torch.from_numpy(sd))
        want.append((float(jleaf), int(jout.metrics.points_out) < cap))
        got.append((float(pipe.out_leaf), int(out.metrics.points_out) < cap))
    np.testing.assert_allclose([g[0] for g in got], [v[0] for v in want],
                               rtol=1e-6)
    fits = [v[1] for v in want]
    assert [g[1] for g in got] == fits
    assert 2 < fits.index(True) + 1 < frames     # the leaf grew first


def test_stitch_step_refuses_colour():
    """Colour and normals both ride the rgb channel: a step asked for both
    refuses the colour."""
    depths, ji, ext = _scene()
    pi, pcfg = _port_state(ji, _jax_cfg(with_normals=True))
    with pytest.raises(ValueError, match="rgb channel"):
        P.stitch_step(pcfg, pi, extrinsics_from_numpy(ext),
                      torch.from_numpy(depths),
                      colors=torch.zeros((NCAM, H, W, 3), dtype=torch.uint8))


def test_stitch_step_takes_the_reference_positional_order():
    """(cfg, intr, extrinsics, depths, colors, cam_mask, color_intr,
    color_ext, out_leaf), as the JAX package's stitch_step."""
    import inspect
    assert list(inspect.signature(P.stitch_step).parameters) == list(
        inspect.signature(jax_step).parameters)
    depths, ji, ext = _scene()
    pi, pcfg = _port_state(ji, _jax_cfg(icp_enabled=False,
                                        out_leaf_autofit=True))
    leaf = torch.tensor(0.05)
    mask = torch.tensor([True, False, True])
    pos = P.stitch_step(pcfg, pi, extrinsics_from_numpy(ext),
                        torch.from_numpy(depths), None, mask, None, None,
                        leaf)
    kw = P.stitch_step(pcfg, pi, extrinsics_from_numpy(ext),
                       torch.from_numpy(depths), cam_mask=mask,
                       out_leaf=leaf)
    ref = P.stitch_step(pcfg, pi, extrinsics_from_numpy(ext),
                        torch.from_numpy(depths), cam_mask=mask)
    assert torch.equal(pos.cloud.xyz, kw.cloud.xyz)
    assert int(pos.metrics.points_out) < int(ref.metrics.points_out)


def test_port_imports_no_jax():
    """The port must run where JAX is not installed: neither the package
    nor chip_smoke.py imports jax, flax or the JAX package. Every module of
    the port (runtime, native codecs, metrics, the calibration tools, the
    analysis ops, the publisher, the viewer and profiling included) and
    chip_smoke.py import in a process where importing any of
    those, or cv2 (which neither machine has), fails."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|"
                     r"pointcloud_stitching_tpu)\b")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f)
        for d, _, fs in os.walk(os.path.join(REPO,
                                             "pointcloud_stitching_tpu_torch"))
        for f in fs if f.endswith(".py")]
    assert len(files) > 30
    for path in files:
        with open(path) as fh:
            for line in fh:
                assert not bad.match(line), (path, line)
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "pointcloud_stitching_tpu", "cv2"):
    sys.modules[name] = None   # any import of these raises ImportError
import pointcloud_stitching_tpu_torch as P
names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in
            ("jax", "jaxlib", "flax") and sys.modules[m] is not None]
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = int(proc.stdout.split()[-1])
    assert names > 35
    for mod in ("runtime.client", "runtime.stitch_cli", "runtime.wire",
                "native.snappy", "native.lzf", "utils.metrics", "ops.fpfh",
                "ops.gicp", "ops.ndt", "models.pose_graph", "tools.graph_cli",
                "tools.pick_cli", "ops.sac", "ops.cluster", "ops.hull",
                "tools.segment_cli", "runtime.publisher", "runtime.view_cli",
                "utils.profiling"):
        assert os.path.exists(os.path.join(
            REPO, "pointcloud_stitching_tpu_torch",
            *mod.split(".")) + ".py"), mod


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the script would run for real")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
