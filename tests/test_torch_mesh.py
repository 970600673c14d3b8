"""The port's meshers against the JAX package's: organized meshing of
depth frames, the bilateral depth filter, the voxel map's isosurface, and
the mesh CLI's depth-frame and voxel-map inputs.

Both sides get the same numpy inputs; the port's tensors lie on the CPU.
Tolerances: ``organized_mesh`` masks are equal, with every test edge kept
at least 1e-4 (relative) away from the ``max_edge`` threshold, so a fused
multiply-add in XLA's edge length cannot flip a triangle (the port does
not copy XLA's contraction there). ``field_from_map`` is bit for bit
without smoothing (the scatter-max); with the box filter it is within 3e-7
of the [0, 1] occupancy (a few float32 ulps): the port computes each pass
as (lo + f + hi) / 3, as the JAX source writes it, but XLA on the CPU
turns the division into a multiply by 1/3 and contracts one pass's
multiply into the next pass's adds (fused multiply-adds), depending on
how it fuses the program. ``reconstruct_surface`` vertices are within
1e-6 m and its faces equal.
``bilateral_depth`` is within rtol 1e-5 / atol 1e-3 raw depth units
(PyTorch's and XLA's ``exp`` may differ in the last bit). The CLIs print
the same counts and write .ply files of the same size.
"""
import os

import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu import Intrinsics as JIntrinsics
from pointcloud_stitching_tpu.models import voxel_map as JV
from pointcloud_stitching_tpu.ops import bilateral_depth as jax_bilateral
from pointcloud_stitching_tpu.ops import deproject as jax_deproject
from pointcloud_stitching_tpu.ops import mesh as JMesh
from pointcloud_stitching_tpu.ops import surface as JS
from pointcloud_stitching_tpu.utils.types import PointCloud as JPointCloud
from pointcloud_stitching_tpu_torch.io import load_ply, save_cal
from pointcloud_stitching_tpu_torch.ops import bilateral_depth
from pointcloud_stitching_tpu_torch.ops import mesh as TMesh
from pointcloud_stitching_tpu_torch.ops import surface as TS
from pointcloud_stitching_tpu_torch.tools import mesh_cli
from pointcloud_stitching_tpu_torch.utils.convert import voxel_map_from_numpy
from oracle import random_se3, synth_depth_frame
from test_surface import ball_cloud, edge_counts

CPU = torch.device("cpu")
H, W = 48, 64


def _organized(seed=3):
    """A synthetic depth frame deprojected by the JAX package: (xyz [H, W,
    3], mask [H, W]) as numpy."""
    depth = synth_depth_frame(H, W, seed)
    intr = JIntrinsics.d435_default(width=W, height=H)
    pc = jax_deproject(depth, intr, z_min=0.1, z_max=10.0)
    return (np.array(pc.xyz).reshape(H, W, 3),
            np.array(pc.mask).reshape(H, W))


def _edges_off_threshold(xyz, tri, max_edge, rel=1e-4):
    p = xyz.reshape(-1, 3).astype(np.float64)[tri]
    e2 = ((p - np.roll(p, 1, axis=1)) ** 2).sum(-1)
    return np.abs(e2 - max_edge ** 2).min() > rel * max_edge ** 2


@pytest.mark.parametrize("max_edge", [0.05, 0.02])
def test_organized_mesh_matches_jax(max_edge):
    xyz, mask = _organized()
    jt, jok = JMesh.organized_mesh(xyz, mask, max_edge)
    tt, tok = TMesh.organized_mesh(torch.from_numpy(xyz),
                                   torch.from_numpy(mask), max_edge)
    assert tt.dtype == torch.int32 and tok.dtype == torch.bool
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert _edges_off_threshold(xyz, tt.numpy(), max_edge)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < int(tok.sum()) < tok.numel()
    # a 0-d tensor threshold gives the same mask
    _, tok2 = TMesh.organized_mesh(torch.from_numpy(xyz),
                                   torch.from_numpy(mask),
                                   torch.tensor(max_edge))
    assert torch.equal(tok, tok2)


def test_mesh_cloud_arrays_matches_jax():
    xyz, mask = _organized(seed=4)
    jv, jf = JMesh.mesh_cloud_arrays(xyz, mask, max_edge=0.05)
    tv, tf = TMesh.mesh_cloud_arrays(torch.from_numpy(xyz),
                                     torch.from_numpy(mask), max_edge=0.05)
    np.testing.assert_array_equal(tv, np.asarray(jv))
    assert tf.dtype == np.int32
    np.testing.assert_array_equal(tf, np.asarray(jf))


@pytest.mark.parametrize("kind", ["uint16", "float32 batched"])
def test_bilateral_depth_matches_jax(kind):
    rng = np.random.default_rng(731)
    depth = 1000 + rng.normal(0, 8, (2, 14, 18))
    depth[:, 3:5, 6:9] = 0                        # holes
    depth[:, :, 11:] += 900                       # a hard step
    if kind == "uint16":
        depth, kw = depth[0].astype(np.uint16), {}
    else:
        depth = depth.astype(np.float32)
        kw = dict(sigma_spatial=2.0, sigma_range=0.02, radius=3)
    want = np.asarray(jax_bilateral(depth, **kw))
    got = bilateral_depth(torch.from_numpy(depth), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    assert np.all(got.numpy()[..., 3:5, 6:9] == 0)   # holes stay holes


def _ball_maps(leaf=0.05, extra=None):
    """A JAX voxel map of a ball (plus ``extra`` points) and the port's
    copy of it."""
    acc = JV.TemporalAccumulator(capacity=1 << 13, leaf=leaf)
    ball = JPointCloud.from_points(ball_cloud(leaf=leaf))
    acc.update(ball)
    acc.update(ball)
    if extra is not None:
        acc.update(JPointCloud.from_points(np.asarray(extra, np.float32)))
    jm = acc.state
    arrays = {k: np.asarray(getattr(jm, k))
              for k in ("ijk", "sums", "weight", "leaf")}
    return jm, voxel_map_from_numpy(arrays, CPU)


@pytest.mark.parametrize("smooth,saturate,min_weight",
                         [(0, 1.0, 0.0), (1, 1.0, 0.0), (2, 3.0, 1.5)])
def test_field_from_map_matches_jax(smooth, saturate, min_weight):
    jm, tm = _ball_maps(extra=[[0.9, -0.2, 1.0]])
    origin, shape, _ = JS.map_grid_bounds(jm, pad=2)
    want = np.asarray(JS.field_from_map(
        jm.ijk, jm.weight, origin, shape, min_weight=min_weight,
        saturate=saturate, smooth_iters=smooth))
    got = TS.field_from_map(tm.ijk, tm.weight, origin, shape,
                            min_weight=min_weight, saturate=saturate,
                            smooth_iters=smooth)
    assert got.shape == tuple(shape) and got.dtype == torch.float32
    if smooth == 0:
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-7)
    assert 0.0 < want.max() <= 1.0


@pytest.mark.parametrize("pad,max_nodes,min_weight",
                         [(2, 256, 0.0), (1, 12, 0.0), (2, 256, 1.5)])
def test_map_grid_bounds_matches_jax(pad, max_nodes, min_weight):
    jm, tm = _ball_maps(extra=[[1.5, 1.5, 1.5]])
    want = JS.map_grid_bounds(jm, min_weight=min_weight, pad=pad,
                              max_nodes=max_nodes)
    got = TS.map_grid_bounds(tm, min_weight=min_weight, pad=pad,
                             max_nodes=max_nodes)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int32 and got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    with pytest.raises(ValueError, match="no occupied voxels"):
        TS.map_grid_bounds(tm, min_weight=10.0)


@pytest.mark.parametrize("smooth", [0, 1])
def test_reconstruct_surface_matches_jax(smooth):
    jm, tm = _ball_maps()
    jv, jf, jn = JS.reconstruct_surface(jm, smooth_iters=smooth)
    tv, tf, tn = TS.reconstruct_surface(tm, smooth_iters=smooth)
    assert tn == jn > 0
    assert tv.shape == jv.shape and tv.dtype == np.float32
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tf, jf)
    assert np.all(edge_counts(tf) == 2)           # watertight
    with pytest.raises(ValueError, match="active cells"):
        TS.reconstruct_surface(tm, cell_capacity=8)


# ---------------------------------------------------------------------------
# the mesh CLI's depth-frame and voxel-map inputs
# ---------------------------------------------------------------------------

def _run_both(argv_t, argv_j, capsys):
    """Run the port's and the JAX package's CLI in this process; returns
    their last output lines."""
    from pointcloud_stitching_tpu.tools import mesh_cli as jax_cli
    capsys.readouterr()
    n_t = mesh_cli._run(argv_t)
    line_t = capsys.readouterr().out.strip().splitlines()[-1]
    n_j = jax_cli.main(argv_j)
    line_j = capsys.readouterr().out.strip().splitlines()[-1]
    assert n_t == n_j > 0
    return line_t, line_j


@pytest.mark.parametrize("extra", [[], ["--bilateral", "0.03", "--cal",
                                        "CAL", "--max-edge", "0.04"]])
def test_mesh_cli_depth_frame_matches_jax(tmp_path, capsys, monkeypatch,
                                          extra):
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    frames = np.stack([synth_depth_frame(H, W, s) for s in (5, 6)])
    src = str(tmp_path / "depth.npy")
    np.save(src, frames)
    cal = str(tmp_path / "cam0.cal")
    save_cal(cal, random_se3(seed=3, max_angle=0.2, max_trans=0.3))
    extra = [cal if a == "CAL" else a for a in extra]
    out_t, out_j = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    line_t, line_j = _run_both([src, out_t, "--frame", "1"] + extra,
                               [src, out_j, "--frame", "1"] + extra, capsys)
    assert line_t.split(": ", 1)[1] == line_j.split(": ", 1)[1]
    assert os.path.getsize(out_t) == os.path.getsize(out_j)
    vt, _ = load_ply(out_t)
    vj, _ = load_ply(out_j)
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-5)


def test_mesh_cli_voxel_map_matches_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    jm, _ = _ball_maps()
    src = str(tmp_path / "scene.npz")
    JV.save_map(src, jm)
    out_t, out_j = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    argv = ["--smooth", "1", "--iso", "0.4"]
    line_t, line_j = _run_both([src, out_t] + argv, [src, out_j] + argv,
                               capsys)
    assert line_t.split(": ", 1)[1] == line_j.split(": ", 1)[1]
    assert "iso 0.4" in line_t
    assert os.path.getsize(out_t) == os.path.getsize(out_j)
