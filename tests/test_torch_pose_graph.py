"""The port's multi-camera calibration tools against the JAX package's.

Covers ``models/pose_graph.py`` (the Gauss-Newton solve, the BFS
initialisation, ``register_rig``), ``tools/graph_cli.py`` in both modes,
the copied ``io/picker.py`` and ``io/render.py``, and ``tools/pick_cli.py``
feeding ``tools/register_cli.py``. JAX runs on the CPU as the rest of the
suite runs it. Inputs are made with numpy from a generator per test (the
graph helpers of tests/test_pose_graph.py take their seeds) and cross as
numpy arrays; the CLIs run in-process with ``PCS_PLATFORM=cpu``.
"""
import numpy as np
import pytest
import torch

import pointcloud_stitching_tpu.io.picker as JPK
import pointcloud_stitching_tpu.io.render as JRN
from pointcloud_stitching_tpu import PointCloud as JPointCloud
from pointcloud_stitching_tpu.io import load_cal as jax_load_cal
from pointcloud_stitching_tpu.models import (
    chain_initial_poses as jax_chain_initial_poses)
from pointcloud_stitching_tpu.models import (
    optimize_pose_graph as jax_optimize_pose_graph)
from pointcloud_stitching_tpu.models import register_rig as jax_register_rig
from pointcloud_stitching_tpu.tools import graph_cli as jax_graph_cli
from pointcloud_stitching_tpu.tools import pick_cli as jax_pick_cli
from pointcloud_stitching_tpu_torch import PointCloud
import pointcloud_stitching_tpu_torch.io.picker as PPK
import pointcloud_stitching_tpu_torch.io.render as PRN
from pointcloud_stitching_tpu_torch.io import load_cal, save_cal, save_ply
from pointcloud_stitching_tpu_torch.models import (chain_initial_poses,
                                                   optimize_pose_graph,
                                                   register_rig)
from pointcloud_stitching_tpu_torch.tools import (graph_cli, pick_cli,
                                                  register_cli)
from oracle import random_se3, transform_np
from test_pose_graph import _make_graph, _perturb, _pose_err


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# --- the pose-graph solve ----------------------------------------------------

def _noisy(meas, seed):
    rng = np.random.default_rng(seed)
    return np.stack([m @ random_se3(seed=int(rng.integers(1 << 30)),
                                    max_angle=0.02, max_trans=0.02)
                     for m in meas]).astype(np.float32)


@pytest.mark.parametrize("case", ["ring", "anchor_weights", "disconnected"])
def test_optimize_pose_graph_matches_jax(case):
    """Poses and residual norms equal to JAX within 1e-5 (the port solves
    in float64 and rounds once, JAX in float32); the anchor exactly
    fixed; a node no edge reaches keeps its pose."""
    gt, edges, meas = _make_graph(6, extra_chords=[(0, 3), (1, 4)])
    meas = _noisy(meas, 80)
    init = _perturb(gt, dt=0.05, dr=0.05, seed=81)
    kw, weights = dict(iterations=10), None
    if case == "anchor_weights":
        kw["anchor"] = 2
        weights = np.random.default_rng(82).uniform(0.1, 3.0, len(edges)
                                                    ).astype(np.float32)
    elif case == "disconnected":
        init = np.concatenate([init, random_se3(seed=83)[None]])
    want = jax_optimize_pose_graph(
        init, edges, meas, weights=weights, **kw)
    got = optimize_pose_graph(t(init), t(edges), t(meas),
                              weights=None if weights is None else t(weights),
                              **kw)
    np.testing.assert_allclose(n(got.poses), n(want.poses), atol=1e-5)
    np.testing.assert_allclose(n(got.residual_before),
                               n(want.residual_before), atol=1e-5)
    np.testing.assert_allclose(n(got.residual_after), n(want.residual_after),
                               atol=1e-5)
    assert int(got.iterations) == 10 and got.poses.dtype == torch.float32
    a = kw.get("anchor", 0)
    assert torch.equal(got.poses[a], t(init[a]))
    if case == "disconnected":
        np.testing.assert_allclose(n(got.poses)[6], init[6], atol=1e-6)
    assert float(got.residual_after.mean()) < float(
        got.residual_before.mean())


def test_chain_initial_poses_matches_jax():
    """BFS over forward and reverse edges, bit for bit (both numpy);
    unreached nodes get identity; the result lands on T_meas's device."""
    gt, _, _ = _make_graph(5, seed=3)
    edges = [(0, 1), (2, 1), (3, 2)]
    meas = np.stack([np.linalg.inv(gt[i]) @ gt[j] for i, j in edges]
                    ).astype(np.float32)
    want = jax_chain_initial_poses(5, edges, meas)
    for m in (meas, t(meas)):
        got = chain_initial_poses(5, edges, m)
        assert torch.equal(got, t(want))
    np.testing.assert_array_equal(n(got)[4], np.eye(4))


def _rig(seed, ncam=4, npts=2500):
    """A scene seen by ``ncam`` cameras, each cloud a subset in its own
    sensor frame, and initial poses 3 cm / 0.03 rad off."""
    rng = np.random.default_rng(seed)
    scene = rng.uniform(-1.5, 1.5, (4000, 3)).astype(np.float32)
    gt = np.stack([np.eye(4, dtype=np.float32)]
                  + [random_se3(seed=seed + k, max_angle=0.3, max_trans=0.5)
                     for k in range(1, ncam)])
    clouds = []
    for k in range(ncam):
        sub = scene[rng.permutation(len(scene))[:npts]]
        inv = np.linalg.inv(gt[k])
        clouds.append((sub @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32))
    init = _perturb(gt, dt=0.03, dr=0.03, seed=seed + 17)
    init[0] = gt[0]
    return np.stack(clouds), gt, init


def test_register_rig_matches_jax():
    """Batched edge ICP + joint solve: both recover the rig within 5 mm /
    5e-3, and agree with each other within 1e-4 (JAX's CPU NN rounds its
    distances through |q|^2+|r|^2-2qr, the port's takes differences)."""
    clouds, gt, init = _rig(90)
    mask = np.ones(clouds.shape[:2], bool)
    mask[:, -100:] = False
    edges = np.asarray([(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)], np.int32)
    kw = dict(icp_iterations=15, gn_iterations=8, max_corr_dist=0.3)
    want = jax_register_rig(JPointCloud(xyz=clouds, mask=mask), edges, init,
                            **kw)
    got = register_rig(PointCloud(xyz=t(clouds), mask=t(mask)), t(edges),
                       t(init), **kw)
    np.testing.assert_allclose(n(got.poses), n(want.poses), atol=1e-4)
    dt, dr = _pose_err(n(got.poses), gt)
    assert dt < 5e-3 and dr < 5e-3
    assert torch.equal(got.poses[0], t(init[0]))


# --- graph_cli ---------------------------------------------------------------

def _write_pair_cals(tmp_path, edges, meas, weights=None):
    lines = []
    for k, (i, j) in enumerate(edges):
        p = tmp_path / f"pair_{k}.cal"
        save_cal(str(p), meas[k])
        w = "" if weights is None else f" {weights[k]}"
        lines.append(f"{i} {j} {p}{w}")
    edges_file = tmp_path / "edges.txt"
    edges_file.write_text("# rig\n" + "\n".join(lines) + "\n")
    return edges_file


def _run_both_graph_clis(tmp_path, args, ncam):
    out = {}
    for name, cli in (("jax", jax_graph_cli), ("port", graph_cli)):
        d = tmp_path / f"out_{name}"
        assert cli.main([*args[:1], str(d), *args[1:]]) == 0
        out[name] = np.stack([(jax_load_cal if name == "jax" else load_cal)(
            str(d / f"cam_{k}.cal")) for k in range(ncam)])
    return out["port"], out["jax"]


def test_graph_cli_matches_jax_cal_mode(tmp_path, monkeypatch, capsys):
    """Pairwise .cal measurements (noisy, weighted), BFS-chained start:
    the port's refined .cal files equal the JAX CLI's within 1e-5."""
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    gt, edges, meas = _make_graph(5, extra_chords=[(0, 2)], seed=4)
    meas = _noisy(meas, 84)
    weights = np.random.default_rng(85).uniform(0.5, 2.0, len(edges))
    edges_file = _write_pair_cals(tmp_path, edges, meas,
                                  [f"{w:.3f}" for w in weights])
    got, want = _run_both_graph_clis(
        tmp_path, [str(edges_file), "--iterations", "8", "--anchor", "1"], 5)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert "pose graph: 5 cameras, 6 measurements" in capsys.readouterr().out


def test_graph_cli_matches_jax_ply_mode(tmp_path, monkeypatch):
    """--ply-dir with --voxel: the measurements come from one batched ICP
    over every edge; both CLIs agree within 1e-4 and recover most of the
    initial error (the bound of tests/test_pose_graph.py: the cameras see
    different random samples of the scene, so no pair matches exactly)."""
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    clouds, gt, init = _rig(91, ncam=3, npts=2000)
    ply_dir, init_dir = tmp_path / "clouds", tmp_path / "init"
    ply_dir.mkdir()
    init_dir.mkdir()
    for k in range(3):
        save_ply(str(ply_dir / f"cam_{k}.ply"), clouds[k])
        save_cal(str(init_dir / f"cam_{k}.cal"), init[k])
    edges_file = tmp_path / "edges.txt"
    edges_file.write_text("0 1\n1 2\n2 0\n")
    got, want = _run_both_graph_clis(
        tmp_path, [str(edges_file), "--ply-dir", str(ply_dir), "--init-dir",
                   str(init_dir), "--icp-iter", "15", "--iterations", "8",
                   "--voxel", "0.02"], 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    dt, dr = _pose_err(got, gt)
    assert dt < 0.3 * _pose_err(init, gt)[0] and dr < 5e-3


# --- picker, renderer, pick_cli ----------------------------------------------

def test_picker_and_render_match_jax(tmp_path):
    """The numpy copies equal the JAX package's functions bit for bit."""
    rng = np.random.default_rng(86)
    xyz = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (3000, 3)).astype(np.float32)
    for axis in ("x", "z"):
        b = PPK.projection_bounds(xyz, axis)
        jb = JPK.projection_bounds(xyz, axis)
        np.testing.assert_array_equal(b[0], jb[0])
        assert b[1] == jb[1]
        np.testing.assert_array_equal(PPK.project_pixels(xyz, axis, 256, b),
                                      JPK.project_pixels(xyz, axis, 256, jb))
        for colour in (None, rgb):
            img, idx = PPK.render_indexed(xyz, colour, axis=axis, size=256)
            jimg, jidx = JPK.render_indexed(xyz, colour, axis=axis, size=256)
            np.testing.assert_array_equal(img, jimg)
            np.testing.assert_array_equal(idx, jidx)
            np.testing.assert_array_equal(
                PRN.render_orthographic(xyz, colour, axis=axis, size=200),
                JRN.render_orthographic(xyz, colour, axis=axis, size=200))
    for u, v in ((5, 5), (128, 100), (255, 0)):
        assert PPK.pick_index(idx, u, v, 4) == JPK.pick_index(jidx, u, v, 4)
    np.testing.assert_array_equal(
        PRN.render_view(xyz, rgb, 30.0, 20.0, size=128, shade_normals=True),
        JRN.render_view(xyz, rgb, 30.0, 20.0, size=128, shade_normals=True))
    PPK.save_picks(str(tmp_path / "p.txt"), [(1, 2), (30, 40)])
    JPK.save_picks(str(tmp_path / "j.txt"), [(1, 2), (30, 40)])
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    PRN.save_image(str(tmp_path / "p.ppm"), img)
    JRN.save_image(str(tmp_path / "j.ppm"), img)
    assert (tmp_path / "p.ppm").read_bytes() == \
        (tmp_path / "j.ppm").read_bytes()
    pc = PointCloud.from_points(xyz[:100], rgb=rgb[:100], capacity=128)
    PRN.render_cloud(pc, str(tmp_path / "c.ppm"), size=64)
    JRN.render_cloud(JPointCloud.from_points(xyz[:100], rgb=rgb[:100],
                                             capacity=128),
                     str(tmp_path / "cj.ppm"), size=64)
    assert (tmp_path / "c.ppm").read_bytes() == \
        (tmp_path / "cj.ppm").read_bytes()


def test_pick_cli_to_register_cli_end_to_end(tmp_path, monkeypatch):
    """Render -> pick pixel pairs -> picks file -> register_cli --picks ->
    .cal: the port's picks file equals the JAX CLI's, and its .cal matches
    the true transform within 5e-3 and the JAX CLI's within 1e-5."""
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    rng = np.random.default_rng(87)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    landmarks = np.array([[-0.9, -0.9, -3.0], [0.9, -0.85, -3.0],
                          [-0.85, 0.9, -3.0], [0.8, 0.85, -3.0]], np.float32)
    src = np.concatenate([pts, landmarks])
    T_true = random_se3(seed=11, max_angle=0.1, max_trans=0.5)
    dst = transform_np(T_true, src).astype(np.float32)
    sp, dp = str(tmp_path / "src.ply"), str(tmp_path / "dst.ply")
    save_ply(sp, src)
    save_ply(dp, dst)
    size = 512
    lm = np.arange(len(pts), len(src))
    spx = PPK.project_pixels(src[lm], "z", size, PPK.projection_bounds(src))
    dpx = PPK.project_pixels(dst[lm], "z", size, PPK.projection_bounds(dst))
    pairs = " ".join(f"{su},{sv}:{tu},{tv}"
                     for (su, sv), (tu, tv) in zip(spx, dpx))
    args = ["--size", str(size), "--pairs", pairs, "--radius", "2"]
    picks, jpicks = str(tmp_path / "picks.txt"), str(tmp_path / "jp.txt")
    assert pick_cli.main([sp, dp, picks, *args, "--render-dir",
                          str(tmp_path / "views")]) == 0
    assert jax_pick_cli.main([sp, dp, jpicks, *args]) == 0
    got = np.loadtxt(picks, dtype=np.int64).reshape(-1, 2)
    np.testing.assert_array_equal(got, np.loadtxt(jpicks, dtype=np.int64
                                                  ).reshape(-1, 2))
    assert len(got) >= 3
    assert (tmp_path / "views" / "source.ppm").exists() or \
        (tmp_path / "views" / "source.png").exists()
    out = str(tmp_path / "pair.cal")
    register_cli.main([sp, dp, out, "--picks", picks,
                       "--max-corr-dist", "1.0"])
    T = load_cal(out)
    np.testing.assert_allclose(T, T_true, atol=5e-3)
