"""The port's extra registration methods against the JAX package's.

Covers ``ops/gicp.py``, ``ops/ndt.py`` (and ``utils/convert.py``'s NDT
map), the FPFH-seeded starts of ``models/registration.py`` and the
register CLI's ``--gicp`` and ``--fpfh-starts``. JAX runs on the CPU as
the rest of the suite runs it; where its GICP reaches the NN it runs its
Pallas kernel in interpret mode (the direct-difference distances the
port's K3 computes), patched into the module in the test. Inputs are made
with numpy from a generator per test and cross as numpy arrays.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu import PointCloud as JPointCloud
import pointcloud_stitching_tpu.ops as J
from pointcloud_stitching_tpu.io import load_cal as jax_load_cal
from pointcloud_stitching_tpu.models import registration as JR
from pointcloud_stitching_tpu.ops.gicp import gicp as jax_gicp
from pointcloud_stitching_tpu.ops.ndt import ndt_align as jax_ndt_align
from pointcloud_stitching_tpu.ops.ndt import ndt_build as jax_ndt_build
from pointcloud_stitching_tpu.ops.nn import nearest_neighbors as jax_nn
from pointcloud_stitching_tpu.tools import register_cli as jax_register_cli
from pointcloud_stitching_tpu_torch import PointCloud
import pointcloud_stitching_tpu_torch.ops as P
from pointcloud_stitching_tpu_torch.io import load_cal, save_ply
from pointcloud_stitching_tpu_torch.models import registration as PR
from pointcloud_stitching_tpu_torch.ops.se3 import so3_exp
from pointcloud_stitching_tpu_torch.tools import register_cli
from pointcloud_stitching_tpu_torch.utils.convert import ndt_map_from_numpy
from oracle import random_se3, transform_np
from test_fpfh import _bumpy_surface
from test_gicp import _corner

QT = RB = 128  # the JAX Pallas tests' tile sizes (tests/test_nn_pallas.py)


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _clouds(xyz, mask=None):
    mask = np.ones(len(xyz), bool) if mask is None else mask
    return (JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)),
            PointCloud(xyz=t(xyz), mask=t(mask)))


def _max_point_err(T_got, T_true, xyz):
    return float(np.linalg.norm(transform_np(n(T_got), xyz)
                                - transform_np(np.asarray(T_true), xyz),
                                axis=-1).max())


# --- GICP --------------------------------------------------------------------

@pytest.fixture
def jax_gicp_direct_nn(monkeypatch):
    """JAX's ``gicp`` on the NN of its own Pallas kernel (interpret mode,
    128-wide tiles), jitted afresh so the substituted NN is traced.

    Off the TPU the JAX function takes the XLA NN, whose |q|^2+|r|^2-2qr
    form rounds d2; the port's K3 (and its plain version) computes direct
    differences, as the Pallas kernel does."""
    mod = sys.modules["pointcloud_stitching_tpu.ops.gicp"]

    def direct(q, r, m, query_tile, ref_tile, impl):
        return jax_nn(q, r, m, query_tile=QT, ref_tile=RB, impl="pallas",
                      interpret=True)

    monkeypatch.setattr(mod, "nearest_neighbors", direct)
    return jax.jit(jax_gicp.__wrapped__,
                   static_argnames=("max_iterations", "trim_fraction"))


def test_gicp_covariances_match_jax():
    rng = np.random.default_rng(70)
    nrm = rng.normal(size=(64, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    valid = rng.random(64) > 0.2
    want = J.gicp_covariances(jnp.asarray(nrm), jnp.asarray(valid), 1e-3)
    got = P.gicp_covariances(t(nrm), t(valid), 1e-3)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-7)
    assert torch.equal(got[~t(valid)], torch.eye(3).expand(
        int((~valid).sum()), 3, 3))


@pytest.mark.parametrize("scene", ["bumpy", "corner"])
def test_gicp_matches_jax(jax_gicp_direct_nn, scene):
    """T within 1e-5, iterations and inliers equal. The corner scene is
    the same three planes sampled at half-step phases (no point-to-point
    correspondence better than half a step), 10% trimming."""
    if scene == "bumpy":
        xyz, _ = _bumpy_surface(seed=11, n=600)
        T_true = random_se3(seed=3, max_angle=0.3, max_trans=0.1)
        dst_xyz = transform_np(T_true, xyz).astype(np.float32)
        radius, kw = 0.15, dict(max_corr_dist=0.5, max_iterations=50)
    else:
        xyz = _corner(step=0.02, phase=(0.0, 0.0, 0.0))
        T_true = random_se3(seed=7, max_angle=0.15, max_trans=0.05)
        dst_xyz = transform_np(T_true, _corner(
            step=0.02, phase=(0.5, 0.5, 0.5))).astype(np.float32)
        radius, kw = 0.062, dict(max_corr_dist=0.2, max_iterations=60,
                                 trim_fraction=0.1)
    js, ps = _clouds(xyz)
    jd, pd = _clouds(dst_xyz)
    ns, oks = J.estimate_normals(js, radius)
    nd, okd = J.estimate_normals(jd, radius)
    want = jax_gicp_direct_nn(js, jd, ns, nd, oks, okd, **kw)
    got = P.gicp(ps, pd, t(ns), t(nd), t(oks), t(okd), **kw)
    np.testing.assert_allclose(n(got.T), n(want.T), atol=1e-5)
    assert int(got.iterations) == int(want.iterations)
    assert int(got.num_inliers) == int(want.num_inliers)
    np.testing.assert_allclose(float(got.mean_error), float(want.mean_error),
                               rtol=1e-3, atol=1e-12)
    assert _max_point_err(got.T, T_true, xyz[:200]) < 6e-3


def test_gicp_starved_returns_identity():
    xyz, _ = _bumpy_surface(seed=13, n=64)
    src = PointCloud(xyz=t(xyz), mask=torch.zeros(64, dtype=torch.bool))
    ns = torch.zeros((64, 3))
    res = P.gicp(src, PointCloud.from_points(xyz), ns, ns,
                 max_iterations=10)
    assert torch.equal(res.T, torch.eye(4))
    assert int(res.num_inliers) == 0 and int(res.iterations) == 1


# --- NDT ---------------------------------------------------------------------

def _ndt_scene(seed, offset=0.0):
    xyz, _ = _bumpy_surface(seed=seed, n=700)
    xyz = (xyz + np.float32(offset)).astype(np.float32)
    mask = np.random.default_rng(seed).random(700) > 0.05
    T = random_se3(seed=seed + 1, max_angle=0.05, max_trans=0.05)
    c = xyz.mean(0)
    # the motion about the cloud's centre, so the offset scene moves alike
    Tc = np.eye(4, dtype=np.float32)
    Tc[:3, 3] = c
    T = (Tc @ T @ np.linalg.inv(Tc)).astype(np.float32)
    src = transform_np(np.linalg.inv(T), xyz).astype(np.float32)
    return xyz, mask, src, T


@pytest.mark.parametrize("offset", [0.0, 40.0])
def test_ndt_build_matches_jax(offset):
    """Cell keys, validity, base and extents equal; means within 1e-5 m
    (2 ulp at 40 m); inverse covariances within 1e-3 relative to their
    largest entry (eigh of nearly planar cells)."""
    xyz, mask, _, _ = _ndt_scene(71, offset)
    jd, pd = _clouds(xyz, mask)
    want = jax_ndt_build(jd, 0.2, min_points=6)
    got = P.ndt_build(pd, 0.2, min_points=6)
    for f in ("keys", "valid", "base", "dims"):
        np.testing.assert_array_equal(n(getattr(got, f)), n(getattr(want, f)))
    v = n(want.valid)
    assert v.sum() > 10
    atol = max(1e-5, 2 * float(np.spacing(np.float32(offset + 1.0))))
    np.testing.assert_allclose(n(got.mu)[v], n(want.mu)[v], atol=atol)
    wi = n(want.inv_cov)[v]
    scale = np.abs(wi).max(axis=(1, 2))[:, None, None]
    np.testing.assert_allclose(n(got.inv_cov)[v] / scale, wi / scale,
                               atol=1e-3)


@pytest.mark.parametrize("map_from", ["port", "jax"])
def test_ndt_align_matches_jax(map_from):
    """T within 1e-5, iterations and inliers equal, on the port's own map
    and on the JAX package's map carried over by ``ndt_map_from_numpy``."""
    xyz, mask, src, T_true = _ndt_scene(72)
    jd, pd = _clouds(xyz, mask)
    js, ps = _clouds(src, mask)
    jm = jax_ndt_build(jd, 0.2)
    pm = (P.ndt_build(pd, 0.2) if map_from == "port" else
          ndt_map_from_numpy({f: np.asarray(getattr(jm, f))
                              for f in jm._fields}, "cpu"))
    want = jax_ndt_align(js, jm)
    got = P.ndt_align(ps, pm)
    np.testing.assert_allclose(n(got.T), n(want.T), atol=1e-5)
    assert int(got.iterations) == int(want.iterations)
    assert int(got.num_inliers) == int(want.num_inliers)
    # NDT's own accuracy on this sparse surface (700 points in 0.2 m cells)
    assert _max_point_err(got.T, T_true, src[:200]) < 0.01


def test_ndt_one_shot_matches_jax():
    xyz, mask, src, _ = _ndt_scene(73)
    jd, pd = _clouds(xyz, mask)
    js, ps = _clouds(src, mask)
    want = J.ndt(js, jd, 0.25, max_iterations=20)
    got = P.ndt(ps, pd, 0.25, max_iterations=20)
    np.testing.assert_allclose(n(got.T), n(want.T), atol=1e-5)
    assert int(got.iterations) == int(want.iterations)


def test_so3_exp_hessian_finite_at_zero():
    """NDT linearises at exactly omega = 0 every iteration: the Hessian
    through ``so3_exp`` must be finite there (the series guard's untaken
    branch evaluates at theta^2 = 1, not 0). It equals the analytic one:
    f(w) = sum(R(w) p) has d2f/dw2 = the symmetric part of the second
    order term 0.5 [w]_x^2 p."""
    p = torch.tensor([0.3, -1.2, 2.0])

    def f(w):
        return (so3_exp(w) @ p).sum()

    H = torch.func.hessian(f)(torch.zeros(3))
    assert torch.isfinite(H).all()
    # 0.5 [w]^2 p = 0.5 (w (w.p) - p |w|^2), summed over rows
    s = p.sum()
    want = 0.5 * (p[:, None] + p[None, :]) - s * torch.eye(3)
    np.testing.assert_allclose(n(H), n(want), atol=1e-6)
    g = torch.func.grad(f)(torch.zeros(3))
    np.testing.assert_allclose(n(g), n(torch.linalg.cross(
        p, torch.ones(3), dim=0)), atol=1e-6)


# --- FPFH-seeded starts ------------------------------------------------------

def test_fpfh_hypotheses_match_jax():
    """``_fpfh_hypotheses`` fed the JAX package's own sampled triples
    (``si``, ``pick``, from its key) and its features: T within 1e-5
    where the triple's cross-covariance H is not near rank one (second
    singular value >= 0.005 x the first). Below that the fitted rotation
    about H's dominant axis is set by rounding (LAPACK's SVD against
    XLA's moves it by up to ~3e-5); such hypotheses must still be rigid.
    The features themselves are held in tests/test_torch_features.py."""
    xyz, _ = _bumpy_surface(seed=9, n=800)
    T_true = random_se3(seed=21, max_angle=2.5, max_trans=0.4)
    dst = transform_np(T_true, xyz).astype(np.float32)
    leaf, k_corr, n_starts = 0.05, 2, 32
    jcs = J.voxel_downsample(JPointCloud.from_points(xyz), leaf, 1024)
    jcd = J.voxel_downsample(JPointCloud.from_points(dst), leaf, 1024)
    want = JR._fpfh_start_transforms(jcs, jcd, jax.random.key(5), n_starts,
                                     leaf, k_corr)
    # JAX's draws, as _fpfh_start_transforms makes them
    ns_, oks = J.estimate_normals(jcs, 2.5 * leaf)
    nd_, okd = J.estimate_normals(jcd, 2.5 * leaf)
    fs, vs = J.fpfh(jcs, ns_, oks, radius=5.0 * leaf)
    fd, vd = J.fpfh(jcd, nd_, okd, radius=5.0 * leaf)
    idx, md2 = J.match_fpfh(fs, vs, fd, vd, k=k_corr)
    k1, k2 = jax.random.split(jax.random.key(5))
    si = jax.random.categorical(k1, jnp.where(vs, 0.0, -1e9),
                                shape=(n_starts, 3))
    pick = jax.random.randint(k2, (n_starts, 3), 0, k_corr)
    pcs = PointCloud(xyz=t(jcs.xyz), mask=t(jcs.mask))
    pcd = PointCloud(xyz=t(jcd.xyz), mask=t(jcd.mask))
    got = PR._fpfh_hypotheses(pcs, pcd, (t(vs), t(vd), t(idx), t(md2)),
                              t(si), t(pick))
    si, pick = np.asarray(si), np.asarray(pick)
    a = np.asarray(jcs.xyz, np.float64)[si]
    b = np.asarray(jcd.xyz, np.float64)[np.asarray(idx)[si, pick]]
    H = np.einsum("sni,snj->sij", a - a.mean(1, keepdims=True),
                  b - b.mean(1, keepdims=True))
    sv = np.linalg.svd(H, compute_uv=False)
    posed = sv[:, 1] >= 0.005 * sv[:, 0]
    assert posed.sum() >= n_starts // 2
    np.testing.assert_allclose(n(got)[posed], n(want)[posed], atol=1e-5)
    R = n(got)[:, :3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


def test_fpfh_starts_sample_valid_descriptors():
    """The port's draws come from the caller's generator: the same seed
    gives the same hypotheses, and every sampled source point has a valid
    descriptor."""
    xyz, _ = _bumpy_surface(seed=9, n=800)
    T_true = random_se3(seed=21, max_angle=2.5, max_trans=0.4)
    dst = transform_np(T_true, xyz).astype(np.float32)
    cs = P.voxel_downsample(PointCloud.from_points(xyz), 0.05, 1024)
    cd = P.voxel_downsample(PointCloud.from_points(dst), 0.05, 1024)
    a = PR._fpfh_start_transforms(cs, cd, torch.Generator().manual_seed(1),
                                  16, 0.05, 2)
    b = PR._fpfh_start_transforms(cs, cd, torch.Generator().manual_seed(1),
                                  16, 0.05, 2)
    assert torch.equal(a, b) and a.shape == (16, 4, 4)
    vs = PR._fpfh_features(cs, cd, 0.05, 2)[0]
    g = torch.Generator().manual_seed(1)
    si = torch.multinomial(torch.softmax(torch.where(vs, 0.0, -1e9), 0),
                           48, replacement=True, generator=g)
    assert bool(vs[si].all())


def test_register_global_fpfh_starts_alone_recover_pose():
    """With num_starts=1 (identity only, hopeless at 2.5 rad) the FPFH
    hypotheses must land the pose within 1 cm, as
    tests/test_register_global.py holds the JAX package."""
    xyz, _ = _bumpy_surface(seed=9, n=800)
    T_true = random_se3(seed=21, max_angle=2.5, max_trans=0.4)
    dst = transform_np(T_true, xyz).astype(np.float32)
    res = PR.register_global(PointCloud.from_points(xyz),
                             PointCloud.from_points(dst),
                             torch.Generator().manual_seed(3), num_starts=1,
                             fpfh_starts=32, fpfh_k_corr=2, coarse_leaf=0.05,
                             max_iterations=30)
    assert _max_point_err(res.T, T_true, xyz[:200]) < 0.01
    assert int(res.icp.num_inliers) == 800


# --- the register CLI --------------------------------------------------------

def _cli_pair(tmp_path, mode):
    if mode == "gicp":
        src = _corner(step=0.02, phase=(0.0, 0.0, 0.0))
        T_true = random_se3(seed=9, max_angle=0.1, max_trans=0.03)
        dst = transform_np(T_true, _corner(step=0.02,
                                           phase=(0.5, 0.5, 0.5)))
        args = ["--no-picks", "--gicp", "--gicp-normal-radius", "0.062",
                "--max-corr-dist", "0.2", "--max-iter", "60"]
    else:
        src, _ = _bumpy_surface(seed=9, n=800)
        T_true = random_se3(seed=21, max_angle=2.5, max_trans=0.4)
        dst = transform_np(T_true, src)
        # one start (identity): the FPFH hypotheses alone must land it
        args = ["--global", "--starts", "1", "--fpfh-starts", "32",
                "--coarse-leaf", "0.05", "--max-iter", "30"]
    sp, dp = str(tmp_path / "s.ply"), str(tmp_path / "d.ply")
    save_ply(sp, src)
    save_ply(dp, dst.astype(np.float32))
    return sp, dp, args, src, T_true


@pytest.mark.parametrize("mode", ["gicp", "fpfh"])
def test_register_cli_matches_jax_cli(tmp_path, monkeypatch, capsys, mode):
    """``register_cli --gicp`` (phase-shifted corner scans) and
    ``--global --starts 1 --fpfh-starts 32`` (2.5 rad apart): the port's
    .cal moves the source points within 1e-4 m of where the JAX CLI's .cal
    moves them."""
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    sp, dp, args, src, T_true = _cli_pair(tmp_path, mode)
    want_path, got_path = str(tmp_path / "jax.cal"), str(tmp_path / "p.cal")
    jax_register_cli.main([sp, dp, want_path] + args)
    register_cli.main([sp, dp, got_path] + args)
    out = capsys.readouterr().out
    assert ("GICP:" in out) == (mode == "gicp")
    want, got = jax_load_cal(want_path), load_cal(got_path)
    probe = src[:300]
    assert _max_point_err(got, want, probe) < 1e-4
    assert _max_point_err(got, T_true, probe) < 6e-3
