"""The port's registration (calibration) path against the JAX package's.

Covers the pruned NN (``block_ranges``, the plain version of K4,
``nearest_neighbors_pruned``), single-pair ICP with and without pruning,
``models/registration.py``, the copied file readers and writers, the
register CLI and ``utils/platform``. JAX runs on the CPU as the rest of the
suite runs it: its Pallas NN in interpret mode with 128-wide tiles, its
``icp``/``icp_converge`` on the XLA NN (it has no Pallas path off the TPU).
The port gets CPU tensors, so its wrappers take their plain versions.
Inputs are made with numpy and cross as numpy arrays.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointcloud_stitching_tpu.io as JIO
from pointcloud_stitching_tpu import Intrinsics as JIntrinsics
from pointcloud_stitching_tpu import PointCloud as JPointCloud
from pointcloud_stitching_tpu.kernels import nn_pallas as JNN
from pointcloud_stitching_tpu.models import registration as JR
from pointcloud_stitching_tpu.ops.icp import icp as jax_icp
from pointcloud_stitching_tpu.ops.icp import icp_converge as jax_icp_converge
from pointcloud_stitching_tpu.ops.nn import nearest_neighbors as jax_nn
from pointcloud_stitching_tpu.tools import register_cli as jax_register_cli
import pointcloud_stitching_tpu_torch.io as PIO
from pointcloud_stitching_tpu_torch import Intrinsics, PointCloud
from pointcloud_stitching_tpu_torch.kernels import build as kb
from pointcloud_stitching_tpu_torch.kernels import nn_pallas as PNN
from pointcloud_stitching_tpu_torch.models import registration as PR
from pointcloud_stitching_tpu_torch.ops import icp, icp_converge
from pointcloud_stitching_tpu_torch.utils import platform, prng
from oracle import deproject_np, icp_np, random_se3, synth_depth_frame, \
    transform_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QT = RB = 128  # the JAX Pallas tests' tile sizes (tests/test_nn_pallas.py)


def t(a):
    return torch.from_numpy(np.array(a))


# --- the pruned NN --------------------------------------------------------

def _sorted_scene(rng, b=2, n=700, m=1500, extent=12.0):
    """A reference sorted along x (coherent blocks, as voxel order gives)
    and queries near it in the same order, with masked references and
    queries."""
    r = rng.uniform(-1, 1, (b, m, 3)).astype(np.float32)
    r[..., 0] *= extent
    r = np.take_along_axis(r, np.argsort(r[..., 0], axis=1)[..., None], 1)
    q = (r[:, np.sort(rng.integers(0, m, n))]
         + rng.normal(0, 0.05, (b, n, 3))).astype(np.float32)
    rmask = rng.random((b, m)) > 0.1
    qmask = rng.random((b, n)) > 0.1
    return q, r, rmask, qmask


def _coarse_ub(q, r, rmask, stride=8):
    """The JAX package's coarse-pass bound (Pallas, interpret mode)."""
    _, d2 = JNN.nearest_neighbors_pallas_batched(
        jnp.asarray(q), jnp.asarray(r[:, ::stride]),
        jnp.asarray(rmask[:, ::stride]), query_tile=QT, ref_block=RB,
        interpret=True)
    return np.asarray(d2)


@pytest.mark.parametrize("n,m,qt,rb", [(700, 1500, 128, 128),
                                       (300, 1000, 100, 256),
                                       (1, 130, 128, 64)])
def test_block_ranges_match_jax(n, m, qt, rb):
    rng = np.random.default_rng(101)
    q, r, rmask, qmask = _sorted_scene(rng, n=n, m=m)
    ub = _coarse_ub(q, r, rmask)
    args = (q, qmask, r, rmask, ub)
    wl, wh = JNN.block_ranges(*map(jnp.asarray, args), query_tile=qt,
                              ref_block=rb)
    gl, gh = PNN.block_ranges(*map(t, args), query_tile=qt, ref_block=rb)
    assert gl.dtype == gh.dtype == torch.int32
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    if n > 1:  # the scene is spread along x: some blocks are pruned
        assert (gh - gl + 1).sum() < gl.numel() * -(-m // rb)


@pytest.mark.parametrize("ranges", ["block_ranges", "narrowed", "empty"])
def test_ranged_plain_matches_jax(ranges):
    rng = np.random.default_rng(102)
    q, r, rmask, qmask = _sorted_scene(rng)
    ub = _coarse_ub(q, r, rmask)
    jlo, jhi = (np.asarray(a) for a in JNN.block_ranges(
        *map(jnp.asarray, (q, qmask, r, rmask, ub)), query_tile=QT,
        ref_block=RB))
    if ranges == "narrowed":  # cut to the first block: on purpose too narrow
        jhi = jlo.copy()
    elif ranges == "empty":  # a tile with jlo > jhi sweeps nothing
        jlo, jhi = jlo.copy(), jhi.copy()
        jlo[0, 1], jhi[0, 1] = 3, 2
    rT, rsq = JNN.prepare_ref_batched(jnp.asarray(r), jnp.asarray(rmask), RB)
    wi, wd = JNN.nn_batched_prepared_ranged(
        jnp.asarray(q), rT, rsq, jnp.asarray(jlo), jnp.asarray(jhi),
        num_ref=r.shape[1], query_tile=QT, ref_block=RB, interpret=True)
    gi, gd = PNN.nn_batched_prepared_ranged(
        t(q), PNN.prepare_ref_batched(t(r), t(rmask)), t(jlo), t(jhi),
        query_tile=QT, ref_block=RB)
    if ranges == "empty":  # JAX's kernel still reads its first block
        keep = np.ones(q.shape[:2], bool)
        keep[0, QT:2 * QT] = False
        assert np.isinf(gd.numpy()[~keep]).all()
        assert (gi.numpy()[~keep] == 0).all()
    else:
        keep = np.ones(q.shape[:2], bool)
    np.testing.assert_array_equal(gi.numpy()[keep], np.asarray(wi)[keep])
    np.testing.assert_allclose(gd.numpy()[keep], np.asarray(wd)[keep],
                               rtol=1e-6)
    if ranges == "narrowed":
        # a sweep that ignored its ranges would return brute force here
        bi, _ = PNN.nearest_neighbors_pallas_batched(t(q), t(r), t(rmask))
        assert int((bi != gi).sum()) > 100


def test_pruned_nn_matches_brute_force_and_jax():
    rng = np.random.default_rng(103)
    q, r, rmask, qmask = _sorted_scene(rng)
    kw = dict(coarse_stride=8, query_tile=QT, ref_block=RB)
    gi, gd = PNN.nearest_neighbors_pruned(t(q), t(r), t(rmask), t(qmask),
                                          **kw)
    bi, bd = PNN.nearest_neighbors_pallas_batched(t(q), t(r), t(rmask))
    assert torch.equal(gi[t(qmask)], bi[t(qmask)])
    assert torch.equal(gd[t(qmask)], bd[t(qmask)])
    wi, wd = JNN.nearest_neighbors_pruned(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(rmask),
        jnp.asarray(qmask), interpret=True, **kw)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)


def test_ranged_ties_go_to_the_lower_index():
    """A tie between two blocks of one range: the lower index wins, as in
    the unranged sweep."""
    r = np.zeros((1, 300, 3), np.float32)
    r[0, :, 0] = np.arange(300, dtype=np.float32)
    r[0, 250] = r[0, 40] = (5.0, 1.0, 0.0)      # blocks 0 and 1 of 128
    q = np.full((1, 3, 3), (5.0, 1.0, 0.0), np.float32)
    refT = PNN.prepare_ref_batched(t(r), None)
    one = torch.zeros((1, 1), dtype=torch.int32)
    gi, gd = PNN.nn_batched_prepared_ranged(t(q), refT, one, one + 2,
                                            query_tile=QT, ref_block=RB)
    assert (gi == 40).all() and (gd == 0).all()
    gi, _ = PNN.nn_batched_prepared_ranged(t(q), refT, one + 1, one + 2,
                                           query_tile=QT, ref_block=RB)
    assert (gi == 250).all()


def test_ranged_wrapper_checks_and_routes():
    q = torch.zeros((1, 5, 3))
    refT = PNN.prepare_ref_batched(torch.zeros((1, 9, 3)), None)
    good = torch.zeros((1, 1), dtype=torch.int32)
    kb.reset_launches()
    PNN.nn_batched_prepared_ranged(q, refT, good, good)
    PNN.nearest_neighbors_pruned(q, torch.zeros((1, 9, 3)))
    assert not kb.LAUNCHES
    for lo, hi in ((good.long(), good),
                   (good, torch.zeros((1, 2), dtype=torch.int32))):
        with pytest.raises(ValueError):
            PNN.nn_batched_prepared_ranged(q, refT, lo, hi)
    with pytest.raises(ValueError):
        PNN.nn_batched_prepared_ranged(q, refT, good, good, impl="cuda")


# --- single-pair ICP ------------------------------------------------------

def _icp_scene(rng, n=3000, masked=0.05):
    """A wavy sheet, voxel-ordered by x, and a slightly moved copy with
    1 mm noise (so that trimming does not sort rounding noise)."""
    dst = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    dst[:, 0] *= 3.0
    dst[:, 2] = 0.2 * np.sin(3 * dst[:, 0]) * np.cos(2 * dst[:, 1])
    dst = dst[np.argsort(dst[:, 0])]
    T_true = random_se3(seed=int(rng.integers(1000)), max_angle=0.05,
                        max_trans=0.03)
    src = (transform_np(np.linalg.inv(T_true), dst)
           + rng.normal(0, 1e-3, (n, 3))).astype(np.float32)
    src = src[rng.permutation(n)]
    smask = rng.random(n) > masked
    dmask = rng.random(n) > masked
    return src, dst, smask, dmask, T_true


@pytest.fixture
def jax_icp_direct_nn(monkeypatch):
    """JAX's ``icp`` and ``icp_converge`` on the NN of its own Pallas kernel
    (interpret mode, 128-wide tiles): the direct-difference d2 that the
    port implements.

    Off the TPU the JAX functions take the XLA NN, whose |q|^2+|r|^2-2qr
    form rounds d2 by ~1e-6 m^2 on these 3 m sheets: as large as the 1 mm
    noise, so it reorders correspondences at the trim quantile and moves T
    by up to ~7e-5. That is the reference's arithmetic, not a fault of the
    port. The functions are called unjitted (``__wrapped__``) so that the
    substituted NN is traced whatever ran before."""
    mod = sys.modules["pointcloud_stitching_tpu.ops.icp"]

    def direct(q, r, m, query_tile, ref_tile, impl):
        return jax_nn(q, r, m, query_tile=QT, ref_tile=RB, impl="pallas",
                      interpret=True)

    monkeypatch.setattr(mod, "nearest_neighbors", direct)
    return jax_icp.__wrapped__, jax_icp_converge.__wrapped__


@pytest.mark.parametrize("fn", ["icp", "icp_converge"])
@pytest.mark.parametrize("prune", [False, True])
def test_icp_matches_jax(jax_icp_direct_nn, fn, prune):
    # a generator per case: the suite-wide rng would make the inputs depend
    # on which tests ran before
    rng = np.random.default_rng(30 + 2 * (fn == "icp_converge") + prune)
    src, dst, smask, dmask, _ = _icp_scene(rng)
    js = JPointCloud(xyz=jnp.asarray(src), mask=jnp.asarray(smask))
    jd = JPointCloud(xyz=jnp.asarray(dst), mask=jnp.asarray(dmask))
    ps, pd = PointCloud(xyz=t(src), mask=t(smask)), \
        PointCloud(xyz=t(dst), mask=t(dmask))
    j_icp, j_icp_converge = jax_icp_direct_nn
    if fn == "icp":
        kw = dict(iterations=6, max_corr_dist=0.2, trim_fraction=0.1)
        want, got = j_icp(js, jd, prune=prune, **kw), \
            icp(ps, pd, prune=prune, **kw)
    else:
        kw = dict(max_iterations=8, transformation_epsilon=0.0,
                  max_corr_dist=0.2)
        want = j_icp_converge(js, jd, prune=prune, **kw)
        got = icp_converge(ps, pd, prune=prune, **kw)
    # the same correspondences on both sides; Kabsch's SVD (LAPACK against
    # XLA) rounds differently, which moves T by ~1e-6
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-5)
    assert int(got.iterations) == int(want.iterations)
    assert int(got.num_inliers) == int(want.num_inliers)
    assert got.T.shape == (4, 4) and got.iterations.dtype == torch.int32


def test_pruned_icp_equals_unpruned_and_oracle():
    """Pruning changes which blocks are swept, never the answer: the port's
    pruned ICP equals its brute-force ICP bit for bit, and both agree with
    the numpy oracle."""
    rng = np.random.default_rng(104)
    src, dst, _, _, T_true = _icp_scene(rng, masked=0.0)
    ps = PointCloud.from_points(src)
    pd = PointCloud.from_points(dst)
    a = icp(ps, pd, iterations=8, max_corr_dist=0.2, prune=True)
    b = icp(ps, pd, iterations=8, max_corr_dist=0.2, prune=False)
    assert torch.equal(a.T, b.T)
    want = icp_np(src, dst, iterations=8, max_corr_dist=0.2)
    np.testing.assert_allclose(a.T.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(a.T.numpy(), T_true, atol=1e-3)


def test_icp_converge_stops_on_epsilon():
    rng = np.random.default_rng(105)
    src, dst, _, _, _ = _icp_scene(rng, masked=0.0)
    ps, pd = PointCloud.from_points(src), PointCloud.from_points(dst)
    res = icp_converge(ps, pd, max_iterations=50, max_corr_dist=0.2,
                       prune=True)
    assert 1 < int(res.iterations) < 50
    zero = icp_converge(ps, pd, max_iterations=0)
    assert torch.equal(zero.T, torch.eye(4)) and int(zero.iterations) == 0


# --- models/registration.py ----------------------------------------------

def test_register_pair_matches_jax():
    rng = np.random.default_rng(106)
    src, dst, smask, dmask, T_true = _icp_scene(rng)
    smask[:] = dmask[:] = True
    # picks: four destination points and the source points they came from
    di = np.array([3, 1000, 2000, 2900])
    moved = transform_np(T_true, src)
    si = np.array([int(np.argmin(np.linalg.norm(moved - dst[d], axis=-1)))
                   for d in di])
    js = JPointCloud(xyz=jnp.asarray(src), mask=jnp.asarray(smask))
    jd = JPointCloud(xyz=jnp.asarray(dst), mask=jnp.asarray(dmask))
    ps, pd = PointCloud(xyz=t(src), mask=t(smask)), \
        PointCloud(xyz=t(dst), mask=t(dmask))
    w0 = JR.register_from_correspondences(js, jd, si, di)
    g0 = PR.register_from_correspondences(ps, pd, si, di)
    np.testing.assert_allclose(g0.numpy(), np.asarray(w0), atol=1e-5)
    np.testing.assert_allclose(g0.numpy(), T_true, atol=1e-2)  # 1 mm noise
    kw = dict(max_iterations=30, max_corr_dist=0.2)
    want = JR.register_pair(js, jd, si, di, **kw)
    got = PR.register_pair(ps, pd, si, di, prune=True, **kw)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-5)
    np.testing.assert_allclose(got.T.numpy(), T_true, atol=1e-3)
    assert torch.equal(got.initial_T, g0)
    with pytest.raises(ValueError):
        PR.register_from_correspondences(ps, pd, [1, 2], [1, 2])


def _scene_cloud(seed, stride=4, h=120, w=212):
    """tests/test_register_global.py's wavy scene with one off-centre
    blob, as numpy (xyz, mask)."""
    depth = synth_depth_frame(h, w, seed=seed)
    xyz, mask = deproject_np(depth, 106.0, 106.0, w / 2, h / 2)
    xyz = xyz.reshape(-1, 3)[::stride]
    mask = mask.reshape(-1)[::stride]
    blob = np.array([0.6, 0.4, 1.2]) + np.random.default_rng(
        seed + 100).normal(0, 0.05, (200, 3))
    return (np.concatenate([xyz, blob]).astype(np.float32),
            np.concatenate([mask, np.ones(200, bool)]))


def _max_point_err(T_got, T_true, xyz):
    a = transform_np(np.asarray(T_got), xyz)
    return float(np.linalg.norm(a - transform_np(T_true, xyz), axis=-1).max())


def test_register_global_matches_jax_at_25_starts():
    """At 25 starts the hypotheses are identity + the 24 PCA alignments on
    both sides (the one random rotation drawn from the key is not used),
    so the two winners agree."""
    xyz, mask = _scene_cloud(seed=3)
    T_true = random_se3(seed=8, max_angle=1.0, max_trans=0.2)
    dxyz = transform_np(T_true, xyz).astype(np.float32)
    kw = dict(num_starts=25, coarse_leaf=0.08, coarse_capacity=512,
              max_iterations=30)
    want = JR.register_global(
        JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)),
        JPointCloud(xyz=jnp.asarray(dxyz), mask=jnp.asarray(mask)),
        jax.random.key(0), **kw)
    got = PR.register_global(PointCloud(xyz=t(xyz), mask=t(mask)),
                             PointCloud(xyz=t(dxyz), mask=t(mask)),
                             prng.key(0), prune=True, **kw)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-4)
    assert _max_point_err(got.T, T_true, xyz[mask][:200]) < 0.005


@pytest.mark.parametrize("fpfh_starts", [0, 16])
def test_register_global_matches_jax_on_the_same_key(fpfh_starts):
    """The JAX package's default 64 starts (39 of them random), alone and
    with 16 FPFH starts: the port draws JAX's rotations (normal, within
    ~6e-6 relative) and JAX's FPFH triples and matches (categorical,
    randint) from the same key, so the two winners agree. On this scene
    the coarse winner depends on the draws: another key moves
    ``initial_T`` by 2-8e-3."""
    xyz, mask = _scene_cloud(seed=1)
    T_true = random_se3(seed=0, max_angle=3.1, max_trans=0.2)
    dxyz = transform_np(T_true, xyz).astype(np.float32)
    kw = dict(num_starts=64, coarse_leaf=0.08, coarse_capacity=512,
              fpfh_starts=fpfh_starts, max_iterations=30)
    want = JR.register_global(
        JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)),
        JPointCloud(xyz=jnp.asarray(dxyz), mask=jnp.asarray(mask)),
        jax.random.key(4), **kw)
    got = PR.register_global(PointCloud(xyz=t(xyz), mask=t(mask)),
                             PointCloud(xyz=t(dxyz), mask=t(mask)),
                             prng.key(4), **kw)
    np.testing.assert_allclose(got.initial_T.numpy(),
                               np.asarray(want.initial_T), atol=1e-4)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-4)
    assert _max_point_err(got.T, T_true, xyz[mask][:200]) < 0.005


def test_register_global_routes_its_draws_with_kernel_impl(monkeypatch):
    """``kernel_impl`` reaches the draws' kernels as it reaches K1/K3/K4:
    every threefry2x32 of the random and FPFH starts gets it."""
    seen = []
    real = prng.threefry2x32

    def recording(key, n, pairs=False, impl="auto"):
        seen.append(impl)
        return real(key, n, pairs, impl=impl)

    monkeypatch.setattr(prng, "threefry2x32", recording)
    xyz, mask = _scene_cloud(seed=2)
    pc = PointCloud(xyz=t(xyz), mask=t(mask))
    PR.register_global(pc, pc, prng.key(0), num_starts=26, coarse_leaf=0.08,
                       coarse_capacity=256, refine=False, fpfh_starts=4,
                       kernel_impl="torch")
    # split, normal; the FPFH starts' split, categorical, randint (split
    # and two bits)
    assert seen == ["torch"] * 7


def test_register_global_recovers_large_rotation():
    """tests/test_register_global.py's ~140-degree case, on the port."""
    xyz, mask = _scene_cloud(seed=2)
    T_true = random_se3(seed=5, max_angle=2.5, max_trans=0.4)
    dst = PointCloud(xyz=t(transform_np(T_true, xyz).astype(np.float32)),
                     mask=t(mask))
    res = PR.register_global(PointCloud(xyz=t(xyz), mask=t(mask)), dst,
                             prng.key(0), num_starts=48,
                             coarse_leaf=0.08, coarse_capacity=512,
                             max_iterations=30)
    assert _max_point_err(res.T, T_true, xyz[:200]) < 0.005
    # the FPFH-seeded starts run beside the identity start (they used to
    # raise): a cloud against itself stays where it is
    same = PR.register_global(dst, dst, prng.key(1),
                              num_starts=1, fpfh_starts=8, coarse_leaf=0.08,
                              coarse_capacity=512, max_iterations=30)
    assert _max_point_err(same.T, np.eye(4), xyz[:200]) < 1e-5


def test_pca_axes_right_handed_like_jax():
    rng = np.random.default_rng(107)
    for s in range(4):
        xyz = (rng.normal(size=(500, 3)) * [3.0, 1.0, 0.3]).astype(
            np.float32) @ random_se3(seed=s, max_angle=3)[:3, :3].T
        w = (rng.random(500) > 0.2).astype(np.float32)
        got = PR._pca_axes(t(xyz), t(w)).numpy()
        want = np.asarray(JR._pca_axes(jnp.asarray(xyz), jnp.asarray(w)))
        assert abs(np.linalg.det(got) - 1.0) < 1e-5
        # the same axes, up to the signs of the eigenvectors
        np.testing.assert_allclose(np.abs(got.T @ want), np.eye(3),
                                   atol=1e-4)
    np.testing.assert_array_equal(PR._ALIGN24, JR._ALIGN24)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(PR._quat_rotations(t(q)).numpy(),
                               np.asarray(JR._quat_rotations(jnp.asarray(q))),
                               atol=1e-6)


@pytest.mark.parametrize("fn", ["nearest_neighbors", "icp_batched",
                                "icp_point_to_plane_batched", "icp",
                                "icp_converge", "register_pair",
                                "register_global"])
def test_entry_points_take_and_ignore_the_tile_arguments(fn):
    """The JAX package's query_tile/ref_tile (its XLA sweep's tiles) are
    accepted and ignored: a call with them equals the call without them."""
    from pointcloud_stitching_tpu_torch.ops import (
        icp_batched, icp_point_to_plane_batched, nearest_neighbors)
    rng = np.random.default_rng(120)
    src, dst, smask, dmask, _ = _icp_scene(rng, n=600)
    ps = PointCloud(xyz=t(src), mask=t(smask))
    pd = PointCloud(xyz=t(dst), mask=t(dmask))
    bs = PointCloud(xyz=ps.xyz[None].repeat(2, 1, 1),
                    mask=ps.mask[None].repeat(2, 1))
    bd = PointCloud(xyz=pd.xyz[None].repeat(2, 1, 1),
                    mask=pd.mask[None].repeat(2, 1))
    normals = torch.nn.functional.normalize(bd.xyz, dim=-1)
    calls = {
        "nearest_neighbors": lambda **kw: nearest_neighbors(
            ps.xyz, pd.xyz, pd.mask, **kw),
        "icp_batched": lambda **kw: icp_batched(bs, bd, iterations=3, **kw),
        "icp_point_to_plane_batched": lambda **kw:
            icp_point_to_plane_batched(bs, bd, normals, iterations=3, **kw),
        "icp": lambda **kw: icp(ps, pd, iterations=3, max_corr_dist=0.2,
                                prune=True, **kw),
        "icp_converge": lambda **kw: icp_converge(ps, pd, max_iterations=10,
                                                  max_corr_dist=0.2, **kw),
        "register_pair": lambda **kw: PR.register_pair(
            ps, pd, max_iterations=10, max_corr_dist=0.2, **kw),
        "register_global": lambda **kw: PR.register_global(
            ps, pd, prng.key(0), num_starts=25,
            coarse_capacity=256, **kw),
    }
    plain = calls[fn]()
    tiled = calls[fn](query_tile=256, ref_tile=512)
    for a, b in zip(torch.utils._pytree.tree_leaves(plain),
                    torch.utils._pytree.tree_leaves(tiled)):
        assert torch.equal(a, b)


# --- the copied file readers and writers ----------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["ply_bin", "ply_ascii", "ply_normals",
                                 "pcd_bin", "pcd_ascii", "pcd_compressed"])
def test_cloud_files_cross_read(tmp_path, writer, fmt):
    rng = np.random.default_rng(108)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (300, 3)).astype(np.uint8)
    W, R = (JIO, PIO) if writer == "jax" else (PIO, JIO)
    path = str(tmp_path / ("c.ply" if fmt.startswith("ply") else "c.pcd"))
    if fmt == "ply_normals":
        W.save_ply(path, xyz, normals=xyz)
    elif fmt.startswith("ply"):
        W.save_ply(path, xyz, rgb, binary=fmt == "ply_bin")
    else:
        W.save_pcd(path, xyz, rgb, binary=fmt != "pcd_ascii",
                   compressed=fmt == "pcd_compressed")
    load = R.load_ply if fmt.startswith("ply") else R.load_pcd
    (gx, gc), (wx, wc) = load(path), W.load_ply(path) if fmt.startswith(
        "ply") else W.load_pcd(path)
    np.testing.assert_array_equal(gx, wx)
    tol = 1e-5 if fmt.endswith("ascii") else 0.0
    np.testing.assert_allclose(gx, xyz, rtol=tol, atol=tol)
    if fmt == "ply_normals":
        assert gc is None and wc is None
    else:
        np.testing.assert_array_equal(gc, rgb)
        np.testing.assert_array_equal(wc, rgb)


def test_cal_mesh_and_intrinsics_files_cross_read(tmp_path):
    rng = np.random.default_rng(109)
    T = random_se3(seed=3)
    JIO.save_cal(str(tmp_path / "a.cal"), T)
    PIO.save_cal(str(tmp_path / "b.cal"), T)
    assert (tmp_path / "a.cal").read_text() == (tmp_path / "b.cal").read_text()
    np.testing.assert_array_equal(PIO.load_cal(str(tmp_path / "a.cal")),
                                  JIO.load_cal(str(tmp_path / "b.cal")))
    assert PIO.discover_cals(str(tmp_path)) == JIO.discover_cals(
        str(tmp_path))
    np.testing.assert_array_equal(
        PIO.load_cals(PIO.discover_cals(str(tmp_path))),
        JIO.load_cals(JIO.discover_cals(str(tmp_path))))
    xyz = rng.normal(size=(10, 3)).astype(np.float32)
    faces = rng.integers(0, 10, (7, 3))
    JIO.save_mesh(str(tmp_path / "j.ply"), xyz, faces)
    PIO.save_mesh(str(tmp_path / "p.ply"), xyz, faces)
    assert (tmp_path / "j.ply").read_bytes() == \
        (tmp_path / "p.ply").read_bytes()
    JIO.save_intrinsics(str(tmp_path / "j.intr.json"), JIntrinsics.create(
        fx=421.5, fy=421.1, ppx=424.0, ppy=240.0, coeffs=[0.1, 0, 0, 0, 0],
        model=2))
    PIO.save_intrinsics(str(tmp_path / "p.intr.json"), Intrinsics.create(
        fx=421.5, fy=421.1, ppx=424.0, ppy=240.0, coeffs=[0.1, 0, 0, 0, 0],
        model=2))
    assert (tmp_path / "j.intr.json").read_text() == \
        (tmp_path / "p.intr.json").read_text()
    stack = PIO.load_intrinsics_stack(PIO.discover_intrinsics(str(tmp_path)))
    assert stack.fx.shape == (2,) and stack.model == 2
    assert float(stack.coeffs[1, 0]) == pytest.approx(0.1)


# --- the register CLI and the device choice --------------------------------

def _port_cli(*args, env_extra=None):
    env = dict(os.environ, PCS_PLATFORM="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m",
         "pointcloud_stitching_tpu_torch.tools.register_cli", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)


def test_register_cli_matches_jax_cli(tmp_path):
    """tests/test_tools.py's picks case through both CLIs, with --prune."""
    rng = np.random.default_rng(110)
    pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    T_true = random_se3(seed=5, max_angle=0.4, max_trans=0.4)
    sp, dp = str(tmp_path / "src.ply"), str(tmp_path / "dst.pcd")
    PIO.save_ply(sp, pts)
    PIO.save_pcd(dp, transform_np(T_true, pts))
    picks = tmp_path / "picks.txt"
    picks.write_text("\n".join(f"{i} {i}" for i in [5, 300, 999, 1500]))
    args = ["--picks", str(picks), "--max-corr-dist", "1.0", "--prune"]
    r = _port_cli(sp, dp, str(tmp_path / "port.cal"), *args)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[0] == "src: 2000 pts, dst: 2000 pts"
    assert lines[1].startswith("ICP: ") and "inliers=2000" in lines[1]
    assert lines[2] == f"wrote {tmp_path / 'port.cal'}"
    jax_register_cli.main([sp, dp, str(tmp_path / "jax.cal"), *args])
    got = PIO.load_cal(str(tmp_path / "port.cal"))
    np.testing.assert_allclose(got, T_true, atol=1e-3)
    np.testing.assert_allclose(got, JIO.load_cal(str(tmp_path / "jax.cal")),
                               atol=1e-5)


@pytest.mark.parametrize("flag", [["--gicp"], ["--fpfh-starts", "8"]])
def test_register_cli_refuses_unported_flags(tmp_path, flag):
    """The two flags the CLI refused until their modules were ported now
    run end to end as a subprocess: a .cal within 5 mm of the pose. (The
    name is the one this test had while it pinned the refusals.)"""
    xyz, mask = _scene_cloud(seed=4)
    xyz = xyz[mask]
    T_true = random_se3(seed=6, max_angle=0.05, max_trans=0.03)
    PIO.save_ply(str(tmp_path / "s.ply"), xyz)
    PIO.save_ply(str(tmp_path / "d.ply"),
                 transform_np(T_true, xyz).astype(np.float32))
    r = _port_cli(str(tmp_path / "s.ply"), str(tmp_path / "d.ply"),
                  str(tmp_path / "o.cal"), "--global", "--starts", "1",
                  "--coarse-leaf", "0.08", *flag)
    assert r.returncode == 0, r.stderr[-2000:]
    assert ("GICP:" in r.stdout) == (flag[0] == "--gicp")
    T = PIO.load_cal(str(tmp_path / "o.cal"))
    assert _max_point_err(T, T_true, xyz[:200]) < 0.005


def test_platform_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for value in (None, "cuda", "CUDA"):
        if value is None:
            monkeypatch.delenv("PCS_PLATFORM", raising=False)
        else:
            monkeypatch.setenv("PCS_PLATFORM", value)
        with pytest.raises(RuntimeError, match="PCS_PLATFORM"):
            platform.platform_device()
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    assert platform.platform_device() == torch.device("cpu")
    monkeypatch.setenv("PCS_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        platform.platform_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("PCS_PLATFORM", "cuda")
    assert platform.platform_device() == torch.device("cuda", 0)


def test_full_fp32_matmul_helper_is_shared():
    from pointcloud_stitching_tpu_torch.models import stitcher
    assert stitcher.set_full_fp32_matmul is platform.set_full_fp32_matmul
    platform.set_full_fp32_matmul()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
