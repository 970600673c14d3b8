"""The port's analysis ops against the JAX package's.

Covers ``ops/filters.py`` (passthrough, frustum culling, the neighbour
counts and the radius / statistical outlier filters), ``ops/sac.py``
(plane RANSAC on the JAX package's own draws), ``ops/cluster.py`` (the
three clusterers, cluster statistics, oriented boxes) and ``ops/hull.py``
(support points, convex and concave hulls, crop). Inputs are made with
numpy from a generator per test and cross as numpy arrays; the port gets
CPU tensors. JAX runs on the CPU as the rest of the suite runs it; none of
these functions reaches a Pallas kernel.

Tolerances: masks and labels bitwise; ``segment_plane`` on the JAX
package's indices within 1e-5 (inlier masks equal away from 1e-6 m of the
threshold); ``knn_mean_distance`` within 1e-6; ``cluster_stats`` and the
oriented boxes within 1e-5 (box axes up to sign); support indices and
hull vertex sets exactly.
"""
import importlib
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointcloud_stitching_tpu as JP
from pointcloud_stitching_tpu import Intrinsics as JIntrinsics
from pointcloud_stitching_tpu import PointCloud as JPointCloud
from pointcloud_stitching_tpu.ops import cluster as JC
from pointcloud_stitching_tpu.ops import filters as JF
from pointcloud_stitching_tpu.ops import hull as JH
from pointcloud_stitching_tpu.ops import sac as JS
import pointcloud_stitching_tpu_torch as PP
from pointcloud_stitching_tpu_torch import Intrinsics, PointCloud
from pointcloud_stitching_tpu_torch.ops import cluster as PC
from pointcloud_stitching_tpu_torch.ops import filters as PF
from pointcloud_stitching_tpu_torch.ops import hull as PH
from pointcloud_stitching_tpu_torch.ops import sac as PS
from oracle import random_se3

N = 2048


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _clouds(xyz, mask):
    xyz = np.asarray(xyz, np.float32)
    mask = np.asarray(mask, bool)
    return (JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)),
            PointCloud(xyz=t(xyz), mask=t(mask)))


def _scene(seed, npts=N, masked=0.1):
    """Four blobs of 300 points, uniform clutter, a tenth masked."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0.0, 0.4, (npts, 3)).astype(np.float32)
    for c in range(4):
        xyz[c * 300:(c + 1) * 300] = (rng.normal(0.0, 0.03, (300, 3))
                                      + np.array([0.5 * c, 0.0, 1.0]))
    return xyz, rng.random(npts) > masked


def _plane_scene(seed, npts=N):
    """A tilted plane of 60% of the points (0.5 mm noise) plus clutter."""
    rng = np.random.default_rng(seed)
    k = int(0.6 * npts)
    T = random_se3(seed=seed, max_angle=0.4, max_trans=0.3)
    plane = np.c_[rng.uniform(-1, 1, (k, 2)), rng.normal(0, 5e-4, k)]
    clutter = rng.uniform(-1, 1, (npts - k, 3))
    xyz = np.concatenate([plane, clutter]) @ T[:3, :3].T + T[:3, 3]
    return (xyz.astype(np.float32), rng.random(npts) > 0.05,
            T[:3, 2].astype(np.float32))


# --- filters -------------------------------------------------------------------

@pytest.mark.parametrize("invert", [False, True])
def test_passthrough_matches_jax(invert):
    xyz, mask = _scene(1)
    jp, tp = _clouds(xyz, mask)
    for axis, lo, hi in ((0, -0.2, 0.6), (2, 0.9, 1.1)):
        want = JF.passthrough(jp, axis, lo, hi, invert=invert).mask
        got = PF.passthrough(tp, axis, lo, hi, invert=invert).mask
        np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("model,extrinsic,invert", [
    (0, False, False), (1, True, False), (2, True, True)])
def test_frustum_cull_matches_jax(model, extrinsic, invert):
    """Pixel-area bounds, z range, distortion and the camera pose."""
    rng = np.random.default_rng(2 + model)
    xyz = np.c_[rng.uniform(-3, 3, (N, 2)), rng.uniform(-1, 6, N)]
    ext = random_se3(seed=model, max_angle=0.3, max_trans=0.5)
    if extrinsic:
        xyz = xyz @ ext[:3, :3].T + ext[:3, 3]
    mask = rng.random(N) > 0.1
    jp, tp = _clouds(xyz, mask)
    coeffs = [0.05, -0.02, 0.001, -0.001, 0.003] if model else None
    kw = dict(fx=300.0, fy=310.0, ppx=160.0, ppy=118.0, coeffs=coeffs,
              width=320, height=240, model=model)
    ji, ti = JIntrinsics.create(**kw), Intrinsics.create(**kw)
    e = ext if extrinsic else None
    want = JF.frustum_cull(jp, ji, e, z_min=0.3, z_max=4.0, invert=invert)
    got = PF.frustum_cull(tp, ti, e, z_min=0.3, z_max=4.0, invert=invert)
    np.testing.assert_array_equal(n(got.mask), n(want.mask))
    assert 0 < int(got.mask.sum()) < int(tp.mask.sum())


def _with_duplicates(seed):
    xyz, mask = _scene(seed)
    xyz[1000:1040] = xyz[1200:1240]          # exact duplicates
    xyz[1500] = xyz[1501]
    mask[1500] = mask[1501] = True
    return xyz, mask


def test_count_neighbors_matches_jax_and_counts_duplicates():
    """Exact duplicates count each other; no point counts itself; invalid
    points count 0; a [B, N, 3] batch is each cloud on its own."""
    xyz, mask = _with_duplicates(3)
    jp, tp = _clouds(xyz, mask)
    want = n(JF.count_neighbors(jp, 0.05))
    got = n(PF.count_neighbors(tp, 0.05, query_tile=256, ref_tile=512))
    np.testing.assert_array_equal(got, want)
    d2 = ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
    brute = ((d2 <= np.float32(0.05) ** 2) & mask[None]).sum(1) - 1
    np.testing.assert_array_equal(got, np.where(mask, brute, 0))
    assert got[1500] >= 1 and (got[~mask] == 0).all()
    two = PointCloud(xyz=t(np.stack([xyz, xyz[::-1]])),
                     mask=t(np.stack([mask, mask[::-1]])))
    batched = n(PF.count_neighbors(two, 0.05))
    np.testing.assert_array_equal(batched[0], got)
    np.testing.assert_array_equal(batched[1], got[::-1])


def test_radius_outlier_removal_matches_jax():
    xyz, mask = _with_duplicates(4)
    jp, tp = _clouds(xyz, mask)
    for radius, k in ((0.05, 4), (0.2, 10)):
        want = JF.radius_outlier_removal(jp, radius, k).mask
        got = PF.radius_outlier_removal(tp, radius, k).mask
        np.testing.assert_array_equal(n(got), n(want))
        assert 0 < int(got.sum()) < int(tp.mask.sum())


def test_knn_mean_distance_and_sor_match_jax():
    """Duplicates give zero distances (the point itself is excluded by
    index); a cloud with fewer than k valid co-points averages over the
    ones it has."""
    xyz, mask = _with_duplicates(5)
    jp, tp = _clouds(xyz, mask)
    want = n(JF.knn_mean_distance(jp, 8))
    got = n(PF.knn_mean_distance(tp, 8))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[1500] > 0 and (got[~mask] == 0).all()
    for ratio in (1.0, 0.5):
        np.testing.assert_array_equal(
            n(PF.statistical_outlier_removal(tp, 8, ratio).mask),
            n(JF.statistical_outlier_removal(jp, 8, ratio).mask))
    sparse = np.zeros(N, bool)
    sparse[[3, 50, 700]] = True
    js, ts = _clouds(xyz, sparse)
    np.testing.assert_allclose(n(PF.knn_mean_distance(ts, 8)),
                               n(JF.knn_mean_distance(js, 8)), atol=1e-6)


# --- plane RANSAC --------------------------------------------------------------

def _jax_draws(jp, m, seed):
    """The hypotheses JAX's segment_plane draws with key(seed)."""
    key = jax.random.key(seed)
    p = jp.mask.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return key, np.asarray(jax.random.choice(key, jp.xyz.shape[0],
                                             shape=(m, 3), p=p))


@pytest.mark.parametrize("refine_iters", [0, 2])
def test_segment_plane_on_jax_draws_matches_jax(refine_iters):
    xyz, mask, normal = _plane_scene(6)
    jp, tp = _clouds(xyz, mask)
    key, idx = _jax_draws(jp, 256, 7)
    jm, ji, jc = JS.segment_plane(jp, 0.01, key, num_hypotheses=256,
                                  refine_iters=refine_iters, chunk=512)
    pm, pi, pc_ = PS._segment_plane_from_indices(
        tp, t(idx), 0.01, refine_iters=refine_iters, chunk=512)
    np.testing.assert_allclose(n(pm), n(jm), rtol=0, atol=1e-5)
    assert abs(abs(float(n(pm)[:3] @ normal)) - 1) < 1e-4
    dist = np.abs(xyz.astype(np.float64) @ n(jm)[:3].astype(np.float64)
                  + float(n(jm)[3]))
    edge = np.abs(dist - 0.01) < 1e-6
    np.testing.assert_array_equal(n(pi)[~edge], n(ji)[~edge])
    assert abs(int(pc_) - int(jc)) <= int(edge.sum())


def test_segment_plane_draws_from_the_generator():
    """The same generator state gives the same plane; an empty or
    two-point cloud gives the zero model and no inliers, as JAX's."""
    xyz, mask, normal = _plane_scene(8)
    _, tp = _clouds(xyz, mask)
    a = PS.segment_plane(tp, 0.01, torch.Generator().manual_seed(3))
    b = PS.segment_plane(tp, 0.01, torch.Generator().manual_seed(3))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert abs(abs(float(a[0][:3] @ t(normal))) - 1) < 1e-4
    assert int(a[2]) >= int(0.6 * N * 0.9)
    for keep in ([], [5, 9]):
        m = np.zeros(N, bool)
        m[keep] = True
        jp, tp = _clouds(xyz, m)
        jm, ji, jc = JS.segment_plane(jp, 0.01, jax.random.key(0),
                                      num_hypotheses=64)
        pm, pi, pc_ = PS.segment_plane(tp, 0.01,
                                       torch.Generator().manual_seed(0),
                                       num_hypotheses=64)
        assert int(pc_) == int(jc) == 0
        assert not pi.any() and not n(ji).any()
        np.testing.assert_array_equal(n(pm), n(jm))


def test_extract_and_project_plane_match_jax():
    xyz, mask, _ = _plane_scene(9)
    jp, tp = _clouds(xyz, mask)
    model = np.array([0.1, -0.2, 0.97, -0.3], np.float32)   # not unit
    for neg in (True, False):
        np.testing.assert_array_equal(
            n(PS.extract_plane(tp, t(model), 0.05, negative=neg).mask),
            n(JS.extract_plane(jp, jnp.asarray(model), 0.05,
                               negative=neg).mask))
    got = PS.project_plane(tp, t(model))
    want = JS.project_plane(jp, jnp.asarray(model))
    np.testing.assert_allclose(n(got.xyz), n(want.xyz), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(n(got.xyz)[~mask], xyz[~mask])


# --- clusters --------------------------------------------------------------------

def _assert_same_clusters(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.parametrize("tol,min_size,k", [(0.05, 20, 8), (0.1, 1, 16)])
def test_euclidean_clusters_matches_jax(tol, min_size, k):
    xyz, mask = _scene(10)
    jp, tp = _clouds(xyz, mask)
    want = JC.euclidean_clusters(jp, tol, min_size=min_size, max_clusters=k)
    got = PC.euclidean_clusters(tp, tol, min_size=min_size, max_clusters=k)
    _assert_same_clusters(got, want)
    assert int(got[1]) >= 4


def _equal_blobs():
    """Three separated blobs of 60 points each, their lowest indices in
    the order 2, 0, 1, plus a blob of 90 and padding."""
    rng = np.random.default_rng(11)
    pts = np.zeros((512, 3), np.float32)
    mask = np.zeros(512, bool)
    centres = [(2.0, 0, 0), (0, 2.0, 0), (0, 0, 2.0), (2.0, 2.0, 2.0)]
    spans = [(100, 160), (200, 260), (10, 70), (300, 390)]
    for c, (a, b) in zip(centres, spans):
        pts[a:b] = rng.uniform(-0.04, 0.04, (b - a, 3)) + np.array(c)
        mask[a:b] = True
    return pts, mask, spans


@pytest.mark.parametrize("fn", ["euclidean_clusters",
                                "euclidean_clusters_exact"])
def test_cluster_size_ties_rank_the_lower_root_first(fn):
    """Equal sizes rank as lax.top_k does: the lower root index first."""
    pts, mask, spans = _equal_blobs()
    jp, tp = _clouds(pts, mask)
    want = getattr(JC, fn)(jp, 0.05, max_clusters=4)
    got = getattr(PC, fn)(tp, 0.05, max_clusters=4)
    _assert_same_clusters(got, want)
    lab = n(got[0])
    np.testing.assert_array_equal(n(got[2]), [90, 60, 60, 60])
    assert set(lab[300:390]) == {0}
    if fn == "euclidean_clusters_exact":      # roots are point indices
        assert [lab[a] for a, _ in spans[:3]] == [2, 3, 1]


def test_euclidean_clusters_fails_safe_past_2_31_cells():
    """Past 2^31 occupied-extent cells every label is -1, as in JAX."""
    pts = np.array([[0, 0, 0], [0.0005, 0, 0], [1500, 1500, 1500],
                    [1500.0005, 1500, 1500]], np.float32)
    jp, tp = _clouds(pts, np.ones(4, bool))
    want = JC.euclidean_clusters(jp, 0.001, max_clusters=2)
    got = PC.euclidean_clusters(tp, 0.001, max_clusters=2)
    _assert_same_clusters(got, want)
    assert (n(got[0]) == -1).all() and int(got[1]) == 0
    ok = PC.euclidean_clusters(tp, 10.0, max_clusters=2)
    assert int(ok[1]) == 2


@pytest.mark.parametrize("rounds", [1, 2, 5])
def test_propagation_round_cap_matches_jax(rounds):
    """A chain needs many rounds: a cap stops both at the same labels."""
    pts = np.c_[np.arange(400) * 0.04, np.zeros(400), np.zeros(400)]
    pts = pts[np.random.default_rng(12).permutation(400)]
    jp, tp = _clouds(pts, np.ones(400, bool))
    _assert_same_clusters(
        PC.euclidean_clusters(tp, 0.05, max_clusters=8, rounds=rounds),
        JC.euclidean_clusters(jp, 0.05, max_clusters=8, rounds=rounds))
    _assert_same_clusters(
        PC.euclidean_clusters_exact(tp, 0.05, max_clusters=8,
                                    rounds=rounds),
        JC.euclidean_clusters_exact(jp, 0.05, max_clusters=8,
                                    rounds=rounds))


def test_euclidean_clusters_exact_matches_jax():
    xyz, mask = _scene(13)
    jp, tp = _clouds(xyz, mask)
    for tol in (0.03, 0.08):
        _assert_same_clusters(
            PC.euclidean_clusters_exact(tp, tol, min_size=5, max_clusters=8,
                                        query_tile=256, ref_tile=512),
            JC.euclidean_clusters_exact(jp, tol, min_size=5, max_clusters=8,
                                        query_tile=256, ref_tile=512))


def test_region_growing_matches_jax():
    """Two planes meeting at a crease split; the curvature gate drops the
    crease, the normals' validity mask the rest."""
    rng = np.random.default_rng(14)
    a = np.c_[rng.uniform(0, 1, (700, 2)), np.zeros(700)]
    b = np.c_[rng.uniform(0, 1, 700), np.zeros(700), rng.uniform(0, 1, 700)]
    xyz = np.concatenate([a, b]).astype(np.float32)
    mask = rng.random(1400) > 0.05
    nrm = np.concatenate([np.tile([0, 0, 1.0], (700, 1)),
                          np.tile([0, -1.0, 0], (700, 1))]).astype(np.float32)
    nrm += rng.normal(0, 0.02, nrm.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nvalid = rng.random(1400) > 0.02
    curv = np.where(np.abs(xyz[:, 1]) + np.abs(xyz[:, 2]) < 0.05, 0.2,
                    0.001).astype(np.float32)
    jp, tp = _clouds(xyz, mask)
    for kw in ({}, {"curvature_threshold": 0.05}):
        jc = jnp.asarray(curv) if kw else None
        pc_ = t(curv) if kw else None
        want = JC.region_growing(jp, jnp.asarray(nrm), 0.06, 0.3,
                                 normals_valid=jnp.asarray(nvalid),
                                 curvature=jc, min_size=10, max_clusters=4,
                                 **kw)
        got = PC.region_growing(tp, t(nrm), 0.06, 0.3, normals_valid=t(nvalid),
                                curvature=pc_, min_size=10, max_clusters=4,
                                **kw)
        _assert_same_clusters(got, want)
        assert int(got[1]) == 2


def test_cluster_stats_and_oriented_boxes_match_jax():
    """Centroids, boxes and OBB centres/half extents within 1e-5; the axes
    within 1e-5 up to each axis' sign. Clusters a few meters out (the
    JAX package sums in float32: at 20 m its centroids drift ~1.5e-5)."""
    rng = np.random.default_rng(15)
    xyz = np.zeros((N, 3), np.float32)
    labels = np.full(N, -1, np.int32)
    for c in range(5):
        R = random_se3(seed=20 + c, max_angle=1.0, max_trans=0)[:3, :3]
        pts = rng.normal(0, [0.3, 0.1, 0.03], (300, 3)) @ R.T
        xyz[c * 300:(c + 1) * 300] = pts + np.array([1.5 * c, -2.0, 3.0])
        labels[c * 300:(c + 1) * 300] = c if c != 3 else 6   # id 3 absent
    mask = rng.random(N) > 0.05
    jp, tp = _clouds(xyz, mask)
    for g, w in zip(PC.cluster_stats(tp, t(labels), 8),
                    JC.cluster_stats(jp, jnp.asarray(labels), 8)):
        np.testing.assert_allclose(n(g), n(w), rtol=0, atol=1e-5)
    got = PC.oriented_bboxes(tp, t(labels), 8)
    want = JC.oriented_bboxes(jp, jnp.asarray(labels), 8)
    for i in (0, 2):
        np.testing.assert_allclose(n(got[i]), n(want[i]), rtol=0, atol=1e-5)
    ga, wa = n(got[1]), n(want[1])
    sign = np.sign((ga * wa).sum(-1, keepdims=True))
    sign[sign == 0] = 1
    np.testing.assert_allclose(ga * sign, wa, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n(got[3]), n(want[3]))
    assert (n(got[3])[[3, 5, 7]] == 0).all() and (ga[3] == 0).all()


# --- hulls ------------------------------------------------------------------------

def _hull_cloud(seed, npts=1000):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, [0.4, 0.3, 0.2], (npts, 3)).astype(np.float32)
    return xyz, rng.random(npts) > 0.1


def test_support_indices_match_jax():
    """Blocks of 256 over 1000 points; a copy of a support point at a later
    index loses the tie."""
    xyz, mask = _hull_cloud(16)
    dirs = JH.fibonacci_directions(2048)
    np.testing.assert_array_equal(PH.fibonacci_directions(2048), dirs)
    want = n(JH._support_indices(jnp.asarray(xyz), jnp.asarray(mask),
                                 jnp.asarray(dirs), block=256))
    first = want[0]
    xyz[900] = xyz[first]
    mask[900] = True
    want = n(JH._support_indices(jnp.asarray(xyz), jnp.asarray(mask),
                                 jnp.asarray(dirs), block=256))
    got = n(PH._support_indices(t(xyz), t(mask), t(dirs), block=256))
    np.testing.assert_array_equal(got, want)
    assert 900 not in got and mask[got].all()


@pytest.mark.parametrize("exact", [False, True])
def test_convex_hull_matches_jax(exact):
    xyz, mask = _hull_cloud(17)
    jp, tp = _clouds(xyz, mask)
    want = JH.convex_hull(jp, n_dirs=512, exact=exact, block=256)
    got = PH.convex_hull(tp, n_dirs=512, exact=exact, block=256)
    np.testing.assert_array_equal(got.vertex_ids, want.vertex_ids)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.equations, want.equations)
    assert got.volume == want.volume and got.area == want.area


def _alpha_between(radii, target):
    """An alpha near ``target`` at least 1e-4 (relative) from every
    circumradius."""
    r = np.sort(radii[np.isfinite(radii)])
    gaps = np.diff(r)
    mids = (r[1:] + r[:-1]) / 2
    ok = gaps > 2e-4 * mids
    return float(mids[ok][np.argmin(np.abs(mids[ok] - target))])


@pytest.mark.parametrize("planar", [False, True])
def test_concave_hull_matches_jax(planar):
    from scipy.spatial import Delaunay
    rng = np.random.default_rng(18)
    if planar:   # an annulus: one outer ring, one hole ring
        ang = rng.uniform(0, 2 * np.pi, 800)
        rad = np.sqrt(rng.uniform(0.25, 1.0, 800))
        xyz = np.c_[rad * np.cos(ang), rad * np.sin(ang),
                    rng.normal(0, 1e-3, 800)]
        tri = xyz[Delaunay(xyz[:, :2]).simplices][:, :, :2]
        radii = n(JH._tri_circumradii(jnp.asarray(tri.astype(np.float32))))
        target = 0.15
    else:
        xyz = rng.uniform(-1, 1, (800, 3))
        xyz = xyz[np.linalg.norm(xyz, axis=1) > 0.5]      # a hollow ball
        tets = xyz[Delaunay(xyz).simplices]
        radii = n(JH._tet_circumradii(jnp.asarray(tets.astype(np.float32))))
        target = 0.3
    alpha = _alpha_between(radii, target)
    jp, tp = _clouds(xyz, np.ones(len(xyz), bool))
    want = JH.concave_hull(jp, alpha, planar=planar)
    got = PH.concave_hull(tp, alpha, planar=planar)
    np.testing.assert_array_equal(got.vertex_ids, want.vertex_ids)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.volume == want.volume and got.area == want.area
    assert len(got.rings) == len(want.rings) == (2 if planar else 0)
    for a, b in zip(got.rings, want.rings):
        np.testing.assert_array_equal(a, b)


def test_flat_tetrahedra_drop_out():
    """A flat tetrahedron (all on z = 0) and one with a repeated point:
    torch.linalg.solve would raise; solve_ex gives +inf, and JAX's nan or
    inf fails the alpha test just the same."""
    tets = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                     [[0, 0, 0], [1, 0, 0], [1, 0, 0], [0, 0, 1]]],
                    np.float32)
    got = n(PH._tet_circumradii(t(tets)))
    want = n(JH._tet_circumradii(jnp.asarray(tets)))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[0], np.sqrt(3) / 2, rtol=1e-6)
    assert np.isposinf(got[1:]).all()
    assert not (np.nan_to_num(want[1:], nan=np.inf) < 1e6).any()


@pytest.mark.parametrize("invert", [False, True])
def test_crop_hull_matches_jax(invert):
    """The hull's own vertices stay inside (the default slack); planes
    given raw as a tensor give the same mask."""
    xyz, mask = _hull_cloud(19)
    jp, tp = _clouds(xyz, mask)
    h = JH.convex_hull(JPointCloud(xyz=jnp.asarray(xyz[:500]),
                                   mask=jnp.asarray(mask[:500])), exact=True)
    want = n(JH.crop_hull(jp, h, invert=invert).mask)
    got = n(PH.crop_hull(tp, h, invert=invert).mask)
    np.testing.assert_array_equal(got, want)
    raw = n(PH.crop_hull(tp, t(h.equations), invert=invert).mask)
    np.testing.assert_array_equal(raw, want)
    assert got[h.vertex_ids].all() != invert


# --- exports ----------------------------------------------------------------------

# ops names the port exports besides the JAX package's (all are functions
# of the JAX package's modules, only not in its ops/__init__)
PORT_ONLY_OPS = {"map_grid_bounds", "mesh_cloud_arrays", "mm", "se3_blend",
                 "se3_power", "so3_exp", "so3_log"}


def test_port_exports_match_the_jax_package():
    """ops, models, io, runtime and parallel export the JAX package's
    names (ops also PORT_ONLY_OPS); tools has every CLI of the JAX
    package; no subpackage of the JAX package is left unported."""
    for sub in ("ops", "models", "io", "runtime", "parallel"):
        want = set(importlib.import_module(
            f"pointcloud_stitching_tpu.{sub}").__all__)
        got = set(importlib.import_module(
            f"pointcloud_stitching_tpu_torch.{sub}").__all__)
        extra = PORT_ONLY_OPS if sub == "ops" else set()
        assert got == want | extra, (sub, want ^ got)
    import pointcloud_stitching_tpu.tools as jt
    import pointcloud_stitching_tpu_torch.tools as pt
    names = [{m.name for m in pkgutil.iter_modules(p.__path__)}
             for p in (jt, pt)]
    assert names[0] <= names[1], names[0] - names[1]
    assert {m.name for m in pkgutil.iter_modules(JP.__path__)} - {
        m.name for m in pkgutil.iter_modules(PP.__path__)} == set()
