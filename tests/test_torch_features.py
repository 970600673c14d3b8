"""The port's feature ops against the JAX package's.

Covers ``ops/sweep.py`` (``blockwise_accumulate``), ``ops/search.py``,
``ops/mls.py`` (the moments engine, normals, curvature, MLS smoothing),
``ops/fpfh.py`` (descriptors and matching), ``ops/keypoints.py`` (ISS) and
``ops/vfh.py``. Inputs are made with numpy from a generator per test and
cross as numpy arrays; the port gets CPU tensors. JAX runs on the CPU as
the rest of the suite runs it; none of these functions reaches a Pallas
kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu import PointCloud as JPointCloud
import pointcloud_stitching_tpu.ops as J
from pointcloud_stitching_tpu.ops import mls as JM
from pointcloud_stitching_tpu.ops import sweep as JS
from pointcloud_stitching_tpu_torch import PointCloud
import pointcloud_stitching_tpu_torch.ops as P
from pointcloud_stitching_tpu_torch.ops import mls as PM
from pointcloud_stitching_tpu_torch.ops import sweep as PS
from test_fpfh import _bumpy_surface
from test_keypoints import _box_edges_scene

# (query_tile, ref_tile): the JAX sweep's tiles, and two tilings of the
# port's chunks (16 x 64 x CHUNK_TILES pairs: 51 queries a chunk at 1280
# points; the defaults: one chunk)
TILINGS = [(16, 64), (512, 1024)]


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _clouds(xyz, mask):
    return (JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)),
            PointCloud(xyz=t(xyz), mask=t(mask)))


def _surface(seed, npts=1280, masked=0.1):
    xyz, nrm = _bumpy_surface(seed=seed, n=npts)
    mask = np.random.default_rng(seed).random(npts) > masked
    return xyz, nrm, mask


# --- the sweep loop and the moments engine -----------------------------------

@pytest.mark.parametrize("tiles", TILINGS)
def test_blockwise_accumulate_matches_jax(tiles):
    """A step with a float and an integer accumulator and a ridden-along
    extra: the port (chunks against every reference) equals the JAX
    package (tiles against tiles) to float32 summation order."""
    xyz, _, mask = _surface(seed=40)
    wts = np.random.default_rng(41).uniform(0.5, 2.0, len(xyz)).astype(
        np.float32)

    def step(lib):
        def f(q, qv, qe, r, rv, re):
            d = q[:, None, :] - r[None, :, :]
            d2 = (d * d).sum(-1)
            inside = (d2 <= 0.04) & qv[:, None] & rv[None, :]
            w = lib.where(inside, re[0][None, :] * qe[0][:, None], 0.0)
            return w.sum(1), inside.sum(1)
        return f

    want = JS.blockwise_accumulate(jnp.asarray(xyz), jnp.asarray(mask),
                                   [jnp.asarray(wts)], 128, 256, step(jnp))
    got = PS.blockwise_accumulate(t(xyz), t(mask), [t(wts)], *tiles,
                                  step(torch))
    np.testing.assert_allclose(n(got[0]), n(want[0]), rtol=1e-5)
    np.testing.assert_array_equal(n(got[1]), n(want[1]))
    assert got[0].shape == (len(xyz),)


@pytest.mark.parametrize("tiles", TILINGS)
def test_radius_moments_match_jax(tiles):
    """The query-centred moments at two tilings: rtol 1e-5 (atol 1e-7 m
    for first and second moments that cancel to ~0)."""
    xyz, _, mask = _surface(seed=42)
    want = JM._radius_moments(jnp.asarray(xyz), jnp.asarray(mask), 0.15,
                              0.15 ** 2, 128, 256)
    got = PM._radius_moments(t(xyz), t(mask), 0.15, 0.15 ** 2, *tiles)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(n(g), n(w), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(n(got[3]), n(want[3]))


def test_port_tilings_agree():
    """Within the port the tiling moves results by float32 summation
    order only."""
    xyz, _, mask = _surface(seed=43)
    a = PM._radius_moments(t(xyz), t(mask), 0.15, 0.02, *TILINGS[0])
    b = PM._radius_moments(t(xyz), t(mask), 0.15, 0.02, *TILINGS[1])
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_allclose(n(x), n(y), rtol=1e-5, atol=1e-7)
    assert torch.equal(a[3], b[3])


# --- k-NN and radius search --------------------------------------------------

def _search_scene(seed):
    """Queries and references with exact ties (duplicated references, and
    queries sitting midway between two references), masked references and
    masked queries."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(300, 3)).astype(np.float32)
    r = rng.normal(size=(700, 3)).astype(np.float32)
    r[600:650] = r[100:150]                      # duplicates: equal d2
    q[:20] = r[200:220]
    q[20:40] = 0.5 * (r[300:320] + r[400:420])   # equidistant pairs
    rmask = rng.random(700) > 0.1
    rmask[100:150] = rmask[600:650] = True
    qmask = rng.random(300) > 0.05
    return q, r, rmask, qmask


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_search_matches_jax(exclude_self):
    """idx equal (of equal distances the lower index first, as lax.top_k
    merges tiles), d2 within 1e-6; -1 / +inf for masked queries."""
    q, r, rmask, qmask = _search_scene(50 + exclude_self)
    if exclude_self:
        q, qmask = r[:300], rmask[:300]
    jq, pq = _clouds(q, qmask)
    jr, pr = _clouds(r, rmask)
    kw = dict(k=9, exclude_self=exclude_self)
    wd2, widx = J.knn_search(jq, jr, query_tile=128, ref_tile=256, **kw)
    gd2, gidx = P.knn_search(pq, pr, query_tile=16, ref_tile=64, **kw)
    np.testing.assert_array_equal(n(gidx), n(widx))
    fin = np.isfinite(n(wd2))
    np.testing.assert_array_equal(np.isfinite(n(gd2)), fin)
    np.testing.assert_allclose(n(gd2)[fin], n(wd2)[fin], atol=1e-6)
    assert (n(gidx)[~qmask] == -1).all()
    assert gidx.dtype == torch.int32


def test_knn_more_neighbours_than_references():
    q, r, _, _ = _search_scene(52)
    rmask = np.zeros(700, bool)
    rmask[:5] = True
    jq, pq = _clouds(q, np.ones(300, bool))
    jr, pr = _clouds(r[:6], rmask[:6])
    wd2, widx = J.knn_search(jq, jr, 8)
    gd2, gidx = P.knn_search(pq, pr, 8)
    np.testing.assert_array_equal(n(gidx), n(widx))
    assert (n(gidx)[:, 5:] == -1).all() and np.isinf(n(gd2)[:, 5:]).all()


def test_radius_search_matches_jax():
    q, r, rmask, qmask = _search_scene(53)
    jq, pq = _clouds(q, qmask)
    jr, pr = _clouds(r, rmask)
    want = J.radius_search(jq, jr, 0.45, 6)
    got = P.radius_search(pq, pr, 0.45, 6)
    np.testing.assert_array_equal(n(got[1]), n(want[1]))
    np.testing.assert_array_equal(n(got[2]), n(want[2]))
    fin = np.isfinite(n(want[0]))
    np.testing.assert_allclose(n(got[0])[fin], n(want[0])[fin], atol=1e-6)
    assert 0 < int(got[2].sum()) < 6 * 300
    with pytest.raises(ValueError, match="max_nn"):
        P.radius_search(pq, pr, 0.45, 0)


# --- MLS: normals, curvature, smoothing --------------------------------------

def _eigengap(xyz, mask, radius):
    """Per point, the gap between the two smallest eigenvalues of the
    (JAX package's) weighted covariance, relative to the largest."""
    sw, swd, swddt, _ = JM._radius_moments(
        jnp.asarray(xyz), jnp.asarray(mask), radius, radius ** 2, 128, 256)
    denom = np.maximum(n(sw), 1e-12)[:, None]
    md = n(swd) / denom
    cov = n(swddt) / denom[..., None] - md[:, :, None] * md[:, None, :]
    vals = np.linalg.eigvalsh(cov.astype(np.float64))
    return (vals[:, 1] - vals[:, 0]) / np.maximum(vals[:, 2], 1e-30)


@pytest.mark.parametrize("offset", [0.0, 60.0])
def test_normals_curvature_mls_match_jax(offset):
    """``estimate_normals``/``estimate_curvature``/``mls_smooth`` against
    JAX: validity equal; |n . n_jax| >= 1 - 1e-5 where the eigengap is
    clear (> 1e-3 of the largest eigenvalue); curvature within 1e-5;
    smoothed positions within 1e-6 m. At 60 m out the query-centred
    moments keep that (positions within one float32 ulp at 60 m)."""
    xyz, _, mask = _surface(seed=44)
    xyz = (xyz + np.float32(offset)).astype(np.float32)
    vp = (offset, offset, offset + 5.0)
    jp, pp = _clouds(xyz, mask)
    wn, wok = J.estimate_normals(jp, 0.15, viewpoint=vp)
    gn, gok = P.estimate_normals(pp, 0.15, viewpoint=vp)
    np.testing.assert_array_equal(n(gok), n(wok))
    clear = n(gok) & (_eigengap(xyz, mask, 0.15) > 1e-3)
    assert clear.sum() > 0.8 * mask.sum()
    dots = (n(gn) * n(wn)).sum(-1)
    assert dots[clear].min() >= 1 - 1e-5, dots[clear].min()
    assert (n(gn)[~n(gok)] == 0).all()

    wc, wcok = J.estimate_curvature(jp, 0.15)
    gc, gcok = P.estimate_curvature(pp, 0.15)
    np.testing.assert_array_equal(n(gcok), n(wcok))
    np.testing.assert_allclose(n(gc), n(wc), atol=1e-5)

    want = J.mls_smooth(jp, 0.15)
    got = P.mls_smooth(pp, 0.15)
    ulp = float(np.spacing(np.float32(max(offset, 1.0) + 1.0)))
    np.testing.assert_allclose(n(got.xyz), n(want.xyz),
                               atol=max(1e-6, ulp))
    assert torch.equal(got.mask, pp.mask)


def test_eigh_batches_equal_one_call(monkeypatch):
    """``utils/linalg.py`` cuts the per-point eigendecompositions into
    batches (cuSOLVER's batched syev refuses 32,768 3x3 matrices): cut into
    batches of 100 the normals and curvature equal one call bit for bit."""
    from pointcloud_stitching_tpu_torch.utils import linalg
    xyz, _, mask = _surface(seed=67, npts=700)
    pp = PointCloud(xyz=t(xyz), mask=t(mask))
    want = P.estimate_normals(pp, 0.15), P.estimate_curvature(pp, 0.15)
    monkeypatch.setattr(linalg, "EIGH_BATCH", 100)
    got = P.estimate_normals(pp, 0.15), P.estimate_curvature(pp, 0.15)
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


def test_mls_smooth_batched_matches_jax():
    """Camera-batched [B, N, 3] clouds smooth camera by camera."""
    xyz = np.stack([_surface(seed=s, npts=400)[0] for s in (45, 46)])
    mask = np.random.default_rng(47).random((2, 400)) > 0.1
    jp, pp = _clouds(xyz, mask)
    want = J.mls_smooth(jp, 0.2, min_neighbors=4)
    got = P.mls_smooth(pp, 0.2, min_neighbors=4)
    np.testing.assert_allclose(n(got.xyz), n(want.xyz), atol=1e-6)


# --- FPFH --------------------------------------------------------------------

def test_fpfh_matches_jax():
    """ok equal, descriptors within atol 5e-3 (as tests/test_fpfh.py holds
    JAX against its numpy oracle); the port bins 0/1 weights by index."""
    xyz, nrm, mask = _surface(seed=48, npts=900)
    nvalid = np.random.default_rng(49).random(len(xyz)) > 0.05
    jp, pp = _clouds(xyz, mask)
    want, wok = J.fpfh(jp, jnp.asarray(nrm), jnp.asarray(nvalid),
                       radius=0.25)
    got, gok = P.fpfh(pp, t(nrm), t(nvalid), radius=0.25, query_tile=16,
                      ref_tile=64)
    np.testing.assert_array_equal(n(gok), n(wok))
    assert n(gok).sum() > 0.5 * len(xyz)
    np.testing.assert_allclose(n(got), n(want), atol=5e-3)
    sums = n(got)[n(gok)].reshape(-1, 3, 11).sum(-1)
    np.testing.assert_allclose(sums, 100.0, rtol=1e-5)


def _descriptor_scene(seed):
    """Descriptors with exact duplicates in B (equal distances), invalid
    rows on both sides."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 100, (300, 33)).astype(np.float32)
    b = rng.uniform(0, 100, (400, 33)).astype(np.float32)
    b[350:400] = b[10:60]
    a[:30] = b[10:40] + rng.normal(0, 1.0, (30, 33)).astype(np.float32)
    ok_a = rng.random(300) > 0.1
    ok_b = rng.random(400) > 0.1
    ok_b[10:60] = ok_b[350:400] = True
    return a, ok_a, b, ok_b


@pytest.mark.parametrize("k", [1, 4])
def test_match_fpfh_matches_jax(k):
    """idx equal; of two equal descriptors the lower index comes first;
    invalid A rows get the 1e12 sentinel."""
    a, ok_a, b, ok_b = _descriptor_scene(60 + k)
    wi, wd = J.match_fpfh(jnp.asarray(a), jnp.asarray(ok_a), jnp.asarray(b),
                          jnp.asarray(ok_b), k=k, query_tile=128,
                          ref_tile=128)
    gi, gd = P.match_fpfh(t(a), t(ok_a), t(b), t(ok_b), k=k, query_tile=16,
                          ref_tile=64)
    np.testing.assert_array_equal(n(gi), n(wi))
    np.testing.assert_allclose(n(gd), n(wd), rtol=1e-5, atol=0.05)
    assert (n(gi)[:30, 0] == np.arange(10, 40)).all()
    assert (n(gd)[~ok_a] == np.float32(1e12)).all()


def test_match_fpfh_unmatched_slots():
    """Fewer valid B rows than k: the slots left over hold index 0 and the
    sentinel, as the JAX package's running top-k leaves them."""
    a, ok_a, b, _ = _descriptor_scene(63)
    ok_b = np.zeros(400, bool)
    ok_b[[7, 300]] = True
    wi, wd = J.match_fpfh(jnp.asarray(a), jnp.asarray(ok_a), jnp.asarray(b),
                          jnp.asarray(ok_b), k=4)
    gi, gd = P.match_fpfh(t(a), t(ok_a), t(b), t(ok_b), k=4)
    np.testing.assert_array_equal(n(gi), n(wi))
    assert (n(gi)[:, 2:] == 0).all()
    assert (n(gd)[:, 2:] == np.float32(1e12)).all()


# --- ISS keypoints and VFH ---------------------------------------------------

@pytest.mark.parametrize("scene", ["box", "surface"])
def test_iss_keypoints_match_jax(scene):
    """Keypoint mask equal; saliency within 1e-7 (float32 of ~1e-4 m^2)."""
    if scene == "box":
        xyz = _box_edges_scene()
        mask = np.ones(len(xyz), bool)
        kw = dict(salient_radius=0.1, non_max_radius=0.08)
    else:
        xyz, _, mask = _surface(seed=64, npts=900)
        kw = dict(salient_radius=0.2)
    jp, pp = _clouds(xyz, mask)
    wk, ws = J.iss_keypoints(jp, **kw)
    gk, gs = P.iss_keypoints(pp, query_tile=16, ref_tile=64, **kw)
    np.testing.assert_array_equal(n(gk), n(wk))
    assert 0 < int(gk.sum()) < len(xyz) // 4
    np.testing.assert_allclose(n(gs), n(ws), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("valid", ["all", "some"])
def test_vfh_matches_jax(valid):
    xyz, nrm, _ = _surface(seed=65, npts=700)
    rng = np.random.default_rng(66)
    mask = np.ones(700, bool) if valid == "all" else rng.random(700) > 0.3
    nvalid = None if valid == "all" else rng.random(700) > 0.1
    jp, pp = _clouds(xyz, mask)
    vp = (0.3, -0.2, 2.0)
    want, wok = J.vfh(jp, jnp.asarray(nrm),
                      None if nvalid is None else jnp.asarray(nvalid),
                      viewpoint=vp)
    got, gok = P.vfh(pp, t(nrm), None if nvalid is None else t(nvalid),
                     viewpoint=vp)
    assert bool(gok) == bool(wok)
    np.testing.assert_allclose(n(got), n(want), atol=5e-3)
    assert got.shape == (308,)
