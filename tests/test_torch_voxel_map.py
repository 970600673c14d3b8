"""The port's temporal voxel map and change detection against the JAX
package's.

Both sides get the same numpy clouds. The JAX map runs its XLA reduction
(and, in one case, its Pallas K1 in interpret mode); the port's tensors lie
on the CPU, so K1 takes its plain version. Maps cross as numpy arrays
(``utils.convert.voxel_map_from_numpy``) and as ``.npz`` checkpoints.

Tolerances: the occupied voxel set (``ijk``) is equal. Sums, weights and
colour sums are within rtol 1e-6 / atol 1e-5 of JAX's (the port adds each
voxel's rows in float64 and rounds once, the JAX package adds in float32)
and within tests/test_voxel_map.py's oracle tolerance (atol 2e-4). The
decays used keep every weight off the ``min_weight`` eviction boundary, so
float32 and float64 evict the same voxels. Change masks are equal: they
answer a set question.
"""
import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu.models import voxel_map as JV
from pointcloud_stitching_tpu.ops.change import (
    detect_changes as jax_detect_changes,
    detect_changes_map as jax_detect_changes_map)
from pointcloud_stitching_tpu.utils.types import PointCloud as JPointCloud
from pointcloud_stitching_tpu_torch.models import voxel_map as TV
from pointcloud_stitching_tpu_torch.ops.change import (detect_changes,
                                                       detect_changes_map)
from pointcloud_stitching_tpu_torch.utils.convert import voxel_map_from_numpy
from pointcloud_stitching_tpu_torch.utils.types import PointCloud
from oracle import random_se3, transform_np
from test_voxel_map import assert_maps_match, oracle_update

CPU = torch.device("cpu")
RTOL, ATOL = 1e-6, 1e-5
FIELDS = ("ijk", "sums", "weight", "leaf", "rgb_sums")


def _clouds(xyz, rgb=None, capacity=None, mask=None):
    """(JAX cloud, port cloud) of the same padded numpy points."""
    xyz = np.asarray(xyz, np.float32)
    rgb = None if rgb is None else np.asarray(rgb, np.float32)
    j = JPointCloud.from_points(xyz, rgb=rgb, capacity=capacity)
    t = PointCloud.from_points(xyz, rgb=rgb, capacity=capacity)
    if mask is not None:
        j = j.replace(mask=j.mask & np.asarray(mask))
        t = t.replace(mask=t.mask & torch.from_numpy(np.asarray(mask)))
    return j, t


def _maps(capacity, leaf, with_rgb=False):
    return (JV.VoxelMap.create(capacity, leaf=leaf, with_rgb=with_rgb),
            TV.VoxelMap.create(capacity, leaf, with_rgb=with_rgb,
                               device=CPU))


def _arrays(m):
    return {k: (None if getattr(m, k) is None else np.asarray(getattr(m, k)))
            for k in FIELDS}


def _assert_same_map(jm, tm):
    a, b = _arrays(jm), _arrays(tm)
    np.testing.assert_array_equal(b["ijk"], a["ijk"])
    assert b["leaf"] == a["leaf"]
    assert (a["rgb_sums"] is None) == (b["rgb_sums"] is None)
    for k in ("sums", "weight", "rgb_sums"):
        if a[k] is not None:
            assert b[k].dtype == np.float32
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL)


def _frames(rng, n_frames, n, scale=1.5, with_rgb=False):
    return [(rng.uniform(-scale, scale, (n, 3)),
             rng.integers(0, 256, (n, 3)).astype(np.float32)
             if with_rgb else None) for _ in range(n_frames)]


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,interpret", [("xla", False), ("pallas", True)])
def test_single_update_matches_jax(impl, interpret):
    rng = np.random.default_rng(701)
    xyz = rng.uniform(-2, 2, (800, 3))
    jm, tm = _maps(4096, 0.25)
    jc, tc = _clouds(xyz, capacity=1024)
    jm = JV.voxel_map_update(jm, jc, impl=impl, interpret=interpret)
    tm = TV.voxel_map_update(tm, tc)
    _assert_same_map(jm, tm)
    assert_maps_match(tm, oracle_update({}, xyz, 0.25))
    assert int(tm.count()) == int(jm.count())


def test_decay_eviction_until_empty_matches_jax():
    """Three updates with decay and eviction, then empty clouds until every
    voxel is evicted; the maps agree after every update."""
    rng = np.random.default_rng(702)
    leaf, decay, min_w = 0.2, 0.6, 0.05
    jm, tm = _maps(4096, leaf)
    state = {}
    for xyz, _ in _frames(rng, 3, 500):
        jc, tc = _clouds(xyz, capacity=640)
        jm = JV.voxel_map_update(jm, jc, decay=decay, min_weight=min_w)
        tm = TV.voxel_map_update(tm, tc, decay=decay, min_weight=min_w)
        state = oracle_update(state, xyz, leaf, decay=decay, min_weight=min_w)
        _assert_same_map(jm, tm)
    assert_maps_match(tm, state)
    jc, tc = _clouds(np.zeros((0, 3)), capacity=640)
    counts = []
    for _ in range(12):
        jm = JV.voxel_map_update(jm, jc, decay=decay, min_weight=min_w)
        tm = TV.voxel_map_update(tm, tc, decay=decay, min_weight=min_w)
        state = oracle_update(state, np.zeros((0, 3)), leaf, decay=decay,
                              min_weight=min_w)
        _assert_same_map(jm, tm)
        counts.append(int(tm.count()))
    assert_maps_match(tm, state)
    assert counts[0] > counts[4] > 0 and counts[-1] == 0 and not state


def test_rgb_and_max_weight_match_jax():
    rng = np.random.default_rng(703)
    leaf, max_w = 0.3, 2.5
    jm, tm = _maps(2048, leaf, with_rgb=True)
    state = {}
    for xyz, rgb in _frames(rng, 5, 400, with_rgb=True):
        jc, tc = _clouds(xyz, rgb=rgb, capacity=512)
        jm = JV.voxel_map_update(jm, jc, max_weight=max_w)
        tm = TV.voxel_map_update(tm, tc, max_weight=max_w)
        state = oracle_update(state, xyz, leaf, rgb=rgb, max_weight=max_w)
        _assert_same_map(jm, tm)
    assert_maps_match(tm, state)
    assert float(tm.weight.max()) <= max_w + 1e-5
    # rescaled weights keep the mean: centroids and colours as JAX's
    jp, tp = jm.as_cloud(), tm.as_cloud()
    np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    np.testing.assert_allclose(tp.xyz.numpy(), np.asarray(jp.xyz),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp.rgb.numpy(), np.asarray(jp.rgb),
                               rtol=RTOL, atol=1e-4)


def test_capacity_truncation_matches_jax():
    rng = np.random.default_rng(704)
    xyz = rng.uniform(-2, 2, (600, 3))
    jm, tm = _maps(32, 0.1)
    jc, tc = _clouds(xyz, capacity=640)
    jm = JV.voxel_map_update(jm, jc)
    tm = TV.voxel_map_update(tm, tc)
    _assert_same_map(jm, tm)
    assert_maps_match(tm, oracle_update({}, xyz, 0.1, capacity=32))
    assert int(tm.count()) == 32


def test_out_of_bounds_and_masked_points_dropped():
    xyz = np.array([[0.0, 0.0, 0.0], [1e5, 0.0, 0.0], [0.0, -1e5, 0.0],
                    [0.5, 0.5, 0.5]])
    mask = np.array([True, True, True, False])
    jm, tm = _maps(64, 0.1)
    jc, tc = _clouds(xyz, mask=mask)
    jm = JV.voxel_map_update(jm, jc)
    tm = TV.voxel_map_update(tm, tc)
    _assert_same_map(jm, tm)
    assert int(tm.count()) == 1          # only the in-bounds valid point


def test_rgb_presence_mismatch_raises():
    rng = np.random.default_rng(705)
    xyz = rng.uniform(-1, 1, (10, 3))
    _, tc = _clouds(xyz, rgb=np.zeros((10, 3)))
    with pytest.raises(ValueError, match="rgb presence"):
        TV.voxel_map_update(TV.VoxelMap.create(64, 0.1, device=CPU), tc)
    _, tc = _clouds(xyz)
    with pytest.raises(ValueError, match="rgb presence"):
        TV.voxel_map_update(TV.VoxelMap.create(64, 0.1, with_rgb=True,
                                               device=CPU), tc)


def test_tensor_scalars_equal_python_scalars():
    """decay/min_weight/max_weight as 0-d tensors (what a caller on the
    card passes to avoid host copies) give the same map bit for bit."""
    rng = np.random.default_rng(706)
    frames = _frames(rng, 3, 300, with_rgb=True)
    a = TV.VoxelMap.create(1024, 0.2, with_rgb=True, device=CPU)
    b = TV.VoxelMap.create(1024, 0.2, with_rgb=True, device=CPU)
    for xyz, rgb in frames:
        _, tc = _clouds(xyz, rgb=rgb, capacity=384)
        a = TV.voxel_map_update(a, tc, 0.7, 0.1, 1.5)
        b = TV.voxel_map_update(b, tc, torch.tensor(0.7), torch.tensor(0.1),
                                torch.tensor(1.5), impl="torch")
    for k in ("ijk", "sums", "weight", "rgb_sums"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_as_cloud_min_weight_matches_jax():
    rng = np.random.default_rng(707)
    jm, tm = _maps(1024, 0.25)
    a = rng.uniform(-1, 1, (300, 3))
    b = rng.uniform(-1, 1, (50, 3)) + 10.0
    for xyz in (a, a, b):
        jc, tc = _clouds(xyz, capacity=384)
        jm = JV.voxel_map_update(jm, jc)
        tm = TV.voxel_map_update(tm, tc)
    for mw in (0.0, 1.5, torch.tensor(1.5)):
        jp = jm.as_cloud(min_weight=float(mw))
        tp = tm.as_cloud(min_weight=mw)
        np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
        np.testing.assert_allclose(tp.xyz.numpy(), np.asarray(jp.xyz),
                                   rtol=RTOL, atol=ATOL)
    assert int(tm.as_cloud(1.5).mask.sum()) < int(tm.as_cloud().mask.sum())


def test_temporal_accumulator_matches_jax():
    rng = np.random.default_rng(708)
    jacc = JV.TemporalAccumulator(capacity=2048, leaf=0.2, decay=0.9,
                                  min_weight=0.05)
    tacc = TV.TemporalAccumulator(capacity=2048, leaf=0.2, decay=0.9,
                                  min_weight=0.05, device=CPU)
    state = {}
    for xyz, _ in _frames(rng, 4, 300):
        jc, tc = _clouds(xyz, capacity=384)
        jacc.update(jc)
        tacc.update(tc)
        state = oracle_update(state, xyz, 0.2, decay=0.9)
    _assert_same_map(jacc.state, tacc.state)
    assert_maps_match(tacc.state, state)
    assert int(tacc.cloud().mask.sum()) == len(state)
    assert tacc.state.device == CPU


def test_voxel_map_from_numpy_carries_state():
    rng = np.random.default_rng(709)
    jm, _ = _maps(512, 0.1, with_rgb=True)
    jc, _ = _clouds(rng.uniform(-1, 1, (200, 3)),
                    rgb=rng.uniform(0, 255, (200, 3)))
    jm = JV.voxel_map_update(jm, jc)
    tm = voxel_map_from_numpy(_arrays(jm), CPU)
    for k, v in _arrays(jm).items():
        got = getattr(tm, k).numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v)
    assert tm.capacity == 512 and tm.leaf.dim() == 0
    # the carried state updates as the JAX map does
    jc, tc = _clouds(rng.uniform(-1, 1, (200, 3)),
                     rgb=rng.uniform(0, 255, (200, 3)))
    _assert_same_map(JV.voxel_map_update(jm, jc),
                     TV.voxel_map_update(tm, tc))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_rgb", [False, True])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, with_rgb):
    """JAX save_map -> port load_map; one more update on each side."""
    rng = np.random.default_rng(710)
    frames = _frames(rng, 3, 300, scale=1.0, with_rgb=with_rgb)
    jm, _ = _maps(2048, 0.1, with_rgb=with_rgb)
    for xyz, rgb in frames[:2]:
        jm = JV.voxel_map_update(jm, _clouds(xyz, rgb, 512)[0], decay=0.9)
    path = str(tmp_path / "ckpt")          # no extension: .npz is added
    JV.save_map(path, jm)
    tm = TV.load_map(path, device=CPU)
    for k, v in _arrays(jm).items():
        assert (v is None) == (getattr(tm, k) is None)
        if v is not None:
            np.testing.assert_array_equal(getattr(tm, k).numpy(), v)
    xyz, rgb = frames[2]
    jc, tc = _clouds(xyz, rgb, 512)
    _assert_same_map(JV.voxel_map_update(jm, jc, decay=0.9),
                     TV.voxel_map_update(tm, tc, decay=0.9))


def test_port_checkpoint_loads_in_jax(tmp_path):
    rng = np.random.default_rng(711)
    tacc = TV.TemporalAccumulator(capacity=1024, leaf=0.1, with_rgb=True,
                                  device=CPU)
    xyz, rgb = rng.uniform(-1, 1, (200, 3)), rng.uniform(0, 255, (200, 3))
    tacc.update(_clouds(xyz, rgb, 256)[1])
    path = str(tmp_path / "acc.npz")
    tacc.save(path)
    jm = JV.load_map(path)
    for k, v in _arrays(tacc.state).items():
        np.testing.assert_array_equal(np.asarray(getattr(jm, k)), v)
    resumed = TV.TemporalAccumulator.load(path, device=CPU)
    resumed.update(_clouds(xyz, rgb, 256)[1])
    assert int(resumed.state.count()) == int(tacc.state.count())


def test_load_map_resize_matches_jax(tmp_path):
    """capacity= on load: grow pads with empty slots, shrink keeps the
    highest-weight voxels; both as the JAX package loads them."""
    rng = np.random.default_rng(712)
    jm, _ = _maps(512, 0.1)
    base = rng.uniform(-1, 1, (200, 3))
    jm = JV.voxel_map_update(jm, _clouds(base, capacity=256)[0])
    jm = JV.voxel_map_update(jm, _clouds(base[:100], capacity=256)[0])
    path = str(tmp_path / "m.npz")
    JV.save_map(path, jm)
    heavy = int(np.sum(np.asarray(jm.weight) > 1.5))
    for cap in (1024, heavy, 512):
        want = JV.load_map(path, capacity=cap)
        got = TV.load_map(path, capacity=cap, device=CPU)
        assert got.capacity == cap
        for k, v in _arrays(want).items():
            if v is not None:
                np.testing.assert_array_equal(getattr(got, k).numpy(), v)


# ---------------------------------------------------------------------------
# localization
# ---------------------------------------------------------------------------

def test_localize_recovers_transform():
    rng = np.random.default_rng(713)
    n = 1500
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    np.sin(rng.uniform(-3, 3, n))], axis=-1)
    jm, tm = _maps(2048, 0.03)
    jc, tc = _clouds(xyz, capacity=2048)
    jm = JV.voxel_map_update(jm, jc)
    tm = TV.voxel_map_update(tm, tc)
    T = random_se3(seed=7, max_angle=0.05, max_trans=0.03)
    jq, tq = _clouds(transform_np(np.linalg.inv(T), xyz), capacity=2048)
    got = TV.localize(tm, tq, iterations=15, max_corr_dist=0.2)
    want = JV.localize(jm, jq, iterations=15, max_corr_dist=0.2)
    np.testing.assert_allclose(got.T.numpy(), T, atol=0.02)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-4)
    acc = TV.TemporalAccumulator(2048, 0.03, device=CPU)
    acc.update(tc)
    torch.testing.assert_close(
        acc.localize(tq, iterations=15, max_corr_dist=0.2).T, got.T,
        rtol=0, atol=0)


# ---------------------------------------------------------------------------
# change detection
# ---------------------------------------------------------------------------

def test_detect_changes_matches_jax():
    rng = np.random.default_rng(714)
    for _ in range(4):
        nr, nq = (int(v) for v in rng.integers(50, 400, 2))
        leaf = float(rng.uniform(0.03, 0.2))
        ref_xyz = rng.uniform(-2, 2, (nr, 3))
        near = ref_xyz[rng.integers(0, nr, nq // 2)] + rng.uniform(
            -0.01, 0.01, (nq // 2, 3))
        q_xyz = np.concatenate([near, rng.uniform(-2, 2, (nq - nq // 2, 3))])
        q_xyz[0] = [1e6, 0.0, 0.0]               # off the grid: never new
        jr, tr = _clouds(ref_xyz, capacity=nr + 7, mask=np.r_[
            rng.random(nr) > 0.1, np.ones(7, bool)])
        jq, tq = _clouds(q_xyz, mask=rng.random(nq) > 0.1)
        want = np.asarray(jax_detect_changes(jr, jq, leaf))
        got = detect_changes(tr, tq, leaf)
        assert got.dtype == torch.bool and got.shape == (nq,)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < nq and not want[0]


def test_detect_changes_map_matches_jax():
    rng = np.random.default_rng(715)
    jm, tm = _maps(4096, 0.1)
    a = rng.uniform(-1, 1, (400, 3))
    for xyz in (a, a[:200]):                      # weights 2 and 1
        jc, tc = _clouds(xyz, capacity=512)
        jm = JV.voxel_map_update(jm, jc)
        tm = TV.voxel_map_update(tm, tc)
    q = np.concatenate([a[:300] + 0.02, rng.uniform(-1.5, 1.5, (200, 3))])
    jq, tq = _clouds(q, capacity=600)
    for mw in (0.0, 1.5):
        want = np.asarray(jax_detect_changes_map(jm, jq, mw))
        np.testing.assert_array_equal(
            detect_changes_map(tm, tq, mw).numpy(), want)
    assert (np.asarray(jax_detect_changes_map(jm, jq, 1.5)).sum()
            > np.asarray(jax_detect_changes_map(jm, jq, 0.0)).sum())
