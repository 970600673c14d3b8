"""The port's kernel modules against the JAX package's Pallas kernels.

The JAX side runs as its own tests run it on the CPU (Pallas interpret mode,
128-wide tiles); the port's wrappers get CPU tensors and therefore run their
plain PyTorch versions. Inputs are made with numpy and cross as numpy
arrays. The CUDA kernels themselves run only on a card: their tests are in
test_torch_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointcloud_stitching_tpu.kernels.nn_pallas import (
    nearest_neighbors_pallas_batched as jax_nn_batched)
from pointcloud_stitching_tpu.kernels.segment_reduce import (
    segment_sum_from_flags as jax_segsum_flags,
    segment_sum_sorted as jax_segsum_sorted)
from pointcloud_stitching_tpu_torch.kernels import build as kb
from pointcloud_stitching_tpu_torch.kernels.nn_pallas import (
    NN_MAX_SPLITS, NN_QUERY_TILE, H100_SMS, nearest_neighbors_pallas,
    nearest_neighbors_pallas_batched, nn_batched_prepared, nn_splits,
    prepare_ref_batched)
from pointcloud_stitching_tpu_torch.kernels.segment_reduce import (
    segment_sum_from_flags, segment_sum_sorted)


@pytest.fixture
def rng():
    """A fresh generator per test: the suite-wide one of conftest.py
    would make each test's inputs depend on the tests that ran before."""
    return np.random.default_rng(1234)


def _segment_inputs(rng, n, n_int, n_f32, p_flag=0.3, lead_zero=3):
    """Sorted-segment inputs: boundary flags (the first rows unflagged,
    so they carry id -1 and drop) and [n, n_int + n_f32] values whose first
    n_int channels are integers, as the packed voxel branch feeds them."""
    flags = rng.random(n) < p_flag
    flags[:lead_zero] = False
    ints = rng.integers(0, 1024, size=(n, n_int)).astype(np.float32)
    f32 = rng.normal(size=(n, n_f32)).astype(np.float32)
    return flags, np.concatenate([ints, f32], axis=1)


def _assert_sums(got, want, n_int):
    np.testing.assert_array_equal(got[:, :n_int], want[:, :n_int])
    np.testing.assert_allclose(got[:, n_int:], want[:, n_int:], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,capacity,n_int,n_f32", [
    (1000, 256, 7, 0), (3000, 2048, 4, 3), (700, 64, 3, 4), (130, 1000, 1, 3)])
def test_segment_sum_from_flags_matches_jax(rng, n, capacity, n_int, n_f32):
    flags, vals = _segment_inputs(rng, n, n_int, n_f32)
    want = np.asarray(jax_segsum_flags(
        jnp.asarray(vals), jnp.asarray(flags), capacity, chunk=128,
        interpret=True, precision="highest"))
    got = segment_sum_from_flags(torch.from_numpy(vals),
                                 torch.from_numpy(flags), capacity)
    _assert_sums(got.numpy(), want, n_int)


def _sorted_seg(rng, n, capacity, discard_frac=0.1):
    # unit-increment ids (a cumsum of boundaries), then a discard tail
    seg = np.cumsum(rng.random(n) < 0.4).astype(np.int32) - 1
    seg = np.clip(seg, 0, capacity - 1)
    seg[int(n * (1 - discard_frac)):] = capacity
    return seg


@pytest.mark.parametrize("n,capacity,n_int,n_f32", [
    (1000, 256, 4, 3), (5000, 4096, 7, 0), (512, 512, 1, 6), (130, 1000, 3, 4)])
def test_segment_sum_sorted_matches_jax(rng, n, capacity, n_int, n_f32):
    seg = _sorted_seg(rng, n, capacity)
    _, vals = _segment_inputs(rng, n, n_int, n_f32)
    vals[seg == capacity] = 0.0
    want = np.asarray(jax_segsum_sorted(jnp.asarray(vals), jnp.asarray(seg),
                                        capacity, chunk=128, interpret=True))
    got = segment_sum_sorted(torch.from_numpy(vals), torch.from_numpy(seg),
                             capacity)
    _assert_sums(got.numpy(), want, n_int)


def test_sorted_sum_long_discard_suffix_matches_jax():
    """K2's plain version against the JAX kernel on the flat multi-camera
    layout, each camera ending in a discard run over many 128-row chunks."""
    rng = np.random.default_rng(70)
    cap_cam, segs = 64, []
    for c in range(3):
        s = np.cumsum(rng.random(1500) < 0.5) - 1
        segs.append(np.minimum(s, cap_cam) + c * (cap_cam + 1))
    seg = np.concatenate(segs).astype(np.int32)
    capacity = 3 * (cap_cam + 1)
    assert (seg % (cap_cam + 1) == cap_cam).sum() > 3 * 10 * 128
    vals = rng.normal(size=(seg.size, 7)).astype(np.float32)
    want = np.asarray(jax_segsum_sorted(jnp.asarray(vals), jnp.asarray(seg),
                                        capacity, chunk=128, interpret=True))
    got = segment_sum_sorted(torch.from_numpy(vals), torch.from_numpy(seg),
                             capacity)
    # JAX adds in float32, the port in float64: the discard sums (some 1400
    # rows each) differ in float32 rounding
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,n,m", [(1, 131072, 8192), (1, 131072, 131072),
                                   (8, 2048, 2048), (3, 700, 1001),
                                   (2, 100, 5), (1, 1, 3), (1, 3000, 3000),
                                   (264, 10, 50)])
def test_nn_splits(b, n, m):
    """S = 1 where the query tiles fill the card (the registration shapes),
    S >= 2 at the ring shape, and every one of the S slices
    [m k / S, m (k + 1) / S) holds a reference."""
    s = nn_splits(b, n, m)
    assert 1 <= s <= min(NN_MAX_SPLITS, m)
    tiles = b * -(-n // NN_QUERY_TILE)
    if tiles >= H100_SMS or (b, n) == (1, 131072):
        assert s == 1
    if (b, n, m) == (8, 2048, 2048):
        assert s >= 2 and s * tiles > 64
    bounds = [m * k // s for k in range(s + 1)]
    assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("b,n,m,masked", [(3, 200, 300, 0.1), (2, 130, 700, 0.0),
                                          (8, 256, 256, 0.3)])
def test_nn_batched_matches_jax(rng, b, n, m, masked):
    q = rng.normal(size=(b, n, 3)).astype(np.float32)
    r = rng.normal(size=(b, m, 3)).astype(np.float32)
    mask = rng.random((b, m)) >= masked
    wi, wd = jax_nn_batched(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask),
                            query_tile=128, ref_block=128, interpret=True)
    gi, gd = nearest_neighbors_pallas_batched(
        torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(mask))
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)
    assert mask[np.arange(b)[:, None], gi.numpy()].all()


def test_nn_tie_breaks_to_first_like_jax():
    q = np.zeros((1, 3), np.float32)
    r = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0]], np.float32)  # all d2=1
    wi, _ = jax_nn_batched(jnp.asarray(q[None]), jnp.asarray(r[None]),
                           query_tile=128, ref_block=128, interpret=True)
    gi, gd = nearest_neighbors_pallas(torch.from_numpy(q), torch.from_numpy(r))
    assert int(np.asarray(wi)[0, 0]) == 0 and int(gi[0]) == 0
    assert float(gd[0]) == 1.0


def test_nn_masked_refs_never_match():
    q = np.zeros((4, 3), np.float32)
    r = np.array([[0.01, 0, 0], [5, 5, 5]], np.float32)
    mask = np.array([False, True])
    gi, gd = nearest_neighbors_pallas(torch.from_numpy(q), torch.from_numpy(r),
                                      torch.from_numpy(mask))
    assert (gi.numpy() == 1).all()
    np.testing.assert_allclose(gd.numpy(), 75.0, rtol=1e-6)


def test_wrappers_take_plain_versions_for_cpu_tensors(rng):
    """On the CPU the wrappers run their plain versions and count no
    launch; asking for the kernels with CPU tensors raises."""
    kb.reset_launches()
    vals = torch.ones((10, 2))
    flags = torch.zeros(10, dtype=torch.bool)
    flags[[0, 4]] = True
    seg = torch.tensor([0] * 4 + [1] * 6, dtype=torch.int32)
    want = torch.tensor([[4.0, 4.0], [6.0, 6.0]])
    assert torch.equal(segment_sum_from_flags(vals, flags, 2), want)
    assert torch.equal(segment_sum_sorted(vals, seg, 2, impl="torch"), want)
    refT = prepare_ref_batched(torch.zeros((1, 5, 3)), None)
    nn_batched_prepared(torch.zeros((1, 3, 3)), refT)
    assert not kb.LAUNCHES
    for call in (lambda: segment_sum_from_flags(vals, flags, 2, impl="cuda"),
                 lambda: segment_sum_sorted(vals, seg, 2, impl="cuda"),
                 lambda: nn_batched_prepared(torch.zeros((1, 3, 3)), refT,
                                             impl="cuda"),
                 lambda: segment_sum_sorted(vals, seg, 2, impl="pallas")):
        with pytest.raises(ValueError):
            call()


def test_wrappers_check_shapes():
    with pytest.raises(ValueError):
        segment_sum_sorted(torch.ones((4, 17)), torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        segment_sum_from_flags(torch.ones((4, 2)), torch.zeros(5, dtype=torch.bool), 2)
    with pytest.raises(ValueError):
        nn_batched_prepared(torch.zeros((1, 3, 3)), torch.zeros((1, 5, 3)))


def test_build_key_covers_every_source():
    for name in kb.SOURCES:
        assert (kb.CSRC / name).is_file()
    assert kb._key() == kb._key()
    assert "arch=compute_90a,code=sm_90a" in kb.NVCC_FLAGS
