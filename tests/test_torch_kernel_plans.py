"""The Python side of the port's kernel launches, on the CPU.

What a wrapper works out before it launches (how K4's ranges fall into work
items, how large its scratch is, how many blocks K1 takes, which epoch
stamps K1's look-back words) against a brute-force reckoning in numpy. The
kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu_torch.kernels import segment_reduce as SR
from pointcloud_stitching_tpu_torch.kernels.nn_pallas import (
    NN_QUERY_TILE, NN_RANGED_CHUNK, nn_ranged_chunks, nn_ranged_scratch_sizes)


def _chunks_brute_force(jlo, jhi, n, m, query_tile, ref_block, chunk):
    """Chunks per (batch row, sub-tile), one query at a time: the references
    a sub-tile stages run from the lowest to the highest reference that any
    of its queries sweeps."""
    b = jlo.shape[0]
    nsub = -(-n // NN_QUERY_TILE)
    out = np.zeros((b, nsub), np.int64)
    for bi in range(b):
        for s in range(nsub):
            lo_all, hi_all = [], []
            for q in range(s * NN_QUERY_TILE, min((s + 1) * NN_QUERY_TILE, n)):
                t = q // query_tile
                lo = min(max(int(jlo[bi, t]) * ref_block, 0), m)
                hi = min(max((int(jhi[bi, t]) + 1) * ref_block, 0), m)
                if lo < hi:
                    lo_all.append(lo)
                    hi_all.append(hi)
            if lo_all:
                out[bi, s] = -(-(max(hi_all) - min(lo_all)) // chunk)
    return out


@pytest.mark.parametrize("n,m,query_tile,ref_block,chunk", [
    (5000, 30_001, 1024, 2048, NN_RANGED_CHUNK),   # ragged tile and block
    (5000, 30_001, 128, 2048, NN_RANGED_CHUNK),    # 4 tiles per sub-tile
    (3000, 9000, 700, 1000, 300),                  # tiles straddle sub-tiles
    (512, 4096, 1024, 1024, 4096),                 # one sub-tile, one chunk
    (1, 5, 1, 2, 1),
])
def test_ranged_chunks_match_brute_force(n, m, query_tile, ref_block, chunk):
    rng = np.random.default_rng(n + m + query_tile)
    b = 3
    nq, nm = -(-n // query_tile), -(-m // ref_block)
    jlo = rng.integers(0, nm, (b, nq))
    jhi = jlo + rng.integers(0, 4, (b, nq)) * (rng.random((b, nq)) < 0.5)
    jhi[0, 0] = nm + 5                      # past the last block: clamped
    jlo[1, nq // 2] = jhi[1, nq // 2] + 1   # an empty range
    jlo[2, :], jhi[2, :] = 3, 1             # a batch row of empty ranges
    got = nn_ranged_chunks(torch.from_numpy(jlo.astype(np.int32)),
                           torch.from_numpy(jhi.astype(np.int32)), n, m,
                           query_tile, ref_block, chunk)
    want = _chunks_brute_force(jlo, jhi, n, m, query_tile, ref_block, chunk)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[2].sum()) == 0


def test_ranged_chunks_full_sweep_counts_every_chunk():
    """Every tile sweeping every block: each sub-tile has ceil(m / chunk)
    items, the bound the wrapper's scratch and the kernel's int32 offsets
    are sized for."""
    n, m, qt, rb = 4096, 10_000, 1024, 2048
    nq, nm = n // qt, -(-m // rb)
    lo = torch.zeros((2, nq), dtype=torch.int32)
    hi = torch.full((2, nq), nm - 1, dtype=torch.int32)
    got = nn_ranged_chunks(lo, hi, n, m, qt, rb)
    assert got.shape == (2, n // NN_QUERY_TILE)
    assert bool((got == -(-m // NN_RANGED_CHUNK)).all())


@pytest.mark.parametrize("b,n", [(1, 131072), (3, 5000), (2, 512), (1, 1)])
def test_ranged_scratch_sizes(b, n):
    """One key per query; offsets for every sub-tile and one past, the item
    counter, and a done counter per sub-tile."""
    keys, meta = nn_ranged_scratch_sizes(b, n)
    subtiles = sum(1 for _ in range(b) for _ in range(0, n, NN_QUERY_TILE))
    assert keys == b * n
    assert meta == (subtiles + 1) + 1 + subtiles


@pytest.mark.parametrize("n,ch,capacity", [
    (3_256_320, 7, 262_144), (0, 7, 100), (1, 1, 1), (5000, 7, 131_072),
    (1024, 16, 1024), (1025, 3, 1024), (1023, 4, 6485), (40_000, 1, 16_385)])
def test_k1_grid_matches_brute_force(n, ch, capacity):
    """A tile per 1024 rows; the floats of the slots [n, capacity), which no
    row can reach, dealt out K1_ZERO_FLOATS to a block."""
    tiles, zero_blocks = SR.k1_grid(n, ch, capacity)
    assert tiles == len(range(0, n, SR.K2_TILE_ROWS))
    unreached = [s for s in range(min(n, capacity), capacity)]
    floats = len(unreached) * ch
    assert zero_blocks == len(range(0, floats, SR.K1_ZERO_FLOATS))
    assert tiles + zero_blocks >= 1         # a launch has at least one block


def test_lookback_scratch_epochs_and_growth():
    """K1's epochs count up from 1 per scratch, a scratch is kept per
    (kernel, device, stream) and replaced by a larger, clean one when the
    tile count outgrows it, and the words are zeroed before an epoch could
    come round again. K1's count words hold one more, the run count that
    K1 on packed rows publishes."""
    dev = torch.device("cpu")
    SR._SCRATCH.clear()
    a = SR._lookback_scratch("k1", dev, 0, 10)
    assert a.tiles == 1024 and a.state.numel() == a.tiles + 3
    assert a.cstat.numel() == a.tiles + 1
    assert a.part.shape == (2, a.tiles, 16)
    assert [a.next_epoch() for _ in range(3)] == [1, 2, 3]
    assert SR._lookback_scratch("k1", dev, 0, 1024) is a
    assert SR._lookback_scratch("k1", dev, 7, 10) is not a      # a stream
    assert SR._lookback_scratch("k2", dev, 0, 10) is not a      # a kernel
    big = SR._lookback_scratch("k1", dev, 0, 5000)
    assert big is not a and big.tiles == 5000
    assert big.next_epoch() == 1 and not bool(big.state.any())
    big.state[5] = 9
    big.cstat[2] = 9
    big.epoch = SR._MAX_EPOCH
    assert big.next_epoch() == 1
    assert not bool(big.state.any()) and not bool(big.cstat.any())
    assert SR._MAX_EPOCH << 2 < 2 ** 31     # the tag fits the status word
    SR._SCRATCH.clear()
