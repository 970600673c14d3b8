"""Exact batched 1-nearest-neighbour search: kernels K3 and K4.

Port of ``pointcloud_stitching_tpu/kernels/nn_pallas.py`` (the module keeps
the reference's name so that each function has an obvious counterpart).
``prepare_ref_batched`` masks and transposes the reference cloud once per
ICP call; ``nn_batched_prepared`` runs the search against it, launching the
hand-written kernel of ``csrc/nn.cu`` for CUDA tensors and the plain
version below for CPU tensors or ``impl="torch"``. The kernel splits the
references into ``nn_splits(B, N, M)`` ascending slices, one block of a
thread-block cluster each, where the query tiles alone would leave SMs
idle.

``nearest_neighbors_pruned`` is the registration-scale search: a K3 pass
over a stride-subsampled reference bounds each query's NN distance,
``block_ranges`` turns the bounds and block bounding boxes into a range of
reference blocks per query tile, and ``nn_batched_prepared_ranged`` (K4)
sweeps only those blocks. The result equals brute force on valid queries.
K4 cuts the ranges into items of equal size (512 queries x
``NN_RANGED_CHUNK`` references), found on the device so that the host
never reads the ranges, and a persistent grid takes them from a counter;
the chunks of one query meet in a 64-bit (distance, index) key under
``atomicMin``, so the result does not depend on the schedule.

Contract (the TPU kernel's): squared distances by direct differences,
``((dx*dx) + dy*dy) + dz*dz`` in float32 with no ``|q|^2+|r|^2-2qr``
cancellation; masked references become the 1e12 sentinel and never match a
real point; on a tie the lowest reference index wins. The reference is not
padded (the kernel handles a ragged last tile), so ``idx < M`` holds without
the reference's clamp to ``num_ref - 1``; the direct form is non-negative,
so ``d2 >= 0`` needs no clamp either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .build import LAUNCHES, check, library, stream_handle, use_kernel

_FAR = 1e12  # coordinate sentinel for invalid reference points
_PLAIN_REF_BLOCK = 1024

# K3's launch shape (csrc/nn.cu): queries per block, the most reference
# splits it is given (a cluster holds up to 8 blocks, but clusters of 8
# land unevenly on the SMs: at the ring shape S = 8 runs slower than S = 7
# in chip_smoke.py's sweep of S, PERF.md), and the SMs of the H100 it
# targets.
NN_QUERY_TILE = 512
NN_MAX_SPLITS = 7
H100_SMS = 132
# K4's work items: references per item (one stage of the kernel's 1024:
# the smallest items balance the SMs best in chip_smoke.py's sweep, and
# the blocks resident on an SM hide each other's staging) and blocks of the
# persistent grid per SM (0: as many as fit, at most 8)
NN_RANGED_CHUNK = 1024
NN_RANGED_BLOCKS_PER_SM = 0


def nn_splits(b: int, n: int, m: int) -> int:
    """How many contiguous reference slices K3 sweeps in parallel.

    The query tiles of b x n queries fill ``b * ceil(n / NN_QUERY_TILE)``
    blocks. Where that is at least the card's SMs, S = 1; otherwise S is
    enough to cover the SMs about twice, at most NN_MAX_SPLITS and at most
    m, so that every slice holds a reference.
    """
    tiles = b * -(-n // NN_QUERY_TILE)
    if tiles >= H100_SMS:
        return 1
    return max(1, min(NN_MAX_SPLITS, m, -(-2 * H100_SMS // tiles)))


def prepare_ref_batched(ref: torch.Tensor,
                        ref_mask: torch.Tensor | None) -> torch.Tensor:
    """Reference [B, M, 3] (+ mask [B, M]) -> sentinel-masked [B, 3, M].

    Done once per ICP call: the reference cloud is loop-invariant."""
    if ref_mask is not None:
        ref = torch.where(ref_mask[..., None], ref, _FAR)
    return ref.transpose(1, 2).contiguous()


def _nn_plain(query: torch.Tensor, refT: torch.Tensor,
              block: int = _PLAIN_REF_BLOCK, sweeps=None):
    """Plain version: sweep reference blocks with a running (best, idx),
    first index on ties within a block, strict `<` across blocks.

    ``sweeps(j)`` -> [B, N] bool says which queries sweep block j (None:
    all of them); the others see it as +inf, which is skipping it."""
    b, n, _ = query.shape
    m = refT.shape[-1]
    best = torch.full((b, n), float("inf"), dtype=torch.float32,
                      device=query.device)
    best_idx = torch.zeros((b, n), dtype=torch.int64, device=query.device)
    for j, j0 in enumerate(range(0, m, block)):
        r = refT[:, :, j0:j0 + block]                          # [B, 3, mb]
        d2 = None
        for c in range(3):
            diff = query[..., c, None] - r[:, None, c, :]      # [B, N, mb]
            sq = diff * diff
            d2 = sq if d2 is None else d2 + sq
        if sweeps is not None:
            d2 = torch.where(sweeps(j)[..., None], d2, float("inf"))
        am = d2.argmin(dim=-1, keepdim=True)
        m_blk = d2.gather(-1, am)[..., 0]
        better = m_blk < best
        best = torch.where(better, m_blk, best)
        best_idx = torch.where(better, am[..., 0] + j0, best_idx)
    return best_idx.to(torch.int32), best


def _check_nn_args(query: torch.Tensor, refT: torch.Tensor) -> None:
    if query.dim() != 3 or query.shape[-1] != 3 or refT.dim() != 3 \
            or refT.shape[1] != 3 or refT.shape[0] != query.shape[0]:
        raise ValueError(f"query {tuple(query.shape)} / refT "
                         f"{tuple(refT.shape)}: want [B, N, 3] / [B, 3, M]")
    if query.dtype != torch.float32 or refT.dtype != torch.float32:
        raise ValueError("query and refT must be float32")
    if refT.shape[-1] < 1:
        raise ValueError("empty reference cloud")


def nn_batched_prepared(query: torch.Tensor, refT: torch.Tensor,
                        impl: str = "auto"):
    """Batched NN of query [B, N, 3] against a prepared reference
    [B, 3, M] (see prepare_ref_batched). Returns (idx [B, N] int32,
    d2 [B, N] float32)."""
    _check_nn_args(query, refT)
    b, n, _ = query.shape
    m = refT.shape[-1]
    if not use_kernel(impl, query):
        return _nn_plain(query, refT)

    if refT.device != query.device:
        raise ValueError("query and refT must be on one device")
    query = query.contiguous()
    refT = refT.contiguous()
    idx = torch.empty((b, n), dtype=torch.int32, device=query.device)
    d2 = torch.empty((b, n), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        err = library().pcs_nn_batched(
            query.data_ptr(), refT.data_ptr(), b, n, m, nn_splits(b, n, m),
            idx.data_ptr(), d2.data_ptr(), stream_handle(query))
    check(err, "nn_batched_prepared")
    LAUNCHES["nn_batched_prepared"] += 1
    return idx, d2


def nearest_neighbors_pallas_batched(query: torch.Tensor, ref: torch.Tensor,
                                     ref_mask: torch.Tensor | None = None,
                                     impl: str = "auto"):
    """Batched NN: query [B, N, 3] vs ref [B, M, 3] pairwise per batch row."""
    return nn_batched_prepared(query, prepare_ref_batched(ref, ref_mask),
                               impl=impl)


def nearest_neighbors_pallas(query: torch.Tensor, ref: torch.Tensor,
                             ref_mask: torch.Tensor | None = None,
                             impl: str = "auto"):
    """Single-pair NN: query [N, 3] vs ref [M, 3] -> (idx [N], d2 [N])."""
    idx, d2 = nearest_neighbors_pallas_batched(
        query[None], ref[None], None if ref_mask is None else ref_mask[None],
        impl=impl)
    return idx[0], d2[0]


def _nn_ranged_plain(query, refT, jlo, jhi, query_tile, ref_block):
    """Plain version of K4: the block sweep of ``_nn_plain`` in units of
    ``ref_block``, each query sweeping only its tile's [jlo, jhi]."""
    tile = torch.arange(query.shape[1], device=query.device) // query_tile
    lo, hi = jlo[:, tile], jhi[:, tile]                         # [B, N]
    return _nn_plain(query, refT, ref_block,
                     lambda j: (lo <= j) & (j <= hi))


def nn_ranged_chunks(jlo: torch.Tensor, jhi: torch.Tensor, n: int, m: int,
                     query_tile: int, ref_block: int,
                     chunk: int = NN_RANGED_CHUNK) -> torch.Tensor:
    """K4's work items per (batch row, sub-tile of NN_QUERY_TILE queries):
    [B, ceil(n / NN_QUERY_TILE)] int64, as its set-up kernel counts them.

    A sub-tile sweeps the union of the non-empty reference ranges
    ``[jlo * ref_block, min((jhi + 1) * ref_block, m))`` of the query tiles
    it falls in, in chunks of ``chunk`` references; the sum is the number
    of items one launch works through."""
    nq = jlo.shape[1]
    dev = jlo.device
    lo = torch.clamp(jlo.long() * ref_block, 0, m)               # [B, nq]
    hi = torch.clamp((jhi.long() + 1) * ref_block, 0, m)
    q0 = torch.arange(0, n, NN_QUERY_TILE, device=dev)           # [nsub]
    t_first = q0 // query_tile
    t_last = torch.clamp((torch.clamp(q0 + NN_QUERY_TILE, max=n) - 1)
                         // query_tile, max=nq - 1)
    t = torch.arange(nq, device=dev)
    use = ((t >= t_first[:, None]) & (t <= t_last[:, None])      # [nsub, nq]
           & (lo < hi)[:, None, :])                              # [B, ., .]
    ulo = torch.where(use, lo[:, None, :], m).amin(dim=-1)
    uhi = torch.where(use, hi[:, None, :], 0).amax(dim=-1)
    return -(-torch.clamp(uhi - ulo, min=0) // chunk)


def nn_ranged_scratch_sizes(b: int, n: int) -> tuple[int, int]:
    """(keys, meta): elements of K4's uint64 key array, one per query, and
    of its int32 bookkeeping (item offsets [sub-tiles + 1], the item
    counter, and a done counter per sub-tile)."""
    ns = b * -(-n // NN_QUERY_TILE)
    return b * n, 2 * ns + 2


def nn_batched_prepared_ranged(query: torch.Tensor, refT: torch.Tensor,
                               jlo: torch.Tensor, jhi: torch.Tensor,
                               query_tile: int = 1024, ref_block: int = 1024,
                               impl: str = "auto"):
    """Batched NN sweeping only reference blocks [jlo, jhi] per (batch,
    query tile): kernel K4.

    jlo/jhi: [B, nq] int32 inclusive ranges in units of ``ref_block``
    references, one per tile of ``query_tile`` queries (see
    ``block_ranges``). Each query gets the first index of the minimum over
    its tile's range, so it equals brute force wherever the range holds
    the query's nearest neighbour; an empty range (jlo > jhi) gives
    (+inf, 0). On a card the ranges are read on the device only (no host
    sync): a set-up kernel and a persistent kernel, see ``csrc/nn.cu``.
    Returns (idx [B, N] int32, d2 [B, N]).
    """
    _check_nn_args(query, refT)
    if query_tile < 1 or ref_block < 1:
        raise ValueError("query_tile and ref_block must be positive")
    b, n, _ = query.shape
    m = refT.shape[-1]
    nq = -(-n // query_tile)
    for name, r in (("jlo", jlo), ("jhi", jhi)):
        if r.shape != (b, nq) or r.dtype != torch.int32:
            raise ValueError(f"{name}: want int32 [{b}, {nq}], got "
                             f"{r.dtype} {tuple(r.shape)}")
    if not use_kernel(impl, query):
        return _nn_ranged_plain(query, refT, jlo, jhi, query_tile, ref_block)

    if any(t.device != query.device for t in (refT, jlo, jhi)):
        raise ValueError("query, refT, jlo and jhi must be on one device")
    query, refT = query.contiguous(), refT.contiguous()
    jlo, jhi = jlo.contiguous(), jhi.contiguous()
    dev = query.device
    idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, n), dtype=torch.float32, device=dev)
    n_keys, n_meta = nn_ranged_scratch_sizes(b, n)
    keys = torch.empty((n_keys,), dtype=torch.int64, device=dev)
    meta = torch.empty((n_meta,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = library().pcs_nn_batched_ranged(
            query.data_ptr(), refT.data_ptr(), jlo.data_ptr(),
            jhi.data_ptr(), b, n, m, query_tile, ref_block, NN_RANGED_CHUNK,
            NN_RANGED_BLOCKS_PER_SM, idx.data_ptr(), d2.data_ptr(),
            keys.data_ptr(), meta.data_ptr(), stream_handle(query))
    check(err, "nn_batched_prepared_ranged")
    LAUNCHES["nn_batched_prepared_ranged"] += 1
    return idx, d2


def block_ranges(query: torch.Tensor, query_mask: torch.Tensor,
                 ref: torch.Tensor, ref_mask: torch.Tensor,
                 d2_ub: torch.Tensor, query_tile: int = 1024,
                 ref_block: int = 1024):
    """Exact per-query-tile reference-block ranges from bounding boxes.

    A voxel-sorted reference is spatially coherent, so consecutive blocks
    have compact bounding boxes and the blocks that can beat a known upper
    bound form (a superset of) a contiguous range. query [B, N, 3],
    query_mask [B, N], ref [B, M, 3], ref_mask [B, M]; d2_ub [B, N] must
    bound each valid query's squared NN distance from above. Masked
    queries count with a bound of 0, so their range need not hold their
    nearest neighbour. Boxes are reckoned over the tile grid padded to
    whole tiles, as the JAX package does. Returns (jlo, jhi): [B, nq]
    inclusive int32 block ranges.
    """
    b, n, _ = query.shape
    m = ref.shape[1]
    nq, nm = -(-n // query_tile), -(-m // ref_block)
    big = 3.0e38

    def bbox(x, mask, tile, count):
        pad = (0, 0, 0, count * tile - x.shape[1])
        lo = F.pad(torch.where(mask[..., None], x, big), pad, value=big)
        hi = F.pad(torch.where(mask[..., None], x, -big), pad, value=-big)
        return (lo.reshape(b, count, tile, 3).amin(dim=2),
                hi.reshape(b, count, tile, 3).amax(dim=2))   # [B, tiles, 3]

    qlo, qhi = bbox(query, query_mask, query_tile, nq)
    rlo, rhi = bbox(ref, ref_mask, ref_block, nm)
    # squared box-to-box distance [B, nq, nm]
    gap = torch.clamp(torch.maximum(qlo[:, :, None] - rhi[:, None],
                                    rlo[:, None] - qhi[:, :, None]), min=0.0)
    g2 = gap * gap
    lb2 = (g2[..., 0] + g2[..., 1]) + g2[..., 2]

    ubm = F.pad(torch.where(query_mask, d2_ub, 0.0), (0, nq * query_tile - n))
    ub_tile = ubm.reshape(b, nq, query_tile).amax(dim=-1)      # [B, nq]
    # all-masked reference blocks have an infinite lower bound
    cand = lb2 <= ub_tile[..., None] * (1.0 + 1e-5) + 1e-12
    idxs = torch.arange(nm, dtype=torch.int32, device=query.device)
    jlo = torch.where(cand, idxs, nm - 1).amin(dim=-1)
    jhi = torch.where(cand, idxs, 0).amax(dim=-1)
    jhi = torch.maximum(jhi, jlo)  # degenerate tiles sweep one block
    return jlo.to(torch.int32), jhi.to(torch.int32)


def nearest_neighbors_pruned(query: torch.Tensor, ref: torch.Tensor,
                             ref_mask: torch.Tensor | None = None,
                             query_mask: torch.Tensor | None = None,
                             coarse_stride: int = 16,
                             query_tile: int = 1024, ref_block: int = 2048,
                             impl: str = "auto"):
    """Exact batched NN with key-range pruning, for voxel-sorted clouds.

    Pass 1 (K3) searches the stride-subsampled reference for an upper
    bound per query; ``block_ranges`` keeps the reference blocks whose
    bounding boxes can beat it; pass 2 (K4) sweeps only those. The
    subsampled reference is a subset, so the bound is valid and the
    result equals brute force on valid queries (``query_mask``).
    query [B, N, 3], ref [B, M, 3] -> (idx [B, N] int32, d2 [B, N]).
    """
    b, n, _ = query.shape
    m = ref.shape[1]
    if ref_mask is None:
        ref_mask = torch.ones((b, m), dtype=torch.bool, device=ref.device)
    if query_mask is None:
        query_mask = torch.ones((b, n), dtype=torch.bool,
                                device=query.device)
    _, d2_ub = nearest_neighbors_pallas_batched(
        query, ref[:, ::coarse_stride], ref_mask[:, ::coarse_stride],
        impl=impl)
    jlo, jhi = block_ranges(query, query_mask, ref, ref_mask, d2_ub,
                            query_tile=query_tile, ref_block=ref_block)
    return nn_batched_prepared_ranged(
        query, prepare_ref_batched(ref, ref_mask), jlo, jhi,
        query_tile=query_tile, ref_block=ref_block, impl=impl)
