"""Segment sums over sorted segments: kernels K1 and K2.

Port of ``pointcloud_stitching_tpu/kernels/segment_reduce.py``. The voxel
passes sort points by voxel key and then need one sum per run of equal
keys. Two entry points, as in the JAX package:

  * ``segment_sum_from_flags`` (K1): segment ids are ``cumsum(flags) - 1``,
    derived inside the kernel from the boundary flags; used by the global
    (unbatched) voxel pass. Its kernel is one launch too: a look-back over
    the tiles' flag counts gives every tile its first id, K2's scan and
    look-back give the sums, the slots that no run reaches are zeroed by
    the tiles themselves (no memset), and a tile whose ids are all past the
    capacity stops before it reads its rows.
  * ``segment_sum_sorted`` (K2): precomputed nondecreasing ids (they may
    jump, as the flattened camera batch makes them), discard id =
    capacity; used by the flattened batched pass. Its kernel is one launch:
    a segmented reduction inside each tile and a decoupled look-back for
    the runs that cross tiles.

The global voxel pass's packed branch (one cloud) takes a third entry,
``segment_sum_packed``: the pack kernel (``voxel_pack``) makes each point's
int32 voxel key and quantised offset (and colour) word, ``torch.sort``
sorts the keys, and K1 builds its rows and flags from the sorted keys, the
permutation and those words in registers. Its plain version is the
composition the batched pass uses (``packed_rows``) and a segment sum, and
the two agree bit for bit.

Both drop ids outside ``[0, capacity)``. For a CUDA tensor they launch the
hand-written kernels of ``csrc/segment_reduce.cu`` (see the design note
there); for a CPU tensor, or with ``impl="torch"``, they run the plain
versions below, which ``index_add_`` into ``capacity + 1`` slots.

Both add in float64 and round each sum to float32 once. A float64 sum of
float32 values is exact unless a segment's values span more than about
2^29 in magnitude, so the result does not depend on the order of the adds:
kernel and plain version agree bit for bit, run after run, though atomics
order the plain version's adds on the card. (The JAX package adds in
float32; the difference is below float32 rounding of each sum.)
"""
from __future__ import annotations

import torch

from ..utils.profiling import annotate
from ..utils.types import PointCloud, scalar
from .build import LAUNCHES, check, library, stream_handle, use_kernel

MAX_CHANNELS = 16
SENTINEL = 2 ** 31 - 1   # the voxel key of an invalid point: it sorts last


# rows per block of K1 and K2 (csrc/segment_reduce.cu K2_TILE; chip_smoke.py
# checks that the two agree), and the floats that one of K1's zero-only
# blocks clears (K1_ZERO_FLOATS)
K2_TILE_ROWS = 1024
K1_ZERO_FLOATS = 16384

# The look-back scratch of K1 and of K2, per (kernel, device, stream),
# allocated once and grown with the tile count: the state ([3 + tiles]
# int32: K2's counters or K1's 64-bit hint word, then a status per tile) and
# K1's flag-count words
# ([tiles + 1] int64: on packed rows the last holds the number of runs),
# both zero at first, and the tiles' published partials
# ([2, tiles, 16] float64). K2's last block leaves its state zero; K1
# stamps what it publishes with the call's epoch instead (a word of another
# epoch reads as unpublished), counted here. One stream runs its calls in
# order, so they can share a scratch; another stream gets its own.
_SCRATCH: dict = {}
_MAX_EPOCH = 2 ** 29 - 1


class _Scratch:
    def __init__(self, dev: torch.device, tiles: int):
        self.tiles = tiles
        self.state = torch.zeros((tiles + 3,), dtype=torch.int32, device=dev)
        self.cstat = torch.zeros((tiles + 1,), dtype=torch.int64, device=dev)
        self.part = torch.empty((2, tiles, MAX_CHANNELS),
                                dtype=torch.float64, device=dev)
        self.epoch = 0
        # addresses: state, its per-tile statuses, cstat, xbuf, abuf
        self.ptrs = (self.state.data_ptr(), self.state[3:].data_ptr(),
                     self.cstat.data_ptr(), self.part[0].data_ptr(),
                     self.part[1].data_ptr())

    def next_epoch(self) -> int:
        """An epoch that no word in the scratch carries."""
        if self.epoch >= _MAX_EPOCH:     # start over on clean words
            self.state.zero_()
            self.cstat.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.epoch


def _lookback_scratch(kernel: str, dev: torch.device, stream: int,
                      ntiles: int) -> _Scratch:
    key = (kernel, dev.index, stream)
    sc = _SCRATCH.get(key)
    if sc is None or sc.tiles < ntiles:
        sc = _SCRATCH[key] = _Scratch(dev, max(ntiles, 1024))
    return sc


def take_scratch(dev: torch.device, stream: int) -> list:
    """Take K1's and K2's look-back scratch of ``stream`` out of the table
    and return it: a CUDA graph captured on that stream holds its
    addresses, so it keeps the scratch alive and for itself, and a later
    call on the stream gets fresh scratch."""
    keys = [k for k in _SCRATCH if k[1:] == (dev.index, stream)]
    return [_SCRATCH.pop(k) for k in keys]


def k1_grid(n: int, ch: int, capacity: int) -> tuple[int, int]:
    """(tiles, zero-only blocks) of K1's one launch: a block per
    K2_TILE_ROWS rows, then a block per K1_ZERO_FLOATS floats of the slots
    [n, capacity), which no row can reach."""
    return (-(-n // K2_TILE_ROWS),
            -(-(capacity - min(n, capacity)) * ch // K1_ZERO_FLOATS))


def _discard_out_of_range(seg: torch.Tensor, capacity: int) -> torch.Tensor:
    return torch.where((seg >= 0) & (seg < capacity), seg, capacity)


def segment_sum_plain(vals: torch.Tensor, seg: torch.Tensor,
                      capacity: int) -> torch.Tensor:
    """Plain PyTorch segment sum: rows with ids outside [0, capacity) drop."""
    out = torch.zeros((capacity + 1, vals.shape[-1]), dtype=torch.float64,
                      device=vals.device)
    out.index_add_(0, _discard_out_of_range(seg, capacity).long(),
                   vals.to(torch.float64))
    return out[:capacity].to(torch.float32)


def _check_vals(vals: torch.Tensor, capacity: int) -> None:
    if vals.dtype != torch.float32 or vals.dim() != 2:
        raise ValueError(f"vals must be [N, ch] float32, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    if not 1 <= vals.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"{vals.shape[1]} channels; the kernel takes "
                         f"1..{MAX_CHANNELS}")
    if vals.shape[0] >= 2 ** 31:
        raise ValueError("more than 2^31 rows")
    if capacity < 1:
        raise ValueError("capacity must be positive")


def segment_sum_from_flags(vals: torch.Tensor, flags: torch.Tensor,
                           capacity: int, impl: str = "auto") -> torch.Tensor:
    """Segment sums where ids come from boundary flags (K1).

    Args:
      vals: [N, ch] float32; rows of invalid points must be zeroed.
      flags: [N] bool (or integer, nonzero = set): a new segment starts at
        the row. Rows before the first flag get id -1 and drop; ids at or
        past ``capacity`` drop; slots that no run reaches are 0.
    Returns [capacity, ch] float32 sums. On a card: one kernel launch, with
    look-back scratch kept per (device, stream) as K2's is; rows whose ids
    are all past ``capacity`` are never read.
    """
    _check_vals(vals, capacity)
    if flags.shape != vals.shape[:1]:
        raise ValueError(f"flags {tuple(flags.shape)} do not match vals "
                         f"{tuple(vals.shape)}")
    if not use_kernel(impl, vals):
        seg = torch.cumsum((flags != 0).to(torch.int32), dim=0) - 1
        return segment_sum_plain(vals, seg, capacity)

    if not (flags.is_cuda and flags.device == vals.device):
        raise ValueError("flags must be on vals' device")
    vals = vals.contiguous()
    f8 = (flags if flags.dtype == torch.bool else flags != 0).contiguous()
    f8 = f8.view(torch.uint8)
    n, ch = vals.shape
    if capacity * ch >= 2 ** 31:
        raise ValueError(f"capacity x channels {capacity} x {ch} >= 2^31")
    dev = vals.device
    stream = stream_handle(vals)
    sc = _lookback_scratch("k1", dev, stream, -(-n // K2_TILE_ROWS))
    hint, status, cstat, xbuf, abuf = sc.ptrs   # hint: the state's head
    out = torch.empty((capacity, ch), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().pcs_segsum_flags(
            vals.data_ptr(), f8.data_ptr(), n, ch, capacity, out.data_ptr(),
            sc.next_epoch(), hint, status, cstat, xbuf, abuf, stream)
    check(err, "segment_sum_from_flags")
    LAUNCHES["segment_sum_from_flags"] += 1
    return out


def segment_sum_sorted(vals: torch.Tensor, seg: torch.Tensor, capacity: int,
                       impl: str = "auto") -> torch.Tensor:
    """Sum ``vals`` rows by sorted segment id into ``capacity`` slots (K2).

    Args:
      vals: [N, ch] float32; discarded rows should be zeroed.
      seg: [N] int32, nondecreasing (the form a cumsum of boundaries
        produces; ids may jump), with any suffix at the discard id
        ``capacity``. Rows with ids outside [0, capacity) drop; slots that
        no row reaches are 0. Where an id decreases, the kernel writes NaN
        into every slot (the plain version sums such ids all the same).
    Returns [capacity, ch] float32 sums.
    """
    _check_vals(vals, capacity)
    if seg.shape != vals.shape[:1]:
        raise ValueError(f"seg {tuple(seg.shape)} does not match vals "
                         f"{tuple(vals.shape)}")
    if not use_kernel(impl, vals):
        return segment_sum_plain(vals, seg, capacity)

    if not (seg.is_cuda and seg.device == vals.device):
        raise ValueError("seg must be on vals' device")
    if seg.dtype != torch.int32:
        raise ValueError(f"seg must be int32, got {seg.dtype}")
    vals = vals.contiguous()
    seg = seg.contiguous()
    n, ch = vals.shape
    if capacity * ch >= 2 ** 31:
        raise ValueError(f"capacity x channels {capacity} x {ch} >= 2^31")
    dev = vals.device
    stream = stream_handle(vals)
    state, _, _, xbuf, abuf = _lookback_scratch(
        "k2", dev, stream, -(-n // K2_TILE_ROWS)).ptrs
    out = torch.empty((capacity, ch), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().pcs_segsum_sorted(
            vals.data_ptr(), seg.data_ptr(), n, ch, capacity, out.data_ptr(),
            state, xbuf, abuf, stream)
    check(err, "segment_sum_sorted")
    LAUNCHES["segment_sum_sorted"] += 1
    return out



def run_starts(skey: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K1's flags over sorted keys: True where a valid row's key differs
    from the row before it (the first row's from none), along the last
    axis."""
    prev = torch.cat([torch.full_like(skey[..., :1], -1), skey[..., :-1]],
                     dim=-1)
    return (skey != prev) & valid


# The packed voxel format (the voxel pass's packed branch): a point's int32
# key (ix * ny + iy) * nz + iz, SENTINEL where it is invalid; its offset in
# the voxel in units of leaf/1024, (q0 << 20) | (q1 << 10) | q2; with
# colour, (r << 16) | (g << 8) | b. A run of one key sums to the channels
# [ix, iy, iz (on its first row only), q0, q1, q2, 1] (+ [r, g, b]), all
# small integers, so the sums are exact; ``finalize_packed`` turns them
# into centroids.

def voxel_pack(xyz: torch.Tensor, mask: torch.Tensor, rgb, inv: torch.Tensor,
               min_ijk: torch.Tensor, dims: torch.Tensor, impl: str = "auto"):
    """The packed voxel branch's words of each point.

    Args:
      xyz: [..., N, 3] float32; mask: [..., N] bool; rgb: [..., N, 3]
        float32 of 8-bit integer values, or None.
      inv: 0-d float32, 1 / leaf. min_ijk: [..., 1, 3] int32, the valid
        points' least floor(xyz * inv) per axis. dims: [..., 3] int32, the
        grid's (nx, ny, nz), each at least 1.
    Returns (key, off, col) [..., N] int32, the words of the format above
    (col None without rgb). On a card: one launch of the pack kernel, for
    one cloud ([N, 3]).
    """
    if not use_kernel(impl, xyz):
        p = xyz * inv
        fp = torch.floor(p)
        ijk = fp.to(torch.int32) - min_ijk
        ny, nz = dims[..., 1:2], dims[..., 2:3]
        key = (ijk[..., 0] * ny + ijk[..., 1]) * nz + ijk[..., 2]
        key = torch.where(mask, key, SENTINEL)
        # in-voxel offsets in units of leaf/1024 (floor of the f32 fraction)
        oq = torch.clamp(((p - fp) * 1024.0).to(torch.int32), 0, 1023)
        off = (oq[..., 0] << 20) | (oq[..., 1] << 10) | oq[..., 2]
        col = None
        if rgb is not None:
            rq = torch.clamp(rgb.to(torch.int32), 0, 255)
            col = (rq[..., 0] << 16) | (rq[..., 1] << 8) | rq[..., 2]
        return key, off, col

    dev = xyz.device
    if xyz.dim() != 2 or xyz.shape[1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"xyz must be [N, 3] float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    n = xyz.shape[0]
    if mask.shape != (n,) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be [{n}] bool")
    if rgb is not None and (rgb.shape != (n, 3) or rgb.dtype != torch.float32):
        raise ValueError(f"rgb must be [{n}, 3] float32")
    if (inv.numel() != 1 or inv.dtype != torch.float32
            or min_ijk.numel() != 3 or min_ijk.dtype != torch.int32
            or dims.numel() != 3 or dims.dtype != torch.int32):
        raise ValueError("inv must be one float32, min_ijk and dims three "
                         "int32 each")
    ts = [xyz, mask, inv, min_ijk, dims] + ([] if rgb is None else [rgb])
    if any(a.device != dev for a in ts):
        raise ValueError("the pack kernel's inputs must be on one device")
    if n >= 2 ** 31:
        raise ValueError("more than 2^31 points")
    xyz, mask, inv, min_ijk, dims = (a.contiguous() for a in
                                     (xyz, mask, inv, min_ijk, dims))
    rgb = None if rgb is None else rgb.contiguous()
    key = torch.empty((n,), dtype=torch.int32, device=dev)
    off = torch.empty_like(key)
    col = None if rgb is None else torch.empty_like(key)
    with torch.cuda.device(dev):
        err = library().pcs_voxel_pack(
            xyz.data_ptr(), mask.view(torch.uint8).data_ptr(),
            None if rgb is None else rgb.data_ptr(), inv.data_ptr(),
            min_ijk.data_ptr(), dims.data_ptr(), n, key.data_ptr(),
            off.data_ptr(), None if col is None else col.data_ptr(),
            stream_handle(xyz))
    check(err, "voxel_pack")
    LAUNCHES["voxel_pack"] += 1
    return key, off, col


def sorted_packed_rows(skey: torch.Tensor, perm: torch.Tensor,
                       off: torch.Tensor, col, dims: torch.Tensor):
    """The rows of sorted packed words, composed in PyTorch.

    Args:
      skey: [..., N] int32 sorted keys; perm: [..., N] the sort's
        permutation; off, col: [..., N] int32, ``voxel_pack``'s words in the
        points' own order (col None: no colour); dims: [..., 3] int32.
    Returns (flags [..., N] bool, vals [..., N, 7 or 10] float32): a flag
    starts each run of one valid key; the channels are those of the format
    above, the indices on flagged rows only, every channel zero on invalid
    rows.
    """
    soff = off.gather(-1, perm)
    valid = skey != SENTINEL
    ny, nz = dims[..., 1:2], dims[..., 2:3]
    sk = torch.where(valid, skey, 0)
    iz = sk % nz
    t = sk // nz
    iy = t % ny
    ix = t // ny

    flags = run_starts(skey, valid)
    f = flags.to(torch.float32)
    q = torch.stack([(soff >> 20) & 1023, (soff >> 10) & 1023, soff & 1023],
                    dim=-1).to(torch.float32)
    chans = [torch.stack([ix, iy, iz], dim=-1).to(torch.float32) * f[..., None],
             q, torch.ones_like(f)[..., None]]
    if col is not None:
        scol = col.gather(-1, perm)
        chans.append(torch.stack([(scol >> 16) & 255, (scol >> 8) & 255,
                                  scol & 255], dim=-1).to(torch.float32))
    vals = torch.cat(chans, dim=-1)
    vals = torch.where(valid[..., None], vals, 0.0)
    return flags, vals


def packed_rows(xyz: torch.Tensor, mask: torch.Tensor, rgb,
                inv: torch.Tensor, min_ijk: torch.Tensor, dims: torch.Tensor):
    """The packed voxel branch's sorted rows, composed in PyTorch: takes
    ``voxel_pack``'s arguments and returns ``sorted_packed_rows``' (flags,
    vals) of its words, sorted by key."""
    key, off, col = voxel_pack(xyz, mask, rgb, inv, min_ijk, dims,
                               impl="torch")
    skey, perm = torch.sort(key, dim=-1)
    return sorted_packed_rows(skey, perm, off, col, dims)


def segment_sum_from_keys(skey: torch.Tensor, perm: torch.Tensor,
                          off: torch.Tensor, col, dims: torch.Tensor,
                          capacity: int, impl: str = "auto") -> torch.Tensor:
    """K1 on packed rows: the sums of ``sorted_packed_rows``' channels per
    run of one valid key, into ``capacity`` slots (runs past it drop, in key
    order; slots that no run reaches are 0).

    Takes ``sorted_packed_rows``' arguments for one cloud ([N]). Returns
    [capacity, 7 or 10] float32. On a card: one launch of K1 with the
    packed row source, which builds each row's flag and channels in
    registers from the sorted key, the permutation and the words (no row
    buffer, no flag bytes); scratch and epochs are K1's. The plain version
    (CPU tensors, ``impl="torch"``) sums ``sorted_packed_rows``; both give
    the same bits.
    """
    if capacity < 1:
        raise ValueError("capacity must be positive")
    if not use_kernel(impl, skey):
        flags, vals = sorted_packed_rows(skey, perm, off, col, dims)
        seg = torch.cumsum(flags.to(torch.int32), dim=-1) - 1
        return segment_sum_plain(vals, seg, capacity)

    n = skey.shape[0]
    ch = 7 if col is None else 10
    words = [off] + ([] if col is None else [col])
    if (skey.shape != (n,) or perm.shape != (n,) or dims.numel() != 3
            or any(w.shape != (n,) for w in words)):
        raise ValueError("skey, perm, off and col must be [N], dims [3]")
    if (skey.dtype != torch.int32 or perm.dtype != torch.int64
            or dims.dtype != torch.int32
            or any(w.dtype != torch.int32 for w in words)):
        raise ValueError("skey, off, col and dims must be int32, perm int64")
    dev = skey.device
    if any(a.device != dev for a in [perm, dims] + words):
        raise ValueError("K1's packed inputs must be on one device")
    if n >= 2 ** 31:
        raise ValueError("more than 2^31 rows")
    if capacity * ch >= 2 ** 31:
        raise ValueError(f"capacity x channels {capacity} x {ch} >= 2^31")
    skey, perm, off, dims = (a.contiguous() for a in (skey, perm, off, dims))
    col = None if col is None else col.contiguous()
    stream = stream_handle(skey)
    sc = _lookback_scratch("k1", dev, stream, -(-n // K2_TILE_ROWS))
    hint, status, cstat, xbuf, abuf = sc.ptrs
    out = torch.empty((capacity, ch), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().pcs_segsum_packed(
            skey.data_ptr(), perm.data_ptr(), off.data_ptr(),
            None if col is None else col.data_ptr(), dims.data_ptr(), n,
            capacity, out.data_ptr(), sc.next_epoch(), hint, status, cstat,
            xbuf, abuf, stream)
    check(err, "segment_sum_from_keys")
    LAUNCHES["segment_sum_from_keys"] += 1
    return out


def segment_sum_packed(xyz: torch.Tensor, mask: torch.Tensor, rgb,
                       inv: torch.Tensor, min_ijk: torch.Tensor,
                       dims: torch.Tensor, capacity: int,
                       impl: str = "auto") -> torch.Tensor:
    """One cloud's packed voxel sums: ``segment_sum_from_keys`` over its
    words sorted by key.

    Takes ``voxel_pack``'s arguments for one cloud ([N, 3]). Returns
    [capacity, 7 or 10] float32. On a card: the pack kernel, ``torch.sort``
    and K1 on packed rows, inside the span ``pcs.voxel.k1_packed``; no host
    sync. The plain version (CPU tensors, ``impl="torch"``) is
    ``packed_rows`` and ``segment_sum_plain``; both give the same bits.
    """
    if capacity < 1:
        raise ValueError("capacity must be positive")
    if not use_kernel(impl, xyz):
        flags, vals = packed_rows(xyz, mask, rgb, inv, min_ijk, dims)
        seg = torch.cumsum(flags.to(torch.int32), dim=0) - 1
        return segment_sum_plain(vals, seg, capacity)

    with annotate("pcs.voxel.k1_packed"):
        return _packed_k1(xyz, mask, rgb, inv, min_ijk, dims, capacity)


def _packed_k1(xyz, mask, rgb, inv, min_ijk, dims, capacity: int):
    """``segment_sum_packed`` on a card: the pack kernel, the sort, K1."""
    key, off, col = voxel_pack(xyz, mask, rgb, inv, min_ijk, dims, "cuda")
    skey, perm = torch.sort(key)
    return segment_sum_from_keys(skey, perm, off, col, dims, capacity, "cuda")


def finalize_packed(sums: torch.Tensor, min_ijk: torch.Tensor, leaf,
                    has_rgb: bool = False):
    """Centroids from the packed format's sums: (base + (Σq/n + ½)/1024)
    · leaf, base the voxel's indices plus ``min_ijk``; with ``has_rgb``
    the mean colour. Returns a PointCloud of ``sums``' slots."""
    counts = sums[..., 6]
    out_mask = counts > 0.0
    denom = torch.clamp(counts, min=1.0)[..., None]
    base = sums[..., :3] + min_ijk.to(torch.float32)
    mean_q = sums[..., 3:6] / denom
    xyz = (base + (mean_q + 0.5) * (1.0 / 1024.0)) * scalar(leaf, sums)
    rgb = None
    if has_rgb:
        rgb = torch.where(out_mask[..., None], sums[..., 7:10] / denom, 0.0)
    return PointCloud(xyz=torch.where(out_mask[..., None], xyz, 0.0),
                      mask=out_mask, rgb=rgb)
