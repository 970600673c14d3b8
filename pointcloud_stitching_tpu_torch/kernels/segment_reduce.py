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

from .build import LAUNCHES, check, library, stream_handle, use_kernel

MAX_CHANNELS = 16


# rows per block of K1 and K2 (csrc/segment_reduce.cu K2_TILE; chip_smoke.py
# checks that the two agree), and the floats that one of K1's zero-only
# blocks clears (K1_ZERO_FLOATS)
K2_TILE_ROWS = 1024
K1_ZERO_FLOATS = 16384

# The look-back scratch of K1 and of K2, per (kernel, device, stream),
# allocated once and grown with the tile count: the state ([3 + tiles]
# int32: K2's counters or K1's 64-bit hint word, then a status per tile) and
# K1's flag-count words
# ([tiles] int64), both zero at first, and the tiles' published partials
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
        self.cstat = torch.zeros((tiles,), dtype=torch.int64, device=dev)
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
