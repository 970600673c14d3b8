"""Segment sums over sorted segments: kernels K1 and K2.

Port of ``pointcloud_stitching_tpu/kernels/segment_reduce.py``. The voxel
passes sort points by voxel key and then need one sum per run of equal
keys. Two entry points, as in the JAX package:

  * ``segment_sum_from_flags`` (K1): segment ids are ``cumsum(flags) - 1``,
    derived inside the kernel from the boundary flags; used by the global
    (unbatched) voxel pass.
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


# rows per K2 block (csrc/segment_reduce.cu K2_TILE; chip_smoke.py checks
# that the two agree)
K2_TILE_ROWS = 1024

# K2's scratch, per (device, stream), allocated once and grown with the tile
# count: the look-back state ([3 + tiles] int32, zero; the kernel's last
# block leaves it zero) and the tiles' published partials ([2, tiles, 16]
# float64), with their addresses. One stream runs its calls in order, so
# they can share it; another stream gets its own.
_SCRATCH: dict = {}


def _k2_scratch(dev: torch.device, stream: int, ntiles: int):
    key = (dev.index, stream)
    sc = _SCRATCH.get(key)
    if sc is None or sc[0] < ntiles:
        tiles = max(ntiles, 1024)
        state = torch.zeros((tiles + 3,), dtype=torch.int32, device=dev)
        part = torch.empty((2, tiles, MAX_CHANNELS), dtype=torch.float64,
                           device=dev)
        sc = _SCRATCH[key] = (tiles, state, part, state.data_ptr(),
                              part[0].data_ptr(), part[1].data_ptr())
    return sc[3:]


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
        past ``capacity`` drop.
    Returns [capacity, ch] float32 sums.
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
    lib = library()
    ntiles = -(-n // lib.pcs_segsum_tile_rows())
    dev = vals.device
    out = torch.empty((capacity, ch), dtype=torch.float32, device=dev)
    tile_counts = torch.empty((max(ntiles, 1),), dtype=torch.int32, device=dev)
    tile_offsets = torch.empty_like(tile_counts)
    tile_info = torch.empty((max(ntiles, 1) * 3,), dtype=torch.int32,
                            device=dev)
    part = torch.empty((2 * max(ntiles, 1), ch), dtype=torch.float64,
                       device=dev)
    with torch.cuda.device(dev):
        err = lib.pcs_segsum_flags(
            vals.data_ptr(), f8.data_ptr(), n, ch, capacity, out.data_ptr(),
            tile_counts.data_ptr(), tile_offsets.data_ptr(),
            tile_info.data_ptr(), part.data_ptr(), stream_handle(vals))
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
    state, xbuf, abuf = _k2_scratch(dev, stream, -(-n // K2_TILE_ROWS))
    out = torch.empty((capacity, ch), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().pcs_segsum_sorted(
            vals.data_ptr(), seg.data_ptr(), n, ch, capacity, out.data_ptr(),
            state, xbuf, abuf, stream)
    check(err, "segment_sum_sorted")
    LAUNCHES["segment_sum_sorted"] += 1
    return out
