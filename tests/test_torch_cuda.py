"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU (CUDA kernels have no CPU mode): each takes
the ``cuda_device`` fixture, which skips where there is none. The file
imports no JAX, so it also runs where JAX is not installed; there, skip
tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import pointcloud_stitching_tpu_torch as P
from pointcloud_stitching_tpu_torch.kernels import build as kb
from pointcloud_stitching_tpu_torch.kernels.nn_pallas import (
    block_ranges, nearest_neighbors_pallas_batched, nearest_neighbors_pruned,
    NN_MAX_SPLITS, NN_RANGED_CHUNK, nn_batched_prepared,
    nn_batched_prepared_ranged, nn_ranged_chunks, nn_splits,
    prepare_ref_batched)
from pointcloud_stitching_tpu_torch.kernels.patch_gather import patch_gather
from pointcloud_stitching_tpu_torch.models import tsdf as TM
from pointcloud_stitching_tpu_torch.ops import icp_converge, voxel_downsample
from pointcloud_stitching_tpu_torch.utils import prng
from pointcloud_stitching_tpu_torch.utils.types import scalar
from pointcloud_stitching_tpu_torch.kernels import prng as KP
from pointcloud_stitching_tpu_torch.kernels.segment_reduce import (
    k1_grid, segment_sum_from_flags, segment_sum_sorted)
from oracle import random_se3, synth_depth_frame

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    """The first GPU; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def test_segment_kernels_match_plain(rng, cuda_device):
    """Float64 accumulation makes kernel and plain version bitwise equal,
    float channels included, with segments that cross tile boundaries."""
    n = 200_000
    flags = rng.random(n) < 0.01            # ~100-row segments
    flags[:5] = False                       # leading rows carry id -1
    vals = np.concatenate([rng.integers(0, 1024, (n, 4)),
                           rng.normal(size=(n, 3))], 1).astype(np.float32)
    v = torch.from_numpy(vals).to(cuda_device)
    f = torch.from_numpy(flags).to(cuda_device)
    kb.reset_launches()
    for cap in (500, 1900, 5000):           # saturated and not
        got = segment_sum_from_flags(v, f, cap, impl="cuda")
        want = segment_sum_from_flags(v, f, cap, impl="torch")
        assert torch.equal(got, want)
        # K2 takes nondecreasing ids: the leading -1 rows stay -1 and drop
        seg = torch.cumsum(f.to(torch.int32), 0, dtype=torch.int32) - 1
        seg = torch.where(seg < cap, seg, cap).to(torch.int32)
        got = segment_sum_sorted(v, seg, cap, impl="cuda")
        want = segment_sum_sorted(v, seg, cap, impl="torch")
        assert torch.equal(got, want)
    assert kb.LAUNCHES["segment_sum_from_flags"] == 3
    assert kb.LAUNCHES["segment_sum_sorted"] == 3


def test_segment_kernels_edge_shapes(cuda_device):
    for n, ch in ((1, 1), (511, 16), (513, 5), (4096, 10)):
        vals = torch.arange(n * ch, dtype=torch.float32,
                            device=cuda_device).reshape(n, ch)
        flags = torch.zeros(n, dtype=torch.bool, device=cuda_device)
        flags[0] = True                     # one segment over every row
        got = segment_sum_from_flags(vals, flags, 3, impl="cuda")
        want = segment_sum_from_flags(vals, flags, 3, impl="torch")
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        segment_sum_sorted(vals, torch.zeros(n, dtype=torch.int64,
                                             device=cuda_device), 3,
                           impl="cuda")


def test_nn_kernel_matches_plain(rng, cuda_device):
    q = torch.from_numpy(rng.normal(size=(8, 2048, 3)).astype(np.float32))
    r_np = rng.normal(size=(8, 3000, 3)).astype(np.float32)
    r_np[:, 2500] = r_np[:, 10]             # a tie: index 10 must win
    q[:, 0] = torch.from_numpy(r_np[:, 10])
    mask = torch.from_numpy(rng.random((8, 3000)) > 0.1)
    mask[:, [10, 2500]] = True
    refT = prepare_ref_batched(torch.from_numpy(r_np).to(cuda_device),
                               mask.to(cuda_device))
    qd = q.to(cuda_device)
    gi, gd = nn_batched_prepared(qd, refT, impl="cuda")
    wi, wd = nn_batched_prepared(qd, refT, impl="torch")
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    assert bool((gi[:, 0] == 10).all())


def _k2_case(case: str):
    """(vals [N, ch], seg [N], capacity) for one K2 case, from a generator
    of its own."""
    rng = np.random.default_rng(["long_run", "discard_mid", "gaps",
                                 "out_of_range", "n1", "n511", "n513",
                                 "ch1", "ch16"].index(case) + 40)
    # up to 4 channels the kernel gives a thread 8 rows, above that 4
    ch = {"ch1": 1, "ch16": 16, "ch4": 4, "unsaturated_long": 4}.get(case, 7)
    if case == "long_run":        # one run over 30 tiles of 1024 rows
        seg = np.concatenate([np.arange(100), np.full(30_000, 100),
                              np.arange(101, 400)])
        cap = 400
    elif case == "discard_mid":   # 3 cameras of 9000 rows, 2048 slots each
        cap_cam, segs = 2048, []
        for c in range(3):
            s = np.cumsum(rng.random(9000) < 0.5) - 1
            s = np.where(s < cap_cam, s, cap_cam)   # a long discard suffix
            segs.append(s + c * (cap_cam + 1))
        seg, cap = np.concatenate(segs), 3 * (cap_cam + 1)
    elif case == "gaps":          # ids jump by up to 40: the gaps read 0
        seg = np.cumsum(rng.integers(0, 41, 20_000) * (rng.random(20_000)
                                                       < 0.05))
        cap = int(seg[-1]) + 500
    elif case == "out_of_range":  # ids < 0 first, ids >= capacity last
        seg = np.sort(rng.integers(-300, 2300, 25_000))
        cap = 2000
    else:
        n = {"n1": 1, "n511": 511, "n513": 513}.get(case, 5000)
        seg = np.sort(rng.integers(0, max(n // 3, 1), n))
        cap = int(seg[-1]) + 7
    vals = rng.normal(size=(seg.size, ch)).astype(np.float32)
    return vals, seg.astype(np.int32), cap


@pytest.mark.parametrize("case", ["long_run", "discard_mid", "gaps",
                                  "out_of_range", "n1", "n511", "n513",
                                  "ch1", "ch16"])
def test_sorted_segment_kernel_matches_plain_bitwise(cuda_device, case):
    """K2 (one launch) against its plain version bit for bit, and two
    launches give the same bits."""
    vals, seg, cap = _k2_case(case)
    v = torch.from_numpy(vals).to(cuda_device)
    s = torch.from_numpy(seg).to(cuda_device)
    kb.reset_launches()
    got = segment_sum_sorted(v, s, cap, impl="cuda")
    again = segment_sum_sorted(v, s, cap, impl="cuda")
    want = segment_sum_sorted(v, s, cap, impl="torch")
    torch.cuda.synchronize()
    assert kb.LAUNCHES["segment_sum_sorted"] == 2
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    hit = np.zeros(cap, bool)
    hit[seg[(seg >= 0) & (seg < cap)]] = True
    assert not bool(got[torch.from_numpy(~hit).to(cuda_device)].any())


def test_sorted_segment_kernel_integer_sums_exact(cuda_device):
    """Integer channels (the packed voxel branch) sum exactly."""
    rng = np.random.default_rng(50)
    seg = np.sort(rng.integers(0, 3000, 200_000)).astype(np.int32)
    vals = rng.integers(0, 1024, (seg.size, 7)).astype(np.float32)
    got = segment_sum_sorted(torch.from_numpy(vals).to(cuda_device),
                             torch.from_numpy(seg).to(cuda_device), 3000,
                             impl="cuda").cpu().numpy()
    want = np.zeros((3000, 7))
    np.add.at(want, seg, vals.astype(np.float64))
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_sorted_segment_kernel_decreasing_ids_give_nan(cuda_device):
    """Ids that decrease break K2's contract: every slot reads NaN, and the
    next call, with nondecreasing ids, is right again."""
    rng = np.random.default_rng(51)
    v = torch.from_numpy(rng.normal(size=(5000, 7)).astype(np.float32)).to(
        cuda_device)
    seg = np.sort(rng.integers(0, 900, 5000)).astype(np.int32)
    bad = seg.copy()
    bad[3000:] -= 50                        # one drop, inside a tile
    got = segment_sum_sorted(v, torch.from_numpy(bad).to(cuda_device), 1000,
                             impl="cuda")
    assert bool(got.isnan().all())
    s = torch.from_numpy(seg).to(cuda_device)
    assert torch.equal(segment_sum_sorted(v, s, 1000, impl="cuda"),
                       segment_sum_sorted(v, s, 1000, impl="torch"))


def test_sorted_segment_kernel_on_two_streams(cuda_device):
    """Calls on two streams at once each keep their own look-back state."""
    cases = [_k2_case(c) for c in ("long_run", "discard_mid")]
    ins = [(torch.from_numpy(v).to(cuda_device),
            torch.from_numpy(s).to(cuda_device), c) for v, s, c in cases]
    main = torch.cuda.current_stream(cuda_device)
    streams = [torch.cuda.Stream(cuda_device) for _ in ins]
    outs = []
    for st in streams:
        st.wait_stream(main)
    for _ in range(5):
        for st, (v, s, c) in zip(streams, ins):
            with torch.cuda.stream(st):
                outs.append(segment_sum_sorted(v, s, c, impl="cuda"))
    torch.cuda.synchronize()
    for k, out in enumerate(outs):
        v, s, c = ins[k % 2]
        assert torch.equal(out, segment_sum_sorted(v, s, c, impl="torch"))


K1_CASES = ["long_run", "no_flag", "late_flag", "saturated", "all_flags",
            "n0", "n1", "n1_flag", "n1023", "n1025", "ch1", "ch16",
            "big_capacity", "saturated_long", "unsaturated_long", "ch4"]


def _k1_case(case: str):
    """(vals [N, ch], flags [N], capacity) for one K1 case, from a
    generator of its own."""
    rng = np.random.default_rng(K1_CASES.index(case) + 70)
    # up to 4 channels the kernel gives a thread 8 rows, above that 4
    ch = {"ch1": 1, "ch16": 16, "ch4": 4, "unsaturated_long": 4}.get(case, 7)
    # the long cases have more tiles than the card holds blocks at once
    n = {"n0": 0, "n1": 1, "n1_flag": 1, "n1023": 1023, "n1025": 1025,
         "saturated_long": 1_500_000,
         "unsaturated_long": 1_500_000}.get(case, 40_000)
    flags = rng.random(n) < 0.02
    cap = 1500
    if case in ("long_run", "ch4"):   # one run over 30 tiles of 1024 rows
        flags[3000:33_800] = False
        flags[3000] = True
    elif case == "no_flag":       # every id is -1: all slots read 0
        flags[:] = False
    elif case == "late_flag":     # 20 tiles of id -1 before the first run
        flags[:20_500] = False
    elif case == "saturated":     # most runs lie past the capacity
        flags = rng.random(n) < 0.6
        cap = 3000
    elif case == "saturated_long":    # the ids pass the capacity early on
        flags = rng.random(n) < 0.5
        cap = 20_000
    elif case == "unsaturated_long":  # every row kept, runs of 1 to ~60 rows
        flags = rng.random(n) < 0.08
        cap = 150_000
    elif case == "all_flags":     # runs of one row, fewer than the slots
        flags[:] = True
        cap = 50_000
    elif case == "n1_flag":
        flags[:] = True
    elif case == "big_capacity":  # slots past the row count are zeroed too
        cap = 200_000
    vals = rng.normal(size=(n, ch)).astype(np.float32)
    return vals, flags, cap


@pytest.mark.parametrize("case", K1_CASES)
def test_flags_segment_kernel_matches_plain_bitwise(cuda_device, case):
    """K1 (one launch) against its plain version bit for bit, two launches
    give the same bits (the state is left clean), and every slot past the
    last run reads 0."""
    vals, flags, cap = _k1_case(case)
    v = torch.from_numpy(vals).to(cuda_device)
    f = torch.from_numpy(flags).to(cuda_device)
    kb.reset_launches()
    # the outputs reuse freed blocks of NaN, so a slot that the kernel
    # leaves unwritten cannot pass for a zero
    junk = [torch.full((cap, vals.shape[1]), float("nan"),
                       device=cuda_device) for _ in range(2)]
    del junk
    got = segment_sum_from_flags(v, f, cap, impl="cuda")
    again = segment_sum_from_flags(v, f, cap, impl="cuda")
    want = segment_sum_from_flags(v, f, cap, impl="torch")
    torch.cuda.synchronize()
    assert kb.LAUNCHES["segment_sum_from_flags"] == 2
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    runs = int(flags.sum())
    assert not bool(got[min(runs, cap):].any())
    tiles, zero_blocks = k1_grid(len(flags), vals.shape[1], cap)
    assert kb.library().pcs_segsum_flags_grid(
        len(flags), vals.shape[1], cap) == tiles + zero_blocks


def test_flags_segment_kernel_takes_integer_and_unaligned_flags(cuda_device):
    """Flags as uint8 counts (nonzero = set) and as a view that starts one
    byte into its storage give the plain version's sums."""
    vals, flags, cap = _k1_case("long_run")
    v = torch.from_numpy(vals).to(cuda_device)
    f = torch.from_numpy(flags).to(cuda_device)
    want = segment_sum_from_flags(v, f, cap, impl="torch")
    counts = f.to(torch.uint8) * 7
    assert torch.equal(segment_sum_from_flags(v, counts, cap, impl="cuda"),
                       want)
    shifted = torch.cat([f[:1], f])[1:]
    assert shifted.data_ptr() % 4 == 1 and shifted.is_contiguous()
    assert torch.equal(segment_sum_from_flags(v, shifted, cap, impl="cuda"),
                       want)


def test_flags_segment_kernel_on_two_streams(cuda_device):
    """Calls on two streams at once each keep their own look-back state."""
    cases = [_k1_case(c) for c in ("long_run", "saturated")]
    ins = [(torch.from_numpy(v).to(cuda_device),
            torch.from_numpy(f).to(cuda_device), c) for v, f, c in cases]
    main = torch.cuda.current_stream(cuda_device)
    streams = [torch.cuda.Stream(cuda_device) for _ in ins]
    outs = []
    for st in streams:
        st.wait_stream(main)
    for _ in range(5):
        for st, (v, f, c) in zip(streams, ins):
            with torch.cuda.stream(st):
                outs.append(segment_sum_from_flags(v, f, c, impl="cuda"))
    torch.cuda.synchronize()
    for k, out in enumerate(outs):
        v, f, c = ins[k % 2]
        assert torch.equal(out, segment_sum_from_flags(v, f, c, impl="torch"))


# --- the global voxel pass's packed route: pack kernel, sort, K1 ---------

PACKED_CASES = ["cloud", "saturated", "all_invalid", "one_point",
                "n_odd", "all_valid", "one_voxel"]


def _packed_case(case: str, dev, with_rgb: bool):
    """(PointCloud [N], leaf, capacity) for one case of the packed route."""
    rng = np.random.default_rng(PACKED_CASES.index(case) + 140)
    n = {"n_odd": 1024 * 37 + 333, "all_valid": 300_000,
         "one_point": 5000}.get(case, 200_000)
    xyz = rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32)
    xyz[:, 2] += 1.3
    mask = rng.random(n) > 0.6              # a sorted suffix of 60% invalid
    cap = 1 << 18
    if case == "saturated":                 # runs past the capacity drop
        cap = 5000
    elif case == "all_invalid":
        mask[:] = False
    elif case == "one_point":
        mask[:] = False
        mask[777] = True
    elif case == "all_valid":               # no invalid suffix at all
        mask[:] = True
    elif case == "one_voxel":               # one run over every tile
        xyz = (rng.uniform(0.0, 0.0099, (n, 3)) + 0.5).astype(np.float32)
    xyz[~mask] = 0.0
    rgb = (rng.integers(0, 256, (n, 3)).astype(np.float32) if with_rgb
           else None)
    pc = P.PointCloud(xyz=torch.from_numpy(xyz).to(dev),
                      mask=torch.from_numpy(mask).to(dev),
                      rgb=None if rgb is None else
                      torch.from_numpy(rgb).to(dev))
    return pc, 0.01, cap


def _packed_args(pc, leaf):
    """``segment_sum_packed``'s inputs as ``voxel_downsample`` makes them."""
    from pointcloud_stitching_tpu_torch.ops import voxel as V
    inv = 1.0 / scalar(leaf, pc.xyz)
    ijk, min_ijk = V._indices_and_min(pc.xyz, pc.mask, inv)
    dims = torch.clamp(V._extents(ijk), min=1)
    return (pc.xyz, pc.mask, pc.rgb, inv, min_ijk, dims)


def _nan_junk(dev, *shape):
    """Fill freed blocks with NaN, so a slot that a kernel leaves unwritten
    cannot pass for a zero."""
    junk = [torch.full(shape, float("nan"), device=dev) for _ in range(2)]
    del junk


def _assert_packed_route_equals_composition(pc, leaf, cap, dev):
    """The card's route against ``impl='torch'`` bit for bit: the pack
    kernel's words, the sums (one pack launch and one K1 launch, no host
    sync), and the finalised cloud."""
    from pointcloud_stitching_tpu_torch.kernels.segment_reduce import (
        segment_sum_packed, voxel_pack)
    args = _packed_args(pc, leaf)
    got_w = voxel_pack(*args, impl="cuda")
    want_w = voxel_pack(*args, impl="torch")
    for a, b, name in zip(got_w, want_w, ("key", "off", "col")):
        assert (a is None and b is None) or torch.equal(a, b), name
    _nan_junk(dev, cap, 10)
    torch.cuda.synchronize()
    kb.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = segment_sum_packed(*args, cap, impl="auto")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert dict(kb.LAUNCHES) == {"voxel_pack": 1,
                                 "segment_sum_from_keys": 1}
    want = segment_sum_packed(*args, cap, impl="torch")
    assert torch.equal(got, want)
    a = voxel_downsample(pc, leaf, capacity=cap, impl="auto")
    b = voxel_downsample(pc, leaf, capacity=cap, impl="torch")
    for name in ("xyz", "mask", "rgb"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None and y is None) or torch.equal(x, y), name
    return got


@pytest.mark.parametrize("with_rgb", [False, True])
@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_route_equals_the_composition(cuda_device, case, with_rgb):
    """Capacity below the occupied voxels, no valid point, one, a length
    that is no multiple of 1024, no invalid suffix, one run over every
    tile: the kernels' route gives the composition's bits, and every slot
    past the last run reads 0."""
    pc, leaf, cap = _packed_case(case, cuda_device, with_rgb)
    got = _assert_packed_route_equals_composition(pc, leaf, cap, cuda_device)
    runs = int((got[:, 6] > 0).sum())
    assert not bool(got[runs:].any())
    if case == "saturated":
        assert runs == cap
    elif case in ("all_invalid", "one_point", "one_voxel"):
        assert runs == {"all_invalid": 0}.get(case, 1)


def _bench_global_pass_input(name: str, seed: int, dev):
    """The cloud that reaches the global voxel pass in the first frame of a
    benchmark cell's configuration (its rig, scene and colour at ``seed``),
    with its leaf and capacity."""
    sys.path.insert(0, REPO)
    from benchmark import harness, scene
    from pointcloud_stitching_tpu_torch.models import stitcher
    cfg = harness.config(name)
    rig = scene.make_rig(cfg, seed)
    frames = scene.render_cycle(cfg, rig, seed, dev)
    colors = (scene.render_color(cfg, rig, seed, dev)
              if scene.has_color(cfg) else None)
    ctx = harness.Context(cell=name, cfg=cfg, traffic={}, seed=seed,
                          seconds=0.0, trace=False, device=dev, t_start=0.0)
    pipe = ctx.pipeline(rig.calib)
    st = cfg["stitch"]
    seen = []
    real = stitcher.voxel_downsample

    def spy(pc, leaf, capacity, *a, **kw):
        if capacity == st["out_capacity"] and pc.xyz.dim() == 2:
            seen.append(P.PointCloud(
                xyz=pc.xyz.clone(), mask=pc.mask.clone(),
                rgb=None if pc.rgb is None else pc.rgb.clone()))
        return real(pc, leaf, capacity, *a, **kw)

    stitcher.voxel_downsample = spy
    try:
        pipe(frames[0], None if colors is None else colors[0])
    finally:
        stitcher.voxel_downsample = real
    (pc,) = seen
    return pc, st["out_voxel_leaf"], st["out_capacity"]


@pytest.mark.parametrize("seed", [7, 2026101822])
@pytest.mark.parametrize("name", ["rig8_ring_icp", "rig8_ring_icp_color"])
def test_packed_route_on_the_benchmark_frames(cuda_device, name, seed):
    """The global pass of the benchmark's depth and XYZRGB rigs at 1 cm
    (8 × 848×480, cropped): the route equals the composition bit for bit."""
    pc, leaf, cap = _bench_global_pass_input(name, seed, cuda_device)
    assert int(pc.mask.sum()) > 100_000
    assert (pc.rgb is not None) == name.endswith("color")
    _assert_packed_route_equals_composition(pc, leaf, cap, cuda_device)


def test_packed_route_over_100_calls_and_on_two_streams(cuda_device):
    """100 calls in a row on one stream (the look-back words of each call
    carry its own epoch) and calls on two streams at once each give the
    composition's bits."""
    from pointcloud_stitching_tpu_torch.kernels.segment_reduce import (
        segment_sum_packed)
    cases = [_packed_case(c, cuda_device, rgb) for c, rgb in
             (("cloud", False), ("saturated", True))]
    ins = [(_packed_args(pc, leaf), cap) for pc, leaf, cap in cases]
    wants = [segment_sum_packed(*a, cap, impl="torch") for a, cap in ins]
    for i in range(100):
        a, cap = ins[i % 2]
        assert torch.equal(segment_sum_packed(*a, cap, impl="cuda"),
                           wants[i % 2]), i
    main = torch.cuda.current_stream(cuda_device)
    streams = [torch.cuda.Stream(cuda_device) for _ in ins]
    for st in streams:
        st.wait_stream(main)
    outs = []
    for _ in range(5):
        for st, (a, cap) in zip(streams, ins):
            with torch.cuda.stream(st):
                outs.append(segment_sum_packed(*a, cap, impl="cuda"))
    torch.cuda.synchronize()
    for k, out in enumerate(outs):
        assert torch.equal(out, wants[k % 2]), k


def _map_clouds(rng, dev, n, with_rgb, shift):
    """A cloud of ``n`` points in a 0.8 m cube moved by ``shift`` (+ uint8
    colour), on the card."""
    xyz = (rng.uniform(-0.4, 0.4, (n, 3)) + shift).astype(np.float32)
    rgb = (rng.integers(0, 256, (n, 3)).astype(np.float32) if with_rgb
           else None)
    return P.PointCloud.from_points(xyz, rgb=rgb, device=dev)


@pytest.mark.parametrize("with_rgb,saturated", [
    (False, False), (True, False), (False, True), (True, True)])
def test_flags_segment_kernel_at_the_map_update(cuda_device, with_rgb,
                                                saturated):
    """K1 on what a voxel-map update feeds it (decayed float sums of the map
    beside fresh coordinates, 7 or 10 channels, N = capacity + cloud rows >
    capacity, nearly every row kept, or past the capacity when the map is
    saturated) against its plain version bit for bit."""
    from pointcloud_stitching_tpu_torch.models import voxel_map as VM
    rng = np.random.default_rng(90 + 2 * with_rgb + saturated)
    cap = 4096 if saturated else 1 << 17
    vm = VM.VoxelMap.create(cap, 0.01, with_rgb=with_rgb,
                            device=cuda_device)
    for k in range(3):
        pc = _map_clouds(rng, cuda_device, 30_000, with_rgb, 0.05 * k)
        vm = VM.voxel_map_update(vm, pc, decay=0.9, impl="torch")
    flags, vals = VM._merge_rows(vm, pc, 0.9, 0.05)
    assert vals.shape == (cap + 30_000, 10 if with_rgb else 7)
    assert (int(flags.sum()) > cap) == saturated
    junk = [torch.full((cap, vals.shape[1]), float("nan"),
                       device=cuda_device) for _ in range(2)]
    del junk
    kb.reset_launches()
    got = segment_sum_from_flags(vals, flags, cap, impl="cuda")
    again = segment_sum_from_flags(vals, flags, cap, impl="cuda")
    want = segment_sum_from_flags(vals, flags, cap, impl="torch")
    torch.cuda.synchronize()
    assert kb.LAUNCHES["segment_sum_from_flags"] == 2
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.parametrize("with_rgb", [False, True])
def test_voxel_map_update_auto_equals_torch(cuda_device, with_rgb):
    """Several updates (decay, evictions, max_weight) with K1 equal the
    plain path bit for bit after every update; one K1 launch and no host
    sync per update."""
    from pointcloud_stitching_tpu_torch.models import voxel_map as VM
    rng = np.random.default_rng(95 + with_rgb)
    kw = dict(decay=0.5, min_weight=0.3, max_weight=1.8)
    auto = VM.VoxelMap.create(1 << 16, 0.01, with_rgb=with_rgb,
                              device=cuda_device)
    plain = VM.VoxelMap.create(1 << 16, 0.01, with_rgb=with_rgb,
                               device=cuda_device)
    a, b = (_map_clouds(rng, cuda_device, 20_000, with_rgb, s)
            for s in (0.0, 0.3))
    counts = []
    for cloud in (a, a, a, b, b, b):
        kb.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            auto = VM.voxel_map_update(auto, cloud, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert kb.LAUNCHES["segment_sum_from_flags"] == 1
        plain = VM.voxel_map_update(plain, cloud, impl="torch", **kw)
        for k in ("ijk", "sums", "weight", "leaf", "rgb_sums"):
            x, y = getattr(auto, k), getattr(plain, k)
            assert (x is None and y is None) or torch.equal(x, y), k
        counts.append(int(auto.count()))
    # cloud a's own voxels evict three updates after it was last seen
    assert counts[-1] < counts[-2] and float(auto.weight.max()) <= 1.8


def test_voxel_batched_flat_ids_never_decrease(cuda_device, monkeypatch):
    """The camera batch's flat K2 ids never decrease, with invalid points
    and with clouds of no valid point (the first, a middle one and the
    last), and the pass equals its plain version bit for bit."""
    from pointcloud_stitching_tpu_torch.ops import voxel as V
    rng = np.random.default_rng(52)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (5, 6000, 3)).astype(
        np.float32)).to(cuda_device)
    mask = torch.from_numpy(rng.random((5, 6000)) > 0.3).to(cuda_device)
    mask[[0, 2, 4]] = False
    seen = []
    real = V.segment_sum_sorted

    def spy(vals, seg, capacity, impl="auto"):
        seen.append(seg)
        return real(vals, seg, capacity, impl=impl)

    monkeypatch.setattr(V, "segment_sum_sorted", spy)
    for packed in ("auto", "never"):
        kb.reset_launches()
        pc = P.PointCloud(xyz=xyz, mask=mask)
        got = V.voxel_downsample(pc, 0.02, capacity=2048, packed=packed)
        want = V.voxel_downsample(pc, 0.02, capacity=2048, packed=packed,
                                  impl="torch")
        assert kb.LAUNCHES["segment_sum_sorted"] == 1
        assert torch.equal(got.xyz, want.xyz)
        assert torch.equal(got.mask, want.mask)
        assert not bool(got.mask[[0, 2, 4]].any())
        assert bool((got.mask.sum(-1)[[1, 3]] == 2048).all())  # saturated
    assert len(seen) == 4
    for seg in seen:
        assert bool((seg[1:] >= seg[:-1]).all())


def _nn_check(q, r, mask, dev):
    refT = prepare_ref_batched(r.to(dev), None if mask is None
                               else mask.to(dev))
    qd = q.to(dev)
    gi, gd = nn_batched_prepared(qd, refT, impl="cuda")
    wi, wd = nn_batched_prepared(qd, refT, impl="torch")
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    return gi, gd


@pytest.mark.parametrize("b,n,m", [(8, 2048, 2048), (3, 700, 1001),
                                   (2, 100, 5), (1, 1, 3)])
def test_nn_split_kernel_matches_plain(cuda_device, b, n, m):
    """K3 with the reference split across a cluster: the ring shape, M not
    a multiple of S, and M < S (S is cut to M)."""
    rng = np.random.default_rng(60 + m)
    s = nn_splits(b, n, m)
    assert 1 <= s <= min(NN_MAX_SPLITS, m)
    if (b, n, m) == (8, 2048, 2048):
        assert s >= 2 and s * 4 * b > 64
    q = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(b, m, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random((b, m)) > 0.1)
    mask[:, 0] = True
    _nn_check(q, r, mask, cuda_device)


def test_nn_tie_across_splits_goes_to_the_lower_index(cuda_device):
    """Two equal references in different slices: the lower index wins."""
    m = 2048
    s = nn_splits(8, 2048, m)
    r = torch.zeros((8, m, 3))
    r[..., 0] = torch.arange(m, dtype=torch.float32)
    lo_ref, hi_ref = 100, m - 100           # slice 0 and slice s - 1
    assert lo_ref < m // s and hi_ref >= m * (s - 1) // s
    r[:, lo_ref] = r[:, hi_ref] = torch.tensor([5.5, 3.0, 0.0])
    q = torch.tensor([5.5, 3.0, 0.0]).expand(8, 2048, 3).contiguous()
    gi, gd = _nn_check(q, r, None, cuda_device)
    assert bool((gi == lo_ref).all()) and bool((gd == 0).all())


def test_nn_all_references_masked(cuda_device):
    rng = np.random.default_rng(61)
    q = torch.from_numpy(rng.normal(size=(8, 2048, 3)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(8, 2048, 3)).astype(np.float32))
    gi, gd = _nn_check(q, r, torch.zeros((8, 2048), dtype=torch.bool),
                       cuda_device)
    assert bool((gi == 0).all()) and bool((gd > 1e24).all())


def test_nn_kernel_coarse_registration_shape(cuda_device):
    """B = 1 at 131072 x 8192, the pruned search's coarse pass (S = 1)."""
    rng = np.random.default_rng(62)
    assert nn_splits(1, 131072, 8192) == 1
    q = torch.from_numpy(rng.uniform(-2, 2, (1, 131072, 3)).astype(
        np.float32))
    r = torch.from_numpy(rng.uniform(-2, 2, (1, 8192, 3)).astype(np.float32))
    _nn_check(q, r, torch.from_numpy(rng.random((1, 8192)) > 0.1),
              cuda_device)


def test_pipeline_kernels_match_plain_and_are_launched(cuda_device):
    """Two track-mode frames of a 3-camera rig: the same output with the
    kernels and with the plain versions, and each frame launches one NN
    kernel per ICP iteration, one K1 and one K2."""
    h, w, ncam = 120, 212, 3
    depths = torch.from_numpy(np.stack(
        [synth_depth_frame(h, w, seed=s) for s in range(ncam)]))
    i0 = P.Intrinsics.create(fx=106.0, fy=106.0, ppx=w / 2, ppy=h / 2,
                             width=w, height=h)
    intr = i0.stack([i0] * (ncam - 1))
    ext = np.stack([random_se3(seed=10 + i, max_angle=0.1, max_trans=0.2)
                    for i in range(ncam)])
    cfg = P.StitchConfig(num_cameras=ncam, height=h, width=w,
                         out_voxel_leaf=0.02, out_capacity=65536,
                         icp_voxel_leaf=0.04, icp_capacity=4096,
                         icp_iterations=3, icp_max_corr_dist=0.3)
    outs = {}
    for impl in ("auto", "torch"):
        pipe = P.StitchingPipeline(dataclasses.replace(cfg, kernel_impl=impl),
                                   intr, ext, device=cuda_device,
                                   update_mode="track")
        kb.reset_launches()
        for _ in range(2):
            out = pipe(depths)
        torch.cuda.synchronize()
        outs[impl] = (out, dict(kb.LAUNCHES))
    (a, la), (b, lb) = outs["auto"], outs["torch"]
    assert la == {"nn_batched_prepared": 6, "segment_sum_from_keys": 2,
                  "segment_sum_sorted": 2, "voxel_pack": 2}
    assert not lb
    assert torch.equal(a.extrinsics, b.extrinsics)
    assert torch.equal(a.cloud.mask, b.cloud.mask)
    assert torch.equal(a.cloud.xyz, b.cloud.xyz)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _sorted_scene(rng, dev, b=2, n=20_000, m=30_001):
    """References sorted along x (coherent blocks, as voxel order gives;
    m leaves a ragged last block), queries near them in the same order,
    about 10% of each masked."""
    r = rng.uniform(-1, 1, (b, m, 3)).astype(np.float32)
    r[..., 0] *= 20.0
    r = np.take_along_axis(r, np.argsort(r[..., 0], axis=1)[..., None], 1)
    q = (r[:, np.sort(rng.integers(0, m, n))]
         + rng.normal(0, 0.02, (b, n, 3))).astype(np.float32)
    return (torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev),
            torch.from_numpy(rng.random((b, m)) > 0.1).to(dev),
            torch.from_numpy(rng.random((b, n)) > 0.1).to(dev))


@pytest.mark.parametrize("query_tile", [1024, 128])
@pytest.mark.parametrize("ranges", ["block_ranges", "narrowed"])
def test_ranged_kernel_matches_plain(rng, cuda_device, query_tile, ranges):
    """K4 against its plain version on every query (masked ones too), with
    the ranges block_ranges gives and with ranges cut to one block."""
    q, r, rmask, qmask = _sorted_scene(rng, cuda_device)
    _, ub = nearest_neighbors_pallas_batched(q, r[:, ::16], rmask[:, ::16],
                                             impl="cuda")
    jlo, jhi = block_ranges(q, qmask, r, rmask, ub, query_tile=query_tile,
                            ref_block=2048)
    if ranges == "narrowed":
        jhi = jlo.clone()
    refT = prepare_ref_batched(r, rmask)
    kb.reset_launches()
    kw = dict(query_tile=query_tile, ref_block=2048)
    gi, gd = nn_batched_prepared_ranged(q, refT, jlo, jhi, impl="cuda", **kw)
    wi, wd = nn_batched_prepared_ranged(q, refT, jlo, jhi, impl="torch",
                                        **kw)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["nn_batched_prepared_ranged"] == 1
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    bi, bd = nn_batched_prepared(q, refT, impl="cuda")
    if ranges == "narrowed":  # a kernel that ignored its ranges fails here
        assert int((gi != bi).sum()) > 1000
    else:
        assert torch.equal(gi[qmask], bi[qmask])
        assert torch.equal(gd[qmask], bd[qmask])


def test_pruned_nn_matches_brute_force(rng, cuda_device):
    q, r, rmask, qmask = _sorted_scene(rng, cuda_device)
    kb.reset_launches()
    gi, gd = nearest_neighbors_pruned(q, r, rmask, qmask, impl="cuda")
    assert dict(kb.LAUNCHES) == {"nn_batched_prepared": 1,
                                 "nn_batched_prepared_ranged": 1}
    bi, bd = nearest_neighbors_pallas_batched(q, r, rmask, impl="cuda")
    assert torch.equal(gi[qmask], bi[qmask])
    assert torch.equal(gd[qmask], bd[qmask])


def test_ranged_tie_goes_to_the_lower_index(cuda_device):
    """Equal references in two blocks of one range: the lower index wins."""
    r = torch.zeros((1, 5000, 3))
    r[0, :, 0] = torch.arange(5000, dtype=torch.float32)
    r[0, 4500] = r[0, 700] = torch.tensor([7.0, 1.0, 0.0])
    q = torch.tensor([7.0, 1.0, 0.0]).expand(1, 300, 3).contiguous()
    refT = prepare_ref_batched(r.to(cuda_device), None)
    lo = torch.zeros((1, 3), dtype=torch.int32, device=cuda_device)
    for qt in (128, 1024):
        nq = -(-300 // qt)
        gi, gd = nn_batched_prepared_ranged(
            q.to(cuda_device), refT, lo[:, :nq], lo[:, :nq] + 2,
            query_tile=qt, ref_block=2048, impl="cuda")
        assert bool((gi == 700).all()) and bool((gd == 0).all())


@pytest.mark.parametrize("query_tile", [1024, 128])
def test_ranged_kernel_uneven_ranges(cuda_device, query_tile):
    """K4 on ranges of very different lengths in one launch (B = 3, M not a
    multiple of ref_block): a tile that sweeps every block beside tiles that
    sweep one, empty ranges (jlo > jhi) giving (+inf, 0), ranges that run
    past the last block, and a masked and a NaN query; equal to the plain
    version on every query, twice. (K4 keeps nothing between calls, its
    scratch is allocated by each, so there is no two-stream case.)"""
    rng = np.random.default_rng(80)
    b, n, m, rb = 3, 5000, 30_001, 2048
    nq, nm = -(-n // query_tile), -(-m // rb)
    q_np = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    q_np[0, 17] = np.nan
    q = torch.from_numpy(q_np).to(cuda_device)
    r = torch.from_numpy(rng.uniform(-1, 1, (b, m, 3)).astype(np.float32))
    refT = prepare_ref_batched(r.to(cuda_device), torch.from_numpy(
        rng.random((b, m)) > 0.1).to(cuda_device))
    jlo = rng.integers(0, nm, (b, nq))
    jhi = jlo.copy()                        # most tiles sweep one block
    jlo[:, 1], jhi[:, 1] = 0, nm - 1        # one sweeps them all
    jlo[:, 2], jhi[:, 2] = 5, 3             # empty
    jlo[1, 0], jhi[1, 0] = nm - 2, nm + 3   # past the last block
    jlo[2, nq - 1], jhi[2, nq - 1] = 9, 0   # the ragged tile, empty
    lo = torch.from_numpy(jlo.astype(np.int32)).to(cuda_device)
    hi = torch.from_numpy(jhi.astype(np.int32)).to(cuda_device)
    chunks = nn_ranged_chunks(lo, hi, n, m, query_tile, rb)
    assert int(chunks.max()) == -(-m // NN_RANGED_CHUNK)
    kw = dict(query_tile=query_tile, ref_block=rb)
    gi, gd = nn_batched_prepared_ranged(q, refT, lo, hi, impl="cuda", **kw)
    ai, ad = nn_batched_prepared_ranged(q, refT, lo, hi, impl="cuda", **kw)
    wi, wd = nn_batched_prepared_ranged(q, refT, lo, hi, impl="torch", **kw)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    assert torch.equal(gi, ai) and torch.equal(gd, ad)
    empty = slice(2 * query_tile, 3 * query_tile)
    assert bool((gi[:, empty] == 0).all()) and bool(gd[:, empty].isinf().all())
    assert int(gi[0, 17]) == 0 and bool(gd[0, 17].isinf())


def test_ranged_tie_across_chunks_goes_to_the_lower_index(cuda_device):
    """Equal references in two work items (chunks) of one range, and in two
    stages of one chunk: the lower index wins in both."""
    m = 3 * NN_RANGED_CHUNK + 100
    r = torch.zeros((1, m, 3))
    r[0, :, 0] = torch.arange(m, dtype=torch.float32) + 10.0
    first, second = 300, 2 * NN_RANGED_CHUNK + 50     # chunks 0 and 2
    r[0, first] = r[0, second] = torch.tensor([1.0, 2.0, 0.0])
    near, later = NN_RANGED_CHUNK + 10, NN_RANGED_CHUNK + 1500  # chunk 1
    r[0, near] = r[0, later] = torch.tensor([-4.0, 0.0, 0.0])
    q = torch.tensor([1.0, 2.0, 0.0]).repeat(1, 700, 1)
    q[0, 1::2] = torch.tensor([-4.0, 0.0, 0.0])
    refT = prepare_ref_batched(r.to(cuda_device), None)
    lo = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    gi, gd = nn_batched_prepared_ranged(
        q.to(cuda_device), refT, lo, lo + 3, query_tile=1024,
        ref_block=NN_RANGED_CHUNK, impl="cuda")
    assert bool((gi[0, 0::2] == first).all())
    assert bool((gi[0, 1::2] == near).all()) and bool((gd == 0).all())


def test_pruned_icp_converge_launches_k4(rng, cuda_device):
    """icp_converge(prune=True) with kernels launches one K3 (coarse pass)
    and one K4 per iteration and equals the plain run."""
    q, r, rmask, _ = _sorted_scene(rng, cuda_device, b=1)
    src = P.PointCloud(xyz=q[0] + 0.01, mask=torch.ones_like(q[0, :, 0],
                                                             dtype=torch.bool))
    dst = P.PointCloud(xyz=r[0], mask=rmask[0])
    out = {}
    for impl in ("auto", "torch"):
        kb.reset_launches()
        res = icp_converge(src, dst, max_iterations=6, max_corr_dist=0.1,
                           nn_impl=impl, prune=True)
        torch.cuda.synchronize()
        out[impl] = (res, dict(kb.LAUNCHES))
    (a, la), (b, lb) = out["auto"], out["torch"]
    it = int(a.iterations)
    assert la == {"nn_batched_prepared": it, "nn_batched_prepared_ranged": it}
    assert not lb
    assert torch.equal(a.T, b.T) and int(b.iterations) == it


@pytest.mark.parametrize("h,w", [(480, 848), (48, 64), (520, 1030)])
def test_patch_gather_kernel_matches_plain(rng, cuda_device, h, w):
    """K5 against its plain version, bit for bit: starts that are
    negative, unaligned and clamped at the bottom-right edge; local indices
    inside the window, in the alignment slop and outside it."""
    nb = 4096
    img = rng.uniform(0.1, 5.0, (h, w)).astype(np.float32)
    v0 = rng.integers(-20, h + 20, nb).astype(np.int32)
    u0 = rng.integers(-200, w + 200, nb).astype(np.int32)
    v0[:4] = [-3, h - 2, max(h - 129, 0), 7]
    u0[:4] = [-130, w - 5, max(w - 257, 0), 127]
    iv = rng.integers(-10, 140, (nb, 512)).astype(np.int32)
    iu = rng.integers(-140, 270, (nb, 512)).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (img, v0, u0, iv,
                                                           iu)]
    kb.reset_launches()
    got = patch_gather(*args, impl="cuda")
    want = patch_gather(*args, impl="torch")
    torch.cuda.synchronize()
    assert kb.LAUNCHES["patch_gather"] == 1
    assert torch.equal(got, want)
    assert bool((want == 0).any()) and bool((want != 0).any())
    empty = patch_gather(args[0], args[1][:0], args[2][:0], args[3][:0],
                         args[4][:0], impl="cuda")
    assert empty.shape == (0, 512)


def _tsdf_scene(dev, w=160, h=120, f=100.0):
    """Three cameras of two spheres and a wall (tests/test_tsdf.py's scene,
    rendered by chip_smoke.py's numpy renderer), with a dead patch in the
    first frame."""
    sys.path.insert(0, REPO)
    from chip_smoke import render_depth
    scene = dict(spheres=[((-0.15, 0.05, 0.55), 0.12),
                          ((0.18, -0.08, 0.65), 0.10)],
                 planes=[((0.0, 0.0, -1.0), -0.9)])
    exts, ds = [], []
    for i in range(3):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.08 * (i - 1), 0.02 * i, -0.03 * i]
        exts.append(T)
        ds.append(render_depth(f, f, w / 2.0, h / 2.0, w, h, T, **scene))
    ds[0][20:60, 40:90] = 0.0
    i0 = P.Intrinsics.create(fx=f, fy=f, ppx=w / 2.0, ppy=h / 2.0, width=w,
                             height=h, device=dev)
    depth = torch.from_numpy((np.stack(ds) * 1000).astype(np.uint16))
    return (depth.to(dev), i0.stack([i0] * 2),
            torch.from_numpy(np.stack(exts)).to(dev))


@pytest.mark.parametrize("with_rgb", [False, True])
def test_integrate_auto_matches_dense_on_the_card(rng, cuda_device, with_rgb):
    """The pruned path through K5 equals the dense oracle bit for bit on
    a 64^3 volume, two frames deep; K5 launches once per gathered plane
    per camera, and never under kernel_impl='torch'."""
    depth, intr, ext = _tsdf_scene(cuda_device)
    color = (torch.from_numpy(rng.integers(0, 256, (*depth.shape, 3),
                                           dtype=np.uint8)).to(cuda_device)
             if with_rgb else None)
    out = {}
    for method, impl in (("dense", "auto"), ("auto", "auto"),
                         ("auto", "torch")):
        vol = TM.TSDFVolume.create((64, 64, 64), 0.02,
                                   origin=(-0.64, -0.64, 0.0),
                                   with_rgb=with_rgb, device=cuda_device)
        kb.reset_launches()
        for _ in range(2):
            vol = TM.integrate(vol, depth, intr, ext, color=color,
                               method=method, kernel_impl=impl)
        torch.cuda.synchronize()
        out[(method, impl)] = (vol, dict(kb.LAUNCHES))
    dense, _ = out[("dense", "auto")]
    assert float(dense.weight.sum()) > 0
    for key in (("auto", "auto"), ("auto", "torch")):
        vol, _ = out[key]
        assert torch.equal(vol.tsdf, dense.tsdf)
        assert torch.equal(vol.weight, dense.weight)
        if with_rgb:
            assert torch.equal(vol.rgb, dense.rgb)
    planes = 2 if with_rgb else 1
    assert out[("auto", "auto")][1] == {"patch_gather": 2 * 3 * planes}
    assert not out[("auto", "torch")][1]
    assert not out[("dense", "auto")][1]


@pytest.mark.parametrize("color", [False, True])
def test_stream_client_on_the_card(cuda_device, color):
    """The pipelined client on a CUDA pipeline: snapshots in pinned ring
    slots, copied on a side stream; with sync_every=3 the ring wraps while
    copies may be in flight, and every output equals a direct call bit for
    bit, with K1, K2 and K3 launched per frame."""
    from pointcloud_stitching_tpu_torch.runtime import (
        Codec, FakeCameraServer, MulticameraClient, synthetic_frames)
    ncam, h, w = 3, 120, 212
    servers = [FakeCameraServer(synthetic_frames(1, h, w, seed=s),
                                codec=Codec.SNAPPY, color=color).start()
               for s in range(ncam)]
    client = None
    try:
        cfg = P.StitchConfig(num_cameras=ncam, height=h, width=w,
                             out_voxel_leaf=0.02, out_capacity=65536,
                             icp_voxel_leaf=0.05, icp_capacity=1024,
                             with_color=color)
        i0 = P.Intrinsics.create(fx=106.0, fy=106.0, ppx=w / 2, ppy=h / 2,
                                 width=w, height=h)
        ext = np.stack([random_se3(seed=10 + i, max_angle=0.05,
                                   max_trans=0.1) for i in range(ncam)])
        pipe = P.StitchingPipeline(cfg, i0.stack([i0] * (ncam - 1)), ext,
                                   device=cuda_device)
        d = torch.from_numpy(np.stack([s.frames[0] for s in servers]))
        c = (torch.from_numpy(np.stack([s.colors[0] for s in servers]))
             if color else None)
        want = pipe(d.to(cuda_device),
                    None if c is None else c.to(cuda_device))
        client = MulticameraClient([("127.0.0.1", s.port) for s in servers],
                                   pipe).start()
        assert client.wait_for_first_frames(timeout=20)
        outs = []
        kb.reset_launches()
        client.run(num_frames=10, sync_every=3,
                   on_frame=lambda i, o: outs.append(o))
        torch.cuda.synchronize()
        assert dict(kb.LAUNCHES) == {"nn_batched_prepared": 50,
                                     "segment_sum_from_keys": 10,
                                     "segment_sum_sorted": 10,
                                     "voxel_pack": 10}
        assert all(t.is_pinned() for st in client._stage_ring
                   for t in st.host.values() if t is not None)
        assert len(outs) == 10
        for o in outs:
            assert o.depth.is_cuda and o.depth.dtype == torch.uint16
            assert torch.equal(o.depth.cpu(), d)
            for k in ("xyz", "mask", "rgb"):
                a, b = getattr(o.cloud, k), getattr(want.cloud, k)
                assert (a is None and b is None) or torch.equal(a, b), k
            assert torch.equal(o.extrinsics, want.extrinsics)
    finally:
        if client is not None:
            client.stop()
        for s in servers:
            s.stop()


# --- the registration extras -------------------------------------------------

def _bumps(seed, n):
    """A smooth height field of Gaussian bumps (heterogeneous curvature)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    z = np.zeros(n)
    for c, a, s in zip(rng.uniform(-1, 1, (12, 2)), rng.uniform(-.25, .25, 12),
                       rng.uniform(0.08, 0.3, 12)):
        z += a * np.exp(-((xy - c) ** 2).sum(1) / (2 * s * s))
    return np.concatenate([xy, z[:, None]], 1).astype(np.float32)


def test_gicp_and_ndt_on_the_card_match_cpu(cuda_device):
    """estimate_normals, gicp (K3 every iteration) and ndt_build (K2) +
    ndt_align on the card against the port on the CPU: T within 1e-5,
    iterations equal."""
    from pointcloud_stitching_tpu_torch.ops import (estimate_normals, gicp,
                                                    ndt_align, ndt_build)
    xyz = _bumps(11, 1500)
    T_true = random_se3(seed=3, max_angle=0.2, max_trans=0.05)
    dst = (xyz @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda_device):
        s = P.PointCloud.from_points(xyz, device=dev)
        d = P.PointCloud.from_points(dst, device=dev)
        ns, oks = estimate_normals(s, 0.15)
        nd, okd = estimate_normals(d, 0.15)
        kb.reset_launches()
        g = gicp(s, d, ns, nd, oks, okd, max_corr_dist=0.5)
        launches = dict(kb.LAUNCHES)
        m = ndt_build(d, 0.2)
        a = ndt_align(s.replace(xyz=s.xyz + 0.01), m)
        res[str(dev)] = (g, a, launches, oks)
    (gc, ac, lc, okc), (gg, ag, lg, okg) = res["cpu"], res[str(cuda_device)]
    assert torch.equal(okc, okg.cpu())
    np.testing.assert_allclose(gg.T.cpu().numpy(), gc.T.numpy(), atol=1e-5)
    assert int(gg.iterations) == int(gc.iterations)
    assert lg == {"nn_batched_prepared": int(gg.iterations)} and not lc
    np.testing.assert_allclose(ag.T.cpu().numpy(), ac.T.numpy(), atol=1e-5)
    assert int(ag.iterations) == int(ac.iterations)


def test_ndt_build_kernel_route_equals_plain(cuda_device):
    """ndt_build through K2 ('cuda') equals its plain route ('torch') on
    the card bit for bit, invalid rows jumping to the catch-all slot."""
    from pointcloud_stitching_tpu_torch.ops import ndt_build
    xyz = _bumps(12, 3000)
    mask = np.random.default_rng(12).random(3000) > 0.2
    d = P.PointCloud(xyz=torch.from_numpy(xyz).to(cuda_device),
                     mask=torch.from_numpy(mask).to(cuda_device))
    kb.reset_launches()
    got = ndt_build(d, 0.2, impl="cuda")
    assert dict(kb.LAUNCHES) == {"segment_sum_sorted": 2}
    want = ndt_build(d, 0.2, impl="torch")
    for f in ("keys", "mu", "inv_cov", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_match_fpfh_holds_full_fp32_under_tf32(cuda_device):
    """match_fpfh's cross term accumulates in float64, so TF32 switched on
    process-wide leaves its indices equal to the CPU's."""
    from pointcloud_stitching_tpu_torch.ops import match_fpfh
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0, 100, (3000, 33)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0, 100, (4000, 33)).astype(np.float32))
    b[3000:3500] = b[:500]                        # exact ties
    ok_a = torch.from_numpy(rng.random(3000) > 0.1)
    ok_b = torch.from_numpy(rng.random(4000) > 0.1)
    want = match_fpfh(a, ok_a, b, ok_b, k=4)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        got = match_fpfh(a.to(cuda_device), ok_a.to(cuda_device),
                         b.to(cuda_device), ok_b.to(cuda_device), k=4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert torch.equal(got[0].cpu(), want[0])
    # |a|^2 + |b|^2 ~ 2e5 is summed in float32 in another order on each
    # device: d2 agrees to a few of its ulps (0.016 each)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                               atol=0.1)


def test_pose_graph_holds_full_fp32_under_tf32(cuda_device):
    """optimize_pose_graph solves in float64: with TF32 on and after
    set_full_fp32_matmul it gives the same poses within 1e-6, and the
    CPU's."""
    from pointcloud_stitching_tpu_torch.models import optimize_pose_graph
    from pointcloud_stitching_tpu_torch.utils.platform import (
        set_full_fp32_matmul)
    gt = np.stack([np.eye(4, dtype=np.float32)]
                  + [random_se3(seed=k, max_angle=0.5, max_trans=1.0)
                     for k in range(1, 6)])
    edges = np.asarray([(i - 1, i) for i in range(1, 6)] + [(5, 0), (0, 3)],
                       np.int32)
    meas = np.stack([np.linalg.inv(gt[i]) @ gt[j] @ random_se3(
        seed=40 + k, max_angle=0.02, max_trans=0.02)
        for k, (i, j) in enumerate(edges)]).astype(np.float32)
    init = np.stack([g @ random_se3(seed=60 + k, max_angle=0.05,
                                    max_trans=0.05)
                     for k, g in enumerate(gt)]).astype(np.float32)

    def solve(dev):
        return optimize_pose_graph(
            torch.from_numpy(init).to(dev), torch.from_numpy(edges).to(dev),
            torch.from_numpy(meas).to(dev), iterations=10).poses.cpu()

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        tf32 = solve(cuda_device)
        set_full_fp32_matmul()
        full = solve(cuda_device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    np.testing.assert_allclose(tf32.numpy(), full.numpy(), atol=1e-6)
    np.testing.assert_allclose(full.numpy(), solve("cpu").numpy(), atol=1e-6)


def _analysis_scene(seed=7, n=2048):
    """Four blobs and a plane of clutter, a tenth masked (float32)."""
    rng = np.random.default_rng(seed)
    xyz = np.c_[rng.uniform(-1, 1, (n, 2)), rng.normal(0, 0.002, n)]
    for c in range(4):
        xyz[c * 200:(c + 1) * 200] = (rng.normal(0, 0.04, (200, 3))
                                      + np.array([0.5 * c - 0.7, 0.3, 0.3]))
    return (torch.from_numpy(xyz.astype(np.float32)),
            torch.from_numpy(rng.random(n) > 0.1))


def test_segment_plane_holds_full_fp32_under_tf32(cuda_device):
    """segment_plane's products are elementwise and its refit runs in
    float64: with TF32 switched on process-wide, the card's model, inliers
    and count equal those with it off, and the CPU's model within 1e-6."""
    from pointcloud_stitching_tpu_torch.ops import sac
    xyz, mask = _analysis_scene()
    idx = prng.choice(prng.key(1), mask.shape[0], (256, 3),
                      p=mask.float() / mask.sum())
    pc = P.PointCloud(xyz=xyz, mask=mask)
    pcg = P.PointCloud(xyz=xyz.to(cuda_device), mask=mask.to(cuda_device))
    want = sac._segment_plane_from_indices(pc, idx, 0.01)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        tf32 = sac._segment_plane_from_indices(pcg, idx, 0.01)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        full = sac._segment_plane_from_indices(pcg, idx, 0.01)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    for a, b in zip(tf32, full):
        assert torch.equal(a, b)
    np.testing.assert_allclose(full[0].cpu().numpy(), want[0].numpy(),
                               atol=1e-6)
    assert torch.equal(full[1].cpu(), want[1])
    assert int(full[2]) > 1000


def test_analysis_ops_on_the_card_match_cpu(cuda_device):
    """Filters, the three clusterers (scatter-min, stable sort,
    searchsorted, the int64 ranking key), cluster boxes, support points and
    crop_hull: the card equals the CPU on one scene."""
    from pointcloud_stitching_tpu_torch import ops as O
    from pointcloud_stitching_tpu_torch.ops import hull as HL
    xyz, mask = _analysis_scene()
    pc = P.PointCloud(xyz=xyz, mask=mask)
    pcg = P.PointCloud(xyz=xyz.to(cuda_device), mask=mask.to(cuda_device))
    for fn in (lambda c: O.radius_outlier_removal(c, 0.05, 4).mask,
               lambda c: O.statistical_outlier_removal(c, 8).mask,
               lambda c: O.euclidean_clusters(c, 0.05, min_size=5),
               lambda c: O.euclidean_clusters_exact(c, 0.05, min_size=5),
               lambda c: O.crop_hull(c, HL.convex_hull(pc)).mask):
        got, want = fn(pcg), fn(pc)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a.cpu(), b)
    nrm, ok = O.estimate_normals(pc, 0.1)
    rg = [O.region_growing(c, nrm.to(c.xyz.device), 0.05, 0.3,
                           normals_valid=ok.to(c.xyz.device))
          for c in (pcg, pc)]
    for a, b in zip(*rg):
        assert torch.equal(a.cpu(), b)
    lab = O.euclidean_clusters(pc, 0.05, min_size=5)[0]
    for g, w in zip(O.cluster_stats(pcg, lab.to(cuda_device)),
                    O.cluster_stats(pc, lab)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-6)
    g = O.oriented_bboxes(pcg, lab.to(cuda_device))
    w = O.oriented_bboxes(pc, lab)
    for i in (0, 2):
        np.testing.assert_allclose(g[i].cpu().numpy(), w[i].numpy(),
                                   atol=1e-5)
    sign = torch.where((g[1].cpu() * w[1]).sum(-1, keepdim=True) < 0, -1, 1)
    np.testing.assert_allclose((g[1].cpu() * sign).numpy(), w[1].numpy(),
                               atol=1e-5)
    dirs = torch.from_numpy(HL.fibonacci_directions(1024))
    assert torch.equal(
        HL._support_indices(pcg.xyz, pcg.mask, dirs.to(cuda_device)).cpu(),
        HL._support_indices(xyz, mask, dirs))


def test_prng_kernels_match_plain(cuda_device):
    """threefry2x32 and the XLA-order scan on the card, bit for bit their
    plain versions, at 1 and 262,144 counters and a 262,144-slot mask;
    and the draws made from them equal the CPU's."""
    kb.reset_launches()
    for seed in (0, 5, 2 ** 32 + 7):
        k = prng.key(seed, device=cuda_device)
        for n in (1, 17, 262144):
            for pairs in (False, True):
                got = KP.threefry2x32(k, n, pairs, impl="cuda")
                want = KP.threefry2x32(k, n, pairs, impl="torch")
                assert torch.equal(got, want)
                assert torch.equal(got.cpu(), KP.threefry2x32(
                    k.cpu(), n, pairs))
    rng = np.random.default_rng(3)
    for n in (1, 16, 17, 300, 262144):
        m = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32))
        p = (m / torch.clamp(m.sum(), min=1.0)).to(cuda_device)
        got = KP.scan16(p, impl="cuda")
        assert torch.equal(got, KP.scan16(p, impl="torch"))
        assert torch.equal(got.cpu(), KP.scan16(p.cpu()))
        k = prng.key(7, device=cuda_device)
        assert torch.equal(prng.choice(k, n, (64, 3), p=p).cpu(),
                           prng.choice(k.cpu(), n, (64, 3), p=p.cpu()))
    assert kb.LAUNCHES["threefry2x32"] >= 18
    assert kb.LAUNCHES["scan16"] >= 5


def test_segment_plane_on_the_card_matches_cpu(cuda_device):
    """The same key draws the same hypotheses on both devices, so the
    plane is the CPU's."""
    from pointcloud_stitching_tpu_torch.ops import sac
    xyz, mask = _analysis_scene()
    pc = P.PointCloud(xyz=xyz, mask=mask)
    pcg = P.PointCloud(xyz=xyz.to(cuda_device), mask=mask.to(cuda_device))
    want = sac.segment_plane(pc, 0.01, prng.key(0), num_hypotheses=256)
    got = sac.segment_plane(pcg, 0.01, prng.key(0, device=cuda_device),
                            num_hypotheses=256)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               atol=1e-6)
    assert torch.equal(got[1].cpu(), want[1])
    assert int(got[2]) == int(want[2]) > 1000


def test_a_cpu_key_draws_on_the_card(cuda_device):
    """A key made on the CPU with a cloud on the card: the hash and the
    scan run on the card (the key moves there), and the plane is the one
    a key on the card gives."""
    from pointcloud_stitching_tpu_torch.ops import sac
    xyz, mask = _analysis_scene()
    pcg = P.PointCloud(xyz=xyz.to(cuda_device), mask=mask.to(cuda_device))
    want = sac.segment_plane(pcg, 0.01, prng.key(0, device=cuda_device),
                             num_hypotheses=256)
    kb.reset_launches()
    got = sac.segment_plane(pcg, 0.01, prng.key(0), num_hypotheses=256)
    assert kb.LAUNCHES["threefry2x32"] == 1 and kb.LAUNCHES["scan16"] == 1
    assert got[0].device == pcg.xyz.device
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    p = mask.float() / mask.sum()
    idx = prng.choice(prng.key(3), p.shape[0], (8, 3), p=p.to(cuda_device))
    assert idx.device == pcg.xyz.device
    assert torch.equal(idx.cpu(), prng.choice(prng.key(3), p.shape[0],
                                              (8, 3), p=p))


def test_float_draws_on_the_card_match_cpu(cuda_device):
    """uniform on a range, normal and categorical: the card's samples are
    the CPU's bit for bit (the range's multiply-add is made in float64,
    where the product is exact). CUDA's erfinv and log may differ from the
    CPU's by a few ulps, so normal is held to 1e-5 relative, the bound
    against JAX, and gumbel to 1e-6; the categorical's indices equal."""
    for seed in (0, 5, 2 ** 32 + 7):
        kc = prng.key(seed)
        kg = kc.to(cuda_device)
        for lo, hi in ((-2.5, 7.0), (0.1, 0.7), (-3.3e-3, 1e4)):
            assert torch.equal(
                prng.uniform(kg, (262144,), lo, hi).cpu().view(torch.int32),
                prng.uniform(kc, (262144,), lo, hi).view(torch.int32))
        torch.testing.assert_close(prng.normal(kg, (39, 4)).cpu(),
                                   prng.normal(kc, (39, 4)),
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(prng.gumbel(kg, (4096,)).cpu(),
                                   prng.gumbel(kc, (4096,)),
                                   rtol=1e-6, atol=1e-6)
        logits = torch.where(torch.arange(1024) % 5 != 0, 0.0, -1e9)
        assert torch.equal(
            prng.categorical(kg, logits.to(cuda_device), shape=(64, 3)).cpu(),
            prng.categorical(kc, logits, shape=(64, 3)))


def test_register_global_torch_route_launches_no_draw_kernel(cuda_device):
    """kernel_impl='torch' keeps the draws on their plain versions too."""
    from pointcloud_stitching_tpu_torch.models import registration as PR
    rng = np.random.default_rng(0)
    xyz = torch.from_numpy(rng.random((2000, 3)).astype(np.float32))
    pc = P.PointCloud(xyz=xyz.to(cuda_device),
                      mask=torch.ones(2000, dtype=torch.bool,
                                      device=cuda_device))
    kb.reset_launches()
    PR.register_global(pc, pc, prng.key(0), num_starts=26, coarse_leaf=0.1,
                       coarse_capacity=256, refine=False, fpfh_starts=4,
                       kernel_impl="torch")
    assert kb.LAUNCHES["threefry2x32"] == 0 and kb.LAUNCHES["scan16"] == 0
    PR.register_global(pc, pc, prng.key(0), num_starts=26, coarse_leaf=0.1,
                       coarse_capacity=256, refine=False, fpfh_starts=4)
    assert kb.LAUNCHES["threefry2x32"] == 7
