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
    nn_batched_prepared, nn_batched_prepared_ranged, prepare_ref_batched)
from pointcloud_stitching_tpu_torch.kernels.patch_gather import patch_gather
from pointcloud_stitching_tpu_torch.models import tsdf as TM
from pointcloud_stitching_tpu_torch.ops import icp_converge
from pointcloud_stitching_tpu_torch.kernels.segment_reduce import (
    segment_sum_from_flags, segment_sum_sorted)
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
        seg = torch.cumsum(f.to(torch.int32), 0, dtype=torch.int32) - 1
        seg = torch.where((seg >= 0) & (seg < cap), seg, cap).to(torch.int32)
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
    assert la == {"nn_batched_prepared": 6, "segment_sum_from_flags": 2,
                  "segment_sum_sorted": 2}
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
