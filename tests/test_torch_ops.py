"""The port's ops against the JAX package's, on the same numpy inputs.

JAX runs on the CPU as the rest of the suite runs it; the port gets CPU
tensors (so its kernel wrappers take their plain versions). Tolerances are
stated per op; the voxel and ICP ones are those of the port's contract.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointcloud_stitching_tpu.ops as J
import pointcloud_stitching_tpu.ops.se3 as JS
from pointcloud_stitching_tpu import Intrinsics as JIntrinsics
from pointcloud_stitching_tpu import PointCloud as JPointCloud
from pointcloud_stitching_tpu.ops.icp import _trim_weights as jax_trim
from pointcloud_stitching_tpu.utils.config import StitchConfig as JConfig
import pointcloud_stitching_tpu_torch.ops as T
from pointcloud_stitching_tpu_torch import PointCloud, StitchConfig
from pointcloud_stitching_tpu_torch.kernels.segment_reduce import (
    SENTINEL, finalize_packed, packed_rows, run_starts, segment_sum_from_flags,
    segment_sum_from_keys, segment_sum_packed, segment_sum_plain, voxel_pack)
from pointcloud_stitching_tpu_torch.ops.icp import _trim_weights
from pointcloud_stitching_tpu_torch.utils.convert import (
    extrinsics_from_numpy, intrinsics_from_numpy)
from pointcloud_stitching_tpu_torch.utils.types import DistortionModel
from oracle import random_se3, synth_depth_frame


@pytest.fixture
def rng():
    """A fresh generator per test: the suite-wide one of conftest.py
    would make each test's inputs depend on the tests that ran before."""
    return np.random.default_rng(1234)


def t(a):
    return torch.tensor(np.asarray(a))


def n(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# --- se3 ----------------------------------------------------------------

def _poses(rng, k=4, angle=0.3):
    return np.stack([random_se3(seed=int(s), max_angle=angle, max_trans=0.5)
                     for s in rng.integers(0, 10_000, k)])


@pytest.mark.parametrize("name", ["se3_inverse", "so3_log", "so3_exp",
                                  "se3_power", "se3_blend", "se3_apply",
                                  "transform_cloud"])
def test_se3_ops_match_jax(rng, name):
    Ts = _poses(rng)
    pts = rng.normal(size=(4, 50, 3)).astype(np.float32)
    mask = rng.random((4, 50)) > 0.2
    omega = (rng.normal(size=(4, 3)) * 0.3).astype(np.float32)
    omega[0] = 0.0                                # the series branch
    alpha = np.array([0.0, 0.25, -0.5, 1.0], np.float32)
    if name == "se3_inverse":
        want, got = JS.se3_inverse(jnp.asarray(Ts)), T.se3_inverse(t(Ts))
    elif name == "so3_log":
        want = JS.so3_log(jnp.asarray(Ts[:, :3, :3]))
        got = T.so3_log(t(Ts[:, :3, :3]))
    elif name == "so3_exp":
        want, got = JS.so3_exp(jnp.asarray(omega)), T.so3_exp(t(omega))
    elif name == "se3_power":
        want = JS.se3_power(jnp.asarray(Ts[0]), jnp.asarray(alpha))
        got = T.se3_power(t(Ts[0]), t(alpha))
    elif name == "se3_blend":
        want = JS.se3_blend(jnp.asarray(Ts), jnp.asarray(Ts[::-1]), 0.05)
        got = T.se3_blend(t(Ts), t(Ts[::-1].copy()), 0.05)
    elif name == "se3_apply":
        want = J.se3_apply(jnp.asarray(Ts), jnp.asarray(pts))
        got = T.se3_apply(t(Ts), t(pts))
    else:
        want = J.transform_cloud(jnp.asarray(Ts[1]), JPointCloud(
            xyz=jnp.asarray(pts[0]), mask=jnp.asarray(mask[0]))).xyz
        got = T.transform_cloud(t(Ts[1]), PointCloud(
            xyz=t(pts[0]), mask=t(mask[0]))).xyz
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)


def test_se3_compose_matches_jax():
    # a local generator: the suite-wide rng fixture feeds later tests
    Ts = _poses(np.random.default_rng(7))
    np.testing.assert_allclose(
        n(T.se3_compose(t(Ts), t(Ts[::-1].copy()))),
        n(JS.se3_compose(jnp.asarray(Ts), jnp.asarray(Ts[::-1]))), atol=1e-6)


# --- deproject, decimate, normals ----------------------------------------

_COEFFS = np.array([0.08, -0.03, 0.001, -0.002, 0.005], np.float32)


@pytest.mark.parametrize("model", ["none", "brown_conrady",
                                   "inverse_brown_conrady", "mixed"])
def test_deproject_matches_jax(model):
    h, w = 48, 64
    depths = np.stack([synth_depth_frame(h, w, seed=s) for s in range(3)])
    models = {"none": [0, 0, 0], "brown_conrady": [1, 1, 1],
              "inverse_brown_conrady": [2, 2, 2], "mixed": [0, 1, 2]}[model]
    cams = [JIntrinsics.create(fx=50.0 + i, fy=51.0, ppx=31.5, ppy=24.2,
                               coeffs=_COEFFS * (i + 1), width=w, height=h,
                               model=DistortionModel(m))
            for i, m in enumerate(models)]
    ji = cams[0].stack(cams[1:])
    want = J.deproject(jnp.asarray(depths), ji, 0.001, 0.1, 3.0)
    fields = {k: np.asarray(getattr(ji, k))
              for k in ("fx", "fy", "ppx", "ppy", "coeffs", "model_ids")
              if getattr(ji, k) is not None}
    pi = intrinsics_from_numpy(fields, w, h, ji.model)
    got = T.deproject(t(depths), pi, 0.001, 0.1, 3.0)
    np.testing.assert_array_equal(n(got.mask), n(want.mask))
    np.testing.assert_allclose(n(got.xyz), n(want.xyz), atol=1e-6)


@pytest.mark.parametrize("model", ["none", "brown_conrady",
                                   "inverse_brown_conrady", "mixed"])
def test_project_matches_jax(model):
    """Points in front of, on and behind the camera plane, against the
    JAX function compiled as the TSDF integrator compiles it: the pinhole
    is bit for bit (one fused multiply-add, as XLA contracts it), the
    distortion polynomials within a relative 1e-5 (XLA contracts some of
    their products into fused multiply-adds; points near the camera plane
    land thousands of pixels out)."""
    models = {"none": [0, 0, 0], "brown_conrady": [1, 1, 1],
              "inverse_brown_conrady": [2, 2, 2], "mixed": [0, 1, 2]}[model]
    cams = [JIntrinsics.create(fx=50.0 + i, fy=51.0, ppx=31.5, ppy=24.2,
                               coeffs=_COEFFS * (i + 1), width=64, height=48,
                               model=DistortionModel(m))
            for i, m in enumerate(models)]
    ji = cams[0].stack(cams[1:])
    rng = np.random.default_rng(11)
    xyz = rng.uniform(-0.6, 0.6, (3, 200, 3)).astype(np.float32)
    xyz[..., 2] = rng.uniform(-0.2, 2.0, (3, 200))
    xyz[:, :5, 2] = 0.0
    fields = {k: np.asarray(getattr(ji, k))
              for k in ("fx", "fy", "ppx", "ppy", "coeffs", "model_ids")
              if getattr(ji, k) is not None}
    pi = intrinsics_from_numpy(fields, 64, 48, ji.model)
    wuv, wf = jax.jit(J.project)(jnp.asarray(xyz), ji)
    guv, gf = T.project(t(xyz), pi)
    np.testing.assert_array_equal(n(gf), n(wf))
    front = n(wf)
    if model == "none":
        np.testing.assert_array_equal(n(guv), n(wuv))
    np.testing.assert_allclose(n(guv)[front], n(wuv)[front], rtol=1e-5,
                               atol=1e-4)


def test_decimate_and_grid_normals_match_jax():
    h, w = 60, 80
    depths = np.stack([synth_depth_frame(h, w, seed=s) for s in range(2)])
    np.testing.assert_array_equal(
        n(T.decimate_depth(t(depths), 3)),
        n(J.decimate_depth(jnp.asarray(depths), 3)))
    ji = JIntrinsics.create(fx=60.0, fy=60.0, ppx=40.0, ppy=30.0, width=w,
                            height=h)
    pc = J.deproject(jnp.asarray(depths), ji, 0.001, 0.1, 10.0)
    xyz = np.asarray(pc.xyz).reshape(2, h, w, 3)
    mask = np.asarray(pc.mask).reshape(2, h, w)
    wn, wv = J.grid_normals(jnp.asarray(xyz), jnp.asarray(mask))
    gn, gv = T.grid_normals(t(xyz), t(mask))
    np.testing.assert_array_equal(n(gv), n(wv))
    np.testing.assert_allclose(n(gn), n(wn), atol=1e-5)


def test_fuse_and_crop_box_match_jax(rng):
    xyz = rng.uniform(-1, 1, (3, 40, 3)).astype(np.float32)
    mask = rng.random((3, 40)) > 0.3
    rgb = rng.integers(0, 256, (3, 40, 3)).astype(np.float32)
    jf = J.fuse_batched(JPointCloud(xyz=jnp.asarray(xyz),
                                    mask=jnp.asarray(mask),
                                    rgb=jnp.asarray(rgb)))
    pf = T.fuse_batched(PointCloud(xyz=t(xyz), mask=t(mask), rgb=t(rgb)))
    for a, b in ((pf.xyz, jf.xyz), (pf.mask, jf.mask), (pf.rgb, jf.rgb)):
        np.testing.assert_array_equal(n(a), n(b))
    jl = J.fuse([JPointCloud(xyz=jnp.asarray(xyz[i]),
                             mask=jnp.asarray(mask[i])) for i in range(3)])
    pl = T.fuse([PointCloud(xyz=t(xyz[i]), mask=t(mask[i]))
                 for i in range(3)])
    np.testing.assert_array_equal(n(pl.xyz), n(jl.xyz))
    lo, hi = [-0.5, -0.2, -0.9], [0.5, 0.7, 0.3]
    for invert in (False, True):
        jc = J.crop_box(jf, lo, hi, invert=invert)
        pc = T.crop_box(pf, lo, hi, invert=invert)
        np.testing.assert_array_equal(n(pc.mask), n(jc.mask))


# --- voxel_downsample ----------------------------------------------------

def _voxel_inputs(rng, batched, rgb):
    shape = (3, 1500) if batched else (4000,)
    xyz = rng.uniform(-0.6, 0.6, (*shape, 3)).astype(np.float32)
    mask = rng.random(shape) > 0.15
    xyz[~mask] = 0.0
    colors = (rng.integers(0, 256, (*shape, 3)).astype(np.float32)
              if rgb else None)
    return xyz, mask, colors


@pytest.mark.parametrize("packed", ["auto", "never"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("rgb", [False, True])
def test_voxel_downsample_matches_jax(rng, packed, batched, rgb):
    """leaf 0.02 m takes the packed branch under 'auto' (the xyz are then
    quantised at leaf/2048 in both frameworks); 'never' is the exact one."""
    xyz, mask, colors = _voxel_inputs(rng, batched, rgb)
    cap = 2048
    jpc = JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask),
                      rgb=None if colors is None else jnp.asarray(colors))
    ppc = PointCloud(xyz=t(xyz), mask=t(mask),
                     rgb=None if colors is None else t(colors))
    want = J.voxel_downsample(jpc, 0.02, capacity=cap, impl="xla",
                              packed=packed)
    got = T.voxel_downsample(ppc, 0.02, capacity=cap, packed=packed)
    np.testing.assert_array_equal(n(got.mask), n(want.mask))
    atol = 1e-6 if packed == "auto" else 1e-5
    np.testing.assert_allclose(n(got.xyz), n(want.xyz), atol=atol)
    if rgb:
        np.testing.assert_allclose(n(got.rgb), n(want.rgb), atol=1e-4)


def test_voxel_downsample_traced_leaf_and_saturation(rng):
    """A 0-d tensor leaf (autofit) works, and a saturated grid keeps the
    first `capacity` voxels in key order, as the JAX package does."""
    xyz, mask, _ = _voxel_inputs(rng, False, False)
    want = J.voxel_downsample(JPointCloud(xyz=jnp.asarray(xyz),
                                          mask=jnp.asarray(mask)),
                              jnp.float32(0.05), capacity=256, impl="xla")
    got = T.voxel_downsample(PointCloud(xyz=t(xyz), mask=t(mask)),
                             torch.tensor(0.05), capacity=256)
    assert int(got.count()) == int(want.count()) == 256
    np.testing.assert_allclose(n(got.xyz), n(want.xyz), atol=1e-5)


@pytest.mark.parametrize("packed", ["auto", "never"])
def test_voxel_batched_flat_ids_never_decrease(monkeypatch, packed):
    """The camera batch's flat segment ids never decrease (K2's contract),
    with invalid points and with clouds of no valid point (the first, a
    middle one and the last); those clouds come out empty, and the pass
    matches the JAX package."""
    from pointcloud_stitching_tpu_torch.ops import voxel as V
    rng = np.random.default_rng(80)
    xyz = rng.uniform(-1, 1, (5, 600, 3)).astype(np.float32)
    mask = rng.random((5, 600)) > 0.3
    mask[[0, 2, 4]] = False
    seen = []
    real = V.segment_sum_sorted

    def spy(vals, seg, capacity, impl="auto"):
        seen.append(seg)
        return real(vals, seg, capacity, impl=impl)

    monkeypatch.setattr(V, "segment_sum_sorted", spy)
    got = T.voxel_downsample(PointCloud(xyz=t(xyz), mask=t(mask)), 0.02,
                             capacity=256, packed=packed)
    want = J.voxel_downsample(JPointCloud(xyz=jnp.asarray(xyz),
                                          mask=jnp.asarray(mask)), 0.02,
                              capacity=256, impl="xla", packed=packed)
    (seg,) = seen
    assert bool((seg[1:] >= seg[:-1]).all())
    np.testing.assert_array_equal(n(got.mask), n(want.mask))
    assert not n(got.mask)[[0, 2, 4]].any()
    assert (n(got.mask).sum(-1)[[1, 3]] == 256).all()     # saturated
    atol = 1e-6 if packed == "auto" else 1e-5
    np.testing.assert_allclose(n(got.xyz), n(want.xyz), atol=atol)


def _old_packed_pass(pc, leaf, capacity):
    """The packed branch of one cloud as the port composed it before the
    global pass's rows were built in K1: voxel indices, then the extents,
    min_ijk and the offsets all worked out again from the points."""
    from pointcloud_stitching_tpu_torch.ops import voxel as V
    SENT = V._SENTINEL
    ijk = V.voxel_indices(pc.xyz, pc.mask, leaf)
    inv = 1.0 / torch.tensor(leaf, dtype=torch.float32)
    ext = V._extents(ijk)
    ny = torch.clamp(ext[..., 1:2], min=1)
    nz = torch.clamp(ext[..., 2:3], min=1)
    key = (ijk[..., 0] * ny + ijk[..., 1]) * nz + ijk[..., 2]
    key = torch.where(pc.mask, key, SENT)
    p = pc.xyz * inv
    frac = p - torch.floor(p)
    oq = torch.clamp((frac * 1024.0).to(torch.int32), 0, 1023)
    off = (oq[..., 0] << 20) | (oq[..., 1] << 10) | oq[..., 2]
    skey, perm = torch.sort(key, dim=-1)
    soff = off.gather(-1, perm)
    valid = skey != SENT
    sk = torch.where(valid, skey, 0)
    iz, t_ = sk % nz, sk // nz
    iy, ix = t_ % ny, t_ // ny
    fm = torch.where(pc.mask[..., None], torch.floor(p).to(torch.int32), SENT)
    min_ijk = fm.amin(dim=-2, keepdim=True)
    flags = run_starts(skey, valid)
    f = flags.to(torch.float32)
    q = torch.stack([(soff >> 20) & 1023, (soff >> 10) & 1023, soff & 1023],
                    dim=-1).to(torch.float32)
    chans = [torch.stack([ix, iy, iz], -1).to(torch.float32) * f[..., None],
             q, torch.ones_like(f)[..., None]]
    if pc.rgb is not None:
        rq = torch.clamp(pc.rgb.to(torch.int32), 0, 255)
        srgb = ((rq[..., 0] << 16) | (rq[..., 1] << 8) | rq[..., 2]).gather(
            -1, perm)
        chans.append(torch.stack([(srgb >> 16) & 255, (srgb >> 8) & 255,
                                  srgb & 255], -1).to(torch.float32))
    vals = torch.where(valid[..., None], torch.cat(chans, -1), 0.0)
    seg = torch.cumsum(flags.to(torch.int32), dim=0) - 1
    sums = segment_sum_plain(vals, seg, capacity)
    return sums, finalize_packed(sums, min_ijk, leaf, pc.rgb is not None)


def _packed_args(pc, leaf):
    from pointcloud_stitching_tpu_torch.ops import voxel as V
    inv = 1.0 / torch.tensor(leaf, dtype=torch.float32)
    ijk, min_ijk = V._indices_and_min(pc.xyz, pc.mask, inv)
    dims = torch.clamp(V._extents(ijk), min=1)
    return inv, min_ijk, dims


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("case", ["cloud", "saturated", "all_invalid",
                                  "one_point"])
def test_segment_sum_packed_plain_equals_composition_and_jax(rng, case, rgb):
    """The plain ``segment_sum_packed`` equals ``packed_rows`` summed by
    ``segment_sum_from_flags`` bit for bit, and its centroids the JAX
    package's packed pass."""
    xyz, mask, colors = _voxel_inputs(rng, False, rgb)
    if case == "all_invalid":
        mask[:] = False
    elif case == "one_point":
        mask[:] = False
        mask[1234] = True
    cap = 64 if case == "saturated" else 4096
    pc = PointCloud(xyz=t(xyz), mask=t(mask),
                    rgb=None if colors is None else t(colors))
    args = (pc.xyz, pc.mask, pc.rgb, *_packed_args(pc, 0.02))
    got = segment_sum_packed(*args, cap)
    flags, vals = packed_rows(*args)
    assert torch.equal(got, segment_sum_from_flags(vals, flags, cap,
                                                   impl="torch"))
    assert got.shape == (cap, 10 if rgb else 7)
    want = J.voxel_downsample(
        JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask),
                    rgb=None if colors is None else jnp.asarray(colors)),
        0.02, capacity=cap, impl="xla", packed="auto")
    out = T.voxel_downsample(pc, 0.02, capacity=cap)
    np.testing.assert_array_equal(n(out.mask), n(want.mask))
    np.testing.assert_allclose(n(out.xyz), n(want.xyz), atol=1e-6)
    if rgb:
        np.testing.assert_allclose(n(out.rgb), n(want.rgb), atol=1e-4)


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("case", ["cloud", "saturated", "all_invalid"])
def test_segment_sum_from_keys_plain_sums_the_sorted_words(rng, case, rgb):
    """K1 on packed rows, plain: the pack's words sorted by key and summed
    per run give ``segment_sum_packed``'s bits, and each run's rows sum to
    its count and offsets; the CPU refuses the kernel."""
    xyz, mask, colors = _voxel_inputs(rng, False, rgb)
    if case == "all_invalid":
        mask[:] = False
    cap = 64 if case == "saturated" else 4096
    pc = PointCloud(xyz=t(xyz), mask=t(mask),
                    rgb=None if colors is None else t(colors))
    args = (pc.xyz, pc.mask, pc.rgb, *_packed_args(pc, 0.02))
    key, off, col = voxel_pack(*args)
    skey, perm = torch.sort(key)
    dims = args[-1]
    got = segment_sum_from_keys(skey, perm, off, col, dims, cap)
    assert torch.equal(got, segment_sum_packed(*args, cap))
    valid = skey != SENTINEL
    runs = int(run_starts(skey, valid).sum())
    assert int((got[:, 6] > 0).sum()) == min(runs, cap)
    if case != "saturated":
        assert float(got[:, 6].sum()) == int(pc.mask.sum())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        segment_sum_from_keys(skey, perm, off, col, dims, cap, impl="cuda")


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("cap", [100, 4096])
def test_min_ijk_and_extents_passed_on_equal_them_recomputed(rng, cap, rgb):
    """The packed pass computes min_ijk and the extents once and hands them
    on: the sums and the cloud are those of the composition that worked
    them out again, bit for bit (saturated and not)."""
    xyz, mask, colors = _voxel_inputs(rng, False, rgb)
    xyz += np.float32(0.37)                 # min_ijk away from the origin
    pc = PointCloud(xyz=t(xyz), mask=t(mask),
                    rgb=None if colors is None else t(colors))
    want_sums, want = _old_packed_pass(pc, 0.02, cap)
    got_sums = segment_sum_packed(pc.xyz, pc.mask, pc.rgb,
                                  *_packed_args(pc, 0.02), cap)
    got = T.voxel_downsample(pc, 0.02, capacity=cap)
    assert torch.equal(got_sums, want_sums)
    for name in ("xyz", "mask", "rgb"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None and b is None) or torch.equal(a, b), name


@pytest.mark.parametrize("impl", ["auto", "torch", "cuda"])
@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("batched", [False, True])
def test_packed_route_rule(monkeypatch, batched, card, impl):
    """Which packed route a pass takes: one cloud on a card (``impl``
    'auto' or 'cuda') takes the pack kernel and K1 on packed rows, inside
    the span ``pcs.voxel.k1_packed``; a camera batch always the composition
    and K2; the CPU and 'torch' the plain composition. ``card`` stands in
    for CUDA tensors: the kernel steps are replaced by their plain
    versions, which record that they ran."""
    from pointcloud_stitching_tpu_torch.kernels import segment_reduce as SR
    from pointcloud_stitching_tpu_torch.ops import voxel as V
    rng = np.random.default_rng(81)
    xyz, mask, _ = _voxel_inputs(rng, batched, False)
    pc = PointCloud(xyz=t(xyz), mask=t(mask))
    ran = []
    real_use = SR.use_kernel

    def use_kernel(impl_, x):
        return impl_ != "torch" if card else real_use(impl_, x)

    def packed_k1(xyz_, mask_, rgb_, inv, min_ijk, dims, capacity):
        ran.append("k1_packed")
        return SR.segment_sum_packed(xyz_, mask_, rgb_, inv, min_ijk, dims,
                                     capacity, impl="torch")

    def k2(vals, seg, capacity, impl="auto"):
        ran.append("k2" if use_kernel(impl, vals) else "k2_plain")
        return SR.segment_sum_sorted(vals, seg, capacity, impl="torch")

    monkeypatch.setattr(SR, "use_kernel", use_kernel)
    monkeypatch.setattr(SR, "_packed_k1", packed_k1)
    monkeypatch.setattr(V, "segment_sum_sorted", k2)
    if impl == "cuda" and not card:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            T.voxel_downsample(pc, 0.02, capacity=256, impl=impl)
        return
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = T.voxel_downsample(pc, 0.02, capacity=256, impl=impl)
    spans = [e.name for e in prof.events()
             if e.name == "pcs.voxel.k1_packed"]
    kernel = card and impl != "torch"
    if batched:
        assert ran == ["k2" if kernel else "k2_plain"] and not spans
    else:
        assert ran == (["k1_packed"] if kernel else [])
        assert len(spans) == int(kernel)
    want = T.voxel_downsample(pc, 0.02, capacity=256, impl="torch")
    for name in ("xyz", "mask"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


# --- nn, kabsch, trim, icp -----------------------------------------------

def test_nearest_neighbors_matches_jax(rng):
    q = rng.normal(size=(300, 3)).astype(np.float32)
    r = rng.normal(size=(500, 3)).astype(np.float32)
    m = rng.random(500) > 0.2
    wi, wd = J.nearest_neighbors(jnp.asarray(q), jnp.asarray(r),
                                 jnp.asarray(m), query_tile=128,
                                 ref_tile=128, impl="pallas", interpret=True)
    gi, gd = T.nearest_neighbors(t(q), t(r), t(m))
    np.testing.assert_array_equal(n(gi), n(wi))
    np.testing.assert_allclose(n(gd), n(wd), rtol=1e-6)


def test_kabsch_matches_jax(rng):
    src = rng.normal(size=(3, 200, 3)).astype(np.float32)
    Ts = _poses(rng, 3)
    dst = np.einsum("bij,bnj->bni", Ts[:, :3, :3], src) + Ts[:, None, :3, 3]
    dst += rng.normal(scale=1e-3, size=dst.shape)
    w = (rng.random((3, 200)) > 0.3).astype(np.float32)
    w[2] = 0.0                                    # degenerate: identity
    got = T.kabsch(t(src), t(dst.astype(np.float32)), t(w))
    for b in range(3):
        want = J.kabsch(jnp.asarray(src[b]), jnp.asarray(dst[b], jnp.float32),
                        jnp.asarray(w[b]))
        np.testing.assert_allclose(n(got[b]), n(want), atol=1e-5)


def test_trim_weights_matches_jax(rng):
    d2 = rng.random((4, 333)).astype(np.float32)
    w = (rng.random((4, 333)) > 0.4).astype(np.float32)
    w[3] = 0.0                                    # nothing accepted
    for frac in (0.0, 0.1, 0.37):
        want = jax_trim(jnp.asarray(w), jnp.asarray(d2), frac)
        got = _trim_weights(t(w), t(d2), frac)
        np.testing.assert_array_equal(n(got), n(want))


def _icp_pair(rng, b=3, m=400):
    """Wavy sheets with normals, and copies moved by small poses plus 1 mm
    noise: without the noise the residuals after convergence are rounding
    noise (~1e-16), and trimming at the quantile sorts that noise, so the
    inlier counts of two correct implementations differ."""
    dst = rng.uniform(-1, 1, (b, m, 3)).astype(np.float32)
    dst[..., 2] = 0.2 * np.sin(3 * dst[..., 0]) * np.cos(2 * dst[..., 1])
    normals = np.stack([-0.6 * np.cos(3 * dst[..., 0]) * np.cos(2 * dst[..., 1]),
                        0.4 * np.sin(3 * dst[..., 0]) * np.sin(2 * dst[..., 1]),
                        np.ones_like(dst[..., 0])], axis=-1)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    Ts = _poses(rng, b, angle=0.03)
    Ts[:, :3, 3] *= 0.05
    src = np.einsum("bij,bnj->bni", Ts[:, :3, :3], dst) + Ts[:, None, :3, 3]
    src = src + rng.normal(0, 1e-3, src.shape)
    mask = rng.random((b, m)) > 0.1
    return (src.astype(np.float32), dst, normals.astype(np.float32), mask)


@pytest.mark.parametrize("variant", ["point_to_plane", "point_to_point"])
def test_icp_batched_matches_jax(variant):
    # a generator per case: the suite-wide rng would make the inputs depend
    # on which tests ran before
    rng = np.random.default_rng({"point_to_plane": 21,
                                 "point_to_point": 22}[variant])
    src, dst, normals, mask = _icp_pair(rng)
    js = JPointCloud(xyz=jnp.asarray(src), mask=jnp.asarray(mask))
    jd = JPointCloud(xyz=jnp.asarray(dst), mask=jnp.asarray(mask))
    ps = PointCloud(xyz=t(src), mask=t(mask))
    pd = PointCloud(xyz=t(dst), mask=t(mask))
    kw = dict(iterations=4, max_corr_dist=0.2, trim_fraction=0.1)
    if variant == "point_to_plane":
        want = J.icp_point_to_plane_batched(
            js, jd, jnp.asarray(normals), query_tile=128, nn_impl="pallas",
            nn_interpret=True, **kw)
        got = T.icp_point_to_plane_batched(ps, pd, t(normals), **kw)
    else:
        want = J.icp_batched(js, jd, query_tile=128, nn_impl="pallas",
                             nn_interpret=True, **kw)
        got = T.icp_batched(ps, pd, **kw)
    # both sides take the direct-difference NN (JAX's Pallas kernel in
    # interpret mode); the solves (LAPACK's SVD and 6x6 solve against XLA's)
    # round differently, which moves T by ~1e-6
    np.testing.assert_allclose(n(got.T), n(want.T), atol=1e-5)
    np.testing.assert_array_equal(n(got.num_inliers), n(want.num_inliers))


# --- config and state carried across ---------------------------------------

def test_config_from_jax_json_maps_backends():
    jc = JConfig(num_cameras=3, kernel_impl="pallas", kernel_interpret=True,
                 crop_lo=(-1.0, -1.0, 0.0), crop_hi=(1.0, 1.0, 3.0))
    pc = StitchConfig.from_jax_json(jc.to_json())
    assert pc.kernel_impl == "cuda" and pc.crop_lo == (-1.0, -1.0, 0.0)
    jd = dataclasses.asdict(jc)
    pd = dataclasses.asdict(pc)
    jd.pop("kernel_interpret")
    jd.pop("kernel_impl")
    pd.pop("kernel_impl")
    assert jd == pd
    assert StitchConfig.from_jax_json(
        JConfig(kernel_impl="xla").to_json()).kernel_impl == "torch"
    assert StitchConfig.from_json(pc.to_json()) == pc


def test_config_checks():
    with pytest.raises(ValueError):
        StitchConfig(kernel_impl="pallas")
    # colour is ported: allowed alone, refused with normals (both ride the
    # rgb channel) and where the colour-stream size is half given
    assert StitchConfig(with_color=True, color_height=45,
                        color_width=80).with_color
    with pytest.raises(ValueError):
        StitchConfig(with_color=True, with_normals=True)
    with pytest.raises(ValueError):
        StitchConfig(with_color=True, color_height=45)
    with pytest.raises(ValueError):
        StitchConfig(color_height=45, color_width=80)
    with pytest.raises(ValueError):
        StitchConfig(decimation=7)
    with pytest.raises(ValueError):
        StitchConfig(icp_trim_fraction=1.0)


def test_convert_state():
    ext = np.stack([random_se3(seed=s) for s in range(3)])
    e = extrinsics_from_numpy(ext)
    assert e.dtype == torch.float32 and np.array_equal(e.numpy(), ext)
    with pytest.raises(ValueError):
        extrinsics_from_numpy(ext[:, :3])
    ji = JIntrinsics.d435_default()
    pi = intrinsics_from_numpy(
        {k: np.asarray(getattr(ji, k)) for k in ("fx", "fy", "ppx", "ppy",
                                                  "coeffs")},
        ji.width, ji.height, ji.model)
    assert (pi.width, pi.height, pi.model) == (848, 480, 0)
    assert float(pi.fx) == 425.0 and pi.model_ids is None
