"""The port's TSDF scene model against the JAX package's.

Both sides get the same numpy inputs: the analytic scenes and
``render_depth`` of tests/test_tsdf.py, seeded noise, and volumes carried
across with ``utils.convert.tsdf_volume_from_numpy``. The JAX side runs as
its own tests run it on the CPU (the Pallas patch gather in interpret
mode); the port's tensors lie on the CPU, so K5 takes its plain version.

Tolerances: K5, the brick classifier and ``integrate`` are bit for bit
(the port repeats XLA's fused multiply-adds with ``torch.addcmul``).
Extraction is held at 1e-6 m, ray casting at 1e-5 m of depth and tracking
at 1e-5 on T: their arithmetic follows the JAX package's, but sums of
products and reductions may round differently in the last bit.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu.kernels.patch_gather import (
    patch_gather as jax_patch_gather)
from pointcloud_stitching_tpu.models import tsdf as JM
from pointcloud_stitching_tpu.ops.surface import weld_mesh as jax_weld
from pointcloud_stitching_tpu_torch.kernels import build as kb
from pointcloud_stitching_tpu_torch.kernels.patch_gather import patch_gather
from pointcloud_stitching_tpu_torch.models import tsdf as TM
from pointcloud_stitching_tpu_torch.ops.surface import weld_mesh
from pointcloud_stitching_tpu_torch.utils.convert import (
    intrinsics_from_numpy, tsdf_volume_from_numpy)
from test_tsdf import I4, SCENE, _global_drift, _intr, render_depth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# carrying state across
# ---------------------------------------------------------------------------

def _tintr(ji):
    """The port's Intrinsics for a JAX Intrinsics (batched or not)."""
    f = {k: np.asarray(getattr(ji, k))
         for k in ("fx", "fy", "ppx", "ppy", "coeffs")}
    if ji.model_ids is not None:
        f["model_ids"] = np.asarray(ji.model_ids)
    return intrinsics_from_numpy(f, ji.width, ji.height, ji.model, CPU)


def _tvol(jvol):
    arrays = {k: np.asarray(getattr(jvol, k))
              for k in ("tsdf", "weight", "origin", "leaf", "trunc")}
    if jvol.rgb is not None:
        arrays["rgb"] = np.asarray(jvol.rgb)
    return tsdf_volume_from_numpy(arrays, CPU)


def _assert_vol_equal(tv, jv_or_tv):
    """Bit-for-bit equality of tsdf, weight and rgb."""
    o = jv_or_tv
    for k in ("tsdf", "weight", "rgb"):
        a, b = getattr(tv, k), getattr(o, k)
        assert (a is None) == (b is None), k
        if a is None:
            continue
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)


def _pose(ang, axis, t):
    c, s = np.cos(ang), np.sin(ang)
    R = {"x": [[1, 0, 0], [0, c, -s], [0, s, c]],
         "y": [[c, 0, s], [0, 1, 0], [-s, 0, c]],
         "z": [[c, -s, 0], [s, c, 0], [0, 0, 1]]}[axis]
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


# ---------------------------------------------------------------------------
# K5: the patch gather's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _gather_case(rng, h, w, nb=24):
    """Starts that are negative, unaligned, and clamped near the
    bottom-right edge; local indices inside the window, in the alignment
    slop (slightly negative) and outside the window."""
    img = rng.uniform(0.1, 5.0, (h, w)).astype(np.float32)
    v0 = rng.integers(-20, h + 20, nb).astype(np.int32)
    u0 = rng.integers(-200, w + 200, nb).astype(np.int32)
    v0[:4] = [-3, h - 2, max(h - 129, 0), 7]
    u0[:4] = [-130, w - 5, max(w - 257, 0), 127]
    iv = rng.integers(-10, min(140, h + 10), (nb, 512)).astype(np.int32)
    iu = rng.integers(-140, min(270, w + 10), (nb, 512)).astype(np.int32)
    return img, v0, u0, iv, iu


@pytest.mark.parametrize("h,w", [(48, 64), (520, 1030)])
def test_patch_gather_plain_matches_jax_bitwise(h, w):
    rng = np.random.default_rng(h * w)
    img, v0, u0, iv, iu = _gather_case(rng, h, w)
    want = np.asarray(jax_patch_gather(*map(jnp.asarray, (img, v0, u0, iv,
                                                          iu)),
                                       interpret=True))
    kb.reset_launches()
    got = patch_gather(*map(torch.from_numpy, (img, v0, u0, iv, iu)))
    assert not kb.LAUNCHES          # a CPU tensor takes the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    # every branch of the contract was exercised
    assert (want == 0).mean() > 0.05 and (want != 0).mean() > 0.05


def test_patch_gather_rejects_bad_inputs():
    img = torch.zeros((48, 64))
    ok = torch.zeros((3,), dtype=torch.int32)
    loc = torch.zeros((3, 512), dtype=torch.int32)
    with pytest.raises(ValueError, match="img"):
        patch_gather(img.double(), ok, ok, loc, loc)
    with pytest.raises(ValueError, match="iu"):
        patch_gather(img, ok, ok, loc, loc[:, :100])
    with pytest.raises(ValueError, match="cuda"):
        patch_gather(img, ok, ok, loc, loc, impl="cuda")


# ---------------------------------------------------------------------------
# the brick classifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("origin", [(-0.64, -0.64, 0.0), (-0.3, -0.2, -0.4)])
def test_classify_bricks_matches_jax(origin):
    """The two volumes of test_tsdf's pruned-integrate tests: a grid in
    front of the camera (FREE, FREE_BORDER, SKIP and REFINE bricks), and
    one around the camera (behind-camera and near-camera bricks)."""
    ji = _intr()
    T2 = _pose(0.1, "y", [0.15, -0.1, -0.1])
    d = render_depth(ji, T2, **SCENE)
    shape, leaf, trunc = (64, 64, 64), 0.02, 0.08
    inv = np.linalg.inv(T2.astype(np.float64)).astype(np.float32)
    args = (shape, np.asarray(origin, np.float32), np.float32(leaf),
            np.float32(trunc), np.float32(0.0), np.float32(np.inf))
    classify = jax.jit(JM._classify_bricks, static_argnums=3)
    want = classify(jnp.asarray(d), ji, jnp.asarray(inv), args[0],
                    *map(jnp.asarray, args[1:]))
    got = TM._classify_bricks(torch.from_numpy(d), _tintr(ji),
                              torch.from_numpy(inv), args[0],
                              *(torch.tensor(a) for a in args[1:]))
    for g, w, name in zip(got, want, ("free_full", "free_border", "refine")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert 0 < int(got[2].sum()) < got[2].numel() // 2
    assert int(got[0].sum() + got[1].sum()) > 0


def test_brick_layout_matches_jax():
    """_to_bricks/_from_bricks: the JAX package's brick-major layout, and
    each other's inverse, with and without a channel axis."""
    a = np.random.default_rng(0).normal(size=(16, 24, 8, 4)).astype(
        np.float32)
    for arr in (a, a[..., 0]):
        want = np.asarray(JM._to_bricks(jnp.asarray(arr), (16, 24, 8)))
        got = TM._to_bricks(torch.from_numpy(arr), (16, 24, 8))
        np.testing.assert_array_equal(got.numpy(), want)
        back = TM._from_bricks(got, (16, 24, 8))
        np.testing.assert_array_equal(back.numpy(), arr)


# ---------------------------------------------------------------------------
# integrate
# ---------------------------------------------------------------------------

def _scene_case(shape=(32, 32, 32), leaf=0.04, origin=(-0.64, -0.64, 0.0),
                depth="f32", color=None, models=None, **kw):
    """Three cameras of the test scene from nearby poses (the first with a
    dead patch and dead rows), 64x48 frames; ``models`` gives each camera
    a distortion model (a MIXED rig)."""
    rng = np.random.default_rng(5)
    ji = _intr()
    cams = [ji] * 3
    if models is not None:
        coeffs = np.array([0.05, -0.02, 0.001, -0.001, 0.003], np.float32)
        cams = [ji.replace(coeffs=jnp.asarray(coeffs * (i + 1)), model=m)
                for i, m in enumerate(models)]
    poses = [I4, _pose(0.1, "y", [0.15, -0.1, -0.1]),
             _pose(-0.12, "x", [-0.1, 0.05, 0.05])]
    d = np.stack([render_depth(ji, T, **SCENE) for T in poses])
    d[0, 10:30, 20:40] = 0.0
    d[0, ::37, :] = 0.0
    scale = 1.0
    if depth == "u16":
        d, scale = (d * 1000.0).astype(np.uint16), 0.001
    col = None
    if color is not None:
        col = rng.integers(0, 256, d.shape + (3,), dtype=np.uint8)
        if color == "f32":
            col = col.astype(np.float32) + 0.25
    return dict(shape=shape, leaf=leaf, origin=origin, depth=d,
                ext=np.stack(poses), intr=cams[0].stack(cams[1:]), color=col,
                kw=dict(kw, depth_scale=scale))


def _one_camera(w, h, f, T, depth, **vol):
    return dict(vol, depth=depth[None], ext=T[None], color=None,
                intr=_intr(w=w, h=h, f=f).stack([]), kw=dict(depth_scale=1.0))


def _t(x, y, z):
    T = I4.copy()
    T[:3, 3] = [x, y, z]
    return T


CASES = {
    "float": lambda: _scene_case(),
    "u16": lambda: _scene_case(depth="u16"),
    "rgb_u8": lambda: _scene_case(color="u8"),
    "rgb_f32": lambda: _scene_case(color="f32"),
    "gates": lambda: _scene_case(cam_mask=np.array([True, False, True]),
                                 z_min=0.3, z_max=0.8, max_weight=1.5),
    "odd_shape": lambda: _scene_case(shape=(30, 34, 28),
                                     origin=(-0.6, -0.7, 0.0)),
    "near_rgb": lambda: _scene_case(origin=(-0.3, -0.2, -0.4), color="u8"),
    "mixed_models": lambda: _scene_case(models=(0, 1, 2)),
    # 64^3 in front of the camera: FREE, FREE_BORDER and SKIP bricks, and
    # cameras whose REFINE count passes nb/2 (the unpruned lookup)
    "grid64": lambda: _scene_case(shape=(64, 64, 64), leaf=0.02),
    # a noise frame from inside the volume's front face: every brick in
    # the frustum refines, which overflows to the unpruned lookup
    "noise": lambda: _one_camera(
        64, 48, 50.0, _t(0.32, 0.32, -0.05),
        np.random.default_rng(7).uniform(0.05, 0.7, (48, 64))
        .astype(np.float32), shape=(64, 64, 64), leaf=0.01,
        origin=(0.0, 0.0, 0.0)),
    # a camera inside the volume: bricks next to it span more than a K5
    # window, a few (patched) or too many for the patch budget (full)
    "patched": lambda: _one_camera(
        160, 120, 100.0, I4, render_depth(_intr(160, 120, 100.0), I4,
                                          **SCENE),
        shape=(40, 40, 40), leaf=0.02, origin=(-0.4, -0.4, -0.05)),
    "full": lambda: _one_camera(
        1000, 800, 400.0, I4, render_depth(
            _intr(1000, 800, 400.0), I4, planes=[((0.0, 0.0, -1.0), -0.5)]),
        shape=(64, 64, 64), leaf=0.02, origin=(-0.64, -0.64, -0.64)),
}


def _jax_kw(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _port_kw(kw):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _integrate_jax(c, method, reps):
    jv = JM.TSDFVolume.create(c["shape"], c["leaf"], origin=c["origin"],
                              with_rgb=c["color"] is not None)
    col = None if c["color"] is None else jnp.asarray(c["color"])
    for _ in range(reps):
        jv = JM.integrate(jv, jnp.asarray(c["depth"]), c["intr"],
                          jnp.asarray(c["ext"]), color=col, method=method,
                          **_jax_kw(c["kw"]))
    return jv


def _integrate_port(c, method, reps):
    tv = TM.TSDFVolume.create(c["shape"], c["leaf"], origin=c["origin"],
                              with_rgb=c["color"] is not None, device=CPU)
    col = None if c["color"] is None else torch.from_numpy(c["color"])
    for _ in range(reps):
        tv = TM.integrate(tv, torch.from_numpy(c["depth"]), _tintr(c["intr"]),
                          torch.from_numpy(c["ext"]), color=col,
                          method=method, **_port_kw(c["kw"]))
    return tv


# which branch of the pruned path each case must reach, read from the
# window plans: (gathered bricks K, non-fitting bricks, patch budget)
BRANCHES = {
    "grid64": lambda plans: any(k == 512 for k, _, _ in plans),
    "noise": lambda plans: set(plans) == {(512, 0, 64)},
    "patched": lambda plans: any(0 < bad <= kb for _, bad, kb in plans),
    "full": lambda plans: any(bad > kb for _, bad, kb in plans),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_integrate_matches_jax_dense_bitwise(name, monkeypatch):
    """Port 'dense' and port 'auto' (the pruned path, K5's plain version)
    against JAX 'dense', two frames deep, bit for bit."""
    c = CASES[name]()
    plans = []
    plan = TM._plan_windows

    def spy(ui, vi, ok):
        v0, u0, fits = plan(ui, vi, ok)
        k = ui.shape[0]
        plans.append((k, int((~fits).sum()), min(k, max(64, k // 8))))
        return v0, u0, fits

    monkeypatch.setattr(TM, "_plan_windows", spy)
    want = _integrate_jax(c, "dense", 2)
    dense = _integrate_port(c, "dense", 2)
    _assert_vol_equal(dense, want)
    auto = _integrate_port(c, "auto", 2)
    _assert_vol_equal(auto, want)
    assert float(dense.weight.sum()) > 0
    assert BRANCHES.get(name, lambda p: p)(plans), plans


@pytest.mark.parametrize("name", ["near_rgb", "rgb_f32", "u16"])
def test_integrate_pruned_matches_jax_mxu_pallas(name):
    """Port 'auto' against JAX 'mxu_pallas' (the Pallas patch gather in
    interpret mode, as tests/test_tsdf.py runs it), bit for bit."""
    c = CASES[name]()
    _assert_vol_equal(_integrate_port(c, "auto", 1),
                      _integrate_jax(c, "mxu_pallas", 1))


def test_integrate_methods_and_devices(monkeypatch):
    c = CASES["float"]()
    for m in ("mxu", "mxu_pallas"):
        _assert_vol_equal(_integrate_port(c, m, 1),
                          _integrate_port(c, "dense", 1))
    for m in ("brick", "mxu_xla"):
        with pytest.raises(ValueError, match="Do not port"):
            _integrate_port(c, m, 1)
    with pytest.raises(ValueError, match="method"):
        _integrate_port(c, "fast", 1)
    tv = TM.TSDFVolume.create((8, 8, 8), 0.05, device=CPU)
    with pytest.raises(ValueError, match="color"):
        TM.integrate(tv, torch.zeros((48, 64)), _tintr(_intr()),
                     torch.eye(4), color=torch.zeros((48, 64, 3)))
    # no device given: the platform decides, and never falls to the CPU
    # unasked
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    assert TM.TSDFVolume.create((8, 8, 8), 0.05).device == CPU
    if not torch.cuda.is_available():
        monkeypatch.delenv("PCS_PLATFORM")
        with pytest.raises(RuntimeError, match="PCS_PLATFORM"):
            TM.TSDFVolume.create((8, 8, 8), 0.05)


# ---------------------------------------------------------------------------
# extraction and persistence
# ---------------------------------------------------------------------------

def _fused_jax(rgb=False):
    """A JAX volume two frames deep (of the test scene, 64^3 at 2 cm)."""
    ji = _intr()
    jv = JM.TSDFVolume.create((64, 64, 64), 0.02, origin=(-0.64, -0.64, 0.0),
                              with_rgb=rgb)
    T2 = _t(0.08, 0.0, 0.0)
    col = np.random.default_rng(3).integers(0, 256, (48, 64, 3),
                                            dtype=np.uint8)
    for T in (I4, T2):
        jv = JM.integrate(jv, jnp.asarray(render_depth(ji, T, **SCENE)), ji,
                          jnp.asarray(T), depth_scale=1.0,
                          color=jnp.asarray(col) if rgb else None)
    return jv


@pytest.fixture(scope="module")
def fused():
    """(JAX volume, the port's copy of it) with colour."""
    jv = _fused_jax(rgb=True)
    return jv, _tvol(jv)


def test_extract_cloud_matches_jax(fused):
    jv, tv = fused
    want = JM.extract_cloud(jv, capacity=20000)
    got = TM.extract_cloud(tv, capacity=20000)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert 1000 < int(got.mask.sum()) < 20000
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.rgb.numpy(), np.asarray(want.rgb))
    # a saturated capacity keeps the first voxels in voxel order
    small = TM.extract_cloud(tv, capacity=100)
    np.testing.assert_array_equal(small.xyz.numpy(), got.xyz.numpy()[:100])


def test_extract_mesh_and_weld_match_jax(fused):
    jv, tv = fused
    jverts, jvalid, jn = JM.extract_mesh(jv, cell_capacity=30000)
    verts, valid, n = TM.extract_mesh(tv, cell_capacity=30000)
    assert int(n) == int(jn) and 1000 < int(n) < 30000
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(verts.numpy(), np.asarray(jverts), rtol=0,
                               atol=1e-6)
    vw, fw = weld_mesh(verts, valid)
    jvw, jfw = jax_weld(jverts, jvalid)
    assert vw.shape == jvw.shape and fw.shape == jfw.shape
    np.testing.assert_allclose(vw, jvw, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(fw, jfw)


def test_save_load_both_ways(fused, tmp_path):
    jv, tv = fused
    JM.save_volume(str(tmp_path / "jax"), jv)
    got = TM.load_volume(str(tmp_path / "jax.npz"), device=CPU)
    _assert_vol_equal(got, jv)
    for k in ("origin", "leaf", "trunc"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(jv, k)))
    TM.save_volume(str(tmp_path / "port.npz"), tv)
    back = JM.load_volume(str(tmp_path / "port"))
    _assert_vol_equal(tv, back)
    with np.load(tmp_path / "port.npz") as zp, \
            np.load(tmp_path / "jax.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        assert int(zp["version"]) == 1
    # a volume without colour round-trips too
    TM.save_volume(str(tmp_path / "plain"), tv.replace(rgb=None))
    assert JM.load_volume(str(tmp_path / "plain")).rgb is None


# ---------------------------------------------------------------------------
# ray casting and tracking
# ---------------------------------------------------------------------------

def _assert_raycast_close(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.vertex.numpy(), np.asarray(want.vertex),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal),
                               rtol=0, atol=1e-4)


def test_raycast_matches_jax(fused):
    jv, tv = fused
    ji = _intr()
    view = _t(0.03, -0.02, 0.0)
    ti = _tintr(ji)
    want = JM.raycast(jv, ji, view, t_min=0.2, t_max=1.4)
    got = TM.raycast(tv, ti, torch.from_numpy(view), t_min=0.2, t_max=1.4)
    _assert_raycast_close(got, want)
    assert float(got.valid.float().mean()) > 0.8
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb),
                               rtol=0, atol=1e-3)
    # the tracking regime: stride 2, a prior-depth window
    d = render_depth(ji, view, **SCENE)
    want = JM.raycast(jv, ji, view, t_min=0.2, t_max=1.4, stride=2,
                      prior_depth=jnp.asarray(d), depth_scale=1.0)
    got = TM.raycast(tv, ti, torch.from_numpy(view), t_min=0.2, t_max=1.4,
                     stride=2, prior_depth=torch.from_numpy(d),
                     depth_scale=1.0)
    _assert_raycast_close(got, want)
    assert got.depth.shape == (24, 32)


def test_track_matches_jax():
    ji = _intr(w=96, h=72, f=75.0)
    jv = JM.TSDFVolume.create((72, 72, 72), 0.018,
                              origin=(-0.648, -0.648, 0.0))
    jv = JM.integrate(jv, jnp.asarray(render_depth(ji, I4, **SCENE)), ji, I4,
                      depth_scale=1.0)
    tv = _tvol(jv)
    T_true = _pose(0.03, "z", [0.02, -0.015, 0.01])
    d = render_depth(ji, T_true, **SCENE)
    for window in (None, 0.3):
        kw = dict(iterations=6, depth_scale=1.0, stride=2, t_min=0.2,
                  t_max=1.4, prior_window=window)
        want = JM.track(jv, jnp.asarray(d), ji, jnp.asarray(I4), **kw)
        got = TM.track(tv, torch.from_numpy(d), _tintr(ji), torch.eye(4),
                       **kw)
        np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), rtol=0,
                                   atol=1e-5)
        # a last-bit difference (LAPACK's eigh against XLA's, sums in
        # another order) moves T by ~1e-7 per iteration, which flips the
        # distance and normal gates of a few pixels: the inlier count may
        # differ by 1%
        n, nj = int(got.n_matched), int(want.n_matched)
        assert nj > 300 and abs(n - nj) <= 0.01 * nj
        np.testing.assert_allclose(float(got.rms), float(want.rms), rtol=0,
                                   atol=1e-5)


def test_rig_track_matches_jax():
    """The accepted and the gated cases of tests/test_tsdf.py."""
    ji = _intr(w=96, h=72, f=75.0)
    jv = JM.TSDFVolume.create((72, 72, 72), 0.018,
                              origin=(-0.648, -0.648, 0.0))
    jv = JM.integrate(jv, jnp.asarray(render_depth(ji, I4, **SCENE)), ji, I4,
                      depth_scale=1.0)
    tv = _tvol(jv)
    T_cal1 = _t(0.03, 0.0, -0.02)
    ext = np.stack([I4, T_cal1])
    d = render_depth(ji, _global_drift(), **SCENE)
    kw = dict(depth_scale=1.0, prior_window=None, iterations=10, stride=1,
              t_min=0.2, t_max=1.4)
    want = JM.rig_track(jv, jnp.asarray(np.stack([d, d])), ji.stack([ji]),
                        jnp.asarray(ext), **kw)
    got = TM.rig_track(tv, torch.from_numpy(np.stack([d, d])),
                       _tintr(ji.stack([ji])), torch.from_numpy(ext), **kw)
    assert got.applied is True and want.applied is True
    np.testing.assert_allclose(got.extrinsics.numpy(),
                               np.asarray(want.extrinsics), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.G.numpy(), np.asarray(want.G), rtol=0,
                               atol=1e-5)
    # an evidence-free volume: both gate the correction away
    ji = _intr()
    empty = JM.TSDFVolume.create((64, 64, 64), 0.02, origin=(-0.64, -0.64, 0))
    d = render_depth(ji, I4, **SCENE)
    kw = dict(depth_scale=1.0, prior_window=None, t_min=0.2, t_max=1.4)
    want = JM.rig_track(empty, jnp.asarray(d), ji, jnp.asarray(I4), **kw)
    got = TM.rig_track(_tvol(empty), torch.from_numpy(d), _tintr(ji),
                       torch.eye(4), **kw)
    assert got.applied is False and want.applied is False
    assert got.extrinsics.shape == (4, 4)
    np.testing.assert_array_equal(got.G.numpy(), I4)


# ---------------------------------------------------------------------------
# the mesh CLI's TSDF branch
# ---------------------------------------------------------------------------

def test_mesh_cli_tsdf_branch_matches_jax(fused, tmp_path, capsys,
                                         monkeypatch):
    """The port's CLI, as a user runs it on the CPU, against the JAX CLI
    on the same JAX-saved volume: the same output line and .ply size."""
    from pointcloud_stitching_tpu.tools import mesh_cli as jax_cli
    from pointcloud_stitching_tpu_torch.tools import mesh_cli
    jv, _ = fused
    src = str(tmp_path / "scene_tsdf.npz")
    JM.save_volume(src, jv)
    out_t, out_j = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    env = dict(os.environ, PCS_PLATFORM="cpu")
    pt = subprocess.run([sys.executable, "-m",
                         "pointcloud_stitching_tpu_torch.tools.mesh_cli", src,
                         out_t], cwd=REPO, capture_output=True, text=True,
                        timeout=300, env=env)
    assert pt.returncode == 0, pt.stderr
    capsys.readouterr()
    n_tri = jax_cli.main([src, out_j])
    line_j = capsys.readouterr().out.strip().splitlines()[-1]
    line_t = pt.stdout.strip().splitlines()[-1]
    assert line_t.split(": ", 1)[1] == line_j.split(": ", 1)[1]
    assert f" {n_tri} triangles" in line_t and n_tri > 1000
    assert os.path.getsize(out_t) == os.path.getsize(out_j)
    # the other two inputs take their own branches (test_torch_mesh.py
    # holds them against the JAX tool): a depth frame of zeros meshes to
    # no triangle, and an .npz without a "tsdf" key is read as a voxel map
    monkeypatch.setenv("PCS_PLATFORM", "cpu")
    np.save(tmp_path / "d.npy", np.zeros((48, 64), np.uint16))
    assert mesh_cli.main([str(tmp_path / "d.npy"), out_t, "--frame", "0"]) \
        == 0
    np.savez(tmp_path / "map.npz", keys=np.zeros(3))
    with pytest.raises(KeyError, match="version"):
        mesh_cli.main([str(tmp_path / "map.npz"), out_t, "--iso", "0.4"])
    # no PCS_PLATFORM: the default device is the GPU, and a machine
    # without one is an error, never a silent run on the CPU
    if not torch.cuda.is_available():
        monkeypatch.delenv("PCS_PLATFORM")
        with pytest.raises(RuntimeError, match="PCS_PLATFORM"):
            mesh_cli.main([src, out_t])
