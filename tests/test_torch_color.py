"""The port's colour path against the JAX package's, on the same numpy inputs.

Colour deprojection (depth-aligned and texture-mapped), ``compact``,
``decode_normals``, ``se3_identity``, ``round_up``, ``save_cloud`` and the
coloured stitch step. JAX runs on the CPU; the port gets CPU tensors, so
its kernel wrappers take their plain versions. Every test draws from its
own generator.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointcloud_stitching_tpu.ops as J
from pointcloud_stitching_tpu import Intrinsics as JIntrinsics
from pointcloud_stitching_tpu import PointCloud as JPointCloud
from pointcloud_stitching_tpu.models import stitch_step as jax_step
from pointcloud_stitching_tpu.utils.config import StitchConfig as JConfig
from pointcloud_stitching_tpu.utils.types import round_up as jax_round_up
import pointcloud_stitching_tpu_torch as P
import pointcloud_stitching_tpu_torch.ops as T
from pointcloud_stitching_tpu_torch.io import load_ply, save_cloud
from pointcloud_stitching_tpu_torch.utils.convert import (
    extrinsics_from_numpy, intrinsics_from_numpy)
from pointcloud_stitching_tpu_torch.utils.types import (DistortionModel,
                                                        round_up)
from oracle import (map_color_np, project_np, random_se3,
                    synth_depth_frame, transform_np)

NCAM, H, W = 3, 60, 106
HC, WC = 45, 80                      # a colour stream of its own size
INTR = dict(fx=53.0, fy=53.5, ppx=W / 2 + 0.5, ppy=H / 2 - 0.5)
C_INTR = dict(fx=40.0, fy=40.5, ppx=WC / 2 + 1.0, ppy=HC / 2 - 1.0)
BOUNDARY = 1e-4                      # px: projections this near a .5 tie


def t(a):
    return torch.tensor(np.asarray(a))


def _port_intr(ji):
    fields = {k: np.asarray(getattr(ji, k))
              for k in ("fx", "fy", "ppx", "ppy", "coeffs")}
    return intrinsics_from_numpy(fields, ji.width, ji.height, ji.model)


def _rig(seed):
    """3 cameras: depth, depth-aligned colour, colour at its own size, the
    batched depth and colour intrinsics and small depth→colour baselines."""
    rng = np.random.default_rng(seed)
    depths = np.stack([synth_depth_frame(H, W, seed=seed + c)
                       for c in range(NCAM)])
    colors = rng.integers(0, 256, (NCAM, H, W, 3)).astype(np.uint8)
    colors_c = rng.integers(0, 256, (NCAM, HC, WC, 3)).astype(np.uint8)
    i0 = JIntrinsics.create(**INTR, width=W, height=H)
    c0 = JIntrinsics.create(**C_INTR, width=WC, height=HC)
    ji, jc = i0.stack([i0] * (NCAM - 1)), c0.stack([c0] * (NCAM - 1))
    d2c = np.stack([random_se3(seed=seed + 20 + c, max_angle=0.02,
                               max_trans=0.015) for c in range(NCAM)])
    return depths, colors, colors_c, ji, jc, d2c.astype(np.float32)


def test_deproject_with_color_matches_jax():
    depths, colors, _, ji, _, _ = _rig(1)
    want = J.deproject_with_color(jnp.asarray(depths), jnp.asarray(colors),
                                  ji, z_min=0.1, z_max=10.0)
    got = T.deproject_with_color(t(depths), t(colors), _port_intr(ji),
                                 z_min=0.1, z_max=10.0)
    for a in ("xyz", "mask", "rgb"):
        np.testing.assert_array_equal(getattr(got, a).numpy(),
                                      np.asarray(getattr(want, a)))
    assert (got.rgb[~got.mask] == 0).all()


def _near_half(u: np.ndarray) -> np.ndarray:
    return np.abs(u - np.floor(u) - 0.5) < BOUNDARY


@pytest.mark.parametrize("model", ["none", "brown_conrady"])
def test_map_color_matches_jax_and_oracle(model):
    """Coordinates within 1e-4 px of JAX's; colours equal to JAX's and to
    the numpy oracle's except where a projection lies within 1e-4 px of a
    .5 tie (both sides round half to even there), and the scene has none
    of those. Points behind the colour camera, outside its frame or masked
    get zero colour."""
    # seeds whose 1024 points have no projection within 3e-4 px of a tie
    rng = np.random.default_rng(13 if model == "none" else 14)
    n = 1024
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.3, 3.0, n).astype(np.float32)
    pts[:64, 2] = -0.5                     # behind the colour camera
    mask = np.ones(n, bool)
    mask[64:96] = False
    color = rng.integers(0, 256, (HC, WC, 3)).astype(np.uint8)
    coeffs = [0.08, -0.03, 0.001, -0.001, 0.004] if model != "none" else None
    dm = (DistortionModel.BROWN_CONRADY if model != "none"
          else DistortionModel.NONE)
    d2c = random_se3(seed=13, max_angle=0.02, max_trans=0.015)
    jc = JIntrinsics.create(**C_INTR, coeffs=coeffs, width=WC, height=HC,
                            model=int(dm))
    pc_j = JPointCloud(xyz=jnp.asarray(pts), mask=jnp.asarray(mask))
    pc_t = P.PointCloud(xyz=t(pts), mask=t(mask))
    want = J.map_color(pc_j, jnp.asarray(color), jc, jnp.asarray(d2c))
    got = T.map_color(pc_t, t(color), _port_intr(jc), t(d2c))

    uv_j, _ = J.project(J.se3_apply(jnp.asarray(d2c), jnp.asarray(pts)), jc)
    uv_t, _ = T.project(T.se3_apply(t(d2c), t(pts)), _port_intr(jc))
    uv_j, uv_t = np.asarray(uv_j), uv_t.numpy()
    np.testing.assert_allclose(uv_t, uv_j, rtol=0, atol=1e-4)
    uv_o, _ = project_np(transform_np(d2c, pts), C_INTR["fx"], C_INTR["fy"],
                         C_INTR["ppx"], C_INTR["ppy"], coeffs, model)
    ties = (_near_half(uv_t) | _near_half(uv_j) | _near_half(uv_o)).any(-1)
    assert int(ties.sum()) == 0

    rgb_o = map_color_np(pts, mask, color, C_INTR["fx"], C_INTR["fy"],
                         C_INTR["ppx"], C_INTR["ppy"], d2c, coeffs=coeffs,
                         model=model)
    g = got.rgb.numpy()
    np.testing.assert_array_equal(g[~ties], np.asarray(want.rgb)[~ties])
    np.testing.assert_array_equal(g[~ties], rgb_o[~ties])
    assert (got.rgb[:96] == 0).all()       # behind the camera, or masked
    assert (got.rgb[96:] != 0).any()


@pytest.mark.parametrize("name", ["deproject_with_color_mapped", "compact",
                                  "decode_normals", "se3_identity",
                                  "round_up"])
def test_colour_helpers_match_jax_bitwise(name):
    rng = np.random.default_rng(40 + len(name))
    if name == "deproject_with_color_mapped":
        depths, _, colors_c, ji, jc, d2c = _rig(2)
        want = J.deproject_with_color_mapped(
            jnp.asarray(depths), jnp.asarray(colors_c), ji, jc,
            jnp.asarray(d2c), z_min=0.1, z_max=10.0)
        got = T.deproject_with_color_mapped(
            t(depths), t(colors_c), _port_intr(ji), _port_intr(jc), t(d2c),
            z_min=0.1, z_max=10.0)
        pairs = [(got.xyz, want.xyz), (got.mask, want.mask),
                 (got.rgb, want.rgb)]
        assert bool((got.rgb.sum(-1) > 0).any())
    elif name == "compact":
        xyz = rng.normal(size=(2, 500, 3)).astype(np.float32)
        rgb = rng.integers(0, 256, (2, 500, 3)).astype(np.float32)
        mask = rng.random((2, 500)) > 0.4
        want = J.compact(JPointCloud(xyz=jnp.asarray(xyz),
                                     mask=jnp.asarray(mask),
                                     rgb=jnp.asarray(rgb)))
        got = T.compact(P.PointCloud(xyz=t(xyz), mask=t(mask), rgb=t(rgb)))
        pairs = [(got.xyz, want.xyz), (got.mask, want.mask),
                 (got.rgb, want.rgb)]
        k = int(mask[0].sum())
        assert got.mask[0, :k].all() and not got.mask[0, k:].any()
    elif name == "decode_normals":
        n = rng.normal(size=(800, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        q = np.clip(np.round((n + 1.0) * 127.5), 0, 255).astype(np.float32)
        q[:50] = 127.5                  # a voxel whose normals cancelled
        mask = rng.random(800) > 0.1
        xyz = np.zeros((800, 3), np.float32)
        wn, wok = J.decode_normals(JPointCloud(
            xyz=jnp.asarray(xyz), mask=jnp.asarray(mask), rgb=jnp.asarray(q)))
        gn, gok = T.decode_normals(P.PointCloud(xyz=t(xyz), mask=t(mask),
                                                rgb=t(q)))
        pairs = [(gn, wn), (gok, wok)]
        assert not gok[:50].any() and gok[50:].any()
        with pytest.raises(ValueError):
            T.decode_normals(P.PointCloud(xyz=t(xyz), mask=t(mask)))
    elif name == "se3_identity":
        pairs = [(T.se3_identity(), J.se3_identity())]
    else:
        for x, m in [(0, 1024), (1, 1024), (1024, 1024), (113301, 1024),
                     (7, 3)]:
            assert round_up(x, m) == jax_round_up(x, m)
        pairs = []
    for g, w in pairs:
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def _cfg(leaf, mapped, **kw):
    base = dict(num_cameras=NCAM, height=H, width=W, out_voxel_leaf=leaf,
                out_capacity=32768, icp_enabled=False, with_color=True,
                kernel_impl="xla")
    if mapped:
        base.update(color_height=HC, color_width=WC)
    base.update(kw)
    return JConfig(**base)


@pytest.mark.parametrize("mapped", [False, True], ids=["aligned", "mapped"])
@pytest.mark.parametrize("leaf", [0.02, 0.05], ids=["packed", "exact"])
def test_coloured_stitch_step_matches_jax(mapped, leaf):
    """The coloured step with equal extrinsics on both sides (ICP off, as
    tests/test_torch_stitcher.py compares clouds). At 2 cm the global pass
    takes the packed branch (10 integer channels through K1's plain
    version): bit for bit. At 5 cm the exact branch's unstable sort
    permutes the float sums: within the oracle's 1e-4 m (colour 1e-3)."""
    depths, colors, colors_c, ji, jc, d2c = _rig(3)
    ext = np.stack([random_se3(seed=30 + c, max_angle=0.1, max_trans=0.2)
                    for c in range(NCAM)]).astype(np.float32)
    jcfg = _cfg(leaf, mapped)
    col = colors_c if mapped else colors
    want = jax_step(jcfg, ji, jnp.asarray(ext), jnp.asarray(depths),
                    jnp.asarray(col), None,
                    jc if mapped else None,
                    jnp.asarray(d2c) if mapped else None)
    pcfg = P.StitchConfig.from_jax_json(jcfg.to_json())
    got = P.stitch_step(pcfg, _port_intr(ji), extrinsics_from_numpy(ext),
                        t(depths), t(col), None,
                        _port_intr(jc) if mapped else None,
                        t(d2c) if mapped else None)
    assert int(got.metrics.points_in) == int(want.metrics.points_in)
    assert int(got.metrics.points_out) == int(want.metrics.points_out)
    assert int(got.metrics.points_out) < pcfg.out_capacity
    wm = np.asarray(want.cloud.mask)
    gx, gr = got.cloud.xyz.numpy(), got.cloud.rgb.numpy()
    wx, wr = np.asarray(want.cloud.xyz), np.asarray(want.cloud.rgb)
    assert (gr[got.cloud.mask.numpy()] > 0).any()
    if leaf <= 0.03:
        np.testing.assert_array_equal(got.cloud.mask.numpy(), wm)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gr, wr)
    else:
        gm = got.cloud.mask.numpy()
        og, ow = np.lexsort(gx[gm].T[::-1]), np.lexsort(wx[wm].T[::-1])
        np.testing.assert_allclose(gx[gm][og], wx[wm][ow], atol=1e-4)
        np.testing.assert_allclose(gr[gm][og], wr[wm][ow], atol=1e-3)


def test_coloured_step_refusals():
    """Colour with normals raises (both ride the rgb channel), as does a
    pipeline whose config sets color_height without color_intr; mapped
    colour with identity extrinsics and the depth intrinsics equals
    depth-aligned colour."""
    depths, colors, _, ji, _, _ = _rig(4)
    pi = _port_intr(ji)
    ext = np.tile(np.eye(4, dtype=np.float32), (NCAM, 1, 1))
    ncfg = P.StitchConfig.from_jax_json(
        _cfg(0.02, False, with_color=False, with_normals=True).to_json())
    with pytest.raises(ValueError, match="rgb channel"):
        P.stitch_step(ncfg, pi, t(ext), t(depths), t(colors))
    mcfg = P.StitchConfig.from_jax_json(_cfg(0.02, True).to_json())
    with pytest.raises(ValueError, match="color_intr"):
        P.StitchingPipeline(mcfg, pi, ext, device="cpu")
    acfg = P.StitchConfig.from_jax_json(_cfg(0.02, False).to_json())
    aligned = P.StitchingPipeline(acfg, pi, ext, device="cpu")(
        t(depths), t(colors))
    mapped = P.StitchingPipeline(
        dataclasses.replace(acfg, color_height=H, color_width=W), pi, ext,
        device="cpu", color_intr=pi)(t(depths), t(colors))
    for a in ("xyz", "mask", "rgb"):
        assert torch.equal(getattr(mapped.cloud, a),
                           getattr(aligned.cloud, a)), a


@pytest.mark.parametrize("kind", ["colour", "normals"])
def test_save_cloud_reads_back(tmp_path, kind):
    """save_cloud writes the valid points of a (device) cloud: colours as
    red/green/blue, or decoded normals as nx/ny/nz."""
    rng = np.random.default_rng(50 + len(kind))
    xyz = rng.normal(size=(400, 3)).astype(np.float32)
    mask = rng.random(400) > 0.3
    rgb = rng.integers(0, 256, (400, 3)).astype(np.float32)
    pc = P.PointCloud(xyz=t(xyz), mask=t(mask), rgb=t(rgb))
    path = str(tmp_path / f"{kind}.ply")
    save_cloud(path, pc, decode_normals=kind == "normals")
    got_xyz, got_rgb = load_ply(path)
    np.testing.assert_array_equal(got_xyz, xyz[mask])
    if kind == "colour":
        np.testing.assert_array_equal(got_rgb, rgb[mask].astype(np.uint8))
    else:
        assert got_rgb is None
        jn, _ = J.decode_normals(JPointCloud(
            xyz=jnp.asarray(xyz), mask=jnp.asarray(mask),
            rgb=jnp.asarray(rgb)))
        np.testing.assert_array_equal(_ply_normals(path),
                                      np.asarray(jn)[mask])


def _ply_normals(path):
    """nx/ny/nz of a binary PLY written by save_ply with normals."""
    raw = open(path, "rb").read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    rec = np.frombuffer(raw[end:], dtype=np.dtype(
        [("xyz", "<f4", 3), ("nrm", "<f4", 3)]))
    return rec["nrm"]
