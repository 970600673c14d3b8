"""The port's ``parallel/`` on a CPU gloo world against the JAX package's.

One module-scoped world of 4 ranks (``tests/_torch_parallel_child.py``,
which imports numpy, torch and the port only) runs every port-side case
and writes each rank's results; the JAX references run here on
``jax.devices()[:4]`` of conftest's 8-device CPU mesh, at the sizes of
``tests/test_parallel.py`` (4 cameras of 60x106; a 32x32x64 TSDF in 4 Z
slabs). One more world of 2 processes joins through ``init_multihost``'s
TCP coordinator. On the CPU the ranks take the kernels' plain versions;
``chip_smoke.py`` phase 13 holds the kernels on the card.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu import Intrinsics as JIntrinsics
from pointcloud_stitching_tpu.models import tsdf as JT
from pointcloud_stitching_tpu.parallel import make_mesh as jax_mesh
from pointcloud_stitching_tpu.parallel import (
    make_shardmap_stitch as jax_shardmap, ring_nearest_neighbors as jax_ring)
from pointcloud_stitching_tpu.utils.config import StitchConfig as JConfig
from pointcloud_stitching_tpu_torch import stitch_step
from pointcloud_stitching_tpu_torch.models import tsdf as PT
from pointcloud_stitching_tpu_torch.ops import nearest_neighbors
from pointcloud_stitching_tpu_torch.utils.convert import intrinsics_from_numpy
from test_parallel import _mixed_scene, _scene, _tsdf_scene
from _torch_parallel_child import stitch_kwargs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_parallel_child.py")
WORLD = 4
ATOL_EXT = 1e-4      # extrinsics and sorted clouds (tests/test_parallel.py)
H, W = 60, 106


def _port_cfg(name, **kw):
    from pointcloud_stitching_tpu_torch import StitchConfig
    return StitchConfig(**{**stitch_kwargs(name), **kw})


def _intr_arrays(prefix, intr):
    n = np.asarray(intr.fx).shape[0]
    ids = (np.full(n, intr.model) if intr.model_ids is None
           else np.asarray(intr.model_ids))
    return {prefix + k: np.asarray(getattr(intr, k), np.float32)
            for k in ("fx", "fy", "ppx", "ppy", "coeffs")} | {
                prefix + "model": ids.astype(np.int32)}


def _port_intr(intr):
    fields = {k: np.asarray(getattr(intr, k))
              for k in ("fx", "fy", "ppx", "ppy", "coeffs")}
    if intr.model_ids is not None:
        fields["model_ids"] = np.asarray(intr.model_ids)
    return intrinsics_from_numpy(fields, intr.width, intr.height, intr.model)


def _inputs():
    rng = np.random.default_rng(11)
    n, m = 512 * WORLD, 768 * WORLD
    depths, intr, ext = _scene(WORLD)
    _, mixed, _ = _mixed_scene(WORLD)
    crng = np.random.default_rng(5)
    ci = JIntrinsics.create(fx=40.0, fy=40.0, ppx=40.0, ppy=22.5, width=80,
                            height=45)
    c_ext = np.tile(np.eye(4, dtype=np.float32), (WORLD, 1, 1))
    c_ext[:, 0, 3] = 0.015
    t_depth, _, t_ext, leaf, origin = _tsdf_scene()
    return dict(
        nn_q=rng.normal(size=(n, 3)).astype(np.float32),
        nn_r=rng.normal(size=(m, 3)).astype(np.float32),
        nn_mask=rng.random(m) > 0.1,
        depths=depths, ext=ext,
        colors=crng.integers(0, 256, (WORLD, 45, 80, 3)).astype(np.uint8),
        colors_aligned=crng.integers(0, 256, (WORLD, H, W, 3)).astype(
            np.uint8),
        cam_mask=np.array([True, True, False, True]), c_ext=c_ext,
        tsdf_depth=np.asarray(t_depth), tsdf_ext=np.asarray(t_ext),
        tsdf_color=np.random.default_rng(0).integers(
            0, 256, (*t_depth.shape, 3), dtype=np.uint8),
        tsdf_shape=np.array([32, 32, 64]), tsdf_leaf=np.float32(leaf),
        tsdf_origin=np.array(origin, np.float32),
        **_intr_arrays("intr_", intr), **_intr_arrays("mixed_", mixed),
        **_intr_arrays("cintr_", ci.stack([ci] * (WORLD - 1))))


def _env():
    return dict(os.environ, PCS_PLATFORM="cpu", OMP_NUM_THREADS="2",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))


def _run(args_per_rank, timeout=240):
    procs = [subprocess.Popen([sys.executable, CHILD, *a],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env())
             for a in args_per_rank]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} rc={p.returncode}\n{err[-3000:]}"
        assert "CHILD_OK" in out, out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel")
    inputs = _inputs()
    np.savez(d / "inputs.npz", **inputs)
    url = f"file://{d / 'store'}"
    _run([("world", str(r), str(WORLD), url, str(d)) for r in range(WORLD)])
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return inputs, ranks


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(WORLD)


def _cloud(r, prefix):
    return r[prefix + "xyz"][r[prefix + "mask"]]


def _sorted(a):
    return a[np.lexsort(a.T[::-1])]


# --- collectives ----------------------------------------------------------

def test_collectives_match_their_jax_counterparts(world):
    _, ranks = world
    xs = [np.arange(6, dtype=np.int32).reshape(2, 3) + 10 * r
          for r in range(WORLD)]
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["c_gather"], np.stack(xs))
        np.testing.assert_array_equal(out["c_ring_p"], xs[(r - 1) % WORLD])
        np.testing.assert_array_equal(out["c_ring_m"], xs[(r + 1) % WORLD])
        np.testing.assert_array_equal(
            out["c_open_p"], xs[r - 1] if r > 0 else np.zeros_like(xs[0]))
        np.testing.assert_array_equal(
            out["c_open_m"],
            xs[r + 1] if r < WORLD - 1 else np.zeros_like(xs[0]))
        np.testing.assert_array_equal(out["c_min"], [0.0, -3.0, np.inf])
        np.testing.assert_array_equal(out["c_sum"], [6.0, -6.0])
        np.testing.assert_array_equal(
            out["c_bool"], [[k % 2 == 0, k == 1] for k in range(WORLD)])
        np.testing.assert_array_equal(out["c_rep_a"], xs[0])
        np.testing.assert_array_equal(out["c_rep_b"], [True, False])
        assert int(out["c_rep_keep"]) == 7
        # two gathers of 24 and 2 B from each of the 3 other ranks
        assert int(out["c_bytes"]) == 3 * (24 + 2)


# --- ring NN --------------------------------------------------------------

def test_ring_nn_matches_jax(world, jmesh):
    inputs, ranks = world
    idx = np.concatenate([r["nn_idx"] for r in ranks])
    d2 = np.concatenate([r["nn_d2"] for r in ranks])
    jidx, jd2 = jax_ring(jnp.asarray(inputs["nn_q"]),
                         jnp.asarray(inputs["nn_r"]),
                         jnp.asarray(inputs["nn_mask"]), jmesh,
                         query_tile=256, ref_tile=256)
    # the JAX package's CPU NN is the |q|^2+|r|^2-2qr form
    np.testing.assert_allclose(d2, np.asarray(jd2), atol=1e-5)
    assert (idx == np.asarray(jidx)).mean() > 0.999


def test_ring_nn_equals_unsharded_port(world):
    inputs, ranks = world
    ridx, rd2 = nearest_neighbors(torch.from_numpy(inputs["nn_q"]),
                                  torch.from_numpy(inputs["nn_r"]),
                                  torch.from_numpy(inputs["nn_mask"]))
    d2 = np.concatenate([r["nn_d2"] for r in ranks])
    np.testing.assert_array_equal(d2, rd2.numpy())
    idx = np.concatenate([r["nn_idx"] for r in ranks])
    np.testing.assert_array_equal(idx, ridx.numpy())


# --- the camera-sharded stitch ---------------------------------------------

def _jax_shardmap_out(name, inputs, jmesh):
    _, intr, _ = _scene(WORLD)
    fn = jax_shardmap(JConfig(**stitch_kwargs(name), kernel_impl="xla"),
                      jmesh)
    return fn(intr, jnp.asarray(inputs["ext"]), jnp.asarray(inputs["depths"]))


@pytest.mark.parametrize("name", ["p2p", "p2l"])
def test_shardmap_stitch_matches_jax(world, jmesh, name):
    inputs, ranks = world
    out = ranks[0]
    j = _jax_shardmap_out(name, inputs, jmesh)
    np.testing.assert_allclose(out[f"sm_{name}_ext"], np.asarray(j.extrinsics),
                               atol=ATOL_EXT)
    assert int(out[f"sm_{name}_points_in"]) == int(j.metrics.points_in)
    np.testing.assert_allclose(out[f"sm_{name}_err"],
                               np.asarray(j.metrics.icp_mean_error),
                               rtol=1e-3, atol=1e-7)


def test_shardmap_stitch_without_icp_matches_jax(world, jmesh):
    inputs, ranks = world
    out = ranks[0]
    j = _jax_shardmap_out("noicp", inputs, jmesh)
    a = _cloud(out, "sm_noicp_")
    b = np.asarray(j.cloud.xyz)[np.asarray(j.cloud.mask)]
    assert a.shape == b.shape and a.shape[0] > 1000
    np.testing.assert_allclose(_sorted(a), _sorted(b), atol=ATOL_EXT)
    np.testing.assert_array_equal(out["sm_noicp_ext"], inputs["ext"])
    assert int(out["sm_noicp_points_in"]) == int(j.metrics.points_in)


def _port_step(name, inputs, intr=None, ext=None, **kw):
    cfg = _port_cfg(name, **kw)
    if intr is None:
        intr = _port_intr(_scene(WORLD)[1])
    e = inputs["ext"] if ext is None else ext
    return cfg, stitch_step(cfg, intr, torch.from_numpy(e),
                            torch.from_numpy(inputs["depths"]))


@pytest.mark.parametrize("name", ["p2p", "p2l", "chain"])
def test_shardmap_stitch_matches_stitch_step(world, name):
    """Extrinsics within 1e-4 of the unsharded step; the cloud equal to
    the unsharded step with ICP off fed the sharded extrinsics (a ~1e-7
    change of extrinsics can move a point across a voxel boundary)."""
    inputs, ranks = world
    out = ranks[0]
    _, ref = _port_step(name, inputs)
    np.testing.assert_allclose(out[f"sm_{name}_ext"], ref.extrinsics.numpy(),
                               atol=ATOL_EXT)
    assert int(out[f"sm_{name}_points_in"]) == int(ref.metrics.points_in)
    np.testing.assert_allclose(out[f"sm_{name}_err"],
                               ref.metrics.icp_mean_error.numpy(),
                               rtol=1e-3, atol=1e-7)
    _, fed = _port_step(name, inputs, ext=out[f"sm_{name}_ext"],
                        icp_enabled=False)
    np.testing.assert_array_equal(out[f"sm_{name}_mask"],
                                  fed.cloud.mask.numpy())
    np.testing.assert_array_equal(out[f"sm_{name}_xyz"],
                                  fed.cloud.xyz.numpy())


@pytest.mark.parametrize("name", ["colour", "mixed", "normals", "noicp",
                                  "aligned"])
def test_sharded_stitch_matches_stitch_step(world, name):
    """The whole stitch_step signature over the mesh: mapped colour with a
    camera dropped, a mixed-distortion rig, normals with a crop and
    decimation (no camera pass: the raw clouds are gathered), the no-ICP
    step, and aligned colour with an output-leaf override."""
    inputs, ranks = world
    out = ranks[0]
    t = torch.from_numpy
    cfg_name = "noicp" if name == "aligned" else name
    cfg = _port_cfg(cfg_name)
    intr = _port_intr((_mixed_scene if name == "mixed" else _scene)(WORLD)[1])
    kw = {}
    if name == "colour":
        ci = JIntrinsics.create(fx=40.0, fy=40.0, ppx=40.0, ppy=22.5,
                                width=80, height=45)
        kw = dict(colors=t(inputs["colors"]), cam_mask=t(inputs["cam_mask"]),
                  color_intr=_port_intr(ci.stack([ci] * (WORLD - 1))),
                  color_ext=t(inputs["c_ext"]))
    if name == "aligned":
        kw = dict(colors=t(inputs["colors_aligned"]),
                  out_leaf=torch.tensor(0.04))
    p = f"ss_{name}_"
    ref = stitch_step(cfg, intr, t(inputs["ext"]), t(inputs["depths"]), **kw)
    np.testing.assert_allclose(out[p + "ext"], ref.extrinsics.numpy(),
                               atol=ATOL_EXT)
    assert int(out[p + "points_in"]) == int(ref.metrics.points_in)
    if cfg.icp_enabled:
        cfg = dataclasses.replace(cfg, icp_enabled=False)
        ref = stitch_step(cfg, intr, t(out[p + "ext"]), t(inputs["depths"]),
                          **kw)
    assert int(out[p + "points_out"]) == int(ref.metrics.points_out) > 500
    np.testing.assert_array_equal(out[p + "mask"], ref.cloud.mask.numpy())
    np.testing.assert_array_equal(out[p + "xyz"], ref.cloud.xyz.numpy())
    if ref.cloud.rgb is not None:
        np.testing.assert_array_equal(out[p + "rgb"], ref.cloud.rgb.numpy())
        assert (out[p + "rgb"][out[p + "mask"]] > 0).any()
    if name == "colour":
        # the dropped camera's points are gone: fewer than with it
        full = stitch_step(cfg, intr, t(out[p + "ext"]), t(inputs["depths"]),
                           **{**kw, "cam_mask": None})
        assert int(out[p + "points_in"]) < int(full.metrics.points_in)


def test_outputs_are_identical_on_every_rank(world):
    _, ranks = world
    shared = [k for k in ranks[0] if k.startswith(("sm_", "ss_", "rc_",
                                                   "err_"))]
    assert len(shared) >= 90     # 9 stitch cases, the raycast, 7 guards
    for r in ranks[1:]:
        for k in shared:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


# --- the Z-slab TSDF -------------------------------------------------------

def _jax_dense(inputs, colour: bool, frames: int = 2):
    depth, intr_b, ext, leaf, origin = _tsdf_scene()
    kw = dict(depth_scale=1.0, z_min=0.2, z_max=5.0)
    if colour:
        kw["color"] = jnp.asarray(inputs["tsdf_color"])
    vol = JT.TSDFVolume.create((32, 32, 64), leaf, origin=origin,
                               with_rgb=colour)
    for _ in range(frames):
        vol = JT.integrate(vol, depth, intr_b, ext, method="dense", **kw)
    return vol


@pytest.mark.parametrize("method", ["auto", "dense"])
@pytest.mark.parametrize("colour", [True, False])
def test_sharded_integrate_equals_unsharded(world, method, colour):
    """4 Z slabs, two frames: bit for bit the JAX package's unsharded
    'dense' and the port's unsharded integrate."""
    inputs, ranks = world
    tag = f"ts_{method}_{'rgb' if colour else 'plain'}_"
    fields = ("tsdf", "weight", "rgb") if colour else ("tsdf", "weight")
    got = {f: np.concatenate([r[tag + f] for r in ranks], axis=2)
           for f in fields}
    want = _jax_dense(inputs, colour)
    pv = PT.TSDFVolume.create((32, 32, 64), float(inputs["tsdf_leaf"]),
                              origin=tuple(inputs["tsdf_origin"]),
                              with_rgb=colour, device="cpu")
    t = torch.tensor
    from pointcloud_stitching_tpu_torch import Intrinsics
    i0 = Intrinsics.create(fx=50.0, fy=50.0, ppx=32.0, ppy=24.0, width=64,
                           height=48)
    for _ in range(2):
        pv = PT.integrate(pv, t(inputs["tsdf_depth"]), i0.stack([i0]),
                          t(inputs["tsdf_ext"]), depth_scale=1.0, z_min=0.2,
                          z_max=5.0, method=method,
                          color=t(inputs["tsdf_color"]) if colour else None)
    for f in fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
        np.testing.assert_array_equal(got[f], getattr(pv, f).numpy(),
                                      err_msg=f)
    for r in ranks:
        np.testing.assert_array_equal(r[tag + "origin"],
                                      inputs["tsdf_origin"])


def test_sharded_integrate_promotes_a_single_camera(world):
    inputs, ranks = world
    depth, intr_b, ext, leaf, origin = _tsdf_scene()
    want = JT.integrate(
        JT.TSDFVolume.create((32, 32, 64), leaf, origin=origin,
                             with_rgb=True),
        depth[0], JIntrinsics.create(fx=50.0, fy=50.0, ppx=32.0, ppy=24.0,
                                     width=64, height=48),
        ext[0], depth_scale=1.0, z_min=0.2, z_max=5.0, method="dense",
        color=jnp.asarray(inputs["tsdf_color"][0]))
    for f in ("tsdf", "rgb"):
        got = np.concatenate([r[f"ts_single_{f}"] for r in ranks], axis=2)
        np.testing.assert_array_equal(got, np.asarray(getattr(want, f)))


def test_sharded_raycast_matches_jax(world):
    """Per-slab halo-extended march + min-combine against JAX's unsharded
    renderer: validity within 1%, depth within 2e-3 where both hit."""
    inputs, ranks = world
    vol = _jax_dense(inputs, colour=False, frames=1)
    i0 = JIntrinsics.create(fx=50.0, fy=50.0, ppx=32.0, ppy=24.0,
                            width=64, height=48)
    rc = JT.raycast(vol, i0, np.eye(4, dtype=np.float32), t_min=0.2,
                    t_max=3.0)
    out = ranks[0]
    v1, vn = np.asarray(rc.valid), out["rc_valid"]
    assert (v1 != vn).mean() < 0.01, (v1 != vn).mean()
    both = v1 & vn
    assert both.sum() > 500
    np.testing.assert_allclose(out["rc_depth"][both],
                               np.asarray(rc.depth)[both], atol=2e-3)
    np.testing.assert_allclose(
        np.linalg.norm(out["rc_normal"][both], axis=-1), 1.0, atol=1e-3)


def test_sharded_raycast_refuses_an_undersized_halo(world):
    _, ranks = world
    assert "26-plane halo" in str(ranks[0]["err_halo"])


# --- guards, multihost, imports ----------------------------------------------

@pytest.mark.parametrize("key,text", [
    ("err_cams", "num_cameras=3 not divisible"),
    ("err_cams_gspmd", "num_cameras=3 not divisible"),
    ("err_slab", "Z=30 not divisible"),
    ("err_rows", "holds (4,) camera rows"),
    ("err_mesh", "need 5 ranks"),
    ("err_axis", "are not ('z',)"),
])
def test_guards_raise_value_error(world, key, text):
    _, ranks = world
    for r in ranks:
        assert text in str(r[key]), (key, str(r[key]))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_init_multihost_two_processes_gather_their_clouds(tmp_path):
    """The counterpart of tests/test_multihost.py's two-process rig: each
    process voxel-downsamples its own unit cube of points, and only the
    downsampled clouds cross, through init_multihost's TCP coordinator."""
    port = str(_free_port())
    _run([("multihost", str(r), port, str(tmp_path)) for r in range(2)],
         timeout=120)
    outs = [np.load(tmp_path / f"multihost{r}.npz") for r in range(2)]
    for o in outs:
        assert o["xyz"].shape == (2, 1024, 3)
        for r in range(2):
            np.testing.assert_array_equal(o["xyz"][r], outs[r]["local"])
            np.testing.assert_array_equal(o["mask"][r],
                                          outs[r]["local_mask"])
        pts = o["xyz"][o["mask"]]
        assert (pts.min(0) < 0.5).all() and (pts.max(0) > 1.5).all()


@pytest.mark.parametrize("count,want", [(1, 0), (4, 2)])
def test_platform_device_takes_local_rank_where_several_gpus(monkeypatch,
                                                             count, want):
    """One process per GPU: a rank's default device is cuda:LOCAL_RANK
    where several GPUs are visible, cuda:0 where one is (ranks sharing
    it)."""
    from pointcloud_stitching_tpu_torch.utils.platform import platform_device
    monkeypatch.delenv("PCS_PLATFORM", raising=False)
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert platform_device() == torch.device("cuda", want)


def test_init_multihost_without_a_coordinator_is_a_no_op(monkeypatch):
    from pointcloud_stitching_tpu_torch.parallel import init_multihost
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert init_multihost() is False
    assert not torch.distributed.is_initialized()


def test_package_import_needs_no_jax_and_starts_nothing():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch, torch.distributed as dist\n"
        "import pointcloud_stitching_tpu_torch.parallel as P\n"
        "import pointcloud_stitching_tpu_torch.parallel.collectives\n"
        "assert not dist.is_initialized(), 'a process group at import'\n"
        "assert not torch.cuda.is_initialized(), 'a CUDA context at import'\n"
        "assert not any(m == 'pointcloud_stitching_tpu' or\n"
        "               m.startswith('pointcloud_stitching_tpu.')\n"
        "               for m in sys.modules), 'the JAX package imported'\n"
        "print(sorted(P.__all__))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    from pointcloud_stitching_tpu import parallel as JP
    assert proc.stdout.strip() == str(sorted(JP.__all__))
