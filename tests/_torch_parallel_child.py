"""One rank of a CPU gloo world for tests/test_torch_parallel.py.

Imports numpy, torch and the port only (never jax). Two modes:

  world RANK WORLD INIT_URL DIR   every port-side case of the parallel
      tests on the inputs in DIR/inputs.npz; writes DIR/rank{RANK}.npz
  multihost RANK PORT DIR          two processes joined through
      init_multihost(coordinator="127.0.0.1:PORT"), each voxel-downsampling
      its own points; only the downsampled clouds cross (all_gather);
      writes DIR/multihost{RANK}.npz

A failed case raises, and the process exits non-zero with its traceback.
"""
import dataclasses
import datetime
import os
import sys

import numpy as np
import torch

TIMEOUT = datetime.timedelta(seconds=60)


def intrinsics(npz, prefix: str, h: int, w: int):
    from pointcloud_stitching_tpu_torch import Intrinsics
    cams = [Intrinsics.create(fx=npz[prefix + "fx"][i],
                              fy=npz[prefix + "fy"][i],
                              ppx=npz[prefix + "ppx"][i],
                              ppy=npz[prefix + "ppy"][i],
                              coeffs=npz[prefix + "coeffs"][i],
                              model=int(npz[prefix + "model"][i]),
                              width=w, height=h)
            for i in range(len(npz[prefix + "fx"]))]
    return cams[0].stack(cams[1:])


# the stitch cases: tests/test_parallel.py's _cfg at 4 cameras and its
# variants (the test module reads the same table)
_BASE = dict(num_cameras=4, height=60, width=106, cam_voxel_leaf=0.03,
             cam_capacity=4096, out_voxel_leaf=0.03, out_capacity=8192,
             icp_enabled=True, icp_voxel_leaf=0.06, icp_capacity=1024,
             icp_iterations=2, icp_max_corr_dist=0.3, icp_trim_fraction=0.0,
             icp_query_tile=256, icp_ref_tile=256)
_FINE = dict(cam_voxel_enabled=True, cam_voxel_leaf=0.005, cam_capacity=8192)
STITCH_CASES = {
    "p2p": dict(_FINE, icp_variant="point_to_point"),
    "p2l": dict(_FINE, icp_variant="point_to_plane", icp_stride=2),
    "noicp": dict(icp_enabled=False, out_capacity=32768),
    "colour": dict(with_color=True, color_height=45, color_width=80),
    "mixed": dict(_FINE),
    "normals": dict(with_normals=True, decimation=2,
                    crop_lo=(-1.0, -1.0, 0.0), crop_hi=(1.0, 0.8, 3.0),
                    icp_stride=3, out_capacity=16384),
    "chain": dict(_FINE, icp_ring_closure=False),
}


def stitch_kwargs(name: str) -> dict:
    """The StitchConfig fields of a stitch case."""
    return {**_BASE, **STITCH_CASES[name]}


def stitch_config(name: str):
    from pointcloud_stitching_tpu_torch import StitchConfig
    return StitchConfig(**stitch_kwargs(name))


def out_arrays(prefix: str, out) -> dict:
    m = out.metrics
    return {prefix + "xyz": out.cloud.xyz.numpy(),
            prefix + "mask": out.cloud.mask.numpy(),
            prefix + "rgb": (np.zeros(0, np.float32) if out.cloud.rgb is None
                             else out.cloud.rgb.numpy()),
            prefix + "ext": out.extrinsics.numpy(),
            prefix + "points_in": np.asarray(int(m.points_in)),
            prefix + "points_out": np.asarray(int(m.points_out)),
            prefix + "err": m.icp_mean_error.numpy(),
            prefix + "inl": m.icp_inliers.numpy(),
            prefix + "loop": np.asarray(float(m.loop_error))}


def raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def run_world(rank: int, world: int, init_url: str, out_dir: str) -> None:
    from pointcloud_stitching_tpu_torch.models import tsdf as M
    from pointcloud_stitching_tpu_torch.parallel import (
        collectives as C, init_multihost, make_mesh, make_sharded_integrate,
        make_sharded_raycast, make_sharded_stitch, make_shardmap_stitch,
        replicate, ring_nearest_neighbors, shard_volume)
    from pointcloud_stitching_tpu_torch.utils.types import Intrinsics

    torch.set_num_threads(2)
    assert init_multihost(coordinator=init_url, num_processes=world,
                          process_id=rank, timeout=TIMEOUT)
    npz = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    t = torch.from_numpy
    res = {}
    mesh = make_mesh()
    assert mesh.size() == world and mesh.get_local_rank() == rank

    # -- collectives ------------------------------------------------------
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3) + 10 * rank
    res["c_gather"] = C.all_gather(x, mesh).numpy()
    res["c_ring_p"] = C.ring_shift(x, mesh, 1).numpy()
    res["c_ring_m"] = C.ring_shift(x, mesh, -1).numpy()
    res["c_open_p"] = C.shift_open(x, mesh, 1).numpy()
    res["c_open_m"] = C.shift_open(x, mesh, -1).numpy()
    f = torch.tensor([float(rank), -float(rank), float("inf")])
    res["c_min"] = C.all_reduce(f, "min", mesh).numpy()
    res["c_sum"] = C.all_reduce(f[:2], "sum", mesh).numpy()
    b = torch.tensor([rank % 2 == 0, rank == 1])
    res["c_bool"] = C.all_gather(b, mesh).numpy()
    rep = replicate(mesh, {"a": x.clone(), "b": (b.clone(), 7)})
    res["c_rep_a"] = rep["a"].numpy()
    res["c_rep_b"] = rep["b"][0].numpy()
    res["c_rep_keep"] = np.asarray(rep["b"][1])
    res["c_bytes"] = np.asarray(C.BYTES["all_gather"])

    # -- ring NN ----------------------------------------------------------
    q = C.local_rows(t(npz["nn_q"]), mesh)
    r = C.local_rows(t(npz["nn_r"]), mesh)
    rm = C.local_rows(t(npz["nn_mask"]), mesh)
    idx, d2 = ring_nearest_neighbors(q, r, rm, mesh, query_tile=256,
                                     ref_tile=256)
    res["nn_idx"], res["nn_d2"] = idx.numpy(), d2.numpy()

    # -- the camera-sharded stitch -----------------------------------------
    h, w = 60, 106
    intr = intrinsics(npz, "intr_", h, w)
    mixed = intrinsics(npz, "mixed_", h, w)
    cintr = intrinsics(npz, "cintr_", 45, 80)
    ext, depths = t(npz["ext"]), t(npz["depths"])
    for name in ("p2p", "p2l", "noicp", "chain"):
        fn = make_shardmap_stitch(stitch_config(name), mesh)
        out = fn(C.local_rows(intr, mesh), C.local_rows(ext, mesh),
                 C.local_rows(depths, mesh))
        res.update(out_arrays(f"sm_{name}_", out))
    for name in ("colour", "mixed", "normals", "noicp"):
        kw = {}
        if name == "colour":
            kw = dict(colors=C.local_rows(t(npz["colors"]), mesh),
                      cam_mask=t(npz["cam_mask"]),
                      color_intr=C.local_rows(cintr, mesh),
                      color_ext=C.local_rows(t(npz["c_ext"]), mesh))
        fn = make_sharded_stitch(stitch_config(name), mesh)
        out = fn(C.local_rows(mixed if name == "mixed" else intr, mesh),
                 C.local_rows(ext, mesh), C.local_rows(depths, mesh), **kw)
        res.update(out_arrays(f"ss_{name}_", out))
    # aligned colour and an output-leaf override through the whole
    # signature (ICP off, so the cloud is exact)
    fn = make_sharded_stitch(stitch_config("noicp"), mesh)
    out = fn(C.local_rows(intr, mesh), C.local_rows(ext, mesh),
             C.local_rows(depths, mesh),
             colors=C.local_rows(t(npz["colors_aligned"]), mesh),
             out_leaf=torch.tensor(0.04))
    res.update(out_arrays("ss_aligned_", out))

    # -- the Z-slab TSDF ----------------------------------------------------
    shape = tuple(int(v) for v in npz["tsdf_shape"])
    leaf, origin = float(npz["tsdf_leaf"]), tuple(npz["tsdf_origin"])
    tin = Intrinsics.create(fx=50.0, fy=50.0, ppx=32.0, ppy=24.0,
                            width=64, height=48)
    t_intr = tin.stack([tin])
    t_depth, t_ext = t(npz["tsdf_depth"]), t(npz["tsdf_ext"])
    t_color = t(npz["tsdf_color"])
    kw = dict(depth_scale=1.0, z_min=0.2, z_max=5.0)
    zmesh = make_mesh(axis="z")
    for method in ("auto", "dense"):
        for colour in (True, False):
            vs = shard_volume(M.TSDFVolume.create(
                shape, leaf, origin=origin, with_rgb=colour, device="cpu"),
                zmesh)
            fn = make_sharded_integrate(zmesh, method=method)
            for _ in range(2):
                vs = fn(vs, t_depth, t_intr, t_ext,
                        color=t_color if colour else None, **kw)
            tag = f"ts_{method}_{'rgb' if colour else 'plain'}_"
            res[tag + "tsdf"] = vs.tsdf.numpy()
            res[tag + "weight"] = vs.weight.numpy()
            if colour:
                res[tag + "rgb"] = vs.rgb.numpy()
            res[tag + "origin"] = vs.origin.numpy()
    # the single-camera promotion: 2-D depth, 0-d intrinsics, [4, 4] pose
    vs = shard_volume(M.TSDFVolume.create(shape, leaf, origin=origin,
                                          with_rgb=True, device="cpu"),
                      zmesh)
    vs = make_sharded_integrate(zmesh, method="auto")(
        vs, t_depth[0], tin, t_ext[0], color=t_color[0], **kw)
    res["ts_single_tsdf"], res["ts_single_rgb"] = vs.tsdf.numpy(), \
        vs.rgb.numpy()
    # raycast of a one-frame 'dense' volume
    vs = shard_volume(M.TSDFVolume.create(shape, leaf, origin=origin,
                                          device="cpu"), zmesh)
    vs = make_sharded_integrate(zmesh, method="dense")(
        vs, t_depth, t_intr, t_ext, **kw)
    rc = make_sharded_raycast(zmesh, t_min=0.2, t_max=3.0)(
        vs, tin, torch.eye(4))
    for k in ("depth", "vertex", "normal", "valid"):
        res["rc_" + k] = getattr(rc, k).numpy()
    small = shard_volume(M.TSDFVolume.create(
        (16, 16, 32), 0.03125, origin=(0.0, 0.0, 0.0), device="cpu"), zmesh)
    i16 = Intrinsics.create(fx=50.0, fy=50.0, ppx=8.0, ppy=8.0, width=16,
                            height=16)
    res["err_halo"] = np.asarray(raises(lambda: make_sharded_raycast(
        zmesh, step=0.5)(small, i16, torch.eye(4))))

    # -- guards -------------------------------------------------------------
    cfg3 = dataclasses.replace(stitch_config("p2p"), num_cameras=3)
    res["err_cams"] = np.asarray(raises(
        lambda: make_shardmap_stitch(cfg3, mesh)))
    res["err_cams_gspmd"] = np.asarray(raises(
        lambda: make_sharded_stitch(cfg3, mesh)))
    res["err_slab"] = np.asarray(raises(lambda: shard_volume(
        M.TSDFVolume.create((8, 8, 30), 0.1, device="cpu"), zmesh)))
    res["err_rows"] = np.asarray(raises(lambda: make_shardmap_stitch(
        stitch_config("p2p"), mesh)(intr, ext, depths)))
    res["err_mesh"] = np.asarray(raises(lambda: make_mesh(world + 1)))
    res["err_axis"] = np.asarray(raises(
        lambda: make_sharded_integrate(mesh)))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


def run_multihost(rank: int, port: str, out_dir: str) -> None:
    """The counterpart of tests/_multihost_child.py's first part: each
    process is one capture host with its own points."""
    from pointcloud_stitching_tpu_torch import PointCloud
    from pointcloud_stitching_tpu_torch.ops import voxel_downsample
    from pointcloud_stitching_tpu_torch.parallel import (
        collectives as C, init_multihost, make_mesh)

    assert init_multihost(coordinator=f"127.0.0.1:{port}", num_processes=2,
                          process_id=rank, timeout=TIMEOUT)
    assert torch.distributed.get_world_size() == 2
    rng = np.random.default_rng(rank)
    xyz = rng.uniform(rank, rank + 1, (4096, 3)).astype(np.float32)
    local = voxel_downsample(PointCloud.from_points(xyz, capacity=4096),
                             0.25, capacity=1024)
    mesh = make_mesh()
    # only the downsampled cloud crosses: 1024 x 13 B each way
    fused_xyz = C.all_gather(local.xyz, mesh).numpy()
    fused_mask = C.all_gather(local.mask, mesh).numpy()
    np.savez(os.path.join(out_dir, f"multihost{rank}.npz"),
             xyz=fused_xyz, mask=fused_mask, local=local.xyz.numpy(),
             local_mask=local.mask.numpy())
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["PCS_PLATFORM"] = "cpu"
    mode = sys.argv[1]
    if mode == "world":
        run_world(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
    elif mode == "multihost":
        run_multihost(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    print(f"CHILD_OK {mode} {sys.argv[2]}", flush=True)
