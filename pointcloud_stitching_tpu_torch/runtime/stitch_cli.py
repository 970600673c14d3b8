"""Multicamera stitching client CLI.

Port of ``pointcloud_stitching_tpu/runtime/stitch_cli.py`` (the reference's
pcs-multicamera-client). Flag parity (reference flag → here):
  -n num cameras / IP list  → --camera host:port (repeat)
  .cal directory            → --cal-dir (one .cal per camera)
  -f fps display            → --print-every
  -t timing                 → --timing (per-stage breakdown)
  -s save                   → --save-dir (PLY snapshot per --save-every)
  -d downsample             → --leaf / config
  -v visualize              → --view (in-process) or --publish-port plus
                              ``runtime.view_cli`` (decoupled)

CLI:
  python -m pointcloud_stitching_tpu_torch.runtime.stitch_cli \\
      --camera 127.0.0.1:8000 --camera 127.0.0.1:8001 \\
      [--cal-dir cals/] [--config cfg.json] [--frames 300] \\
      [--save-dir out/ --save-every 30] [--tsdf-leaf 0.02] \\
      [--map-leaf 0.01 --map-out scene.npz] [--drop-plane 0.02] \\
      [--publish-port 9000] [--view --view-dir viewer_out] [--trace-dir t/]

The device comes from PCS_PLATFORM: unset or ``cuda`` runs on the first
GPU (and fails without one), ``cpu`` runs the kernels' plain versions on
the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--camera", action="append", required=True,
                    help="host:port of a camera server (repeat per camera)")
    ap.add_argument("--cal-dir", help="directory of per-camera .cal files "
                                      "(sorted by name = camera order)")
    ap.add_argument("--intr-dir",
                    help="directory of per-camera .intr.json intrinsics "
                         "(sorted by name = camera order; default: nominal "
                         "D435 factory values)")
    ap.add_argument("--config", help="StitchConfig JSON path")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--print-every", type=int, default=30)
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--save-dir")
    ap.add_argument("--save-every", type=int, default=30)
    ap.add_argument("--leaf", type=float, default=None,
                    help="override output voxel leaf (meters)")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--no-icp", action="store_true")
    ap.add_argument("--crop", default=None, metavar="X0,Y0,Z0:X1,Y1,Z1",
                    help="world-frame crop box for the fused cloud (meters; "
                         "applied before the output voxel grid)")
    ap.add_argument("--normals", action="store_true",
                    help="attach per-point surface normals to the fused "
                         "output (saved .ply files carry nx/ny/nz). "
                         "Mutually exclusive with --color")
    ap.add_argument("--auto-leaf", action="store_true",
                    help="adapt the output grid resolution per frame")
    ap.add_argument("--auto-leaf-max", type=float, default=None,
                    help="--auto-leaf ceiling in meters (default 8x the "
                         "base leaf)")
    ap.add_argument("--payload", choices=["depth", "points"], default="depth",
                    help="wire payload kind (points = reference legacy mode)")
    ap.add_argument("--color", action="store_true",
                    help="ingest RGB and stitch coloured clouds")
    ap.add_argument("--color-intr-dir",
                    help="directory of per-camera colour-stream .intr.json "
                         "files; required when the config sets "
                         "color_height/color_width (non-aligned colour)")
    ap.add_argument("--color-cal-dir",
                    help="directory of per-camera depth→colour extrinsic "
                         ".cal files; identity per camera when omitted")
    ap.add_argument("--fps", type=float, default=None,
                    help="pace the stitch loop to this many ticks/sec")
    ap.add_argument("--record-dir",
                    help="record incoming depth streams as replayable .npy")
    ap.add_argument("--record-frames", type=int, default=300)
    ap.add_argument("--map-leaf", type=float, default=None,
                    help="accumulate stitched frames into a persistent "
                         "temporal voxel map at this leaf size (meters); "
                         "the denoised map saves to --map-out on exit")
    ap.add_argument("--map-capacity", type=int, default=None,
                    help="voxel-map slot capacity (occupied-voxel bound; "
                         "default 2^20). With --map-in this resizes the "
                         "loaded checkpoint (grow pads, shrink keeps the "
                         "highest-evidence voxels)")
    ap.add_argument("--map-decay", type=float, default=1.0,
                    help="per-frame map weight decay (1.0 = never forget; "
                         "0.98 at 30 FPS forgets in ~1.7 s)")
    ap.add_argument("--map-min-weight", type=float, default=0.05,
                    help="evict map voxels whose decayed weight falls below "
                         "this")
    ap.add_argument("--map-out", default="map.ply",
                    help="map path written on exit: .ply saves the denoised "
                         "centroid cloud, .npz saves the full resumable "
                         "accumulation state (see --map-in)")
    ap.add_argument("--map-in", default=None,
                    help="resume accumulation from a .npz map checkpoint "
                         "(leaf/color come from the file; --map-leaf may "
                         "be omitted)")
    ap.add_argument("--tsdf-leaf", type=float, default=None,
                    help="fuse depth keyframes into a persistent TSDF "
                         "volume at this voxel size (meters), every "
                         "--tsdf-every frames; saved to --tsdf-out on exit")
    ap.add_argument("--tsdf-shape", default="256,256,256",
                    metavar="X,Y,Z", help="TSDF grid shape in voxels")
    ap.add_argument("--tsdf-origin", default=None, metavar="x,y,z",
                    help="world position of voxel (0,0,0)'s centre "
                         "(default centres the grid on XY, Z from 0)")
    ap.add_argument("--tsdf-every", type=int, default=10,
                    help="integrate every K-th stitched frame")
    ap.add_argument("--tsdf-out", default="scene_tsdf.npz",
                    help="TSDF checkpoint written on exit")
    ap.add_argument("--tsdf-in", default=None,
                    help="resume from a --tsdf-out checkpoint")
    ap.add_argument("--tsdf-max-weight", type=float, default=64.0,
                    help="per-voxel evidence cap")
    ap.add_argument("--tsdf-track", action="store_true",
                    help="track the anchor camera frame-to-model against "
                         "the volume every keyframe and apply the gated "
                         "rigid-rig correction to all cameras")
    ap.add_argument("--tsdf-track-cam", type=int, default=0,
                    help="which camera anchors the frame-to-model track")
    ap.add_argument("--drop-plane", type=float, default=None, metavar="DIST",
                    help="segment the dominant plane each frame "
                         "(pcl::SACSegmentation role) and drop points "
                         "within DIST meters of it from every output")
    ap.add_argument("--trace-dir",
                    help="write a torch.profiler trace of the run "
                         "(trace.json) into this directory")
    ap.add_argument("--publish-port", type=int, default=None,
                    help="serve the stitched cloud stream on this TCP port")
    ap.add_argument("--view", action="store_true",
                    help="render the stitched cloud in-process: a cv2 "
                         "window when a GUI exists, else a rolling image "
                         "sequence in --view-dir (keys: a/d/w/s orbit, 0 "
                         "reset, n shade, p snapshot .ply, q close)")
    ap.add_argument("--view-dir", default="viewer_out")
    ap.add_argument("--view-axis", default="z", choices=("x", "y", "z"))
    ap.add_argument("--view-size", type=int, default=800)
    ap.add_argument("--view-every", type=int, default=1,
                    help="render every K-th stitched frame")
    return ap


def main(argv=None) -> int:
    """The command: stitch the cameras' frames, then exit status 0 (the
    run's ``FrameMetrics`` come from ``_run``, for callers that want
    them)."""
    _run(argv)
    return 0


def _run(argv=None):
    args = _parser().parse_args(argv)

    import dataclasses

    from ..io.calio import (discover_cals, discover_intrinsics, load_cals,
                            load_intrinsics_stack)
    from ..io.plyio import save_cloud
    from ..models.stitcher import StitchingPipeline
    from ..utils.config import StitchConfig
    from ..ops import extract_plane, segment_plane
    from ..utils import prng
    from ..utils.platform import platform_device, set_full_fp32_matmul
    from ..utils.profiling import trace
    from ..utils.types import Intrinsics
    from .client import MulticameraClient

    set_full_fp32_matmul()
    dev = platform_device()

    addresses = []
    for cam in args.camera:
        host, port = cam.rsplit(":", 1)
        addresses.append((host, int(port)))
    ncam = len(addresses)

    cfg = StitchConfig.load(args.config) if args.config else StitchConfig()
    updates = {"num_cameras": ncam}
    if args.leaf is not None:
        updates["out_voxel_leaf"] = args.leaf
    if args.height is not None:
        updates["height"] = args.height
    if args.width is not None:
        updates["width"] = args.width
    if args.no_icp:
        updates["icp_enabled"] = False
    if args.color:
        updates["with_color"] = True
    if args.normals:
        if args.payload == "points":
            # normals come from the organised depth grid; the points
            # payload has none
            raise SystemExit("--normals requires the depth payload "
                             "(--payload points clouds have no grid to "
                             "derive normals from)")
        updates["with_normals"] = True
    tsdf_on = args.tsdf_leaf is not None or args.tsdf_in is not None
    if tsdf_on and args.payload == "points":
        raise SystemExit("--tsdf-* integrates raw depth frames; the legacy "
                         "points payload carries none (use --payload "
                         "depth)")
    if args.tsdf_track and not tsdf_on:
        raise SystemExit("--tsdf-track corrects poses against the TSDF "
                         "volume; give it one (--tsdf-leaf or --tsdf-in)")
    if args.tsdf_track and not (0 <= args.tsdf_track_cam < ncam):
        raise SystemExit(f"--tsdf-track-cam {args.tsdf_track_cam} out of "
                         f"range for {ncam} cameras")
    tsdf_shape = tsdf_origin = None
    if tsdf_on:
        try:
            tsdf_shape = tuple(int(v) for v in args.tsdf_shape.split(","))
            if len(tsdf_shape) != 3 or any(s <= 0 for s in tsdf_shape):
                raise ValueError
        except ValueError:
            raise SystemExit(f"bad --tsdf-shape {args.tsdf_shape!r}; "
                             "want X,Y,Z positive voxel counts")
        if args.tsdf_origin is not None:
            try:
                tsdf_origin = tuple(
                    float(v) for v in args.tsdf_origin.split(","))
                if len(tsdf_origin) != 3:
                    raise ValueError
            except ValueError:
                raise SystemExit(f"bad --tsdf-origin {args.tsdf_origin!r}; "
                                 "want x,y,z meters (use --tsdf-origin=-1,"
                                 "... for negative corners)")
    if args.crop:
        try:
            lo_s, hi_s = args.crop.split(":")
            lo = tuple(float(v) for v in lo_s.split(","))
            hi = tuple(float(v) for v in hi_s.split(","))
            if len(lo) != 3 or len(hi) != 3 or any(
                    a >= b for a, b in zip(lo, hi)):
                raise ValueError
        except ValueError:
            raise SystemExit(f"bad --crop {args.crop!r}; want "
                             "X0,Y0,Z0:X1,Y1,Z1 with lo < hi per axis "
                             "(use --crop=-2,... for negative corners)")
        updates["crop_lo"], updates["crop_hi"] = lo, hi
    if args.auto_leaf:
        updates["out_leaf_autofit"] = True
        base = updates.get("out_voxel_leaf", cfg.out_voxel_leaf)
        updates["out_leaf_max"] = (args.auto_leaf_max
                                   if args.auto_leaf_max is not None
                                   else 8.0 * base)
    cfg = dataclasses.replace(cfg, **updates)

    if args.cal_dir:
        paths = discover_cals(args.cal_dir)
        if len(paths) != ncam:
            raise SystemExit(f"{len(paths)} .cal files for {ncam} cameras")
        ext = load_cals(paths)
    else:
        ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))

    if args.intr_dir:
        ipaths = discover_intrinsics(args.intr_dir)
        if len(ipaths) != ncam:
            raise SystemExit(f"{len(ipaths)} .intr.json files for "
                             f"{ncam} cameras")
        intr = load_intrinsics_stack(ipaths, device=dev)
        if intr.width != cfg.width or intr.height != cfg.height:
            raise SystemExit(
                f"intrinsics are {intr.width}x{intr.height} but the pipeline "
                f"is configured {cfg.width}x{cfg.height}")
    else:
        i0 = Intrinsics.d435_default(width=cfg.width, height=cfg.height,
                                     device=dev)
        intr = i0.stack([i0] * (ncam - 1))

    # non-aligned colour (cfg.color_height set) needs the colour stream's
    # own calibration; refuse up front with the fix spelled out
    color_intr = color_ext = None
    if args.color_intr_dir:
        cpaths = discover_intrinsics(args.color_intr_dir)
        if len(cpaths) != ncam:
            raise SystemExit(f"{len(cpaths)} color .intr.json files for "
                             f"{ncam} cameras")
        color_intr = load_intrinsics_stack(cpaths, device=dev)
        if args.color_cal_dir:
            ccals = discover_cals(args.color_cal_dir)
            if len(ccals) != ncam:
                raise SystemExit(f"{len(ccals)} depth→color .cal files for "
                                 f"{ncam} cameras")
            color_ext = load_cals(ccals)
    elif cfg.color_height is not None:
        raise SystemExit(
            "config sets color_height/color_width (non-aligned color) but "
            "no --color-intr-dir was given; pass the color stream's "
            "per-camera intrinsics (and optionally --color-cal-dir for "
            "depth→color extrinsics)")

    pipe = StitchingPipeline(cfg, intr, ext, device=dev,
                             color_intr=color_intr, color_ext=color_ext)
    client = MulticameraClient(
        addresses, pipe, payload=args.payload,
        record_frames=args.record_frames if args.record_dir else 0).start()
    if not client.wait_for_first_frames(timeout=15):
        errs = client.camera_errors()
        client.stop()
        raise SystemExit("no camera produced a frame within 15 s"
                         + (": " + "; ".join(errs) if errs else ""))
    print(f"streaming from {ncam} cameras on {dev}...", flush=True)

    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    publisher = None
    if args.publish_port is not None:
        from .publisher import CloudPublisher
        publisher = CloudPublisher(port=args.publish_port).start()
        print(f"publishing stitched clouds on :{publisher.port}", flush=True)

    view = view_sink = None
    snap_idx = 0   # --view 'p'-key snapshots
    if args.view:
        from .view_cli import CloudView, _directory_sink, _window_sink
        # a --normals rig shades its normals by default ('n' toggles)
        view = CloudView(axis=args.view_axis, size=args.view_size,
                         shade_normals=cfg.with_normals)
        view_sink = _window_sink()
        if view_sink is None:
            print(f"view: no GUI, writing image sequence to {args.view_dir}",
                  flush=True)
            view_sink = _directory_sink(args.view_dir, keep=300)

    def close_view() -> None:
        nonlocal view
        view = None
        try:
            import cv2
            cv2.destroyAllWindows()
        except Exception:   # no cv2 or no GUI: nothing to close
            pass

    def show(i, out) -> None:
        """Render one frame into the view sink and act on its key."""
        nonlocal snap_idx
        cmd = view_sink(i, view.render_cloud(out.cloud))
        if cmd == "quit":
            # q closes the in-process viewer; stitching goes on, as
            # closing the reference's PCLVisualizer window does
            close_view()
        elif cmd == "snap":
            # p saves the cloud that made this frame
            path = os.path.join(args.view_dir,
                                f"snapshot_{snap_idx:05d}.ply")
            os.makedirs(args.view_dir, exist_ok=True)
            save_cloud(path, out.cloud, decode_normals=cfg.with_normals)
            snap_idx += 1
            print(f"saved {path}", flush=True)
        else:
            view.apply_command(cmd)

    # one key on the device, made once and used for every frame, as the
    # JAX CLI uses its fixed key(0): each frame draws JAX's hypotheses
    drop_key = prng.key(0, device=dev) if args.drop_plane is not None \
        else None

    def drop_plane(out):
        model, _, _ = segment_plane(out.cloud, args.drop_plane, drop_key)
        return out._replace(cloud=extract_plane(out.cloud, model,
                                                args.drop_plane))

    map_on = args.map_leaf is not None or args.map_in is not None
    acc = None

    def map_update(out) -> None:
        """Fold the stitched cloud into the voxel map, made at the first
        frame (its colour must match the stitched output's)."""
        nonlocal acc
        if acc is None:
            from ..models.voxel_map import TemporalAccumulator
            if args.map_in is not None:
                acc = TemporalAccumulator.load(
                    args.map_in, capacity=args.map_capacity,
                    decay=args.map_decay, min_weight=args.map_min_weight,
                    device=dev)
                has_rgb = acc.state.rgb_sums is not None
                if has_rgb != (out.cloud.rgb is not None):
                    raise ValueError(
                        f"--map-in {args.map_in} was built "
                        f"{'with' if has_rgb else 'without'} color but this "
                        "rig streams the opposite — resume with a matching "
                        "config or start a fresh map")
            else:
                acc = TemporalAccumulator(
                    capacity=args.map_capacity or (1 << 20),
                    leaf=args.map_leaf, decay=args.map_decay,
                    min_weight=args.map_min_weight,
                    with_rgb=out.cloud.rgb is not None, device=dev)
        acc.update(out.cloud)

    tsdf_state = {"vol": None, "frames": 0,
                  "track_seen": 0, "track_applied": 0, "track_last": None}

    def tsdf_keyframe(out) -> None:
        """Keyframe TSDF fusion on the exact device-resident depth the
        stitch saw (StitchOutput.depth), against the frame's refined
        extrinsics; with --tsdf-track, frame-to-model tracking first."""
        from ..models import tsdf as tsdf_mod
        vol = tsdf_state["vol"]
        if vol is None:
            if args.tsdf_in is not None:
                vol = tsdf_mod.load_volume(args.tsdf_in, device=dev)
                if (vol.rgb is not None) and out.color is None:
                    raise SystemExit(
                        f"--tsdf-in {args.tsdf_in} carries color but "
                        "this rig streams none — pass --color or "
                        "start a fresh volume")
                if (vol.rgb is not None) and cfg.color_height is not None:
                    # a non-aligned stream's colour has its own geometry;
                    # integrate's depth-grid indices would fuse the wrong
                    # pixels' colour
                    raise SystemExit(
                        f"--tsdf-in {args.tsdf_in} carries color but "
                        "this rig streams non-depth-aligned color "
                        "(config sets color_height/color_width); "
                        "TSDF color needs per-depth-pixel alignment "
                        "— start a fresh volume or use an aligned "
                        "color stream")
            else:
                leaf = args.tsdf_leaf
                org = tsdf_origin if tsdf_origin is not None else (
                    -tsdf_shape[0] * leaf / 2.0,
                    -tsdf_shape[1] * leaf / 2.0, 0.0)
                # rgb only for depth-aligned colour streams
                vol = tsdf_mod.TSDFVolume.create(
                    tsdf_shape, leaf, origin=org,
                    with_rgb=(out.color is not None
                              and cfg.color_height is None), device=dev)
        color = out.color if vol.rgb is not None else None
        ext_kf = out.extrinsics
        # a dead anchor's slot keeps serving its last frame: tracking a
        # stale frame would pull the rig toward an outdated pose. The mask
        # read is a host sync, so it comes after the cheap host flags.
        if args.tsdf_track and tsdf_state["frames"] > 0 \
                and bool(out.cam_mask[args.tsdf_track_cam]):
            rt = tsdf_mod.rig_track(
                vol, out.depth, intr, out.extrinsics,
                cam=args.tsdf_track_cam, depth_scale=cfg.depth_scale,
                t_min=max(cfg.z_min, 0.05), t_max=cfg.z_max)
            tsdf_state["track_seen"] += 1
            tsdf_state["track_last"] = rt.track
            if rt.applied:
                tsdf_state["track_applied"] += 1
                ext_kf = rt.extrinsics
                from ..ops.se3 import mm
                pipe.extrinsics = mm(rt.G, pipe.extrinsics)
        tsdf_state["vol"] = tsdf_mod.integrate(
            vol, out.depth, intr, ext_kf, depth_scale=cfg.depth_scale,
            max_weight=args.tsdf_max_weight, color=color,
            cam_mask=out.cam_mask, z_min=cfg.z_min, z_max=cfg.z_max)
        tsdf_state["frames"] += 1

    def on_frame(i, out):
        if drop_key is not None:
            # the plane's inliers leave everything downstream (save,
            # publish, view, map)
            out = drop_plane(out)
        if map_on:
            map_update(out)
        if tsdf_on and i % max(args.tsdf_every, 1) == 0:
            tsdf_keyframe(out)
        if publisher is not None and publisher.num_subscribers:
            publisher.publish_cloud(out.cloud)
        if view is not None and i % max(args.view_every, 1) == 0:
            show(i, out)
        if args.print_every and i > 0 and i % args.print_every == 0:
            line = str(client.metrics)
            if args.timing:
                line += f" stages(ms)={client.stages.summary()}"
            print(line, flush=True)
        if args.save_dir and i % args.save_every == 0:
            save_cloud(os.path.join(args.save_dir, f"cloud_{i:06d}.ply"),
                       out.cloud, decode_normals=cfg.with_normals)

    try:
        with (trace(args.trace_dir) if args.trace_dir
              else contextlib.nullcontext()):
            metrics = client.run(num_frames=args.frames, on_frame=on_frame,
                                 fps=args.fps)
    except KeyboardInterrupt:
        metrics = client.metrics
    finally:
        # run() leaves the client started; the CLI is done with it
        client.stop()
        if publisher is not None:
            publisher.stop()
    if args.record_dir:
        paths = client.save_recording(args.record_dir)
        print(f"recorded {len(paths)} camera streams to {args.record_dir}")
    if acc is not None:
        if args.map_out.endswith(".npz"):
            acc.save(args.map_out)   # the full resumable state
        else:
            save_cloud(args.map_out, acc.cloud())
        print(f"saved accumulated map ({int(acc.state.count())} voxels) "
              f"to {args.map_out}")
    if tsdf_state["vol"] is not None:
        from ..models.tsdf import save_volume
        save_volume(args.tsdf_out, tsdf_state["vol"])
        occ = int((tsdf_state["vol"].weight > 0).sum())
        line = (f"saved TSDF volume ({tsdf_state['frames']} keyframes, "
                f"{occ} observed voxels) to {args.tsdf_out}")
        if args.tsdf_track and tsdf_state["track_seen"]:
            last = tsdf_state["track_last"]
            line += (f"; tracking applied {tsdf_state['track_applied']}/"
                     f"{tsdf_state['track_seen']} corrections "
                     f"(last rms {float(last.rms) * 1e3:.1f} mm, "
                     f"{int(last.n_matched)} matched)")
        print(line)
    print(metrics)
    return metrics


if __name__ == "__main__":
    raise SystemExit(main())
