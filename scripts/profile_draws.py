#!/usr/bin/env python3
"""What the random draws cost the paths that draw: two trees of the port
in turns on one NVIDIA GPU.

    python3 scripts/profile_draws.py OTHER_TREE

runs, each in a process of its own and in the order OTHER, this checkout,
this checkout, OTHER (host-bound times drift within a call and between
calls, so only turns within one call compare), and for each run prints
one JSON line:

  * ``segment_plane`` (1024 hypotheses, 1 cm) on ``chip_smoke.py``'s two
    clouds (the registration cloud, 113,301 points in 131,072 slots, and
    the flagship stitch of the stream rig, 262,144 slots): the median of
    20 synced calls, in ms;
  * ``stitch_cli --drop-plane 0.01`` over the stream rig (8 fake cameras
    of 848x480 on loopback, snappy, in the process; 30 frames): fps and
    p50 latency;
  * where the tree draws from keys, each draw of ``chip_smoke.draw_calls``
    through ``chip_smoke.draw_profile``: device ms, ms per call back to
    back, the card's kernels per draw in ``torch.profiler`` (of which the
    port's) and the wrappers' launches. A fresh process counts them all
    (late in ``chip_smoke.py``'s long process the profiler drops some).

OTHER_TREE is an unpacked ``git archive`` of another commit, such as the
parent. A tree from before the key stream (no ``utils/prng.py``) draws
from a ``torch.Generator`` seeded 0 and reads its metrics from
``stitch_cli.main``, as it did then. The helpers (the rig, the clouds,
the timers, the patient client, the draws) are ``chip_smoke.py``'s.
Imports nothing of JAX; prints the card's name and power limit first.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20


def one(tree: str) -> dict:
    """The numbers of one tree, in this process."""
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.join(REPO, "tests"))    # oracle.py's scenes
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    import numpy as np
    import torch
    import pointcloud_stitching_tpu_torch as P
    from pointcloud_stitching_tpu_torch.ops import segment_plane
    from pointcloud_stitching_tpu_torch.runtime import (
        Codec, FakeCameraServer, stitch_cli)

    dev = torch.device("cuda", 0)
    if os.path.exists(os.path.join(os.path.dirname(P.__file__), "utils",
                                   "prng.py")):
        from pointcloud_stitching_tpu_torch.utils import prng
        draw, run, label = prng.key(0, device=dev), stitch_cli._run, "key"
    else:
        draw = torch.Generator(device=dev).manual_seed(0)
        run, label = stitch_cli.main, "torch.Generator"
    out = {"tree": tree, "draws from": label}

    frames, ext = CS.stream_rig()
    i0 = P.Intrinsics.create(fx=421.5, fy=421.1, ppx=CS.W / 2.0,
                             ppy=CS.H / 2.0, width=CS.W, height=CS.H,
                             device=dev)
    d_rig = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    flag = P.StitchingPipeline(CS.flagship_cfg(P.StitchConfig),
                               i0.stack([i0] * (CS.NCAM - 1)), ext,
                               device=dev)(d_rig).cloud
    if label == "key":
        from pointcloud_stitching_tpu_torch.kernels import build as kb
        p = flag.mask.to(torch.float32)
        p = p / torch.clamp(p.sum(), min=1.0)
        for name, fn in CS.draw_calls(dev, p).items():
            fn()
            dev_ms, call_ms, ops, ours, launches = CS.draw_profile(fn, kb)
            out[f"draw {name}"] = {
                "device ms": dev_ms, "ms per call": call_ms,
                "kernels": ops, "of which the port's": ours,
                "wrapper launches": launches}
    src = CS.registration_scene(dev).src
    for tag, pc in (("131k", src), ("262k", flag)):
        out[f"segment_plane {tag} ms"] = CS.median_ms(
            lambda: segment_plane(pc, CS.PLANE_THR, draw), CALLS)

    servers = [FakeCameraServer(f, codec=Codec.SNAPPY).start()
               for f in frames]
    undo = CS.patient_client()
    try:
        cams = sum((["--camera", f"127.0.0.1:{s.port}"] for s in servers),
                   [])
        with contextlib.redirect_stdout(io.StringIO()):
            m = run(cams + ["--height", str(CS.H), "--width", str(CS.W),
                            "--frames", str(CS.DROP_FRAMES), "--print-every",
                            "0", "--drop-plane", str(CS.PLANE_THR)])
    finally:
        undo()
        for s in servers:
            s.stop()
    out["--drop-plane fps"] = m.fps
    out["--drop-plane p50 ms"] = m.latency_ms(50)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        print("profile_draws: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(smi.stdout.strip(), flush=True)
    other = os.path.abspath(sys.argv[1])
    for tree in (other, REPO, REPO, other):
        # a fresh process per turn: both trees name their package alike
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree])
        if done.returncode != 0:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
