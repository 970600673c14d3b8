#!/usr/bin/env python
"""Correspondence picker CLI: click (or type) >=3 point pairs, get a picks file.

Port of ``pointcloud_stitching_tpu/tools/pick_cli.py`` (numpy only: it
renders and picks on the host). It replaces the interactive half of the
reference registration tool (reference: registration/ manual_registration
workflow — pick pairs in a dual-viewport PCL viewer; SURVEY.md §3.4).
Renders both clouds side by side with per-pixel
point-index maps (io/picker.py), then collects pairs through whichever
front-end the box supports:

  * cv2 GUI (default when a display works): the two views share one window;
    click a point in the LEFT (source) view, then its match in the RIGHT
    (target) view; keys: u = undo last pair, s = save + exit, q = quit.
  * --pairs "us,vs:ut,vt ..." — non-interactive pixel pairs (scriptable,
    and what the tests drive).
  * stdin REPL (no GUI, no --pairs): the tool writes both rendered views to
    --render-dir, you open them in anything that shows an image (browser
    over ssh, VS Code, web server) and type "us,vs ut,vt" lines.

Then feed the picks file to ``register_cli --picks``.

Usage:
  python -m pointcloud_stitching_tpu_torch.tools.pick_cli src.ply dst.ply \
      picks.txt [--axis z] [--size 800] [--radius 6] [--pairs "..."] \
      [--render-dir d]
"""
from __future__ import annotations

import argparse
import os
import sys


def _load(path):
    from pointcloud_stitching_tpu_torch.io import load_pcd, load_ply
    xyz, rgb = (load_pcd(path) if path.endswith(".pcd") else load_ply(path))
    return xyz, rgb


def collect_pairs_from_pixels(pixel_pairs, maps, radius):
    """Map ((us, vs), (ut, vt)) pixel pairs to (src_idx, dst_idx) via the
    two index maps; drops pairs where either click misses all points."""
    from pointcloud_stitching_tpu_torch.io.picker import pick_index
    src_map, dst_map = maps
    out, missed = [], 0
    for (us, vs), (ut, vt) in pixel_pairs:
        si = pick_index(src_map, us, vs, radius)
        ti = pick_index(dst_map, ut, vt, radius)
        if si < 0 or ti < 0:
            missed += 1
            continue
        out.append((si, ti))
    return out, missed


def _parse_pairs_arg(arg: str):
    pairs = []
    for tok in arg.split():
        a, b = tok.split(":")
        us, vs = (int(x) for x in a.split(","))
        ut, vt = (int(x) for x in b.split(","))
        pairs.append(((us, vs), (ut, vt)))
    return pairs


def _gui_pick(imgs, maps, radius):
    """cv2 window front-end. Returns pairs or None if no GUI available."""
    import os
    # gate on a display server BEFORE touching imshow: cv2's Qt backend
    # ABORTS the process (not a Python exception) when no display
    # exists, so try/except alone would never reach the REPL fallback
    # on a headless box
    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        return None
    try:
        import cv2
        import numpy as np
        canvas0 = np.concatenate(imgs, axis=1)
        cv2.imshow("pick", canvas0)
        cv2.waitKey(1)
    except Exception:
        return None
    from pointcloud_stitching_tpu_torch.io.picker import pick_index
    size = imgs[0].shape[0]
    pairs, pending = [], []   # pending = clicked source point awaiting match
    canvas = canvas0.copy()

    def redraw():
        nonlocal canvas
        canvas = canvas0.copy()
        for n, (si, ti, ps, pt) in enumerate(pairs):
            cv2.circle(canvas, ps, radius, (0, 255, 0), 1)
            cv2.circle(canvas, (pt[0] + size, pt[1]), radius, (0, 255, 0), 1)
            cv2.putText(canvas, str(n), (ps[0] + 4, ps[1] - 4),
                        cv2.FONT_HERSHEY_PLAIN, 1.0, (0, 255, 0))
            cv2.putText(canvas, str(n), (pt[0] + size + 4, pt[1] - 4),
                        cv2.FONT_HERSHEY_PLAIN, 1.0, (0, 255, 0))
        for ps in pending:
            cv2.circle(canvas, ps, radius, (0, 255, 255), 1)

    def on_mouse(event, x, y, flags, _):
        if event != cv2.EVENT_LBUTTONDOWN:
            return
        if x < size:                      # left = source view
            if pick_index(maps[0], x, y, radius) >= 0:
                pending[:] = [(x, y)]
        elif pending:                     # right = target view
            si = pick_index(maps[0], *pending[0], radius)
            ti = pick_index(maps[1], x - size, y, radius)
            if ti >= 0:
                pairs.append((si, ti, pending[0], (x - size, y)))
            pending.clear()
        redraw()

    cv2.setMouseCallback("pick", on_mouse)
    print("click source (left) then target (right); u=undo s=save q=quit",
          flush=True)
    while True:
        cv2.imshow("pick", canvas)
        k = cv2.waitKey(30) & 0xFF
        if k == ord("u") and pairs:
            pairs.pop()
            redraw()
        elif k == ord("s"):
            cv2.destroyAllWindows()
            return [(si, ti) for si, ti, _, _ in pairs]
        elif k == ord("q"):
            cv2.destroyAllWindows()
            return []


def _repl_pick(maps, radius):
    print("enter 'us,vs ut,vt' per pair (source-view and target-view "
          "pixels); blank line = done", flush=True)
    pairs = []
    for line in sys.stdin:
        line = line.strip()
        if not line:
            break
        try:
            a, b = line.split()
            us, vs = (int(x) for x in a.split(","))
            ut, vt = (int(x) for x in b.split(","))
        except ValueError:
            print(f"could not parse {line!r}", flush=True)
            continue
        pairs.append(((us, vs), (ut, vt)))
    got, missed = collect_pairs_from_pixels(pairs, maps, radius)
    if missed:
        print(f"{missed} pair(s) missed all points", flush=True)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="source cloud (.ply/.pcd)")
    ap.add_argument("dst", help="target cloud (.ply/.pcd)")
    ap.add_argument("out", help="output picks file (for register_cli --picks)")
    ap.add_argument("--axis", default="z", choices=("x", "y", "z"))
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--radius", type=int, default=6,
                    help="pixel search radius around each click")
    ap.add_argument("--pairs", default=None,
                    help='non-interactive: "us,vs:ut,vt us,vs:ut,vt ..."')
    ap.add_argument("--render-dir", default=None,
                    help="also write the two rendered views (+index maps) "
                         "here — needed for the typed/REPL workflow")
    args = ap.parse_args(argv)

    import numpy as np
    from pointcloud_stitching_tpu_torch.io.picker import (render_indexed,
                                                          save_picks)

    views = []
    for path in (args.src, args.dst):
        xyz, rgb = _load(path)
        img, idx = render_indexed(xyz, rgb, axis=args.axis, size=args.size)
        views.append((img, idx))
    imgs = [v[0] for v in views]
    maps = [v[1] for v in views]

    if args.render_dir:
        from pointcloud_stitching_tpu_torch.io.render import save_image
        os.makedirs(args.render_dir, exist_ok=True)
        save_image(os.path.join(args.render_dir, "source.png"), imgs[0])
        save_image(os.path.join(args.render_dir, "target.png"), imgs[1])
        np.save(os.path.join(args.render_dir, "source_index.npy"), maps[0])
        np.save(os.path.join(args.render_dir, "target_index.npy"), maps[1])
        print(f"rendered views in {args.render_dir}", flush=True)

    if args.pairs is not None:
        pairs, missed = collect_pairs_from_pixels(
            _parse_pairs_arg(args.pairs), maps, args.radius)
        if missed:
            print(f"{missed} pair(s) missed all points", flush=True)
    else:
        pairs = _gui_pick(imgs, maps, args.radius)
        if pairs is None:
            print("no GUI available, falling back to typed pairs "
                  "(see --render-dir for the images to look at)", flush=True)
            pairs = _repl_pick(maps, args.radius)

    if len(pairs) < 3:
        print(f"only {len(pairs)} pairs collected; register_cli needs >=3",
              flush=True)
        return 1
    save_picks(args.out, pairs)
    print(f"wrote {len(pairs)} pairs to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
