#!/usr/bin/env python3
"""The readings the limits of ``check.py`` are set from, at a cell's own
size on the card (the benchmark's runs never run this):

* sound: the program (``StitchingPipeline`` of the configuration) on
  frames of the cycle of each seed, judged by ``check.judge``;
* control: the reference itself in the program's place, computed in the
  nearest precision below the configuration's float32: float32 with TF32
  matrix products (the program turns TF32 off), judged the same way.

A configuration with colour feeds both its colour cycle
(``scene.render_color``) and reads ``color_off_pct`` too.

    python3 benchmark/control.py --config rig8_ring_icp --seeds 1-12 \
        --control-seeds 1-3 --frames 15

prints one JSON line per seed and side (each number as a run compares it
over its frames), then the largest sound reading and the smallest control
reading of each number.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import check, harness, reference, scene  # noqa: E402


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b or a) + 1))
    return out


def readings(cfg: dict, seed: int, frames: int, control: bool,
             dev) -> list[dict]:
    """The numbers of each of ``frames`` seeded cycle frames of ``seed``."""
    rig = scene.make_rig(cfg, seed)
    cycle = scene.render_cycle(cfg, rig, seed, dev)
    col = harness.color_of(cfg)
    colors = None if col is None else scene.render_color(cfg, rig, seed, dev)

    def color(f):
        return None if colors is None else colors[f]

    picks = random.Random(seed).sample(range(len(cycle)), frames)
    intr, st = harness.intr_of(cfg), cfg["stitch"]
    ctx = harness.Context("control", cfg, {}, seed, 0.0, False, dev, 0.0)
    out = []
    if control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        try:
            made = []
            for f in picks:
                ext, xyz, _, rgb = reference.stitch(
                    cycle[f], rig.calib.to(dev), intr, st, torch.float32,
                    colors=color(f), color=col)
                made.append((ext, xyz, rgb))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
    else:
        pipe = ctx.pipeline(rig.calib)
        made = []
        for f in picks:
            o = pipe(cycle[f], color(f))
            m = o.cloud.mask
            made.append((o.extrinsics, o.cloud.xyz[m],
                         None if col is None else o.cloud.rgb[m]))
    for f, (ext, xyz, rgb) in zip(picks, made):
        kw = {} if col is None else {"rgb": rgb, "colors": color(f),
                                     "color": col}
        r = check.judge(ext, xyz, cycle[f], rig.calib, intr, st, dev, **kw)
        out.append({"frame": f, **r})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--frames", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    cfg = harness.config(args.config)
    worst = {"sound": {}, "control": {}}
    for side, ss in (("sound", seeds(args.seeds)),
                     ("control", seeds(args.control_seeds))):
        for s in ss:
            rs = readings(cfg, s, args.frames, side == "control", dev)
            w = check.worst(rs, cfg["limits"])
            print(json.dumps({"side": side, "seed": s, "worst": w,
                              "frames": rs}), flush=True)
            agg = max if side == "sound" else min
            for k, v in w.items():
                worst[side][k] = agg(worst[side].get(k, v), v)
    print(json.dumps({"config": args.config,
                      "lower": worst["sound"], "upper": worst["control"],
                      "card": harness.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
