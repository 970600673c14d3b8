#!/usr/bin/env python3
"""The camera-rate sweep of a stream cell, on the card (the benchmark's
runs never run this): the cell's traffic with the cameras and the client
at each rate, one process per rate, delivered frames per second and the
latency percentiles of each.

    python3 benchmark/sweep.py --workload rig8_ring_icp.stream15 \
        --rates 15,20,30,40,50,60 --seconds 10

The knee is the highest rate whose delivered rate keeps up with the
cameras'.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def one(cell: str, rate: float, seconds: float, seed: int) -> dict:
    from benchmark import harness
    mix = harness.traffic

    def at_rate(name: str) -> dict:
        return dict(mix(name), camera_fps=rate, client_fps=rate)

    harness.traffic = at_rate      # this process runs this one rate
    line, _ = harness.run_cell(cell, seed, seconds, False, "cuda:0",
                               time.perf_counter())
    return {"rate": rate, "correct": line["correct"],
            "failed": line["failed"], "attempted": line["attempted"],
            **{k: v["value"] for k, v in line["metrics"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", default="20,30,40,50,60")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--one", type=float, default=None)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.workload, args.one, args.seconds,
                             args.seed)), flush=True)
        return 0
    for rate in (float(r) for r in args.rates.split(",")):
        out = subprocess.run(
            [sys.executable, __file__, "--workload", args.workload,
             "--seconds", str(args.seconds), "--seed", str(args.seed),
             "--one", str(rate)], capture_output=True, text=True)
        lines = out.stdout.strip().splitlines()
        print(lines[-1] if out.returncode == 0 and lines
              else json.dumps({"rate": rate, "error": out.stderr[-800:]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
