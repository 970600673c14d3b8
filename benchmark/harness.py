"""One run of one cell: find its pieces by name, drive its traffic, judge
its outputs and assemble the result line.

Everything is found by the names in ``BENCHMARK.json``: the cell's
configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json`` (whose ``kind`` names the runner:
``closed`` -> ``loop.py``, ``stream`` -> ``stream.py``) and each
per-layer metric's reader in ``metrics/<metric>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import check, scene, trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
RUNNERS = {"closed": "benchmark.loop", "stream": "benchmark.stream"}
# top-level modules a run may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "pointcloud_stitching_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def reader(metric: str):
    """The ``read(span)`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of ``spec[kind]`` that this cell reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def intr_of(cfg: dict) -> dict:
    rig = cfg["rig"]
    return {"fx": rig["fx"], "fy": rig["fy"], "ppx": rig["width"] / 2.0,
            "ppy": rig["height"] / 2.0}


def color_of(cfg: dict) -> dict | None:
    """The colour sensor of a configuration with a ``color`` block, as the
    reference and the pipeline take it (intrinsics, ``width``, ``height``,
    the depth-to-colour extrinsic ``ext`` [4, 4] float64, ``aligned``), or
    None. The ``stitch`` block has to ask for the same colour."""
    if not scene.has_color(cfg):
        return None
    blk, st = cfg["rig"]["color"], cfg["stitch"]
    aligned = scene.color_aligned(cfg)
    dims = [None, None] if aligned else [blk["height"], blk["width"]]
    if not st.get("with_color") or \
            [st.get("color_height"), st.get("color_width")] != dims:
        raise ValueError("the stitch block's with_color, color_height and "
                         "color_width do not match the rig's colour block")
    return {"fx": blk["fx"], "fy": blk["fy"], "ppx": blk["ppx"],
            "ppy": blk["ppy"], "width": blk["width"],
            "height": blk["height"], "ext": scene.depth_to_color(cfg),
            "aligned": aligned}


@dataclasses.dataclass
class Context:
    """What a runner needs for one run of one cell."""
    cell: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    setup_s: float | None = None

    def stitch_config(self):
        from pointcloud_stitching_tpu_torch import StitchConfig
        return StitchConfig(**self.cfg["stitch"])

    def pipeline(self, calib: torch.Tensor):
        """The system under test: a ``StitchingPipeline`` of this
        configuration at the calibration ``calib``; a colour stream of its
        own resolution gets the colour intrinsics and depth-to-colour
        extrinsics, as ``stitch_cli --color-intr-dir`` gives them."""
        from pointcloud_stitching_tpu_torch import (Intrinsics,
                                                    StitchingPipeline)
        rig = self.cfg["rig"]
        n = rig["cameras"]
        i0 = Intrinsics.create(fx=rig["fx"], fy=rig["fy"],
                               ppx=rig["width"] / 2.0,
                               ppy=rig["height"] / 2.0, width=rig["width"],
                               height=rig["height"], device=self.device)
        intr = i0.stack([i0] * (n - 1))
        col, kw = color_of(self.cfg), {}
        if col is not None and not col["aligned"]:
            c0 = Intrinsics.create(fx=col["fx"], fy=col["fy"],
                                   ppx=col["ppx"], ppy=col["ppy"],
                                   width=col["width"], height=col["height"],
                                   device=self.device)
            kw = {"color_intr": c0.stack([c0] * (n - 1)),
                  "color_ext": col["ext"].to(torch.float32).repeat(n, 1, 1)}
        return StitchingPipeline(self.stitch_config(), intr, calib,
                                 update_mode=self.cfg["update_mode"],
                                 device=self.device, **kw)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def end_setup(self) -> None:
        """Set-up ends here: the first timed frame comes next. The peak
        of device memory counts from here (the frames stay resident)."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        self.sync()
        return int(torch.cuda.max_memory_allocated(self.device))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_cell(cell: str, seed: int, seconds: float, trace_on: bool,
             device, t_start: float):
    """Drive one run of ``cell`` on ``device`` and judge it; set-up is
    timed from ``t_start``. Returns (result line as a dict, check lines
    for standard error)."""
    spec = benchmark_spec()
    entry = next(w for w in spec["workloads"] if w["name"] == cell)
    cfg = config(entry["config"])
    mix = traffic(entry["traffic"])
    ctx = Context(cell=cell, cfg=cfg, traffic=mix, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace_on),
                  device=torch.device(device), t_start=t_start)
    drive = importlib.import_module(RUNNERS[mix["kind"]]).run
    res = drive(ctx)
    if ctx.trace and res["span"] is None:
        raise RuntimeError("the window closed before its traced span")
    col = color_of(cfg)
    readings = [check.judge(s["ext"], s["xyz"], s["depths"], s["calib"],
                            intr_of(cfg), cfg["stitch"], ctx.device,
                            **({} if col is None else {
                                "rgb": s["rgb"], "colors": s["colors"],
                                "color": col}))
                for s in res["samples"]]
    correct, table = check.verdict(readings, cfg["limits"],
                                   color=col is not None)
    # a frame that says the wrong thing is not correct; one that lacked a
    # camera the client found stale is a failure, not a wrong answer
    correct = correct and res["attempted"] > 0 and res["wrong"] == 0
    kind = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(spec, cell, kind):
        if ctx.trace:
            v = reader(m["name"])(res["span"])
        elif m["name"] == "setup_s":
            v = ctx.setup_s
        else:
            v = res["end_to_end"].get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": bool(correct), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if ctx.trace:
        span = res["span"]
        dev["busy_s"], dev["window_s"] = span.busy_s, span.window_s
        line["breakdown"] = trace.breakdown(span)
    line["cell"], line["seed"] = cell, ctx.seed
    line["card"] = card_line() if ctx.device.type == "cuda" else "cpu"
    line["info"] = res.get("info", {})
    line["info"]["ref_voxels"] = [r["ref_voxels"] for r in readings]
    line["info"]["icp_voxels_max"] = max(
        (r["icp_voxels_max"] for r in readings), default=0)
    line["checks"] = table
    lines = [f"check {k}: {v['value']} (limit {v['limit']})"
             for k, v in table.items()]
    lines.append(f"check wrong frames: {res['wrong']} of "
                 f"{res['attempted']} (limit 0)")
    table["wrong_frames"] = {"value": res["wrong"], "limit": 0}
    return line, lines
