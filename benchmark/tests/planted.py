"""What the tests plant under a run: a small copy of a configuration for
the CPU, and a fault under the timed path."""
from __future__ import annotations

import json

import torch

from benchmark import harness

FAULTS = ("unchanged", "half", "altered")


def shrink(cfg: dict, cameras: int = 8, factor: int = 4,
           cycle: int = 3) -> dict:
    """A small copy of a configuration: fewer cameras, the image and focal
    lengths cut by ``factor``, a shorter cycle and a smaller output
    capacity, and the ICP grid stride cut with the image, so that the ICP
    clouds sample the scene as densely."""
    c = json.loads(json.dumps(cfg))
    rig, st = c["rig"], c["stitch"]
    rig["cameras"] = st["num_cameras"] = cameras
    rig["width"] = st["width"] = rig["width"] // factor
    rig["height"] = st["height"] = rig["height"] // factor
    rig["fx"] /= factor
    rig["fy"] /= factor
    st["icp_stride"] = max(1, st["icp_stride"] // factor)
    st["out_capacity"] = 65536
    c["scene"]["cycle_frames"] = cycle
    return c


class Faulty:
    """The pipeline with one fault planted under the timed path:
    ``unchanged`` returns the state it was given (the calibration as the
    refined extrinsics, the previous frame's cloud), ``half`` leaves out
    the second half of the cameras, ``altered`` moves every output point
    by 2 mm where the output is produced."""

    def __init__(self, pipe, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self._pipe, self._fault, self._last = pipe, fault, None

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def __call__(self, depths, colors=None, cam_mask=None):
        if self._fault == "half":
            n = self._pipe.cfg.num_cameras
            keep = torch.arange(n, device=self._pipe.device) < n // 2
            cam_mask = keep if cam_mask is None else cam_mask & keep
        out = self._pipe(depths, colors, cam_mask)
        if self._fault == "unchanged":
            prev, self._last = self._last, out
            out = out._replace(extrinsics=self._pipe.extrinsics.clone(),
                               cloud=(out if prev is None else prev).cloud)
        elif self._fault == "altered":
            xyz = out.cloud.xyz + torch.tensor(
                [2e-3, 0.0, 0.0], device=out.cloud.xyz.device)
            out = out._replace(cloud=out.cloud.replace(xyz=xyz))
        return out


def plant(monkeypatch, cfgs: dict | None = None, mixes: dict | None = None,
          fault: str | None = None) -> None:
    """Make ``harness.run_cell`` find the configurations ``cfgs`` and the
    traffic mixes ``mixes`` (by name) in place of the cell's own files,
    and hand its runner the pipeline with ``fault`` planted."""
    if cfgs is not None:
        monkeypatch.setattr(harness, "config", cfgs.__getitem__)
    if mixes is not None:
        monkeypatch.setattr(harness, "traffic", mixes.__getitem__)
    if fault is not None:
        build = harness.Context.pipeline

        def pipeline(self, calib):
            return Faulty(build(self, calib), fault)

        monkeypatch.setattr(harness.Context, "pipeline", pipeline)
