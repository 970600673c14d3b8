"""What the tests plant under a run: a small copy of a configuration for
the CPU, a copy with colour, and a fault under the timed path."""
from __future__ import annotations

import json

import torch

from benchmark import harness, scene

FAULTS = ("unchanged", "half", "altered")
# the faults of a configuration with colour: R and B swapped, the
# depth-to-colour extrinsic left out (a colour stream of its own only),
# each camera given its neighbour's colour frame, every colour sampled one
# pixel to the right
COLOR_FAULTS = ("rb_swapped", "no_color_ext", "neighbour_color",
                "color_shifted")

# an Intel RealSense D435's RGB sensor at 1280x720 and 30 FPS beside its
# depth: intrinsics and depth-to-colour extrinsic of that part's published
# geometry (RGB about 15 mm beside the left imager, the depth origin);
# texture and noise as in ``scene.render_color``
D435_RGB = {"width": 1280, "height": 720, "fx": 909.2, "fy": 908.9,
            "ppx": 641.4, "ppy": 363.8, "t_m": [0.0148, 0.0001, 0.0003],
            "rot_deg": [0.05, -0.12, 0.03], "texture_amp": 60.0,
            "texture_wavelength_m": [0.02, 0.05], "noise_sigma": 3.0}
# the colour number's limit (PERF.md section 2: above the program's
# readings, below the control's)
COLOR_LIMIT = 2.0


def faults(cfg: dict) -> tuple:
    """The faults a configuration can have."""
    if "color" not in cfg["rig"]:
        return FAULTS
    own = tuple(f for f in COLOR_FAULTS if f != "no_color_ext"
                or not scene.color_aligned(cfg))
    return FAULTS + own


def with_color(cfg: dict, aligned: bool = False,
               block: dict = D435_RGB) -> dict:
    """A copy of a configuration whose rig streams colour: ``block``'s
    colour stream at its own resolution, or (``aligned``) depth-aligned
    colour at the depth's, with ``color_off_pct``'s limit."""
    c = json.loads(json.dumps(cfg))
    rig, st = c["rig"], c["stitch"]
    blk = dict(block)
    if aligned:
        blk.update(width=rig["width"], height=rig["height"], fx=rig["fx"],
                   fy=rig["fy"], ppx=rig["width"] / 2.0,
                   ppy=rig["height"] / 2.0, t_m=[0.0] * 3,
                   rot_deg=[0.0] * 3)
    rig["color"] = blk
    st["with_color"] = True
    if not aligned:
        st["color_height"], st["color_width"] = blk["height"], blk["width"]
    c["limits"]["color_off_pct"] = COLOR_LIMIT
    return c


def shrink(cfg: dict, cameras: int = 8, factor: int = 4,
           cycle: int = 3) -> dict:
    """A small copy of a configuration: fewer cameras, the image and focal
    lengths cut by ``factor`` (the colour sensor's too), a shorter cycle
    and a smaller output capacity, and the ICP grid stride cut with the
    image, so that the ICP clouds sample the scene as densely."""
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
    blk = rig.get("color")
    if blk is not None:
        blk["width"] //= factor
        blk["height"] //= factor
        for k in ("fx", "fy", "ppx", "ppy"):
            blk[k] /= factor
        if st.get("color_height") is not None:
            st["color_height"], st["color_width"] = blk["height"], \
                blk["width"]
    return c


class Faulty:
    """The pipeline with one fault planted under the timed path:
    ``unchanged`` returns the state it was given (the calibration as the
    refined extrinsics, the previous frame's cloud), ``half`` leaves out
    the second half of the cameras, ``altered`` moves every output point
    by 2 mm where the output is produced; and of colour
    (``COLOR_FAULTS``), ``rb_swapped`` swaps the colour frames' R and B,
    ``no_color_ext`` maps colour without the depth-to-colour extrinsic,
    ``neighbour_color`` gives each camera its ring neighbour's colour frame
    and ``color_shifted`` samples every colour one pixel to the right."""

    def __init__(self, pipe, fault: str):
        if fault not in FAULTS + COLOR_FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self._pipe, self._fault, self._last = pipe, fault, None
        if fault == "no_color_ext":
            pipe.color_ext = None       # the stitcher maps by the identity

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def __call__(self, depths, colors=None, cam_mask=None):
        if self._fault == "rb_swapped":
            colors = colors.flip(-1)
        elif self._fault == "neighbour_color":
            colors = colors.roll(1, dims=0)
        elif self._fault == "color_shifted":
            colors = torch.cat([colors[..., 1:, :], colors[..., -1:, :]],
                               dim=-2)
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
