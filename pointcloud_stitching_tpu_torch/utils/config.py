"""Declarative pipeline configuration of the PyTorch port.

A copy of ``pointcloud_stitching_tpu/utils/config.py::StitchConfig`` with
every field and check, apart from the kernel backend: ``kernel_impl`` takes
``auto | cuda | torch`` and ``kernel_interpret`` is gone. The port cannot
import the JAX config (importing any module of the JAX package imports
jax), and the JAX config rejects these backend names.
"""
from __future__ import annotations

import dataclasses
import json

KERNEL_IMPLS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class StitchConfig:
    """Static shape/program configuration for the stitching pipeline."""

    num_cameras: int = 4
    height: int = 480
    width: int = 848
    depth_scale: float = 0.001
    z_min: float = 0.1
    z_max: float = 10.0
    decimation: int = 1          # grid-stride depth decimation
    # stitch coloured clouds (depth-aligned RGB, or texture-mapped from a
    # colour stream of its own resolution when color_height/width are set)
    with_color: bool = False
    # attach per-point surface normals to the fused output, quantised to
    # 3x8-bit in the cloud's rgb channel (decode: (rgb / 127.5) - 1)
    with_normals: bool = False
    color_height: int | None = None
    color_width: int | None = None

    # optional per-camera voxel pre-downsample
    cam_voxel_enabled: bool = False
    cam_voxel_leaf: float = 0.01
    cam_capacity: int = 131072

    # fused output cloud
    out_voxel_leaf: float = 0.01
    out_capacity: int = 262144
    # optional world-frame crop of the fused cloud before the voxel pass
    crop_lo: tuple[float, float, float] | None = None
    crop_hi: tuple[float, float, float] | None = None
    # adaptive output resolution (see models.stitcher.autofit_out_leaf)
    out_leaf_autofit: bool = False
    out_leaf_max: float = 0.08

    # per-frame ring ICP drift correction
    icp_enabled: bool = True
    icp_stride: int = 6
    icp_voxel_leaf: float = 0.07
    icp_capacity: int = 2048
    icp_iterations: int = 5
    icp_max_corr_dist: float = 0.1
    icp_trim_fraction: float = 0.1
    icp_ring_closure: bool = True
    icp_closure_gate: float = 0.25
    icp_closure_gate_rot: float = 0.26
    icp_variant: str = "point_to_plane"
    # tiling knobs of the JAX package's XLA NN sweep; the port's NN kernel
    # has no such tiles, so these are carried only so configs round-trip
    icp_query_tile: int = 1024
    icp_ref_tile: int = 4096

    # kernel backend: 'auto' = hand-written CUDA kernels for CUDA tensors
    # and their plain PyTorch versions for CPU tensors; 'cuda' = kernels
    # only (a CPU tensor raises); 'torch' = plain versions everywhere (the
    # explicit reference mode)
    kernel_impl: str = "auto"

    def __post_init__(self):
        if self.num_cameras < 1:
            raise ValueError("num_cameras must be >= 1")
        if self.icp_variant not in ("point_to_point", "point_to_plane"):
            raise ValueError(f"unknown icp_variant {self.icp_variant!r}")
        if self.kernel_impl not in KERNEL_IMPLS:
            raise ValueError(f"unknown kernel_impl {self.kernel_impl!r}")
        if not (0.0 <= self.icp_trim_fraction < 1.0):
            raise ValueError("icp_trim_fraction must be in [0, 1)")
        for name in ("cam_capacity", "out_capacity", "icp_capacity"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be positive")
        if self.decimation < 1:
            raise ValueError("decimation must be >= 1")
        if self.decimation > 1 and (self.height % self.decimation
                                    or self.width % self.decimation):
            raise ValueError(
                f"decimation {self.decimation} must divide height "
                f"{self.height} and width {self.width}")
        if self.out_leaf_autofit and self.out_leaf_max < self.out_voxel_leaf:
            raise ValueError("out_leaf_max must be >= out_voxel_leaf")
        if self.with_normals and self.with_color:
            raise ValueError("with_normals and with_color are mutually "
                             "exclusive (both ride the cloud's rgb channel)")
        if (self.color_height is None) != (self.color_width is None):
            raise ValueError("set both color_height and color_width or neither")
        if self.color_height is not None and not self.with_color:
            raise ValueError("color_height/width require with_color=True")
        if (self.crop_lo is None) != (self.crop_hi is None):
            raise ValueError("set both crop_lo and crop_hi or neither")
        if self.crop_lo is not None:
            # JSON round-trips tuples as lists; keep the config hashable
            lo, hi = tuple(self.crop_lo), tuple(self.crop_hi)
            if len(lo) != 3 or len(hi) != 3:
                raise ValueError("crop_lo/crop_hi must have 3 components")
            if not all(a < b for a, b in zip(lo, hi)):
                raise ValueError("crop_lo must be < crop_hi per axis")
            object.__setattr__(self, "crop_lo", lo)
            object.__setattr__(self, "crop_hi", hi)

    @property
    def pixels_per_camera(self) -> int:
        return (self.height // self.decimation) * (self.width // self.decimation)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "StitchConfig":
        return cls(**json.loads(s))

    @classmethod
    def from_jax_json(cls, s: str) -> "StitchConfig":
        """Read the JAX package's ``StitchConfig.to_json()``: the Pallas
        backend maps to the CUDA kernels, the XLA backend to the plain
        PyTorch versions, and ``kernel_interpret`` is dropped."""
        d = json.loads(s)
        d.pop("kernel_interpret", None)
        d["kernel_impl"] = {"pallas": "cuda", "xla": "torch"}.get(
            d.get("kernel_impl", "auto"), d.get("kernel_impl", "auto"))
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "StitchConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
