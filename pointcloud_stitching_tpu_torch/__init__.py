"""PyTorch / CUDA port of pointcloud_stitching_tpu for NVIDIA Hopper.

The JAX package ``pointcloud_stitching_tpu`` is the reference; this package
mirrors its module paths and public names. Plain tensor code is PyTorch,
and the Pallas kernels of the reference's stitch step are hand-written CUDA
kernels (``csrc/``), built for ``sm_90a`` at first use. Each kernel has a
plain PyTorch version that CPU tensors (and ``kernel_impl="torch"``) take.
This package never imports jax.
"""
from .models.stitcher import (StitchingPipeline, StitchMetrics, StitchOutput,
                              stitch_points_step, stitch_step)
from .utils.config import StitchConfig
from .utils.types import DistortionModel, Intrinsics, PointCloud

__all__ = [
    "DistortionModel", "Intrinsics", "PointCloud", "StitchConfig",
    "StitchingPipeline", "StitchMetrics", "StitchOutput", "stitch_step",
    "stitch_points_step",
]
