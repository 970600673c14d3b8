"""PyTorch / CUDA port of pointcloud_stitching_tpu for NVIDIA Hopper.

The JAX package ``pointcloud_stitching_tpu`` is the reference; this package
mirrors its module paths and public names. Plain tensor code is PyTorch,
and the Pallas kernels of the reference's stitch step are hand-written CUDA
kernels (``csrc/``), built for ``sm_90a`` at first use. Each kernel has a
plain PyTorch version that CPU tensors (and ``kernel_impl="torch"``) take.
The streaming runtime (``runtime/``) feeds the pipeline from camera servers
over TCP. This package never imports jax.
"""
from .models.stitcher import (StitchingPipeline, StitchMetrics, StitchOutput,
                              stitch_points_step, stitch_step)
from .runtime import (CameraIngest, Codec, FakeCameraServer, Kind,
                      MulticameraClient, decode_frame, encode_depth_frame,
                      encode_frame, pack_points_i16mm, recv_frame,
                      synthetic_frames, unpack_points_i16mm)
from .utils.config import StitchConfig
from .utils.types import DistortionModel, Intrinsics, PointCloud

__all__ = [
    "CameraIngest", "Codec", "DistortionModel", "FakeCameraServer",
    "Intrinsics", "Kind", "MulticameraClient", "PointCloud", "StitchConfig",
    "StitchingPipeline", "StitchMetrics", "StitchOutput", "decode_frame",
    "encode_depth_frame", "encode_frame", "pack_points_i16mm", "recv_frame",
    "stitch_points_step", "stitch_step", "synthetic_frames",
    "unpack_points_i16mm",
]
