"""Device selection and float32 settings for the port's tools.

Counterpart of ``pointcloud_stitching_tpu/utils/platform.py``: the tools
read ``PCS_PLATFORM`` to pick their device. ``cpu`` runs them on the CPU
(the kernels' plain versions); unset or ``cuda`` asks for a GPU (the first,
or ``LOCAL_RANK``'s where a launcher such as ``torchrun`` starts one process
per GPU), and a machine without one is an error, never a silent run on the
CPU.
"""
from __future__ import annotations

import os

import torch


def platform_device() -> torch.device:
    """The device that ``PCS_PLATFORM`` asks for (default: cuda:0, or
    cuda:LOCAL_RANK where several GPUs are visible)."""
    want = os.environ.get("PCS_PLATFORM", "").strip().lower() or "cuda"
    if want == "cpu":
        return torch.device("cpu")
    if want != "cuda":
        raise ValueError(f"PCS_PLATFORM={want!r}: want 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("PCS_PLATFORM asks for CUDA (the default) but "
                           "torch.cuda.is_available() is false; set "
                           "PCS_PLATFORM=cpu to run on the CPU")
    if torch.cuda.device_count() > 1:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cuda", 0)


def set_full_fp32_matmul() -> None:
    """Full float32 for every matmul and convolution: TF32 would round
    rotation entries at about 1e-3 (the twin of the TPU's bf16 pass that
    the JAX package avoids with precision='highest')."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
