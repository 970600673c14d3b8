#!/usr/bin/env python
"""Shim: the PyTorch port's register tool lives in
pointcloud_stitching_tpu_torch.tools (register_cli); this path gives it the
`python registration/register_cli_torch.py` invocation from a checkout, beside
the JAX package's registration/register_cli.py. It runs on the GPU, or on the
CPU under PCS_PLATFORM=cpu."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pointcloud_stitching_tpu_torch.tools.register_cli import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())
