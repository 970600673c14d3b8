"""Ahead-of-time build: python -m pointcloud_stitching_tpu_torch.native.build"""
from . import build

if __name__ == "__main__":
    print(build())
