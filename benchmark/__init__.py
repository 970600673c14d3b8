"""The benchmark of pointcloud_stitching_tpu_torch (see README.md)."""
