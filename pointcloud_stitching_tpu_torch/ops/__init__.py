from .deproject import deproject, project
from .filters import crop_box
from .fuse import fuse, fuse_batched
from .icp import (ICPResult, icp, icp_batched, icp_converge,
                  icp_point_to_plane_batched)
from .kabsch import kabsch
from .nn import nearest_neighbors
from .normals import grid_normals
from .se3 import (mm, se3_apply, se3_blend, se3_compose, se3_from_rt,
                  se3_inverse, se3_power, so3_exp, so3_log, transform_cloud)
from .voxel import decimate_depth, voxel_downsample

__all__ = [
    "ICPResult", "crop_box", "decimate_depth", "deproject", "fuse",
    "fuse_batched", "grid_normals", "icp", "icp_batched", "icp_converge",
    "icp_point_to_plane_batched", "kabsch", "mm", "nearest_neighbors",
    "project", "se3_apply", "se3_blend", "se3_compose", "se3_from_rt",
    "se3_inverse", "se3_power", "so3_exp", "so3_log", "transform_cloud",
    "voxel_downsample",
]
