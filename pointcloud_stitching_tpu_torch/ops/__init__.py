from .deproject import (deproject, deproject_with_color,
                        deproject_with_color_mapped, map_color, project)
from .filters import crop_box
from .fuse import compact, fuse, fuse_batched
from .icp import (ICPResult, icp, icp_batched, icp_converge,
                  icp_point_to_plane_batched)
from .kabsch import kabsch
from .nn import nearest_neighbors
from .normals import decode_normals, grid_normals
from .se3 import (mm, se3_apply, se3_blend, se3_compose, se3_from_rt,
                  se3_identity, se3_inverse, se3_power, so3_exp, so3_log,
                  transform_cloud)
from .voxel import decimate_depth, voxel_downsample

__all__ = [
    "ICPResult", "compact", "crop_box", "decimate_depth", "decode_normals",
    "deproject", "deproject_with_color", "deproject_with_color_mapped",
    "fuse", "fuse_batched", "grid_normals", "icp", "icp_batched",
    "icp_converge", "icp_point_to_plane_batched", "kabsch", "map_color", "mm",
    "nearest_neighbors", "project", "se3_apply", "se3_blend", "se3_compose",
    "se3_from_rt", "se3_identity", "se3_inverse", "se3_power", "so3_exp",
    "so3_log", "transform_cloud", "voxel_downsample",
]
