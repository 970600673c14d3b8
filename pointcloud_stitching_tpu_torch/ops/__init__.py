from .change import detect_changes, detect_changes_map
from .deproject import (deproject, deproject_with_color,
                        deproject_with_color_mapped, map_color, project)
from .filters import bilateral_depth, crop_box
from .fuse import compact, fuse, fuse_batched
from .icp import (ICPResult, icp, icp_batched, icp_converge,
                  icp_point_to_plane_batched)
from .kabsch import kabsch
from .mesh import mesh_cloud_arrays, organized_mesh
from .nn import nearest_neighbors
from .normals import decode_normals, grid_normals
from .surface import (field_from_map, map_grid_bounds, marching_tetrahedra,
                      reconstruct_surface, soup_triangles, weld_mesh)
from .se3 import (mm, se3_apply, se3_blend, se3_compose, se3_from_rt,
                  se3_identity, se3_inverse, se3_power, so3_exp, so3_log,
                  transform_cloud)
from .voxel import decimate_depth, voxel_downsample

__all__ = [
    "ICPResult", "bilateral_depth", "compact", "crop_box", "decimate_depth",
    "decode_normals", "deproject", "deproject_with_color",
    "deproject_with_color_mapped", "detect_changes", "detect_changes_map",
    "field_from_map", "fuse", "fuse_batched", "grid_normals", "icp",
    "icp_batched", "icp_converge", "icp_point_to_plane_batched", "kabsch",
    "map_color", "map_grid_bounds", "marching_tetrahedra",
    "mesh_cloud_arrays", "mm", "nearest_neighbors", "organized_mesh",
    "project", "reconstruct_surface", "se3_apply", "se3_blend",
    "se3_compose", "se3_from_rt", "se3_identity", "se3_inverse", "se3_power",
    "so3_exp", "so3_log", "soup_triangles", "transform_cloud",
    "voxel_downsample", "weld_mesh",
]
