from .change import detect_changes, detect_changes_map
from .deproject import (deproject, deproject_with_color,
                        deproject_with_color_mapped, map_color, project)
from .filters import bilateral_depth, crop_box
from .fpfh import fpfh, match_fpfh
from .fuse import compact, fuse, fuse_batched
from .gicp import gicp, gicp_covariances
from .icp import (ICPResult, icp, icp_batched, icp_converge,
                  icp_point_to_plane_batched)
from .kabsch import kabsch
from .keypoints import iss_keypoints
from .mesh import mesh_cloud_arrays, organized_mesh
from .mls import estimate_curvature, estimate_normals, mls_smooth
from .ndt import NDTMap, ndt, ndt_align, ndt_build
from .nn import nearest_neighbors
from .normals import decode_normals, grid_normals
from .search import knn_search, radius_search
from .surface import (field_from_map, map_grid_bounds, marching_tetrahedra,
                      reconstruct_surface, soup_triangles, weld_mesh)
from .se3 import (mm, se3_apply, se3_blend, se3_compose, se3_from_rt,
                  se3_identity, se3_inverse, se3_power, so3_exp, so3_log,
                  transform_cloud)
from .vfh import vfh
from .voxel import decimate_depth, voxel_downsample

__all__ = [
    "ICPResult", "NDTMap", "bilateral_depth", "compact", "crop_box",
    "decimate_depth", "decode_normals", "deproject", "deproject_with_color",
    "deproject_with_color_mapped", "detect_changes", "detect_changes_map",
    "estimate_curvature", "estimate_normals", "field_from_map", "fpfh",
    "fuse", "fuse_batched", "gicp", "gicp_covariances", "grid_normals",
    "icp", "icp_batched", "icp_converge", "icp_point_to_plane_batched",
    "iss_keypoints", "kabsch", "knn_search", "map_color", "map_grid_bounds",
    "marching_tetrahedra", "match_fpfh", "mesh_cloud_arrays", "mls_smooth",
    "mm", "ndt", "ndt_align", "ndt_build", "nearest_neighbors",
    "organized_mesh", "project", "radius_search", "reconstruct_surface",
    "se3_apply", "se3_blend", "se3_compose", "se3_from_rt", "se3_identity",
    "se3_inverse", "se3_power", "so3_exp", "so3_log", "soup_triangles",
    "transform_cloud", "vfh", "voxel_downsample", "weld_mesh",
]
