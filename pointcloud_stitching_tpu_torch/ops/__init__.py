from .change import detect_changes, detect_changes_map
from .cluster import (cluster_stats, euclidean_clusters,
                      euclidean_clusters_exact, oriented_bboxes,
                      region_growing)
from .deproject import (deproject, deproject_with_color,
                        deproject_with_color_mapped, map_color, project)
from .filters import (bilateral_depth, count_neighbors, crop_box,
                      frustum_cull, knn_mean_distance, passthrough,
                      radius_outlier_removal, statistical_outlier_removal)
from .fpfh import fpfh, match_fpfh
from .fuse import compact, fuse, fuse_batched
from .gicp import gicp, gicp_covariances
from .hull import (ConcaveHullResult, ConvexHullResult, concave_hull,
                   convex_hull, crop_hull)
from .icp import (ICPResult, icp, icp_batched, icp_converge,
                  icp_point_to_plane_batched)
from .kabsch import kabsch
from .keypoints import iss_keypoints
from .mesh import mesh_cloud_arrays, organized_mesh
from .mls import estimate_curvature, estimate_normals, mls_smooth
from .ndt import NDTMap, ndt, ndt_align, ndt_build
from .nn import nearest_neighbors
from .normals import decode_normals, grid_normals
from .sac import extract_plane, project_plane, segment_plane
from .search import knn_search, radius_search
from .surface import (field_from_map, map_grid_bounds, marching_tetrahedra,
                      reconstruct_surface, soup_triangles, weld_mesh)
from .se3 import (mm, se3_apply, se3_blend, se3_compose, se3_from_rt,
                  se3_identity, se3_inverse, se3_power, so3_exp, so3_log,
                  transform_cloud)
from .vfh import vfh
from .voxel import decimate_depth, voxel_downsample, voxel_indices

__all__ = [
    "ConcaveHullResult", "ConvexHullResult", "ICPResult", "NDTMap",
    "bilateral_depth", "cluster_stats", "compact", "concave_hull",
    "convex_hull", "count_neighbors", "crop_box", "crop_hull",
    "decimate_depth", "decode_normals", "deproject", "deproject_with_color",
    "deproject_with_color_mapped", "detect_changes", "detect_changes_map",
    "estimate_curvature", "estimate_normals", "euclidean_clusters",
    "euclidean_clusters_exact", "extract_plane", "field_from_map", "fpfh",
    "frustum_cull", "fuse", "fuse_batched", "gicp", "gicp_covariances",
    "grid_normals", "icp", "icp_batched", "icp_converge",
    "icp_point_to_plane_batched", "iss_keypoints", "kabsch",
    "knn_mean_distance", "knn_search", "map_color", "map_grid_bounds",
    "marching_tetrahedra", "match_fpfh", "mesh_cloud_arrays", "mls_smooth",
    "mm", "ndt", "ndt_align", "ndt_build", "nearest_neighbors",
    "organized_mesh", "oriented_bboxes", "passthrough", "project",
    "project_plane", "radius_outlier_removal", "radius_search",
    "reconstruct_surface", "region_growing", "se3_apply", "se3_blend",
    "se3_compose", "se3_from_rt", "se3_identity", "se3_inverse", "se3_power",
    "segment_plane", "so3_exp", "so3_log", "soup_triangles",
    "statistical_outlier_removal", "transform_cloud", "vfh",
    "voxel_downsample", "voxel_indices", "weld_mesh",
]
