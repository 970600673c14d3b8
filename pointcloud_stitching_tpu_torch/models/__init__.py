from .pose_graph import (PoseGraphResult, chain_initial_poses,
                         optimize_pose_graph, register_rig)
from .registration import (RegistrationResult, register_from_correspondences,
                           register_global, register_pair, write_cal)
from .stitcher import (StitchingPipeline, StitchMetrics, StitchOutput,
                       autofit_out_leaf, stitch_points_step, stitch_step)
from .tsdf import (RaycastResult, RigTrackResult, TrackResult, TSDFVolume,
                   extract_cloud, extract_mesh, integrate, load_volume,
                   raycast, rig_track, save_volume, track)
from .voxel_map import (TemporalAccumulator, VoxelMap, load_map, localize,
                        save_map, voxel_map_update)

__all__ = ["PoseGraphResult", "RaycastResult", "RegistrationResult",
           "RigTrackResult", "StitchingPipeline", "StitchMetrics",
           "StitchOutput", "TSDFVolume", "TemporalAccumulator",
           "TrackResult", "VoxelMap", "autofit_out_leaf",
           "chain_initial_poses", "extract_cloud", "extract_mesh",
           "integrate", "load_map", "load_volume", "localize",
           "optimize_pose_graph", "raycast", "register_from_correspondences",
           "register_global", "register_pair", "register_rig", "rig_track",
           "save_map", "save_volume", "stitch_points_step", "stitch_step",
           "track", "voxel_map_update", "write_cal"]
