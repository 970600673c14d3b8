from .pose_graph import (PoseGraphResult, chain_initial_poses,
                         optimize_pose_graph, register_rig)
from .registration import (RegistrationResult, register_from_correspondences,
                           register_global, register_pair, write_cal)
from .stitcher import (StitchingPipeline, StitchMetrics, StitchOutput,
                       autofit_out_leaf, stitch_points_step, stitch_step)
from .voxel_map import (TemporalAccumulator, VoxelMap, load_map, localize,
                        save_map, voxel_map_update)

__all__ = ["PoseGraphResult", "RegistrationResult", "StitchingPipeline",
           "StitchMetrics", "StitchOutput", "TemporalAccumulator", "VoxelMap",
           "autofit_out_leaf", "chain_initial_poses", "load_map", "localize",
           "optimize_pose_graph", "register_from_correspondences",
           "register_global", "register_pair", "register_rig", "save_map",
           "stitch_points_step", "stitch_step", "voxel_map_update",
           "write_cal"]
