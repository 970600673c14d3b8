from .registration import (RegistrationResult, register_from_correspondences,
                           register_global, register_pair, write_cal)
from .stitcher import (StitchingPipeline, StitchMetrics, StitchOutput,
                       autofit_out_leaf, stitch_points_step, stitch_step)
from .voxel_map import (TemporalAccumulator, VoxelMap, load_map, localize,
                        save_map, voxel_map_update)

__all__ = ["RegistrationResult", "StitchingPipeline", "StitchMetrics",
           "StitchOutput", "TemporalAccumulator", "VoxelMap",
           "autofit_out_leaf", "load_map", "localize",
           "register_from_correspondences", "register_global",
           "register_pair", "save_map", "stitch_points_step", "stitch_step",
           "voxel_map_update", "write_cal"]
