from .registration import (RegistrationResult, register_from_correspondences,
                           register_global, register_pair, write_cal)
from .stitcher import (StitchingPipeline, StitchMetrics, StitchOutput,
                       autofit_out_leaf, stitch_points_step, stitch_step)

__all__ = ["RegistrationResult", "StitchingPipeline", "StitchMetrics",
           "StitchOutput", "autofit_out_leaf", "register_from_correspondences",
           "register_global", "register_pair", "stitch_points_step",
           "stitch_step", "write_cal"]
