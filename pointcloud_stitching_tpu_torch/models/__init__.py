from .stitcher import (StitchingPipeline, StitchMetrics, StitchOutput,
                       autofit_out_leaf, stitch_points_step, stitch_step)

__all__ = ["StitchingPipeline", "StitchMetrics", "StitchOutput",
           "autofit_out_leaf", "stitch_points_step", "stitch_step"]
