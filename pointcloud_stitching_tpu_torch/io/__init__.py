"""Host-side file IO of the port: numpy-only copies of the reference's
``.cal``, intrinsics, PLY and PCD readers and writers, its orthographic
renderer and the correspondence picker's index maps."""
from .calio import (discover_cals, discover_intrinsics, load_cal, load_cals,
                    load_intrinsics, load_intrinsics_stack, save_cal,
                    save_intrinsics)
from .pcdio import load_pcd, save_pcd
from .picker import (pick_index, project_pixels, projection_bounds,
                     render_indexed, save_picks)
from .plyio import load_ply, save_cloud, save_mesh, save_ply
from .render import render_cloud, render_orthographic, save_image

__all__ = ["discover_cals", "discover_intrinsics", "load_cal", "load_cals",
           "load_intrinsics", "load_intrinsics_stack", "load_pcd",
           "load_ply", "pick_index", "project_pixels", "projection_bounds",
           "render_cloud", "render_indexed", "render_orthographic",
           "save_cal", "save_cloud", "save_image", "save_intrinsics",
           "save_mesh", "save_pcd", "save_picks", "save_ply"]
