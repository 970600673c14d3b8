"""Host-side file IO of the port: numpy-only copies of the reference's
``.cal``, intrinsics, PLY and PCD readers and writers."""
from .calio import (discover_cals, discover_intrinsics, load_cal, load_cals,
                    load_intrinsics, load_intrinsics_stack, save_cal,
                    save_intrinsics)
from .pcdio import load_pcd, save_pcd
from .plyio import load_ply, save_cloud, save_mesh, save_ply

__all__ = ["discover_cals", "discover_intrinsics", "load_cal", "load_cals",
           "load_intrinsics", "load_intrinsics_stack", "save_cal",
           "save_intrinsics", "load_ply", "save_cloud", "save_mesh", "save_ply",
           "load_pcd", "save_pcd"]
