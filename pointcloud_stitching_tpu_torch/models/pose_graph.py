"""Multi-way extrinsic refinement: pose-graph optimization on SE(3).

Port of ``pointcloud_stitching_tpu/models/pose_graph.py``. Given pairwise
rigid measurements over the camera graph, it solves for the most
consistent world poses,

    minimize over {T_i}   sum_e  w_e * || r_e ||^2
    r_e = pseudo-log( (T_i @ T_e_meas)^-1 @ T_j )      for edge e = (i, j)

where ``T_e_meas`` maps camera j's frame into camera i's (what
``register_pair(src=cloud_j, dst=cloud_i)`` or a pairwise .cal file holds).
The pseudo-log is the [translation, rotation-vector] chart of the ICP
updates, used for the residual and as the retraction.

Dense Gauss-Newton: the Jacobian is ``torch.func.jacrev`` of the stacked
residual at the linearisation point, and the normal equations are one
[6N, 6N] solve (``solve_ex``: no wait for the device's status). The anchor's
6 columns are zeroed and its diagonal block set to identity, so its update
is exactly 0; columns no edge reaches (disconnected nodes) get the same
fix. The state is tiny (6 x cameras), so the solve runs in float64 and
rounds the poses to float32 at the end: its matmuls never take TF32,
whatever the process-wide switch says.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..ops.se3 import mm, se3_from_rt, se3_inverse, so3_exp


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor            # [N, 4, 4] refined world-from-camera
    residual_before: torch.Tensor  # [E] pseudo-log norms at the initial poses
    residual_after: torch.Tensor   # [E] pseudo-log norms at the solution
    iterations: torch.Tensor       # scalar int32: GN iterations executed


def _so3_log_diff(R: torch.Tensor) -> torch.Tensor:
    """SO(3) log with a finite derivative at theta = 0 (``ops.se3.so3_log``'s
    arccos has none there, and GN linearises exactly there)."""
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)  # 2 sin(theta) axis
    s2 = (w * w).sum(dim=-1, keepdim=True)                   # 4 sin^2(theta)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace[..., None] - 1.0) * 0.5, -1.0, 1.0)
    small = s2 < 1e-12
    sin = 0.5 * torch.sqrt(torch.where(small, 1.0, s2))
    # scale = theta / (2 sin theta); Taylor 1/2 + theta^2/12 with
    # theta^2 ~= 2 (1 - cos) near zero
    scale = torch.where(small, 0.5 + (1.0 - cos) / 6.0,
                        torch.atan2(sin, cos) / (2.0 * sin))
    return w * scale


def _pseudo_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] = [t(3), omega(3)] -> [..., 4, 4] (SO(3) x R^3 chart)."""
    return se3_from_rt(so3_exp(xi[..., 3:]), xi[..., :3])


def _pseudo_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6]; inverse of _pseudo_exp on its image."""
    return torch.cat([T[..., :3, 3], _so3_log_diff(T[..., :3, :3])], dim=-1)


def _edge_residuals(poses, xi, src, dst, meas_inv):
    """Stacked [E, 6] residuals of the perturbed poses T_k @ exp(xi_k);
    src/dst are the edges' (i, j) node ids, meas_inv[e] = T_e_meas^-1."""
    perturbed = mm(poses, _pseudo_exp(xi))
    err = mm(mm(meas_inv, se3_inverse(perturbed[src])), perturbed[dst])
    return _pseudo_log(err)


def optimize_pose_graph(T_init: torch.Tensor, edges: torch.Tensor,
                        T_meas: torch.Tensor,
                        weights: torch.Tensor | None = None,
                        iterations: int = 10, damping: float = 1e-9,
                        anchor: int = 0) -> PoseGraphResult:
    """Jointly refine world poses against pairwise measurements.

    Args:
      T_init: [N, 4, 4] initial world-from-camera poses (chained pairwise
        .cal files, or the rig's current extrinsics); sets the device.
      edges: [E, 2] (i, j) node indices; T_meas[e] maps camera
        edges[e, 1]'s frame into camera edges[e, 0]'s.
      T_meas: [E, 4, 4] pairwise rigid measurements.
      weights: optional [E] per-edge confidences (e.g. ICP inlier counts);
        residuals scale by sqrt(w).
      iterations: Gauss-Newton iterations.
      damping: Levenberg diagonal added to the normal equations.
      anchor: node whose pose stays exactly T_init[anchor].

    Returns PoseGraphResult; disconnected nodes keep their initial pose.
    """
    dev = T_init.device
    f64 = dict(dtype=torch.float64, device=dev)
    poses = T_init.to(**f64)
    n = poses.shape[0]
    edges = edges.to(device=dev, dtype=torch.int64)
    src, dst = edges[:, 0], edges[:, 1]
    meas_inv = se3_inverse(T_meas.to(**f64))
    e = edges.shape[0]
    sqw = (torch.ones((e,), **f64) if weights is None
           else torch.sqrt(weights.to(**f64)))
    # zero the anchor's 6 Jacobian columns; identity on its diagonal block
    # makes the solve well-posed with delta_anchor == 0
    free = (torch.arange(n, device=dev) != anchor).to(torch.float64)
    z = torch.zeros((n, 6), **f64)

    def residual_norms(p):
        return torch.linalg.vector_norm(
            _edge_residuals(p, z, src, dst, meas_inv), dim=-1).to(
                torch.float32)

    before = residual_norms(poses)
    for _ in range(iterations):
        p0 = poses
        r = _edge_residuals(p0, z, src, dst, meas_inv)         # [E, 6]
        jac = torch.func.jacrev(
            lambda xi: _edge_residuals(p0, xi, src, dst, meas_inv))(z)
        jac = jac * sqw[:, None, None, None] * free[None, None, :, None]
        r = r * sqw[:, None]
        jf = jac.reshape(e * 6, n * 6)
        jtj = jf.T @ jf
        # exact-zero update for the anchor AND for columns no edge reaches:
        # unit diagonal + zero rhs (damping alone leaves a ~1e-9 pivot)
        dead = (jf.abs().sum(dim=0) == 0.0).to(torch.float64)
        diag_fix = torch.maximum((1.0 - free).repeat_interleave(6), dead) \
            + damping
        jtj = jtj + torch.diag(diag_fix)
        rhs = -(jf.T @ r.reshape(-1))
        delta = torch.linalg.solve_ex(jtj, rhs[:, None]).result.reshape(n, 6)
        poses = mm(p0, _pseudo_exp(delta * free[:, None]))
    after = residual_norms(poses)
    return PoseGraphResult(poses=poses.to(torch.float32),
                           residual_before=before, residual_after=after,
                           iterations=torch.full((), iterations,
                                                 dtype=torch.int32,
                                                 device=dev))


def register_rig(clouds, edges: torch.Tensor, T_init: torch.Tensor,
                 icp_iterations: int = 20, gn_iterations: int = 10,
                 max_corr_dist: float = 0.25, trim_fraction: float = 0.0,
                 query_tile: int = 1024, ref_tile: int = 4096,
                 nn_impl: str = "auto", anchor: int = 0) -> PoseGraphResult:
    """Multiway registration: pairwise ICP on every graph edge, then the
    joint pose-graph solve.

    All edges run as one batched ICP (``ops.icp.icp_batched``: one K3
    launch per iteration over every pair); each aligned pose becomes the
    edge measurement T_i^-1 @ delta @ T_j, weighted by its inlier count.

    Args:
      clouds: camera-batched sensor-frame PointCloud ([N, C, 3] + mask).
      edges: [E, 2] (i, j) pairs expected to overlap; the clouds must be
        roughly pre-aligned by T_init (ICP basin, a few cm).
      T_init: [N, 4, 4] initial world-from-camera poses.
      query_tile, ref_tile: taken and ignored (see ``ops.icp``).

    Returns the PoseGraphResult of the joint solve (anchor fixed).
    """
    from ..ops.icp import icp_batched
    from ..ops.se3 import se3_apply
    from ..utils.types import PointCloud

    dev = clouds.xyz.device
    edges = edges.to(device=dev, dtype=torch.int64)
    T_init = T_init.to(device=dev, dtype=torch.float32)
    world_xyz = se3_apply(T_init, clouds.xyz)            # [N, C, 3]
    si, di = edges[:, 1], edges[:, 0]
    src = PointCloud(xyz=world_xyz[si], mask=clouds.mask[si])
    dst = PointCloud(xyz=world_xyz[di], mask=clouds.mask[di])
    res = icp_batched(src, dst, iterations=icp_iterations,
                      max_corr_dist=max_corr_dist, nn_impl=nn_impl,
                      trim_fraction=trim_fraction)
    # res.T[e] aligns camera j's world-frame cloud onto camera i's, so the
    # measured world pose of j is res.T[e] @ T_init[j]; in i's frame:
    meas = mm(se3_inverse(T_init[di]), mm(res.T, T_init[si]))
    weights = torch.clamp(res.num_inliers.to(torch.float32), min=1.0)
    return optimize_pose_graph(T_init, edges, meas, weights=weights,
                               iterations=gn_iterations, anchor=anchor)


def chain_initial_poses(num_nodes: int, edges: Sequence[Sequence[int]],
                        T_meas, anchor: int = 0) -> torch.Tensor:
    """Spanning-tree initialisation: a breadth-first chain of measurements
    from ``anchor``, composing T_parent @ T_meas (or its inverse against
    the edge direction). Unreached nodes get identity. A host-side helper;
    the result is on T_meas's device (the CPU for a numpy array)."""
    dev = T_meas.device if torch.is_tensor(T_meas) else torch.device("cpu")
    if torch.is_tensor(T_meas):
        T_meas = T_meas.cpu().numpy()
    T_meas = np.asarray(T_meas, np.float32)
    poses = [None] * num_nodes
    poses[anchor] = np.eye(4, dtype=np.float32)
    adj: list[list[tuple[int, int, bool]]] = [[] for _ in range(num_nodes)]
    for k, (i, j) in enumerate(edges):
        adj[int(i)].append((int(j), k, False))   # forward: T_j = T_i @ M
        adj[int(j)].append((int(i), k, True))    # reverse: T_i = T_j @ M^-1
    queue = [anchor]
    while queue:
        i = queue.pop(0)
        for j, k, rev in adj[i]:
            if poses[j] is not None:
                continue
            m = np.linalg.inv(T_meas[k]) if rev else T_meas[k]
            poses[j] = poses[i] @ m
            queue.append(j)
    for i in range(num_nodes):
        if poses[i] is None:
            poses[i] = np.eye(4, dtype=np.float32)
    return torch.from_numpy(np.stack(poses).astype(np.float32)).to(dev)
