"""The plain reference of the stitch: what one frame of depth images and a
calibration must give, written from the published math in plain PyTorch.

It imports nothing of the program and takes nothing the program made: the
frames and the calibration are the benchmark's. Past deprojection it
computes in float64 by default (``dtype``), on any device, one camera or
one camera pair at a time:

* deprojection (librealsense ``rs2_deproject_pixel_to_point``, no
  distortion): ``x = (u - ppx) / fx * z``, valid where z_min < z <= z_max,
  in float32 as the configuration states points (so every voxel index
  below is PCL's float32 floor(p * (1 / leaf)) of the same points);
* the ICP clouds: the stride-``icp_stride`` pixel grid, grid normals from
  forward differences (the last row and column have none), and a voxel grid
  (``pcl::VoxelGrid`` centroids, ordered by (ix, iy, iz) from the cloud's
  minimum, the first ``icp_capacity`` kept) that averages the normals too;
* ring point-to-plane ICP (Chen and Medioni): camera i against camera i-1
  in the world frame, ``icp_iterations`` rounds of nearest neighbours
  (first index on ties), rejection beyond ``icp_max_corr_dist``, trimming
  of the worst ``icp_trim_fraction`` (lower quantile), and the linearised
  6x6 solve with a 1e-8 Tikhonov floor, kept only with more than 5
  inliers;
* the ring's composition: camera 0 anchors, camera k takes the product of
  the pair corrections 1..k, and the loop residual is spread along the ring
  as r^(-k/n) when it passes the closure gates;
* the fused cloud: every valid pixel of every camera moved into the world,
  cropped to [crop_lo, crop_hi], through a voxel grid of ``out_voxel_leaf``;
* with colour, each point's colour (librealsense ``rs2::pointcloud::map_to``
  for a colour stream of its own: the point moved by the depth-to-colour
  extrinsic, projected with the colour intrinsics, the nearest pixel, zero
  outside the colour frame; the point's own pixel for depth-aligned
  colour), averaged over each voxel's points beside the centroid.

Matrix products go through ``torch.matmul``, so a float32 ``dtype`` with
TF32 allowed computes them at TF32: the control of ``check.py``.
"""
from __future__ import annotations

import math

import torch


def deproject(depth: torch.Tensor, fx, fy, ppx, ppy, scale, z_min, z_max):
    """[h, w] raw depth -> (xyz [h, w, 3] float32, valid [h, w]), in the
    float32 the configuration states for points, each product rounded as
    written."""
    h, w = depth.shape
    dev = depth.device
    f32 = torch.float32
    z = depth.to(f32) * torch.tensor(scale, dtype=f32)
    u = torch.arange(w, dtype=f32, device=dev)[None, :]
    v = torch.arange(h, dtype=f32, device=dev)[:, None]
    x = (u - torch.tensor(ppx, dtype=f32)) / torch.tensor(fx, dtype=f32)
    y = (v - torch.tensor(ppy, dtype=f32)) / torch.tensor(fy, dtype=f32)
    xyz = torch.stack([x * z, y * z, z.expand(h, w)], -1)
    valid = (z > torch.tensor(z_min, dtype=f32)) & \
        (z <= torch.tensor(z_max, dtype=f32))
    return torch.where(valid[..., None], xyz, 0.0), valid


def grid_normals(xyz: torch.Tensor, valid: torch.Tensor):
    """Normals of an organised grid [h, w, 3]: cross(down - p, right - p),
    unit length, turned towards the sensor; valid where the pixel and its
    right and lower neighbours are (never in the last row or column)."""
    h, w = valid.shape
    right = torch.zeros_like(xyz)
    down = torch.zeros_like(xyz)
    right[:, :-1] = xyz[:, 1:]
    down[:-1] = xyz[1:]
    ok = torch.zeros_like(valid)
    ok[:-1, :-1] = valid[:-1, :-1] & valid[:-1, 1:] & valid[1:, :-1]
    n = torch.linalg.cross(down - xyz, right - xyz, dim=-1)
    norm = n.norm(dim=-1)
    ok = ok & (norm > 1e-12)
    n = n / torch.clamp(norm, min=1e-300)[..., None]
    n = torch.where(((n * xyz).sum(-1) > 0)[..., None], -n, n)
    return torch.where(ok[..., None], n, 0.0), ok


def voxel_grid(p: torch.Tensor, extra: torch.Tensor | None, leaf: float,
               capacity: int, dtype=torch.float64):
    """pcl::VoxelGrid of the points ``p`` [N, 3]: centroids [U, 3] (and the
    mean of ``extra`` [N, k]) in ``dtype`` of the occupied voxels in (ix,
    iy, iz) order from the cloud's minimum, the first ``capacity`` of them.
    A point's voxel is floor(p * (1 / leaf)) in ``p``'s own precision, the
    reciprocal multiplied as PCL does."""
    if p.shape[0] == 0:
        k = 3 if extra is None else 3 + extra.shape[1]
        z = p.new_zeros((0, k), dtype=dtype)
        return z[:, :3], None if extra is None else z[:, 3:]
    inv = 1.0 / torch.tensor(leaf, dtype=p.dtype, device=p.device)
    ijk = torch.floor(p * inv).to(torch.int64)
    ijk = ijk - ijk.min(0).values
    ext = ijk.max(0).values + 1
    key = (ijk[:, 0] * ext[1] + ijk[:, 1]) * ext[2] + ijk[:, 2]
    uniq, inv_idx = torch.unique(key, return_inverse=True)
    vals = p.to(dtype) if extra is None else torch.cat(
        [p.to(dtype), extra.to(dtype)], 1)
    sums = torch.zeros((len(uniq), vals.shape[1]), dtype=dtype,
                       device=p.device).index_add_(0, inv_idx, vals)
    cnt = torch.bincount(inv_idx, minlength=len(uniq)).to(dtype)
    mean = (sums / cnt[:, None])[:capacity]
    return mean[:, :3], None if extra is None else mean[:, 3:]


def icp_cloud(xyz, valid, cfg: dict, dtype=torch.float64):
    """One camera's ICP cloud from its float32 points: (points [cap, 3],
    normals [cap, 3], mask [cap]) in the sensor frame, padded to
    ``icp_capacity``, in ``dtype``."""
    s = cfg["icp_stride"]
    sub, ok = xyz[::s, ::s], valid[::s, ::s]
    n, nok = grid_normals(sub.to(dtype), ok)
    ok = ok & nok
    pts, nrm = voxel_grid(sub[ok], n[ok], cfg["icp_voxel_leaf"],
                          cfg["icp_capacity"], dtype)
    cap = cfg["icp_capacity"]
    out_p = pts.new_zeros((cap, 3))
    out_n = pts.new_zeros((cap, 3))
    mask = torch.zeros(cap, dtype=torch.bool, device=xyz.device)
    out_p[:len(pts)], out_n[:len(pts)], mask[:len(pts)] = pts, nrm, True
    return out_p, out_n, mask


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x -> R x + t for points [N, 3]."""
    return torch.matmul(p, T[:3, :3].transpose(0, 1)) + T[:3, 3]


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of the rotation vector ``w`` [3]."""
    th2 = (w * w).sum()
    K = torch.zeros((3, 3), dtype=w.dtype, device=w.device)
    K[0, 1], K[0, 2], K[1, 0] = -w[2], w[1], w[2]
    K[1, 2], K[2, 0], K[2, 1] = -w[0], -w[1], w[0]
    if float(th2) < 1e-12:
        a, b = 1.0 - th2 / 6.0, 0.5 - th2 / 24.0
    else:
        th = torch.sqrt(th2)
        a, b = torch.sin(th) / th, (1.0 - torch.cos(th)) / th2
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * K \
        + b * torch.matmul(K, K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector of a rotation matrix away from a half turn."""
    cos = torch.clamp((R[0, 0] + R[1, 1] + R[2, 2] - 1.0) * 0.5, -1.0, 1.0)
    th = torch.arccos(cos)
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]])
    scale = 0.5 if float(th) < 1e-6 else th / (2.0 * torch.sin(th))
    return w * scale


def se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3], T[:3, 3] = R, t
    return T


def point_to_plane(src, src_mask, dst, dst_n, dst_mask, cfg: dict):
    """Point-to-plane ICP of one pair (src onto dst, both world frame):
    the 4x4 correction, starting from the identity."""
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    max_d2 = cfg["icp_max_corr_dist"] ** 2
    trim = cfg["icp_trim_fraction"]
    far = torch.where(dst_mask[:, None], dst, 1e12)
    for _ in range(cfg["icp_iterations"]):
        p = apply(T, src)
        d2 = ((p[:, None, :] - far[None, :, :]) ** 2).sum(-1)
        idx = torch.argmin(d2, dim=1)
        d2 = d2.gather(1, idx[:, None])[:, 0]
        q, n = dst[idx], dst_n[idx]
        w = src_mask & (d2 <= max_d2) & ((n * n).sum(-1) > 0.25)
        if trim > 0 and bool(w.any()):
            acc = torch.sort(d2[w]).values
            k = int(math.floor((1.0 - trim) * (len(acc) - 1)))
            w = w & (d2 <= acc[k])
        wf = w.to(src.dtype)
        r0 = ((p - q) * n).sum(-1)
        J = torch.cat([torch.linalg.cross(p, n, dim=-1), n], -1)
        A = torch.matmul((wf[:, None] * J).transpose(0, 1), J) \
            + 1e-8 * torch.eye(6, dtype=src.dtype, device=src.device)
        rhs = -torch.matmul(J.transpose(0, 1), wf * r0)
        x = torch.linalg.solve(A, rhs)
        if float(wf.sum()) <= 5.0:
            x = torch.zeros_like(x)
        T = torch.matmul(se3(so3_exp(x[:3]), x[3:]), T)
    return T


def se3_power(T: torch.Tensor, alpha: float) -> torch.Tensor:
    """T^alpha of a near-identity rigid transform (rotation by its log,
    translation scaled)."""
    return se3(so3_exp(alpha * so3_log(T[:3, :3])), alpha * T[:3, 3])


def ring_icp(clouds, calib: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Refined extrinsics [C, 4, 4] from the per-camera ICP clouds
    [(points, normals, mask)] and the calibration ``calib``."""
    n = len(clouds)
    closure = cfg["icp_ring_closure"] and n >= 3
    world = [apply(calib[c], clouds[c][0]) for c in range(n)]
    normals = []
    for c in range(n):
        nr = clouds[c][1]
        norm = nr.norm(dim=-1, keepdim=True)
        unit = torch.where(norm > 0.5, nr / torch.clamp(norm, min=1e-300),
                           0.0)
        normals.append(torch.matmul(unit, calib[c, :3, :3].transpose(0, 1)))
    eye = torch.eye(4, dtype=calib.dtype, device=calib.device)
    pairs = range(n) if closure else range(1, n)
    deltas = [eye] * n
    for i in pairs:
        j = (i - 1) % n
        deltas[i] = point_to_plane(world[i], clouds[i][2], world[j],
                                   normals[j], clouds[j][2], cfg)
    prefix = [eye]
    for k in range(1, n):
        prefix.append(torch.matmul(prefix[-1], deltas[k]))
    corr = prefix
    if closure:
        r = torch.matmul(prefix[-1], deltas[0])
        cos = (r[0, 0] + r[1, 1] + r[2, 2] - 1.0) * 0.5
        gate_rot = cfg["icp_closure_gate_rot"]
        ok = (float((r[:3, 3] ** 2).sum()) <= cfg["icp_closure_gate"] ** 2
              and (gate_rot >= math.pi or float(cos) >= math.cos(gate_rot)))
        if ok:
            corr = [torch.matmul(se3_power(r, -k / n), prefix[k])
                    for k in range(n)]
    return torch.stack([torch.matmul(corr[k], calib[k]) for k in range(n)])


def map_color(xyz: torch.Tensor, valid: torch.Tensor, image: torch.Tensor,
              color: dict, dtype=torch.float64) -> torch.Tensor:
    """Each point's colour [h, w, 3] in ``dtype`` from one camera's float32
    points ``xyz`` [h, w, 3] (``valid`` [h, w]) and its colour frame
    ``image`` [hc, wc, 3] uint8. Depth-aligned colour (``color['aligned']``)
    is the point's own pixel. Else the point is moved by the
    depth-to-colour extrinsic ``color['ext']`` and projected with the
    colour intrinsics, u = x / z * fx + ppx, and takes the nearest pixel
    (rounded half to even); a point behind the sensor (z <= 1e-9) or
    outside the frame keeps its geometry and gets zero colour, as does an
    invalid one."""
    if color["aligned"]:
        return torch.where(valid[..., None], image.to(dtype), 0.0)
    hc, wc = image.shape[:2]
    p = apply(color["ext"].to(dtype=dtype, device=xyz.device), xyz.to(dtype))
    front = p[..., 2] > 1e-9
    z = torch.where(front, p[..., 2], 1.0)
    u = torch.round(p[..., 0] / z * color["fx"] + color["ppx"])
    v = torch.round(p[..., 1] / z * color["fy"] + color["ppy"])
    inside = valid & front & (u >= 0) & (u < wc) & (v >= 0) & (v < hc)
    idx = (torch.clamp(v, 0, hc - 1) * wc
           + torch.clamp(u, 0, wc - 1)).to(torch.int64)
    rgb = image.reshape(hc * wc, 3)[idx].to(dtype)
    return torch.where(inside[..., None], rgb, 0.0)


def fused_points(points, ext: torch.Tensor, cfg: dict, colors=None):
    """Every camera's valid points [(xyz [P, 3])] moved by ``ext`` [C, 4,
    4] into the world and cropped to [crop_lo, crop_hi]: [N, 3]; with
    each camera's point colours ``colors`` [(rgb [P, 3])], also theirs
    [N, 3]."""
    world = torch.cat([apply(ext[c], p.to(ext.dtype))
                       for c, p in enumerate(points)])
    lo = torch.tensor(cfg["crop_lo"], dtype=world.dtype, device=world.device)
    hi = torch.tensor(cfg["crop_hi"], dtype=world.dtype, device=world.device)
    keep = ((world >= lo) & (world <= hi)).all(-1)
    if colors is None:
        return world[keep]
    return world[keep], torch.cat(colors)[keep]


def fused_cloud(points, ext: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Centroids [U, 3] of the fused, cropped cloud of ``fused_points``."""
    return voxel_grid(fused_points(points, ext, cfg), None,
                      cfg["out_voxel_leaf"], cfg["out_capacity"],
                      ext.dtype)[0]


def _points(depths: torch.Tensor, intr: dict, cfg: dict):
    """Each camera's (xyz [h, w, 3], valid [h, w]) of a frame set."""
    return [deproject(d, intr["fx"], intr["fy"], intr["ppx"], intr["ppy"],
                      cfg["depth_scale"], max(cfg["z_min"], 0.0),
                      cfg["z_max"]) for d in depths]


def work(depths: torch.Tensor, ext: torch.Tensor, intr: dict,
         cfg: dict) -> dict:
    """What one frame set gives the stitch to do, counted from its own
    data and the extrinsics ``ext`` it was fused with: ``rows``, the valid
    pixels that land in the crop box (the global voxel pass's input that
    reaches the output); ``voxels``, the output voxels they occupy; and
    ``icp_points``, each camera's ICP cloud size (with ICP on)."""
    cams = _points(depths, intr, cfg)
    world = fused_points([xyz[v] for xyz, v in cams], ext.double(), cfg)
    leaf = torch.tensor(cfg["out_voxel_leaf"], dtype=world.dtype,
                        device=world.device)
    keys = torch.unique(torch.floor(world * (1.0 / leaf)).to(torch.int64),
                        dim=0)
    out = {"rows": len(world), "voxels": len(keys)}
    if cfg["icp_enabled"]:
        out["icp_points"] = [int(icp_cloud(xyz, v, cfg)[2].sum())
                             for xyz, v in cams]
    return out


def stitch(depths: torch.Tensor, calib: torch.Tensor, intr: dict, cfg: dict,
           dtype=torch.float64, cloud_ext: torch.Tensor | None = None,
           colors: torch.Tensor | None = None, color: dict | None = None):
    """The reference's stitch of one frame set.

    depths: [C, h, w] raw depth; calib: [C, 4, 4] calibrated poses; intr:
    fx, fy, ppx, ppy; cfg: the StitchConfig fields; with colour, the
    colour frames ``colors`` [C, hc, wc, 3] uint8 of the sensor ``color``
    (see ``map_color``). The fused cloud is built with ``cloud_ext`` where
    given (the extrinsics under judgement), else with the reference's own.
    Returns (extrinsics [C, 4, 4], centroids [U, 3]), both in ``dtype``,
    each camera's number of ICP voxels, and the voxels' mean colours [U, 3]
    in ``dtype`` (None without colour)."""
    calib = calib.to(dtype)
    pts, rgbs, clouds = [], [], []
    for c, (xyz, valid) in enumerate(_points(depths, intr, cfg)):
        pts.append(xyz[valid])
        if colors is not None:
            rgbs.append(map_color(xyz, valid, colors[c], color,
                                  dtype)[valid])
        if cfg["icp_enabled"]:
            clouds.append(icp_cloud(xyz, valid, cfg, dtype))
    ext = ring_icp(clouds, calib, cfg) if cfg["icp_enabled"] and \
        depths.shape[0] > 1 else calib
    use = ext if cloud_ext is None else cloud_ext.to(dtype)
    icp = [int(c[2].sum()) for c in clouds]
    if colors is None:
        return ext, fused_cloud(pts, use, cfg), icp, None
    xyz, rgb = voxel_grid(*fused_points(pts, use, cfg, rgbs),
                          cfg["out_voxel_leaf"], cfg["out_capacity"], dtype)
    return ext, xyz, icp, rgb
