"""The benchmark's scene: a ring rig of depth cameras around a capture
volume, rendered analytically on the device from ``--seed``.

Every cell uses this scene. The rig, the objects, the sensor model and the
calibration error come from the configuration file (``configs/<name>.json``,
keys ``rig``, ``scene`` and ``sensor``); the seed draws only what changes
from run to run without changing the work: the objects' phase on their
orbits, the depth noise, the dropouts, the axes of each camera's
calibration error (their sizes are fixed), the order of the cameras'
clock phases and, for a rig with colour, the objects' textures and the
colour sensor's noise.

A configuration whose ``rig`` holds a ``color`` block also renders colour:
the same scene ray-cast from each colour sensor's pose (the depth pose
composed with the block's depth-to-colour extrinsic) at its own
resolution. Each object has a base colour and a seeded texture that
varies at a few voxels' scale, and each pixel gets seeded sensor noise.

The renderer is a torch copy of ``render_depth`` (spheres and planes by
ray casting, float64), extended with oriented boxes and a finite floor
disc, and run on whatever device it is given: the card in a run, the CPU
in the tests. World frame: z up, the floor at z = 0. Camera frame:
RealSense's, x right, y down, z forward.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch


@dataclass
class Rig:
    """Camera-to-world poses (true and as calibrated) and intrinsics."""
    true_pose: torch.Tensor    # [C, 4, 4] float64, camera -> world
    calib: torch.Tensor        # [C, 4, 4] float32, what the stitcher is told
    fx: float
    fy: float
    ppx: float
    ppy: float
    width: int
    height: int
    depth_scale: float


def look_at(position, target) -> torch.Tensor:
    """Camera-to-world pose [4, 4] float64 of a camera at ``position``
    looking at ``target`` with the world's z axis up."""
    p = torch.tensor(position, dtype=torch.float64)
    f = torch.tensor(target, dtype=torch.float64) - p
    f = f / f.norm()
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    x = torch.linalg.cross(f, up)
    x = x / x.norm()
    y = torch.linalg.cross(f, x)
    T = torch.eye(4, dtype=torch.float64)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, f, p
    return T


def _rotation(axis: torch.Tensor, angle: float) -> torch.Tensor:
    """Rodrigues' rotation [3, 3] about a unit ``axis`` (float64)."""
    k = axis / axis.norm()
    K = torch.tensor([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                      [-k[1], k[0], 0.0]], dtype=torch.float64)
    return (torch.eye(3, dtype=torch.float64) + math.sin(angle) * K
            + (1.0 - math.cos(angle)) * (K @ K))


def make_rig(cfg: dict, seed: int) -> Rig:
    """The ring rig of ``cfg['rig']`` with the calibration error of
    ``cfg['sensor']``: every camera's calibrated pose is its true pose moved
    by ``cal_err_mm`` along a seeded direction and turned by
    ``cal_err_deg`` about a seeded axis through the camera (camera
    frame)."""
    rig, sensor = cfg["rig"], cfg["sensor"]
    n = rig["cameras"]
    poses = []
    for c in range(n):
        a = 2.0 * math.pi * c / n
        pos = (rig["radius_m"] * math.cos(a), rig["radius_m"] * math.sin(a),
               rig["height_m"])
        poses.append(look_at(pos, rig["target"]))
    true_pose = torch.stack(poses)
    g = torch.Generator().manual_seed(_mix(seed, 1))
    dirs = torch.randn((n, 2, 3), generator=g, dtype=torch.float64)
    calib = true_pose.clone()
    for c in range(n):
        dR = _rotation(dirs[c, 0], math.radians(sensor["cal_err_deg"]))
        dt = dirs[c, 1] / dirs[c, 1].norm() * sensor["cal_err_mm"] * 1e-3
        E = torch.eye(4, dtype=torch.float64)
        E[:3, :3], E[:3, 3] = dR, dt
        calib[c] = true_pose[c] @ E
    w, h = rig["width"], rig["height"]
    return Rig(true_pose=true_pose, calib=calib.to(torch.float32),
               fx=rig["fx"], fy=rig["fy"], ppx=w / 2.0, ppy=h / 2.0,
               width=w, height=h, depth_scale=rig["depth_scale"])


def _mix(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one purpose (``stream``) of a run's
    seed: seeds above 2**32 stay distinct."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63 - 1)


def object_phases(cfg: dict, seed: int) -> list[float]:
    """Each object's phase on its orbit (radians), drawn from the seed."""
    sc = cfg["scene"]
    n = len(sc["spheres"]) + len(sc["boxes"])
    g = torch.Generator().manual_seed(_mix(seed, 2))
    return (torch.rand(n, generator=g, dtype=torch.float64)
            * 2.0 * math.pi).tolist()


def clock_phases(n: int, seed: int) -> list[float]:
    """The cameras' capture phases as fractions of one frame period: the
    same evenly spread set for every seed, in a seeded order (the cameras
    are not synchronised, and every seed sees the same spread)."""
    g = torch.Generator().manual_seed(_mix(seed, 3))
    order = torch.randperm(n, generator=g).tolist()
    return [(order[c] + 0.5) / n for c in range(n)]


def _objects_at(cfg: dict, phases: list[float], t: int):
    """Spheres [(centre, r)] and boxes [(centre, half, yaw)] at frame ``t``
    of the cycle: each object orbits its base position on a horizontal
    circle of ``orbit_m`` once a cycle."""
    sc = cfg["scene"]
    k, amp = sc["cycle_frames"], sc["orbit_m"]
    out_s, out_b = [], []
    for i, (c, r) in enumerate(sc["spheres"]):
        a = 2.0 * math.pi * t / k + phases[i]
        out_s.append(((c[0] + amp * math.cos(a), c[1] + amp * math.sin(a),
                       c[2]), r))
    off = len(sc["spheres"])
    for i, (c, half, yaw) in enumerate(sc["boxes"]):
        a = 2.0 * math.pi * t / k + phases[off + i]
        out_b.append(((c[0] + amp * math.cos(a), c[1] + amp * math.sin(a),
                       c[2]), half, yaw))
    return out_s, out_b


def render_depth(rig: Rig, pose: torch.Tensor, spheres, boxes,
                 floor_radius: float, device,
                 z_clip=(0.05, 50.0)) -> torch.Tensor:
    """Analytic z-depth [C, h, w] float64 (0 = no hit) of the nearest
    surface along each pixel ray of every camera at ``pose`` [C, 4, 4]:
    spheres, oriented boxes (yaw about z) and the floor disc of
    ``floor_radius`` around the origin."""
    best = _cast(rig, pose, spheres, boxes, floor_radius, device, z_clip)[0]
    return torch.where(torch.isfinite(best) & (best < z_clip[1]), best, 0.0)


def _cast(rig: Rig, pose: torch.Tensor, spheres, boxes, floor_radius: float,
          device, z_clip, hits: bool = False):
    """The ray cast of ``render_depth``: (z [C, h, w] float64 of the
    nearest surface above ``z_clip[0]``, inf where none), and with ``hits``
    also the object each ray hits (spheres, then boxes, then the floor;
    -1 for none), each ray's direction (z_cam = 1) and origin."""
    h, w = rig.height, rig.width
    T = pose.to(device=device, dtype=torch.float64)
    u = torch.arange(w, dtype=torch.float64, device=device)
    v = torch.arange(h, dtype=torch.float64, device=device)
    rays = torch.stack([((u - rig.ppx) / rig.fx)[None, :].expand(h, w),
                        ((v - rig.ppy) / rig.fy)[:, None].expand(h, w),
                        torch.ones((h, w), dtype=torch.float64,
                                   device=device)], -1)
    d = torch.einsum("cij,hwj->chwi", T[:, :3, :3], rays)  # z_cam = 1
    o = T[:, None, None, :3, 3]
    best = torch.full(d.shape[:3], math.inf, dtype=torch.float64,
                      device=device)
    obj = torch.full(d.shape[:3], -1, dtype=torch.int64,
                     device=device) if hits else None
    count = 0

    def keep(z):
        nonlocal best, obj, count
        z = torch.where(z > z_clip[0], z, math.inf)
        if hits:
            obj = torch.where(z < best, count, obj)
        count += 1
        best = torch.minimum(best, z)

    for c, r in spheres:
        c = torch.tensor(c, dtype=torch.float64, device=device)
        a = (d * d).sum(-1)
        b = 2.0 * (d * (o - c)).sum(-1)
        cc = ((o - c) ** 2).sum(-1) - r * r
        disc = b * b - 4.0 * a * cc
        z = torch.where(disc >= 0,
                        (-b - torch.sqrt(torch.clamp(disc, min=0.0)))
                        / (2.0 * a), math.inf)
        keep(z)
    for c, half, yaw in boxes:
        c = torch.tensor(c, dtype=torch.float64, device=device)
        hb = torch.tensor(half, dtype=torch.float64, device=device)
        cy, sy = math.cos(yaw), math.sin(yaw)
        Rb = torch.tensor([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]],
                          dtype=torch.float64, device=device)
        ob = (o - c) @ Rb                     # box frame: R^T (o - c)
        db = d @ Rb
        safe = torch.where(db.abs() > 1e-12, db, 1e-12)
        t1, t2 = (-hb - ob) / safe, (hb - ob) / safe
        tmin = torch.minimum(t1, t2).amax(-1)
        tmax = torch.maximum(t1, t2).amin(-1)
        keep(torch.where(tmax >= tmin, tmin, math.inf))
    dz = d[..., 2]
    safe = torch.where(dz.abs() > 1e-12, dz, -1e-12)
    z = -o[..., 2] / safe
    hit = o[..., :2] + z[..., None] * d[..., :2]
    keep(torch.where((hit * hit).sum(-1) <= floor_radius ** 2, z, math.inf))
    return best, obj, d, o


def render_cycle(cfg: dict, rig: Rig, seed: int, device) -> torch.Tensor:
    """The cycle of ``cycle_frames`` depth frames [K, C, h, w] uint16 on
    ``device``: the moving scene seen from the true poses, with Gaussian
    depth noise of sigma ``noise_k`` * z^2 metres, ``dropout`` of the
    pixels zeroed, quantised to the depth unit. The noise and dropouts come
    from one device generator seeded from ``seed``."""
    sc, sensor = cfg["scene"], cfg["sensor"]
    phases = object_phases(cfg, seed)
    g = torch.Generator(device=device).manual_seed(_mix(seed, 4))
    k = sc["cycle_frames"]
    out = torch.empty((k, len(rig.true_pose), rig.height, rig.width),
                      dtype=torch.uint16, device=device)
    scale = rig.depth_scale
    for t in range(k):
        spheres, boxes = _objects_at(cfg, phases, t)
        z = render_depth(rig, rig.true_pose, spheres, boxes,
                         sc["floor_radius_m"], device)
        noise = torch.randn(z.shape, generator=g, device=device,
                            dtype=torch.float32).to(torch.float64)
        drop = torch.rand(z.shape, generator=g, device=device,
                          dtype=torch.float32) < sensor["dropout"]
        zn = z + sensor["noise_k"] * z * z * noise
        q = torch.clamp(torch.round(zn / scale), 0, 65535)
        q = torch.where((z > 0) & ~drop, q, 0.0)
        out[t] = q.to(torch.int32).to(torch.uint16)
    return out


# a colour rig's base colour of each object, in the order ``_cast`` numbers
# them (spheres, boxes, the floor), cycled; the colour where a ray hits
# nothing; and the plane waves a texture sums
PALETTE = ((200, 70, 40), (40, 140, 210), (225, 200, 60), (80, 180, 90),
           (170, 80, 200), (150, 135, 115))
BACKGROUND = (30, 30, 30)
WAVES = 3


def has_color(cfg: dict) -> bool:
    """Whether the configuration's rig streams colour (a ``color`` block)."""
    return "color" in cfg["rig"]


def depth_to_color(cfg: dict) -> torch.Tensor:
    """The colour block's depth-to-colour extrinsic [4, 4] float64: a point
    of the depth camera's frame into the colour camera's, turned by the
    rotation vector ``rot_deg`` (degrees) and moved by ``t_m`` (metres)."""
    blk = cfg["rig"]["color"]
    w = torch.tensor(blk["rot_deg"], dtype=torch.float64) * (math.pi / 180)
    E = torch.eye(4, dtype=torch.float64)
    if float(w.norm()) > 0.0:
        E[:3, :3] = _rotation(w, float(w.norm()))
    E[:3, 3] = torch.tensor(blk["t_m"], dtype=torch.float64)
    return E


def color_aligned(cfg: dict) -> bool:
    """Whether the colour is depth-aligned (wire ``DEPTH16_COLOR``): the
    block at the depth's resolution with an identity extrinsic, which must
    then have the depth camera's intrinsics. Any other block is a colour
    stream at its own resolution (``DEPTH16_COLOR_NATIVE``) that the
    stitcher texture-maps."""
    rig, blk = cfg["rig"], cfg["rig"]["color"]
    aligned = (blk["width"], blk["height"]) == (rig["width"],
                                                rig["height"]) \
        and not any(blk["t_m"]) and not any(blk["rot_deg"])
    if aligned and (blk["fx"], blk["fy"], blk["ppx"], blk["ppy"]) != (
            rig["fx"], rig["fy"], rig["width"] / 2.0, rig["height"] / 2.0):
        raise ValueError("depth-aligned colour has the depth intrinsics")
    return aligned


def color_rig(cfg: dict, rig: Rig) -> Rig:
    """The colour sensors as a rig: the block's intrinsics, each true pose
    the depth camera's composed with the inverse of the extrinsic (colour
    camera to world)."""
    blk = cfg["rig"]["color"]
    pose = rig.true_pose @ torch.linalg.inv(depth_to_color(cfg))
    return dataclasses.replace(rig, true_pose=pose, fx=blk["fx"],
                               fy=blk["fy"], ppx=blk["ppx"], ppy=blk["ppy"],
                               width=blk["width"], height=blk["height"])


def textures(cfg: dict, seed: int):
    """Each object's texture (the floor last), drawn from the seed:
    ``WAVES`` plane waves of uniform random direction, a wavelength
    uniform in the block's ``texture_wavelength_m`` and a phase for each
    colour channel. Returns (wave vectors [n, WAVES, 3] in radians a
    metre, phases [n, WAVES, 3]), float64."""
    sc, blk = cfg["scene"], cfg["rig"]["color"]
    n = len(sc["spheres"]) + len(sc["boxes"]) + 1
    g = torch.Generator().manual_seed(_mix(seed, 5))
    dirs = torch.randn((n, WAVES, 3), generator=g, dtype=torch.float64)
    lo, hi = blk["texture_wavelength_m"]
    lam = lo + (hi - lo) * torch.rand((n, WAVES, 1), generator=g,
                                      dtype=torch.float64)
    phase = torch.rand((n, WAVES, 3), generator=g,
                       dtype=torch.float64) * (2.0 * math.pi)
    return dirs / dirs.norm(dim=-1, keepdim=True) * (2.0 * math.pi / lam), \
        phase


def render_color(cfg: dict, rig: Rig, seed: int, device) -> torch.Tensor:
    """The cycle's colour frames [K, C, hc, wc, 3] uint8 on ``device``:
    the scene of ``render_cycle``'s frame t seen by each colour sensor
    (``color_rig``). A hit on object j reads its base colour plus
    ``texture_amp`` times the mean of its waves at the hit point in the
    object's own frame (the world's for the floor), a miss the
    background; every pixel adds Gaussian noise of ``noise_sigma`` levels
    from one device generator seeded from ``seed``, and rounds to 8 bits."""
    sc, blk = cfg["scene"], cfg["rig"]["color"]
    crig = color_rig(cfg, rig)
    phases = object_phases(cfg, seed)
    waves, wphase = (t.to(device) for t in textures(cfg, seed))
    f64 = dict(dtype=torch.float64, device=device)
    base = torch.tensor([PALETTE[j % len(PALETTE)]
                         for j in range(len(waves))], **f64)
    g = torch.Generator(device=device).manual_seed(_mix(seed, 6))
    out = torch.empty((sc["cycle_frames"], len(rig.true_pose), crig.height,
                       crig.width, 3), dtype=torch.uint8, device=device)
    for t in range(sc["cycle_frames"]):
        spheres, boxes = _objects_at(cfg, phases, t)
        z, obj, d, o = _cast(crig, crig.true_pose, spheres, boxes,
                             sc["floor_radius_m"], device, (0.05, 50.0),
                             hits=True)
        x = o + torch.where(torch.isfinite(z), z, 0.0)[..., None] * d
        centres = [c for c, _ in spheres] + [c for c, _, _ in boxes] \
            + [(0.0, 0.0, 0.0)]
        rgb = torch.tensor(BACKGROUND, **f64).expand(*z.shape, 3)
        for j, c in enumerate(centres):
            arg = torch.einsum("chwi,mi->chwm", x - torch.tensor(c, **f64),
                               waves[j])
            tex = torch.sin(arg[..., None] + wphase[j]).mean(-2)
            rgb = torch.where((obj == j)[..., None],
                              base[j] + blk["texture_amp"] * tex, rgb)
        noise = torch.randn(rgb.shape, generator=g, device=device,
                            dtype=torch.float32).to(torch.float64)
        out[t] = torch.clamp(torch.round(rgb + blk["noise_sigma"] * noise),
                             0, 255).to(torch.uint8)
    return out


def tag_depth(seq: int, modulus: int) -> int:
    """The sequence tag a camera writes into pixel (0, 0): 1 + (seq mod
    ``modulus``) depth units, below any z_min the rig uses, so
    deprojection masks it."""
    return 1 + seq % modulus


def untag(value: int, modulus: int) -> int:
    """seq mod ``modulus`` from a tag pixel's value."""
    if not 1 <= value <= modulus:
        raise ValueError(f"pixel (0, 0) holds {value}, not a sequence tag")
    return value - 1
