"""The port's stitch step on a recorded stream against the numpy oracle.

The counterpart of tests/test_golden_stream.py: the stitched cloud of every
frame of the port's ``synthetic_frames`` stream (the one its fake server
replays) must match the PCL-equivalent numpy pipeline of tests/oracle.py to
its float tolerance. Runs on the CPU (the kernels' plain versions).
"""
import numpy as np
import pytest
import torch

from pointcloud_stitching_tpu_torch import (Intrinsics, StitchConfig,
                                            stitch_step, synthetic_frames)
from oracle import deproject_np, random_se3, transform_np, voxel_downsample_np

NCAM, H, W, T = 3, 120, 212, 4


def _oracle_stitch(depths, intrs, exts, leaf, z_min, z_max):
    """Full numpy pipeline: deproject -> transform -> concat -> voxel."""
    clouds = []
    for d, (fx, fy, ppx, ppy), e in zip(depths, intrs, exts):
        xyz, mask = deproject_np(d, fx, fy, ppx, ppy, z_min=z_min,
                                 z_max=z_max)
        clouds.append(transform_np(e, xyz[mask]))
    out, _ = voxel_downsample_np(np.concatenate(clouds), leaf)
    return out


@pytest.fixture(scope="module")
def stream():
    frames = [synthetic_frames(T, H, W, seed=s) for s in range(NCAM)]
    params = [(106.0, 106.0, W / 2, H / 2)] * NCAM
    exts = np.stack([random_se3(seed=40 + i, max_angle=0.2, max_trans=0.3)
                     for i in range(NCAM)]).astype(np.float32)
    cfg = StitchConfig(num_cameras=NCAM, height=H, width=W, z_min=0.1,
                       z_max=10.0, out_voxel_leaf=0.03, out_capacity=65536,
                       icp_enabled=False)
    cams = [Intrinsics.create(*p, width=W, height=H) for p in params]
    return frames, params, exts, cfg, cams[0].stack(cams[1:])


@pytest.mark.parametrize("t", range(T))
def test_recorded_stream_parity(stream, t):
    frames, params, exts, cfg, intr = stream
    depths = np.stack([f[t] for f in frames])
    out = stitch_step(cfg, intr, torch.from_numpy(exts),
                      torch.from_numpy(depths))
    got = out.cloud.xyz[out.cloud.mask].numpy()
    want = _oracle_stitch(depths, params, exts, cfg.out_voxel_leaf,
                          cfg.z_min, cfg.z_max)
    assert got.shape == want.shape and got.shape[0] > 1000
    np.testing.assert_allclose(got, want, atol=2e-4, err_msg=f"frame {t}")
