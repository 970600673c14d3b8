"""Per-frame metrics: FPS, latency percentiles, throughput.

Copy of ``pointcloud_stitching_tpu/utils/metrics.py`` (numpy only): the
streaming client's frame statistics (stitched points/s, p50/p99 frame
latency) and its named host-side stage timers.
"""
from __future__ import annotations

import collections
import json
import time
from typing import Optional

import numpy as np


class FrameMetrics:
    """Sliding-window frame statistics."""

    def __init__(self, window: int = 120):
        self.latencies = collections.deque(maxlen=window)
        self.points = collections.deque(maxlen=window)
        self.frame_times = collections.deque(maxlen=window)
        self._last_frame: Optional[float] = None
        self.total_frames = 0
        self.dropped_cameras = 0

    def record(self, latency_s: float, points: int = 0) -> None:
        now = time.time()
        self.latencies.append(latency_s)
        self.points.append(points)
        if self._last_frame is not None:
            self.frame_times.append(now - self._last_frame)
        self._last_frame = now
        self.total_frames += 1

    def record_unsynced(self, points: int = 0) -> None:
        """Count a frame that was dispatched but not host-synced (see
        MulticameraClient.run(sync_every=...)): contributes to frame pacing
        and throughput, but adds no latency sample (its completion time is
        unknown host-side)."""
        now = time.time()
        self.points.append(points)
        if self._last_frame is not None:
            self.frame_times.append(now - self._last_frame)
        self._last_frame = now
        self.total_frames += 1

    def reset(self) -> None:
        """Drop recorded samples (e.g. after a compile warmup frame) so
        summaries reflect steady state only. Keeps the window size."""
        self.latencies.clear()
        self.points.clear()
        self.frame_times.clear()
        self._last_frame = None
        self.total_frames = 0

    @property
    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return 1.0 / float(np.mean(self.frame_times))

    def latency_ms(self, pct: float) -> float:
        if not self.latencies:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies), pct) * 1e3)

    @property
    def points_per_sec(self) -> float:
        if not self.frame_times or not self.points:
            return 0.0
        return float(np.sum(self.points)) / max(float(np.sum(self.frame_times)),
                                                1e-9)

    def summary(self) -> dict:
        return {
            "frames": self.total_frames,
            "fps": round(self.fps, 2),
            "p50_latency_ms": round(self.latency_ms(50), 2),
            "p99_latency_ms": round(self.latency_ms(99), 2),
            "points_per_sec": round(self.points_per_sec, 0),
            "dropped_cameras": self.dropped_cameras,
        }

    def __str__(self) -> str:
        return json.dumps(self.summary())


class StageTimer:
    """Named host-side stage timers (ingest / h2d / stitch / output)."""

    def __init__(self):
        self.stages: dict[str, collections.deque] = {}

    def record(self, stage: str, seconds: float) -> None:
        self.stages.setdefault(stage, collections.deque(maxlen=120)).append(
            seconds)

    def reset(self) -> None:
        self.stages.clear()

    def summary(self) -> dict:
        return {k: round(float(np.mean(v)) * 1e3, 2)
                for k, v in self.stages.items()}
