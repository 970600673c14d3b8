"""What a traced run reads: ``torch.profiler`` (CPU and CUDA activity)
over a fixed span of frames inside the measured window, reduced to the
records the per-layer readers (``metrics/<name>.py``) take.

The span's window is the time from its first to its last recorded event;
the device is busy over the union of its operations' intervals.
"""
from __future__ import annotations

import bisect
import collections
import gc
from dataclasses import dataclass, field

import torch

from . import roofline

TOP = 10


@dataclass
class Span:
    """One traced span and the run's stage samples and frame latencies
    outside it."""
    frames: int                        # frames the span covers
    device_ops: list = field(default_factory=list)   # (name, t0_us, t1_us)
    cpu_ops: list = field(default_factory=list)      # (name, t0_us, t1_us)
    stages: dict = field(default_factory=dict)       # name -> [seconds]
    latencies: list = field(default_factory=list)    # seconds, a frame
    cfg: dict = field(default_factory=dict)          # StitchConfig fields
    work: list = field(default_factory=list)  # per frame: reference.work

    @property
    def window_s(self) -> float:
        ev = self.device_ops + self.cpu_ops
        if not ev:
            return 0.0
        return (max(e[2] for e in ev) - min(e[1] for e in ev)) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(self.device_ops)) * 1e-6

    def least_s(self, work) -> float:
        """The mean over the span's frames of the least seconds for the
        work ``work(cfg, frame's counts)`` gives, or 0 without counts."""
        if not self.work:
            return 0.0
        return sum(roofline.bound_s(*work(self.cfg, w))
                   for w in self.work) / len(self.work)

    def device_s(self, kernel: str) -> float:
        """Summed seconds of the device operations whose name holds
        ``kernel``, per frame."""
        tot = sum(b - a for n, a, b in self.device_ops if kernel in n)
        return tot * 1e-6 / max(self.frames, 1)


def gc_collections() -> int:
    """Passes Python's garbage collector has made, all generations."""
    return sum(g["collections"] for g in gc.get_stats())


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def collect(prof, frames: int, cfg: dict) -> Span:
    """The span's records from a finished profiler."""
    span = Span(frames=frames, cfg=cfg)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        (span.device_ops if e.device_type == cuda else span.cpu_ops
         ).append(rec)
    return span


def _union(ops):
    merged = []
    for _, a, b in sorted(ops, key=lambda e: e[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def short(name: str) -> str:
    """A kernel's or operator's name without its C++ signature."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:80]


def breakdown(span: Span) -> dict:
    """The device operations that took most time and the longest idle
    gaps by the innermost host operation running at the gap's middle, each
    [[name, seconds]] summed over the span, at most ``TOP`` of each."""
    by_op = collections.Counter()
    for n, a, b in span.device_ops:
        by_op[short(n)] += (b - a) * 1e-6
    cpu = sorted(span.cpu_ops, key=lambda e: e[1])
    starts = [e[1] for e in cpu]
    gaps = collections.Counter()
    merged = _union(span.device_ops)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + nxt)
        i = bisect.bisect_right(starts, mid) - 1
        name = "python between operators"
        for j in range(i, max(i - 400, -1), -1):
            if cpu[j][2] >= mid:
                name = short(cpu[j][0])
                break
        gaps[name] += (nxt - end) * 1e-6
    return {"device_ops": [[n, s] for n, s in by_op.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(TOP)]}


def idle_share_pct(span: Span) -> float | None:
    """The device's idle share of the span, in %; None where the span
    recorded no device operation."""
    if span.busy_s <= 0 or span.window_s <= 0:
        return None
    return (1.0 - span.busy_s / span.window_s) * 100.0
