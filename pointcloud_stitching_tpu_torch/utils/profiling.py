"""Device tracing hooks.

Port of ``pointcloud_stitching_tpu/utils/profiling.py`` on
``torch.profiler``: a streaming run can dump a Chrome trace (viewable in
Perfetto or chrome://tracing) of its host operations and, on a GPU, its
kernels, beside the host-side stage timer.
"""
from __future__ import annotations

import contextlib
import os

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(trace_dir: str):
    """Trace the enclosed block into ``trace_dir``/trace.json.

    Usage:
        with trace("pcs-trace"):
            for _ in range(30):
                client.step()

    The CPU activity is always traced; the CUDA activity (kernels and
    copies) whenever PyTorch sees a GPU.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


def annotate(name: str):
    """Named host span that shows up in the trace."""
    import torch
    return torch.profiler.record_function(name)
