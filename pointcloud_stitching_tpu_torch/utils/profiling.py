"""Device tracing hooks.

Port of ``pointcloud_stitching_tpu/utils/profiling.py`` on
``torch.profiler``: a streaming run can dump a Chrome trace (viewable in
Perfetto or chrome://tracing) of its host operations and, on a GPU, its
kernels, beside the host-side stage timer. The stitch step and the
streaming loop open named spans (``annotate``) that such a trace shows on
the device's clock:

  pcs.prepare, pcs.icp (> pcs.icp.iter, or pcs.icp.graph around the
  replay of the captured stage), pcs.output, pcs.sync (each blocking
  device-to-host read of the step), pcs.voxel.k1_packed (the global voxel
  pass's packed route on the card: pack kernel, sort, K1); pcs.client.pace,
  .snapshot,
  .h2d, .dispatch, .sync, .deliver (``MulticameraClient.run``).
"""
from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"
# a record function that opens no user scope (see ``annotate``); None
# where this build of torch lacks it
_SPAN = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_NO_SPAN = contextlib.nullcontext()


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
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


def annotate(name: str):
    """Named host span that shows up in the trace: the only way the
    program opens one.

    A fast record function, not ``record_function``: the latter opens a
    user scope, for which the CUDA profiler also writes a device-typed
    annotation event over the span's kernels, which would count as device
    work in a reading of the trace. It is opened only while a profiler
    runs: a fast record function that a profiler starts inside fails as
    it closes (``on_frame`` may start one inside the client's span), and
    off a profiler a span then costs a flag's test. Where torch lacks the
    class, no span is opened."""
    if _SPAN is None or not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return _SPAN(name)
