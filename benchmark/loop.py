"""The closed-loop runner (traffic ``kind: closed``): the stitch step back
to back on a cycle of frames already on the device.

Set-up renders the scene's cycle of K frame sets on the device, builds the
pipeline and stitches one whole cycle (every shape the window uses). The
window then calls ``StitchingPipeline.__call__`` on frame i mod K for
i = 0, 1, ..., in windows of ``window_frames`` calls, each closed by one
scalar pull, until ``--seconds`` have passed; it is timed whole:
``frame_ms`` is its wall time over every frame stitched in it. A traced
run profiles window number ``trace_window`` and counts its frames' work
(``reference.work``) once the window has closed. A rig with colour keeps
its colour cycle (``scene.render_color``) resident beside the depth and
passes frame i mod K's colour with its depth; each judged frame keeps its
voxels' mean colours beside the centroids.
"""
from __future__ import annotations

import collections
import random
import time

import torch

from . import reference, scene, trace
from .harness import intr_of


def _quartiles(v):
    v = sorted(v)
    return [v[0], v[len(v) // 4], v[len(v) // 2], v[3 * len(v) // 4],
            v[-1]] if v else []


def run(ctx) -> dict:
    mix, dev = ctx.traffic, ctx.device
    t = time.perf_counter()
    rig = scene.make_rig(ctx.cfg, ctx.seed)
    frames = scene.render_cycle(ctx.cfg, rig, ctx.seed, dev)
    k = frames.shape[0]
    colors = (scene.render_color(ctx.cfg, rig, ctx.seed, dev)
              if scene.has_color(ctx.cfg) else None)

    def color(j):
        return None if colors is None else colors[j % k]

    ctx.sync()
    render_s = time.perf_counter() - t
    pipe = ctx.pipeline(rig.calib)
    for i in range(k * mix["warmup_cycles"]):
        out = pipe(frames[i % k], color(i))
    int(out.metrics.points_out)
    warm_s = time.perf_counter() - t - render_s
    rng = random.Random(ctx.seed)
    sampled = set(rng.sample(range(mix["sample_range"]), mix["samples"]))
    ctx.end_setup()

    w = mix["window_frames"]
    counts, exts, kept, marks, cpu = [], [], {}, [], []
    span = None
    i = windows = 0
    gc0 = trace.gc_collections()
    t0, c0 = time.perf_counter(), time.thread_time()
    while True:
        prof = None
        if ctx.trace and windows == mix["trace_window"]:
            prof = trace.profiler(dev)
            prof.__enter__()
        for _ in range(w):
            out = pipe(frames[i % k], color(i))
            counts.append(out.metrics.points_out)
            exts.append(out.extrinsics)
            if i in sampled:
                kept[i] = (out.extrinsics.clone(), out.cloud.xyz.clone(),
                           out.cloud.mask.clone(),
                           None if colors is None else out.cloud.rgb.clone())
            i += 1
        int(out.metrics.points_out)
        marks.append(time.perf_counter())
        cpu.append(time.thread_time())
        if prof is not None:
            prof.__exit__(None, None, None)
            span = prof
        windows += 1
        if time.perf_counter() - t0 >= ctx.seconds and \
                (not ctx.trace or span is not None):
            break
    elapsed = time.perf_counter() - t0
    gcs = trace.gc_collections() - gc0
    if span is not None:
        span = trace.collect(span, w, ctx.cfg["stitch"])

    counts = torch.stack(counts).cpu()
    finite = torch.isfinite(torch.stack(exts)).flatten(1).all(1).cpu()
    failed = int(((counts <= 0) | ~finite).sum())
    peak = ctx.peak_bytes()
    del pipe, out
    if span is not None:
        # the traced frames' own work, for the kernels' rooflines
        first = w * mix["trace_window"]
        span.work = [reference.work(frames[j % k], exts[j], intr_of(ctx.cfg),
                                    ctx.cfg["stitch"])
                     for j in range(first, first + w)]
    cap = ctx.cfg["stitch"]["out_capacity"]
    samples = [{"ext": e.cpu(), "xyz": xyz[m].cpu(),
                "depths": frames[j % k].cpu(), "calib": rig.calib,
                **({} if rgb is None else {"rgb": rgb[m].cpu(),
                                           "colors": color(j).cpu()})}
               for j, (e, xyz, m, rgb) in sorted(kept.items())]
    info = {"frames": i, "windows": windows, "window_s": elapsed,
            "sampled": sorted(kept), "voxels_max": int(counts.max()),
            "saturated_frames": int((counts >= cap).sum()),
            "render_s": render_s, "warm_s": warm_s,
            "window_frame_ms": _quartiles(
                [(b - a) / w * 1e3 for a, b in zip([t0] + marks, marks)]),
            # the host thread's CPU time over each window's wall time, and
            # the garbage collector's passes in the window
            "window_cpu_share": _quartiles(
                [(d - c) / (b - a) for a, b, c, d in
                 zip([t0] + marks, marks, [c0] + cpu, cpu)]),
            "gc_collections": gcs}
    if span is not None:
        # the traced frames' mean work (ICP points summed over the cameras)
        total = collections.Counter()
        for wk in span.work:
            total.update({key: sum(v) if isinstance(v, list) else v
                          for key, v in wk.items()})
        info["traced_work"] = {key: v / len(span.work)
                               for key, v in total.items()}
    del frames, colors, kept, exts
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"end_to_end": {"frame_ms": elapsed / i * 1e3},
            "attempted": i, "failed": failed, "wrong": failed,
            "samples": samples,
            "span": span, "memory_peak_bytes": peak, "info": info}
