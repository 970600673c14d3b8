"""The served-stream runner (traffic ``kind: stream``): the streaming client
of the port, fed over TCP by the camera generator (``camera.py``), a
process of its own.

Set-up renders the scene's cycle of K frame sets on the device, copies it
to the host and encodes every frame a camera will serve: its cycle frame
(seq mod K) with the sequence tag 1 + (seq mod ``tag_modulus``) in pixel
(0, 0), snappy-compressed by the port's native codec. It starts the
generator, connects ``MulticameraClient`` and streams ``warmup_frames``.
The window is one ``MulticameraClient.run(overlap, sync_every, fps)``
stopped from ``on_frame`` once ``--seconds`` have passed (a traced run
profiles its last ``trace_frames`` frames' worth of time), with the
benchmark's own unbounded accumulators in place of the client's metrics
and stage timers. For each delivered frame the benchmark keeps its
delivery time (``on_frame``, after the frame's sync) and, copied on the
device without a sync, pixel (0, 0) of every camera's depth, its count,
extrinsics and camera mask. After the window it reads which captured
frame of each camera the output holds from the tags and the generator's
reports of what it sent, and so its capture time.

A rig with colour serves it in the port's wire kinds, after the depth in
each frame's payload: ``DEPTH16_COLOR`` for depth-aligned colour,
``DEPTH16_COLOR_NATIVE`` (the colour's rows and columns inline) for a
colour stream of its own. Camera c's frame v carries cycle frame v mod K's
colour, so the depth tag names both images, and each kept frame keeps its
voxels' mean colours beside its centroids.

A delivered frame is wrong when a camera's tag names no frame that camera
sent, or its output is empty or not finite; it failed when it is wrong or
lacked a camera while the camera process was alive. ``stream_fps`` is the
frames delivered in the window over its length;
``latency_p50_ms`` the median over those frames of delivery time minus
the capture time of the newest camera frame each holds. A traced run
hands the latencies of the frames outside its span to the readers
(``Span.latencies``); ``info.latency_p95_ms`` is the window's tail.
"""
from __future__ import annotations

import json
import math
import random
import resource
import struct
import subprocess
import sys
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from . import scene, trace
from .harness import BENCH

KIND_DEPTH16 = 0
KIND_DEPTH16_COLOR = 2
KIND_DEPTH16_COLOR_NATIVE = 3
CODEC_SNAPPY = 2


def _header(size: int, rows: int, cols: int,
            kind: int = KIND_DEPTH16) -> bytes:
    """The wire header of a snappy frame of ``kind`` (seq patched at
    send)."""
    return struct.pack("<IBBBBIHH", size, kind, CODEC_SNAPPY, 0, 0, 0, rows,
                       cols)


def encode(cycle: np.ndarray, modulus: int, colors: np.ndarray | None = None,
           aligned: bool = True) -> list[list[bytes]]:
    """Every camera's served frames [C][lcm(K, modulus)]: frame v is cycle
    frame v mod K with the tag of seq v in pixel (0, 0), and with
    ``colors`` [K, C, hc, wc, 3] its colour after the depth: depth-aligned,
    or (``aligned`` false) with the colour's rows and columns before it."""
    from concurrent.futures import ThreadPoolExecutor

    from pointcloud_stitching_tpu_torch.native import snappy
    k, cams, h, w = cycle.shape
    n = math.lcm(k, modulus)
    kind = KIND_DEPTH16 if colors is None else (
        KIND_DEPTH16_COLOR if aligned else KIND_DEPTH16_COLOR_NATIVE)

    def one(job):
        c, v = job
        d = cycle[v % k, c].copy()
        d[0, 0] = scene.tag_depth(v, modulus)
        raw = d.astype("<u2").tobytes()
        if colors is not None:
            rgb = colors[v % k, c]
            raw += (b"" if aligned else struct.pack("<HH", *rgb.shape[:2])) \
                + rgb.tobytes()
        body = snappy.compress(raw)
        return _header(len(body), h, w, kind) + body

    jobs = [(c, v) for c in range(cams) for v in range(n)]
    with ThreadPoolExecutor(8) as pool:
        blobs = list(pool.map(one, jobs))
    return [blobs[c * n:(c + 1) * n] for c in range(cams)]


def _ratio(images: np.ndarray) -> float:
    """Raw over snappy-compressed bytes of ``images`` [C, ...], each
    compressed alone."""
    from pointcloud_stitching_tpu_torch.native import snappy
    return images.nbytes / sum(len(snappy.compress(i.tobytes()))
                               for i in images)


class Stages:
    """Unbounded stage timer (the client's keeps its last 120 samples):
    every sample with the time it was recorded."""

    def __init__(self):
        self.stages = defaultdict(list)

    def record(self, stage: str, seconds: float) -> None:
        self.stages[stage].append((time.monotonic(), seconds))


class Frames:
    """In place of the client's ``FrameMetrics`` (a 120-frame window): the
    benchmark times frames itself, so this only counts them."""

    def __init__(self):
        self.total_frames = self.dropped_cameras = 0

    def record(self, latency_s: float = 0.0, points: int = 0) -> None:
        self.total_frames += 1

    record_unsynced = record


class Generator:
    """The camera process and the reader of its reports."""

    def __init__(self, blobs, fps: float, phases: list[float]):
        self.proc = subprocess.Popen(
            [sys.executable, str(BENCH / "camera.py")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        spec = {"fps": fps, "phases": phases,
                "sizes": [[len(b) for b in cam] for cam in blobs]}
        self.proc.stdin.write((json.dumps(spec) + "\n").encode())
        for cam in blobs:
            for b in cam:
                self.proc.stdin.write(b)
        self.proc.stdin.flush()
        head = json.loads(self.proc.stdout.readline())
        self.ports = head["ports"]
        self.sent = defaultdict(list)      # camera -> [(seq, t_cap, t_sent)]
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            c, k, t_cap, t_sent = line.split()
            self.sent[int(c)].append((int(k), float(t_cap), float(t_sent)))

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._reader.join(timeout=10)

    def capture(self, cam: int, tag: int, modulus: int, before: float):
        """(seq, capture time) of the latest frame camera ``cam`` sent
        before ``before`` whose seq matches the tag, or None."""
        r = scene.untag(tag, modulus)
        for k, t_cap, t_sent in reversed(self.sent[cam]):
            if k % modulus == r and t_sent <= before:
                return k, t_cap
        return None


def run(ctx) -> dict:
    from pointcloud_stitching_tpu_torch import MulticameraClient
    mix, dev, cfg = ctx.traffic, ctx.device, ctx.cfg
    modulus = mix["tag_modulus"]
    t = time.perf_counter()
    rig = scene.make_rig(cfg, ctx.seed)
    cycle = scene.render_cycle(cfg, rig, ctx.seed, dev).cpu().numpy()
    k, cams = cycle.shape[:2]
    ccycle = (scene.render_color(cfg, rig, ctx.seed, dev).cpu().numpy()
              if scene.has_color(cfg) else None)
    render_s = time.perf_counter() - t
    blobs = encode(cycle, modulus, ccycle,
                   ccycle is None or scene.color_aligned(cfg))
    # the served frames before and after snappy
    served = {"served_mb": sum(len(x) for b in blobs for x in b) / 1e6,
              "raw_mb": len(blobs[0]) * (cycle[0].nbytes + (
                  0 if ccycle is None else ccycle[0].nbytes)) / 1e6}
    gen = Generator(blobs, mix["camera_fps"],
                    scene.clock_phases(cams, ctx.seed))
    del blobs
    encode_s = time.perf_counter() - t - render_s
    client = None
    try:
        pipe = ctx.pipeline(rig.calib)
        client = MulticameraClient([("127.0.0.1", p) for p in gen.ports],
                                   pipe,
                                   stale_timeout=mix["stale_timeout_s"],
                                   pull_mode=mix["pull_mode"])
        client.start()
        if not client.wait_for_first_frames(timeout=60):
            raise RuntimeError("the cameras sent no frame: "
                               + "; ".join(client.camera_errors()))
        client.run(num_frames=mix["warmup_frames"], overlap=mix["overlap"],
                   sync_every=mix["sync_every"], fps=mix["client_fps"])
        if ctx.trace:
            # the profiler's first start sets up its device tracing; that
            # stall belongs to set-up, not to the traced span
            with trace.profiler(dev):
                client.run(num_frames=2, overlap=mix["overlap"],
                           sync_every=mix["sync_every"],
                           fps=mix["client_fps"])
        warm_s = time.perf_counter() - t - render_s - encode_s
        rng = random.Random(ctx.seed)
        sampled = set(rng.sample(range(mix["sample_range"]),
                                 mix["samples"]))
        cap = int(ctx.seconds * mix["client_fps"] * 2) + 64
        tags = torch.zeros((cap, cams), dtype=torch.int32, device=dev)
        counts = torch.zeros(cap, dtype=torch.int64, device=dev)
        masks = torch.zeros((cap, cams), dtype=torch.bool, device=dev)
        exts = torch.zeros((cap, cams, 4, 4), device=dev)
        st = {"delivered": [], "kept": {}, "prof": None, "span": None,
              "span_t": (math.inf, -math.inf)}
        client.metrics, client.stages = Frames(), Stages()
        ctx.end_setup()
        t_end = time.monotonic() + ctx.seconds
        t_begin = time.monotonic()
        c_begin, gc_begin = time.thread_time(), trace.gc_collections()

        t_trace = t_end - mix["trace_frames"] / mix["client_fps"]

        def on_frame(n, out):
            now = time.monotonic()
            if now > t_end or n >= cap:
                client.stop()
                return
            st["delivered"].append(now)
            tags[n].copy_(out.depth[:, 0, 0])
            counts[n].copy_(out.metrics.points_out)
            masks[n].copy_(out.cam_mask)
            exts[n].copy_(out.extrinsics)
            if n in sampled:
                st["kept"][n] = (out.extrinsics.clone(),
                                 out.cloud.xyz.clone(),
                                 out.cloud.mask.clone(),
                                 None if ccycle is None
                                 else out.cloud.rgb.clone())
            if ctx.trace and st["prof"] is None and now >= t_trace:
                st["prof"] = trace.profiler(dev)
                st["prof"].__enter__()
                st["span_t"] = (now, n)

        client.run(num_frames=None, on_frame=on_frame,
                   overlap=mix["overlap"], sync_every=mix["sync_every"],
                   fps=mix["client_fps"])
        run_s = time.monotonic() - t_begin
        host = {"main_cpu_share": (time.thread_time() - c_begin) / run_s,
                "gc_collections": trace.gc_collections() - gc_begin}
        if st["prof"] is not None:
            # the span is the window's last frames; stopping the profiler
            # stalls the host, so it stops once the window has closed
            ctx.sync()
            st["prof"].__exit__(None, None, None)
            frames = len(st["delivered"]) - st["span_t"][1]
            st["span"] = (st["prof"], max(frames, 1))
            st["span_t"] = (st["span_t"][0], math.inf)
        alive = gen.alive()
        peak = ctx.peak_bytes()
        stages = client.stages.stages
    finally:
        if client is not None:
            client.stop()
        gen.stop()

    n = len(st["delivered"])
    tags, counts = tags[:n].cpu(), counts[:n].cpu()
    masks = masks[:n].cpu()
    finite = torch.isfinite(exts[:n]).flatten(1).all(1).cpu()
    timed, failed, wrong, seqs = [], 0, 0, []   # (delivery, latency)
    for i, d in enumerate(st["delivered"]):
        caps = [gen.capture(c, int(tags[i, c]), modulus, d)
                if 1 <= int(tags[i, c]) <= modulus else None
                for c in range(cams)]
        seqs.append(caps)
        bad = any(x is None for x in caps) or counts[i] <= 0 \
            or not bool(finite[i])
        wrong += bad
        failed += bad or (alive and not bool(masks[i].all()))
        if not any(x is None for x in caps):
            timed.append((d, d - max(t for _, t in caps)))
    samples = []
    for i, (e, xyz, m, rgb) in sorted(st["kept"].items()):
        if i >= n or any(x is None for x in seqs[i]) \
                or not bool(masks[i].all()):
            continue
        d = np.stack([cycle[s % k, c] for c, (s, _) in enumerate(seqs[i])])
        d = d.copy()
        for c, (s, _) in enumerate(seqs[i]):
            d[c, 0, 0] = scene.tag_depth(s, modulus)
        samples.append({"ext": e.cpu(), "xyz": xyz[m].cpu(),
                        "depths": torch.from_numpy(d.astype(np.int32)
                                                   ).to(torch.uint16),
                        "calib": rig.calib})
        if rgb is not None:
            samples[-1]["rgb"] = rgb[m].cpu()
            samples[-1]["colors"] = torch.from_numpy(np.stack(
                [ccycle[s % k, c] for c, (s, _) in enumerate(seqs[i])]))
    lat = [s for _, s in timed]
    lo, hi = st["span_t"]
    outside = {name: [s for t, s in v if not lo <= t <= hi]
               for name, v in stages.items()}
    span = None
    if st["span"] is not None:
        span = trace.collect(*st["span"], cfg["stitch"])
        span.stages = outside
        span.latencies = [s for t, s in timed if not lo <= t <= hi]
    stale = sum(1 for a, b in zip(seqs, seqs[1:]) for x, y in zip(a, b)
                if x is not None and y is not None and x[0] == y[0])
    skipped = sum(1 for c in range(cams) for a, b in
                  zip(gen.sent[c], gen.sent[c][1:]) if b[0] - a[0] > 1)
    info = {"frames": n, "window_s": ctx.seconds, "sampled": sorted(
        st["kept"]), "generator_alive": alive,
        "camera_frames_skipped": skipped,
        "voxels_max": int(counts.max()) if n else 0,
        "latency_ms_pct_5_25_75_99_max": [
            float(np.percentile(lat, q)) * 1e3 for q in (5, 25, 75, 99, 100)]
        if lat else None,
        "latency_p95_ms": float(np.percentile(lat, 95)) * 1e3
        if lat else None,
        "stale_camera_frames": stale,
        "run_s": run_s, **host, "render_s": render_s,
        "encode_s": encode_s, "warm_s": warm_s, **served,
        "snappy_ratio": served["raw_mb"] / served["served_mb"],
        "color_snappy_ratio": None if ccycle is None else _ratio(ccycle[0]),
        "host_peak_rss_gb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}
    del client, pipe, tags, masks, exts, st
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    e2e = {"stream_fps": n / ctx.seconds}
    if lat:
        e2e["latency_p50_ms"] = float(np.percentile(lat, 50)) * 1e3
    return {"end_to_end": e2e, "attempted": n, "failed": failed,
            "wrong": wrong,
            "samples": samples, "span": span, "memory_peak_bytes": peak,
            "info": info}
