"""Streaming multicamera client: TCP ingest → batched device feed → stitcher.

Port of ``pointcloud_stitching_tpu/runtime/client.py``. Kept: the pull-based
protocol, one ingest thread per camera, freshest-frame semantics,
single-writer slots read by a snapshot, dead cameras dropped through
``cam_mask``, the overlapped ``run()`` (``overlap``, ``sync_every``,
``fps``, ``dead_timeout``), the on-demand pulls and the stage table
(``snapshot``, ``h2d``, ``dispatch``, ``sync_wait``; the port adds
``held``, a frame's wait between its dispatch and its sync,
``drain_early`` and ``drain_piped``, which of ``run()``'s two orders
delivered a frame, ``frame_age``, the snapshot's age of its oldest live
camera frame, and from the ingest threads, for every camera frame,
``recv``, its pull sent to its bytes received, and ``decode``, its bytes
received to its slot written: decompression, parse and the copy under the
slot's lock).

``run()`` has one loop. Overlapped, it is software-pipelined one frame
deep only while it runs late: frame N is synced and delivered after frame
N+1's dispatch, so N+1's snapshot and copy overlap N's compute. Paced by
``fps`` with the next tick still ahead, it syncs and delivers frame N
straight after N's dispatch instead, as the host would otherwise sleep
with a finished frame. ``overlap=False`` is that at-once order for every
frame.

The host→device feed on a CUDA pipeline: each snapshot is written into a
slot of a ring of **pinned** host buffers and copied with
``non_blocking=True`` on a side stream; the stitch's stream waits on an
event recorded after the copy, and the copied tensors are marked as used
on that stream (``record_stream``) so the allocator does not hand their
memory back to the side stream early. A copy from pinned memory is
asynchronous, so a ring slot may be rewritten only once its last copy has
completed: each slot records an event after its copy and the snapshot
waits on it before writing the slot again. Depth stays ``uint16`` from the
wire to the device (the step converts it there). On a CPU pipeline there
is no pinning and no side stream: each frame's tensors are copies of the
slot, so a slot's reuse never changes a tensor a consumer still holds.
The device is the pipeline's own ``device``.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..models.stitcher import StitchingPipeline, StitchOutput
from ..utils.metrics import FrameMetrics, StageTimer
from ..utils.profiling import annotate
from .wire import Kind, decode_frame, recv_frame_bytes, send_pull


class _CameraSlot:
    """Single-writer staging slot holding a camera's freshest frame.

    Depth mode: a [H, W] uint16 image. Points mode (legacy interop): a
    padded [H*W, 3] float32 point buffer + valid count.
    """

    def __init__(self, h: int, w: int, points: bool = False,
                 color: bool = False, color_shape=None):
        self.points = points
        self.color = color
        if points:
            self.xyz = np.zeros((h * w, 3), np.float32)
            self.rgb = np.zeros((h * w, 3), np.uint8) if color else None
            self.count = 0
        else:
            self.frame = np.zeros((h, w), np.uint16)
            ch, cw = color_shape if color_shape is not None else (h, w)
            self.rgb = np.zeros((ch, cw, 3), np.uint8) if color else None
        self.seq = -1
        self.stamp = 0.0
        self.lock = threading.Lock()
        self.alive = True
        self.error: Optional[str] = None
        # pull gate for on-demand mode: set when the consumer has read this
        # slot (pull the next frame), cleared right after each pull.
        # Starts set so the first frame fetches immediately.
        self.consumed = threading.Event()
        self.consumed.set()


class CameraIngest(threading.Thread):
    """Per-camera ingest thread: pull → recv → decompress → slot."""

    def __init__(self, index: int, address: tuple[str, int], slot: _CameraSlot,
                 stop: threading.Event, connect_timeout: float = 5.0,
                 record_frames: int = 0, reconnect: bool = True,
                 reconnect_backoff: float = 0.5,
                 pull_mode: str = "on_demand",
                 trickle: float = 0.25,
                 record: Optional[Callable[[str, float], None]] = None):
        """``record(stage, seconds)``, where given, takes the ``recv`` and
        ``decode`` samples of every frame."""
        super().__init__(daemon=True, name=f"ingest-cam{index}")
        self.index = index
        self.address = address
        self.slot = slot
        self._stop = stop
        self._connect_timeout = connect_timeout
        self._reconnect = reconnect
        self._backoff = reconnect_backoff
        self._on_demand = pull_mode == "on_demand"
        self._trickle = trickle
        self._record = record
        # keep the first K received depth (+colour) frames for .npy export
        # via MulticameraClient.save_recording
        self.record_frames = record_frames
        self.recorded: list[np.ndarray] = []
        self.recorded_color: list[np.ndarray] = []

    def run(self) -> None:
        """Pull loop with reconnection: a dead camera server marks its slot
        stale (so the stitcher drops it from the batch) but the thread keeps
        retrying with capped exponential backoff and resurrects the slot
        when the server returns."""
        backoff = self._backoff
        while not self._stop.is_set():
            self._run_once()
            if not self._reconnect:
                return
            if self._stop.wait(backoff):
                return
            backoff = min(backoff * 2, 5.0)

    def _run_once(self) -> None:
        try:
            sock = socket.create_connection(self.address,
                                            timeout=self._connect_timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(5.0)
        except OSError as e:
            self.slot.error = f"connect {self.address}: {e}"
            self.slot.alive = False
            return
        self.slot.alive = True
        self.slot.error = None
        try:
            while not self._stop.is_set():
                if self._on_demand:
                    # pull only after the consumer read the previous frame;
                    # the timeout keeps a trickle of pulls flowing when the
                    # consumer stalls, so freshness probing and death
                    # detection keep working. The trickle period must sit
                    # well under the client's stale_timeout.
                    self.slot.consumed.wait(timeout=self._trickle)
                    self.slot.consumed.clear()
                send_pull(sock)
                t_pull = time.perf_counter()
                header, body = recv_frame_bytes(sock)
                t_recv = time.perf_counter()
                kind, seq, payload = decode_frame(header, body)
                if self.slot.points:
                    if kind != Kind.POINTS_I16MM:
                        raise ValueError(f"expected point frames, got {kind}")
                    xyz, rgb = payload
                    n = min(len(xyz), len(self.slot.xyz))
                    with self.slot.lock:
                        self.slot.xyz[:n] = xyz[:n]
                        if self.slot.rgb is not None and rgb is not None:
                            self.slot.rgb[:n] = rgb[:n]
                        self.slot.count = n
                        self.slot.seq = seq
                        self.slot.stamp = time.time()
                    self._record_stages(t_pull, t_recv)
                    continue
                rgb = None
                if kind in (Kind.DEPTH16_COLOR, Kind.DEPTH16_COLOR_NATIVE):
                    payload, rgb = payload
                    if self.slot.rgb is not None and \
                            rgb.shape != self.slot.rgb.shape:
                        raise ValueError(
                            f"camera {self.index} sent color {rgb.shape} "
                            f"but the pipeline expects "
                            f"{self.slot.rgb.shape} (set StitchConfig "
                            f"color_height/color_width to match)")
                elif kind != Kind.DEPTH16:
                    raise ValueError(f"unexpected frame kind {kind}")
                if payload.shape != self.slot.frame.shape:
                    raise ValueError(
                        f"camera {self.index} sent {payload.shape} frames "
                        f"but the pipeline expects {self.slot.frame.shape} "
                        f"(set StitchConfig height/width to match)")
                if len(self.recorded) < self.record_frames:
                    self.recorded.append(payload.copy())
                    if rgb is not None:
                        self.recorded_color.append(rgb.copy())
                with self.slot.lock:
                    self.slot.frame[...] = payload
                    if self.slot.rgb is not None and rgb is not None:
                        self.slot.rgb[...] = rgb
                    self.slot.seq = seq
                    self.slot.stamp = time.time()
                self._record_stages(t_pull, t_recv)
        except Exception as e:  # noqa: BLE001 — deliberate breadth:
            # decoding raises more than (OSError, ValueError): zlib.error on
            # a corrupt stream, struct.error on a short colour payload,
            # RuntimeError when the snappy codec cannot be built,
            # MemoryError on a hostile size preamble. Any of those escaping
            # would kill the thread with slot.alive still True: no error
            # surfaced, no reconnect. Every failure marks the slot dead and
            # feeds the backoff/resurrect loop instead.
            self.slot.error = f"{type(e).__name__}: {e}"
            self.slot.alive = False
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _record_stages(self, t_pull: float, t_recv: float) -> None:
        if self._record is not None:
            self._record("recv", t_recv - t_pull)
            self._record("decode", time.perf_counter() - t_recv)


class _Stage:
    """One slot of the snapshot staging ring: host tensors (pinned for a
    CUDA pipeline), numpy views of them for the snapshot to write into, and
    on CUDA an event recorded after the slot's last host→device copy."""

    def __init__(self, host: dict[str, Optional[torch.Tensor]], cuda: bool):
        self.host = host
        self.np = {k: None if v is None else v.numpy()
                   for k, v in host.items()}
        self.copied = torch.cuda.Event() if cuda else None

    def wait_copied(self) -> None:
        """Block until the slot's last copy has read the host buffers (an
        event never recorded returns at once)."""
        if self.copied is not None:
            self.copied.synchronize()


class MulticameraClient:
    """Connects to N camera servers and runs the stitching pipeline live."""

    def __init__(self, addresses: Sequence[tuple[str, int]],
                 pipeline: StitchingPipeline,
                 stale_timeout: float = 0.5,
                 payload: str = "depth",
                 record_frames: int = 0,
                 reconnect: bool = True,
                 pull_mode: str = "on_demand"):
        """pull_mode: 'on_demand' (default) pulls a camera only after the
        previous frame was consumed by a snapshot; 'continuous' pulls
        flat-out for the freshest possible frame at any snapshot instant."""
        cfg = pipeline.cfg
        if len(addresses) != cfg.num_cameras:
            raise ValueError("address count != cfg.num_cameras")
        if payload not in ("depth", "points"):
            raise ValueError("payload must be 'depth' or 'points'")
        if pull_mode not in ("on_demand", "continuous"):
            raise ValueError("pull_mode must be 'on_demand' or 'continuous'")
        self.pipeline = pipeline
        self.device = pipeline.device
        self._cuda = self.device.type == "cuda"
        # the side stream of the host→device copies (CUDA only)
        self._h2d = torch.cuda.Stream(self.device) if self._cuda else None
        self.payload = payload
        self.stale_timeout = stale_timeout
        self.metrics = FrameMetrics()
        self.stages = StageTimer()
        self._stop = threading.Event()
        cshape = (None if cfg.color_height is None
                  else (cfg.color_height, cfg.color_width))
        self._slots = [_CameraSlot(cfg.height, cfg.width,
                                   points=payload == "points",
                                   color=cfg.with_color, color_shape=cshape)
                       for _ in addresses]
        self._threads = [
            CameraIngest(i, addr, slot, self._stop,
                         record_frames=record_frames, reconnect=reconnect,
                         pull_mode=pull_mode,
                         # keep the stall-trickle period well under the
                         # staleness test or a healthy camera flaps stale
                         trickle=min(0.25, stale_timeout / 4.0),
                         # reads self.stages at every call: a caller may
                         # put its own timer there while the threads run
                         record=lambda k, t: self.stages.record(k, t))
            for i, (addr, slot) in enumerate(zip(addresses, self._slots))]
        self._stage_ring: list[_Stage] = []
        self._stage_i = 0

    def _host(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, pin_memory=self._cuda)

    def _ensure_stage_ring(self, depth: int) -> None:
        """Size the snapshot staging ring. Buffers are reused, not
        reallocated (fresh pages fault inside the snapshot window); a slot
        is rewritten only after its last copy completed (``_Stage``), so any
        depth is tear-safe, and sync_every + 2 slots keep that wait off the
        loop's path."""
        cfg = self.pipeline.cfg
        n = cfg.num_cameras
        ch = cfg.color_height or cfg.height
        cw = cfg.color_width or cfg.width
        while len(self._stage_ring) < depth:
            if self.payload == "points":
                cap = cfg.height * cfg.width
                host = {"xyz": self._host((n, cap, 3), torch.float32),
                        "pmask": self._host((n, cap), torch.bool),
                        "rgb": (self._host((n, cap, 3), torch.uint8)
                                if cfg.with_color else None)}
            else:
                host = {"depths": self._host((n, cfg.height, cfg.width),
                                             torch.uint16),
                        "colors": (self._host((n, ch, cw, 3), torch.uint8)
                                   if cfg.with_color else None)}
            host["mask"] = self._host((n,), torch.bool)
            self._stage_ring.append(_Stage(host, self._cuda))

    def _next_stage(self) -> _Stage:
        if not self._stage_ring:
            self._ensure_stage_ring(3)
        stage = self._stage_ring[self._stage_i % len(self._stage_ring)]
        self._stage_i += 1
        stage.wait_copied()
        return stage

    def save_recording(self, directory: str) -> list[str]:
        """Dump recorded per-camera depth (+colour) streams as replayable
        .npy files (feed them back through fake_server --frames
        [--color-frames])."""
        import os
        os.makedirs(directory, exist_ok=True)
        paths = []
        for t in self._threads:
            if t.recorded:
                p = os.path.join(directory, f"cam{t.index}.npy")
                np.save(p, np.stack(t.recorded))
                paths.append(p)
            if t.recorded_color:
                p = os.path.join(directory, f"cam{t.index}_color.npy")
                np.save(p, np.stack(t.recorded_color))
                paths.append(p)
        return paths

    def start(self) -> "MulticameraClient":
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def __enter__(self) -> "MulticameraClient":
        if all(t.ident is None for t in self._threads):  # never started
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def wait_for_first_frames(self, timeout: float = 10.0) -> bool:
        """Wait until every camera has either delivered a frame or is down
        (with at least one frame somewhere). ``alive`` flaps during
        reconnect backoff, so "delivered a frame ever" (seq >= 0) is the
        stable signal."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if all((s.seq >= 0) or not s.alive for s in self._slots) and \
                    any(s.seq >= 0 for s in self._slots):
                return True
            time.sleep(0.01)
        return False

    def camera_errors(self) -> list[str]:
        """Why dead cameras died (for operator diagnostics)."""
        return [f"cam{i}: {s.error}" for i, s in enumerate(self._slots)
                if s.error]

    def _wake_pulls(self) -> None:
        """Release the on-demand ingest pulls (one per camera). Called after
        the next frame is dispatched, so the ingest threads' recv and
        decompress run under the sync wait, not inside the snapshot."""
        for s in self._slots:
            s.consumed.set()

    def _snapshot(self):
        """Copy the freshest frames into a staging slot; set its cam mask.
        Records the ``frame_age`` stage (the snapshot instant less the
        oldest live camera's receipt) when a camera is live. Returns
        (stage, number of live cameras)."""
        now = time.time()
        stage = self._next_stage()
        a = stage.np
        mask = a["mask"]
        if self.payload == "points":
            a["pmask"][...] = False
        oldest = None
        for i, s in enumerate(self._slots):
            with s.lock:
                if self.payload == "points":
                    a["xyz"][i] = s.xyz
                    if a["rgb"] is not None and s.rgb is not None:
                        a["rgb"][i] = s.rgb
                    a["pmask"][i, :s.count] = True
                else:
                    a["depths"][i] = s.frame
                    if a["colors"] is not None and s.rgb is not None:
                        a["colors"][i] = s.rgb
                fresh = s.alive and s.seq >= 0 and \
                    (now - s.stamp) <= self.stale_timeout
                if fresh and (oldest is None or s.stamp < oldest):
                    oldest = s.stamp
            mask[i] = fresh
        if oldest is not None:
            self.stages.record("frame_age", now - oldest)
        return stage, int(mask.sum())

    def _transfer(self, stage: _Stage):
        """Enqueue the host→device copies of a staged snapshot.

        On CUDA the copies go on the side stream from pinned memory and
        return once enqueued; the current (stitch) stream waits on an event
        recorded after them, so frame N+1's copy overlaps frame N's compute
        while ``run()`` runs pipelined. Returns (device tensors by name,
        npix)."""
        host = stage.host
        if not self._cuda:
            dev = {k: None if v is None else v.clone()
                   for k, v in host.items()}
        else:
            main = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._h2d):
                dev = {k: None if v is None else
                       v.to(self.device, non_blocking=True)
                       for k, v in host.items()}
                stage.copied.record(self._h2d)
            main.wait_event(stage.copied)
            for t in dev.values():
                if t is not None:
                    t.record_stream(main)
        npix = (host["pmask"].numel() if self.payload == "points"
                else host["depths"].numel())
        return dev, npix

    def _dispatch(self, dev) -> StitchOutput:
        """Enqueue one stitch on device-resident inputs (no sync of its
        own beyond the pipeline's voxel-branch choices)."""
        if self.payload == "points":
            return self.pipeline.step_points(dev["xyz"], dev["pmask"],
                                             rgb=dev["rgb"],
                                             cam_mask=dev["mask"])
        out = self.pipeline(dev["depths"], colors=dev["colors"],
                            cam_mask=dev["mask"])
        # the frame's raw device inputs ride along, so on_frame consumers
        # (stitch_cli's TSDF keyframes) see the exact frame the stitch saw
        return out._replace(depth=dev["depths"], color=dev["colors"],
                            cam_mask=dev["mask"])

    @staticmethod
    def _sync(out: StitchOutput) -> int:
        """Block until the frame's work finished (a scalar pull; the
        clouds stay on the device)."""
        return int(out.metrics.points_out)

    def _launch(self) -> Optional[tuple]:
        """Snapshot the freshest frames, copy them to the device and dispatch
        their stitch; records the ``snapshot``, ``h2d`` and ``dispatch``
        stages and releases the pulls. Returns the frame in flight (out,
        snapshot start, npix, its dispatch's end), or None if no camera is
        live."""
        t0 = time.time()
        with annotate("pcs.client.snapshot"):
            stage, live = self._snapshot()
        self.metrics.dropped_cameras = self.pipeline.cfg.num_cameras - live
        t1 = time.time()
        if live > 0:
            with annotate("pcs.client.h2d"):
                dev, npix = self._transfer(stage)
            t2 = time.time()
            with annotate("pcs.client.dispatch"):
                out = self._dispatch(dev)
            t_out = time.time()
            self.stages.record("dispatch", t_out - t2)
            self._wake_pulls()  # decode rides under sync_wait
            # latency spans snapshot start -> sync; the frame is held from
            # its dispatch's end to its sync
            frame = (out, t0, npix, t_out)
        else:
            t2, frame = t1, None
            self._wake_pulls()
        self.stages.record("snapshot", t1 - t0)
        self.stages.record("h2d", t2 - t1)
        return frame

    def _timed_sync(self, out: StitchOutput, t0: float, npix: int,
                    t_out: float) -> None:
        """``_sync`` a frame whose snapshot began at ``t0`` and whose
        dispatch ended at ``t_out``: records the ``held`` stage (how long the
        frame was held before its sync), ``sync_wait`` and the frame's
        latency."""
        t_wait = time.time()
        self.stages.record("held", t_wait - t_out)
        with annotate("pcs.client.sync"):
            self._sync(out)
        t3 = time.time()
        self.stages.record("sync_wait", t3 - t_wait)
        self.metrics.record(t3 - t0, points=npix)

    def step(self) -> Optional[StitchOutput]:
        """One serial stitch tick over the freshest frames (snapshot → H2D →
        compute → sync). None if no camera is live. For steady-state
        streaming prefer run(), which overlaps H2D with compute."""
        frame = self._launch()
        if frame is None:
            return None
        self._timed_sync(*frame)
        return frame[0]

    def run(self, num_frames: Optional[int] = None,
            on_frame: Optional[Callable[[int, StitchOutput], None]] = None,
            overlap: bool = True, sync_every: int = 1,
            dead_timeout: Optional[float] = 30.0,
            fps: Optional[float] = None) -> FrameMetrics:
        """Streaming loop. With overlap=True (default) the loop is software-
        pipelined one frame deep while it runs late: while frame N's work
        runs on the device, the host snapshots and enqueues frame N+1's copy
        and step, and frame N is synced only after that. Under ``fps``, a
        frame dispatched while the next tick is still ahead is synced and
        delivered at once, before the pace wait, so it is not held through
        the wait and the next frame's dispatch; unpaced, the loop is always
        late. Each drained frame records the stage ``drain_early`` (seconds
        left to the next tick) or ``drain_piped`` (seconds the loop ran past
        its tick, 0 unpaced). With overlap=False every frame is synced and
        delivered at once, and neither stage is recorded. on_frame(n, out)
        sees every completed frame in order.

        sync_every: host-sync (and record a latency sample) only every K-th
        frame; the other frames count for throughput only. overlap=False
        syncs every frame.

        num_frames counts stitched frames. dead_timeout (seconds, None =
        forever) bounds how long a bounded run waits with zero live cameras
        and nothing in flight; unbounded runs ride out any outage.

        fps paces the dispatch side to that many ticks per second; late
        ticks do not bank debt.

        The client stays started when run() returns, so bounded runs can be
        issued repeatedly; call stop() (or use the client as a context
        manager) to end the ingest threads.
        """
        if num_frames is not None and num_frames <= 0:
            return self.metrics
        sync_every = max(int(sync_every), 1) if overlap else 1
        self._ensure_stage_ring(sync_every + 2)
        n = 0
        last_alive = time.time()
        tick = (1.0 / fps) if fps else None
        next_t = time.time() if tick is not None else 0.0
        # the frame left in flight while the loop runs late: (out, snapshot
        # start, npix, its dispatch's end, seconds the loop was past its tick)
        pending: Optional[tuple] = None

        def drain(frame, stage: Optional[str]) -> bool:
            """Sync (every sync_every-th and the last frame), record and
            deliver frame n; True once a bounded run has all its frames."""
            nonlocal n, last_alive
            out, t0, npix, t_out, value = frame
            if stage is not None:
                self.stages.record(stage, value)
            if n % sync_every == 0 or \
                    (num_frames is not None and n + 1 >= num_frames):
                self._timed_sync(out, t0, npix, t_out)
            else:
                self.metrics.record_unsynced(points=npix)
            if on_frame is not None:
                with annotate("pcs.client.deliver"):
                    on_frame(n, out)
            n += 1
            last_alive = time.time()
            return num_frames is not None and n >= num_frames

        try:
            while not self._stop.is_set():
                # never dispatch past num_frames: with one frame in flight
                # and n delivered, an extra dispatch would be discarded
                in_flight = 1 if pending is not None else 0
                if num_frames is not None and n + in_flight >= num_frames:
                    nxt = None
                else:
                    if tick is not None:
                        # pace the dispatch side only; the drain below must
                        # never wait on the schedule
                        with annotate("pcs.client.pace"):
                            delay = next_t - time.time()
                            if delay > 0:
                                self._stop.wait(delay)
                        next_t = max(next_t + tick, time.time())
                    nxt = self._launch()
                    if nxt is None and pending is None:
                        # nothing in flight and nothing to stitch: do not
                        # busy-spin, and give up once a bounded run's outage
                        # outlasts dead_timeout
                        if num_frames is not None and \
                                dead_timeout is not None and \
                                time.time() - last_alive > dead_timeout:
                            break
                        self._stop.wait(0.005)
                # drain frame N while N+1 runs (its copy is already enqueued)
                if pending is not None and drain(pending, "drain_piped"):
                    break
                pending = None
                if nxt is not None and not self._stop.is_set():
                    late = (time.time() - next_t) if tick is not None \
                        else 0.0
                    if not overlap:
                        if drain(nxt + (0.0,), None):
                            break
                    elif late < 0:
                        # ahead of the schedule: the host would only sleep
                        # until the next tick, so the frame is delivered
                        # now rather than after the next frame's dispatch
                        if drain(nxt + (-late,), "drain_early"):
                            break
                    else:
                        pending = nxt + (late,)
        except BaseException:
            # an exception escaping the loop (including KeyboardInterrupt)
            # tears the client down: the in-flight frame is unowned
            self.stop()
            raise
        return self.metrics
