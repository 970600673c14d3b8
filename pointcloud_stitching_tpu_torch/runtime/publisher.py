"""Stitched-cloud publisher: serve the fused output stream over TCP.

Port of ``pointcloud_stitching_tpu/runtime/publisher.py``. The
production-serving counterpart of the reference's live PCLVisualizer
window (SURVEY.md §1 L4): instead of rendering locally, the stitcher pushes
every fused cloud to subscribed consumers using the same wire protocol the
cameras speak (POINTS_I16MM, packed int16-mm XYZ [+RGB], snappy/zlib).
A consumer is anything that can read the frame format — including this
package's own ingest (`recv_frame`), so stitched streams can be chained,
recorded, or visualised elsewhere.

Push model (no pull byte): consumers connect and receive every published
frame; a slow consumer is dropped rather than backpressuring the stitcher
(freshest-output semantics, matching the camera side). "Slow" covers both
consumers that *die* (send raises) and consumers that *stall* without
closing: each connection has a send timeout (``send_timeout``), and a
subscriber whose TCP buffer stays full past it is disconnected — its
stream is mid-frame at that point, so resuming is impossible and the drop
is the only consistent outcome (a blocking ``sendall`` here would stall
``stitch_cli``'s own stitching loop).
"""
from __future__ import annotations

import socket
import threading
from typing import Optional

import numpy as np

from .wire import Codec, FLAG_HAS_RGB, Kind, encode_frame, pack_points_i16mm


def valid_rows(pc):
    """A PointCloud's valid points (tensors on any device) as numpy
    (xyz [K, 3], rgb [K, 3] or None), with one device-to-host copy."""
    import torch
    rows = pc.xyz if pc.rgb is None else torch.cat([pc.xyz, pc.rgb], -1)
    rows = rows[pc.mask].cpu().numpy()
    return rows[:, :3], None if pc.rgb is None else rows[:, 3:]


class CloudPublisher:
    """TCP fan-out of stitched clouds. Thread-safe publish()."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 codec: Codec = Codec.ZLIB, send_timeout: float = 0.5):
        self.codec = codec
        self.send_timeout = send_timeout
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._seq = 0
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)

    def start(self) -> "CloudPublisher":
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            for c in self._conns:
                try:
                    c.close()
                except OSError:
                    pass
            self._conns.clear()

    @property
    def num_subscribers(self) -> int:
        with self._lock:
            return len(self._conns)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # bound every send: a stalled subscriber (full TCP buffer) makes
            # sendall raise socket.timeout after this long and gets dropped
            conn.settimeout(self.send_timeout)
            with self._lock:
                self._conns.append(conn)

    def publish_cloud(self, pc) -> int:
        """Publish a PointCloud's valid points (``valid_rows``). Returns
        #consumers that received the frame (slow/dead ones are dropped)."""
        return self.publish(*valid_rows(pc))

    def publish(self, xyz: np.ndarray, rgb: Optional[np.ndarray] = None
                ) -> int:
        payload = pack_points_i16mm(xyz, rgb)
        frame = encode_frame(payload, Kind.POINTS_I16MM, self.codec,
                             self._seq,
                             flags=FLAG_HAS_RGB if rgb is not None else 0)
        self._seq += 1
        dead = []
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.sendall(frame)
            except OSError:
                dead.append(c)
        if dead:
            with self._lock:
                for c in dead:
                    try:
                        c.close()
                    except OSError:
                        pass
                    if c in self._conns:
                        self._conns.remove(c)
        return len(conns) - len(dead)
