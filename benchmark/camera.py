"""The camera generator: one process that serves every camera of the rig
over TCP with the port's wire protocol, each camera on its own clock.

A frozen copy of the pull protocol of ``runtime/fake_server.py``
(``FakeCameraServer``): listen, accept, then answer each 1-byte pull with
one frame (``u32 size | u8 kind | u8 codec | u8 flags | u8 0 | u32 seq |
u16 rows | u16 cols`` and the compressed body). What it adds is the
camera's clock: camera c captures frame k at ``t0 + (phase_c + k) /
fps`` whether or not anyone pulls it, and a pull gets the newest captured
frame not yet sent, or waits for the next capture. So the cameras do not
slow when the stitcher does (an open loop), and frames the stitcher does
not pull in time are never sent.

Run by ``stream.py`` as ``python3 benchmark/camera.py``. Standard input
carries one JSON line (``cameras``, ``fps``, ``phases``, ``sizes``: the
byte length of each camera's encoded frames) and then the frames, camera
by camera: frame v of a camera serves every seq with seq mod len(frames)
== v, its seq field patched at send. Standard output carries one JSON
line (``ports``, ``t0``) and then one line per sent frame: ``camera seq
capture_time send_time`` (``time.monotonic()`` seconds). The process ends
when its standard input closes.
"""
from __future__ import annotations

import json
import math
import os
import socket
import struct
import sys
import threading
import time

SEQ_OFFSET = 8   # the u32 seq field in the frame header
HEADER = 16


def serve(c: int, sock: socket.socket, frames: list[bytes], fps: float,
          phase: float, t0: float, out, lock: threading.Lock) -> None:
    period = 1.0 / fps
    last = -1
    while True:
        try:
            conn, _ = sock.accept()
        except OSError:
            return
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while conn.recv(1):
                now = time.monotonic()
                k = max(math.floor((now - t0) / period - phase), last + 1)
                t_cap = t0 + (phase + k) * period
                if t_cap > now:
                    time.sleep(t_cap - now)
                body = frames[k % len(frames)]
                head = bytearray(body[:HEADER])
                struct.pack_into("<I", head, SEQ_OFFSET, k & 0xFFFFFFFF)
                conn.sendall(head)
                conn.sendall(memoryview(body)[HEADER:])
                t_sent = time.monotonic()
                last = k
                with lock:
                    out.write(f"{c} {k} {t_cap:.6f} {t_sent:.6f}\n")
                    out.flush()
        except OSError:
            pass
        finally:
            conn.close()


def main() -> None:
    inp = sys.stdin.buffer
    spec = json.loads(inp.readline())
    frames = [[inp.read(n) for n in sizes] for sizes in spec["sizes"]]
    socks = []
    for _ in frames:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        socks.append(s)
    t0 = time.monotonic()
    lock = threading.Lock()
    out = sys.stdout
    with lock:
        out.write(json.dumps({"ports": [s.getsockname()[1] for s in socks],
                              "t0": t0}) + "\n")
        out.flush()
    for c, s in enumerate(socks):
        threading.Thread(target=serve, daemon=True,
                         args=(c, s, frames[c], spec["fps"],
                               spec["phases"][c], t0, out, lock)).start()
    inp.read()          # until the benchmark closes our input
    os._exit(0)


if __name__ == "__main__":
    main()
