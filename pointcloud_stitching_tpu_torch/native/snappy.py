"""Python facade for the native snappy codec (ctypes).

API mirrors python-snappy: compress(bytes) -> bytes, decompress(bytes) ->
bytes. A copy of ``pointcloud_stitching_tpu/native/snappy.py`` over the
port's own build of ``native/snappy.cc``; wire-compatible with the
reference's snappy payloads.
"""
from __future__ import annotations

import ctypes

from . import load


def compress(data: bytes) -> bytes:
    lib = load()
    n = len(data)
    cap = lib.pcs_snappy_max_compressed_length(n)
    out = ctypes.create_string_buffer(cap)
    written = lib.pcs_snappy_compress(data, n, out)
    if written == 0 and n > 0:
        raise RuntimeError("snappy compression failed")
    return out.raw[:written]


def decompress(data: bytes) -> bytes:
    lib = load()
    n = len(data)
    ulen = lib.pcs_snappy_uncompressed_length(data, n)
    if ulen == ctypes.c_size_t(-1).value:
        raise ValueError("corrupt snappy stream (bad length preamble)")
    out = ctypes.create_string_buffer(max(ulen, 1))
    rc = lib.pcs_snappy_decompress(data, n, out, ulen)
    if rc != 0:
        raise ValueError(f"corrupt snappy stream (error {rc})")
    return out.raw[:ulen]
