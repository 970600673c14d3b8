"""LZF codec: native (ctypes, native/lzf.cc) with the pure-Python codec of
``io/lzf.py`` as its fallback where no C++ toolchain exists.

LZF is what PCL compresses PCD ``DATA binary_compressed`` sections with.
The two encoders may choose different matches, so their streams can
differ byte for byte; each decodes the other's.
"""
from __future__ import annotations

import ctypes

from ..io import lzf as _py
from . import available, load


def compress(data: bytes, force_python: bool = False) -> bytes:
    """LZF-compress. Worst case grows by len/32 + O(1) (literal ctrl
    bytes), so output always fits in len + len//32 + 64."""
    if force_python or not available():
        return _py.compress(data)
    n = len(data)
    if n == 0:
        return b""
    cap = n + n // 32 + 64
    out = ctypes.create_string_buffer(cap)
    written = load().pcs_lzf_compress(data, n, out, cap)
    if written == 0:
        raise RuntimeError("LZF compression failed")
    return out.raw[:written]


def decompress(data: bytes, expected_size: int,
               force_python: bool = False) -> bytes:
    """Decompress an LZF stream whose decoded size is known (PCD headers
    carry it). Raises ValueError on corrupt input."""
    if expected_size == 0:
        if data:
            # the native path's overrun return (0) would equal
            # expected_size and accept the corrupt stream
            raise ValueError(
                "corrupt LZF stream: header says 0 decoded bytes but "
                f"the stream carries {len(data)}")
        return b""
    if force_python or not available():
        return _py.decompress(data, expected_size)
    out = ctypes.create_string_buffer(expected_size)
    written = load().pcs_lzf_decompress(data, len(data), out, expected_size)
    if written != expected_size:
        raise ValueError(
            f"corrupt LZF stream (decoded {written} of {expected_size} "
            "expected bytes)")
    return out.raw[:expected_size]
