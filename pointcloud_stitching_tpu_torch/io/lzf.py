"""LZF codec in pure Python, for PCD ``DATA binary_compressed``.

Copy of the pure-Python codec in ``pointcloud_stitching_tpu/native/lzf.py``
(PCL's pcl::lzfCompress/lzfDecompress stream format). Byte-serial and
slow on large clouds, but exact: ``native/lzf.py`` (the ctypes codec) falls
back to it where no C++ toolchain exists.
"""
from __future__ import annotations

_MAX_LIT = 32     # ctrl 0..31 -> 1..32 literal bytes
_MAX_MATCH = 264  # 2 + 7 + 255
_MAX_OFF = 1 << 13


def compress(data: bytes) -> bytes:
    n = len(data)
    if n == 0:
        return b""
    out = bytearray()
    htab: dict = {}
    ip = 0
    lit_start = 0

    def flush(upto: int) -> None:
        s = lit_start
        while s < upto:
            run = min(upto - s, _MAX_LIT)
            out.append(run - 1)
            out.extend(data[s:s + run])
            s += run

    while ip + 2 < n:
        key = data[ip:ip + 3]
        ref = htab.get(key, -1)
        htab[key] = ip
        off = ip - ref - 1
        if ref >= 0 and off < _MAX_OFF:
            limit = min(n - ip, _MAX_MATCH)
            ln = 3
            while ln < limit and data[ref + ln] == data[ip + ln]:
                ln += 1
            flush(ip)
            l = ln - 2
            if l < 7:
                out.append((l << 5) | (off >> 8))
            else:
                out.append((7 << 5) | (off >> 8))
                out.append(l - 7)
            out.append(off & 0xFF)
            if ip + ln + 2 < n:
                htab[data[ip + 1:ip + 4]] = ip + 1
                htab[data[ip + 2:ip + 5]] = ip + 2
            ip += ln
            lit_start = ip
        else:
            ip += 1
    flush(n)
    return bytes(out)


def decompress(data: bytes, expected_size: int) -> bytes:
    out = bytearray(expected_size)
    ip, op, n = 0, 0, len(data)
    while ip < n:
        ctrl = data[ip]
        ip += 1
        if ctrl < 0x20:
            run = ctrl + 1
            if ip + run > n or op + run > expected_size:
                raise ValueError("corrupt LZF stream (literal overrun)")
            out[op:op + run] = data[ip:ip + run]
            ip += run
            op += run
        else:
            ln = ctrl >> 5
            if ln == 7:
                if ip >= n:
                    raise ValueError("corrupt LZF stream (len byte)")
                ln += data[ip]
                ip += 1
            ln += 2
            if ip >= n:
                raise ValueError("corrupt LZF stream (offset byte)")
            back = ((ctrl & 0x1F) << 8 | data[ip]) + 1
            ip += 1
            if back > op or op + ln > expected_size:
                raise ValueError("corrupt LZF stream (bad reference)")
            # byte-serial: overlapping references repeat the window
            for i in range(ln):
                out[op + i] = out[op - back + i]
            op += ln
    if op != expected_size:
        raise ValueError(
            f"LZF stream decodes to {op} bytes, header said "
            f"{expected_size}")
    return bytes(out)

