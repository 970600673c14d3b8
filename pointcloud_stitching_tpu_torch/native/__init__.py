"""Native (C++) codecs of the port, loaded via ctypes.

The shared library is compiled with ``g++`` at first use from the repo's
own ``native/snappy.cc`` and ``native/lzf.cc`` (the sources the JAX package
builds from), into ``pointcloud_stitching_tpu_torch/_build/native-<hash>/``
— a directory named by a hash of the sources and flags, so an edited
source builds afresh and a stale library is never loaded. Build ahead of
time with ``python -m pointcloud_stitching_tpu_torch.native.build``.
Callers treat the library as optional where a fallback exists (LZF) and
raise where none does (the snappy wire codec).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG.parent / "native"
SOURCES = ("snappy.cc", "lzf.cc")
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libpcs_native.so"
_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Compile the library unless it exists; returns its path. Several
    processes may build at once: each links into a temporary file and
    renames it into place."""
    path = lib_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp,
                        *(str(SRC_DIR / s) for s in SOURCES)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_p, c_n = ctypes.c_char_p, ctypes.c_size_t
    sigs = {
        "pcs_snappy_max_compressed_length": (c_n, [c_n]),
        "pcs_snappy_compress": (c_n, [c_p, c_n, c_p]),
        "pcs_snappy_uncompressed_length": (c_n, [c_p, c_n]),
        "pcs_snappy_decompress": (ctypes.c_int, [c_p, c_n, c_p, c_n]),
        "pcs_lzf_compress": (c_n, [c_p, c_n, c_p, c_n]),
        "pcs_lzf_decompress": (c_n, [c_p, c_n, c_p, c_n]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def load() -> ctypes.CDLL:
    """Load the library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
    return _lib


def available() -> bool:
    """True when the library builds and loads here."""
    try:
        load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
