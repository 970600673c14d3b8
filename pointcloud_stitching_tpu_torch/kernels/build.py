"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` are compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, into ``_build/<hash of sources and flags>/``
inside the package, so a fresh checkout builds everything on its first
kernel launch and later processes load the cached library.

Every kernel wrapper in this package routes through ``use_kernel`` and
counts its launches in ``LAUNCHES``, so a run can show that the main path
went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("segment_reduce.cu", "nn.cu", "patch_gather.cu", "prng.cu",
           "map_color.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libpcs_kernels.so"

# launches per wrapper (one per wrapper call that launched its kernels)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def use_kernel(impl: str, t: torch.Tensor) -> bool:
    """True when a wrapper must launch its CUDA kernel for tensor ``t``.

    'torch' always takes the plain PyTorch version; 'auto' launches for a
    CUDA tensor and takes the plain version for a CPU tensor; 'cuda'
    launches and refuses a CPU tensor.
    """
    if impl == "torch":
        return False
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown kernel_impl {impl!r}")
    if t.is_cuda:
        return True
    if impl == "cuda":
        raise ValueError("kernel_impl='cuda' needs CUDA tensors, got a "
                         f"tensor on {t.device}")
    return False


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float      # wall time of the nvcc runs; 0.0 when cached
    log: str            # nvcc's output, including ptxas -v resource usage
    cached: bool


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    return "nvcc"


def _key() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernels unless a library for these sources exists."""
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib, 0.0, log, cached=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    tmp_dir = tempfile.mkdtemp(dir=out_dir)
    objs = [os.path.join(tmp_dir, Path(s).stem + ".o") for s in SOURCES]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    cmds.append([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds[:-1]]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, o) for c, o, p in zip(cmds, outs, procs) if p.returncode]
    if not failed:
        proc = subprocess.run(cmds[-1], capture_output=True, text=True)
        outs.append(proc.stdout + proc.stderr)
        if proc.returncode:
            failed = [(cmds[-1], outs[-1])]
    seconds = time.perf_counter() - t0
    log = "".join(outs)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    if failed:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(c)}\n{o}" for c, o in failed))
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, log, cached=False)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes; each returns a cudaError_t as int
_SIGNATURES = {
    # img, h, w, v0, u0, iv, iu, nb, out, stream
    "pcs_patch_gather": (_P, _I, _I, _P, _P, _P, _P, _I, _P, _P),
    # xyz, mask(u8), color(u8), ext, fx, fy, ppx, ppy, coeffs,
    # model_ids(i32, or null), model, ncam, n, hc, wc, rgb, stream
    "pcs_map_color": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L,
                      _I, _I, _P, _P),
    # vals, flags(u8), n, ch, capacity, out, epoch, hint(u64), status(i32),
    # cstat(u64), xbuf(f64), abuf(f64), stream
    "pcs_segsum_flags": (_P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P),
    # skey(i32), perm(i64), off(i32), col(i32, or null), dims(i32), n,
    # capacity, out, epoch, hint(u64), status(i32), cstat(u64), xbuf(f64),
    # abuf(f64), stream
    "pcs_segsum_packed": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P,
                          _P, _P),
    # xyz, mask(u8), rgb (or null), inv, min_ijk(i32), dims(i32), n, key,
    # off, col (or null), stream
    "pcs_voxel_pack": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P),
    # vals, seg(i32), n, ch, capacity, out, state(i32), xbuf(f64),
    # abuf(f64), stream
    "pcs_segsum_sorted": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P),
    # query, refT, b, n, m, splits, idx, d2, stream
    "pcs_nn_batched": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    # query, refT, jlo, jhi, b, n, m, query_tile, ref_block, chunk,
    # blocks_per_sm, idx, d2, keys(u64), meta(i32), stream
    "pcs_nn_batched_ranged": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                              _P, _P, _P, _P),
    # key(i64), n, pairs, out(i64), stream
    "pcs_threefry2x32": (_P, _L, _I, _P, _P),
    # x, n, out, scratch, stream
    "pcs_scan16": (_P, _L, _P, _P, _P),
}

_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        # launch shapes, for a run to print and to hold against the
        # Python side's constants: name -> number of int arguments
        for name, nargs in (("pcs_segsum_sorted_tile_rows", 0),
                            ("pcs_segsum_sorted_threads", 0),
                            ("pcs_segsum_sorted_smem", 1),
                            ("pcs_segsum_flags_grid", 3),
                            ("pcs_segsum_flags_tile_rows", 0),
                            ("pcs_segsum_flags_threads", 1),
                            ("pcs_segsum_flags_smem", 1),
                            ("pcs_nn_query_tile", 0),
                            ("pcs_nn_ranged_grid", 1)):
            getattr(lib, name).argtypes = [ctypes.c_int] * nargs
            getattr(lib, name).restype = ctypes.c_int
        lib.pcs_scan16_scratch.argtypes = [_L]
        lib.pcs_scan16_scratch.restype = _L
        lib.pcs_error_string.argtypes = [ctypes.c_int]
        lib.pcs_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = library().pcs_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle (the
    call PyTorch's generated kernels use: no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)

