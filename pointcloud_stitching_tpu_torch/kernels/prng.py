"""The random draws' two kernels: JAX's threefry2x32 stream and XLA's scan.

``utils/prng.py`` gives the port ``jax.random``'s numbers. Its counters go
through ``threefry2x32`` (JAX's partitionable counters: the flat index
``i`` as the pair ``(i >> 32, i & 0xFFFFFFFF)``), and ``choice`` sums its
probabilities with ``scan16``, the order in which XLA's CPU backend
computes ``jnp.cumsum`` of float32. For a CUDA tensor both launch the
kernels of ``csrc/prng.cu``; for a CPU tensor, or with ``impl="torch"``,
they run the plain versions below. Kernel and plain version agree bit for
bit: threefry is integer arithmetic, and the scan does the same float32
adds in the same order.

Keys and bits are int64 tensors whose values lie below 2^32 (JAX's uint32
words): PyTorch's uint32 has no shifts on CUDA.
"""
from __future__ import annotations

import torch

from .build import LAUNCHES, check, library, stream_handle, use_kernel

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_BASE = 16          # XLA's CPU cumsum: blocks of 16, scanned recursively


def _threefry2x32_plain(key: torch.Tensor, n: int, pairs: bool):
    """Plain version: the hash of counters 0 .. n-1 with int64 torch ops."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = ((i >> 32) + k0) & _M32
    x1 = ((i & _M32) + k1) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return torch.stack([x0, x1], dim=1) if pairs else x0 ^ x1


def threefry2x32(key: torch.Tensor, n: int, pairs: bool = False,
                 impl: str = "auto") -> torch.Tensor:
    """threefry2x32 of ``key`` over the counters 0 .. n-1.

    Args:
      key: int64 [2], the key's two words (each below 2^32).
      n: the number of counters.
      pairs: False gives ``x0 ^ x1`` [n] (``jax.random.bits`` at 32
        bits); True gives ``(x0, x1)`` [n, 2] (``jax.random.split``).
      impl: 'auto' launches the CUDA kernel for a CUDA key and takes the
        plain version for a CPU key; 'cuda' and 'torch' force one.

    Returns int64 words below 2^32, on the key's device.
    """
    if key.dtype != torch.int64 or tuple(key.shape) != (2,):
        raise ValueError(f"key: want int64 [2], got {key.dtype} "
                         f"{tuple(key.shape)}")
    n = int(n)
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if not use_kernel(impl, key):
        return _threefry2x32_plain(key, n, pairs)

    key = key.contiguous()
    out = torch.empty((n, 2) if pairs else (n,), dtype=torch.int64,
                      device=key.device)
    if n == 0:
        return out
    with torch.cuda.device(key.device):
        err = library().pcs_threefry2x32(key.data_ptr(), n, int(pairs),
                                         out.data_ptr(), stream_handle(key))
    check(err, "threefry2x32")
    LAUNCHES["threefry2x32"] += 1
    return out


def _scan16_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the blocked scan with torch ops, one float32 add at
    a time (a column of every block per add)."""
    n = x.shape[0]
    nb = -(-n // _BASE)
    blocks = torch.zeros((nb, _BASE), dtype=torch.float32, device=x.device)
    blocks.view(-1)[:n] = x
    cols = [blocks[:, 0]]
    for j in range(1, _BASE):
        cols.append(cols[-1] + blocks[:, j])
    inner = torch.stack(cols, dim=1)
    if nb > 1:
        prefix = _scan16_plain(inner[:, -1])
        inner = torch.cat([inner[:1], prefix[:-1, None] + inner[1:]])
    return inner.reshape(-1)[:n]


def scan16(x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Inclusive prefix sum of float32 ``x`` [n], bit for bit as XLA's CPU
    backend computes ``jnp.cumsum``: each block of 16 summed in sequence,
    the block totals scanned the same way (recursively), and every element
    of block b >= 1 given ``prefix[b - 1] + inner``.

    ``impl`` as for ``threefry2x32``. Returns float32 [n] on x's device.
    """
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError(f"x: want float32 [n], got {x.dtype} "
                         f"{tuple(x.shape)}")
    n = x.shape[0]
    if n == 0:
        return x.clone()
    if not use_kernel(impl, x):
        return _scan16_plain(x)

    x = x.contiguous()
    lib = library()
    out = torch.empty_like(x)
    scratch = torch.empty((max(lib.pcs_scan16_scratch(n), 1),),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.pcs_scan16(x.data_ptr(), n, out.data_ptr(),
                             scratch.data_ptr(), stream_handle(x))
    check(err, "scan16")
    LAUNCHES["scan16"] += 1
    return out
