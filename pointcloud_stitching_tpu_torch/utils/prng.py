"""``jax.random``'s draws in PyTorch: the same key gives the same samples.

The JAX package draws its random numbers from JAX keys (plane RANSAC's
hypotheses in ``ops/sac.py``, ``register_global``'s random and FPFH starts
in ``models/registration.py``, and the CLIs' seeds). This module gives the
port the functions those call, under JAX's names and with JAX's semantics,
so that a seed picks the same plane and the same starts in both packages.

It follows the threefry2x32 PRNG of JAX 0.9.0 (``jax/_src/prng.py``,
``jax/_src/random.py``) in its **partitionable** form, JAX's default since
0.5 (``jax_threefry_partitionable``): element ``i`` of a draw hashes the
64-bit counter ``i`` as the pair ``(i >> 32, i & 0xFFFFFFFF)``; ``bits``
is ``x0 ^ x1`` of the hash, and ``split(key, n)`` is the pairs ``(x0, x1)``
of the counters 0 .. n-1.

A key is an int64 tensor of shape [2] holding JAX's two uint32 words
(``np.asarray(jax.random.key_data(k))``; ``utils.convert.key_from_jax``
carries one across). A function that is given data (``choice``'s ``p``,
``categorical``'s ``logits``) computes on the data's device, the key's 16
bytes moved there; the others compute on the key's device, as
``torch.randn`` does on its ``device=``. None makes a host sync. The hash
and ``choice``'s prefix sum run as the kernels of ``kernels/prng.py`` on
CUDA and as their plain versions on the CPU, bit for bit alike; ``impl``
('auto' | 'cuda' | 'torch') routes them as it does every kernel of the
port.

Bit for bit ``jax.random`` (on the CPU, where the JAX package's tests run
it): ``key``, ``split``, ``bits``, ``uniform``, ``randint`` and
``choice(p=...)``, whose cumulative sum is XLA's CPU order (``scan16``;
``torch.cumsum`` rounds elsewhere). ``normal`` goes through
``torch.erfinv``, which differs from XLA's ``erf_inv`` by up to ~5e-6
relative, and ``gumbel`` through ``torch.log``, a few ulps from XLA's; so
``categorical``'s argmax can differ from JAX's only on a near-tie.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..kernels.prng import scan16, threefry2x32

_M32 = 0xFFFFFFFF
_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1
_TINY = float(np.finfo(np.float32).tiny)
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _check_key(key) -> torch.Tensor:
    if isinstance(key, torch.Generator):
        raise TypeError("the port draws from a key, not a torch.Generator: "
                        "pass prng.key(seed) (or a key from prng.split)")
    if (not torch.is_tensor(key) or key.dtype != torch.int64
            or tuple(key.shape) != (2,)):
        raise TypeError("a key is an int64 tensor of shape [2] from "
                        f"prng.key(seed); got {key!r}")
    return key


def key_on(key: torch.Tensor, device) -> torch.Tensor:
    """``key`` checked and moved to ``device``, where the caller's data
    lies (a copy of 16 bytes; none if it is there already)."""
    return _check_key(key).to(device)


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def key(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed, as ``jax.random.key(seed)`` makes it.

    JAX runs in its default 32-bit mode (``jax_enable_x64`` off, as the
    JAX package does), where the seed becomes a 32-bit integer: the key is
    ``[0, seed mod 2^32]``, for negative seeds and seeds >= 2^32 too.
    """
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2,
          impl: str = "auto") -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys, int64 [num, 2]."""
    return threefry2x32(_check_key(key), num, pairs=True, impl=impl)


def bits(key: torch.Tensor, shape: Sequence[int] = (),
         impl: str = "auto") -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: int64 words below 2^32."""
    shape = _shape(shape)
    return threefry2x32(_check_key(key), math.prod(shape),
                        impl=impl).reshape(shape)


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0,
            impl: str = "auto") -> torch.Tensor:
    """``jax.random.uniform`` in float32 on ``[minval, maxval)``: the top 23
    bits ``m`` of each word as a mantissa in [1, 2), minus 1 (which is
    exactly ``m * 2^-23``), scaled."""
    m = bits(key, shape, impl=impl) >> 9
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    if span == 1.0 and lo == 0.0:
        # JAX's scale and max change nothing here; m < 2^23 converts and
        # scales exactly
        return m.to(torch.float32) * 2.0 ** -23
    # XLA fuses f * span + lo into one multiply-add, rounded once. In
    # float64 the product m * (span * 2^-23) is exact, so its sum rounds
    # alike on every device, fused or not; the float32 rounding of that
    # gives XLA's result.
    f = (m.double() * (float(span) * 2.0 ** -23) + float(lo)).float()
    return torch.clamp(f, min=float(lo))


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int, impl: str = "auto") -> torch.Tensor:
    """``jax.random.randint`` as int32 on ``[minval, maxval)``: two 32-bit
    draws from ``split(key)`` folded modulo the span in uint32
    arithmetic, as JAX does (biased where the span is not a power of 2)."""
    shape = _shape(shape)
    k1, k2 = split(key, impl=impl)
    hi, lo = bits(k1, shape, impl=impl), bits(k2, shape, impl=impl)
    out_of_range = int(maxval) > _I32_MAX
    minval = min(max(int(minval), _I32_MIN), _I32_MAX)
    maxval = min(max(int(maxval), _I32_MIN), _I32_MAX)
    span = (maxval - minval) & _M32
    if maxval <= minval:
        span = 1
    elif out_of_range:
        span = (span + 1) & _M32
    if span == 0:   # uint32 wrapped: x % 0 is x in XLA, the multiplier 0
        off = lo
    else:
        mult = (2 ** 16) % span
        mult = ((mult * mult) & _M32) % span
        off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
        off = off % span
    # minval + offset in int32, wrapping as JAX's int32 add does
    val = (off + minval) & _M32
    return torch.where(val > _I32_MAX, val - 2 ** 32, val).to(torch.int32)


def normal(key: torch.Tensor, shape: Sequence[int] = (),
           impl: str = "auto") -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` for u
    uniform on (-1, 1). ``torch.erfinv`` is within ~5e-6 relative of XLA's
    ``erf_inv``, so the samples are JAX's to that tolerance, not bitwise."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, impl=impl)
    return torch.erfinv(u) * _SQRT2


def gumbel(key: torch.Tensor, shape: Sequence[int] = (),
           impl: str = "auto") -> torch.Tensor:
    """``jax.random.gumbel`` (mode 'low') in float32: -log(-log(u)), u
    uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0, impl=impl)))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1,
                shape: Sequence[int] | None = None,
                impl: str = "auto") -> torch.Tensor:
    """``jax.random.categorical`` with replacement (the Gumbel-max trick):
    indices int64 of shape ``shape`` (default ``logits.shape[:-1]``), each
    the argmax over the last axis of gumbel noise plus ``logits``, on the
    logits' device. Only the last axis (JAX's default) is supported."""
    if axis not in (-1, logits.dim() - 1):
        raise ValueError("categorical: only axis=-1 is supported")
    batch = tuple(logits.shape[:-1])
    shape = batch if shape is None else _shape(shape)
    if len(shape) < len(batch) or shape[len(shape) - len(batch):] != batch:
        raise ValueError(f"shape {shape} does not end with the logits' "
                         f"batch shape {batch}")
    key = key_on(key, logits.device)
    g = gumbel(key, (*shape, logits.shape[-1]), impl=impl)
    logits = logits.to(torch.float32)
    return torch.argmax(g + logits, dim=-1)


def choice(key: torch.Tensor, n: int, shape: Sequence[int] = (),
           p: torch.Tensor | None = None,
           impl: str = "auto") -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=True, p=p)``: indices
    int64 of ``shape`` into ``range(n)``, on ``p``'s device, drawn with
    probabilities ``p`` [n] by inverting the cumulative sum:
    ``searchsorted(c, c[-1] * (1 - u), side='left')``, with ``c`` summed
    in XLA's CPU order. A ``p`` of all zeros gives index 0 everywhere, as
    JAX's does. Only the form with replacement and a given ``p`` is
    supported (the one the JAX package calls)."""
    _check_key(key)
    shape = _shape(shape)
    n = int(n)
    if p is None:
        raise ValueError("choice: only the form with p is supported")
    if n <= 0:
        raise ValueError("choice: n must be > 0")
    if tuple(p.shape) != (n,):
        raise ValueError(f"choice: p must have shape ({n},), got "
                         f"{tuple(p.shape)}")
    key = key_on(key, p.device)
    c = scan16(p.to(torch.float32), impl=impl)
    r = c[-1] * (1.0 - uniform(key, shape, impl=impl))
    return torch.searchsorted(c, r.reshape(-1)).reshape(shape)
