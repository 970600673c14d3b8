"""Collectives over a 1-D ``DeviceMesh``: the port's counterparts of the
``jax.lax`` collectives that ``shard_map`` code calls.

  * ``all_gather``   -> ``lax.all_gather`` (stacked on a new leading axis)
  * ``all_reduce``   -> ``lax.psum`` / ``lax.pmin``
  * ``ring_shift``   -> ``lax.ppermute`` of ``[(i, (i + shift) % D)]``
  * ``shift_open``   -> ``lax.ppermute`` of ``[(i, i + shift)]``, no wrap:
    an edge rank receives zeros (ppermute's fill for an unmatched target)
  * ``broadcast``    -> a replicated ``device_put`` from rank 0

Every rank of the mesh calls each function with a tensor of the same shape
and dtype, in the same order, as under ``shard_map``. The process group's
backend decides the transport, never a failure: NCCL moves CUDA tensors
itself; a gloo group moves CPU tensors, and CUDA tensors through host
memory (gloo has no all_gather, send or recv for CUDA tensors), which is
how several ranks share one card (NCCL refuses two ranks on one device).
Bool tensors travel as uint8.

Each call counts, per operation, the payload bytes this rank received from
the other ranks (``BYTES``); inside ``timed()`` it also drains the device
before and after the collective and adds the host seconds in between to
``SECONDS``, so a run can tell what share of a step went to
communication.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist

# per operation: bytes received from other ranks, timed seconds
BYTES: collections.Counter = collections.Counter()
SECONDS: collections.Counter = collections.Counter()
_TIMED = [False]

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


def reset_traffic() -> None:
    BYTES.clear()
    SECONDS.clear()


@contextlib.contextmanager
def timed():
    """Time every collective inside the block (see the module docstring):
    the device is drained before and after each one, so the step slows."""
    _TIMED[0] = True
    try:
        yield
    finally:
        _TIMED[0] = False


def check_axis(mesh, axis: str) -> None:
    """The mesh must be 1-D and name ``axis`` (as a JAX mesh must hold the
    axis a shard_map names)."""
    if tuple(mesh.mesh_dim_names or ()) != (axis,):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} are not "
                         f"({axis!r},)")


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    w = x.to(torch.uint8) if x.dtype == torch.bool else x
    if w.is_cuda and _staged(group):
        w = w.cpu()
    return w.contiguous()


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.to(device=like.device, dtype=like.dtype)


@contextlib.contextmanager
def _account(op: str, nbytes: int, like: torch.Tensor):
    BYTES[op] += nbytes
    if not _TIMED[0]:
        yield
        return
    if like.is_cuda:
        torch.cuda.synchronize(like.device)
    t0 = time.perf_counter()
    yield
    if like.is_cuda:
        torch.cuda.synchronize(like.device)
    SECONDS[op] += time.perf_counter() - t0


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """[D, *x.shape]: every rank's ``x`` in rank order."""
    g, d = mesh.get_group(), mesh.size()
    with _account("all_gather", (d - 1) * _nbytes(x), x):
        w = _to_wire(x, g)
        parts = [torch.empty_like(w) for _ in range(d)]
        # the list form: PyTorch 2.11 and 2.13 both have it without a
        # deprecation (all_gather_into_tensor / all_gather_single differ)
        dist.all_gather(parts, w, group=g)
        return _from_wire(torch.stack(parts), x)


def all_reduce(x: torch.Tensor, op: str, mesh) -> torch.Tensor:
    """The elementwise 'sum' or 'min' of every rank's ``x`` (a new
    tensor; ``x`` is left as it was)."""
    if op not in _OPS:
        raise ValueError(f"unknown reduction {op!r}: want 'sum' or 'min'")
    g, d = mesh.get_group(), mesh.size()
    with _account("all_reduce", (d - 1) * _nbytes(x), x):
        w = _to_wire(x, g).clone()
        dist.all_reduce(w, op=_OPS[op], group=g)
        return _from_wire(w, x)


def broadcast(x: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (a new tensor)."""
    g, r = mesh.get_group(), mesh.get_local_rank()
    with _account("broadcast", 0 if r == src else _nbytes(x), x):
        w = _to_wire(x, g).clone()
        dist.broadcast(w, src=dist.get_global_rank(g, src), group=g)
        return _from_wire(w, x)


def _p2p(x: torch.Tensor, mesh, dst, src, tag: int) -> torch.Tensor:
    """Send ``x`` to mesh rank ``dst`` and receive from ``src`` (either
    None) in one batch; returns what arrived, zeros when ``src`` is None."""
    g = mesh.get_group()
    w = _to_wire(x, g)
    buf = torch.zeros_like(w)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, w, dist.get_global_rank(g, dst),
                              g, tag))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(g, src),
                              g, tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _from_wire(buf, x)


def ring_shift(x: torch.Tensor, mesh, shift: int = 1) -> torch.Tensor:
    """Rank i's ``x`` arrives at rank (i + shift) % D; returns what this
    rank received. One rank keeps its own (a copy: NCCL never sends to
    itself)."""
    d, r = mesh.size(), mesh.get_local_rank()
    if d == 1:
        return x.clone()
    with _account("ring_shift", _nbytes(x), x):
        # a tag per direction, so shifts both ways can never match
        return _p2p(x, mesh, (r + shift) % d, (r - shift) % d,
                    tag=0 if shift > 0 else 1)


def shift_open(x: torch.Tensor, mesh, shift: int) -> torch.Tensor:
    """Rank i's ``x`` arrives at rank i + shift where that rank exists;
    a rank with no sender (an edge of the line) gets zeros."""
    d, r = mesh.size(), mesh.get_local_rank()
    dst = r + shift if 0 <= r + shift < d else None
    src = r - shift if 0 <= r - shift < d else None
    with _account("shift_open", 0 if src is None else _nbytes(x), x):
        return _p2p(x, mesh, dst, src, tag=2 if shift > 0 else 3)


def local_rows(x, mesh):
    """This rank's equal share of the leading axis of every tensor in
    ``x`` (a tensor, a dataclass such as ``Intrinsics``, or a tuple, list
    or dict of them): the P(axis) placement of a JAX mesh. Other leaves
    pass through."""
    d, r = mesh.size(), mesh.get_local_rank()

    def rows(t: torch.Tensor) -> torch.Tensor:
        if t.dim() == 0 or t.shape[0] % d:
            raise ValueError(f"leading axis of {tuple(t.shape)} does not "
                             f"split over {d} ranks")
        n = t.shape[0] // d
        return t[r * n:(r + 1) * n]

    return tree_map(rows, x)


def tree_map(fn, x):
    """``fn`` on every tensor of ``x`` (tensor, dataclass, NamedTuple,
    tuple, list or dict); other leaves pass through."""
    if torch.is_tensor(x):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: tree_map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return x
