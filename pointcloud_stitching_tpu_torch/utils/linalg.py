"""Batched symmetric eigendecompositions of many small matrices.

PyTorch's CUDA ``eigh`` of small matrices calls cuSOLVER's batched syev,
which refuses large batches: on an H100 with CUDA 12.8 a batch of 16,385
3x3 matrices works and one of 32,767 raises
``CUSOLVER_STATUS_INVALID_VALUE`` (``scripts/profile_extras.py`` probes
16,384, 16,385, 32,767, 32,768 and 131,072), so the limit lies in
(16,385, 32,767]. The port's sweeps ask for one per point. These run it in batches of
``EIGH_BATCH``; each batch reads its status on the host (one sync).
"""
from __future__ import annotations

import torch

EIGH_BATCH = 16384


def eigh(a: torch.Tensor):
    """``torch.linalg.eigh`` of [B, n, n] in batches: (values ascending,
    vectors as columns)."""
    parts = [torch.linalg.eigh(a[i:i + EIGH_BATCH])
             for i in range(0, a.shape[0], EIGH_BATCH)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def eigvalsh(a: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.eigvalsh`` of [B, n, n] in batches (ascending)."""
    return torch.cat([torch.linalg.eigvalsh(a[i:i + EIGH_BATCH])
                      for i in range(0, a.shape[0], EIGH_BATCH)])
