"""Process-group initialization for rigs that span processes and machines.

Port of ``pointcloud_stitching_tpu/parallel/multihost.py``. PyTorch's
counterpart of a multi-host JAX program is one process per device, each a
rank of one ``torch.distributed`` process group: each capture host runs
its own ingest and feeds its own ranks, and only fused, downsampled clouds
cross between them (the sharded stitch's all_gather). One call per process:

    from pointcloud_stitching_tpu_torch.parallel import (init_multihost,
                                                         make_mesh)
    init_multihost(coordinator="10.0.0.1:9999", num_processes=8,
                   process_id=int(os.environ["RANK"]))
    mesh = make_mesh()          # now spans every process's device

Under ``torchrun --nproc-per-node N`` no argument is needed: the launcher's
environment (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``) names the group.
Without a coordinator or that environment the call does nothing and returns
False, so the same entry point works in one process and on a rig.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.platform import platform_device


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group when multi-process arguments are given.

    Args:
      coordinator: ``"host:port"`` of rank 0's rendezvous (a ``tcp://``
        init method), or an init-method URL (``file://...``). None reads
        torchrun's environment, and returns False when it is not set.
      num_processes, process_id: world size and this process's rank
        (default: ``WORLD_SIZE`` and ``RANK`` from the environment).
      backend: 'nccl' or 'gloo'; default NCCL when ``platform_device()``
        is a GPU, gloo on the CPU (``PCS_PLATFORM=cpu``). gloo with GPU
        ranks is how several ranks share one card (the collectives then
        copy through host memory; see ``parallel/collectives.py``).
      timeout: of every collective (PyTorch's default when None).

    Returns True when the group was initialized. A failure raises; the
    call never retries on another backend or device.
    """
    if coordinator is None and "MASTER_ADDR" not in os.environ:
        return False
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    init_method = ("env://" if coordinator is None
                   else coordinator if "://" in coordinator
                   else f"tcp://{coordinator}")
    dev = platform_device()
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        # NCCL binds each rank's communicator to its current device
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)
    return True
