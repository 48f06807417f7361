"""Multi-process runs over ``torch.distributed`` with the gloo backend.

``init()`` joins the job's process group, ``global_mesh()`` builds the
1-D mesh over every process's devices in rank order, and
``align_batch_sharded`` (``parallel/batch.py``) runs over it.  Every
collective carries small host arrays (scores, cell counts, the failure
sentinels), so gloo serves on every device: NCCL would refuse two ranks
on one card.  Start the ranks as new processes (``subprocess``, or
``multiprocessing`` with the spawn method): a child forked from a process
that has used CUDA cannot use it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch.distributed as dist


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Join the job's gloo process group at ``tcp://<coordinator_address>``
    (``host:port``, where rank 0 listens).  Arguments not given come from
    ``MWF_COORDINATOR``, ``MWF_NUM_PROCESSES`` and ``MWF_PROCESS_ID``; a
    run of one process does nothing."""
    n = num_processes if num_processes is not None else int(
        os.environ.get("MWF_NUM_PROCESSES", "1"))
    if n <= 1 and coordinator_address is None:
        return
    addr = coordinator_address or os.environ.get("MWF_COORDINATOR")
    rank = process_id if process_id is not None else int(
        os.environ.get("MWF_PROCESS_ID", "-1"))
    if not addr or not 0 <= rank < n:
        raise ValueError(f"a job of {n} processes needs the coordinator's "
                         f"host:port and this process's rank in [0, {n}), "
                         f"got {addr!r} and {rank}")
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=n, rank=rank)


def process_index() -> int:
    """This process's rank in the job (0 outside one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The job's number of processes (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(devices: Optional[Sequence] = None):
    """The 1-D mesh over every device of the job: each process's
    ``devices`` (default: its visible CUDA devices), gathered in rank
    order."""
    from .mesh import Mesh, make_mesh
    local = make_mesh(devices)
    if process_count() == 1:
        return local
    every = [None] * process_count()
    dist.all_gather_object(every, list(local.entries))
    return Mesh(tuple(e for entries in every for e in entries))
