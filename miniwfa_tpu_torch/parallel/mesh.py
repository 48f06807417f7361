"""The device mesh: one data axis over devices, each entry owned by one
process.

The workload is a stream of independent pair alignments, so the mesh is
one axis: a batch's lanes are cut into even blocks, one per entry
(``parallel/batch.py``).  Entries may name the same device (several
entries of one card, or ``cpu``); the lanes of such entries run in one
call on that device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..models.exact import check_device
from .distributed import process_index


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``entries`` are (rank of the owning process, device),
    in lane-block order."""

    entries: Tuple[Tuple[int, torch.device], ...]

    @property
    def size(self) -> int:
        return len(self.entries)


def _physical(device) -> torch.device:
    """``device`` as the device it runs on: every CPU device is ``cpu``; a
    CUDA device without an index takes the current card's; a CUDA device
    with no card raises, as ``check_device`` does."""
    device = check_device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"{device}: only {torch.cuda.device_count()} CUDA "
                         f"device(s) are visible")
    return torch.device("cuda", index)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over this process's ``devices`` (default: every visible
    CUDA device; with no card that raises).  A list is taken as given,
    repeats included: ``["cpu"] * 8`` or ``["cuda:0"] * 4``."""
    if devices is None:
        check_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    rank = process_index()
    return Mesh(tuple((rank, _physical(d)) for d in devices))
