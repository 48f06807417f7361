"""Peak device-memory meter, the km_stat analog (kalloc.c:218-224).

The port of ``miniwfa_tpu/utils/hbm.py``.  The reference's arena allocator
reports its capacity and used bytes through ``km_stat``; here PyTorch's
caching allocator owns the card's memory, so the meter tracks the bytes
each device dispatch holds: every ``note()`` records one dispatch's buffer
footprint and the module keeps the peak and its tag.  A footprint is the
dispatch's inputs, its outputs and the scratch its launch allocates (K1's
and K2's planes sit in global memory on the card, not in VMEM as on the
TPU, and are the buffers that fill it), all of which exist at once while
the launch runs; so on a card the peak never exceeds
``torch.cuda.max_memory_allocated`` over the same window.

The sites, under the JAX package's tags:

* ``kernel mode= B= W= S_CAP=``: K1 and K4 (``ops/wavefront_kernel.py``
  ``launch`` on the card, ``wavefront_plain`` on the CPU);
* ``wide-planes mode= B= W= n_snap=``: each call of the wide engine K2
  (``ops/wavefront_wide.py`` ``wide``, once per ``run_chunked`` step);
* ``wide-out mode= B= W= S_CAP=``: a whole wide run's outputs
  (``models/exact.py`` ``_run_wide``);
* ``gaps mode= G= S_CAP=``: K3 (``ops/wavefront_gaps.py`` ``gaps``).

The JAX package's ``lax``, ``sharded-kernel`` and ``sharded-lax`` tags have
no counterpart: the port has no lax engine, and its sharded path
(``parallel/batch.py``) runs ``align_batch`` on each card, which notes as
above.  That path notes from one thread per card, so the peak is updated
under one lock.

``device_peak()`` also reads the allocator's own peak,
``torch.cuda.max_memory_allocated``, the largest over every visible card;
``reset()`` resets those counters too, so that both numbers cover the same
window.  Noting costs an integer compare under a lock: no device work, no
synchronisation.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

_LOCK = threading.Lock()
_peak: int = 0
_peak_tag: str = ""


def reset() -> None:
    """Forget the peak, and reset ``torch.cuda``'s peak-memory counters on
    every visible card (once CUDA is initialised: before that the
    allocator has no counters, and nothing was allocated)."""
    global _peak, _peak_tag
    with _LOCK:
        _peak = 0
        _peak_tag = ""
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)


def note(tag: str, nbytes: int) -> None:
    """Record one device dispatch's buffer footprint (bytes)."""
    global _peak, _peak_tag
    with _LOCK:
        if nbytes > _peak:
            _peak = int(nbytes)
            _peak_tag = tag


def note_arrays(tag: str, *bufs) -> int:
    """Sum the bytes of tensors and numpy arrays (None is skipped), record
    the sum and return it.

    A tensor counts ``numel() * element_size()``, a numpy array ``nbytes``.
    Only buffers on a device count: where any of them is a CUDA tensor,
    CPU tensors and numpy arrays (host memory) are left out.  A dispatch
    that holds no CUDA tensor, the plain versions' on the CPU, counts its
    CPU tensors and arrays, so that the meter means something there."""
    on_card = any(isinstance(v, torch.Tensor) and v.is_cuda for v in bufs)
    total = 0
    for v in bufs:
        if isinstance(v, torch.Tensor):
            if v.is_cuda or not on_card:
                total += v.numel() * v.element_size()
        elif isinstance(v, np.ndarray) and not on_card:
            total += v.nbytes
    note(tag, total)
    return total


def peak() -> Tuple[int, str]:
    """(peak dispatch bytes, tag of the peak dispatch) since reset()."""
    with _LOCK:
        return _peak, _peak_tag


def device_peak() -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` since reset(), the largest over
    the visible cards; None with no card, or where nothing was allocated."""
    if not torch.cuda.is_available():
        return None
    return max(torch.cuda.max_memory_allocated(i)
               for i in range(torch.cuda.device_count())) or None


def snapshot() -> dict:
    """One JSON-able report: the km_stat print."""
    b, tag = peak()
    out = {"peak_dispatch_bytes": b,
           "peak_dispatch_gb": round(b / 2**30, 3),
           "peak_dispatch": tag}
    dp = device_peak()
    if dp is not None:
        out["device_peak_bytes"] = dp
    return out
