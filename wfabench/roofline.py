"""The roofline: peaks of the card and the operations and bytes of a
wavefront kernel, kept with the benchmark (frozen from ``chip_smoke.py``
of the repository, whose copies a later change may edit).

Peaks of one NVIDIA H100 SXM at its 700 W limit: HBM 3.35e12 B/s (the
data sheet); int32 operations 132 SMs x 64 INT32 lanes x 1.98 GHz boost
= 1.6727e13 /s (NVIDIA's Hopper white paper: derived from the SM count
and the boost clock, not a published rate).  A card set below 700 W
reaches less; the run's line carries the card's name and PERF.md its
power limit.

Operations per wavefront cell, counted in the kernels' transition code:
SCORE 20 (the 5-state recurrence's max, +1 and compare-selects, 19, and
the extension probe, 1); TB adds 14 for the traceback byte; PASS1 adds 9
for the pointer choice.  The cells are the ones the inputs need: the
reference's n_iter of each pair (for pass 1, the pair's score-mode
n_iter), never the program's buckets or re-run rungs, so the count is the
same whatever implements the kernel.  Bytes: each input read once (the
2-bit packed sequences, the lane's inputs), each output written once
(the per-lane outputs; a traceback byte per needed cell and a band row
per score in TB; the checkpoint list in pass 2).  PASS1's snapshot rows
are not counted: its operations bound it by far.
"""

from __future__ import annotations

from typing import Optional, Sequence

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_SCORE, OPS_TB, OPS_PASS1 = 20, 14, 9
LANE_IN, LANE_OUT = 6 * 8, 10 * 8     # int64 [L_N] in, [O_N] out

OPS = {"score": OPS_SCORE, "tb": OPS_SCORE + OPS_TB,
       "seg": OPS_SCORE + OPS_TB, "pass1": OPS_SCORE + OPS_PASS1}


def seq_bytes(tl: Sequence[int], ql: Sequence[int]) -> int:
    """Both sequences of every lane, 2 bits a base."""
    return sum(-(-(a + b) // 4) for a, b in zip(tl, ql))


def work(mode: str, cells: Sequence[int], tl: Sequence[int],
         ql: Sequence[int], s: Sequence[int], step: int = 0):
    """(operations, bytes) of one call's kernel work in ``mode`` (score,
    tb, seg, pass1) over lanes of ``cells`` needed cells."""
    ops = sum(cells) * OPS[mode]
    nbytes = seq_bytes(tl, ql) + len(cells) * (LANE_IN + LANE_OUT)
    if mode in ("tb", "seg"):
        nbytes += sum(cells) + 8 * sum(s)
    if mode == "seg":
        nbytes += 16 * sum(v // step for v in s)
    return ops, nbytes


def bound_s(ops: int, nbytes: int) -> float:
    """The least time the card could take: the larger of the operations
    over the int32 rate and the bytes over the memory rate."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def share(ops: int, nbytes: int, device_us: float) -> Optional[float]:
    """The roofline share in %, or None with no device time."""
    if device_us <= 0:
        return None
    return 100.0 * bound_s(ops, nbytes) / (device_us / 1e6)


# device kernels by name prefix (csrc/wavefront.cu, wavefront_wide.cu,
# walk.cu of the program)
K1 = ("wavefront_kernel",)
K2 = ("wide_tiled", "wide_cycle")
W1 = ("walk_warp_kernel", "walk_thread_kernel")
W2 = ("chain_kernel",)


def stretch_share(rec: dict, prefixes: Sequence[str], mode: str,
                  cells_key: str = "n_iter") -> Optional[float]:
    """A kernel's roofline share over the traced stretch: the bound of
    the stretch's calls (each the reference's cells for the pool) over
    the kernel's device time there."""
    from . import trace
    st = rec["stretch"]
    n = len(st["calls"])
    cells = (rec["ref"] or {}).get(cells_key)
    if not n or not cells:
        return None
    us = trace.device_time(st["events"], prefixes)
    ops, nbytes = work(mode, cells, rec["tl"], rec["ql"], rec["ref"]["s"],
                       rec["step"])
    return share(ops * n, nbytes * n, us)
