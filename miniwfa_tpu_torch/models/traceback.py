"""Host-side sequential decoders: the CIGAR walk's specification and the
low-mem mode's checkpoint recovery.

``traceback_walk`` is a sequential O(n + s) pointer chase over a
traceback table fetched to the host.  The driver walks on the device
(ops/traceback_device.py); this walker is the reference its kernel and
plain version are held against.

``decode_checkpoints_ptrs`` turns the chain pointers of a PASS1 run
(ops/traceback_device.chain_ptrs) into ``(score, diagonal)`` checkpoints,
for the port's snapshot layout (ops/wavefront_kernel.snapshot_layout).

Traceback semantics replicate the reference walker exactly
(wf_traceback, miniwfa.c:329-377): the 7-bit byte per cell is
``extD2<<6|extI2<<5|extD1<<4|extI1<<3|fromState``; the ext bit decides
whether a gap step costs e or o+e; leading overhang is emitted as I/D.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..options import Options
from .. import cigar as C


def _check(cond: bool, msg: str) -> None:
    """Data-integrity check that survives ``python -O``."""
    if not cond:
        raise RuntimeError(msg)


def traceback_walk(
    opt: Options,
    tb_bits: np.ndarray,   # [n_rows, W] uint8; row r ↔ score r+1
    tb_lo: np.ndarray,     # [n_rows] int32; row band lo (anchor = lo - m1)
    m1: int,               # column offset of the anchor
    ts: bytes,
    qs: bytes,
    s_final: int,
    last_state: int,
) -> List[int]:
    """Walk the traceback table into a packed CIGAR (input order)."""
    tl, ql = len(ts), len(qs)
    i, k = ql - 1, tl - 1
    srow = s_final - 1
    last = int(last_state)
    cig: List[int] = []
    while i >= 0 and k >= 0:
        if last == 0:
            # consume exact matches (miniwfa.c:334-340)
            k0 = k
            while i >= 0 and k >= 0 and qs[i] == ts[k]:
                i -= 1
                k -= 1
            if k0 - k > 0:
                C.push(cig, C.OP_EQ, k0 - k)
            if i < 0 or k < 0:
                break
        _check(srow >= 0, "traceback ran past score 0")
        col = (i - k) - int(tb_lo[srow]) + m1
        x = int(tb_bits[srow, col])
        state = (x & 7) if last == 0 else last
        ext = ((x >> (state + 2)) & 1) if state > 0 else 0
        if state == 0:
            C.push(cig, C.OP_X, 1)
            i -= 1
            k -= 1
            srow -= opt.x
        elif state in (1, 3):
            C.push(cig, C.OP_I, 1)
            i -= 1
            srow -= (opt.e1 if ext else opt.o1 + opt.e1) if state == 1 \
                else (opt.e2 if ext else opt.o2 + opt.e2)
        elif state in (2, 4):
            C.push(cig, C.OP_D, 1)
            k -= 1
            srow -= (opt.e1 if ext else opt.o1 + opt.e1) if state == 2 \
                else (opt.e2 if ext else opt.o2 + opt.e2)
        else:
            raise RuntimeError(f"bad traceback state {state}")
        last = state if (state > 0 and ext) else 0
    # leading overhang (miniwfa.c:368-369)
    if i >= 0:
        C.push(cig, C.OP_I, i + 1)
    elif k >= 0:
        C.push(cig, C.OP_D, k + 1)
    cig.reverse()
    return cig


def ptr_to_seg(last: int, c: int, anc: int, spec) -> Tuple[int, int]:
    """(score, diagonal) of flat pointer ``last`` recorded at snapshot row
    ``c``: plane ``last // W`` is slot j of a ring of some depth, which at
    the snapshot's score ``snap_s = step*(c+1) - 1`` held score
    ``snap_s - ((snap_s - j) mod depth)``; the diagonal is ``anc + w``."""
    from ..ops import wavefront_kernel as wk

    p_h, p_e1, p_f1, p_e2, p_f2, _ = wk.snapshot_layout(spec)
    RH, RE1, RE2 = spec.rings
    p, w = divmod(last, spec.W)
    for p0, depth in ((p_f2, RE2), (p_e2, RE2), (p_f1, RE1), (p_e1, RE1),
                      (p_h, RH)):
        if p >= p0:
            break
    snap_s = spec.step * (c + 1) - 1
    return snap_s - (snap_s - (p - p0)) % depth, anc + w


def decode_checkpoints_ptrs(
    recs: np.ndarray,      # [cap] chain pointers, recs[i] at row cap-1-i
    last_fin: int,         # chain carry after the oldest row
    anc: int,
    snap_cnt: int,
    spec,                  # ops.wavefront_kernel.KSpec of the PASS1 run
) -> List[Tuple[int, int]]:
    """Checkpoints, oldest first, from one lane's chain pointers."""
    cap = recs.shape[0]
    _check(last_fin == -1, f"pointer chain did not reach origin: {last_fin}")
    segs: List[Tuple[int, int]] = []
    for c in range(snap_cnt - 1, -1, -1):
        last = int(recs[cap - 1 - c])
        _check(last >= 0, f"pointer chain broke at snapshot {c}: {last}")
        segs.append(ptr_to_seg(last, c, anc, spec))
    segs.reverse()
    return segs
