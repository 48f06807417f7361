"""CIGAR walker over the wavefront kernel's traceback buffer, and the
low-mem mode's checkpoint chain.

Counterpart of ``miniwfa_tpu/ops/traceback_device.py::_build_walk``
(both layouts: K1's rows and K3's gaps, which the port stores alike as
``tb [B, S_CAP, W] uint8``): the O(n+s) backward walk of the reference's
wf_traceback (miniwfa.c:329-377), with byte ``(t, d - anc)`` holding the
transition into score t+1, so the multi-GB buffer never leaves the device
and only the runs come back.

Match runs are consumed a word at a time: the ``cpw`` characters ending
at the cursor, XOR of the two sides, leading zeros = equal characters.
DP steps decode the tb byte with the exact reference semantics
(state/ext bits, per-state score decrements, leading overhang; the host
walker models/traceback.py::traceback_walk is the specification).

Runs come out packed ``len<<4|op``, merged, in input order (oldest first)
from offset 0 of each lane's buffer; ops 1=I 2=D 7='=' 8='X' (htslib
packing, miniwfa.c:51-62).  ``walk_plain`` is the plain PyTorch version
(lanes in lockstep); ``walk`` launches ``csrc/walk.cu`` on a CUDA tensor,
in one of two variants (``pick_variant``): one warp per lane with the tb
and the word streams staged in shared memory, or one thread per lane.

``chain_ptrs`` is the low-mem mode's checkpoint chain (counterpart of
``_get_chain`` / ``chain_ptrs_on_device``, reference wf_traceback_seg,
miniwfa.c:528-549): the snapshot buffer stays on the device and only one
pointer per snapshot row and lane comes back, from ``mwf_chain_ptrs`` in
``csrc/walk.cu`` on a CUDA tensor, ``chain_ptrs_plain`` on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
from typing import List

import torch

from ..utils.launches import count_launch
from . import build

OP_I, OP_D, OP_EQ, OP_X = 1, 2, 7, 8
# per-lane walker inputs, int64 [B, M_N]
(M_ANC, M_TL, M_QL, M_S, M_LS, M_N) = range(6)
VARIANTS = ("warp", "thread")
# the thread variant takes dispatches whose longest side is at most this
# many characters (K3's gaps, <= 127 bp): their walks are a few dozen
# steps, less than a warp's tile and chunk copies (PERF.md §6, W1)
THREAD_MAX_CHARS = 256
# the warp variant's chunk of each word stream, in words (16 KB a half)
MAX_CHUNK = 4096


def run_cap(S_CAP: int) -> int:
    """Run-buffer capacity: each DP step lowers the score row by >= 1 and
    match runs interleave DP steps, so 2*S_CAP + 8 bounds the pushes."""
    return 2 * S_CAP + 8


def _chars_before(words, lane, top, cpw: int) -> torch.Tensor:
    """The ``cpw`` characters ending at char ``top`` (char ``top`` in the
    highest bits), int64 in [0, 2^32); characters below position 0 read
    as zeros."""
    bits = 32 // cpw
    start = top - cpw + 1
    pos = start.clamp(min=0)
    j = pos >> (4 if cpw == 16 else 2)
    sh = (pos & (cpw - 1)) * bits
    w0 = words[lane, j].long() & 0xFFFFFFFF
    w1 = words[lane, j + 1].long() & 0xFFFFFFFF
    w = ((w0 >> sh) | (w1 << (32 - sh))) & 0xFFFFFFFF
    return (w << ((-start).clamp(min=0) * bits)) & 0xFFFFFFFF


def walk_plain(tb: torch.Tensor, meta: torch.Tensor, tw: torch.Tensor,
               qw: torch.Tensor, cpw: int, pens) -> tuple:
    """Plain PyTorch version of the walker kernel: every lane walks in
    lockstep, one match word or one DP step per iteration (a finished
    lane's are no-ops, so whether any lane lives is asked every 8
    iterations: each ask waits for the device).  Returns
    (runs int32 [B, run_cap(S_CAP)] in input order, counts int32 [B];
    count -1 marks a run-buffer overflow)."""
    x, o1, e1, o2, e2 = pens
    dev = tb.device
    B, S_CAP, W = tb.shape
    CAP = run_cap(S_CAP)
    logb = 1 if cpw == 16 else 3
    rows = torch.arange(B, device=dev)
    anc, tl, ql = meta[:, M_ANC], meta[:, M_TL], meta[:, M_QL]
    i, k, srow = ql - 1, tl - 1, meta[:, M_S] - 1
    last = meta[:, M_LS].clone()
    buf = torch.zeros((B, CAP), dtype=torch.int64, device=dev)
    nout = torch.zeros(B, dtype=torch.int64, device=dev)
    over = torch.zeros(B, dtype=torch.bool, device=dev)

    def push(mask, op, ln):
        nonlocal nout, over
        m = mask & (ln > 0)
        prev = buf[rows, (nout - 1).clamp(min=0)]
        merge = m & (nout > 0) & ((prev & 0xF) == op)
        at = torch.where(merge, nout - 1, nout)
        val = torch.where(merge, (((prev >> 4) + ln) << 4) | op, (ln << 4) | op)
        ok = m & (at < CAP)
        at_ok = at.clamp(max=CAP - 1)
        buf[rows, at_ok] = torch.where(ok, val, buf[rows, at_ok])
        over = over | (m & ~ok)
        nout = torch.where(ok, at + 1, nout)

    for it in itertools.count():
        alive = (i >= 0) & (k >= 0)
        if it % 8 == 0 and not bool(alive.any()):
            break
        # backward match probe: one word of chars ending at (k, i)
        xr = _chars_before(tw, rows, k.clamp(min=0), cpw) \
            ^ _chars_before(qw, rows, i.clamp(min=0), cpw)
        clz = 32 - torch.frexp(torch.where(xr == 0, 1, xr).double())[1].long()
        run = torch.where(xr == 0, cpw, clz >> logb)
        run = torch.minimum(run, torch.minimum(k, i) + 1)
        matching = alive & (last == 0) & (run > 0)
        # DP-byte decode (reference miniwfa.c:341-366)
        col = ((i - k) - anc).clamp(0, W - 1)
        byte = tb[rows, srow.clamp(0, S_CAP - 1), col].long() & 0x7F
        state = torch.where(last == 0, byte & 7, last)
        ext = torch.where(state > 0, (byte >> (state + 2)) & 1, 0)
        is_x = state == 0
        is_ins = (state == 1) | (state == 3)
        pen1 = (state == 1) | (state == 2)
        dec = torch.where(is_x, x, torch.where(
            pen1, torch.where(ext == 1, e1, o1 + e1),
            torch.where(ext == 1, e2, o2 + e2)))
        op = torch.where(matching, OP_EQ, torch.where(
            is_x, OP_X, torch.where(is_ins, OP_I, OP_D)))
        ln = torch.where(matching, run, 1)
        di = torch.where(matching, run, (is_x | is_ins).long())
        dk = torch.where(matching, run, (is_x | ~is_ins).long())
        push(alive, op, ln)
        i = torch.where(alive, i - di, i)
        k = torch.where(alive, k - dk, k)
        srow = torch.where(alive & ~matching, srow - dec, srow)
        last = torch.where(alive, torch.where(
            matching, 0, torch.where((state > 0) & (ext == 1), state, 0)),
            last)
    # leading overhang (miniwfa.c:368-369)
    everyone = torch.ones(B, dtype=torch.bool, device=dev)
    push(everyone, OP_I, (i + 1).clamp(min=0))
    push(everyone, OP_D, (k + 1).clamp(min=0))
    # the runs were pushed newest first: reverse each lane's [0, nout)
    j = torch.arange(CAP, device=dev)
    buf = buf.gather(1, torch.where(j < nout[:, None], nout[:, None] - 1 - j,
                                    j))
    counts = torch.where(over, -1, nout)
    return buf.int(), counts.int()


def pick_variant(W: int, NW: int, cpw: int) -> str:
    """W1's variant for a dispatch, from its shapes: "thread" when the
    word streams' width (NW words, which bound each lane's tl and ql)
    holds at most THREAD_MAX_CHARS characters, or when W is no multiple
    of 16 (the warp variant's bulk copies move 16-byte rows); else
    "warp"."""
    if W % 16 or (NW - 2) * cpw <= THREAD_MAX_CHARS:
        return "thread"
    return "warp"


def _chunk(nw: int) -> int:
    """The warp variant's chunk: the streams' width rounded up to a power
    of 2, between 64 words (more than one warp step's 34) and
    MAX_CHUNK."""
    return min(MAX_CHUNK, max(64, 1 << max(nw - 1, 1).bit_length()))


def walk(tb: torch.Tensor, meta: torch.Tensor, tw: torch.Tensor,
         qw: torch.Tensor, cpw: int, pens, variant=None) -> tuple:
    """Walk every lane's traceback; outputs as ``walk_plain``.  CPU
    tensors take the plain version; CUDA tensors launch ``csrc/walk.cu``
    in ``variant`` ("warp" or "thread"; None: ``pick_variant``), and
    count the launch in ``walk.launches`` and by variant in
    ``walk.launches_by_variant``.  A refused launch raises."""
    B, S_CAP, W = tb.shape
    dev = tb.device
    if variant not in (None,) + VARIANTS:
        raise ValueError(f"walk variant must be None or one of {VARIANTS}, "
                         f"got {variant!r}")
    if tb.dtype != torch.uint8 or meta.dtype != torch.int64 \
            or tuple(meta.shape) != (B, M_N) or meta.device != dev:
        raise ValueError(f"walk wants tb uint8 [B, S_CAP, W] and meta int64 "
                         f"[B, {M_N}] on one device")
    for w in (tw, qw):
        if w.dtype != torch.int32 or w.dim() != 2 or w.shape[0] != B \
                or w.device != dev or not w.is_contiguous():
            raise ValueError("walk wants contiguous int32 [B, NW] word "
                             f"streams on {dev}")
    if tw.shape[1] != qw.shape[1]:
        raise ValueError("tw and qw must have the same word count")
    if dev.type == "cpu":
        return walk_plain(tb, meta, tw, qw, cpw, pens)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (tb.is_contiguous() and meta.is_contiguous()):
        raise ValueError("walk inputs must be contiguous")
    variant = variant or pick_variant(W, tw.shape[1], cpw)
    if variant == "warp" and W % 16:
        raise ValueError(f"the warp variant wants W a multiple of 16, got "
                         f"W={W}")
    CAP = run_cap(S_CAP)
    runs = torch.zeros((B, CAP), dtype=torch.int32, device=dev)
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0:
        return runs, counts
    ch = 0
    if variant == "warp":
        # bulk copies move 16-byte units: each lane's stream starts on one
        pad = -tw.shape[1] % 4
        if pad:
            tw = torch.nn.functional.pad(tw, (0, pad))
            qw = torch.nn.functional.pad(qw, (0, pad))
        ch = _chunk(tw.shape[1])
    fn = build.load("walk", "mwf_walk",
                    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p] + [ctypes.c_int] * 9
                    + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(tb.data_ptr(), S_CAP, W, meta.data_ptr(), tw.data_ptr(),
                qw.data_ptr(), tw.shape[1], runs.data_ptr(), CAP,
                counts.data_ptr(), B, cpw, *pens, int(variant == "warp"), ch,
                stream)
    if rc:
        raise RuntimeError(f"walk kernel ({variant}) launch failed: CUDA "
                           f"error {rc}")
    count_launch(walk, variant=variant, card=dev.index)
    return runs, counts


walk.launches = 0
walk.launches_by_variant = collections.Counter()
walk.launches_by_card = collections.Counter()


def _ptr_count(last_ptr, snap_cnt, dev) -> torch.Tensor:
    """``last_ptr`` and ``snap_cnt`` (numpy arrays or tensors) as one
    int64 [2, B] tensor on ``dev``: stacked where they lie, then one
    copy."""
    lp, cnt = torch.as_tensor(last_ptr), torch.as_tensor(snap_cnt)
    return torch.stack([lp.to(cnt.device, torch.int64),
                        cnt.long()]).to(dev)


def chain_ptrs_plain(snap: torch.Tensor, last_ptr, snap_cnt) -> tuple:
    """Plain PyTorch version of the chain kernel: one ``gather`` of B ints
    per snapshot row, newest to oldest.  Returns (final carry [B], recs
    [n_snap, B]) as int64 numpy arrays, as ``chain_ptrs``."""
    B, cap = snap.shape[:2]
    rows = snap.reshape(B, cap, -1)
    last, cnt = _ptr_count(last_ptr, snap_cnt, snap.device)
    recs = torch.empty((cap, B), dtype=torch.int64, device=snap.device)
    for i, c in enumerate(range(cap - 1, -1, -1)):
        live = c < cnt
        idx = last.clamp(0, rows.shape[2] - 1)[:, None]
        nxt = torch.gather(rows[:, c], 1, idx)[:, 0].long()
        recs[i] = torch.where(live, last, -3)
        last = torch.where(live, nxt, last)
    return last.cpu().numpy(), recs.cpu().numpy()


def chain_ptrs(snap: torch.Tensor, last_ptr, snap_cnt) -> tuple:
    """Pointer-jump PASS1 snapshot rows newest to oldest on the snapshot
    buffer's device: ``snap [B, n_snap, NP, W]`` int32 (K1's or the wide
    kernel's), ``last_ptr``/``snap_cnt`` [B] (numpy arrays or tensors).
    Returns (final carry [B], recs [n_snap, B]) as int64 numpy arrays,
    ``recs[i]`` the chain pointer AT row ``n_snap-1-i`` and -3 for rows
    past a lane's count.  CPU tensors take ``chain_ptrs_plain``; CUDA
    tensors launch ``mwf_chain_ptrs`` (one thread per lane), count the
    launch in ``chain_ptrs.launches``, and bring the result back in one
    copy."""
    if snap.dim() != 4 or snap.dtype != torch.int32:
        raise ValueError("chain_ptrs wants snap int32 [B, n_snap, NP, W]")
    dev = snap.device
    if dev.type == "cpu":
        return chain_ptrs_plain(snap, last_ptr, snap_cnt)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not snap.is_contiguous():
        raise ValueError("chain_ptrs wants a contiguous snapshot buffer")
    B, cap = snap.shape[:2]
    lp_cnt = _ptr_count(last_ptr, snap_cnt, dev)
    if tuple(lp_cnt.shape) != (2, B):
        raise ValueError(f"chain_ptrs wants last_ptr and snap_cnt of [{B}]")
    out = torch.empty((cap + 1, B), dtype=torch.int64, device=dev)
    if B:
        fn = build.load("walk", "mwf_chain_ptrs",
                        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(snap.data_ptr(), snap[0, 0].numel(), cap,
                    lp_cnt.data_ptr(), out.data_ptr(), B, stream)
        if rc:
            raise RuntimeError(f"chain_ptrs kernel launch failed: CUDA "
                               f"error {rc}")
        count_launch(chain_ptrs, card=dev.index)
    host = out.cpu().numpy()
    return host[0], host[1:]


chain_ptrs.launches = 0
chain_ptrs.launches_by_card = collections.Counter()


def to_cigars(runs: torch.Tensor, counts: torch.Tensor) -> List[List[int]]:
    """Per-lane packed CIGAR lists (the runs are in input order).  The
    runs come to the host in one copy, cut on the device to the largest
    count; each lane's list is a numpy slice's ``tolist``."""
    counts = counts.cpu().numpy()
    if (counts < 0).any():
        raise RuntimeError("CIGAR walker overflowed its run buffer — "
                           "corrupt traceback input")
    host = runs[:, :int(counts.max(initial=0))].cpu().numpy()
    return [host[b, :n].tolist() for b, n in enumerate(counts)]
