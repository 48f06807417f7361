"""Fused-cycle WFA engine: the whole ``while s += 1`` loop of a batch of
alignments, one lane per pair.

Counterpart of ``miniwfa_tpu/ops/wavefront_kernel.py`` (same semantics,
which mirror the reference lh3/miniwfa mwf_wfa_core, miniwfa.c:380-435,
including every '>=' tie-break of wf_next_tb, miniwfa.c:287-307), in
SCORE, TB and PASS1 modes, with the pass-2 checkpoint collapse.  Two
implementations of one algorithm:

* ``wavefront_plain`` — plain PyTorch, vectorised over lanes and over
  the union of the lanes' live bands; any device.  Its cycle loop,
  ``run_cycles``, runs from a ``PlainState`` to a cycle limit over planes
  in the kernels' layout (``new_planes``), so the wide engine's plain
  version (ops/wavefront_wide.py) resumes it across calls.
* ``csrc/wavefront.cu`` — the hand-written Hopper kernel, one
  thread-block cluster of C CTAs per lane (C from ``pick_cluster``, the
  largest whose clusters all fit on the card at once), one instantiation
  per mode.

``wavefront`` dispatches on the device of its inputs: CPU tensors run the
plain version, CUDA tensors launch the kernel (or raise).

State layout (both implementations).  Window slot ``w`` of a lane holds
diagonal ``anc + w``, ``w`` in ``[0, W)``; a band outgrowing the window
sets ``ovf_band`` and the host retries with a larger window.  Every state
kind keeps a ring of per-score planes one deeper than its largest
recurrence age (H: max(x, o1+e1, o2+e2); E1/F1: e1; E2/F2: e2), so the
planes of score t+1 are written while every source score stays intact —
the current "tops" are simply the ring slot of score t.  Ring reads are
masked by the band recorded for the source score (a registry of score
bands, the analog of the reference's per-slice [lo, hi],
miniwfa.c:67-137): a slot outside it reads as ``WF_NEG_INF`` whatever
stale value it holds, so no plane is ever cleared.  The shrink scan asks
of a slot whether its retired slice was viable at one of the scores
t-NS+2..t; one plane ``lastv`` answers it for any NS: one past the last
such score (0: never), set for every viable slot of the cycle's update
span, which holds every slot the shrink reads.

TB mode writes the 7-bit traceback byte of every in-band cell of the
transition into score t+1 at ``tb[lane, t, d - anc]`` (1 byte/cell, the
reference's density) and records that row's band ``[lo, hi]`` in
``bands[lane, t]``.

PASS1 mode (low-mem pass 1, reference mwf_wfa_seg, miniwfa.c:551-601)
keeps a pointer plane beside every value plane.  Score 0's H pointer at
d=0 is -1 (the chain's origin); every transition copies the pointer of
the source its tb bits chose.  When ``(t+1) % step == 0`` (after score t
is extended, before the transition into t+1) snapshot row
``c = (t+1)//step - 1`` receives every ring slot's in-band pointers, and
each slot is then reset, inside its score's band, to its own flat index
``plane*W + w``.  Snapshot rows are ``snap [B, n_snap, NP, W] int32``
with ``NP = RH + 2*RE1 + 2*RE2`` planes in the order H | E1 | F1 | E2 |
F2 (``snapshot_layout``); entries outside a slot's band stay
``WF_NEG_INF``.  A row ``>= n_snap`` stops the lane as a band overflow
(O_OVFB), as in the JAX kernel; the driver sizes the rows from S_CAP
(``S_CAP//step + 2``), so it never runs out of them.
Termination records the H pointer at the end diagonal as
``last_ptr``; ``snap_cnt`` counts the rows taken.

Checkpoint collapse (low-mem pass 2, miniwfa.c:413-416): ``segs int64
[B, seg_cap, 2]`` holds each lane's ``(score, diagonal)`` checkpoints in
score order, padded with score -1.  On the cycle whose score equals the
next checkpoint's, after termination and before band growth, the
committed band collapses to that one diagonal.
"""

from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..utils import hbm
from ..utils.launches import count_launch
from . import build

WF_NEG_INF = -0x40000000  # reference sentinel (miniwfa.c:67)
MODE_SCORE = 0
MODE_TB = 1
MODE_PASS1 = 2
_BIG = 0x3FFFFFFF

# per-lane inputs, int64 [B, L_N]: lengths, window anchor and the runtime
# early-stop bounds (miniwfa.c:422-425; 0 = unbounded)
(L_TL, L_QL, L_ANC, L_MS, L_MI, L_N) = range(6)
# per-lane outputs, int64 [B, O_N]; O_LP / O_SNC are PASS1's last pointer
# and snapshot count (WF_NEG_INF and 0 in the other modes)
(O_S, O_DONE, O_STOP, O_OVFB, O_OVFS, O_LS, O_NITER, O_LP, O_SNC,
 O_N) = range(10)


@dataclass(frozen=True)
class KSpec:
    """Static configuration of one wavefront dispatch."""

    W: int           # band window (diagonals)
    S_CAP: int       # cycle budget (tb rows)
    x: int
    o1: int
    e1: int
    o2: int
    e2: int
    mode: int = MODE_SCORE
    cpw: int = 16    # chars per packed word (16 = 2-bit ACGT, 4 = bytes)
    step: int = 0    # low-mem snapshot period (PASS1)
    n_snap: int = 0  # snapshot row capacity (PASS1)

    @property
    def NS(self) -> int:  # shrink scan depth = max_pen + 1 (miniwfa.c:390)
        return max(self.x, self.o1 + self.e1, self.o2 + self.e2) + 1

    @property
    def rings(self) -> Tuple[int, int, int]:
        """Ring depths (H, E1/F1, E2/F2): largest age + 1."""
        return (self.NS, max(self.e1, 1) + 1, max(self.e2, 1) + 1)


def snapshot_layout(spec: KSpec) -> Tuple[int, int, int, int, int, int]:
    """First plane of the H, E1, F1, E2 and F2 rings in a snapshot row
    (and in the kernel's planes buffer), and the plane count NP.  A flat
    pointer is ``plane*W + w``; models/traceback.ptr_to_seg inverts it."""
    RH, RE1, RE2 = spec.rings
    p_e1 = RH
    p_f1 = p_e1 + RE1
    p_e2 = p_f1 + RE1
    p_f2 = p_e2 + RE2
    return 0, p_e1, p_f1, p_e2, p_f2, p_f2 + RE2


def transition_values(src):
    """5-state dual-affine recurrence + 7-bit tb byte with the exact
    reference tie-breaks (wf_next_tb, miniwfa.c:287-307).  ``src`` maps
    the 9 source blocks (same-shape int64 tensors)."""
    bit08 = src["Ho1m"] < src["E1m"]
    e1 = torch.maximum(src["Ho1m"], src["E1m"])
    bit20 = src["Ho2m"] < src["E2m"]
    e2 = torch.maximum(src["Ho2m"], src["E2m"])
    ze = torch.where(e1 >= e2, 1, 3)
    e = torch.maximum(e1, e2)
    bit10 = src["Ho1p"] < src["F1p"]
    f1 = torch.maximum(src["Ho1p"], src["F1p"]) + 1
    bit40 = src["Ho2p"] < src["F2p"]
    f2 = torch.maximum(src["Ho2p"], src["F2p"]) + 1
    zf = torch.where(f1 >= f2, 2, 4)
    f = torch.maximum(f1, f2)
    z = torch.where(e >= f, ze, zf)
    h = torch.maximum(e, f)
    hx = src["Hx"] + 1
    z = torch.where(hx >= h, 0, z)
    H = torch.maximum(hx, h)
    bits = (bit08.long() << 3) | (bit10.long() << 4) \
        | (bit20.long() << 5) | (bit40.long() << 6) | z
    return H, e1, f1, e2, f2, bits


def _check_spec(spec: KSpec) -> None:
    if spec.mode not in (MODE_SCORE, MODE_TB, MODE_PASS1):
        raise ValueError(f"unsupported wavefront mode {spec.mode}")
    if spec.mode == MODE_PASS1 and (spec.step < 1 or spec.n_snap < 1):
        raise ValueError(f"PASS1 needs step >= 1 and n_snap >= 1, got "
                         f"step={spec.step} n_snap={spec.n_snap}")
    if spec.cpw not in (4, 16):
        raise ValueError(f"cpw must be 4 or 16, got {spec.cpw}")
    if spec.W < 1 or spec.S_CAP < 2:
        raise ValueError(f"bad window/cycle budget W={spec.W} "
                         f"S_CAP={spec.S_CAP}")


def _chars(words: torch.Tensor, lane, pos, cpw: int) -> torch.Tensor:
    """The ``cpw`` characters starting at char ``pos`` of each lane's
    word stream, as int64 in [0, 2^32) (funnel shift of two words)."""
    bits = 32 // cpw
    j = pos >> (4 if cpw == 16 else 2)
    sh = (pos & (cpw - 1)) * bits
    w0 = words[lane, j].long() & 0xFFFFFFFF
    w1 = words[lane, j + 1].long() & 0xFFFFFFFF
    return ((w0 >> sh) | (w1 << (32 - sh))) & 0xFFFFFFFF


def _ctz(x: torch.Tensor) -> torch.Tensor:
    """Trailing zero bits of positive int64 values (exact: frexp of a
    power of two)."""
    return torch.frexp((x & -x).double())[1].long() - 1


def _lcp(tw, qw, lane, pt, pq, cap, cpw: int) -> torch.Tensor:
    """Longest common prefix of t[pt:] and q[pq:], at most ``cap`` chars
    (the matrix edge: reference wf_extend1_padded, miniwfa.c:212-226)."""
    logb = 1 if cpw == 16 else 3
    adv = torch.zeros_like(cap)
    live = cap > 0
    while bool(live.any()):
        ix = live.nonzero(as_tuple=True)[0]
        a = adv[ix]
        x = _chars(tw, lane[ix], pt[ix] + a, cpw) \
            ^ _chars(qw, lane[ix], pq[ix] + a, cpw)
        hit = x != 0
        run = torch.where(hit, _ctz(torch.where(hit, x, 1)) >> logb, cpw)
        a = torch.minimum(a + run, cap[ix])
        adv[ix] = a
        live[ix] = ~hit & (a < cap[ix])
    return adv


def _span(lo, hi, mask, W: int) -> Optional[Tuple[int, int]]:
    """Union slot range [a, b) of the masked lanes' [lo, hi] (slots),
    clipped to the window; None when empty."""
    if not bool(mask.any()):
        return None
    a = max(int(lo[mask].min()), 0)
    b = min(int(hi[mask].max()) + 1, W)
    return (a, b) if a < b else None


def _block(plane, a: int, b: int, W: int) -> torch.Tensor:
    """Slots [a, b) of [B, W] planes as int64, WF_NEG_INF outside the
    window."""
    out = torch.full((plane.shape[0], b - a), WF_NEG_INF,
                     dtype=torch.int64, device=plane.device)
    lo, hi = max(a, 0), min(b, W)
    out[:, lo - a:hi - a] = plane[:, lo:hi]
    return out


def _snapshot(ptrs, snap, row: int, t: int, act, bnd, anc, W: int) -> None:
    """PASS1 snapshot of the ``act`` lanes into ``snap[:, row]``: every
    pointer ring slot's in-band entries, then each slot reset to its own
    flat index inside its score's band (miniwfa.c:585-587)."""
    RH = bnd.shape[1]
    plane = 0
    for ring in ptrs:
        depth = ring.shape[1]
        for j in range(depth):
            s_j = t - (t - j) % depth     # the score slot j holds
            if s_j >= 0:
                lo, hi = bnd[:, s_j % RH, 0], bnd[:, s_j % RH, 1]
                span = _span(lo - anc, hi - anc, act, W)
                if span:
                    a, b = span
                    sl = torch.arange(a, b, device=anc.device)
                    d = anc[:, None] + sl
                    m = act[:, None] & (d >= lo[:, None]) & (d <= hi[:, None])
                    cur = ring[:, j, a:b]
                    snap[:, row, plane, a:b] = torch.where(
                        m, cur, snap[:, row, plane, a:b])
                    ring[:, j, a:b] = torch.where(
                        m, (plane * W + sl).int(), cur)
            plane += 1


def plane_count(spec: KSpec) -> int:
    """Planes of one lane in the kernels' layout: the value rings (H | E1 |
    F1 | E2 | F2, as ``snapshot_layout``), PASS1's pointer rings laid out
    the same, then lastv."""
    NP = snapshot_layout(spec)[5]
    return NP * (2 if spec.mode == MODE_PASS1 else 1) + 1


def new_planes(spec: KSpec, lanes: torch.Tensor) -> torch.Tensor:
    """Fresh planes ``[B, plane_count, W] int32`` on the lanes' device:
    zeros, and the score-0 top at d=0 (H = -1, E1..F2 = WF_NEG_INF, and in
    PASS1 the same pointers, -1 being the chain's origin).  Any other ring
    entry is read only inside its score's recorded band, so its content
    never matters; lastv starts at 0 (never viable)."""
    B, W = lanes.shape[0], spec.W
    planes = torch.zeros((B, plane_count(spec), W), dtype=torch.int32,
                         device=lanes.device)
    s0 = -lanes[:, L_ANC]           # score-0 top: H[d=0] = -1 (miniwfa.c:119)
    has0 = (s0 >= 0) & (s0 < W)
    rows = torch.arange(B, device=lanes.device)[has0]
    s0 = s0[has0]
    lay = snapshot_layout(spec)
    for off in (0, lay[5]) if spec.mode == MODE_PASS1 else (0,):
        planes[rows, off, s0] = -1
        for p0 in lay[1:5]:
            planes[rows, off + p0, s0] = WF_NEG_INF
    return planes


class PlainState:
    """Where the plain version's cycle loop stands: the cycle ``t`` (one
    for all lanes), the per-lane scalars [B] (``t_lane``: the cycle after
    the lane's last, as a kernel that runs the lane alone keeps it) and
    the band registry ``bnd [B, RH, 2]`` (score s at s % RH; lo > hi is an
    empty band)."""

    def __init__(self, spec: KSpec, B: int, dev):
        def zeros(dtype=torch.int64):
            return torch.zeros(B, dtype=dtype, device=dev)

        self.t = 0
        self.wf_lo, self.wf_hi, self.t_lo, self.t_hi = \
            zeros(), zeros(), zeros(), zeros()
        self.done, self.stopped, self.ovf = zeros(bool), zeros(bool), \
            zeros(bool)
        self.final_s = torch.full((B,), -1, dtype=torch.int64, device=dev)
        self.last_ptr = torch.full((B,), WF_NEG_INF, dtype=torch.int64,
                                   device=dev)
        self.last_state, self.n_iter, self.snap_cnt, self.sid = \
            zeros(), zeros(), zeros(), zeros()
        self.t_lane = zeros()
        self.bnd = torch.zeros((B, spec.rings[0], 2), dtype=torch.int64,
                               device=dev)
        self.bnd[:, :, 0] = 1

    def outputs(self, S_CAP: int) -> torch.Tensor:
        """out int64 [B, O_N]; O_OVFS marks lanes alive at cycle S_CAP-1."""
        alive = ~(self.done | self.stopped | self.ovf)
        return torch.stack([self.final_s, self.done.long(),
                            self.stopped.long(), self.ovf.long(),
                            (alive & (self.t >= S_CAP - 1)).long(),
                            self.last_state, self.n_iter, self.last_ptr,
                            self.snap_cnt], 1)


def wavefront_plain(spec: KSpec, lanes: torch.Tensor, tw: torch.Tensor,
                    qw: torch.Tensor, segs: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the wavefront kernel (same algorithm, same
    outputs).  ``lanes`` int64 [B, L_N]; ``tw``/``qw`` int32 [B, NW] flat
    packed word streams (ops/pack.py); ``segs`` the optional checkpoints
    (module docstring).  Returns (out int64 [B, O_N], tb uint8 [B, S_CAP,
    W] or None, bands int32 [B, S_CAP, 2] or None, snap int32 [B, n_snap,
    NP, W] or None)."""
    _check_spec(spec)
    dev = lanes.device
    B, W = lanes.shape[0], spec.W
    tb = bands = snap = None
    if spec.mode == MODE_TB:
        tb = torch.zeros((B, spec.S_CAP, W), dtype=torch.uint8, device=dev)
        bands = torch.zeros((B, spec.S_CAP, 2), dtype=torch.int32,
                            device=dev)
    if spec.mode == MODE_PASS1:
        snap = torch.full((B, spec.n_snap, snapshot_layout(spec)[5], W),
                          WF_NEG_INF, dtype=torch.int32, device=dev)
    m = PlainState(spec, B, dev)
    planes = new_planes(spec, lanes)
    run_cycles(spec, m, planes, lanes, tw, qw, spec.S_CAP - 1, snap=snap,
               tb=tb, bands=bands, segs=segs)
    out = m.outputs(spec.S_CAP)
    _note(spec, lanes, tw, qw, segs, planes, out, tb, bands, snap)
    return out, tb, bands, snap


def _note(spec: KSpec, lanes: torch.Tensor, *bufs) -> None:
    """The peak-memory meter's note of one K1 or K4 dispatch: its inputs,
    planes and outputs (``utils/hbm.py``, tag ``kernel``)."""
    hbm.note_arrays(f"kernel mode={spec.mode} B={lanes.shape[0]} "
                    f"W={spec.W} S_CAP={spec.S_CAP}", lanes, *bufs)


def run_cycles(spec: KSpec, m: PlainState, planes: torch.Tensor,
               lanes: torch.Tensor, tw: torch.Tensor, qw: torch.Tensor,
               t_lim: int, snap=None, tb=None, bands=None, segs=None) -> None:
    """The plain version's cycle loop: run the lanes from ``m`` while
    ``m.t < t_lim``, updating ``m``, ``planes`` (``new_planes``' layout),
    and the snapshot rows, tb and bands in place.  A loop that stops at
    ``t_lim`` and one resumed from there equal one uninterrupted loop, and
    a lane's state and planes stay as they were from its end on."""
    dev = lanes.device
    B, W, NEG, NS = lanes.shape[0], spec.W, WF_NEG_INF, spec.NS
    RH, RE1, RE2 = spec.rings
    is_tb = spec.mode == MODE_TB
    is_p1 = spec.mode == MODE_PASS1
    ag_x, ag_o1, ag_o2 = spec.x, spec.o1 + spec.e1, spec.o2 + spec.e2
    tl, ql, anc = lanes[:, L_TL], lanes[:, L_QL], lanes[:, L_ANC]
    max_s, max_iter = lanes[:, L_MS], lanes[:, L_MI]
    d_end = ql - tl
    rows = torch.arange(B, device=dev)
    lay = snapshot_layout(spec)
    NP = lay[5]
    H, E1, F1, E2, F2 = (planes[:, p0:p0 + depth] for p0, depth in
                         zip(lay[:5], (RH, RE1, RE1, RE2, RE2)))
    ptrs = None
    if is_p1:
        ptrs = tuple(planes[:, NP + p0:NP + p0 + depth] for p0, depth in
                     zip(lay[:5], (RH, RE1, RE1, RE2, RE2)))
    lastv = planes[:, -1]

    def zeros(dtype=torch.int64):
        return torch.zeros(B, dtype=dtype, device=dev)

    t, bnd = m.t, m.bnd
    wf_lo, wf_hi, t_lo, t_hi = m.wf_lo, m.wf_hi, m.t_lo, m.t_hi
    done, stopped, ovf = m.done, m.stopped, m.ovf
    final_s, last_ptr, last_state = m.final_s, m.last_ptr, m.last_state
    n_iter, snap_cnt, sid, t_lane = m.n_iter, m.snap_cnt, m.sid, m.t_lane
    seg_cap = 0 if segs is None else segs.shape[1]
    while t < t_lim:
        run = ~(done | stopped | ovf)
        if not bool(run.any()):
            break
        rh = t % RH
        bnd[:, rh, 0] = torch.where(run, t_lo, bnd[:, rh, 0])
        bnd[:, rh, 1] = torch.where(run, t_hi, bnd[:, rh, 1])

        # --- 1. extension of the top band (miniwfa.c:400-411)
        term, zero = zeros(bool), zeros(bool)
        span = _span(t_lo - anc, t_hi - anc, run, W)
        if span:
            a, b = span
            d = anc[:, None] + torch.arange(a, b, device=dev)
            in_top = run[:, None] & (d >= t_lo[:, None]) & (d <= t_hi[:, None])
            k_old = H[:, rh, a:b].long()
            elig = in_top & (k_old >= -1) & (d + k_old >= -1) \
                & (k_old < tl[:, None]) & (d + k_old < ql[:, None])
            k_new = k_old.clone()
            li, si = elig.nonzero(as_tuple=True)
            if li.numel():
                k0, dd = k_old[li, si], d[li, si]
                cap = torch.minimum(tl[li] - 1 - k0, ql[li] - 1 - (dd + k0))
                k_new[li, si] = k0 + _lcp(tw, qw, li, k0 + 1, dd + k0 + 1,
                                          cap.clamp(min=0), spec.cpw)
            H[:, rh, a:b] = k_new.int()
            at_end = elig & (d == d_end[:, None]) & (k_new == (tl - 1)[:, None])
            term = at_end.any(1)
            zero = (at_end & (k_new == k_old)).any(1)

        # --- 2. termination (miniwfa.c:405-408, 577): last_state only on
        # a zero-extension termination; PASS1 records the end pointer
        zero_ext = term & zero & (t > 0)
        col = (d_end - anc).clamp(0, W - 1)
        if is_tb and t > 0:
            last_state = torch.where(zero_ext, tb[rows, t - 1, col].long() & 7,
                                     last_state)
        if is_p1:
            last_ptr = torch.where(term, ptrs[0][rows, rh, col].long(),
                                   last_ptr)
        done = done | term
        final_s = torch.where(term, t, final_s)

        # --- 2b. pass-2 checkpoint collapse (miniwfa.c:413-416)
        if seg_cap:
            cid = sid.clamp(max=seg_cap - 1)
            hit = run & ~term & (sid < seg_cap) & (segs[rows, cid, 0] == t)
            wf_lo = torch.where(hit, segs[rows, cid, 1], wf_lo)
            wf_hi = torch.where(hit, segs[rows, cid, 1], wf_hi)
            sid = sid + hit.long()

        # --- 3. band growth + window-overflow check (miniwfa.c:417-418)
        lo = torch.maximum(wf_lo - 1, -tl)
        hi = torch.minimum(wf_hi + 1, ql)
        ovf_now = run & ~term & ((lo < anc) | (hi > anc + W - 1))
        ovf = ovf | ovf_now
        act = run & ~term & ~ovf_now

        # --- 3b. PASS1 snapshot, after score t is extended and before the
        # transition into t+1 (miniwfa.c:585-587); a row past the
        # capacity stops the lane as a band overflow, as in the JAX kernel
        if is_p1 and (t + 1) % spec.step == 0:
            row = (t + 1) // spec.step - 1
            if row < spec.n_snap:
                _snapshot(ptrs, snap, row, t, act, bnd, anc, W)
                snap_cnt = snap_cnt + act.long()
            else:
                ovf = ovf | act
                act = zeros(bool)
        span = _span(torch.minimum(t_lo, lo) - anc,
                     torch.maximum(t_hi, hi) - anc, act, W)
        if span:
            a, b = span
            sl = torch.arange(a, b, device=dev)
            d = anc[:, None] + sl
            in_top = act[:, None] & (d >= t_lo[:, None]) & (d <= t_hi[:, None])
            in_new = act[:, None] & (d >= lo[:, None]) & (d <= hi[:, None])
            rE1, rE2 = t % RE1, t % RE2

            # --- 4. shrink viability of the retired score-t slice: its
            # viable slots (in the lane's top band) get lastv = t+1
            viab = torch.zeros_like(in_top)
            for v in (H[:, rh, a:b], E1[:, rE1, a:b], F1[:, rE1, a:b],
                      E2[:, rE2, a:b], F2[:, rE2, a:b]):
                v = v.long()
                viab |= (v >= -1) & (v < tl[:, None]) & (d + v >= -1) \
                    & (d + v < ql[:, None])
            lastv[:, a:b] = torch.where(viab & in_top, t + 1, lastv[:, a:b])

            # --- 5. transition into score t+1 (miniwfa.c:243-327)
            def src(ring, age):
                s_src = t + 1 - age
                if s_src < 0:
                    return torch.full((B, b - a + 2), NEG, dtype=torch.int64,
                                      device=dev)
                blk = _block(ring[:, s_src % ring.shape[1]], a - 1, b + 1, W)
                rb = bnd[:, s_src % RH]
                dd = anc[:, None] + torch.arange(a - 1, b + 1, device=dev)
                return torch.where((dd >= rb[:, 0:1]) & (dd <= rb[:, 1:2]),
                                   blk, NEG)

            ho1, ho2, hx = src(H, ag_o1), src(H, ag_o2), src(H, ag_x)
            e1b, f1b = src(E1, spec.e1), src(F1, spec.e1)
            e2b, f2b = src(E2, spec.e2), src(F2, spec.e2)
            new = transition_values(dict(
                Hx=hx[:, 1:-1], Ho1m=ho1[:, :-2], Ho1p=ho1[:, 2:],
                Ho2m=ho2[:, :-2], Ho2p=ho2[:, 2:], E1m=e1b[:, :-2],
                F1p=f1b[:, 2:], E2m=e2b[:, :-2], F2p=f2b[:, 2:]))
            def put(ring, v):
                # score t+1's slot in each lane's band; a slot is read
                # only inside its score's recorded band, so the rest of
                # the span (other lanes' bands) is left as it was
                slot = ring[:, (t + 1) % ring.shape[1], a:b]
                slot.copy_(torch.where(in_new, v, slot.long()))

            viable = torch.zeros_like(in_new)
            for ring, v in zip((H, E1, F1, E2, F2), new[:5]):
                put(ring, v)
                viable |= v >= -1
            viable &= in_new
            bits = new[5]
            if is_tb:
                tb[:, t, a:b] = torch.where(in_new, bits,
                                            tb[:, t, a:b].long()).to(torch.uint8)
                bands[act, t, 0] = lo[act].int()
                bands[act, t, 1] = hi[act].int()
            if is_p1:
                # each state copies the pointer of the source its tb bits
                # chose (reference wf_next_seg, miniwfa.c:495-523)
                pH, pE1, pF1, pE2, pF2 = ptrs
                ph1, ph2 = src(pH, ag_o1), src(pH, ag_o2)
                e1p = torch.where(bits & 0x08 != 0, src(pE1, spec.e1)[:, :-2],
                                  ph1[:, :-2])
                f1p = torch.where(bits & 0x10 != 0, src(pF1, spec.e1)[:, 2:],
                                  ph1[:, 2:])
                e2p = torch.where(bits & 0x20 != 0, src(pE2, spec.e2)[:, :-2],
                                  ph2[:, :-2])
                f2p = torch.where(bits & 0x40 != 0, src(pF2, spec.e2)[:, 2:],
                                  ph2[:, 2:])
                z = bits & 7
                hp = src(pH, ag_x)[:, 1:-1]
                for zi, v in ((1, e1p), (2, f1p), (3, e2p), (4, f2p)):
                    hp = torch.where(z == zi, v, hp)
                for ring, v in zip(ptrs, (hp, e1p, f1p, e2p, f2p)):
                    put(ring, v)
            # boundary commit (miniwfa.c:325-326)
            lo_ok = (viable & (d == lo[:, None])).any(1)
            hi_ok = (viable & (d == hi[:, None])).any(1)
            wf_lo = torch.where(act & lo_ok, lo, wf_lo)
            wf_hi = torch.where(act & hi_ok, hi, wf_hi)
        t_lo = torch.where(act, lo, t_lo)
        t_hi = torch.where(act, hi, t_hi)

        # --- 6. shrink every 256 cycles (miniwfa.c:420): good-diagonal hull
        # of the new tops and the retired slices of scores t..t-NS+2 (the
        # stale score t+1-NS slice is excluded): lastv >= t-NS+3
        if ((t + 1) & 0xFF) == 0:
            span = _span(wf_lo - anc, wf_hi - anc, act, W)
            if span:
                a, b = span
                d = anc[:, None] + torch.arange(a, b, device=dev)
                top = torch.zeros(d.shape, dtype=torch.bool, device=dev)
                for ring in (H, E1, F1, E2, F2):
                    top |= ring[:, (t + 1) % ring.shape[1], a:b] >= -1
                good = (top & (d >= t_lo[:, None]) & (d <= t_hi[:, None])) \
                    | (lastv[:, a:b] >= max(t - NS + 3, 1))
                good &= act[:, None] & (d >= wf_lo[:, None]) \
                    & (d <= wf_hi[:, None])
                has = good.any(1)
                wf_lo = torch.where(has, torch.where(good, d, _BIG).min(1)[0],
                                    wf_lo)
                wf_hi = torch.where(has, torch.where(good, d, -_BIG).max(1)[0],
                                    wf_hi)

        # --- 7. accounting + early stop (miniwfa.c:421-425): n_iter adds
        # the grown width on transition cycles only
        n_iter = n_iter + torch.where(act, hi - lo + 1, 0)
        stop = ((max_iter > 0) & (n_iter > max_iter)) \
            | ((max_s > 0) & (t + 1 > max_s))
        stopped = stopped | (act & stop)
        t_lane = torch.where(run, t + 1, t_lane)
        t += 1
    m.t, m.wf_lo, m.wf_hi, m.t_lo, m.t_hi = t, wf_lo, wf_hi, t_lo, t_hi
    m.done, m.stopped, m.ovf = done, stopped, ovf
    m.final_s, m.last_ptr, m.last_state = final_s, last_ptr, last_state
    m.n_iter, m.snap_cnt, m.sid, m.t_lane = n_iter, snap_cnt, sid, t_lane


def _check_inputs(spec: KSpec, lanes, tw, qw, segs) -> None:
    dev = lanes.device
    if lanes.dtype != torch.int64 or lanes.dim() != 2 \
            or lanes.shape[1] != L_N:
        raise ValueError(f"lanes must be int64 [B, {L_N}]")
    for name, w in (("tw", tw), ("qw", qw)):
        if w.dtype != torch.int32 or w.dim() != 2 \
                or w.shape[0] != lanes.shape[0] or w.device != dev:
            raise ValueError(f"{name} must be int32 [B, NW] on {dev}")
    if not (lanes.is_contiguous() and tw.is_contiguous()
            and qw.is_contiguous()):
        raise ValueError("wavefront inputs must be contiguous")
    if tw.shape[1] != qw.shape[1]:
        raise ValueError("tw and qw must have the same word count")
    longest = int(lanes[:, :L_ANC].max()) if lanes.shape[0] else 0
    if tw.shape[1] < longest // spec.cpw + 2:
        raise ValueError("word streams shorter than the sequences")
    if segs is not None and (
            segs.dtype != torch.int64 or segs.dim() != 3
            or segs.shape[0] != lanes.shape[0] or segs.shape[2] != 2
            or segs.device != dev or not segs.is_contiguous()):
        raise ValueError(f"segs must be contiguous int64 [B, seg_cap, 2] "
                         f"on {dev}")


def launch_mode(spec: KSpec, segs) -> str:
    """The name a launch is counted under in ``wavefront.launches_by_mode``."""
    name = {MODE_SCORE: "SCORE", MODE_TB: "TB", MODE_PASS1: "PASS1"}[spec.mode]
    return name + "+seg" if segs is not None and segs.shape[1] else name


CLUSTERS = (16, 8, 4, 2)   # CTAs per lane K1 is launched at, largest first


def pick_cluster(B: int, counts) -> int:
    """CTAs per lane for a K1 launch of B lanes: the largest C of CLUSTERS
    whose count of co-resident clusters (``counts[C]``, from
    ``cluster_counts``) is at least B, so every lane starts at once; else 1
    (one block per lane, as many lanes as the card takes, the rest
    queued)."""
    for C in CLUSTERS:
        if counts.get(C, 0) >= B:
            return C
    return 1


_COUNTS = {}


def cluster_counts(spec: KSpec, device) -> dict:
    """How many clusters of C CTAs of K1 in ``spec.mode`` the card of
    ``device`` holds at once, for C in CLUSTERS, from the CUDA occupancy
    calculator; cached per card, mode and penalties (the registry's shared
    memory)."""
    device = torch.device(device)
    pens = (spec.x, spec.o1, spec.e1, spec.o2, spec.e2)
    key = (device.index, spec.mode, pens)
    if key not in _COUNTS:
        fn = build.load("wavefront", "mwf_wavefront_clusters",
                        [ctypes.c_int] * 7 + [ctypes.c_void_p])
        counts = {}
        with torch.cuda.device(device):
            for C in CLUSTERS:
                n = ctypes.c_int(0)
                rc = fn(spec.mode, C, *pens, ctypes.byref(n))
                if rc:
                    raise RuntimeError(
                        f"wavefront cluster occupancy query failed (C={C}): "
                        f"CUDA error {rc}")
                counts[C] = n.value
        _COUNTS[key] = counts
    return _COUNTS[key]


def launch(spec: KSpec, lanes: torch.Tensor, tw: torch.Tensor,
           qw: torch.Tensor, segs: Optional[torch.Tensor], G: int = 1,
           C: int = 1):
    """Launch ``csrc/wavefront.cu`` on CUDA inputs (checked by the
    caller): K1 (``mwf_wavefront``) at C CTAs per lane (a cluster; one
    block at C = 1) when G is 1, else K4 (``mwf_wavefront_multi``, G lanes
    per block, C = 1); outputs as ``wavefront_plain``.  A launch the card
    refuses raises, with C in the message.  Notes its buffers in the
    peak-memory meter; counts no launch: each wrapper counts its own."""
    if C not in (1,) + CLUSTERS:
        raise ValueError(f"C must be one of {(1,) + CLUSTERS}, got {C}")
    if G != 1 and C != 1:
        raise ValueError(f"the multi-lane kernel runs at C = 1, got G={G} "
                         f"C={C}")
    if G == 1:
        fn = build.load("wavefront", "mwf_wavefront",
                        [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                        + [ctypes.c_void_p] * 4
                        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                        + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    else:
        fn = build.load("wavefront", "mwf_wavefront_multi",
                        [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                        + [ctypes.c_void_p] * 4
                        + [ctypes.c_void_p, ctypes.c_int]
                        + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    dev = lanes.device
    B, W = lanes.shape[0], spec.W
    is_p1 = spec.mode == MODE_PASS1
    NP = snapshot_layout(spec)[5]
    out = torch.empty((B, O_N), dtype=torch.int64, device=dev)
    # value rings (+ PASS1's pointer rings, laid out the same) + lastv;
    # lastv must start at 0, ring contents are never read outside a
    # recorded band
    planes = torch.zeros((B, plane_count(spec), W), dtype=torch.int32,
                         device=dev)
    tb = bands = snap = None
    if spec.mode == MODE_TB:
        tb = torch.zeros((B, spec.S_CAP, W), dtype=torch.uint8, device=dev)
        bands = torch.zeros((B, spec.S_CAP, 2), dtype=torch.int32,
                            device=dev)
    if is_p1:
        snap = torch.full((B, spec.n_snap, NP, W), WF_NEG_INF,
                          dtype=torch.int32, device=dev)
    seg_cap = 0 if segs is None else segs.shape[1]
    ptrs = (lanes.data_ptr(), tw.data_ptr(), qw.data_ptr(), tw.shape[1],
            planes.data_ptr(), out.data_ptr(),
            tb.data_ptr() if tb is not None else None,
            bands.data_ptr() if bands is not None else None,
            segs.data_ptr() if seg_cap else None, seg_cap)
    pens = (spec.x, spec.o1, spec.e1, spec.o2, spec.e2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if G == 1:
            rc = fn(*ptrs, snap.data_ptr() if snap is not None else None,
                    B, W, spec.S_CAP, spec.mode, spec.cpw, *pens,
                    spec.step, spec.n_snap, C, stream)
        else:
            rc = fn(*ptrs, B, W, spec.S_CAP, spec.mode, spec.cpw, *pens, G,
                    stream)
    if rc:
        raise RuntimeError(f"wavefront kernel launch failed (G={G}, C={C}): "
                           f"CUDA error {rc}")
    _note(spec, lanes, tw, qw, segs, planes, out, tb, bands, snap)
    return out, tb, bands, snap


def wavefront(spec: KSpec, lanes: torch.Tensor, tw: torch.Tensor,
              qw: torch.Tensor, segs: Optional[torch.Tensor] = None):
    """Run the wavefront loop for every lane; outputs as
    ``wavefront_plain``.  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/wavefront.cu`` at ``pick_cluster``'s C CTAs per lane and
    count the launch in ``wavefront.launches`` and, by mode,
    ``wavefront.launches_by_mode``; ``wavefront.clusters[card][mode]``
    keeps, by card index and mode, the card's last launch's C and its
    count of co-resident clusters at that C (None at C = 1)."""
    _check_spec(spec)
    _check_inputs(spec, lanes, tw, qw, segs)
    if lanes.device.type == "cpu":
        return wavefront_plain(spec, lanes, tw, qw, segs)
    if lanes.device.type != "cuda":
        raise ValueError(f"unsupported device {lanes.device}")
    counts = cluster_counts(spec, lanes.device)
    C = pick_cluster(lanes.shape[0], counts)
    res = launch(spec, lanes, tw, qw, segs, C=C)
    mode = launch_mode(spec, segs)
    count_launch(wavefront, mode=mode, card=lanes.device.index)
    # keyed by card: the sharded path launches from one thread per card
    wavefront.clusters.setdefault(lanes.device.index, {})[mode] = {
        "C": C, "clusters": counts.get(C)}
    return res


wavefront.launches = 0
wavefront.launches_by_mode = collections.Counter()
wavefront.launches_by_card = collections.Counter()
wavefront.clusters = {}
