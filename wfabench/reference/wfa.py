"""Plain PyTorch reference of the exact dual-affine WFA (lh3/miniwfa).

A frozen copy of the port's plain version
(``miniwfa_tpu_torch/ops/wavefront_kernel.py::run_cycles``, the host
walker ``models/traceback.py::traceback_walk`` and the low-mem passes of
``models/exact.py``), rewritten so that a 100 kb batch runs in seconds
on one card: every lane's whole window is swept each cycle (no
data-dependent spans, no host synchronisation inside a cycle), the
cycle's ring slots are picked by a cycle counter on the device, and on
a CUDA device one cycle is captured once as a CUDA graph and replayed.
It imports nothing of the program.  Its semantics are miniwfa's
(mwf_wfa_core, miniwfa.c:380-435, with every '>=' tie-break of
wf_next_tb, miniwfa.c:287-307; the shrink every 256 cycles,
miniwfa.c:139-171; the traceback, miniwfa.c:329-377; the low-mem two
passes, miniwfa.c:551-601).

Outputs per pair: the score ``s``, the cell count ``n_iter`` (the grown
band's width summed over the transition cycles, as miniwfa counts it)
and, with a traceback table, the packed CIGAR (``len<<4|op``, ops 1=I
2=D 7='=' 8='X').  Low-mem mode (``step > 0``): pass 1 is a traceback
run whose walk gives the checkpoints (the path's cell at which it first
drops to or below each snapshot score ``step*(c+1) - 1``: the pointer
that miniwfa's pass 1 carries back to that snapshot), pass 2 the
traceback run with the band collapsed to each checkpoint's diagonal at
its score; ``s``, ``n_iter`` and the CIGAR are pass 2's.

Sequences must be ACGT (the benchmark's traffic is): extension compares
32 bases at a time from 2-bit 32-grams, and the few diagonals whose run
passes 32 bases compare ``LONG_WORDS`` more 32-grams in one gather.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG = -0x40000000           # miniwfa's WF_NEG_INF (miniwfa.c:67)
BIG = 0x3FFFFFFF
OP_I, OP_D, OP_EQ, OP_X = 1, 2, 7, 8
K_CAND = 1024               # diagonals a cycle may extend past 32 bases
LONG_WORDS = 64             # 32-grams compared for them (2048 bases)
# error flags: window overflow, too many long diagonals, a run past LONG
E_WINDOW, E_CAND, E_LONG = 0, 1, 2


@dataclass(frozen=True)
class Pens:
    x: int = 4
    o1: int = 4
    e1: int = 2
    o2: int = 15
    e2: int = 1

    @property
    def NS(self) -> int:
        return max(self.x, self.o1 + self.e1, self.o2 + self.e2) + 1

    @property
    def rings(self) -> Tuple[int, int, int]:
        return self.NS, max(self.e1, 1) + 1, max(self.e2, 1) + 1


_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


def codes(seq: bytes) -> np.ndarray:
    c = _CODE[np.frombuffer(seq, np.uint8)]
    if (c == 255).any():
        raise ValueError("the reference takes ACGT sequences only")
    return c.astype(np.int64)


def grams(seqs: Sequence[bytes], width: int) -> torch.Tensor:
    """int64 [B, width]: entry p holds bases p..p+31 of the lane's
    sequence, 2 bits each, base p lowest (zeros past the end)."""
    c = np.zeros((len(seqs), width + 32), np.int64)
    for b, s in enumerate(seqs):
        c[b, :len(s)] = codes(s)
    g = np.zeros((len(seqs), width), np.int64)
    for j in range(32):
        # bit 63 wraps into the sign: the grams are only XORed and tested
        g ^= c[:, j:j + width] << np.int64(2 * j)
    return torch.from_numpy(g)


def ctz(x: torch.Tensor) -> torch.Tensor:
    """Trailing zero bits of nonzero int64 values."""
    return torch.frexp((x & -x).double())[1].long() - 1


class Wavefront:
    """One WFA run over a batch of pairs on ``device``: ``run()`` sweeps
    the cycles; then ``final_s``, ``n_iter``, ``last_state`` and, with
    ``tb=True``, the traceback table ``tb [B, s_cap, W]`` (byte of the
    transition into score t+1 at row t, column d + off) hold the result.
    ``segs`` ([B] lists of (score, diagonal)) collapses each lane's band
    at its checkpoints (pass 2)."""

    def __init__(self, pairs, pens: Pens, s_cap: int, device, tb=False,
                 segs=None):
        dev = torch.device(device)
        self.pens, self.s_cap, self.dev = pens, s_cap, dev
        B = len(pairs)
        tl = [len(t) for t, _ in pairs]
        ql = [len(q) for _, q in pairs]
        self.off = min(s_cap, max(tl)) + 2
        W = self.off + min(s_cap, max(ql)) + 3
        self.B, self.W = B, W
        RH, RE1, RE2 = pens.rings
        self.p_e1, self.p_f1 = RH, RH + RE1
        self.p_e2, self.p_f2 = RH + 2 * RE1, RH + 2 * RE1 + RE2
        NP = RH + 2 * RE1 + 2 * RE2
        i64 = dict(dtype=torch.int64, device=dev)
        self.tl = torch.tensor(tl, **i64)
        self.ql = torch.tensor(ql, **i64)
        self.d = torch.arange(W, **i64) - self.off
        self.end_col = (self.ql - self.tl + self.off).clamp(0, W - 1)
        width = max(tl + ql) + 32 * (LONG_WORDS + 2)
        self.gw = width
        self.T = grams([t for t, _ in pairs], width).to(dev).reshape(-1)
        self.Q = grams([q for _, q in pairs], width).to(dev).reshape(-1)
        self.base = (torch.arange(B, **i64) * width)[:, None]
        self.V = torch.zeros((B, NP, W), dtype=torch.int32, device=dev)
        # score 0: H = -1 at d = 0, the other states empty (miniwfa.c:119)
        c0 = self.off
        self.V[:, 0, c0] = -1
        for p in (self.p_e1, self.p_f1, self.p_e2, self.p_f2):
            self.V[:, p, c0] = NEG
        self.lastv = torch.zeros((B, W), dtype=torch.int32, device=dev)
        self.bnd = torch.zeros((B, RH, 2), **i64)
        self.bnd[:, :, 0] = 1                      # lo > hi: empty
        z = lambda: torch.zeros(B, **i64)          # noqa: E731
        self.wf_lo, self.wf_hi, self.t_lo, self.t_hi = z(), z(), z(), z()
        self.n_iter, self.last_state, self.sid = z(), z(), z()
        self.final_s = torch.full((B,), -1, **i64)
        self.done = torch.zeros(B, dtype=torch.bool, device=dev)
        self.act = torch.zeros(B, dtype=torch.bool, device=dev)
        self.t = torch.zeros(1, **i64)
        self.err = torch.zeros(3, dtype=torch.bool, device=dev)
        self.tb = (torch.zeros((B, s_cap, W), dtype=torch.uint8, device=dev)
                   if tb else None)
        self.segs = None
        if segs is not None and any(segs):
            cap = max(len(s) for s in segs)
            sg = np.zeros((B, cap, 2), np.int64)
            sg[:, :, 0] = -1
            for b, s in enumerate(segs):
                if s:
                    sg[b, :len(s)] = s
            self.segs = torch.from_numpy(sg).to(dev)
        p = pens
        # the transition's sources: Hx, Ho1, Ho2, E1, E2, F1, F2
        self.ages = torch.tensor([p.x, p.o1 + p.e1, p.o2 + p.e2, p.e1, p.e2,
                                  p.e1, p.e2], **i64)
        self.ring0 = torch.tensor([0, 0, 0, self.p_e1, self.p_e2, self.p_f1,
                                   self.p_f2], **i64)
        self.depth = torch.tensor([RH, RH, RH, RE1, RE2, RE1, RE2], **i64)
        self.lanes = torch.arange(B, **i64)
        self.graphs = dev.type == "cuda"
        self.graph = None

    # -- one cycle -------------------------------------------------------
    def _step(self) -> None:
        p, V, d = self.pens, self.V, self.d
        RH, RE1, RE2 = p.rings
        B, W = self.B, self.W
        t = self.t
        tl, ql = self.tl[:, None], self.ql[:, None]
        run = ~self.done
        rh = t % RH
        cur = self.bnd.index_select(1, rh)
        new = torch.stack([self.t_lo, self.t_hi], 1)[:, None]
        self.bnd.index_copy_(1, rh, torch.where(run[:, None, None], new, cur))

        # 1. extension of the top band (miniwfa.c:400-411)
        k_old = V.index_select(1, rh)[:, 0].long()
        in_top = run[:, None] & (d >= self.t_lo[:, None]) \
            & (d <= self.t_hi[:, None])
        dk = d + k_old
        elig = in_top & (k_old >= -1) & (dk >= -1) & (k_old < tl) & (dk < ql)
        cap = torch.minimum(tl - 1 - k_old, ql - 1 - dk).clamp(min=0)
        pt = (k_old + 1).clamp(0, self.gw - 1) + self.base
        pq = (dk + 1).clamp(0, self.gw - 1) + self.base
        x = self.T[pt] ^ self.Q[pq]
        adv = torch.minimum(torch.where(x == 0, 32, ctz(x) >> 1), cap)
        need = (elig & (x == 0) & (cap > 32)).reshape(-1)
        adv = self._long(adv.reshape(-1), need, pt.reshape(-1),
                         pq.reshape(-1), cap.reshape(-1)).view(B, W)
        k_new = k_old + torch.where(elig, adv, 0)
        V.index_copy_(1, rh, k_new.int()[:, None])
        col = self.end_col[:, None]
        e_end = elig.gather(1, col)[:, 0]
        kn_end = k_new.gather(1, col)[:, 0]
        term = e_end & (kn_end == self.tl - 1)
        zero = term & (kn_end == k_old.gather(1, col)[:, 0])

        # 2. termination (miniwfa.c:405-408)
        if self.tb is not None:
            row = (t - 1).clamp(min=0)
            byte = self.tb.view(-1)[(self.lanes * self.s_cap + row) * W
                                    + self.end_col].long() & 7
            self.last_state.copy_(torch.where(zero & (t > 0), byte,
                                              self.last_state))
        self.final_s.copy_(torch.where(term, t, self.final_s))
        self.done.copy_(self.done | term)

        # 2b. pass-2 checkpoint collapse (miniwfa.c:413-416)
        wf_lo, wf_hi = self.wf_lo, self.wf_hi
        if self.segs is not None:
            cap_s = self.segs.shape[1]
            cid = self.sid.clamp(max=cap_s - 1)
            sg = self.segs.gather(1, cid[:, None, None].expand(B, 1, 2))[:, 0]
            hit = run & ~term & (self.sid < cap_s) & (sg[:, 0] == t)
            wf_lo = torch.where(hit, sg[:, 1], wf_lo)
            wf_hi = torch.where(hit, sg[:, 1], wf_hi)
            self.sid.add_(hit.long())

        # 3. band growth (miniwfa.c:417-418)
        lo = torch.maximum(wf_lo - 1, -self.tl)
        hi = torch.minimum(wf_hi + 1, self.ql)
        ovf = run & ~term & ((lo < -self.off) | (hi > W - 1 - self.off))
        self.err[E_WINDOW] |= ovf.any()
        act = run & ~term & ~ovf
        self.act.copy_(act)
        in_top = act[:, None] & (d >= self.t_lo[:, None]) \
            & (d <= self.t_hi[:, None])
        in_new = act[:, None] & (d >= lo[:, None]) & (d <= hi[:, None])

        # 4. viability of the retired score-t slice (lastv = t+1)
        rE1, rE2 = t % RE1, t % RE2
        i5 = torch.cat([rh, self.p_e1 + rE1, self.p_f1 + rE1,
                        self.p_e2 + rE2, self.p_f2 + rE2])
        v = V.index_select(1, i5).long()
        dv = d + v
        viab = ((v >= -1) & (v < tl[:, None]) & (dv >= -1)
                & (dv < ql[:, None])).any(1)
        self.lastv.copy_(torch.where(viab & in_top, (t + 1).int(),
                                     self.lastv))

        # 5. transition into score t+1 (miniwfa.c:243-327); sources in
        # the order Hx, Ho1, Ho2, E1, E2, F1, F2
        s_src = t + 1 - self.ages
        src = V.index_select(1, self.ring0 + s_src % self.depth)
        b7 = self.bnd.index_select(1, s_src % RH)
        src = torch.where((d >= b7[:, :, 0:1]) & (d <= b7[:, :, 1:2]),
                          src, NEG)
        src = F.pad(src, (1, 1), value=NEG)
        Xm, Xp = src[:, 1:3, :-2], src[:, 1:3, 2:]
        Ym, Yp = src[:, 3:5, :-2], src[:, 5:7, 2:]
        E = torch.maximum(Xm, Ym)
        bE = Xm < Ym
        Fv = torch.maximum(Xp, Yp) + 1
        bF = Xp < Yp
        e1, e2, f1, f2 = E[:, 0], E[:, 1], Fv[:, 0], Fv[:, 1]
        ze = torch.where(e1 >= e2, 1, 3)
        e = torch.maximum(e1, e2)
        zf = torch.where(f1 >= f2, 2, 4)
        f = torch.maximum(f1, f2)
        z = torch.where(e >= f, ze, zf)
        h = torch.maximum(e, f)
        hx = src[:, 0, 1:-1] + 1
        z = torch.where(hx >= h, 0, z)
        Hn = torch.maximum(hx, h)
        new5 = torch.stack([Hn, e1, f1, e2, f2], 1)
        t1 = t + 1
        o5 = torch.cat([t1 % RH, self.p_e1 + t1 % RE1, self.p_f1 + t1 % RE1,
                        self.p_e2 + t1 % RE2, self.p_f2 + t1 % RE2])
        old5 = V.index_select(1, o5)
        V.index_copy_(1, o5, torch.where(in_new[:, None], new5, old5))
        viable = (new5 >= -1).any(1) & in_new
        if self.tb is not None:
            bits = (bE[:, 0].int() << 3) | (bF[:, 0].int() << 4) \
                | (bE[:, 1].int() << 5) | (bF[:, 1].int() << 6) | z
            self.tb.index_copy_(1, t, torch.where(in_new, bits, 0)
                                .to(torch.uint8)[:, None])
        # boundary commit (miniwfa.c:325-326)
        def at(slot):
            return viable.gather(1, (slot + self.off).clamp(0, W - 1)
                                 [:, None])[:, 0]
        lo_ok, hi_ok = at(lo), at(hi)
        self.wf_lo.copy_(torch.where(act & lo_ok, lo, wf_lo))
        self.wf_hi.copy_(torch.where(act & hi_ok, hi, wf_hi))
        self.t_lo.copy_(torch.where(act, lo, self.t_lo))
        self.t_hi.copy_(torch.where(act, hi, self.t_hi))
        # 7. accounting (miniwfa.c:421): the grown width, transition cycles
        self.n_iter.add_(torch.where(act, hi - lo + 1, 0))
        self.t.add_(1)

    def _long(self, adv, need, pt, pq, cap):
        """Runs past 32 bases: the first K_CAND such diagonals compare
        LONG_WORDS more 32-grams in one gather (flags on overflow)."""
        n = need.numel()
        pos = torch.cumsum(need, 0) - 1
        cnt = need.sum()
        self.err[E_CAND] |= cnt > K_CAND
        ok = need & (pos < K_CAND)
        buf = torch.zeros(K_CAND + 1, dtype=torch.int64, device=self.dev)
        buf.scatter_(0, torch.where(ok, pos, K_CAND),
                     torch.arange(n, device=self.dev))
        cand = buf[:K_CAND]
        valid = torch.arange(K_CAND, device=self.dev) < cnt
        offs = 32 + 32 * torch.arange(LONG_WORDS, device=self.dev)
        a = pt[cand][:, None] + offs
        b = pq[cand][:, None] + offs
        lim = self.T.numel() - 1
        xs = self.T[a.clamp(max=lim)] ^ self.Q[b.clamp(max=lim)]
        nz = torch.cat([xs != 0, torch.ones_like(xs[:, :1], dtype=torch.bool)],
                       1)
        first = nz.int().argmax(1)
        xsel = xs.gather(1, first.clamp(max=LONG_WORDS - 1)[:, None])[:, 0]
        r2 = torch.where(first < LONG_WORDS,
                         first * 32 + (ctz(torch.where(xsel == 0, 1, xsel))
                                       >> 1), 32 * LONG_WORDS)
        ccap = cap[cand]
        self.err[E_LONG] |= (valid & (first >= LONG_WORDS)
                             & (32 + 32 * LONG_WORDS < ccap)).any()
        out = torch.cat([adv, adv.new_zeros(1)])
        out.scatter_(0, torch.where(valid, cand, n),
                     torch.where(valid, torch.minimum(32 + r2, ccap), 0))
        return out[:n]

    def _shrink(self, t: int) -> None:
        """Every 256 cycles (miniwfa.c:420): the good-diagonal hull of the
        new tops and of the retired slices of scores t..t-NS+2."""
        p, V, d = self.pens, self.V, self.d
        RH, RE1, RE2 = p.rings
        t1 = t + 1
        o5 = [t1 % RH, self.p_e1 + t1 % RE1, self.p_f1 + t1 % RE1,
              self.p_e2 + t1 % RE2, self.p_f2 + t1 % RE2]
        top = (V[:, o5] >= -1).any(1)
        act = self.act[:, None]
        good = (top & (d >= self.t_lo[:, None]) & (d <= self.t_hi[:, None])) \
            | (self.lastv >= max(t - p.NS + 3, 1))
        good &= act & (d >= self.wf_lo[:, None]) & (d <= self.wf_hi[:, None])
        has = good.any(1)
        self.wf_lo.copy_(torch.where(
            has, torch.where(good, d, BIG).min(1)[0], self.wf_lo))
        self.wf_hi.copy_(torch.where(
            has, torch.where(good, d, -BIG).max(1)[0], self.wf_hi))

    def _capture(self) -> None:
        try:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                self._step()
            self.graph = g
        except RuntimeError as e:   # eager cycles give the same result
            print(f"wfabench reference: no CUDA graph ({e}); eager cycles",
                  file=sys.stderr)
            self.graphs = False

    def run(self) -> "Wavefront":
        t = 0
        while t < self.s_cap - 1:
            shrink = ((t + 1) & 0xFF) == 0
            if self.graphs and self.graph is None and t >= 2:
                self._capture()
            if self.graph is not None and not shrink:
                self.graph.replay()
            else:
                self._step()
                if shrink:
                    self._shrink(t)
            t += 1
            if t % 64 == 0 or t == self.s_cap - 1:
                if bool(self.done.all()):
                    break
        if bool(self.err.any()):
            raise RuntimeError(f"reference out of its limits (window, long "
                               f"diagonals, run length): "
                               f"{self.err.tolist()}")
        if not bool(self.done.all()):
            raise RuntimeError(f"reference did not finish within s_cap "
                               f"{self.s_cap}")
        return self


class TbReader:
    """Bytes of one lane's traceback table, fetched to the host in blocks
    of rows around the walk (a walk lowers the row by >= 1 per DP step
    and moves the column by <= 1, so a block of R rows needs 2R+3
    columns)."""

    R = 512

    def __init__(self, tb: torch.Tensor, lane: int):
        self.tb, self.lane = tb, lane
        self.blk = None
        self.r0 = self.c0 = 0

    def get(self, row: int, col: int) -> int:
        b = self.blk
        if b is None or not (self.r0 <= row < self.r0 + b.shape[0]
                             and self.c0 <= col < self.c0 + b.shape[1]):
            W = self.tb.shape[2]
            self.r0 = max(0, row - self.R + 1)
            self.c0 = max(0, col - self.R - 1)
            c1 = min(W, col + self.R + 2)
            self.blk = b = self.tb[self.lane, self.r0:row + 1,
                                   self.c0:c1].cpu().numpy()
        return int(b[row - self.r0, col - self.c0])


def _push(cig: List[int], op: int, n: int) -> None:
    if n <= 0:
        return
    if cig and (cig[-1] & 0xF) == op:
        cig[-1] += n << 4
    else:
        cig.append(n << 4 | op)


def walk(reader: TbReader, off: int, ts: bytes, qs: bytes, s_final: int,
         last_state: int, pens: Pens, snaps: Sequence[int] = ()
         ) -> Tuple[List[int], List[Tuple[int, int]]]:
    """The traceback (miniwfa.c:329-377) into a packed CIGAR in input
    order; and, for each snapshot score T in ``snaps`` below ``s_final``,
    the checkpoint (score, diagonal) of the path's first cell, walking
    back, at or below T."""
    i, k = len(qs) - 1, len(ts) - 1
    srow = s_final - 1
    last = last_state
    cig: List[int] = []
    pend = sorted((T for T in snaps if T < s_final), reverse=True)
    ck = {}
    while i >= 0 and k >= 0:
        if last == 0:
            k0 = k
            while i >= 0 and k >= 0 and qs[i] == ts[k]:
                i -= 1
                k -= 1
            _push(cig, OP_EQ, k0 - k)
            if i < 0 or k < 0:
                break
        if srow < 0:
            raise RuntimeError("reference traceback ran past score 0")
        x = reader.get(srow, i - k + off)
        state = (x & 7) if last == 0 else last
        ext = ((x >> (state + 2)) & 1) if state > 0 else 0
        if state == 0:
            _push(cig, OP_X, 1)
            i -= 1
            k -= 1
            dec = pens.x
        elif state in (1, 3):
            _push(cig, OP_I, 1)
            i -= 1
            dec = (pens.e1 if ext else pens.o1 + pens.e1) if state == 1 \
                else (pens.e2 if ext else pens.o2 + pens.e2)
        elif state in (2, 4):
            _push(cig, OP_D, 1)
            k -= 1
            dec = (pens.e1 if ext else pens.o1 + pens.e1) if state == 2 \
                else (pens.e2 if ext else pens.o2 + pens.e2)
        else:
            raise RuntimeError(f"bad traceback state {state}")
        srow -= dec
        while pend and pend[0] >= srow + 1:
            ck[pend.pop(0)] = (srow + 1, i - k)
        last = state if (state > 0 and ext) else 0
    if i >= 0:
        _push(cig, OP_I, i + 1)
    elif k >= 0:
        _push(cig, OP_D, k + 1)
    cig.reverse()
    if pend:
        raise RuntimeError(f"reference walk left snapshot scores {pend} "
                           f"without a checkpoint")
    return cig, [ck[T] for T in sorted(ck)]


@dataclass
class Answer:
    s: int
    n_iter: int
    cigar: Optional[List[int]]
    n_iter_p1: Optional[int] = None   # low-mem: pass 1's (score-mode) cells


def s_cap_for(pairs, pens: Pens, hint: int) -> int:
    """Cycle budget: ``hint`` (the configuration's), never past the
    trivial alignment's score."""
    ub = max(pens.x * min(len(t), len(q))
             + (min(pens.o1 + abs(len(t) - len(q)) * pens.e1,
                    pens.o2 + abs(len(t) - len(q)) * pens.e2)
                if len(t) != len(q) else 0) for t, q in pairs)
    return max(2, min(hint, ub + 2))


def _run(pairs, pens, s_cap, device, **kw) -> Wavefront:
    """A run, its cycle budget doubled until every lane finishes."""
    while True:
        try:
            return Wavefront(pairs, pens, s_cap, device, **kw).run()
        except RuntimeError as e:
            if "s_cap" not in str(e):
                raise
            s_cap *= 2


def align(pairs, pens: Pens, cigar: bool, step: int, device,
          s_cap: int = 16384) -> List[Answer]:
    """The reference's answers for ``pairs`` (score, CIGAR or low-mem
    mode, as the program's ``align_batch``), computed on ``device``."""
    s_cap = s_cap_for(pairs, pens, s_cap)
    if not cigar:
        w = _run(pairs, pens, s_cap, device)
        return [Answer(int(s), int(n), None) for s, n in
                zip(w.final_s.tolist(), w.n_iter.tolist())]
    segs = p1 = None
    if step > 0:
        w = _run(pairs, pens, s_cap, device, tb=True)
        p1 = w.n_iter.tolist()
        segs = []
        for b, (t, q) in enumerate(pairs):
            s = int(w.final_s[b])
            snaps = range(step - 1, s, step)
            _, ck = walk(TbReader(w.tb, b), w.off, t, q, s,
                         int(w.last_state[b]), pens, snaps)
            segs.append(ck)
        s_cap = max(2, int(w.final_s.max()) + 2)
        del w
    w = _run(pairs, pens, s_cap, device, tb=True, segs=segs)
    out = []
    for b, (t, q) in enumerate(pairs):
        s = int(w.final_s[b])
        cig, _ = walk(TbReader(w.tb, b), w.off, t, q, s,
                      int(w.last_state[b]), pens)
        out.append(Answer(s, int(w.n_iter[b]), cig,
                          None if p1 is None else int(p1[b])))
    return out

