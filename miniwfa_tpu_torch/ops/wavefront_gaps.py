"""Gaps engine: many tiny exact alignments at once, each in a window of
diagonals sized to the gap.

Counterpart of ``miniwfa_tpu/ops/wavefront_gaps.py`` (K3, the
gaps-in-sublanes Pallas kernel), which serves the chain mode's exact gap
fills (reference mwf_wfa_chain closes each inter-anchor gap with
mwf_wfa_exact, miniwfa.c:877).  Two implementations of one algorithm:

* ``gaps_plain`` — plain PyTorch, vectorised over ``[G, 128]`` planes;
  any device.
* ``csrc/gaps.cu`` — the hand-written Hopper kernel: a tile of
  ``THREADS[c]`` threads per gap over a window of WD = ``CLASSES[c]``
  slots, the smallest that holds the gap's ``tl + ql + 1`` legal
  diagonals, and ``32 / THREADS[c]`` gaps a warp; one launch per width
  class.

``gaps`` dispatches on the device of its inputs.  Either way it first
groups the gaps by width class on the host (``plan``: a permutation and
each class's first index and count); CUDA tensors then launch the kernel
once per non-empty class (or raise), and CPU tensors run the plain
version on each class's gaps; both return the outputs in input order.

Semantics contract: identical to the wavefront kernel
(ops/wavefront_kernel.py) in MODE_SCORE / MODE_TB for pairs with
``tl + ql <= MAX_TOT = 127``.  Slot ``w`` of a gap's window holds
diagonal ``w - tl``, so the window spans the whole legal diagonal range
``[-tl, ql]``: band growth is clamped at the matrix edge and a band
overflow cannot happen.  Band bookkeeping follows the JAX kernel exactly:
the shrink every 256 cycles takes the hull of the new tops' good
diagonals and the NS-1 youngest retired slices, read from ``lastv``, one
past the last score whose retired slice was viable at the slot (0:
never).  A gap's rings must fit one block's shared memory (``fits``),
which bounds the penalties at a few hundred.

Inputs: ``lens [G, 2] int32`` (tl, ql) and the flat packed word streams
``tw``/``qw [G, NW] int32`` of ops/pack.py, NW = n_words of the longest
sequence of the dispatch (``pack_words`` of both sides).  Outputs:
``out [G, GO_N] int32`` (columns GO_*, as the JAX kernel's result plane)
and, in TB mode, ``tb [G, S_CAP, 128] uint8``: row t holds the 7-bit
byte of every in-band cell of the transition into score t+1, 0 outside
the new band and in every row the gap did not transition in.  It is the
wavefront kernel's traceback layout with window anchor ``-tl``, so the
CIGAR walker (ops/traceback_device.walk) reads it as it is.
"""

from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import hbm
from ..utils.launches import count_dispatch, count_launch
from . import build
from . import pack
from . import wavefront_kernel as wk

MODE_SCORE, MODE_TB, WF_NEG_INF = wk.MODE_SCORE, wk.MODE_TB, wk.WF_NEG_INF
# per-gap output columns (the JAX kernel's result-plane lanes)
(GO_S, GO_DONE, GO_STOP, GO_OVF, GO_LS, GO_NI, GO_N) = range(7)
# eligibility: a 128-diagonal window spans [-tl, ql] iff tl + ql + 1 <= 128
MAX_TOT = 127
WIN = 128
SMEM_CAP = 232448   # shared memory one block may use (csrc/gaps.cu)
# the kernel's width classes: window slots of a gap's tile, and its threads
CLASSES = (8, 16, 32, 64, 128)
THREADS = (8, 16, 16, 32, 32)
# the class of a gap of n = tl + ql + 1 slots, by n
_CLASS_OF = np.searchsorted(CLASSES, np.arange(WIN + 1))


@dataclass(frozen=True)
class GSpec:
    """Static configuration of one gaps dispatch."""

    S_CAP: int       # cycle budget (tb rows)
    x: int
    o1: int
    e1: int
    o2: int
    e2: int
    mode: int = MODE_SCORE
    cpw: int = 16    # chars per packed word (16 = 2-bit ACGT, 4 = bytes)
    max_s: int = 0
    max_iter: int = 0

    @property
    def NS(self) -> int:  # shrink scan depth = max_pen + 1 (miniwfa.c:390)
        return max(self.x, self.o1 + self.e1, self.o2 + self.e2) + 1

    @property
    def rings(self) -> Tuple[int, int, int]:
        """Ring depths (H, E1/F1, E2/F2): each holds the youngest scores
        up to its largest recurrence age."""
        return (max(self.x, self.o1 + self.e1, self.o2 + self.e2),
                max(self.e1, 1), max(self.e2, 1))


WPB = 8             # warps a block of csrc/gaps.cu at most


def block_of(spec: GSpec, c: int) -> Tuple[int, int]:
    """(dynamic shared memory bytes, warps) of a block of width class c at
    the spec's penalties, as csrc/gaps.cu launches it: each warp holds
    32 / THREADS[c] gaps' rings of WD slots and both sides' words of WD - 1
    characters at cpw 4; as many warps as fit SMEM_CAP, at most WPB."""
    DH, DE1, DE2 = spec.rings
    WD = CLASSES[c]
    per_gap = (DH + 2 * DE1 + 2 * DE2) * WD + 2 * pack.n_words(WD - 1, 4)
    per_warp = 4 * (32 // THREADS[c]) * per_gap
    warps = min(WPB, SMEM_CAP // per_warp)
    return warps * per_warp, warps


def fits(spec: GSpec) -> bool:
    """Whether a block of the widest class holds one gap's rings and
    words (csrc/gaps.cu, mwf_gaps): at most 453 ring planes."""
    return block_of(spec, len(CLASSES) - 1)[1] >= 1


def _check(spec: GSpec, lens, tw, qw) -> np.ndarray:
    """Check a dispatch's inputs; returns the lens on the host (the one
    copy from the card)."""
    if spec.mode not in (MODE_SCORE, MODE_TB):
        raise ValueError(f"unsupported gaps mode {spec.mode}")
    if spec.cpw not in (4, 16):
        raise ValueError(f"cpw must be 4 or 16, got {spec.cpw}")
    if not fits(spec):
        raise ValueError(f"a gap's rings at max penalty {spec.NS - 1} "
                         f"exceed a block's shared memory")
    if spec.S_CAP < 2:
        raise ValueError(f"bad cycle budget S_CAP={spec.S_CAP}")
    dev = lens.device
    if lens.dtype != torch.int32 or lens.dim() != 2 or lens.shape[1] != 2:
        raise ValueError("lens must be int32 [G, 2]")
    for name, w in (("tw", tw), ("qw", qw)):
        if w.dtype != torch.int32 or w.dim() != 2 \
                or w.shape[0] != lens.shape[0] or w.device != dev:
            raise ValueError(f"{name} must be int32 [G, NW] on {dev}")
    if not (lens.is_contiguous() and tw.is_contiguous()
            and qw.is_contiguous()):
        raise ValueError("gaps inputs must be contiguous")
    if tw.shape[1] != qw.shape[1]:
        raise ValueError("tw and qw must have the same word count")
    lens_h = lens.cpu().numpy()
    if lens.shape[0]:
        longest, low = int(lens_h.max()), int(lens_h.min())
        # columns added, not sum(1): numpy's reduction over a short
        # axis is slow, and this runs once a dispatch
        if low < 0 or int((lens_h[:, 0] + lens_h[:, 1]).max()) > MAX_TOT:
            raise ValueError(f"every gap needs 0 <= tl, ql and "
                             f"tl + ql <= {MAX_TOT}")
        # the kernel keeps a gap's words in shared memory, sized for
        # n_words(MAX_TOT, 4)
        if tw.shape[1] != pack.n_words(longest, spec.cpw):
            raise ValueError(f"word streams of {tw.shape[1]} words; the "
                             f"longest sequence packs into "
                             f"{pack.n_words(longest, spec.cpw)}")
    return lens_h


def gaps_plain(spec: GSpec, lens: torch.Tensor, tw: torch.Tensor,
               qw: torch.Tensor) -> Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
    """Plain PyTorch version of the gaps kernel (same algorithm, same
    outputs): returns (out int32 [G, GO_N], tb uint8 [G, S_CAP, 128] in TB
    mode, else None)."""
    _check(spec, lens, tw, qw)
    dev = lens.device
    G, NEG, NS = lens.shape[0], WF_NEG_INF, spec.NS
    DH, DE1, DE2 = spec.rings
    ag_x, ag_o1, ag_o2 = spec.x, spec.o1 + spec.e1, spec.o2 + spec.e2
    is_tb = spec.mode == MODE_TB
    tl = lens[:, 0:1].long()
    ql = lens[:, 1:2].long()
    DD = torch.arange(WIN, device=dev)[None, :] - tl   # slot w -> w - tl
    d_end = ql - tl
    rows = torch.arange(G, device=dev)

    def full(v):
        return torch.full((G, WIN), v, dtype=torch.int64, device=dev)

    def col(v=0, dtype=torch.int64):
        return torch.full((G, 1), v, dtype=dtype, device=dev)

    def good(v):   # k in [-1, tl) and d+k in [-1, ql) (miniwfa.c:139-171)
        return (v >= -1) & (v < tl) & (DD + v >= -1) & (DD + v < ql)

    # score-s planes sit in ring slot s % depth; slots of scores < 0 are
    # never written before they are read, so they read WF_NEG_INF
    rH = [full(NEG) for _ in range(DH)]
    rE1, rF1 = [full(NEG) for _ in range(DE1)], [full(NEG) for _ in range(DE1)]
    rE2, rF2 = [full(NEG) for _ in range(DE2)], [full(NEG) for _ in range(DE2)]
    rH[0] = torch.where(DD == 0, -1, NEG)   # score-0 top (miniwfa.c:119)
    lastv, pbits = full(0), full(0)
    wlo, whi, tlo, thi = col(), col(), col(), col()
    done, stopped = col(0, torch.bool), col(0, torch.bool)
    fs, ls, ni = col(-1), col(), col()
    tb = torch.zeros((G, spec.S_CAP, WIN), dtype=torch.uint8, device=dev) \
        if is_tb else None
    neg_col = col(NEG)

    def shm(a):   # value at slot w-1 (diagonal d-1); slot 0 reads NEG
        return torch.cat([neg_col, a[:, :-1]], 1)

    def shp(a):   # value at slot w+1; slot 127 reads NEG
        return torch.cat([a[:, 1:], neg_col], 1)

    t = 0
    while t < spec.S_CAP - 1:
        act = ~(done | stopped)
        if not bool(act.any()):
            break
        # --- 1. extension of the top band (miniwfa.c:400-411)
        k_old = rH[t % DH]
        in_top = (DD >= tlo) & (DD <= thi)
        elig = act & in_top & good(k_old)
        k_new = k_old.clone()
        gi, si = elig.nonzero(as_tuple=True)
        if gi.numel():
            k0, d = k_old[gi, si], DD[gi, si]
            cap = torch.minimum(tl[gi, 0] - 1 - k0, ql[gi, 0] - 1 - (d + k0))
            k_new[gi, si] = k0 + wk._lcp(tw, qw, gi, k0 + 1, d + k0 + 1,
                                         cap.clamp(min=0), spec.cpw)
        rH[t % DH] = k_new

        # --- 2. termination (miniwfa.c:405-408): last_state only on a
        # zero-extension termination after score 0
        at_end = elig & (DD == d_end) & (k_new == tl - 1)
        term = at_end.any(1, keepdim=True)
        zero = (at_end & (k_new == k_old)).any(1, keepdim=True)
        if is_tb:
            bits_at = pbits[rows, ql[:, 0]][:, None]   # slot ql is d_end
            ls = torch.where(act & term & zero & (t > 0), bits_at & 7, ls)
        fs = torch.where(act & term, t, fs)
        done = done | (act & term)
        act2 = act & ~term

        # --- 3. band growth, clamped to the matrix (miniwfa.c:417-418)
        lo = torch.maximum(wlo - 1, -tl)
        hi = torch.minimum(whi + 1, ql)
        in_new = (DD >= lo) & (DD <= hi)

        # --- 4. viability of the retired score-t slice
        h_t, e1_t, f1_t = k_new, rE1[t % DE1], rF1[t % DE1]
        e2_t, f2_t = rE2[t % DE2], rF2[t % DE2]
        viab = good(h_t) | good(e1_t) | good(f1_t) | good(e2_t) | good(f2_t)
        lastv = torch.where(act2 & viab, t + 1, lastv)

        # --- 5. transition into score t+1 (wf_next_tb semantics)
        def rd(ring, age):
            return ring[(t + 1 - age) % len(ring)]

        ho1, ho2, hx = rd(rH, ag_o1), rd(rH, ag_o2), rd(rH, ag_x)
        e1s, f1s = rd(rE1, spec.e1), rd(rF1, spec.e1)
        e2s, f2s = rd(rE2, spec.e2), rd(rF2, spec.e2)
        Hn, E1n, F1n, E2n, F2n, bits = wk.transition_values(dict(
            Hx=hx, Ho1m=shm(ho1), Ho1p=shp(ho1), Ho2m=shm(ho2),
            Ho2p=shp(ho2), E1m=shm(e1s), F1p=shp(f1s), E2m=shm(e2s),
            F2p=shp(f2s)))
        new = (Hn, E1n, F1n, E2n, F2n)
        for ring, v, top in zip((rH, rE1, rF1, rE2, rF2), new,
                                (h_t, e1_t, f1_t, e2_t, f2_t)):
            ring[(t + 1) % len(ring)] = torch.where(
                act2, torch.where(in_new, v, NEG), top)
        if is_tb:
            bits_m = torch.where(act2 & in_new, bits, 0)
            pbits = torch.where(act2, bits_m, pbits)
            tb[:, t] = bits_m.to(torch.uint8)

        # --- 6. boundary commit (miniwfa.c:325-326)
        viable = in_new & ((Hn >= -1) | (E1n >= -1) | (F1n >= -1)
                           | (E2n >= -1) | (F2n >= -1))
        lo_ok = (viable & (DD == lo)).any(1, keepdim=True)
        hi_ok = (viable & (DD == hi)).any(1, keepdim=True)
        wlo = torch.where(act2 & lo_ok, lo, wlo)
        whi = torch.where(act2 & hi_ok, hi, whi)
        tlo = torch.where(act2, lo, tlo)
        thi = torch.where(act2, hi, thi)

        # --- 7. shrink every 256 cycles (miniwfa.c:420): hull of the new
        # tops' good diagonals and the NS-1 youngest retired slices
        if ((t + 1) & 0xFF) == 0:
            goodt = good(Hn) | good(E1n) | good(F1n) | good(E2n) | good(F2n)
            g = (goodt & in_new) | (lastv >= max(t - NS + 3, 1))
            g &= (DD >= wlo) & (DD <= whi)
            shr = act2 & g.any(1, keepdim=True)
            wlo = torch.where(shr, torch.where(g, DD, wk._BIG)
                              .min(1, keepdim=True)[0], wlo)
            whi = torch.where(shr, torch.where(g, DD, -wk._BIG)
                              .max(1, keepdim=True)[0], whi)

        # --- 8. accounting + early stop (miniwfa.c:421-425)
        ni = ni + torch.where(act2, hi - lo + 1, 0)
        stop = (ni > spec.max_iter) if spec.max_iter > 0 \
            else torch.zeros_like(act2)
        if 0 < spec.max_s < t + 1:
            stop = torch.ones_like(act2)
        stopped = stopped | (act2 & stop)
        t += 1
    alive = ~(done | stopped)
    out = torch.cat([fs, done.long(), stopped.long(), alive.long(), ls, ni],
                    1).int()
    return out, tb


def plan(lens: np.ndarray) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """The gaps of a dispatch grouped by width class, from their lens on
    the host: (perm int32 [G], the gap indices class by class, each class
    in input order; each class's first index in perm and count).  A gap's
    class is the smallest window of CLASSES that holds its tl + ql + 1
    diagonals."""
    cls = _CLASS_OF[lens[:, 0] + lens[:, 1] + 1]
    perm = np.argsort(cls, kind="stable").astype(np.int32)
    count = np.bincount(cls, minlength=len(CLASSES))
    first = np.cumsum(count) - count
    return perm, list(zip(first.tolist(), count.tolist()))


def _gaps_by_class_plain(spec: GSpec, lens, tw, qw, lens_h, perm,
                         bounds):
    """The plain version class by class, as the kernel's launches take the
    gaps (each class's word streams cut to its longest sequence), the
    outputs scattered back to input order."""
    G = lens.shape[0]
    out = torch.empty((G, GO_N), dtype=torch.int32)
    tb = torch.zeros((G, spec.S_CAP, WIN), dtype=torch.uint8) \
        if spec.mode == MODE_TB else None
    for first, count in bounds:
        if not count:
            continue
        idx = perm[first:first + count].long()
        nw = pack.n_words(int(lens_h[idx.numpy()].max()), spec.cpw)
        o, t = gaps_plain(spec, lens[idx], tw[idx, :nw].contiguous(),
                          qw[idx, :nw].contiguous())
        out[idx] = o
        if tb is not None:
            tb[idx] = t
    return out, tb


def gaps(spec: GSpec, lens: torch.Tensor, tw: torch.Tensor,
         qw: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Align every gap; outputs as ``gaps_plain``, in input order.  The
    gaps are grouped by width class on the host (``plan``); CPU tensors
    take the plain version class by class; CUDA tensors launch
    ``csrc/gaps.cu`` once per non-empty class, on the caller's stream,
    count each launch in ``gaps.launches`` and, by the class's window
    slots, ``gaps.launches_by_variant``, and the call in
    ``gaps.dispatches``.  Either notes its buffers in the peak-memory
    meter."""
    lens_h = _check(spec, lens, tw, qw)
    if lens.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {lens.device}")
    perm_h, bounds = plan(lens_h)
    dev = lens.device
    perm = torch.from_numpy(perm_h).to(dev)
    if dev.type == "cpu":
        out, tb = _gaps_by_class_plain(spec, lens, tw, qw, lens_h, perm,
                                       bounds)
        _note(spec, lens, tw, qw, perm, out, tb)
        return out, tb
    fn = build.load("gaps", "mwf_gaps",
                    [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                    + [ctypes.c_longlong, ctypes.c_void_p])
    G = lens.shape[0]
    out = torch.empty((G, GO_N), dtype=torch.int32, device=dev)
    # bytes the kernel does not write (outside a gap's band, rows past its
    # end) stay 0, as in the plain version
    tb = torch.zeros((G, spec.S_CAP, WIN), dtype=torch.uint8, device=dev) \
        if spec.mode == MODE_TB else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c, (first, count) in enumerate(bounds):
            if not count:
                continue
            rc = fn(c, lens.data_ptr(), tw.data_ptr(), qw.data_ptr(),
                    tw.shape[1], out.data_ptr(),
                    tb.data_ptr() if tb is not None else None,
                    perm.data_ptr() + 4 * first, count, spec.S_CAP,
                    spec.mode, spec.cpw, spec.x, spec.o1, spec.e1, spec.o2,
                    spec.e2, spec.max_s, spec.max_iter, stream)
            if rc:
                raise RuntimeError(f"gaps kernel launch failed (window of "
                                   f"{CLASSES[c]} slots, {count} gaps): "
                                   f"CUDA error {rc}")
            count_launch(gaps, variant=CLASSES[c], card=dev.index)
    count_dispatch(gaps)
    _note(spec, lens, tw, qw, perm, out, tb)
    return out, tb


def _note(spec: GSpec, lens: torch.Tensor, *bufs) -> None:
    """The peak-memory meter's note of one dispatch: its inputs, the
    class permutation and the outputs (``utils/hbm.py``, tag ``gaps``;
    the rings live in shared memory)."""
    hbm.note_arrays(f"gaps mode={spec.mode} G={lens.shape[0]} "
                    f"S_CAP={spec.S_CAP}", lens, *bufs)


gaps.launches = 0
gaps.launches_by_variant = collections.Counter()
gaps.launches_by_card = collections.Counter()
gaps.dispatches = 0
