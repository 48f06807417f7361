"""Batch driver for the gaps engine (ops/wavefront_gaps.py).

Serves the chain mode's exact gap fills (reference mwf_wfa_chain closes
each inter-anchor gap with mwf_wfa_exact, miniwfa.c:877): tens of
thousands of alignments of at most 127 bp in total, a few dispatches of
up to GMAX gaps, each gap on its own 128-diagonal window.  In CIGAR mode
the CIGAR walker (ops/traceback_device.walk) reads the gaps kernel's
traceback on the same device.

Same Result contract as models.exact.align_batch (score, canonical CIGAR,
n_iter with the reference's band accounting).  A gap that outlives its
dispatch's cycle budget re-runs through align_batch on the same device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..options import Options
from ..ops import pack
from ..ops import traceback_device as tbd
from ..ops import wavefront_gaps as wg
from ..utils.spans import Spans, span
from . import exact
from .exact import Result, as_bytes

# gaps per dispatch: bounds the traceback buffer (G * S_CAP * 128 bytes)
# and the walker's run buffers
GMAX = 16384


def tiny_eligible(opt: Options, pairs_tot_max: int) -> bool:
    """Engine gate: window-sized pairs, and penalties whose rings fit the
    gaps kernel's shared memory (``wavefront_gaps.fits``; past it the
    gaps go to align_batch)."""
    return pairs_tot_max <= wg.MAX_TOT and wg.fits(wg.GSpec(
        S_CAP=2, x=opt.x, o1=opt.o1, e1=opt.e1, o2=opt.o2, e2=opt.e2))


def _s_bound(opt: Options, tl: int, ql: int) -> int:
    """Upper bound on the optimal score: the trivial alignment costs
    x*min(tl,ql) mismatches plus one |tl-ql| gap."""
    d = abs(tl - ql)
    return opt.x * min(tl, ql) + (opt.gap_cost(d) if d else 0) + 4


def _scap_bucket(s: int) -> int:
    for cap in (32, 64, 128, 256, 512, 1024):
        if s <= cap - 2:          # termination needs S_CAP >= s + 2
            return cap
    raise ValueError(f"score bound {s} exceeds the gaps engine's range")


def dispatch_inputs(opt: Options, ts: Sequence[bytes], qs: Sequence[bytes],
                    cpw: int, s_cap: int):
    """The gaps kernel's spec and inputs for one dispatch: (spec, lens
    int32 [G, 2], tw, qw int32 [G, NW]) as numpy arrays."""
    spec = wg.GSpec(S_CAP=s_cap, x=opt.x, o1=opt.o1, e1=opt.e1, o2=opt.o2,
                    e2=opt.e2, mode=wg.MODE_TB if opt.cigar else wg.MODE_SCORE,
                    cpw=cpw, max_s=opt.max_s, max_iter=opt.max_iter)
    lens = np.stack([np.fromiter(map(len, ts), np.int32, len(ts)),
                     np.fromiter(map(len, qs), np.int32, len(qs))], 1)
    # one stream width for both sides, as the walker wants
    both = pack.pack_words(list(ts) + list(qs), cpw)
    return spec, lens, both[:len(ts)].copy(), both[len(ts):].copy()


def walk_meta(lens: np.ndarray, out: np.ndarray) -> np.ndarray:
    """The CIGAR walker's per-gap inputs from the gaps kernel's inputs and
    outputs: window anchor -tl; overflowed and stopped gaps walk
    nothing."""
    skip = (out[:, wg.GO_OVF] != 0) | (out[:, wg.GO_STOP] != 0)
    meta = np.zeros((len(lens), tbd.M_N), np.int64)
    meta[:, tbd.M_ANC] = -lens[:, 0]
    meta[:, tbd.M_TL] = np.where(skip, 0, lens[:, 0])
    meta[:, tbd.M_QL] = np.where(skip, 0, lens[:, 1])
    meta[:, tbd.M_S] = np.where(skip, 0, out[:, wg.GO_S])
    meta[:, tbd.M_LS] = out[:, wg.GO_LS]
    return meta


def walk_gaps(tb, lens: np.ndarray, out: np.ndarray, tw, qw, cpw: int,
              pens) -> List[List[int]]:
    """CIGARs of a dispatch's gaps from the gaps kernel's traceback, by
    the CIGAR walker on tb's device.  The run buffers are cut on the
    device to the most runs a gap can emit (tl + ql + 2) before they
    come to the host."""
    meta = torch.from_numpy(walk_meta(lens, out)).to(tb.device)
    runs, counts = tbd.walk(tb, meta, tw, qw, cpw, pens)
    out_cap = int(lens[:, 0].max(initial=0) + lens[:, 1].max(initial=0) + 4)
    if int(counts.max()) > out_cap:
        raise RuntimeError("gaps walker emitted more runs than a gap can "
                           "(tl + ql + 2): corrupt traceback input")
    return tbd.to_cigars(runs[:, :out_cap], counts)


def align_tiny_batch(pairs: Sequence[Tuple[object, object]], opt: Options,
                     device="cuda", spans: Optional[Spans] = None
                     ) -> List[Result]:
    """Exact alignment of a batch of tiny pairs (tl+ql <= 127 each) on
    the gaps engine.  Bit-identical to align_batch.

    opt.step is ignored: the stripe mode gives the same score and CIGAR
    as the high-mem mode, and a tiny pair's score is far below any
    realistic snapshot period (the auto driver's step=5000,
    miniwfa.c:905); n_iter counts one pass, as the high-mem mode does."""
    device = exact.check_device(device)
    ts_list = [as_bytes(t) for t, _ in pairs]
    qs_list = [as_bytes(q) for _, q in pairs]
    n = len(pairs)
    results: List[Optional[Result]] = [None] * n
    if n == 0:
        return []
    cpw = 16 if pack.can_pack2(ts_list + qs_list) else 4
    pens = (opt.x, opt.o1, opt.e1, opt.o2, opt.e2)

    # order by score bound so each dispatch's cycle budget (and its tb
    # buffer) is sized to its own gaps, not the batch's worst case
    sb = [_s_bound(opt, len(t), len(q)) for t, q in zip(ts_list, qs_list)]
    order = sorted(range(n), key=lambda g: sb[g])
    fallback: List[int] = []
    for c0 in range(0, n, GMAX):
        sel = order[c0:c0 + GMAX]
        with span(spans, "gap packing"):
            spec, lens, tw, qw = dispatch_inputs(
                opt, [ts_list[g] for g in sel], [qs_list[g] for g in sel],
                cpw, _scap_bucket(max(sb[g] for g in sel)))
            tw = torch.from_numpy(tw).to(device)
            qw = torch.from_numpy(qw).to(device)
        with span(spans, "K3"):
            out, tb = wg.gaps(spec, torch.from_numpy(lens).to(device), tw, qw)
            out = out.cpu().numpy()
        cigs = None
        if opt.cigar:
            with span(spans, "W1"):
                cigs = walk_gaps(tb, lens, out, tw, qw, cpw, pens)
        tb = None
        for j, g in enumerate(sel):
            if out[j, wg.GO_OVF]:
                fallback.append(g)
            elif out[j, wg.GO_STOP]:
                results[g] = Result(s=-1, cigar=None,
                                    n_iter=int(out[j, wg.GO_NI]))
            else:
                results[g] = Result(s=int(out[j, wg.GO_S]),
                                    cigar=None if cigs is None else cigs[j],
                                    n_iter=int(out[j, wg.GO_NI]))
    if fallback:
        with span(spans, "K1 gap fills"):
            sub = exact.align_batch([(ts_list[i], qs_list[i])
                                     for i in fallback], opt, device=device)
        for i, r in zip(fallback, sub):
            results[i] = r
    return results  # type: ignore[return-value]
