"""Heuristic chaining mode: anchor the pair on low-occurrence k-mers, then
close the inter-anchor gaps exactly (reference mwf_wfa_chain,
miniwfa.c:850-896).

The host plans each pair's segments (anchors, gap classification by
k-mer similarity) with vectorised numpy; the exact gap fills of a whole
batch of pairs go to the device together: the gaps of at most 127 bp in
total to the gaps engine (models/tiny.py, kernel K3), the rest to
align_batch (kernel K1) in size-sorted chunks.

``Result.n_iter`` in chain mode is the sum of the gap fills' wavefront
cells (the reference leaves r->n_iter unset here, its gap results being
local, miniwfa.c:877-882, so this package defines the unit).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import cigar as C
from ..options import Options
from ..ops import kmer
from ..utils.spans import Spans, span
from . import exact
from . import tiny
from .exact import Result, align_batch, as_bytes

# segment kinds (classification of miniwfa.c:861-891)
K_EQ, K_SKIP, K_ALIGN, K_DEL, K_INS, K_NONE = range(6)
# gaps per align_batch chunk for the fills the gaps engine does not take
CHUNK = 2048


def _intra_offsets(sizes: np.ndarray) -> np.ndarray:
    """[0..s0-1, 0..s1-1, ...] for a vector of run sizes."""
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    return np.arange(total, dtype=np.int64) - \
        np.repeat(np.cumsum(sizes) - sizes, sizes)


def _plan_segments(ts: bytes, qs: bytes, opt: Options):
    """Vectorised anchor-chain walk; returns (kinds, x0, x1, y0, y1)
    int64 arrays over the n_a+1 inter-anchor regions."""
    anchors = kmer.chain(ts, qs, opt.kmer, opt.max_occ)
    anchors = kmer.anchor_filter(anchors, len(ts), len(qs), opt.kmer,
                                 opt.min_len)
    n_a = int(anchors.size)
    x1 = np.empty(n_a + 1, np.int64)
    y1 = np.empty(n_a + 1, np.int64)
    x1[:n_a] = (anchors >> np.uint64(32)).astype(np.int64) + 1
    y1[:n_a] = (anchors & np.uint64(0xFFFFFFFF)).astype(np.int64) + 1
    x1[n_a], y1[n_a] = len(ts), len(qs)
    x0 = np.concatenate([[0], x1[:-1]])
    y0 = np.concatenate([[0], y1[:-1]])
    dx, dy = x1 - x0, y1 - y0
    is_anchor = np.arange(n_a + 1) < n_a
    eq = is_anchor & (dx == dy) & (dx <= opt.kmer)
    both = (~eq) & (dx > 0) & (dy > 0)
    kinds = np.full(n_a + 1, K_NONE, np.int64)
    kinds[eq] = K_EQ
    kinds[both] = K_ALIGN
    kinds[(~eq) & (dx > 0) & (dy == 0)] = K_DEL
    kinds[(~eq) & (dx == 0) & (dy > 0)] = K_INS
    # the >= 10 kb dissimilar-gap shortcut needs a k-mer similarity pass:
    # rare, so loop over its candidates only (miniwfa.c:869-875)
    for i in np.nonzero(both & (dx >= 10000) & (dy >= 10000))[0]:
        if kmer.ksim(ts[x0[i]:x1[i]], qs[y0[i]:y1[i]], opt.kmer) < 0.02:
            kinds[i] = K_SKIP
    return kinds, x0, x1, y0, y1


def align_chain_batch(pairs: Sequence[Tuple[object, object]], opt: Options,
                      device="cuda", spans: Optional[Spans] = None
                      ) -> List[Result]:
    """Chaining heuristic over a batch of pairs on ``device``: every
    pair's exact gap fills are aligned together."""
    device = exact.check_device(device)
    enc = [(as_bytes(t), as_bytes(q)) for t, q in pairs]
    with span(spans, "plan"):
        plans = [_plan_segments(t, q, opt) for t, q in enc]
        gap_pairs = []
        gap_of = []           # (pair index, segment index)
        for pi, ((ts, qs), (kinds, x0, x1, y0, y1)) in enumerate(
                zip(enc, plans)):
            for i in np.nonzero(kinds == K_ALIGN)[0]:
                gap_pairs.append((ts[x0[i]:x1[i]], qs[y0[i]:y1[i]]))
                gap_of.append((pi, int(i)))
    gap_results: List[Optional[Result]] = [None] * len(gap_pairs)

    # window-sized gaps (nearly all of them: 99.98% of a 5 Mb pair's ~43k
    # fills are <= 127 bp in total) run on the gaps engine
    tot = [len(t) + len(q) for t, q in gap_pairs]
    tiny_sel = [g for g, n in enumerate(tot) if n <= tiny.wg.MAX_TOT]
    if tiny_sel and tiny.tiny_eligible(opt, max(tot[g] for g in tiny_sel)):
        sub = tiny.align_tiny_batch([gap_pairs[g] for g in tiny_sel], opt,
                                    device=device, spans=spans)
        for g, r in zip(tiny_sel, sub):
            gap_results[g] = r

    # the rest in bounded chunks, sorted by size so each chunk's window
    # and cycle buckets fit its largest gap, not the 512 default
    pending = [g for g, r in enumerate(gap_results) if r is None]
    order = sorted(pending, key=lambda g: max(len(gap_pairs[g][0]),
                                              len(gap_pairs[g][1])))
    for c0 in range(0, len(order), CHUNK):
        sel = order[c0:c0 + CHUNK]
        mx = max(max(len(gap_pairs[g][0]), len(gap_pairs[g][1]))
                 for g in sel)
        with span(spans, "K1 gap fills"):
            sub = align_batch([gap_pairs[g] for g in sel], opt,
                              w0=max(64, mx // 2), s0=max(64, mx // 2),
                              device=device)
        for g, r in zip(sel, sub):
            gap_results[g] = r
    gap_map = dict(zip(gap_of, gap_results))

    with span(spans, "assembly"):
        return [_assemble_pair(opt, pi, kinds, x1 - x0, y1 - y0, gap_map)
                for pi, (kinds, x0, x1, y0, y1) in enumerate(plans)]


def _assemble_pair(opt: Options, pi: int, kinds, dx, dy, gap_map) -> Result:
    """Vectorised score + CIGAR splice over a pair's segment plan.

    A 5 Mb pair has ~4M segments (mostly same-diagonal '=' runs between
    adjacent anchors), so the reference's per-segment walk
    (miniwfa.c:861-891) is not a Python loop here: scores reduce with
    numpy masks, and the CIGAR is built by scattering every segment's
    packed runs at precomputed offsets, then one run-merge pass (grouping
    equal ops is the sequential push/extend)."""
    m_eq = kinds == K_EQ
    m_skip = kinds == K_SKIP
    m_del = kinds == K_DEL
    m_ins = kinds == K_INS
    m_al = kinds == K_ALIGN

    def gap_cost(ln):
        return np.minimum(opt.o1 + ln * opt.e1, opt.o2 + ln * opt.e2)

    s = int(opt.o2 * 2 * m_skip.sum()
            + opt.e2 * (dx[m_skip].sum() + dy[m_skip].sum())
            + gap_cost(dx[m_del]).sum() + gap_cost(dy[m_ins]).sum())
    aidx = np.nonzero(m_al)[0]
    ares = [gap_map[(pi, int(i))] for i in aidx]
    s += sum(r.s for r in ares)
    n_iter = sum(r.n_iter for r in ares)
    if not opt.cigar:
        return Result(s=s, cigar=None, n_iter=n_iter)

    # emitted runs per segment: EQ/DEL/INS 1, SKIP 2 (D then I), ALIGN the
    # length of its sub-CIGAR, NONE 0
    cnt = np.zeros(kinds.size, np.int64)
    cnt[m_eq | m_del | m_ins] = 1
    cnt[m_skip] = 2
    acigs = [np.asarray(r.cigar if r.cigar is not None else [], np.int64)
             for r in ares]
    sizes = np.fromiter((a.size for a in acigs), np.int64, len(acigs))
    cnt[aidx] = sizes
    off_all = np.concatenate([[0], np.cumsum(cnt)])
    off = off_all[:-1]                     # start offset per segment
    flat = np.zeros(int(off_all[-1]), np.int64)
    flat[off[m_eq]] = (dx[m_eq] << 4) | C.OP_EQ
    flat[off[m_del]] = (dx[m_del] << 4) | C.OP_D
    flat[off[m_ins]] = (dy[m_ins] << 4) | C.OP_I
    flat[off[m_skip]] = (dx[m_skip] << 4) | C.OP_D
    flat[off[m_skip] + 1] = (dy[m_skip] << 4) | C.OP_I
    if acigs:
        # one scatter of every sub-CIGAR (a per-gap slice assignment loop
        # costs seconds at 43k gaps)
        dst = np.repeat(off[aidx], sizes) + _intra_offsets(sizes)
        flat[dst] = np.concatenate(acigs)
    flat = flat[(flat >> 4) > 0]           # drop zero-length runs (push)
    if flat.size:
        ops = flat & 0xF
        b = np.nonzero(np.concatenate([[True], ops[1:] != ops[:-1]]))[0]
        lens = np.add.reduceat(flat >> 4, b)
        flat = (lens << 4) | ops[b]
    return Result(s=s, cigar=flat.tolist(), n_iter=n_iter)


def align_chain(ts, qs, opt: Options, device="cuda") -> Result:
    """Chaining heuristic alignment (reference mwf_wfa_chain).  May miss
    the optimal score; the CIGAR is still self-consistent with s."""
    return align_chain_batch([(ts, qs)], opt, device=device)[0]
