"""k-mer primitives: the chaining heuristic's anchors and the similarity
estimate.

Semantics replicate the reference (miniwfa.c:699-848): 2-bit rolling
k-mers over ACGT (anything else resets the window), low-occurrence match
pairing (per-side occurrence <= max_occ), LIS co-linear chaining,
gapless-run anchor filtering, and the k-mer multiset similarity
(``ksim``), which also sizes the exact driver's first CIGAR-mode
dispatch (models/exact.py ``_estimate_s``).  Runs on the host, over the
native runtime when it is built (utils/native.py), else over numpy.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import native

# A/a→0, C/c→1, G/g→2, T/t/U/u→3, else 4 (reference seq_nt4_table,
# miniwfa.c:699-716)
NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _ch in enumerate("ACGT"):
    NT4[ord(_ch)] = _i
    NT4[ord(_ch.lower())] = _i
NT4[ord("U")] = NT4[ord("u")] = 3


def kmer_codes(seq: bytes, rid: int, k: int,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """All valid k-mers as ``(kmer<<1|rid)<<32 | end_pos`` uint64 values
    (reference mg_fc_kmer, miniwfa.c:718-730); written to the front of
    ``out`` (contiguous uint64, len(seq) at least) when it is given."""
    if native.available():
        return native.kmer_codes(seq, rid, k, out)
    n = len(seq)
    if n < k:
        codes = np.zeros(0, dtype=np.uint64)
    else:
        nt = NT4[np.frombuffer(seq, dtype=np.uint8)].astype(np.uint64)
        bad = nt >= 4
        # window [i-k+1, i] is valid iff it contains no bad char
        cbad = np.concatenate([[0], np.cumsum(bad)])
        valid = (cbad[k:] - cbad[:-k]) == 0      # at end positions k-1..n-1
        x = np.zeros(n - k + 1, dtype=np.uint64)
        for j in range(k):
            x = (x << np.uint64(2)) | nt[j: j + n - k + 1]
        pos = np.arange(k - 1, n, dtype=np.uint64)
        codes = (((x << np.uint64(1)) | np.uint64(rid)) << np.uint64(32)
                 | pos)[valid]
    if out is None:
        return codes
    out[:codes.size] = codes
    return out[:codes.size]


def _group_bounds(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Start indices and counts of equal-key runs in a sorted array."""
    if keys.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    change = np.nonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))[0]
    counts = np.diff(np.concatenate([change, [keys.size]]))
    return change, counts


def match_pairs(ts: bytes, qs: bytes, k: int, max_occ: int) -> np.ndarray:
    """Cross-product anchor pairs pos1<<32|pos2, sorted, for k-mers
    occurring in both sequences with per-side occurrence <= max_occ
    (reference mg_chain first half, miniwfa.c:741-765)."""
    if native.available():
        return native.match_pairs_u64(ts, qs, k, max_occ)
    a = np.sort(np.concatenate([kmer_codes(ts, 0, k), kmer_codes(qs, 1, k)]))
    starts, counts = _group_bounds(a >> np.uint64(33))
    rid = ((a >> np.uint64(32)) & np.uint64(1)).astype(np.int64)
    crid = np.concatenate([[0], np.cumsum(rid)])
    n1 = crid[starts + counts] - crid[starts]    # rid-1 count per group
    n0 = counts - n1
    ok = (n0 >= 1) & (n1 >= 1) & (n0 <= max_occ) & (n1 <= max_occ)
    pos = a & np.uint64(0xFFFFFFFF)
    chunks: List[np.ndarray] = []
    for u in range(max_occ):
        for v in range(max_occ):
            m = ok & (n0 > u) & (n1 > v)
            if not m.any():
                continue
            s_idx = starts[m] + u                # rid-0 entries come first
            t_idx = starts[m] + n0[m] + v        # (rid bit above pos)
            chunks.append(pos[s_idx] << np.uint64(32) | pos[t_idx])
    if not chunks:
        return np.zeros(0, dtype=np.uint64)
    return np.sort(np.concatenate(chunks))


def lis_indices(a: np.ndarray) -> np.ndarray:
    """Indices of the longest strictly increasing subsequence of uint64
    keys (reference mg_lis_64, miniwfa.c:678-697: patience sorting with
    binary search)."""
    if native.available():
        return native.lis_u64(a)
    n = a.size
    M = np.zeros(n + 1, dtype=np.int64)   # M[l]: index of the least tail
    P = np.zeros(n, dtype=np.int64)       # predecessor
    L = 0
    for i in range(n):
        lo, hi = 1, L
        while lo <= hi:
            mid = (lo + hi + 1) >> 1
            if a[M[mid]] < a[i]:
                lo = mid + 1
            else:
                hi = mid - 1
        P[i] = M[lo - 1]
        M[lo] = i
        L = max(L, lo)
    out = np.zeros(L, dtype=np.int64)
    kk = M[L]
    for j in range(L - 1, -1, -1):
        out[j] = kk
        kk = P[kk]
    return out


def chain(ts: bytes, qs: bytes, k: int, max_occ: int) -> np.ndarray:
    """Co-linear anchor chain pos1<<32|pos2, ascending (reference
    mg_chain, miniwfa.c:732-784)."""
    if len(ts) < k or len(qs) < k:
        return np.zeros(0, dtype=np.uint64)
    b = match_pairs(ts, qs, k, max_occ)
    if b.size == 0:
        return b
    # LIS over coordinate-swapped keys (pos2 major) picks the co-linear set
    swapped = (b >> np.uint64(32)) | (b << np.uint64(32))
    return b[lis_indices(swapped)]


def anchor_filter(anchors: np.ndarray, tl: int, ql: int, k: int,
                  min_len: int) -> np.ndarray:
    """Drop anchors in gapless (same-diagonal) runs shorter than min_len
    (reference wf_anchor_filter, miniwfa.c:829-848).  The scan starts
    from a virtual (0,0) element whose run length accumulates without the
    +k base, and a virtual terminal (tl,ql) element can extend, and so
    always keeps, the final run."""
    n = anchors.size
    if n == 0:
        return anchors
    # element 0 = virtual origin, 1..n = anchors (+1'd coordinates as in
    # the reference), n+1 = virtual terminal
    X = np.empty(n + 2, dtype=np.int64)
    Y = np.empty(n + 2, dtype=np.int64)
    X[0] = Y[0] = 0
    X[1:n + 1] = (anchors >> np.uint64(32)).astype(np.int64) + 1
    Y[1:n + 1] = (anchors & np.uint64(0xFFFFFFFF)).astype(np.int64) + 1
    X[n + 1], Y[n + 1] = tl, ql
    brk = np.diff(X) != np.diff(Y)                   # a break AT element e+1
    starts = np.concatenate([[0], np.nonzero(brk)[0] + 1])
    if starts.size == 1:
        return anchors                               # one unchecked run
    ends = starts[1:]                                # a run ends at the next
    s = starts[:-1]
    runlen = np.where(s >= 1, k, 0) + X[ends - 1] - X[s]
    killed = runlen < min_len
    if not killed.any():
        return anchors
    # kill anchor elements [max(s,1), end) through a difference array
    dm = np.zeros(n + 2, dtype=np.int64)
    np.add.at(dm, np.maximum(s[killed], 1), 1)
    np.add.at(dm, ends[killed], -1)
    return anchors[np.cumsum(dm)[1:n + 1] == 0]


def ksim(ts: bytes, qs: bytes, k: int) -> float:
    """max(shared/n1, shared/n2) over the k-mer multiset intersection
    (reference mwf_ksim, miniwfa.c:786-812)."""
    return next(ksims([(ts, qs)], k))


def ksims(pairs: Sequence[Tuple[bytes, bytes]], k: int) -> Iterator[float]:
    """``ksim`` of each pair, in order.  The work arrays are allocated
    once, for the longest pair, and reused: fresh arrays a pair cost more
    in page faults than the sort does."""
    cap = max((len(t) + len(q) for t, q in pairs), default=0)
    codes = np.empty(cap, np.uint64)
    key = np.empty(cap, np.uint32)       # kmer<<1|rid
    group = np.empty(cap, np.uint32)     # a run's k-mer
    flag = np.empty(cap, bool)
    ends = np.empty(cap + 1, np.int64)
    lens = np.empty(cap, np.int64)
    mins = codes.view(np.int64)          # codes are spent by then
    for ts, qs in pairs:
        if len(ts) < k or len(qs) < k:
            yield 0.0
            continue
        n1 = kmer_codes(ts, 0, k, codes).size
        n2 = kmer_codes(qs, 1, k, codes[n1:]).size
        if n1 == 0 or n2 == 0:
            yield 0.0
            continue
        n = n1 + n2
        K = np.right_shift(codes[:n], np.uint64(32), out=key[:n],
                           casting="unsafe")
        K.sort()
        # runs of equal keys: -1, then each run's last index
        brk = np.not_equal(K[1:], K[:-1], out=flag[:n - 1])
        r = int(np.count_nonzero(brk)) + 1
        E = ends[:r + 1]
        E[0], E[1:r], E[r] = -1, np.flatnonzero(brk), n - 1
        L = np.subtract(E[1:], E[:-1], out=lens[:r])
        g = np.take(K, E[1:], out=group[:r], mode="clip")
        g >>= np.uint32(1)
        # a k-mer of both sequences: its rid-0 run, then its rid-1 run
        both = np.equal(g[1:], g[:-1], out=flag[:r - 1])
        m = np.minimum(L[1:], L[:-1], out=mins[:r - 1])
        m *= both
        shared = int(m.sum())
        yield max(shared / n1, shared / n2)
