"""k-mer primitives: the chaining heuristic's anchors and the similarity
estimate.

Semantics replicate the reference (miniwfa.c:699-848): 2-bit rolling
k-mers over ACGT (anything else resets the window), low-occurrence match
pairing (per-side occurrence <= max_occ), LIS co-linear chaining,
gapless-run anchor filtering, and the k-mer multiset similarity
(``ksim``).  These run on the host, over the native runtime when it is
built (utils/native.py), else over numpy.  The similarity that sizes the
exact path's first CIGAR-mode and pass-1 dispatch (models/exact.py
``_estimate_s``) runs on the batch's device instead: ``ksims_device``
counts every lane's k-mers in one hash table on the card
(``csrc/ksim.cu``), or in its plain PyTorch twin on the CPU
(``ksim_counts_plain``), and the host takes the ratios of the counts.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import native
from ..utils.launches import count_launch
from . import build

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


# bytes a table slot: a uint64 key and a uint32 count a side
KSIM_SLOT_BYTES = 16
_NT4_T = torch.from_numpy(NT4)


def ksim_slots(n_kmers: int) -> int:
    """Slots of a launch's hash table: the power of two at or above twice
    its k-mers, so that linear probes stay short."""
    return 1 << max(1, (2 * n_kmers - 1).bit_length())


def ksim_budget(device: torch.device) -> int:
    """Table bytes one launch may hold: a quarter of the card's memory, as
    one CIGAR-mode dispatch's traceback table (models/exact.py
    ``_tb_budget``)."""
    return torch.cuda.get_device_properties(device).total_memory // 4


def ksim_counts_plain(buf: torch.Tensor, seg: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Plain PyTorch version of the ksim kernel: ``buf`` uint8, the
    sequences joined in order; ``seg`` int64 [2L, 2], (offset, length) of
    lane l's target (row 2l) and query (2l + 1).  Returns int64 [L, 3]:
    the k-mer multiset intersection, the target's and the query's valid
    k-mers, as ``ksims`` counts them, by one sort of (lane, k-mer, side)
    keys."""
    L = seg.shape[0] // 2
    dev = buf.device
    out = torch.zeros((L, 3), dtype=torch.int64, device=dev)
    m = buf.numel() - k + 1
    if m <= 0:
        return out
    nt = _NT4_T.to(dev)[buf.long()].long()
    x = torch.zeros(m, dtype=torch.int64, device=dev)
    ok = torch.ones(m, dtype=torch.bool, device=dev)
    for j in range(k):
        c = nt[j:j + m]
        x = (x << 2) | (c & 3)
        ok &= c < 4
    # the segment of each window's first byte: the window has to end in it
    s = torch.repeat_interleave(torch.arange(2 * L, device=dev), seg[:, 1],
                                output_size=buf.numel())[:m]
    ok &= torch.arange(k, m + k, device=dev) <= seg[s, 0] + seg[s, 1]
    keys = (((s >> 1) << (2 * k) | x) << 1 | (s & 1))[ok]
    u, c = torch.unique(keys, return_counts=True)
    lane = u >> (2 * k + 1)
    out.view(-1).index_add_(0, lane * 3 + 1 + (u & 1), c)
    # a k-mer of both sides: its side-0 key, then its side-1 key
    both = (u[1:] >> 1) == (u[:-1] >> 1)
    out[:, 0].index_add_(0, lane[1:][both],
                         torch.minimum(c[1:], c[:-1])[both])
    return out


def ksim_counts(pairs: Sequence[Tuple[bytes, bytes]], k: int,
                device) -> np.ndarray:
    """(shared, n1, n2) of each pair, int64 [B, 3]: the k-mer multiset
    intersection and each side's valid k-mers.  On a CUDA device the
    batch's bytes go to the card in one copy and one launch of the ksim
    kernel (csrc/ksim.cu) counts them, counted in
    ``ksim_counts.launches``; a batch whose table would pass
    ``ksim_budget`` takes a launch a pair.  A launch sums at most 2048
    lanes.  The CPU runs ``ksim_counts_plain``.  The hash table is freed
    before this returns."""
    device = torch.device(device)
    if not 1 <= k <= 15:
        raise ValueError(f"ksim counts k-mers of 1 to 15 bases, not {k}")
    seqs = [s for p in pairs for s in p]
    lens = np.array([len(s) for s in seqs], np.int64)
    if lens.size == 0 or lens.max() < k:
        return np.zeros((len(pairs), 3), np.int64)
    seg = torch.from_numpy(np.stack([np.cumsum(lens) - lens, lens], 1))
    buf = torch.frombuffer(bytearray().join(seqs), dtype=torch.uint8)
    if device.type == "cpu":
        return ksim_counts_plain(buf, seg, k).numpy()
    slots = ksim_slots(int(np.maximum(lens - k + 1, 0).sum()))
    if len(pairs) > 1 and slots * KSIM_SLOT_BYTES > ksim_budget(device):
        return np.concatenate([ksim_counts([p], k, device) for p in pairs])
    return _launch(buf.to(device), seg.to(device), int(lens.max()), k,
                   slots).cpu().numpy()


def _launch(buf: torch.Tensor, seg: torch.Tensor, longest: int, k: int,
            slots: int) -> torch.Tensor:
    dev = buf.device
    L = seg.shape[0] // 2
    # slots uint64 keys, then 2 x slots uint32 counts
    table = torch.zeros(2 * slots, dtype=torch.int64, device=dev)
    out = torch.zeros((L, 3), dtype=torch.int64, device=dev)
    fn = build.load("ksim", "mwf_ksim",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(buf.data_ptr(), seg.data_ptr(), L, longest, k,
                table.data_ptr(), table[slots:].data_ptr(), slots,
                out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"ksim kernel launch failed: CUDA error {rc}")
    count_launch(ksim_counts, card=dev.index)
    return out


ksim_counts.launches = 0
ksim_counts.launches_by_card = collections.Counter()


def ksims_device(pairs: Sequence[Tuple[bytes, bytes]], k: int,
                 device) -> List[float]:
    """``ksim`` of each pair, from ``ksim_counts`` on ``device``: the
    same floats as ``ksims``, whose integer counts these are."""
    return [max(s / n1, s / n2) if n1 and n2 else 0.0
            for s, n1, n2 in ksim_counts(pairs, k, device).tolist()]
