"""Exact WFA alignment driver (host orchestration around the device kernels).

Implements the reference's ``mwf_wfa_exact`` behaviour (miniwfa.c:603-615)
in score-only, high-memory CIGAR and low-memory stripe (``step > 0``)
modes, with identical scores, CIGARs and cell counts, batched.

The low-memory mode is the reference's two passes (mwf_wfa_seg,
miniwfa.c:551-601): pass 1 runs the wavefront in PASS1 mode, snapshotting
pointer planes every ``step`` scores, and the checkpoint chain
(ops/traceback_device.chain_ptrs, models/traceback) turns the snapshots
into one ``(score, diagonal)`` checkpoint per snapshot; pass 2 is the
high-mem CIGAR run with the band collapsed to the checkpoint diagonal at
each checkpoint score, so its traceback table needs a band of about
2·step.  Its ``n_iter`` is pass 2's alone, as the reference counts.

Host work (cheap, O(n+s) per pair): sequence packing, capacity bucket
selection with escalate-and-retry on overflow, checkpoint decoding.  A
call's host stages are profiler ranges (utils/spans.py): ``mwf.size``
(first_bucket, pass2_bucket; on the card the first bucket's k-mer
estimate counts the batch's k-mers in the ksim kernel, ops/kmer.py
``ksims_device``), ``mwf.pack`` (kernel_inputs),
``mwf.dispatch`` (the copies to the device and the launch),
``mwf.checkpoints`` (low-mem pass 1: the checkpoint chain and its
decoding) and ``mwf.cigars`` (the walker and the CIGAR lists).
Device work: the whole wavefront loop of a batch (ops/wavefront_kernel.py, one
cluster of blocks per lane, or with ``MWF_ENGINE=multi`` several lanes per
block, ops/wavefront_multi.py; past its windows, score and pass-1 runs go to
the wide engine, ops/wavefront_wide.py, one lane over the whole card), the
checkpoint chain and, in CIGAR mode, the traceback walk
(ops/traceback_device.py), all on the ``device`` the caller names: a CUDA
device launches the hand-written kernels, the CPU runs their plain PyTorch
versions.

Lanes that outgrow the band window (W) or the cycle budget (S_CAP) re-run
in an escalated bucket; every lane's result is independent of the others
in its batch.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cigar as C
from ..options import Options
from ..ops import pack
from ..ops import traceback_device as tbd
from ..ops import wavefront_kernel as wk
from ..ops import wavefront_multi as wm
from ..ops import wavefront_wide as ww
from ..utils import hbm
from ..utils.spans import span
from . import traceback as tbk

MODE_SCORE, MODE_TB, MODE_PASS1 = wk.MODE_SCORE, wk.MODE_TB, wk.MODE_PASS1
Seg = List[Tuple[int, int]]   # (score, diagonal) checkpoints of one pair

# band windows: K1 (one cluster per lane) serves score runs up to
# WIDE_SCORE_W_MIN diagonals and pass-1 runs up to WIDE_PASS1_W_MIN; wider
# ones go to the wide engine (the whole card per lane) up to WIDE_W_CAP
# (models/exact.py:166-194 of the JAX package).  CIGAR mode stays in K1 up
# to TB_W_CAP: it holds S_CAP * W traceback bytes per lane
WIDE_SCORE_W_MIN = 65536
WIDE_PASS1_W_MIN = 32768
WIDE_W_CAP = 1 << 20
TB_W_CAP = 65536
# snapshot rows a wide pass-1 run starts with (run_chunked grows them)
WIDE_SNAP_ROWS0 = 8
# pass-1 planes + snapshot bytes one dispatch may hold on the CPU (plain
# version): keeps a process well under 1 GiB even at step=1
CPU_PASS1_BUDGET = 256 << 20


@dataclass
class Result:
    """Alignment result (reference mwf_rst_t, miniwfa.h:46-51)."""

    s: int                       # score; -1 when stopped by max_s/max_iter
    cigar: Optional[List[int]]   # packed len<<4|op, or None in score mode
    n_iter: int = 0              # total wavefront cells (Σ band widths)

    @property
    def cigar_str(self) -> Optional[str]:
        return None if self.cigar is None else C.to_string(self.cigar)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _prev_pow2(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    p = 1
    while p * 2 <= n:
        p <<= 1
    return p


def as_bytes(s) -> bytes:
    if isinstance(s, bytes):
        return s
    if isinstance(s, str):
        return s.encode("latin1")
    return bytes(s)


def _cpw_for(ts_list: Sequence[bytes], qs_list: Sequence[bytes]) -> int:
    """Packing mode for a batch: 16 chars/word (2-bit) when every byte is
    uppercase ACGT, else 4 chars/word (raw bytes)."""
    return 16 if pack.can_pack2([*ts_list, *qs_list]) else 4


@dataclass(frozen=True)
class _Buckets:
    LT: int
    LQ: int
    W: int
    S_CAP: int
    W_full: int   # band can never exceed this
    S_full: int   # score can never exceed this


def _buckets_for(opt: Options, ts_list, qs_list, w0: int, s0: int) -> _Buckets:
    ns = opt.max_pen + 1
    LT = _next_pow2(max(128, max((len(t) for t in ts_list), default=1)))
    LQ = _next_pow2(max(128, max((len(q) for q in qs_list), default=1)))
    w_full = _next_pow2(LT + LQ + 1 + 2 * ns + 18)
    s_bound = opt.x * min(LT, LQ) + opt.gap_cost(LT + LQ) + 4
    if opt.max_s > 0:
        s_bound = min(s_bound, opt.max_s + 2)
    s_full = _next_pow2(s_bound)
    return _Buckets(
        LT=LT, LQ=LQ,
        W=min(_next_pow2(max(w0, 2 * ns + 24)), w_full),
        S_CAP=min(_next_pow2(s0), s_full),
        W_full=w_full, S_full=s_full,
    )


def _escalate(bk: _Buckets, ovf_band: bool, ovf_scap: bool) -> _Buckets:
    W, S = bk.W, bk.S_CAP
    if ovf_band:
        W = min(W * 4, bk.W_full)
    if ovf_scap:
        S = min(S * 4, bk.S_full)
    if (W, S) == (bk.W, bk.S_CAP):
        raise RuntimeError("bucket escalation stuck — engine bug")
    return _Buckets(bk.LT, bk.LQ, W, S, bk.W_full, bk.S_full)


def _estimate_s(opt: Options, ts_list, qs_list,
                device: torch.device = torch.device("cpu")
                ) -> Tuple[int, int]:
    """k-mer estimate of the batch's max optimal score, for sizing the
    first CIGAR-mode or pass-1 dispatch instead of climbing the escalation
    ladder.

    Uses the k-mer similarity (the reference mwf_ksim, miniwfa.c:786-812)
    from ops.kmer.ksims_device on ``device``: the ksim kernel's counts on
    a card, its plain version's on the CPU.  Divergence ≈ 1 - sim^(1/k),
    each diverged base costs ≤ x, plus the length-difference gap cost.
    Clustered divergence makes this an underestimate — the escalation
    ladder stays as the backstop.

    Returns (s_for_scap, s_for_band) with 1.5x / 1.15x margins; (0, 0)
    when the estimate is unusable (tiny pairs, non-ACGT content, no
    shared k-mers)."""
    from ..ops import kmer as km
    s_cap_e = s_band_e = 0
    pairs = list(zip(ts_list, qs_list))
    if any(min(len(t), len(q)) < 2048 for t, q in pairs):
        return 0, 0              # ladder rungs are cheap at this size
    for (t, q), sim in zip(pairs, km.ksims_device(pairs, 13, device)):
        tl, ql = len(t), len(q)
        if sim <= 0.0:
            return 0, 0          # dissimilar or non-ACGT: keep the ladder
        div = 1.0 - sim ** (1.0 / 13.0)
        s_raw = opt.x * div * min(tl, ql) + \
            (opt.gap_cost(abs(ql - tl)) if tl != ql else 0)
        s_cap_e = max(s_cap_e, int(s_raw * 1.5) + 128)
        s_band_e = max(s_band_e, int(s_raw * 1.15) + 128)
    return s_cap_e, s_band_e


def _device_w_cap(mode: int, device: torch.device) -> int:
    """Largest band window the device serves (no cap on the CPU)."""
    if device.type != "cuda":
        return 1 << 30
    return TB_W_CAP if mode == MODE_TB else WIDE_W_CAP


def _tb_budget(device: torch.device) -> int:
    """Traceback bytes one CIGAR-mode dispatch may hold: a quarter of the
    card's memory (the batch is split into lane chunks under it)."""
    return torch.cuda.get_device_properties(device).total_memory // 4


def _n_snap(opt: Options, S_CAP: int) -> int:
    """Snapshot rows of a PASS1 dispatch: one per ``step`` cycles, + 2."""
    return S_CAP // opt.step + 2


def _n_planes(opt: Options) -> int:
    return wk.snapshot_layout(wk.KSpec(W=1, S_CAP=2, x=opt.x, o1=opt.o1,
                                       e1=opt.e1, o2=opt.o2, e2=opt.e2))[5]


def _pass1_budget(device: torch.device) -> int:
    """Pass-1 bytes one dispatch may hold: a quarter of the card's memory,
    or CPU_PASS1_BUDGET on the CPU."""
    return _tb_budget(device) if device.type == "cuda" else CPU_PASS1_BUDGET


def _pass1_lane_bytes(opt: Options, bk: _Buckets) -> int:
    """One PASS1 lane's device bytes: value and pointer planes, lastv,
    and the snapshot rows."""
    NP = _n_planes(opt)
    return ((_n_snap(opt, bk.S_CAP) + 2) * NP + 1) * bk.W * 4


def _pass1_lane_cap(opt: Options, bk: _Buckets, device) -> int:
    """Lanes of one pass-1 dispatch under the device's budget (>= 1)."""
    return max(1, _pass1_budget(device) // _pass1_lane_bytes(opt, bk))


def _pass1_w_cap(opt: Options, device: torch.device) -> int:
    """Largest pass-1 window: no cap on the CPU; on the card, the score
    cap, cut so that one lane with 8 snapshot rows fits the budget."""
    if device.type != "cuda":
        return 1 << 30
    per_w = (10 * _n_planes(opt) + 1) * 4
    return min(WIDE_W_CAP, _prev_pow2(_pass1_budget(device) // per_w))


def _band_limit_error(opt: Options, mode: int, W: int,
                      w_cap: int) -> RuntimeError:
    """The band outgrew the largest device-servable window.  For
    high-mem CIGAR mode this is the documented capability boundary of the
    1 byte/cell traceback table (the reference needs 50.6 GB of host RAM
    for its 5 Mb pair, README.md:98)."""
    if mode == MODE_TB and opt.step <= 0 and opt.cigar:
        return RuntimeError(
            f"high-mem CIGAR traceback exceeds device memory at this "
            f"scale (band W={W} > device cap {w_cap}; the tb table is "
            f"1 byte/cell — the reference needs 50.6 GB host RAM for "
            f"its 5 Mb pair).  Use the low-mem stripe mode (-p / "
            f"Options(step=5000): bit-identical score and CIGAR), or the "
            f"auto or chain mode (align_auto / align_chain, CLI -t / -u).")
    return RuntimeError(
        f"band window exceeded the device limit (W={W}, cap {w_cap}) "
        f"— use the auto or chain mode for this pair (align_auto / "
        f"align_chain, CLI -t / -u), or the CPU device")


def kernel_inputs(opt: Options, mode: int, W: int, S_CAP: int,
                  ts_list: Sequence[bytes], qs_list: Sequence[bytes]):
    """The wavefront kernel's spec and inputs for a batch: (spec, lanes
    int64 [B, L_N], tw, qw int32 [B, NW]) as numpy arrays.  PASS1 takes
    ``opt.step`` and runs without early stops (max_s = max_iter = 0)."""
    with span(None, "pack"):
        cpw = _cpw_for(ts_list, qs_list)
        is_p1 = mode == MODE_PASS1
        spec = wk.KSpec(W=W, S_CAP=S_CAP, x=opt.x, o1=opt.o1, e1=opt.e1,
                        o2=opt.o2, e2=opt.e2, mode=mode, cpw=cpw,
                        step=opt.step if is_p1 else 0,
                        n_snap=_n_snap(opt, S_CAP) if is_p1 else 0)
        lanes = np.zeros((len(ts_list), wk.L_N), np.int64)
        for i, (t, q) in enumerate(zip(ts_list, qs_list)):
            lanes[i, wk.L_TL] = len(t)
            lanes[i, wk.L_QL] = len(q)
            # window anchored at the midpoint of start (d=0) and end
            # diagonal
            lanes[i, wk.L_ANC] = (len(q) - len(t)) // 2 - W // 2
        lanes[:, wk.L_MS] = 0 if is_p1 else opt.max_s
        lanes[:, wk.L_MI] = 0 if is_p1 else opt.max_iter
        mx = max(len(s) for s in list(ts_list) + list(qs_list))
        return (spec, lanes, pack.pack_words(ts_list, cpw, mx),
                pack.pack_words(qs_list, cpw, mx))


def seg_input(segs: Optional[Sequence[Optional[Seg]]]
              ) -> Optional[np.ndarray]:
    """Per-lane checkpoint lists -> the kernel's ``segs [B, seg_cap, 2]``
    int64 (score -1 pads the rows), or None when no lane has one."""
    if segs is None or not any(segs):
        return None
    out = np.zeros((len(segs), max(len(sg) for sg in segs if sg), 2),
                   np.int64)
    out[:, :, 0] = -1
    for i, sg in enumerate(segs):
        if sg:
            out[i, :len(sg)] = sg
    return out


def walk_meta(lanes: np.ndarray, o: np.ndarray) -> np.ndarray:
    """The walker's per-lane inputs from the wavefront kernel's inputs and
    outputs; lanes that overflowed or stopped walk nothing."""
    skip = (o[:, wk.O_OVFB] | o[:, wk.O_OVFS] | o[:, wk.O_STOP]) != 0
    meta = np.zeros((len(lanes), tbd.M_N), np.int64)
    meta[:, tbd.M_ANC] = lanes[:, wk.L_ANC]
    meta[:, tbd.M_TL] = np.where(skip, 0, lanes[:, wk.L_TL])
    meta[:, tbd.M_QL] = np.where(skip, 0, lanes[:, wk.L_QL])
    meta[:, tbd.M_S] = np.where(skip, 0, o[:, wk.O_S])
    meta[:, tbd.M_LS] = o[:, wk.O_LS]
    return meta


def band_max(opt: Options, bk: _Buckets, w_cap: int) -> int:
    """The widest band a batch of the bucket can reach (both sequences'
    lengths and the shrink slack, rounded up to 16384), clipped to
    W_full and the device's cap: the wide engine's window, where an
    oversized window costs memory and nothing per cycle."""
    ns = opt.max_pen + 1
    return min(-(-(bk.LT + bk.LQ + 2 * ns + 64) // 16384) * 16384,
               bk.W_full, w_cap)


def _wide_eligible(opt: Options, mode: int, W: int) -> bool:
    """Whether a dispatch goes to the wide engine: score runs past K1's
    WIDE_SCORE_W_MIN, pass-1 runs past WIDE_PASS1_W_MIN, up to WIDE_W_CAP
    (the JAX package's _wide_eligible, on every device)."""
    w_min = {MODE_SCORE: WIDE_SCORE_W_MIN,
             MODE_PASS1: WIDE_PASS1_W_MIN}.get(mode)
    return w_min is not None and w_min < W <= WIDE_W_CAP


def _run_wide(opt: Options, mode: int, bk: _Buckets,
              ts_list: List[bytes], qs_list: List[bytes],
              device: torch.device):
    """One wide-engine run over a batch, in resumable calls (lanes one
    after another, each over the whole card); returns as _run_kernel.
    Pass 1 starts with WIDE_SNAP_ROWS0 snapshot rows, grown under the
    pass-1 budget."""
    spec, lanes, tw, qw = kernel_inputs(opt, mode, bk.W, bk.S_CAP,
                                        ts_list, qs_list)
    if mode == MODE_PASS1:
        spec = dataclasses.replace(
            spec, n_snap=min(spec.n_snap, WIDE_SNAP_ROWS0))
    with span(None, "dispatch"):
        tw = torch.from_numpy(tw).to(device)
        qw = torch.from_numpy(qw).to(device)
        lanes_t = torch.from_numpy(lanes).to(device)
        out, snap, spec = ww.run_chunked(spec, lanes_t, tw, qw,
                                         snap_budget=_pass1_budget(device))
        hbm.note_arrays(f"wide-out mode={mode} B={len(ts_list)} "
                        f"W={spec.W} S_CAP={spec.S_CAP}", out, snap,
                        lanes_t, tw, qw)
    return out.cpu().numpy(), None, snap, lanes, tw, qw, spec


def _multi_g(mode: int, B: int, device: torch.device) -> int:
    """Lanes per block of the multi-lane engine K4 for a K1 dispatch, or 1
    (K1): K4 takes SCORE and TB (with or without checkpoints) batches of
    more than one lane when ``MWF_ENGINE=multi`` and ``pick_g`` packs them
    (exact.py:339-365 of the JAX package)."""
    if os.environ.get("MWF_ENGINE") != "multi" or B < 2 \
            or mode not in (MODE_SCORE, MODE_TB):
        return 1
    return wm.pick_g(mode, B, device)


def _run_kernel(opt: Options, mode: int, bk: _Buckets,
                ts_list: List[bytes], qs_list: List[bytes],
                device: torch.device, segs=None):
    """One wavefront dispatch over a batch; returns the outputs (out as
    numpy, tb and snap on the device) and the inputs the walker and the
    checkpoint decoder reuse.  Windows past K1's go to the wide engine;
    with ``MWF_ENGINE=multi``, K1's SCORE and TB batches to K4."""
    if _wide_eligible(opt, mode, bk.W):
        return _run_wide(opt, mode, bk, ts_list, qs_list, device)
    spec, lanes, tw, qw = kernel_inputs(opt, mode, bk.W, bk.S_CAP,
                                        ts_list, qs_list)
    with span(None, "dispatch"):
        tw = torch.from_numpy(tw).to(device)
        qw = torch.from_numpy(qw).to(device)
        sg = seg_input(segs)
        lanes_t = torch.from_numpy(lanes).to(device)
        sg = None if sg is None else torch.from_numpy(sg).to(device)
        G = _multi_g(mode, len(ts_list), device)
        out, tb, _, snap = wk.wavefront(spec, lanes_t, tw, qw, sg) \
            if G == 1 else wm.wavefront_multi(spec, G, lanes_t, tw, qw, sg)
    return out.cpu().numpy(), tb, snap, lanes, tw, qw, spec


def first_bucket(opt: Options, mode: int, ts_list, qs_list, w0: int,
                 s0: int, device: torch.device) -> Tuple[_Buckets, int]:
    """The first dispatch's bucket for a batch in ``mode``, and the
    device's window cap.  On the card most ladder rungs are replaced by
    upfront sizing."""
    with span(None, "size"):
        bk = _buckets_for(opt, ts_list, qs_list, w0, s0)
        if mode == MODE_SCORE:
            # score mode holds no buffer that scales with S_CAP: use the
            # full score bound, so the ladder only ever re-runs for the
            # window
            bk = _Buckets(bk.LT, bk.LQ, bk.W, bk.S_full, bk.W_full,
                          bk.S_full)
        w_cap = (_pass1_w_cap(opt, device) if mode == MODE_PASS1
                 else _device_w_cap(mode, device))
        if bk.W > w_cap:
            bk = _Buckets(bk.LT, bk.LQ, w_cap, bk.S_CAP, bk.W_full,
                          bk.S_full)
        if device.type != "cuda" or len(ts_list) > 64:
            return bk, w_cap
        if mode == MODE_SCORE:
            # cycles sweep only the live band, so an oversized window
            # costs memory and nothing per cycle: jump to 65536 diagonals
            return _Buckets(bk.LT, bk.LQ,
                            max(bk.W, min(bk.W_full, w_cap, 65536)),
                            bk.S_CAP, bk.W_full, bk.S_full), w_cap
        # TB's tb table (S_CAP*W bytes/lane) and PASS1's planes and
        # snapshot rows scale with W and S_CAP, so both must stay near the
        # real band: size them from the k-mer divergence estimate,
        # replacing the caller's w0/s0 hints.  Pass 1 takes more window
        # slack, since an abandoned rung re-runs it whole and reallocates
        # its snapshots.  The estimate's k-mer counts run on the card,
        # idle until the first dispatch, and their table is freed before
        # it.
        s_cap_e, s_band_e = _estimate_s(opt, ts_list, qs_list, device)
        if not s_cap_e:
            return bk, w_cap
        ns = opt.max_pen + 1
        slack = 4 * ns + 64 if mode == MODE_PASS1 else 2 * ns + 24
        d_span = max(abs(len(q) - len(t))
                     for t, q in zip(ts_list, qs_list))
        est = _Buckets(bk.LT, bk.LQ,
                       min(_next_pow2(2 * s_band_e + d_span + slack),
                           bk.W_full, w_cap),
                       min(_next_pow2(s_cap_e), bk.S_full), bk.W_full,
                       bk.S_full)
        if mode == MODE_PASS1:
            fits = _pass1_lane_bytes(opt, est) <= _pass1_budget(device)
        else:
            fits = est.S_CAP * est.W <= _tb_budget(device)
        return (est if fits else bk), w_cap


def pass2_bucket(opt: Options, s_p1: Sequence[int], ts_list, qs_list,
                 w0: int, s0: int, device: torch.device
                 ) -> Tuple[_Buckets, int]:
    """Pass 2's bucket and the device's TB window cap.  It reaches pass
    1's score exactly, so its cycle budget is sized from it; its band
    collapses to one diagonal every step scores, so the window takes the
    tighter of that bound and the uncollapsed 2s bound."""
    with span(None, "size"):
        bk = _buckets_for(opt, ts_list, qs_list, w0, s0)
        w_cap = _device_w_cap(MODE_TB, device)
        ns = opt.max_pen + 1
        d_span = max(abs(len(q) - len(t))
                     for t, q in zip(ts_list, qs_list))
        w2 = min(_next_pow2(2 * opt.step + 2 * ns + 24),
                 _next_pow2(2 * max(s_p1) + d_span + 2 * ns + 24))
        return _Buckets(bk.LT, bk.LQ, min(w2, bk.W_full, w_cap),
                        min(-(-(max(s_p1) + 4) // 4096) * 4096, bk.S_full),
                        bk.W_full, bk.S_full), w_cap


def _run_pass1(opt: Options, ts_list: List[bytes], qs_list: List[bytes],
               w0: int, s0: int, device: torch.device
               ) -> Tuple[List[Seg], List[int]]:
    """Low-mem pass 1 for a batch (reference mwf_wfa_seg,
    miniwfa.c:551-601): per-pair checkpoint lists and optimal scores.
    Lanes are chunked under the pass-1 budget; overflowed lanes re-run in
    an escalated bucket.  A window past WIDE_PASS1_W_MIN (the wide
    engine's territory) is sized once at the largest band the pair can
    reach, clipped to the cap: the wide engine's cycles sweep only the live
    band, so the oversized window costs memory and nothing per cycle; the
    band overflows at about W/2, which bounds the score and so S_CAP; and
    the snapshot rows start small and grow between calls (exact.py:577-592
    of the JAX package)."""
    bk, w_cap = first_bucket(opt, MODE_PASS1, ts_list, qs_list, w0, s0,
                             device)
    n = len(ts_list)
    segs: List[Optional[Seg]] = [None] * n
    s_fin = [0] * n
    idx = list(range(n))
    sized = False
    while idx:
        if not sized and bk.W > WIDE_PASS1_W_MIN:
            sized = True
            W = max(band_max(opt, bk, w_cap), bk.W)
            S = min(-(-(W // 2 + 4 * (opt.max_pen + 1) + 64) // 4096) * 4096,
                    bk.S_full)
            bk = _Buckets(bk.LT, bk.LQ, W, S, bk.W_full, bk.S_full)
        cap = _pass1_lane_cap(opt, bk, device)
        idx, idx_rest = idx[:cap], idx[cap:]
        o, _, snap, lanes, _, _, spec = _run_kernel(
            opt, MODE_PASS1, bk, [ts_list[i] for i in idx],
            [qs_list[i] for i in idx], device)
        ovf = (o[:, wk.O_OVFB] | o[:, wk.O_OVFS]) != 0
        with span(None, "checkpoints"):
            # chase the chains on the device; only one pointer per
            # snapshot row and lane comes back
            fin, recs = tbd.chain_ptrs(snap,
                                       np.where(ovf, -1, o[:, wk.O_LP]),
                                       np.where(ovf, 0, o[:, wk.O_SNC]))
            snap = None   # free the snapshots before the next dispatch
            retry = []
            for j, i in enumerate(idx):
                if ovf[j]:
                    retry.append(i)
                    continue
                s_fin[i] = int(o[j, wk.O_S])
                segs[i] = tbk.decode_checkpoints_ptrs(
                    recs[:, j], int(fin[j]), int(lanes[j, wk.L_ANC]),
                    int(o[j, wk.O_SNC]), spec)
        if retry:
            need_band = bool(o[:, wk.O_OVFB].any())
            if need_band and bk.W >= min(bk.W_full, w_cap):
                raise RuntimeError(
                    f"low-mem pass-1 band exceeded the device limit "
                    f"(W={bk.W}, cap {w_cap}) — use a larger card or the "
                    f"CPU device")
            bk = _escalate(bk, need_band, bool(o[:, wk.O_OVFS].any()))
            bk = _Buckets(bk.LT, bk.LQ, min(bk.W, w_cap), bk.S_CAP,
                          bk.W_full, bk.S_full)
        idx = retry + idx_rest
    return segs, s_fin  # type: ignore[return-value]


def check_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' needs a CUDA device, and "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def align_batch(pairs: Sequence[Tuple[object, object]], opt: Options,
                *, w0: int = 512, s0: int = 512, band_limit: str = "raise",
                device="cuda") -> List[Result]:
    """Exact alignment of a batch of (target, query) pairs on ``device``.

    ``band_limit`` says what happens to a pair whose band outgrows the
    largest window the device serves: "raise" (default) raises a
    RuntimeError; "stop" returns s=-1 for it, like a max_iter stop (the
    auto driver's policy: it falls back to chaining, as mwf_wfa_auto
    treats a failed attempt, miniwfa.c:903-907)."""
    if band_limit not in ("raise", "stop"):
        raise ValueError(f"band_limit must be 'raise' or 'stop', got "
                         f"{band_limit!r}")
    device = check_device(device)
    ts_list = [as_bytes(t) for t, _ in pairs]
    qs_list = [as_bytes(q) for _, q in pairs]
    n = len(pairs)
    results: List[Optional[Result]] = [None] * n
    if n == 0:
        return []
    mode = MODE_TB if opt.cigar else MODE_SCORE
    tb_budget = _tb_budget(device) if device.type == "cuda" else 0

    segs: Optional[List[Optional[Seg]]] = None
    run_pass1 = opt.step > 0 and opt.cigar
    if run_pass1:
        # huge-step shortcut: when every pair's score upper bound (the
        # trivial alignment: min(tl, ql) mismatches + one |tl-ql| gap) is
        # below step, pass 1 cannot take a snapshot, and pass 2 is the
        # plain high-mem run — identical output, n_iter included
        s_ub = max(opt.x * min(len(t), len(q))
                   + (opt.gap_cost(abs(len(t) - len(q)))
                      if len(t) != len(q) else 0)
                   for t, q in zip(ts_list, qs_list))
        run_pass1 = s_ub >= opt.step
    if run_pass1:
        segs, s_p1 = _run_pass1(opt, ts_list, qs_list, w0, s0, device)
        bk, w_cap = pass2_bucket(opt, s_p1, ts_list, qs_list, w0, s0, device)
    else:
        bk, w_cap = first_bucket(opt, mode, ts_list, qs_list, w0, s0, device)

    pens = (opt.x, opt.o1, opt.e1, opt.o2, opt.e2)
    idx = list(range(n))
    cur_bk = bk
    while idx:
        if mode == MODE_TB and device.type == "cuda":
            # the tb buffer is B * S_CAP * W bytes: chunk the batch so one
            # dispatch stays under the budget
            per_lane = max(1, cur_bk.S_CAP * cur_bk.W)
            cap = _prev_pow2(max(1, tb_budget // per_lane))
        else:
            cap = len(idx)
        idx, idx_rest = idx[:cap], idx[cap:]
        sub_t = [ts_list[i] for i in idx]
        sub_q = [qs_list[i] for i in idx]
        o, tb, _, lanes, tw, qw, spec = _run_kernel(
            opt, mode, cur_bk, sub_t, sub_q, device,
            None if segs is None else [segs[i] for i in idx])
        ovf_b = o[:, wk.O_OVFB] != 0
        ovf_s = o[:, wk.O_OVFS] != 0
        ovf = ovf_b | ovf_s
        stopped = o[:, wk.O_STOP] != 0
        cigs = None
        if opt.cigar:
            with span(None, "cigars"):
                meta = torch.from_numpy(walk_meta(lanes, o)).to(device)
                runs, counts = tbd.walk(tb, meta, tw, qw, spec.cpw, pens)
                cigs = tbd.to_cigars(runs, counts)
        tb = tw = qw = None   # free the traceback buffer before a re-run
        retry = []
        for j, i in enumerate(idx):
            if ovf[j]:
                retry.append(i)
                continue
            n_iter = int(o[j, wk.O_NITER])
            if stopped[j]:
                results[i] = Result(s=-1, cigar=None, n_iter=n_iter)
                continue
            results[i] = Result(s=int(o[j, wk.O_S]),
                                cigar=cigs[j] if cigs is not None else None,
                                n_iter=n_iter)
        need_band = bool(ovf_b.any())
        if need_band and cur_bk.W >= min(cur_bk.W_full, w_cap):
            # the band outgrew the largest window the device serves
            if band_limit != "stop":
                raise _band_limit_error(opt, mode, cur_bk.W, w_cap)
            for j, i in enumerate(idx):
                if ovf_b[j]:
                    results[i] = Result(s=-1, cigar=None,
                                        n_iter=int(o[j, wk.O_NITER]))
            retry = [i for j, i in enumerate(idx)
                     if ovf_s[j] and not ovf_b[j]]
            need_band = False
        if retry:
            cur_bk = _escalate(cur_bk, need_band, bool(ovf_s.any()))
            new_w = min(cur_bk.W, w_cap)
            if need_band and mode == MODE_SCORE and \
                    new_w > WIDE_SCORE_W_MIN:
                # past K1's windows the wide engine's cycles sweep only the
                # live band, so an oversized window costs memory and
                # nothing per cycle: jump to the largest band the pair can
                # reach instead of re-running W/2 cycles per x4 rung
                # (exact.py:966-975 of the JAX package)
                new_w = max(new_w, band_max(opt, cur_bk, w_cap))
            cur_bk = _Buckets(cur_bk.LT, cur_bk.LQ, new_w, cur_bk.S_CAP,
                              cur_bk.W_full, cur_bk.S_full)
        idx = retry + idx_rest
    return results  # type: ignore[return-value]


def align_exact(ts, qs, opt: Options, *, w0: int = 512, s0: int = 512,
                device="cuda") -> Result:
    """Exact alignment of one pair; mirrors mwf_wfa_exact (miniwfa.c:603)."""
    return align_batch([(ts, qs)], opt, w0=w0, s0=s0, device=device)[0]
