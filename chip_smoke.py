#!/usr/bin/env python3
"""Chip smoke test of miniwfa_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the CUDA kernels from
   miniwfa_tpu_torch/csrc (one nvcc per source, started together);
2. holds the wavefront kernel (K1) against its plain PyTorch version on
   the card, SCORE and TB modes, on the golden corpus (four penalty
   regimes, and two of large gap-open costs, o2=40 and o2=100 with e2=1)
   and on 8 of the 8 kb benchmark pairs: every per-lane output, every
   traceback byte and every recorded band must be equal, and the
   multi-lane kernel (K4) at 2, 4 and 8 lanes per block must equal the
   same plain outputs in every SCORE, TB and TB+seg check; then the
   low-mem modes on the goldens (step 16 and 100) and the 8 kb pairs
   (step 200): K1 PASS1 (every output and the whole snapshot buffer),
   the checkpoint chain from both snapshot buffers, and K1 TB with the
   decoded checkpoints (every output and traceback byte); then the gaps
   kernel (K3) in SCORE and TB modes at cpw 16 and 4 on every gap fill of
   at most 127 bp in the goldens' chain plans, on seeded random gaps with
   the edge pairs, and with a max_s early stop: every output and every
   traceback byte must be equal (and on the goldens' gaps at the large
   gap-open costs); then the wide kernel (one lane over the whole card)
   against its plain version, SCORE and PASS1 at W=16384 on the goldens
   (step 16) and the 8 kb pairs (step 200), and SCORE on the goldens of at
   most 256 bp at the large gap-open costs, in one call (every output, the
   state row, the planes and the snapshot rows) and in calls of 77 cycles
   a lane (every output and the snapshot rows), at the chooser's variant
   and tile, and on the goldens also at a forced small tile and in the
   forced "cycle" variant;
3. holds the CIGAR walker (W1) against its plain version on phase 2's
   traceback outputs, K1's and K3's: identical run lists; and the
   checkpoint chain (W2) against its plain version on K1's snapshots;
4. drives the main path, ``align_batch`` on 16 pairs of 100 kb at 2% divergence
   in score, CIGAR and low-mem (step 5000) modes, checks every score and CIGAR
   digest against tests/data/bench_goldens.json, that each CIGAR re-scores and
   consumes both sequences, and that each mode's kernels were launched (counts
   set to 0 just before each run and read just after; so is the peak-memory
   meter, utils/hbm.py, whose peak dispatch and tag each run prints beside
   its peak_bytes, and which must lie above 0 and at most at
   peak_bytes), K1 as a cluster of C > 1
   CTAs per lane (each mode's C and the card's count of co-resident clusters of
   C printed); score and CIGAR again with ``MWF_ENGINE=multi MWF_KERNEL_G=4``
   (K4 at 4 lanes per block, launched and no K1), their walls beside K1's; then
   the chain (-u -c) and auto (-t -c) modes on the scale fixtures, up to div5m
   (5 Mb), against tests/data/scale_goldens.json, with the split of div5m
   auto's wall, and div5m auto on the multi-lane route, its K1 gap fills span
   beside the K1 run's; phase 4e: t3 at o2=40 and o2=100 in exact, -p 16, -u
   and -t modes, each equal to the JAX package's (s, n_iter, CIGAR); then the
   wide path: ``align_batch`` in score mode on dissim150k, nbear1m and sv300k
   and in low-mem mode (step 5000) on those and div5m, against
   scale_goldens.json, each run with its wall, peak memory, wide calls and
   kernel time, and pass 1's wall apart from pass 2's with W1's kernel
   time in pass 2 (CUDA events around every walk call, as around every
   wide call); div5m auto's wall split also carries W1's kernel time;
   phase 4f, the sharded path (miniwfa_tpu_torch/parallel/) on the one
   card: the main path through ``align_batch_sharded`` on 4 mesh entries
   of cuda:0 in all three modes, each (s, n_iter, CIGAR) equal to phase
   4's and to the goldens, its walls beside phase 4's; dissim150k and
   sv300k in score mode on 2 entries (the wide kernel) against
   scale_goldens.json; ``dryrun_multichip(4)``; and a 2-rank gloo job of
   miniwfa_tpu_torch/tools/mp_worker.py on cuda:0, each rank printing
   MP_OK;
5. times each K1 mode, W1 and the checkpoint chain (W2) at the main
   path's first dispatch shape of that mode (CUDA events); holds each K1
   mode against its plain version at that shape with every lane stopped
   past score MAIN_CUT (a whole run of the plain K1 there takes minutes),
   W1 in each variant against walk_plain on the whole CIGAR and low-mem
   pass-2 tracebacks (with its time a step of the longest lane's walk:
   DP steps plus match words), and W2 against its plain version (the
   torch.gather chain, timed beside it as its library yardstick); times
   the plain versions, with the kernels beside them and held equal, at
   the 8 kb benchmark shape; K3 SCORE and TB and W1 in each variant on
   K3's traceback against their plain versions at div5m auto's first K3
   dispatch;
   nbear1m's score run in K1 (one cluster) and in the wide kernel (the whole
   card) at the same window, held equal; the wide kernel against
   wide_plain at the specs of phase 4d's nbear1m score and div5m pass 1
   for their first few thousand cycles; K4 at G=4 at the main path's
   SCORE and TB shapes (its "global" variant: the rings do not fit shared
   memory), held equal to K1 there, whole and with its lanes stopped past
   MAIN_CUT; and K1 against K4 at 2, 4 and 8 lanes per block (its "smem"
   variant, a warp a lane) on 2048 pairs of 1 kb (the chain's K1 gap
   fills come in chunks of 2048) in SCORE and TB, each against the plain
   version; K3 by width class (csrc/gaps.cu, every class the dispatch
   holds); the ksim kernel at the main path's pairs
   (``tools/ksim_bench.time_counts``: its launch by CUDA events, its plain
   version on the card, the host's sorts), held equal to both;
6. runs the port's benchmarks, each in its own process: ``bench_cuda.py``
   with one timed run and no 2 x 200 kb row (phase 4 has held the same
   rows; this checks the entry point and its JSON line, parity included)
   and ``python -m miniwfa_tpu_torch.tools.scaling_bench 100000 16``, the
   main path's 16 pairs of 100 kb on every card; a non-zero exit fails
   the run.

The tolerance of every comparison is exact equality: both versions run
the same integer algorithm.  Prints a ``kernels`` JSON line (each entry's
``ms``, ``bound_ms`` and ``bound_by`` are phase 5's at the main path's
shape: the wavefront entry's SCORE's, the gaps entry's TB's, the wide
entry's nbear1m score's, the multi entry's SCORE's at G=4 (its global
variant); ``plain_ms`` is the plain version's at the 8 kb shape (the
multi entry's at the 2048 x 1 kb shape), beside the kernel's own time
there, ``plain_shape_kernel_ms`` (the smem variant's at G=8); the multi
entry's ``gap_fills`` keep SCORE's times at 2048 x 1 kb by G (TB's under
``TB``),
``variants`` each variant's source and ``launches_by_variant`` its
launches; the gaps entry's ``launches`` count kernel launches, one per
width class a dispatch holds (``launches_by_variant`` by the class's
window slots), and its ``classes`` the first dispatch's gaps by window
slots;
the wide entry's ``launches_by_variant`` counts phase 4d's launches of
each variant, ``checks_by_variant`` those of phase 2+3's comparisons
with wide_plain; ``modes`` holds every mode's launches in the main path's
runs, its times and (K1) its C and co-resident cluster count, the wide
entry's
PASS1 those of div5m's pass 1, summed over its calls; ``launches``
sums phase 4's runs, ``main_launches`` (W1, W2) the main path's alone;
every entry's ``sharded_launches`` counts phase 4f's launches apart;
the ksim entry's ``ms`` is its launch at the main path's pairs (the
table's fill and both kernels), ``kernels_us`` each kernel's device time,
``plain_ms`` its plain version on the card at the same pairs,
``wrapper_ms`` the whole ``ksim_counts`` call and ``host_ms`` the host's
``kmer.ksims``;
the walk entry also carries the variant each shape picked and each
variant's time, and the chain_ptrs entry's ``library_ms`` is the
torch.gather chain at the main shape) and, last, a JSON line with
``"ok": true`` and the device.  Exits non-zero without a CUDA device,
outside a checkout of the repository, or if any check fails.

``bound_ms`` is the least time the card could take for the same work: the
larger of the bytes the call must move (inputs read once, outputs written
once, the traceback's in-band cells only) over 3.35 TB/s, and its int32
operations over the card's int32 instruction rate (132 SMs x 64 INT32
lanes x 1.98 GHz, NVIDIA's Hopper white paper and H100 SXM data sheet).
Operations are counted per wavefront cell (Σ n_iter of this run) from the
kernels' transition code, csrc/gaps.cu and csrc/wavefront_common.cuh:
OPS_SCORE for the 5-state recurrence and its extension probe, plus OPS_TB
for the tb byte, or OPS_PASS1 for the pointer choice (the wide kernel
runs the same cell code as K1); the walker's per DP step and per match
word.  The checkpoint chain's bound is its bytes alone.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MAIN, B_MAIN = 100_000, 16
STEP_MAIN = 5000
# phase 5 holds each K1 mode against its plain version at the main path's
# shapes with every lane stopped past score MAIN_CUT (max_s); the low-mem
# modes there run at step CUT_STEP, so a snapshot (score 999) and its
# checkpoint collapse fall before the stop
MAIN_CUT, CUT_STEP = 1100, 1000
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per cell: max/+1/compare-select of the recurrence (19)
# and the extension's XOR/ctz probe (1); the tb byte's 4 compares, shifts
# and ORs (14); PASS1's pointer selects (5) and source tests (4)
OPS_SCORE, OPS_TB, OPS_PASS1 = 20, 14, 9
# the walker: one DP step decodes a tb byte (~12 ops), one match word is
# two funnel shifts, an XOR, a clz and the cursor updates (~8)
OPS_WALK_STEP, OPS_WALK_WORD = 12, 8
# large gap-open costs (o2, with e2=1) of the penalty checks
PENALTY_O2 = (40, 100)
# t3 (goldens.json) at those penalties: (s, n_iter, CIGAR) by mode, the
# JAX package's values (tests/test_torch_penalties.py pins the same)
T3_EXACT = "1X16=1X14=128I4=1X24="
T3_CHAIN = "1X16=1X18=128I1X24="
T3_PENALTIES = {
    40: {"exact": (180, 18100, T3_EXACT), "p16": (180, 17836, T3_EXACT),
         "chain": (180, 11818, T3_CHAIN), "auto": (180, 18100, T3_EXACT)},
    100: {"exact": (240, 25510, T3_EXACT), "p16": (240, 24900, T3_EXACT),
          "chain": (240, 16708, T3_CHAIN), "auto": (240, 25510, T3_EXACT)}}
# chain (-u -c) and auto (-t -c) runs on the scale fixtures
SCALE_RUNS = (("chain", ("div100k", "sv300k", "rep200k", "dissim150k",
                         "nbear1m")),
              ("auto", ("del50k", "div100k", "dissim150k", "nbear1m",
                        "div5m")))


def make_pairs(n, b, seed=7):
    """``tools/pairs.make_pairs``, imported when called: after main()'s
    checks, which say what is missing before the package is imported."""
    from miniwfa_tpu_torch.tools.pairs import make_pairs as make
    return make(n, b, seed)


def gen_case(name):
    """The scale fixtures of tests/data/scale_goldens.json
    (``tools/pairs.scale_case``), imported when called."""
    from miniwfa_tpu_torch.tools.pairs import scale_case
    return scale_case(name)


def _reset_counts():
    from miniwfa_tpu_torch.ops import kmer
    from miniwfa_tpu_torch.ops import traceback_device as tbd
    from miniwfa_tpu_torch.ops import wavefront_gaps as wg
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    from miniwfa_tpu_torch.ops import wavefront_multi as wm
    from miniwfa_tpu_torch.ops import wavefront_wide as ww
    wk.wavefront.launches = 0
    wk.wavefront.launches_by_mode.clear()
    wk.wavefront.clusters.clear()
    wm.wavefront_multi.launches = 0
    wm.wavefront_multi.launches_by_mode.clear()
    wm.wavefront_multi.launches_by_variant.clear()
    wm.wavefront_multi.variants.clear()
    ww.wide.launches = 0
    ww.wide.launches_by_mode.clear()
    ww.wide.launches_by_variant.clear()
    tbd.walk.launches = 0
    tbd.walk.launches_by_variant.clear()
    tbd.chain_ptrs.launches = 0
    wg.gaps.launches = 0
    wg.gaps.launches_by_variant.clear()
    wg.gaps.dispatches = 0
    kmer.ksim_counts.launches = 0
    kmer.ksim_counts.launches_by_card.clear()


def _read_counts() -> dict:
    from miniwfa_tpu_torch.ops import kmer
    from miniwfa_tpu_torch.ops import traceback_device as tbd
    from miniwfa_tpu_torch.ops import wavefront_gaps as wg
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    from miniwfa_tpu_torch.ops import wavefront_multi as wm
    from miniwfa_tpu_torch.ops import wavefront_wide as ww
    return {"wavefront": wk.wavefront.launches, "walk": tbd.walk.launches,
            "walk_variants": dict(tbd.walk.launches_by_variant),
            "chain_ptrs": tbd.chain_ptrs.launches,
            "gaps": wg.gaps.launches,
            "gaps_dispatches": wg.gaps.dispatches,
            "gaps_classes": dict(wg.gaps.launches_by_variant),
            "modes": dict(wk.wavefront.launches_by_mode),
            "clusters": dict(wk.wavefront.clusters.get(0, {})),
            "multi": wm.wavefront_multi.launches,
            "multi_modes": dict(wm.wavefront_multi.launches_by_mode),
            "multi_variants": dict(wm.wavefront_multi.launches_by_variant),
            "wide": ww.wide.launches,
            "wide_modes": dict(ww.wide.launches_by_mode),
            "wide_variants": dict(ww.wide.launches_by_variant),
            "ksim": kmer.ksim_counts.launches}


def _bound(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the int32 operations over the instruction rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _k1_bound(spec, args, segs, got):
    """K1's bound on this call: inputs and outputs, the in-band tb cells
    (= n_iter) and band rows, the snapshot entries taken."""
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    out = got[0]
    cells = int(out[:, wk.O_NITER].sum())
    nbytes = _nbytes(*args, segs, out)
    ops = cells * OPS_SCORE
    if spec.mode == wk.MODE_TB:
        nbytes += cells + 8 * int(out[:, wk.O_S].clamp(min=0).sum())
        ops += cells * OPS_TB
    if spec.mode == wk.MODE_PASS1:
        nbytes += 4 * int((got[3] != wk.WF_NEG_INF).sum())
        ops += cells * OPS_PASS1
    return _bound(nbytes, ops)


def _walk_bound(cigs, tw, qw, meta, cpw):
    """W1's bound on this call: the sequence words and per-lane inputs,
    one tb byte per DP step, the runs written."""
    steps = sum((c >> 4) for cg in cigs for c in cg if (c & 0xF) != 7)
    words = sum(-(-(c >> 4) // cpw) for cg in cigs for c in cg
                if (c & 0xF) == 7)
    runs = sum(len(cg) for cg in cigs)
    nbytes = _nbytes(tw, qw, meta) + steps + 4 * runs
    return _bound(nbytes, steps * OPS_WALK_STEP + words * OPS_WALK_WORD)


def _gaps_bound(spec, args, out):
    """K3's bound on this call: inputs and outputs and, in TB mode, the
    in-band tb cells (= n_iter)."""
    from miniwfa_tpu_torch.ops import wavefront_gaps as wg
    cells = int(out[:, wg.GO_NI].sum())
    nbytes = _nbytes(*args, out)
    ops = cells * OPS_SCORE
    if spec.mode == wg.MODE_TB:
        nbytes += cells
        ops += cells * OPS_TB
    return _bound(nbytes, ops)


def _ms(fn):
    """(result, milliseconds) of one call, timed with CUDA events."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def _max_err(a, b) -> int:
    """Largest absolute difference of two integer tensors (None = None),
    taken lane by lane so a multi-GB traceback table is never widened
    whole."""
    if a is None or b is None:
        return 0 if a is None and b is None else 1 << 62
    if a.shape != b.shape:
        return 1 << 62
    if a.numel() == 0 or a.equal(b):
        return 0
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


class Smoke:
    def __init__(self, dev):
        self.dev = dev
        self.failures = []
        self.err = {"wavefront": 0, "walk": 0, "gaps": 0, "chain_ptrs": 0,
                    "wavefront_wide": 0, "wavefront_multi": 0, "probes": 0,
                    "ksim": 0}

    def check(self, cond: bool, what: str) -> None:
        print(f"  {'ok  ' if cond else 'FAIL'} {what}", flush=True)
        if not cond:
            self.failures.append(what)

    def k1_pair(self, label, opt, mode, W, S_CAP, ts, qs, segs=None,
                keep_plain=False):
        """Run K1 and its plain version on one batch (``segs``: checkpoint
        lists for pass 2); returns the kernel's outputs and inputs for the
        walker phase, and the plain outputs when asked."""
        import torch
        from miniwfa_tpu_torch.models import exact
        from miniwfa_tpu_torch.ops import wavefront_kernel as wk
        spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, W, S_CAP, ts, qs)
        lanes_t = torch.from_numpy(lanes).to(self.dev)
        tw_t = torch.from_numpy(tw).to(self.dev)
        qw_t = torch.from_numpy(qw).to(self.dev)
        sg = exact.seg_input(segs)
        sg = None if sg is None else torch.from_numpy(sg).to(self.dev)
        got = wk.wavefront(spec, lanes_t, tw_t, qw_t, sg)
        torch.cuda.synchronize()
        want = wk.wavefront_plain(spec, lanes_t, tw_t, qw_t, sg)
        err = max(_max_err(g, w) for g, w in zip(got, want))
        self.err["wavefront"] = max(self.err["wavefront"], err)
        done = int(got[0][:, wk.O_DONE].sum())
        self.check(err == 0, f"K1 {label} mode={wk.launch_mode(spec, sg)} "
                   f"cpw={spec.cpw} B={len(ts)} W={W} S_CAP={S_CAP}: "
                   f"{done} done, max_abs_err={err}")
        if mode != wk.MODE_PASS1:
            self.k4_pair(label, spec, (lanes_t, tw_t, qw_t, sg), want)
        if keep_plain:
            return spec, lanes, got, tw_t, qw_t, want
        return spec, lanes, got, tw_t, qw_t

    def k4_pair(self, label, spec, args, want):
        """K4 at G = 2, 4 and 8 on K1's inputs, each held against the
        plain outputs K1 was held against (every output, traceback byte
        and band row)."""
        from miniwfa_tpu_torch.ops import wavefront_kernel as wk
        from miniwfa_tpu_torch.ops import wavefront_multi as wm
        errs = []
        for G in wm.GS:
            got = wm.wavefront_multi(spec, G, *args)
            errs.append(max(_max_err(g, w) for g, w in zip(got, want)))
            del got
        err = max(errs)
        self.err["wavefront_multi"] = max(self.err["wavefront_multi"], err)
        self.check(err == 0, f"K4 {label} mode="
                   f"{wk.launch_mode(spec, args[3])} G={wm.GS}: "
                   f"max_abs_err={errs}")

    def wide_pair(self, label, spec, args, plain=None, **forced):
        """The wide kernel against wide_plain in one call (every output,
        the state row, the planes and the snapshot rows), then in
        run_chunked's calls of 77 cycles per live lane (every output and
        the snapshot rows), at the chooser's variant and tile or at the
        ``forced`` ones (``wide``'s tile, batch, variant).  ``plain``: the
        (outputs, state, ms) of wide_plain's one call on these inputs, if
        already run.  Returns the plain outputs and the one-call times of
        both versions (CUDA events) with the kernel's variant, n and k,
        and the plain (outputs, state, ms)."""
        import torch
        from miniwfa_tpu_torch.ops import wavefront_kernel as wk
        from miniwfa_tpu_torch.ops import wavefront_wide as ww
        B = args[0].shape[0]
        big = torch.full((B,), 1 << 40, dtype=torch.int64, device=self.dev)
        if plain is None:
            pst = ww.new_state(spec, args[0])
            want, plain_ms = _ms(lambda: ww.wide_plain(spec, *args, pst,
                                                       big))
        else:
            want, pst, plain_ms = plain
        kst = ww.new_state(spec, args[0])
        before = ww.wide.launches
        real = ww.wide
        got, ms = _ms(lambda: real(spec, *args, kst, big, **forced))
        mode = wk.launch_mode(spec, None)
        tiles = dict(real.tiles[args[0].device.index][mode])
        one = [(got, want), (kst.row, pst.row), (kst.planes, pst.planes),
               (kst.snap, pst.snap)]
        del kst
        single = real.launches - before
        cycles, ww.CYCLES_PER_CALL = ww.CYCLES_PER_CALL, 77 * B

        def chunk(*a):
            return real(*a, **forced)

        # the counters live on the function the module's name points to
        chunk.__dict__ = real.__dict__
        ww.wide = chunk
        try:
            got, snap, _ = ww.run_chunked(spec, *args)
        finally:
            ww.CYCLES_PER_CALL = cycles
            ww.wide = real
        torch.cuda.synchronize()
        calls = real.launches - before - single
        how_t = (f"{tiles['variant']} n={tiles['n']} k={tiles['k']}"
                 + (" forced" if forced else ""))
        for how, pairs in (("one call", one),
                           (f"{calls} calls of 77 cycles a lane",
                            [(got, want[:, :wk.O_N]), (snap, pst.snap)])):
            err = max(_max_err(x, y) for x, y in pairs)
            self.err["wavefront_wide"] = max(self.err["wavefront_wide"], err)
            self.check(err == 0, f"wide {label} mode={mode} cpw={spec.cpw} "
                       f"B={B} W={spec.W} S_CAP={spec.S_CAP} {how_t}, "
                       f"{how}: {int(want[:, wk.O_DONE].sum())} done, "
                       f"max_abs_err={err}")
        return want, dict(ms=ms, plain_ms=plain_ms, **tiles,
                          plain=(want, pst, plain_ms))

    def checkpoints(self, label, spec, lanes, got, want):
        """The checkpoint chain: the W2 kernel over K1's snapshot buffer
        against chain_ptrs_plain over the same buffer and over the plain
        version's: identical pointers; returns the kernel's decoded
        checkpoint lists."""
        from miniwfa_tpu_torch.models import traceback as tbk
        from miniwfa_tpu_torch.ops import traceback_device as tbd
        from miniwfa_tpu_torch.ops import wavefront_kernel as wk

        def err(a, b):
            return int(max(abs(a[0] - b[0]).max(initial=0),
                           abs(a[1] - b[1]).max(initial=0)))

        o = got[0]
        fin, recs = tbd.chain_ptrs(got[3], o[:, wk.O_LP], o[:, wk.O_SNC])
        e_w2 = err((fin, recs), tbd.chain_ptrs_plain(
            got[3], o[:, wk.O_LP], o[:, wk.O_SNC]))
        e_k1 = err((fin, recs), tbd.chain_ptrs_plain(
            want[3], want[0][:, wk.O_LP], want[0][:, wk.O_SNC]))
        self.err["chain_ptrs"] = max(self.err["chain_ptrs"], e_w2)
        self.err["wavefront"] = max(self.err["wavefront"], e_k1)
        o = o.cpu().numpy()
        segs = [tbk.decode_checkpoints_ptrs(
            recs[:, j], int(fin[j]), int(lanes[j, wk.L_ANC]),
            int(o[j, wk.O_SNC]), spec) for j in range(len(lanes))]
        self.check(e_w2 == 0 and e_k1 == 0, f"W2 {label}: "
                   f"{sum(map(len, segs))} checkpoints decoded, chain "
                   f"pointers max_abs_err={e_w2} (against the plain chain), "
                   f"{e_k1} (over the plain K1's snapshots)")
        return segs

    def w1_pair(self, label, opt, spec, lanes, got, tw, qw):
        import torch
        from miniwfa_tpu_torch.models import exact
        from miniwfa_tpu_torch.ops import traceback_device as tbd
        o = got[0].cpu().numpy()
        meta = torch.from_numpy(exact.walk_meta(lanes, o)).to(self.dev)
        pens = (opt.x, opt.o1, opt.e1, opt.o2, opt.e2)
        k_runs = tbd.walk(got[1], meta, tw, qw, spec.cpw, pens)
        torch.cuda.synchronize()
        p_runs = tbd.walk_plain(got[1], meta, tw, qw, spec.cpw, pens)
        err = max(_max_err(a, b) for a, b in zip(k_runs, p_runs))
        self.err["walk"] = max(self.err["walk"], err)
        self.check(err == 0, f"W1 {label}: {int(k_runs[1].sum())} runs, "
                   f"max_abs_err={err}")
        return tbd.to_cigars(*k_runs)

    def k3_pair(self, label, opt, cpw, pairs):
        """K3 and its plain version on one dispatch of gaps (every output
        and traceback byte), then, in TB mode, W1 over K3's traceback
        against walk_plain."""
        import torch
        from miniwfa_tpu_torch.models import tiny
        from miniwfa_tpu_torch.ops import traceback_device as tbd
        from miniwfa_tpu_torch.ops import wavefront_gaps as wg
        ts, qs = [p[0] for p in pairs], [p[1] for p in pairs]
        s_cap = tiny._scap_bucket(max(tiny._s_bound(opt, len(t), len(q))
                                      for t, q in pairs))
        spec, lens, tw, qw = tiny.dispatch_inputs(opt, ts, qs, cpw, s_cap)
        args = [torch.from_numpy(a).to(self.dev) for a in (lens, tw, qw)]
        got = wg.gaps(spec, *args)
        torch.cuda.synchronize()
        want = wg.gaps_plain(spec, *args)
        err = max(_max_err(g, w) for g, w in zip(got, want))
        self.err["gaps"] = max(self.err["gaps"], err)
        out = got[0].cpu().numpy()
        ended = int((out[:, wg.GO_DONE] | out[:, wg.GO_STOP]).sum())
        mode = "TB" if spec.mode == wg.MODE_TB else "SCORE"
        self.check(err == 0 and ended == len(pairs),
                   f"K3 {label} mode={mode} cpw={cpw} G={len(pairs)} "
                   f"S_CAP={s_cap}: {int(out[:, wg.GO_DONE].sum())} done, "
                   f"{int(out[:, wg.GO_STOP].sum())} stopped, "
                   f"max_abs_err={err}")
        if spec.mode != wg.MODE_TB:
            return
        meta = torch.from_numpy(tiny.walk_meta(lens, out)).to(self.dev)
        pens = (opt.x, opt.o1, opt.e1, opt.o2, opt.e2)
        k_runs = tbd.walk(got[1], meta, args[1], args[2], cpw, pens)
        torch.cuda.synchronize()
        p_runs = tbd.walk_plain(got[1], meta, args[1], args[2], cpw, pens)
        err = max(_max_err(a, b) for a, b in zip(k_runs, p_runs))
        self.err["walk"] = max(self.err["walk"], err)
        self.check(err == 0, f"W1 on K3 {label} cpw={cpw}: "
                   f"{int(k_runs[1].sum())} runs, max_abs_err={err}")


def kernel_phases(smoke: Smoke) -> None:
    """Phases 2 and 3: the kernels against their plain versions."""
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk

    with open(os.path.join(ROOT, "tests", "data", "goldens.json")) as f:
        gold = json.load(f)
    cases = gold["cases"]
    ts = [c["t"].encode("latin1") for c in cases]
    qs = [c["q"].encode("latin1") for c in cases]
    acgt = [i for i, (t, q) in enumerate(zip(ts, qs))
            if not (set(t + q) - set(b"ACGT"))]
    base = Options(**gold["penalties"])
    regimes = (("score", base, wk.MODE_SCORE),
               ("cigar", base.replace(cigar=True), wk.MODE_TB),
               ("edit_cigar", base.replace(cigar=True).as_edit_distance(),
                wk.MODE_TB),
               ("affine_cigar", base.replace(cigar=True).as_single_affine(),
                wk.MODE_TB))
    # large gap-open costs (max_pen 41 and 101), which goldens.json does
    # not hold: the kernels against their plain versions only
    regimes += tuple((f"o2={o2}_cigar", base.replace(cigar=True, o2=o2, e2=1),
                      wk.MODE_TB) for o2 in PENALTY_O2)
    print("phase 2+3: kernels against their plain versions", flush=True)
    for run, opt, mode in regimes:
        # the whole corpus packs at cpw=4 (it holds lowercase and
        # non-ACGT bytes); its ACGT-only subset packs at cpw=16
        batches = [(f"goldens-acgt/{run}", acgt)]
        if run in ("score", "cigar"):
            batches.insert(0, (f"goldens/{run}", range(len(cases))))
        if run not in gold["runs"]:
            batches = [(f"goldens/{run}", range(len(cases)))]
        for label, sel in batches:
            sub_t, sub_q = [ts[i] for i in sel], [qs[i] for i in sel]
            spec, lanes, got, tw, qw = smoke.k1_pair(
                label, opt, mode, 8192, 4096, sub_t, sub_q)
            o = got[0].cpu().numpy()
            if run not in gold["runs"]:
                smoke.check(int(o[:, wk.O_DONE].sum()) == len(sel),
                            f"K1 {label}: every lane done")
                smoke.w1_pair(label, opt, spec, lanes, got, tw, qw)
                del got
                continue
            exp = [gold["runs"][run][i] for i in sel]
            smoke.check(all(int(o[j, wk.O_S]) == e["s"]
                            for j, e in enumerate(exp)),
                        f"K1 {label}: scores equal goldens.json")
            if mode == wk.MODE_TB:
                from miniwfa_tpu_torch import cigar as C
                cigs = smoke.w1_pair(label, opt, spec, lanes, got, tw, qw)
                smoke.check(all(C.to_string(c) == e["cigar"]
                                for c, e in zip(cigs, exp)),
                            f"W1 {label}: CIGARs equal goldens.json")
            del got
    with open(os.path.join(ROOT, "tests", "data", "bench_goldens.json")) as f:
        bgold = json.load(f)["8000"]
    pairs = make_pairs(8000, 64)[:8]
    bt = [t.encode() for t, _ in pairs]
    bq = [q.encode() for _, q in pairs]
    for mode in (wk.MODE_SCORE, wk.MODE_TB):
        opt = Options(cigar=mode == wk.MODE_TB)
        spec, lanes, got, tw, qw = smoke.k1_pair(
            "bench8k", opt, mode, 4096, 2048, bt, bq)
        o = got[0].cpu().numpy()
        smoke.check([int(v) for v in o[:, wk.O_S]]
                    == [g["s"] for g in bgold[:8]],
                    "K1 bench8k: scores equal bench_goldens.json")
        if mode == wk.MODE_TB:
            smoke.w1_pair("bench8k", opt, spec, lanes, got, tw, qw)
        del got

    print("phase 2+3, low-mem: K1 PASS1, the checkpoint chain and K1 TB "
          "with checkpoints against their plain versions", flush=True)
    from miniwfa_tpu_torch import cigar as C
    runs = [(f"goldens/p{step}", step, 8192, ts, qs,
             [r["s"] for r in gold["runs"][f"lowmem_p{step}"]],
             [r["cigar"] for r in gold["runs"][f"lowmem_p{step}"]])
            for step in (16, 100)]
    # the 8 kb pairs score 774-960, so step 200 gives each 3-4 snapshots
    # (at step 1000 pass 1 would take none)
    runs.append(("bench8k/p200", 200, 4096, bt, bq,
                 [g["s"] for g in bgold[:8]], None))
    for label, step, W, sub_t, sub_q, want_s, want_cig in runs:
        opt = Options(**gold["penalties"], cigar=True, step=step)
        spec, lanes, got, _, _, want = smoke.k1_pair(
            label, opt, wk.MODE_PASS1, W, 2048, sub_t, sub_q,
            keep_plain=True)
        segs = smoke.checkpoints(label, spec, lanes, got, want)
        del got, want
        spec, lanes, got, tw, qw = smoke.k1_pair(
            label, opt, wk.MODE_TB, W, 2048, sub_t, sub_q, segs=segs)
        smoke.check([int(v) for v in got[0][:, wk.O_S]] == want_s,
                    f"K1 {label} pass 2: scores equal the goldens")
        cigs = smoke.w1_pair(label, opt, spec, lanes, got, tw, qw)
        if want_cig is not None:
            smoke.check([C.to_string(c) for c in cigs] == want_cig,
                        f"W1 {label}: CIGARs equal goldens.json")
        del got

    print("phase 2+3, gaps: K3 and W1 on its traceback against their plain "
          "versions", flush=True)
    from miniwfa_tpu_torch.ops import pack
    sets = (("goldens", chain_gaps(ts, qs, base)),
            ("random", random_gaps(7, 64) + GAP_EDGE))
    for label, pairs in sets:
        for cpw in (16, 4):
            sel = pairs if cpw == 4 else [
                p for p in pairs if pack.can_pack2(p)]
            for opt in (base, base.replace(cigar=True)):
                smoke.k3_pair(label, opt, cpw, sel)
    for o2 in PENALTY_O2:
        smoke.k3_pair(f"goldens o2={o2}", base.replace(cigar=True, o2=o2,
                                                       e2=1), 4, sets[0][1])
    stop = sets[0][1] + sets[1][1]
    smoke.k3_pair("max_s=12", base.replace(cigar=True, max_s=12), 4, stop)


def chain_gaps(ts, qs, opt):
    """Every gap fill of at most 127 bp in total in the chain plans of
    the given pairs."""
    from miniwfa_tpu_torch.models import chain
    from miniwfa_tpu_torch.ops import wavefront_gaps as wg
    out = []
    for t, q in zip(ts, qs):
        kinds, x0, x1, y0, y1 = chain._plan_segments(t, q, opt)
        for i in (kinds == chain.K_ALIGN).nonzero()[0]:
            if x1[i] - x0[i] + y1[i] - y0[i] <= wg.MAX_TOT:
                out.append((t[x0[i]:x1[i]], q[y0[i]:y1[i]]))
    return out


def random_gaps(seed, n, maxn=60):
    """Seeded gap pairs of at most 127 bp (tests/test_gaps_interpret.py::
    _pairs, restated): 10% substitutions, 5% insertions."""
    import random
    from miniwfa_tpu_torch.tools.pairs import rand_seq
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        t = rand_seq(rng, rng.randint(1, maxn))
        q = []
        for c in t:
            r = rng.random()
            if r < 0.1:
                q.append(rng.choice("ACGT"))
            elif r < 0.15:
                if rng.random() < .5:
                    q.append(c + rng.choice("ACGT"))
            else:
                q.append(c)
        q = "".join(q)
        if len(t) + len(q) > 127:
            q = q[:127 - len(t)]
        out.append((t.encode(), q.encode()))
    return out


# the edge pairs of tests/test_gaps_interpret.py, and a 127 bp gap
GAP_EDGE = [(b"ACGT", b"ACGT"), (b"A", b"G"), (b"AAAA", b"AAAAAAAA"),
            (b"AAAA", b"GGGGACGT"), (b"AAAA", b""), (b"", b"ACG"),
            (b"", b""), (b"ACGTNNNA", b"ACGTANNA"), (b"A" * 63, b"C" * 64)]


# a forced small tile of the wide kernel's tiled variant: 32 output slots,
# batches of 7 cycles (tests/test_torch_cuda.py sweeps more)
SMALL_TILE = dict(tile=32, batch=7)


def wide_phases(smoke: Smoke, card: str) -> dict:
    """Phase 2+3, wide: the wide kernel against wide_plain on the goldens
    (at the chooser's tile, at SMALL_TILE and in the "cycle" variant) and
    on 8 of the 8 kb benchmark pairs, SCORE and PASS1, at W=16384 (the JAX
    wide kernel's smallest window; the kernel takes any window, and on the
    main path only bands past K1's reach it).  Returns the one-call times
    at the 8 kb shape, by mode, and under "checks" the launches these
    comparisons made, by variant."""
    import torch
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.models import exact
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    from miniwfa_tpu_torch.ops import wavefront_wide as ww

    print("phase 2+3, wide: the wide kernel against wide_plain", flush=True)
    with open(os.path.join(ROOT, "tests", "data", "goldens.json")) as f:
        gold = json.load(f)
    with open(os.path.join(ROOT, "tests", "data", "bench_goldens.json")) as f:
        bgold = json.load(f)["8000"]
    pairs = make_pairs(8000, 64)[:8]
    # the goldens score at most 1001, the 8 kb pairs at most 960
    runs = (("goldens", [c["t"].encode("latin1") for c in gold["cases"]],
             [c["q"].encode("latin1") for c in gold["cases"]], 1100, 16,
             [r["s"] for r in gold["runs"]["score"]]),
            ("bench8k", [t.encode() for t, _ in pairs],
             [q.encode() for _, q in pairs], 2048, 200,
             [g["s"] for g in bgold[:8]]))
    times = {}
    before = ww.wide.launches_by_variant.copy()
    for label, ts, qs, s_cap, step, want_s in runs:
        for mode in (wk.MODE_SCORE, wk.MODE_PASS1):
            p1 = mode == wk.MODE_PASS1
            opt = Options(**gold["penalties"], cigar=p1,
                          step=step if p1 else 0)
            spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, 16384, s_cap,
                                                      ts, qs)
            args = [torch.from_numpy(a).to(smoke.dev)
                    for a in (lanes, tw, qw)]
            want, t = smoke.wide_pair(label, spec, args)
            smoke.check([int(v) for v in want[:, wk.O_S]] == want_s,
                        f"wide {label} mode={wk.launch_mode(spec, None)}: "
                        f"scores equal the goldens")
            if label == "goldens":
                # many tile boundaries and band edges a batch
                smoke.wide_pair(label, spec, args, plain=t["plain"],
                                **SMALL_TILE)
                # the per-cycle body, which the chooser keeps for penalty
                # sets whose smallest tile does not fit
                smoke.wide_pair(label, spec, args, plain=t["plain"],
                                variant="cycle")
            del t["plain"]
            if label == "bench8k":
                name = wk.launch_mode(spec, None)
                times[name] = t
                print(f"  wavefront_wide[{name}] bench8k B={len(ts)} "
                      f"W={spec.W} {t['variant']} n={t['n']} k={t['k']}: "
                      f"kernel_ms={t['ms']:.3f} "
                      f"plain_ms={t['plain_ms']:.3f} card={card}",
                      flush=True)
            del want, args
    # large gap-open costs on the goldens of at most 256 bp (their scores
    # stay below 300), SCORE
    small = [c for c in gold["cases"] if max(len(c["t"]), len(c["q"])) <= 256]
    for o2 in PENALTY_O2:
        opt = Options(**gold["penalties"]).replace(o2=o2, e2=1)
        spec, lanes, tw, qw = exact.kernel_inputs(
            opt, wk.MODE_SCORE, 16384, 1100,
            [c["t"].encode("latin1") for c in small],
            [c["q"].encode("latin1") for c in small])
        args = [torch.from_numpy(a).to(smoke.dev) for a in (lanes, tw, qw)]
        want, _ = smoke.wide_pair(f"goldens-small o2={o2}", spec, args)
        smoke.check(int(want[:, wk.O_DONE].sum()) == len(small),
                    f"wide goldens-small o2={o2}: every lane done")
        del want, args
    times["checks"] = {v: ww.wide.launches_by_variant[v] - before[v]
                       for v in ww.VARIANTS}
    smoke.check(times["checks"]["cycle"] > 0, f"wide: the cycle variant "
                f"held against wide_plain ({times['checks']})")
    print(f"  wide kernel grid (blocks of 512 threads, by device, variant, "
          f"mode, penalties, n, k): {ww.wide.blocks}", flush=True)
    return times


class WideTimer:
    """While active, a pair of CUDA events around every call of the wide
    kernel, kept with the call's spec, inputs and outputs and read after
    the run: kernel time, cells and bound of whole wide runs, summed over
    their calls, and the first call's inputs (the shape the path ran).  An
    event pair also spans the host's enqueue gap before its launch:
    microseconds against calls of tens of milliseconds and more."""

    def __enter__(self):
        import torch
        from miniwfa_tpu_torch.ops import wavefront_wide as ww
        self.ww, self.real = ww, ww.wide
        self.calls, self.first = [], None

        def timed(spec, lanes, tw, qw, state, t_lim):
            t_before = state.row[:, ww.ST_T].clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.real(spec, lanes, tw, qw, state, t_lim)
            end.record()
            self.first = self.first or (spec, lanes, tw, qw)
            self.calls.append((spec, start, end, out, _nbytes(lanes, tw, qw),
                               state.row[:, ww.ST_T] - t_before,
                               self.real.last_stats[lanes.device.index].clone()))
            return out

        # the stand-in shares the real function's launch counters and grid
        # sizes, which the real body updates through the module's name
        timed.__dict__ = self.real.__dict__
        ww.wide = timed
        return self

    def __exit__(self, *exc):
        self.ww.wide = self.real

    def totals(self) -> dict:
        """Per mode: calls, kernel ms, cycles and µs a cycle (summed over
        the lanes), batches and reruns of the tiled variant with block 0's
        tiles and clock64 cycles by phase (``ww.STATS``), cells, and the
        bound of the whole runs (their cells' operations; their inputs,
        outputs and snapshot rows taken).  A run's last call is the one
        that leaves no lane paused, and its outputs hold the run's
        totals."""
        import torch
        from miniwfa_tpu_torch.ops import wavefront_kernel as wk
        ww = self.ww
        torch.cuda.synchronize()
        res = {}
        for spec, start, end, out, in_bytes, cyc, stats in self.calls:
            r = res.setdefault(wk.launch_mode(spec, None),
                               {"calls": 0, "ms": 0.0, "cells": 0, "bytes": 0,
                                "cycles": 0, "batches": 0, "reruns": 0,
                                "block0": dict.fromkeys(ww.STATS[2:], 0)})
            r["calls"] += 1
            r["ms"] += start.elapsed_time(end)
            r["cycles"] += int(cyc.sum())
            r["batches"] += int(stats[0])
            r["reruns"] += int(stats[1])
            for k, v in zip(ww.STATS[2:], stats[2:].tolist()):
                r["block0"][k] += v
            if not bool(out[:, ww.OW_PAUSE].any()):
                r["cells"] += int(out[:, wk.O_NITER].sum())
                row_b = wk.snapshot_layout(spec)[5] * spec.W * 4
                r["bytes"] += (in_bytes + _nbytes(out)
                               + int(out[:, wk.O_SNC].sum()) * row_b)
        for name, r in res.items():
            ops = r["cells"] * (OPS_SCORE
                                + (OPS_PASS1 if name == "PASS1" else 0))
            r["bound_ms"], r["bound_by"] = _bound(r.pop("bytes"), ops)
            r["us_per_cycle"] = 1e3 * r["ms"] / max(r["cycles"], 1)
            r.update(ww.wide.tiles.get(0, {}).get(name, {}))
        return res


class WalkTimer:
    """While active, a pair of CUDA events around every call of the
    walker W1 (``traceback_device.walk``), read after the run: its kernel
    ms and calls, summed over the run."""

    def __enter__(self):
        import torch
        from miniwfa_tpu_torch.ops import traceback_device as tbd
        self.tbd, self.real = tbd, tbd.walk
        self.events = []

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.real(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out

        # the stand-in shares the real function's launch counters
        timed.__dict__ = self.real.__dict__
        tbd.walk = timed
        return self

    def __exit__(self, *exc):
        self.tbd.walk = self.real

    def totals(self) -> dict:
        import torch
        torch.cuda.synchronize()
        return {"w1_calls": len(self.events),
                "w1_kernel_ms": sum(a.elapsed_time(b) for a, b in self.events)}


# score and low-mem runs of the scale fixtures whose bands pass K1's
# windows, so they run in the wide kernel
WIDE_RUNS = (("score", ("dissim150k", "nbear1m", "sv300k")),
             ("lowmem_p5000", ("dissim150k", "nbear1m", "sv300k", "div5m")))


def wide_path(smoke: Smoke, card: str, fixture, sgold) -> dict:
    """Phase 4d: the wide path through align_batch on the scale fixtures
    (score: the K1 dispatch at W=65536 overflows, the wide jump follows;
    low-mem: pass 1 in the wide kernel, pass 2 in K1 TB+seg), against
    scale_goldens.json, with each run's wall, peak memory, wide calls and
    kernel time, and pass 1's wall apart from pass 2's.  Returns the wide
    kernel's launches by mode, div5m pass 1's totals, and the first wide
    call's spec and inputs of nbear1m score and div5m pass 1."""
    import torch
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.models import exact

    print("phase 4d: the wide path, score and low-mem (step 5000) on the "
          "scale fixtures", flush=True)
    launches = {"wavefront_wide": 0, "modes": {}, "variants": {},
                "chain_ptrs": 0}
    pass2 = {}
    div5m = None
    first = {}
    real_p1 = exact._run_pass1
    for run, names in WIDE_RUNS:
        lowmem = run != "score"
        opt = Options(cigar=True, step=STEP_MAIN) if lowmem else Options()
        for name in names:
            t, q = fixture(name)
            g = sgold[name][run]
            p1 = []

            def timed_pass1(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = real_p1(*a, **kw)
                torch.cuda.synchronize()
                p1.append(time.perf_counter() - t0)
                return r

            exact._run_pass1 = timed_pass1
            try:
                with WideTimer() as wt, WalkTimer() as w1:
                    res, counts, wall, peak = _drive(smoke, f"{name} {run}",
                                                     [(t, q)], opt, card)
            finally:
                exact._run_pass1 = real_p1
            tot = wt.totals()
            smoke.check(res[0].s == g["s"], f"{name} {run}: s={res[0].s} "
                        f"equals scale_goldens.json ({g['s']})")
            if lowmem:
                _check_cigars(smoke, f"{name} {run}", [t], [q], res,
                              [g["cigar_md5"]])
            wmode = "PASS1" if lowmem else "SCORE"
            n = counts["wide_modes"].get(wmode, 0)
            smoke.check(n > 0, f"{name} {run} launched "
                        f"wavefront_wide[{wmode}] {n} times")
            if lowmem:
                n = counts["modes"].get("TB+seg", 0)
                smoke.check(n > 0, f"{name} {run} pass 2 launched "
                            f"wavefront[TB+seg] {n} times")
            w = tot.get(wmode, {"calls": 0, "ms": 0.0, "cells": 0,
                                "bound_ms": 0.0, "bound_by": "-",
                                "cycles": 0, "batches": 0, "reruns": 0,
                                "us_per_cycle": 0.0})
            split = ""
            if lowmem:
                walk = w1.totals()
                pass2[name] = dict(pass2_s=wall - sum(p1), **walk,
                                   chain_ptrs=counts["chain_ptrs"])
                split = (f"pass1_s={sum(p1):.6f} pass2_s={wall - sum(p1):.6f}"
                         f" pass2 w1_calls={walk['w1_calls']} "
                         f"w1_kernel_ms={walk['w1_kernel_ms']:.3f} "
                         f"{counts['walk_variants']} "
                         f"chain_ptrs={counts['chain_ptrs']} ")
                launches["chain_ptrs"] += counts["chain_ptrs"]
            print(f"  {name} {run}: {split}wide_calls={w['calls']} "
                  f"wide_kernel_ms={w['ms']:.3f} wide_cells={w['cells']} "
                  f"wide_cycles={w['cycles']} "
                  f"us_per_cycle={w['us_per_cycle']:.3f} "
                  f"variants={counts['wide_variants']} n={w.get('n')} "
                  f"k={w.get('k')} batches={w['batches']} "
                  f"reruns={w['reruns']} "
                  f"bound_ms={w['bound_ms']:.6f} ({w['bound_by']}) "
                  f"peak_bytes={peak} wall_s={wall:.6f} card={card}",
                  flush=True)
            smoke.check(counts["wide_variants"].get("tile", 0)
                        == counts["wide"],
                        f"{name} {run}: the wide kernel ran the tiled "
                        f"variant ({counts['wide_variants']})")
            launches["wavefront_wide"] += counts["wide"]
            for k, v in counts["wide_modes"].items():
                launches["modes"][k] = launches["modes"].get(k, 0) + v
            for k, v in counts["wide_variants"].items():
                launches["variants"][k] = launches["variants"].get(k, 0) + v
            if name == "div5m":
                div5m = w
            if (name, run) in (("nbear1m", "score"),
                               ("div5m", "lowmem_p5000")):
                first[name] = wt.first
    return {"launches": launches, "div5m_pass1": div5m, "first": first,
            "pass2": pass2}


# the multi-lane route of phase 4 (K4 at G=4 for every K1 SCORE and TB
# dispatch of more than one lane)
MULTI_ENV = {"MWF_ENGINE": "multi", "MWF_KERNEL_G": "4"}


def _drive(smoke, label, pairs, opt, card, fn=None, **kw):
    """One run of ``fn`` (default ``align_batch``) on the card with the
    launch counts and the peak-memory meter set to 0 just before it and
    read just after; the meter's peak dispatch must be above 0 and at most
    the allocator's peak of the run (each buffer it counts exists during
    its launch).  Returns (results, counts, wall seconds, peak bytes)."""
    import torch
    from miniwfa_tpu_torch.models import exact
    from miniwfa_tpu_torch.utils import hbm
    hbm.reset()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = (fn or exact.align_batch)(pairs, opt, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    meter, tag = hbm.peak()
    cells = sum(r.n_iter for r in res)
    print(f"  {label}: wall_s={wall:.6f} cells={cells} "
          f"cells_per_s={cells / wall:.6e} peak_bytes={peak} "
          f"meter_bytes={meter} meter_tag='{tag}' "
          f"launches wavefront={counts['wavefront']} {counts['modes']} "
          f"wavefront_multi={counts['multi']} {counts['multi_modes']} "
          f"{counts['multi_variants']} "
          f"wavefront_wide={counts['wide']} {counts['wide_modes']} "
          f"walk={counts['walk']} {counts['walk_variants']} "
          f"chain_ptrs={counts['chain_ptrs']} gaps={counts['gaps']} "
          f"card={card}",
          flush=True)
    smoke.check(0 < meter <= peak, f"{label}: the meter's peak dispatch "
                f"{meter} bytes is above 0 and at most peak_bytes {peak}")
    return res, counts, wall, peak


def _check_cigars(smoke, label, ts, qs, res, md5s, chained=False) -> None:
    """CIGAR md5s against the goldens, and each CIGAR's consistency:
    it consumes both sequences, re-scores to s, and its '='/'X' runs
    match the bases.  The reference anchors the chain case-insensitively
    and emits '=' over an anchored segment, so a chained CIGAR of a pair
    with soft-masked (lowercase) bases may hold '=' over 'a'/'A': for
    such a pair only lengths and score are checked (nbear1m, ROADMAP.md
    section 3)."""
    from miniwfa_tpu_torch import Options, cigar as C
    ok_md5 = ok_cig = True
    folded = False
    for t, q, r, m in zip(ts, qs, res, md5s):
        ok_md5 &= hashlib.md5(r.cigar_str.encode()).hexdigest() == m
        seqs = (t, q)
        if chained and (t != t.upper() or q != q.upper()):
            seqs, folded = (), True
        try:
            C.assert_cigar(Options(), r.cigar, len(t), len(q), r.s, *seqs)
        except AssertionError:
            ok_cig = False
    smoke.check(ok_md5, f"{label}: {len(res)} CIGAR md5s equal the goldens")
    smoke.check(ok_cig, f"{label}: every CIGAR passes assert_cigar"
                + (" (lengths and score: soft-masked bases)" if folded
                   else ""))


def main_path(smoke: Smoke, card: str) -> dict:
    """Phase 4: the main path at full width in each mode, and the
    dissim150k scale fixture.  Returns per-kernel launches (summed over
    the main path's modes) and the main path's pairs."""
    from miniwfa_tpu_torch import Options

    with open(os.path.join(ROOT, "tests", "data", "bench_goldens.json")) as f:
        gold = json.load(f)[str(N_MAIN)]
    pairs = make_pairs(N_MAIN, B_MAIN)
    ts = [t.encode() for t, _ in pairs]
    qs = [q.encode() for _, q in pairs]
    modes = (("score", Options(), ("SCORE",)),
             ("cigar", Options(cigar=True), ("TB",)),
             ("lowmem", Options(cigar=True, step=STEP_MAIN),
              ("PASS1", "TB+seg")))

    print(f"phase 4: main path, {B_MAIN} pairs x {N_MAIN} bp, 2% divergence",
          flush=True)
    launches = {"wavefront": 0, "walk": 0, "modes": {}, "wavefront_multi": 0,
                "multi_modes": {}, "multi_variants": {}, "clusters": {},
                "chain_ptrs": 0, "walk_variants": {}, "ksim": 0}
    # the sizing's k-mer counts (the ksim kernel) against its plain version
    from miniwfa_tpu_torch.ops import kmer
    got = kmer.ksim_counts(list(zip(ts, qs)), 13, "cuda")
    want = kmer.ksim_counts(list(zip(ts, qs)), 13, "cpu")
    err = int(abs(got - want).max())
    smoke.err["ksim"] = max(smoke.err["ksim"], err)
    smoke.check(err == 0, f"ksim_counts on the card against "
                f"ksim_counts_plain, {B_MAIN} pairs: max_abs_err={err}")
    walls, results = {}, {}
    for mode, opt, kmodes in modes:
        res, counts, walls[mode], _ = _drive(smoke, mode, list(zip(ts, qs)),
                                             opt, card)
        results[mode] = [(r.s, r.n_iter, r.cigar_str) for r in res]
        smoke.check([r.s for r in res] == [g["s"] for g in gold],
                    f"main {mode}: {B_MAIN} scores equal bench_goldens.json")
        if opt.cigar:
            _check_cigars(smoke, f"main {mode}", ts, qs, res,
                          [g["cigar_md5"] for g in gold])
        for k in kmodes:
            n = counts["modes"].get(k, 0)
            smoke.check(n > 0, f"main {mode} launched wavefront[{k}] {n} "
                        f"times")
            # K1's cluster: CTAs per lane and co-resident clusters there
            cl = counts["clusters"].get(k, {"C": 0, "clusters": 0})
            launches["clusters"][k] = cl
            smoke.check(cl["C"] > 1, f"main {mode} wavefront[{k}]: "
                        f"C={cl['C']} CTAs per lane, {cl['clusters']} "
                        f"co-resident clusters of C on the card, for "
                        f"{B_MAIN} lanes")
        if opt.cigar:
            smoke.check(counts["walk"] > 0, f"main {mode} launched walk "
                        f"{counts['walk']} times {counts['walk_variants']}")
        if opt.step:
            smoke.check(counts["chain_ptrs"] > 0, f"main {mode} launched "
                        f"chain_ptrs {counts['chain_ptrs']} times")
        smoke.check(counts["wide"] == 0, f"main {mode} launched "
                    f"wavefront_wide {counts['wide']} times (K1's windows "
                    f"serve it)")
        smoke.check(counts["multi"] == 0, f"main {mode} launched "
                    f"wavefront_multi {counts['multi']} times (the default "
                    f"route is K1)")
        # the k-mer estimate sizes CIGAR and low-mem batches, not score's
        smoke.check(counts["ksim"] == int(opt.cigar), f"main {mode} "
                    f"launched ksim {counts['ksim']} times")
        for k in ("wavefront", "walk", "chain_ptrs", "ksim"):
            launches[k] += counts[k]
        for key, into in (("modes", "modes"),
                          ("walk_variants", "walk_variants")):
            for k, n in counts[key].items():
                launches[into][k] = launches[into].get(k, 0) + n

    launches["walk_main"] = launches["walk"]
    # the multi-lane route: the same runs with K4 at G=4
    for mode, opt, kmodes in modes[:2]:
        with mock.patch.dict(os.environ, MULTI_ENV):
            res, counts, wall, _ = _drive(smoke,
                                          f"{mode} MWF_ENGINE=multi G=4",
                                          list(zip(ts, qs)), opt, card)
        smoke.check([r.s for r in res] == [g["s"] for g in gold],
                    f"main {mode} multi: {B_MAIN} scores equal "
                    f"bench_goldens.json")
        if opt.cigar:
            _check_cigars(smoke, f"main {mode} multi", ts, qs, res,
                          [g["cigar_md5"] for g in gold])
        n = sum(counts["multi_modes"].get(k, 0) for k in kmodes)
        smoke.check(n > 0 and counts["wavefront"] == 0,
                    f"main {mode} multi launched wavefront_multi{kmodes} {n} "
                    f"times and wavefront {counts['wavefront']}")
        print(f"  main {mode}: wall_s K1={walls[mode]:.6f} "
              f"K4(G=4)={wall:.6f} card={card}", flush=True)
        _add_multi(launches, counts)

    with open(os.path.join(ROOT, "tests", "data", "scale_goldens.json")) as f:
        sgold = json.load(f)
    fixtures = {}

    def fixture(name):
        if name not in fixtures:
            t0 = time.perf_counter()
            fixtures[name] = tuple(x.encode() for x in gen_case(name))
            print(f"  generated {name} in {time.perf_counter() - t0:.1f} s",
                  flush=True)
        return fixtures[name]

    print("phase 4c: chain (-u -c) and auto (-t -c) on the scale fixtures",
          flush=True)
    from miniwfa_tpu_torch.models.auto import align_auto_batch
    from miniwfa_tpu_torch.models.chain import align_chain_batch
    from miniwfa_tpu_torch.utils.spans import Spans
    launches["gaps"] = 0
    launches["gaps_classes"] = {}
    launches["walk_on_gaps"] = 0
    fns = {"chain": align_chain_batch, "auto": align_auto_batch}
    for mode, names in SCALE_RUNS:
        for name in names:
            t, q = fixture(name)
            g = sgold[name][mode]
            spans = Spans()
            with WalkTimer() as w1:
                res, counts, wall, _ = _drive(smoke, f"{name} {mode}",
                                              [(t, q)], Options(cigar=True),
                                              card,
                                              fns[mode], spans=spans)
            smoke.check(res[0].s == g["s"], f"{name} {mode}: s={res[0].s} "
                        f"equals scale_goldens.json ({g['s']})")
            _check_cigars(smoke, f"{name} {mode}", [t], [q], res,
                          [g["cigar_md5"]], chained=True)
            if mode == "auto":
                n = counts["modes"].get("SCORE", 0)
                smoke.check(n > 0, f"{name} auto probe launched "
                            f"wavefront[SCORE] {n} times")
            if "plan" in spans.totals:     # the chain path ran
                smoke.check(counts["gaps"] > 0 and counts["walk"] > 0,
                            f"{name} {mode} chained: launched gaps "
                            f"{counts['gaps']} and walk {counts['walk']} "
                            f"times")
            else:
                n = counts["modes"].get("TB", 0)
                smoke.check(n > 0 and counts["walk"] > 0,
                            f"{name} auto: probe succeeded, TB re-run "
                            f"launched wavefront[TB] {n} and walk "
                            f"{counts['walk']} times")
            # every K1 TB dispatch and every K3 dispatch is walked once
            k1_tb = sum(n for k, n in counts["modes"].items()
                        if k.startswith("TB"))
            on_gaps = counts["walk"] - k1_tb
            smoke.check(on_gaps == counts["gaps_dispatches"],
                        f"{name} {mode}: walk launched {on_gaps} times on "
                        f"K3's {counts['gaps_dispatches']} tracebacks "
                        f"({counts['gaps']} kernel launches)")
            for k in ("wavefront", "walk", "gaps"):
                launches[k] += counts[k]
            launches["walk_on_gaps"] += on_gaps
            for k, n in counts["gaps_classes"].items():
                launches["gaps_classes"][k] = \
                    launches["gaps_classes"].get(k, 0) + n
            for k, n in counts["modes"].items():
                launches["modes"][k] = launches["modes"].get(k, 0) + n
            if name == "div5m":
                split = " ".join(f"{k}={v:.6f}" for k, v in
                                 sorted(spans.totals.items()))
                rest = wall - sum(spans.totals.values())
                walk = w1.totals()
                launches["div5m_auto_w1"] = walk
                print(f"  div5m auto wall split (s): {split} "
                      f"rest={rest:.6f} wall={wall:.6f}; W1 kernel "
                      f"{walk['w1_kernel_ms']:.3f} ms in {walk['w1_calls']} "
                      f"calls {counts['walk_variants']} card={card}",
                      flush=True)
                _div5m_multi(smoke, card, t, q, g, spans, launches)
    return {"launches": launches, "ts": ts, "qs": qs, "fixture": fixture,
            "sgold": sgold, "gold": gold, "walls": walls, "results": results,
            "modes": modes}


def _div5m_multi(smoke, card, t, q, g, k1_spans, launches) -> None:
    """div5m auto again on the multi-lane route (K4 at G=4 for its K1
    gap fills of more than one lane): parity with scale_goldens.json, and
    its K1 gap fills span beside the K1 run's."""
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.models.auto import align_auto_batch
    from miniwfa_tpu_torch.utils.spans import Spans
    spans = Spans()
    with mock.patch.dict(os.environ, MULTI_ENV):
        res, counts, wall, _ = _drive(smoke,
                                      "div5m auto MWF_ENGINE=multi G=4",
                                      [(t, q)], Options(cigar=True), card,
                                      align_auto_batch, spans=spans)
    smoke.check(res[0].s == g["s"], f"div5m auto multi: s={res[0].s} "
                f"equals scale_goldens.json ({g['s']})")
    _check_cigars(smoke, "div5m auto multi", [t], [q], res,
                  [g["cigar_md5"]], chained=True)
    span = "K1 gap fills"
    print(f"  div5m auto '{span}' span: K1={k1_spans.totals.get(span, 0):.6f}"
          f" s, K4(G=4)={spans.totals.get(span, 0):.6f} s "
          f"(wavefront_multi {counts['multi']} {counts['multi_modes']}, "
          f"wavefront {counts['wavefront']} {counts['modes']}) "
          f"wall={wall:.6f} card={card}", flush=True)
    _add_multi(launches, counts)


def _add_multi(launches, counts) -> None:
    """Add a run's K4 launches, by mode and by variant, to ``launches``."""
    launches["wavefront_multi"] += counts["multi"]
    for key, into in (("multi_modes", "multi_modes"),
                      ("multi_variants", "multi_variants")):
        for k, n in counts[key].items():
            launches[into][k] = launches[into].get(k, 0) + n


def penalty_runs(smoke: Smoke, card: str) -> None:
    """Phase 4e: t3 at o2=40 and o2=100 (e2=1) in exact, low-mem (-p 16),
    chain (-u) and auto (-t) CIGAR modes on the card, each equal to the
    JAX package's (s, n_iter, CIGAR)."""
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.models.auto import align_auto_batch
    from miniwfa_tpu_torch.models.chain import align_chain_batch

    print("phase 4e: t3 at large gap-open costs", flush=True)
    with open(os.path.join(ROOT, "tests", "data", "goldens.json")) as f:
        c = {c["name"]: c for c in json.load(f)["cases"]}["t3"]
    pair = [(c["t"], c["q"])]
    runs = {"exact": ({}, None), "p16": ({"step": 16}, None),
            "chain": ({}, align_chain_batch), "auto": ({}, align_auto_batch)}
    for o2 in PENALTY_O2:
        for mode, (kw, fn) in runs.items():
            opt = Options(cigar=True, o2=o2, e2=1, **kw)
            res, _, _, _ = _drive(smoke, f"t3 o2={o2} {mode}", pair, opt,
                                  card, fn)
            got = (res[0].s, res[0].n_iter, res[0].cigar_str)
            want = T3_PENALTIES[o2][mode]
            smoke.check(got == want, f"t3 o2={o2} e2=1 {mode}: (s, n_iter, "
                        f"CIGAR) = {got}, the JAX package's {want}")


# phase 4f's mesh sizes (entries of one card) and its gloo job's ranks
SHARD_MAIN, SHARD_WIDE, MP_RANKS = 4, 2, 2
MP_TIMEOUT = 300
# the scale fixtures phase 4f runs together on the wide engine, score mode
SHARD_WIDE_RUNS = ("dissim150k", "sv300k")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_path(smoke: Smoke, card: str, info) -> dict:
    """Phase 4f: the sharded path (miniwfa_tpu_torch/parallel/) on one
    card.  The main path through ``align_batch_sharded`` on a mesh of
    SHARD_MAIN entries of cuda:0 in score, CIGAR and low-mem mode, each
    result (s, n_iter, CIGAR) equal to phase 4's ``align_batch``, the
    scores and CIGAR digests to bench_goldens.json, its wall beside phase
    4's; dissim150k and sv300k in score mode on SHARD_WIDE entries, one
    pair a block, through the wide kernel, against scale_goldens.json; the
    port's ``dryrun_multichip(4)``; and a gloo job of MP_RANKS processes of
    tools/mp_worker.py on cuda:0 (after ``build.build()``), each of which
    must print MP_OK.  Returns the phase's launches by kernel (the
    workers' launches are their own)."""
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.ops import build
    from miniwfa_tpu_torch.parallel.batch import align_batch_sharded
    from miniwfa_tpu_torch.parallel.dryrun import dryrun_multichip
    from miniwfa_tpu_torch.parallel.mesh import make_mesh
    from miniwfa_tpu_torch.tools import microbench as mb

    print(f"phase 4f: the sharded path on one card ({SHARD_MAIN} and "
          f"{SHARD_WIDE} mesh entries of cuda:0, a {MP_RANKS}-rank gloo "
          f"job)", flush=True)
    launches = {"wavefront": 0, "walk": 0, "chain_ptrs": 0, "gaps": 0,
                "multi": 0, "wide": 0, "probes": 0}

    def add(counts):
        for k in launches:
            if k != "probes":
                launches[k] += counts[k]

    def on(mesh):
        return lambda p, o, device: align_batch_sharded(p, o, mesh)

    probes0 = sum(f.launches for f in mb.wrappers())
    gold = info["gold"]
    pairs = list(zip(info["ts"], info["qs"]))
    mesh = make_mesh(["cuda:0"] * SHARD_MAIN)
    for mode, opt, kmodes in info["modes"]:
        res, counts, wall, _ = _drive(smoke, f"sharded {mode}", pairs, opt,
                                      card, on(mesh))
        add(counts)
        smoke.check([(r.s, r.n_iter, r.cigar_str) for r in res]
                    == info["results"][mode], f"sharded {mode}: "
                    f"{B_MAIN} (s, n_iter, CIGAR) equal phase 4's align_batch")
        smoke.check([r.s for r in res] == [g["s"] for g in gold],
                    f"sharded {mode}: {B_MAIN} scores equal "
                    f"bench_goldens.json")
        if opt.cigar:
            _check_cigars(smoke, f"sharded {mode}", info["ts"], info["qs"],
                          res, [g["cigar_md5"] for g in gold])
        n = {k: counts["modes"].get(k, 0) for k in kmodes}
        if opt.cigar:
            n["walk"] = counts["walk"]
        if opt.step:
            n["chain_ptrs"] = counts["chain_ptrs"]
        smoke.check(all(n.values()), f"sharded {mode} launched {n}")
        print(f"  main {mode}: wall_s align_batch={info['walls'][mode]:.6f}"
              f" sharded({SHARD_MAIN} x cuda:0)={wall:.6f} card={card}",
              flush=True)

    names = SHARD_WIDE_RUNS
    ts, qs = zip(*(info["fixture"](name) for name in names))
    res, counts, wall, _ = _drive(smoke, f"sharded score {'+'.join(names)}",
                                  list(zip(ts, qs)), Options(), card,
                                  on(make_mesh(["cuda:0"] * SHARD_WIDE)))
    add(counts)
    for name, r in zip(names, res):
        want = info["sgold"][name]["score"]["s"]
        smoke.check(r.s == want, f"sharded {name} score: s={r.s} equals "
                    f"scale_goldens.json ({want})")
    n = counts["wide_modes"].get("SCORE", 0)
    smoke.check(n > 0, f"sharded {'+'.join(names)} score launched "
                f"wavefront_wide[SCORE] {n} times")

    _reset_counts()
    t0 = time.perf_counter()
    try:
        dryrun_multichip(4, device="cuda")
        ok = ""
    except AssertionError as e:
        ok = f": {e!r}"
    add(_read_counts())
    smoke.check(not ok, f"dryrun_multichip(4, device='cuda') in "
                f"{time.perf_counter() - t0:.1f} s{ok}")
    launches["probes"] = sum(f.launches for f in mb.wrappers()) - probes0

    build.build()
    addr = f"127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "miniwfa_tpu_torch.tools.mp_worker", addr,
         str(MP_RANKS), str(rank), "--device", "cuda:0"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(MP_RANKS)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=MP_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                outs.append(f"no end within {MP_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        ok = p.returncode == 0 and f"MP_OK pid={rank}" in out
        smoke.check(ok, f"gloo rank {rank} of {MP_RANKS} on cuda:0: exit "
                    f"{p.returncode}, MP_OK pid={rank} printed"
                    + ("" if ok else f"; its output ends:\n{out[-2000:]}"))
    print(f"  gloo job: {MP_RANKS} ranks in {time.perf_counter() - t0:.1f} s"
          f" card={card}", flush=True)
    return launches


def _time_pair(smoke, label, spec, args, segs, card, plain):
    """K1 once at one dispatch shape (CUDA events) and, with ``plain``,
    its plain version too, which must agree; returns (kernel outputs,
    timing dict)."""
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    got, ms = _ms(lambda: wk.wavefront(spec, *args, segs))
    mode = wk.launch_mode(spec, segs)
    bound_ms, bound_by = _k1_bound(spec, args, segs, got)
    cl = wk.wavefront.clusters[args[0].device.index][mode]
    res = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by, **cl)
    line = (f"  wavefront[{mode}] {label} B={len(args[0])} W={spec.W} "
            f"S_CAP={spec.S_CAP} C={cl['C']} "
            f"(co-resident clusters {cl['clusters']}): kernel_ms={ms:.3f}")
    if plain:
        want, res["plain_ms"] = _ms(
            lambda: wk.wavefront_plain(spec, *args, segs))
        err = max(_max_err(g, w) for g, w in zip(got, want))
        smoke.err["wavefront"] = max(smoke.err["wavefront"], err)
        del want
        line += f" plain_ms={res['plain_ms']:.3f}"
        smoke.check(err == 0, f"K1 {label} {mode}: max_abs_err={err}")
    print(f"{line} bound_ms={bound_ms:.6f} ({bound_by}) card={card}",
          flush=True)
    return got, res


def _hold_cut(smoke, label, spec, args, segs, card) -> dict:
    """K1 and its plain version at one dispatch shape, every lane stopped
    past score MAIN_CUT (max_s): every output, traceback byte and snapshot
    row must agree.  Returns both times (CUDA events)."""
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    lanes = args[0].clone()
    lanes[:, wk.L_MS] = MAIN_CUT
    cargs = (lanes, *args[1:])
    got, ms = _ms(lambda: wk.wavefront(spec, *cargs, segs))
    want, plain_ms = _ms(lambda: wk.wavefront_plain(spec, *cargs, segs))
    err = max(_max_err(g, w) for g, w in zip(got, want))
    smoke.err["wavefront"] = max(smoke.err["wavefront"], err)
    stopped = int(got[0][:, wk.O_STOP].sum())
    snaps = int(got[0][:, wk.O_SNC].sum())
    smoke.check(err == 0 and stopped == len(lanes),
                f"K1 {label} {wk.launch_mode(spec, segs)} step={spec.step} "
                f"max_s={MAIN_CUT}: {stopped} stopped, {snaps} snapshot "
                f"rows, every output, traceback byte and snapshot row "
                f"equal, max_abs_err={err} (kernel_ms={ms:.3f} "
                f"plain_ms={plain_ms:.3f} card={card})")
    return dict(max_s=MAIN_CUT, ms=ms, plain_ms=plain_ms)


def _multi_main(smoke, label, spec, args, k1, card, G=4) -> dict:
    """K4 at G lanes per block on a K1 dispatch's inputs (CUDA events),
    every output held against K1's (``k1``), then again with every lane
    stopped past score MAIN_CUT, against K1 there."""
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    from miniwfa_tpu_torch.ops import wavefront_multi as wm
    got, ms = _ms(lambda: wm.wavefront_multi(spec, G, *args))
    bound_ms, bound_by = _k1_bound(spec, args, None, got)
    err = max(_max_err(a, b) for a, b in zip(got, k1))
    del got
    lanes = args[0].clone()
    lanes[:, wk.L_MS] = MAIN_CUT
    cut = max(_max_err(a, b) for a, b in zip(
        wm.wavefront_multi(spec, G, lanes, *args[1:]),
        wk.wavefront(spec, lanes, *args[1:])))
    smoke.err["wavefront_multi"] = max(smoke.err["wavefront_multi"], err,
                                       cut)
    mode = wk.launch_mode(spec, None)
    v = wm.wavefront_multi.variants[args[0].device.index][mode]
    smoke.check(err == 0 and cut == 0 and v["variant"] == "global",
                f"K4 {label} {mode} G={G} {v['variant']} variant: every "
                f"output equal K1's, whole and with lanes stopped past "
                f"max_s={MAIN_CUT}, max_abs_err={max(err, cut)}")
    print(f"  wavefront_multi[{mode}] {label} G={G} B={len(args[0])} "
          f"W={spec.W} S_CAP={spec.S_CAP} variant={v['variant']}: "
          f"kernel_ms={ms:.3f} bound_ms={bound_ms:.6f} ({bound_by}) "
          f"card={card}", flush=True)
    return dict(G=G, variant=v["variant"], ms=ms, bound_ms=bound_ms,
                bound_by=bound_by)


# the chain's K1 gap fills: dispatches of up to 2048 lanes (models/chain.py
# CHUNK), here 1 kb pairs
FILL_N, FILL_B = 1000, 2048


def gap_fill_times(smoke: Smoke, card: str) -> dict:
    """Phase 5, K4: FILL_B pairs of FILL_N bp (make_pairs) in SCORE and TB
    modes at G = 1 (K1, whose chooser runs so many lanes at C = 1) and 2,
    4, 8 lanes per block (K4 at the chooser's variant: smem, at 4 lanes a
    block), CUDA events, each with its bound, µs a cycle (over the lanes'
    largest score) and every output held against the plain version's;
    then the smem variant at 1 lane a block, held equal."""
    import torch
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.models import exact
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    from miniwfa_tpu_torch.ops import wavefront_multi as wm

    pairs = make_pairs(FILL_N, FILL_B)
    ts = [t.encode() for t, _ in pairs]
    qs = [q.encode() for _, q in pairs]
    res = {}
    for name, opt, mode in (("SCORE", Options(), wk.MODE_SCORE),
                            ("TB", Options(cigar=True), wk.MODE_TB)):
        bk, _ = exact.first_bucket(opt, mode, ts, qs, 512, 512, smoke.dev)
        spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, bk.W, bk.S_CAP,
                                                  ts, qs)
        args = [torch.from_numpy(a).to(smoke.dev) for a in (lanes, tw, qw)]
        print(f"phase 5, K4: {FILL_B} pairs of {FILL_N} bp, {name}, "
              f"W={spec.W} S_CAP={spec.S_CAP}", flush=True)
        want, plain_ms = _ms(lambda: wk.wavefront_plain(spec, *args))
        done = int(want[0][:, wk.O_DONE].sum())
        s_max = int(want[0][:, wk.O_S].max())
        smoke.check(done == FILL_B, f"plain {FILL_B} x {FILL_N} bp {name}: "
                    f"{done} done (plain_ms={plain_ms:.3f})")
        r = res[name] = {"plain_ms": plain_ms, "W": spec.W,
                         "S_CAP": spec.S_CAP, "max_s": s_max,
                         "cells": int(want[0][:, wk.O_NITER].sum())}
        for G in (1,) + tuple(sorted(wm.GS)):
            fn = (lambda: wk.wavefront(spec, *args)) if G == 1 \
                else (lambda: wm.wavefront_multi(spec, G, *args))
            got, ms = _ms(fn)
            bound_ms, bound_by = _k1_bound(spec, args, None, got)
            err = max(_max_err(a, b) for a, b in zip(got, want))
            key = "wavefront" if G == 1 else "wavefront_multi"
            v = {"variant": "K1"} if G == 1 else \
                wm.wavefront_multi.variants[smoke.dev.index][name]
            smoke.err[key] = max(smoke.err[key], err)
            smoke.check(err == 0 and (G == 1 or v["variant"] == "smem"),
                        f"{key} {FILL_B} x {FILL_N} bp {name} G={G} "
                        f"{v['variant']}: every output equal the plain "
                        f"version's, max_abs_err={err}")
            us = 1e3 * ms / max(s_max, 1)
            print(f"  {key}[{name}] G={G} {v}: kernel_ms={ms:.3f} "
                  f"us_per_cycle={us:.3f} bound_ms={bound_ms:.6f} "
                  f"({bound_by}) plain_ms={plain_ms:.3f} card={card}",
                  flush=True)
            r[G] = dict(ms=ms, us_per_cycle=us, bound_ms=bound_ms,
                        bound_by=bound_by, **v)
        # the smem variant at one lane a block, beside the chooser's
        err = max(_max_err(a, b) for a, b in
                  zip(wm._launch_smem(spec, *args, None, 1), want))
        smoke.err["wavefront_multi"] = max(smoke.err["wavefront_multi"], err)
        smoke.check(err == 0, f"wavefront_multi {FILL_B} x {FILL_N} bp "
                    f"{name} smem at 1 lane a block: every output equal "
                    f"the plain version's, max_abs_err={err}")
        del want
    return res


def _median_ms(fn, n=3):
    """(result, median milliseconds) of ``n`` calls, each timed with CUDA
    events."""
    runs = [_ms(fn) for _ in range(n)]
    return runs[0][0], sorted(ms for _, ms in runs)[n // 2]


def _walk_steps(cigs, cpw):
    """The longest lane's dependent steps in a walk: its DP steps (one
    per X, I or D character) plus its match words (cpw characters a
    word), counted from the CIGAR lists as _walk_bound counts them."""
    return max((sum((c >> 4) if (c & 0xF) != 7 else -(-(c >> 4) // cpw)
                    for c in cg) for cg in cigs), default=0)


def _time_walk(smoke, label, tb, meta, tw, qw, cpw, pens, card, plain=True):
    """W1 on one traceback in each variant (median of 3, CUDA events),
    each held against walk_plain, which is timed too with ``plain`` (else
    run once, untimed, for the check).  Returns the picked variant's
    time (``ms``) and each variant's, the bound, and the time a step of
    the longest lane's walk (``step_ns``)."""
    from miniwfa_tpu_torch.ops import traceback_device as tbd
    picked = tbd.pick_variant(tb.shape[2], tw.shape[1], cpw)
    if plain:
        want, plain_ms = _ms(lambda: tbd.walk_plain(tb, meta, tw, qw, cpw,
                                                    pens))
    else:
        want, plain_ms = tbd.walk_plain(tb, meta, tw, qw, cpw, pens), None
    by_variant, errs = {}, {}
    for v in tbd.VARIANTS:
        runs, by_variant[v] = _median_ms(
            lambda: tbd.walk(tb, meta, tw, qw, cpw, pens, variant=v))
        errs[v] = max(_max_err(a, b) for a, b in zip(runs, want))
    cigs = tbd.to_cigars(*want)
    bound_ms, bound_by = _walk_bound(cigs, tw, qw, meta, cpw)
    steps = _walk_steps(cigs, cpw)
    ms = by_variant[picked]
    res = dict(ms=ms, variant=picked, by_variant=by_variant,
               bound_ms=bound_ms, bound_by=bound_by, plain_ms=plain_ms,
               longest_steps=steps, step_ns=ms * 1e6 / max(steps, 1))
    smoke.err["walk"] = max(smoke.err["walk"], *errs.values())
    smoke.check(not any(errs.values()), f"W1 {label}, each variant against "
                f"walk_plain: max_abs_err={errs}")
    times = " ".join(f"{v}={t:.3f}" for v, t in by_variant.items())
    print(f"  walk {label} B={tb.shape[0]} S_CAP={tb.shape[1]} "
          f"W={tb.shape[2]}: kernel_ms {times} (picked {picked})"
          + (f" plain_ms={plain_ms:.3f}" if plain else "")
          + f" longest lane {steps} steps, {res['step_ns']:.1f} ns a step"
          f" bound_ms={bound_ms:.6f} ({bound_by}) card={card}", flush=True)
    return res


def kernel_times(smoke: Smoke, card: str, label: str, ts, qs, step: int,
                 plain: bool, cut: bool = False) -> dict:
    """Phase 5: every K1 mode, W1 and W2 at the first dispatch shape of
    that mode for the pairs ``ts``/``qs`` (low-mem at ``step``); with
    ``plain``, the plain versions beside them, which must agree.  With
    ``cut``, each K1 mode is held against its plain version at that shape
    with its lanes stopped past score MAIN_CUT (the low-mem modes at step
    CUT_STEP, their snapshot rows and checkpoint lists of the same
    shapes), and W1 against walk_plain on the whole traceback."""
    import numpy as np
    import torch
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.models import exact
    from miniwfa_tpu_torch.models import traceback as tbk
    from miniwfa_tpu_torch.ops import traceback_device as tbd
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk

    times = {}
    dev = smoke.dev

    def inputs(opt, mode, bk):
        spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, bk.W, bk.S_CAP,
                                                  ts, qs)
        return spec, lanes, [torch.from_numpy(a).to(dev)
                             for a in (lanes, tw, qw)]

    for mode in (wk.MODE_SCORE, wk.MODE_TB):
        opt = Options(cigar=mode == wk.MODE_TB)
        bk, _ = exact.first_bucket(opt, mode, ts, qs, 512, 512, dev)
        spec, lanes, args = inputs(opt, mode, bk)
        name = wk.launch_mode(spec, None)
        got, times[name] = _time_pair(
            smoke, f"{'cigar' if opt.cigar else 'score'} {label}", spec, args,
            None, card, plain)
        if cut:
            times[name]["cut"] = _hold_cut(smoke, label, spec, args, None,
                                           card)
            times[name]["multi"] = _multi_main(smoke, label, spec, args, got,
                                               card)
        if not opt.cigar:
            continue
        meta = torch.from_numpy(
            exact.walk_meta(lanes, got[0].cpu().numpy())).to(dev)
        times["walk"] = _time_walk(smoke, label, got[1], meta, args[1],
                                   args[2], spec.cpw,
                                   (opt.x, opt.o1, opt.e1, opt.o2, opt.e2),
                                   card, plain or cut)
        del got

    # low-mem: pass 1 at its first dispatch's shape, the checkpoint chain
    # (W2), then pass 2 with the checkpoints that pass 1 decoded
    opt = Options(cigar=True, step=step)
    bk, _ = exact.first_bucket(opt, wk.MODE_PASS1, ts, qs, 512, 512, dev)
    spec, lanes, args = inputs(opt, wk.MODE_PASS1, bk)
    got, times["PASS1"] = _time_pair(smoke, f"lowmem pass 1 {label}", spec,
                                     args, None, card, plain)
    p1 = (spec, lanes, args)
    o = got[0].cpu().numpy()
    ovf = (o[:, wk.O_OVFB] | o[:, wk.O_OVFS]) != 0
    smoke.check(not ovf.any(), f"K1 lowmem pass 1 {label}: every lane "
                f"finished in its first dispatch ({int(ovf.sum())} "
                f"overflowed)")
    cnt = np.where(ovf, 0, o[:, wk.O_SNC])
    lp = np.where(ovf, -1, o[:, wk.O_LP])
    # W2 as exact._run_pass1 calls it (numpy pointers, one copy in and
    # one out), and its plain version, the torch.gather chain
    (fin, recs), w2_ms = _median_ms(lambda: tbd.chain_ptrs(got[3], lp, cnt))
    (pfin, precs), gather_ms = _median_ms(
        lambda: tbd.chain_ptrs_plain(got[3], lp, cnt))
    err = int(max(abs(fin - pfin).max(initial=0),
                  abs(recs - precs).max(initial=0)))
    smoke.err["chain_ptrs"] = max(smoke.err["chain_ptrs"], err)
    smoke.check(err == 0, f"W2 chain_ptrs {label} against chain_ptrs_plain:"
                f" max_abs_err={err}")
    # W2 reads one int32 per snapshot row and lane and writes one int64
    # chain pointer, from two int64 inputs per lane
    rows = got[3].shape[1]
    w2_bound = _bound(rows * len(ts) * (4 + 8) + 2 * 8 * len(ts), 0)
    times["W2"] = dict(ms=w2_ms, bound_ms=w2_bound[0], bound_by=w2_bound[1],
                       plain_ms=gather_ms)
    print(f"  W2 chain_ptrs {label} B={len(ts)} rows={rows}: "
          f"kernel_ms={w2_ms:.3f} (one copy in, one out) plain_ms (the "
          f"gather chain)={gather_ms:.3f} bound_ms={w2_bound[0]:.3e} "
          f"({w2_bound[1]}) card={card}", flush=True)
    del got
    segs = [tbk.decode_checkpoints_ptrs(recs[:, j], int(fin[j]),
                                        int(lanes[j, wk.L_ANC]),
                                        int(cnt[j]), spec)
            for j in range(len(ts))]
    bk, _ = exact.pass2_bucket(opt, [int(v) for v in o[:, wk.O_S]], ts, qs,
                               512, 512, dev)
    spec, lanes, args = inputs(opt, wk.MODE_TB, bk)
    sg = torch.from_numpy(exact.seg_input(segs)).to(dev)
    got, times["TB+seg"] = _time_pair(smoke, f"lowmem pass 2 {label}", spec,
                                      args, sg, card, plain)
    meta = torch.from_numpy(
        exact.walk_meta(lanes, got[0].cpu().numpy())).to(dev)
    times["walk_pass2"] = _time_walk(
        smoke, f"lowmem pass 2 {label}", got[1], meta, args[1], args[2],
        spec.cpw, (opt.x, opt.o1, opt.e1, opt.o2, opt.e2), card, plain)
    del got
    if cut:
        times["PASS1"]["cut"], times["TB+seg"]["cut"] = _lowmem_cut(
            smoke, card, label, p1, (spec, args), sg.shape[1])
    return times


def _lowmem_cut(smoke, card, label, p1, p2, seg_cap):
    """The low-mem modes held against their plain versions at the
    dispatch shapes ``p1`` (spec, lanes, args) and ``p2`` (spec, args)
    with every lane stopped past score MAIN_CUT: pass 1 at step CUT_STEP
    with its n_snap rows, so it takes a snapshot; pass 2 with the first
    ``seg_cap`` checkpoints of each lane from a whole step-CUT_STEP pass 1
    (the kernel's, decoded by W2), so it collapses its band at one."""
    import dataclasses
    import torch
    from miniwfa_tpu_torch.models import exact
    from miniwfa_tpu_torch.models import traceback as tbk
    from miniwfa_tpu_torch.ops import traceback_device as tbd
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    spec, lanes, args = p1
    s1 = dataclasses.replace(spec, step=CUT_STEP)
    res1 = _hold_cut(smoke, f"lowmem pass 1 {label}", s1, args, None, card)
    full = dataclasses.replace(s1, n_snap=spec.S_CAP // CUT_STEP + 2)
    out, _, _, snap = wk.wavefront(full, *args)
    fin, recs = tbd.chain_ptrs(snap, out[:, wk.O_LP], out[:, wk.O_SNC])
    del snap
    o = out.cpu().numpy()
    segs = [tbk.decode_checkpoints_ptrs(
        recs[:, j], int(fin[j]), int(lanes[j, wk.L_ANC]),
        int(o[j, wk.O_SNC]), full)[:seg_cap] for j in range(len(lanes))]
    sg = torch.from_numpy(exact.seg_input(segs)).to(smoke.dev)
    res2 = _hold_cut(smoke, f"lowmem pass 2 {label}", p2[0], p2[1], sg,
                     card)
    return res1, res2


def wide_times(smoke: Smoke, card: str, first) -> dict:
    """Phase 5, wide: nbear1m's score run in K1 (one cluster) and in the
    wide kernel (the whole card) at the spec of align_batch's wide call
    (``first``, phase 4d's): every output equal, and both kernel times
    (CUDA events; the wide kernel's summed over run_chunked's calls)."""
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    from miniwfa_tpu_torch.ops import wavefront_wide as ww

    spec, *args = first
    print(f"phase 5, wide: nbear1m score, K1 against the wide kernel at "
          f"W={spec.W} (cpw={spec.cpw})", flush=True)
    with WideTimer() as wt:
        out, _, _ = ww.run_chunked(spec, *args)
    wide = wt.totals()["SCORE"]
    k1, k1_ms = _ms(lambda: wk.wavefront(spec, *args))
    err = _max_err(out, k1[0])
    smoke.err["wavefront_wide"] = max(smoke.err["wavefront_wide"], err)
    o = out.cpu().numpy()[0]
    smoke.check(err == 0 and o[wk.O_DONE] == 1, f"wide vs K1 nbear1m score "
                f"W={spec.W}: s={o[wk.O_S]} n_iter={o[wk.O_NITER]}, every "
                f"output equal (max_abs_err={err})")
    print(f"  nbear1m score W={spec.W}: wide_kernel_ms={wide['ms']:.3f} "
          f"({wide['calls']} calls, {wide['variant']} n={wide['n']} "
          f"k={wide['k']}, {wide['blocks']} blocks, {wide['batches']} "
          f"batches, {wide['us_per_cycle']:.3f} us a cycle) "
          f"k1_kernel_ms={k1_ms:.3f} "
          f"(C={wk.wavefront.clusters[0]['SCORE']['C']}) cells={wide['cells']} "
          f"bound_ms={wide['bound_ms']:.6f} ({wide['bound_by']}) "
          f"card={card}", flush=True)
    return dict(wide, k1_ms=k1_ms, W=spec.W)


# the wide kernel against wide_plain at the path's own specs, from a fresh
# state: score past five 256-cycle shrinks, pass 1 past its first snapshot
# (score 4999); the kernel in calls that pause right after the shrink cycle
# 767, (PASS1) the snapshot cycle step-1, and at the end
T_SCORE, T_PASS1, T_SHRINK = 1300, 5200, 768
# div5m's pass-1 spec at step 64 with 40 snapshot rows of 113 MB: the last
# rows lie past 2^32 bytes into the buffer, as div5m's 58 rows do at step
# 5000
STEP_ROWS, N_ROWS = 64, 40


def wide_real_shapes(smoke: Smoke, card: str, first) -> dict:
    """Phase 5, wide: the wide kernel against wide_plain at the specs its
    path ran in phase 4d (``first``: nbear1m score at W=2^20, div5m pass 1
    at step 5000, and the latter at step STEP_ROWS with N_ROWS snapshot
    rows), for the cycles set above: every output, the state row, the
    planes and the snapshot rows equal.  Returns the plain and kernel
    times by run."""
    import dataclasses
    import torch
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    from miniwfa_tpu_torch.ops import wavefront_wide as ww

    print("phase 5, wide: the wide kernel against wide_plain at the path's "
          "specs", flush=True)
    d5 = first["div5m"][0]
    runs = (("nbear1m score", first["nbear1m"][0], T_SCORE),
            ("div5m pass 1", dataclasses.replace(
                d5, n_snap=max(d5.n_snap, T_PASS1 // d5.step)), T_PASS1),
            (f"div5m pass 1 step={STEP_ROWS}", dataclasses.replace(
                d5, step=STEP_ROWS, n_snap=N_ROWS), STEP_ROWS * N_ROWS))
    times = {}
    for label, spec, t_end in runs:
        args = first[label.split()[0]][1:]
        B = args[0].shape[0]

        def lim(t):
            return torch.full((B,), t, dtype=torch.int64, device=smoke.dev)

        pst = ww.new_state(spec, args[0])
        want, plain_ms = _ms(lambda: ww.wide_plain(spec, *args, pst,
                                                   lim(t_end)))
        kst = ww.new_state(spec, args[0])
        stops = sorted({T_SHRINK, t_end} | ({spec.step} if spec.step
                                            else set()))
        ms = 0.0
        for t in stops:
            got, m = _ms(lambda: ww.wide(spec, *args, kst, lim(t)))
            ms += m
        err = max(_max_err(x, y) for x, y in (
            (got, want), (kst.row, pst.row), (kst.planes, pst.planes),
            (kst.snap, pst.snap)))
        rows = int(want[:, wk.O_SNC].sum())
        del kst, pst
        smoke.err["wavefront_wide"] = max(smoke.err["wavefront_wide"], err)
        smoke.check(err == 0 and bool(want[:, ww.OW_PAUSE].all()),
                    f"wide {label} W={spec.W} S_CAP={spec.S_CAP} "
                    f"cycles 0..{t_end - 1} in calls ending at {stops}: "
                    f"{rows} snapshot rows, every output, the state "
                    f"row, the planes and the snapshot rows equal "
                    f"wide_plain's, max_abs_err={err} (kernel_ms={ms:.3f} "
                    f"plain_ms={plain_ms:.3f} card={card})")
        times[label] = dict(cycles=t_end, ms=ms, plain_ms=plain_ms)
    return times


def gaps_times(smoke: Smoke, card: str, t: bytes, q: bytes) -> dict:
    """Phase 5, gaps: K3 SCORE and TB, and W1 on K3's traceback, against
    their plain versions at div5m auto's first K3 dispatch (its chain
    plan's gaps ordered by score bound, the first GMAX of them)."""
    import numpy as np
    import torch
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.models import tiny
    from miniwfa_tpu_torch.ops import pack
    from miniwfa_tpu_torch.ops import wavefront_gaps as wg

    gaps = chain_gaps([t], [q], Options())
    cpw = 16 if all(pack.can_pack2(p) for p in gaps) else 4
    sb = [tiny._s_bound(Options(), len(a), len(b)) for a, b in gaps]
    sel = sorted(range(len(gaps)), key=lambda g: sb[g])[:tiny.GMAX]
    s_cap = tiny._scap_bucket(max(sb[g] for g in sel))
    lens = np.array([[len(gaps[g][0]), len(gaps[g][1])] for g in sel],
                    dtype=np.int32)
    classes = {str(wd): n for wd, (_, n) in zip(wg.CLASSES,
                                                 wg.plan(lens)[1])}
    print(f"phase 5, gaps: div5m's chain plan holds {len(gaps)} gaps of at "
          f"most 127 bp; first dispatch G={len(sel)} S_CAP={s_cap} "
          f"cpw={cpw}, gaps by window slots {classes}", flush=True)
    times = {"classes": classes}
    for opt in (Options(), Options(cigar=True)):
        spec, lens, tw, qw = tiny.dispatch_inputs(
            opt, [gaps[g][0] for g in sel], [gaps[g][1] for g in sel], cpw,
            s_cap)
        args = [torch.from_numpy(a).to(smoke.dev) for a in (lens, tw, qw)]
        got, ms = _ms(lambda: wg.gaps(spec, *args))
        want, plain_ms = _ms(lambda: wg.gaps_plain(spec, *args))
        err = max(_max_err(a, b) for a, b in zip(got, want))
        smoke.err["gaps"] = max(smoke.err["gaps"], err)
        del want
        mode = "TB" if opt.cigar else "SCORE"
        bound_ms, bound_by = _gaps_bound(spec, args, got[0])
        print(f"  gaps[{mode}] div5m first dispatch G={len(sel)} "
              f"S_CAP={s_cap}: kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"bound_ms={bound_ms:.6f} ({bound_by}) "
              f"cells={int(got[0][:, wg.GO_NI].sum())} card={card}",
              flush=True)
        smoke.check(err == 0, f"K3 div5m first dispatch {mode}: "
                    f"max_abs_err={err}")
        times[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
        if opt.cigar:
            meta = torch.from_numpy(
                tiny.walk_meta(lens, got[0].cpu().numpy())).to(smoke.dev)
            times["walk"] = _time_walk(
                smoke, "on K3 div5m first dispatch", got[1], meta, args[1],
                args[2], cpw, (opt.x, opt.o1, opt.e1, opt.o2, opt.e2), card)
        del got
    return times


def probe_phase(smoke: Smoke, card: str) -> dict:
    """Phase 2p, group P: the probe kernels of csrc/probes.cu, through the
    entry point a user runs, ``tools/microbench.py``, on every probe file
    at its shapes with the loop counts cut to 16 (P5 to 128 cycles, so
    that its 64-slot tb ring wraps).  Each case runs once: held equal to
    its plain version there and timed (CUDA events), with its bound and
    one library op's time.  The counts are set to 0 just before and read
    just after: every one of the 32 probe wrappers must have launched.
    Returns the ``kernels`` line's ``probes`` entry."""
    import io
    from miniwfa_tpu_torch.tools import microbench as mb

    wrappers = mb.wrappers()
    names = {c.pid: c.fn.__name__ for c in mb.all_cases()}
    for f in wrappers:
        f.launches = 0
    log = io.StringIO()
    out = (mb.run([f for f in mb.FILES if f != "chunk"], smoke.dev,
                  iters=mb.CHECK_ITERS, out=log)
           + mb.run(["chunk"], smoke.dev, iters=mb.CHECK_CYCLES, out=log))
    launches = {f.__name__: f.launches for f in wrappers}
    idle = [n for n, k in launches.items() if k == 0]
    smoke.check(not idle and len(wrappers) == 32,
                f"probes: tools/microbench.py on all {len(mb.FILES)} files "
                f"launched all {len(wrappers)} probe kernels "
                f"({sum(launches.values())} launches; none: {idle})")
    recs = {}
    for r in out:
        smoke.err["probes"] = max(smoke.err["probes"], r["max_abs_err"])
        recs.setdefault(r["pid"], (names[r["pid"]], []))[1].append(r)
    bodies = []
    for pid, (name, rs) in recs.items():
        err = max(r["max_abs_err"] for r in rs)
        smoke.check(err == 0, f"probe {pid} {name} on {len(rs)} shape(s): "
                    f"max_abs_err={err}")
        top = max(rs, key=lambda r: r["ms"])
        bodies.append({
            "id": pid, "name": name, "replaces": mb.SITES[pid],
            "launches": launches[name], "max_abs_err": err,
            "shape": top["label"], "iters": top["iters"], "ms": top["ms"],
            "per_op_us": top["per_op_us"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"]})
        print(f"  {pid:4s} {name:20s} {top['label']:38s} it={top['iters']}: "
              f"kernel_ms={top['ms']:.4f} plain_ms={top['plain_ms']:.3f} "
              f"bound_ms={top['bound_ms']:.6f} ({top['bound_by']}) "
              f"library_ms={top['library_ms']} card={card}", flush=True)
    worst = max(bodies, key=lambda b: b["bound_ms"])
    return {
        "name": "probes", "route": "cuda",
        "source": "miniwfa_tpu_torch/csrc/probes.cu",
        "replaces": ", ".join(dict.fromkeys(mb.SITES.values())),
        "launches": sum(launches.values()),
        "max_abs_err": smoke.err["probes"],
        "ms": sum(b["ms"] for b in bodies),
        "plain_ms": sum(b["plain_ms"] for b in bodies),
        "bound_ms": sum(b["bound_ms"] for b in bodies),
        "bound_by": worst["bound_by"], "library_ms": None,
        "entry_point": "miniwfa_tpu_torch/tools/microbench.py",
        "bodies": bodies}


# phase 6: the port's benchmarks, each a subprocess with its time limit:
# (name, arguments, environment)
BENCH_RUNS = (("bench_cuda.py", ["bench_cuda.py"],
               {"MWF_BENCH_REPS": "1", "MWF_BENCH_BIG_N": "0"}),
              ("scaling_bench",
               ["-m", "miniwfa_tpu_torch.tools.scaling_bench",
                str(N_MAIN), str(B_MAIN)], {}))
BENCH_TIMEOUT = 180


def bench_phase(smoke: Smoke, card: str) -> None:
    """Phase 6: ``bench_cuda.py`` (one timed run, no 2 x 200 kb row) and
    the scaling bench at the main path's shape, each in its own process on
    the card; echoes each one's output and seconds, and fails the run on a
    non-zero exit or a time-out."""
    import torch
    torch.cuda.empty_cache()     # the earlier phases' cached blocks
    print("phase 6: the port's benchmarks", flush=True)
    for name, args, env in BENCH_RUNS:
        t0 = time.perf_counter()
        try:
            p = subprocess.run([sys.executable, *args], cwd=ROOT,
                               env={**os.environ, **env},
                               capture_output=True, text=True,
                               timeout=BENCH_TIMEOUT)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:   # run() killed it
            rc, out = None, (e.stdout or b"").decode(errors="replace")
            err = f"no end in {BENCH_TIMEOUT} s"
        for line in out.strip().splitlines():
            print(f"  {name}: {line}", flush=True)
        smoke.check(rc == 0, f"{name}: exit {rc} in "
                    f"{time.perf_counter() - t0:.1f} s card={card}"
                    + ("" if rc == 0 else f"; its errors end:\n"
                       f"{err[-2000:]}"))


def ksim_times(smoke, card, ts, qs) -> dict:
    """The ksim kernel (csrc/ksim.cu) at the main path's pairs:
    ``tools/ksim_bench.time_counts`` (its launch by CUDA events, the plain
    version on the card, the wrapper and the host's sorts), held equal to
    the plain version and the host's similarities."""
    from miniwfa_tpu_torch.tools import ksim_bench
    r = ksim_bench.time_counts(list(zip(ts, qs)), smoke.dev)
    smoke.check(r["equal"], f"ksim {B_MAIN} pairs: the kernel's counts "
                f"equal the plain version's, its similarities the host's")
    print(f"  ksim B={B_MAIN} slots={r['slots']}: kernel_ms (fill and both "
          f"kernels)={r['launch_ms']:.3f} {r['kernels_us']} plain_ms (on "
          f"the card)={r['plain_ms']:.3f} wrapper_ms={r['wrapper_ms']:.3f} "
          f"host_ms={r['host_ms']:.3f} bound_ms={r['bound_ms']:.6f} (bytes) "
          f"card={card}", flush=True)
    return {"ms": r["launch_ms"], "bound_by": "bytes", **r}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "miniwfa_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(miniwfa_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from miniwfa_tpu_torch.ops import build
    from miniwfa_tpu_torch.utils import native

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    logs = build.build()
    print(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
          f"(host runtime native={native.available()})", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # gaps.cu's and wavefront_multi.cu's shared memory is dynamic, so ptxas
    # does not report it: K3's block of each width class, K4's smem lane at
    # the 2048 x 1 kb gap fills' window, at the default penalties
    from miniwfa_tpu_torch.ops import wavefront_gaps as wg
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    from miniwfa_tpu_torch.ops import wavefront_multi as wm
    gspec = wg.GSpec(S_CAP=64, x=4, o1=4, e1=2, o2=15, e2=1)
    print("  gaps: dynamic shared memory a block (bytes, warps) by class "
          + ", ".join(f"{wd}: {wg.block_of(gspec, c)}"
                      for c, wd in enumerate(wg.CLASSES)))
    kspec = wk.KSpec(W=512, S_CAP=64, x=4, o1=4, e1=2, o2=15, e2=1)
    print(f"  wavefront_multi smem: {wm.lane_smem(kspec)} bytes a lane at "
          f"W=512")

    smoke = Smoke(torch.device("cuda", 0))
    t0 = time.perf_counter()
    kernel_phases(smoke)
    wtimes8 = wide_phases(smoke, card)
    tp = time.perf_counter()
    print("phase 2p: the probe kernels (group P) through "
          "tools/microbench.py, each against its plain version",
          flush=True)
    probes = probe_phase(smoke, card)
    t1 = time.perf_counter()
    info = main_path(smoke, card)
    penalty_runs(smoke, card)
    winfo = wide_path(smoke, card, info["fixture"], info["sgold"])
    t_sh = time.perf_counter()
    sharded = sharded_path(smoke, card, info)
    t2 = time.perf_counter()
    print("phase 5: kernel timings at the main path's dispatch shapes, "
          "each K1 mode held against its plain version there with its lanes "
          "stopped early, the plain versions timed at the 8 kb benchmark "
          "shape", flush=True)
    times = kernel_times(smoke, card, "main", info["ts"], info["qs"],
                         STEP_MAIN, plain=False, cut=True)
    pairs = make_pairs(8000, 64)[:8]
    ptimes = kernel_times(smoke, card, "bench8k",
                          [t.encode() for t, _ in pairs],
                          [q.encode() for _, q in pairs], 200, plain=True)
    gtimes = gaps_times(smoke, card, *info["fixture"]("div5m"))
    ftimes = gap_fill_times(smoke, card)
    wtime = wide_times(smoke, card, winfo["first"]["nbear1m"])
    wreal = wide_real_shapes(smoke, card, winfo["first"])
    ktime = ksim_times(smoke, card, info["ts"], info["qs"])
    t3 = time.perf_counter()
    bench_phase(smoke, card)
    print(f"phase seconds: kernels {tp - t0:.1f}, probes {t1 - tp:.1f}, "
          f"main path {t_sh - t1:.1f}, sharded {t2 - t_sh:.1f}, "
          f"timings {t3 - t2:.1f}, benchmarks "
          f"{time.perf_counter() - t3:.1f}", flush=True)
    launches = info["launches"]
    wl = winfo["launches"]

    def timed(t, p=None):
        """ms and bound at the main path's shape; plain_ms (and the
        kernel's own time there) at the 8 kb shape ``p``."""
        res = {k: t[k] for k in ("ms", "bound_ms", "bound_by")}
        p = p or t
        res["plain_ms"] = p.get("plain_ms")
        if p is not t:
            res["plain_shape_kernel_ms"] = p["ms"]
        return res

    # each K1 mode's check against its plain version at the main shape,
    # its lanes stopped past max_s: both times
    modes = {m: {"launches": launches["modes"].get(m, 0),
                 **timed(times[m], ptimes[m]),
                 **launches["clusters"].get(m, {}),
                 "main_shape_cut": times[m]["cut"]}
             for m in ("SCORE", "TB", "PASS1", "TB+seg")}
    d5 = winfo["div5m_pass1"]
    def tiled(w):
        """The wide kernel's variant, tile and batches over a run."""
        return {k: w.get(k) for k in ("variant", "n", "k", "calls",
                                      "cycles", "us_per_cycle", "batches",
                                      "reruns", "block0")}

    wmodes = {
        "SCORE": {"launches": wl["modes"].get("SCORE", 0),
                  **timed(wtime, wtimes8["SCORE"]), "k1_ms": wtime["k1_ms"],
                  **tiled(wtime), "shape": f"nbear1m score W={wtime['W']}"},
        "PASS1": {"launches": wl["modes"].get("PASS1", 0),
                  **timed(d5, wtimes8["PASS1"]), **tiled(d5),
                  "shape": "div5m low-mem pass 1"}}
    # SCORE's at the entry's top level, TB's under its own key
    fills = {m: {"shape": f"{FILL_B} x {FILL_N} bp {m} W={ftimes[m]['W']} "
                          f"S_CAP={ftimes[m]['S_CAP']}",
                 "cells": ftimes[m]["cells"], "max_s": ftimes[m]["max_s"],
                 "plain_ms": ftimes[m]["plain_ms"],
                 "by_G": {str(g): ftimes[m][g] for g in (1, 2, 4, 8)}}
             for m in ("SCORE", "TB")}
    kernels = [
        {"name": "wavefront", "route": "cuda",
         "source": "miniwfa_tpu_torch/csrc/wavefront.cu",
         "replaces": "miniwfa_tpu/ops/wavefront_kernel.py:226",
         "launches": launches["wavefront"],
         "sharded_launches": sharded["wavefront"],
         "max_abs_err": smoke.err["wavefront"],
         **timed(times["SCORE"], ptimes["SCORE"]),
         "C": launches["clusters"].get("SCORE", {}).get("C"),
         "library_ms": None, "modes": modes},
        {"name": "walk", "route": "cuda",
         "source": "miniwfa_tpu_torch/csrc/walk.cu",
         "replaces": "miniwfa_tpu/ops/traceback_device.py:33",
         "launches": launches["walk"], "max_abs_err": smoke.err["walk"],
         "sharded_launches": sharded["walk"],
         **timed(times["walk"], ptimes["walk"]), "library_ms": None,
         "main_launches": launches["walk_main"],
         "launches_by_variant": launches["walk_variants"],
         "main_shape_plain_ms": times["walk"]["plain_ms"],
         **{k: times["walk"][k] for k in ("variant", "by_variant",
                                          "longest_steps", "step_ns")},
         "on_gaps": {"launches": launches["walk_on_gaps"],
                     **timed(gtimes["walk"]),
                     **{k: gtimes["walk"][k] for k in ("variant",
                                                       "by_variant")}},
         "lowmem_pass2": {k: times["walk_pass2"][k] for k in (
             "ms", "variant", "by_variant", "step_ns", "bound_ms",
             "bound_by")},
         "pass2_wide": winfo["pass2"],
         "div5m_auto": launches.get("div5m_auto_w1")},
        {"name": "chain_ptrs", "route": "cuda",
         "source": "miniwfa_tpu_torch/csrc/walk.cu",
         "replaces": "miniwfa_tpu/ops/traceback_device.py:324",
         "launches": launches["chain_ptrs"] + wl["chain_ptrs"],
         "main_launches": launches["chain_ptrs"],
         "sharded_launches": sharded["chain_ptrs"],
         "max_abs_err": smoke.err["chain_ptrs"],
         **timed(times["W2"], ptimes["W2"]),
         "library_ms": times["W2"]["plain_ms"]},
        {"name": "gaps", "route": "cuda",
         "source": "miniwfa_tpu_torch/csrc/gaps.cu",
         "replaces": "miniwfa_tpu/ops/wavefront_gaps.py:90",
         "launches": launches["gaps"], "max_abs_err": smoke.err["gaps"],
         "launches_by_variant": launches["gaps_classes"],
         "sharded_launches": sharded["gaps"],
         **timed(gtimes["TB"]), "library_ms": None,
         "classes": gtimes["classes"],
         "modes": {m: timed(gtimes[m]) for m in ("SCORE", "TB")}},
        {"name": "wavefront_wide", "route": "cuda",
         "source": "miniwfa_tpu_torch/csrc/wavefront_wide.cu",
         "replaces": "miniwfa_tpu/ops/wavefront_wide.py:158",
         "launches": wl["wavefront_wide"],
         "sharded_launches": sharded["wide"],
         "max_abs_err": smoke.err["wavefront_wide"],
         **timed(wtime, wtimes8["SCORE"]), "library_ms": None,
         **{k: wtime.get(k) for k in ("variant", "n", "k")},
         "launches_by_variant": {v: wl["variants"].get(v, 0)
                                 for v in ("tile", "cycle")},
         "checks_by_variant": wtimes8["checks"],
         "modes": wmodes, "path_spec_checks": wreal},
        {"name": "wavefront_multi", "route": "cuda",
         "source": "miniwfa_tpu_torch/csrc/wavefront.cu",
         "replaces": "miniwfa_tpu/ops/wavefront_multi.py:138",
         "launches": launches["wavefront_multi"],
         "sharded_launches": sharded["multi"],
         "max_abs_err": smoke.err["wavefront_multi"],
         **{k: times["SCORE"]["multi"][k] for k in ("ms", "bound_ms",
                                                    "bound_by")},
         "plain_ms": ftimes["SCORE"]["plain_ms"],
         "plain_shape_kernel_ms": ftimes["SCORE"][8]["ms"],
         "library_ms": None,
         "launches_by_variant": launches["multi_variants"],
         "variants": {
             "smem": "miniwfa_tpu_torch/csrc/wavefront_multi.cu",
             "global": "miniwfa_tpu_torch/csrc/wavefront.cu"},
         "modes": {m: {"launches": launches["multi_modes"].get(m, 0),
                       **times[m]["multi"]} for m in ("SCORE", "TB")},
         "gap_fills": {**fills["SCORE"], "TB": fills["TB"]}},
        {**probes, "sharded_launches": sharded["probes"]},
        {"name": "ksim", "route": "cuda",
         "source": "miniwfa_tpu_torch/csrc/ksim.cu",
         "replaces": None, "launches": launches["ksim"],
         "max_abs_err": smoke.err["ksim"], "library_ms": None,
         **{k: ktime[k] for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                                  "kernels_us", "wrapper_ms", "host_ms")}}]
    print(json.dumps({"kernels": kernels}), flush=True)
    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} check(s) failed:",
              file=sys.stderr)
        for f in smoke.failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
