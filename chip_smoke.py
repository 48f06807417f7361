#!/usr/bin/env python3
"""Chip smoke test of miniwfa_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the CUDA kernels from
   miniwfa_tpu_torch/csrc (one nvcc per source, started together);
2. holds the wavefront kernel (K1) against its plain PyTorch version on
   the card, SCORE and TB modes, on the golden corpus (four penalty
   regimes) and on 8 of the 8 kb benchmark pairs: every per-lane output,
   every traceback byte and every recorded band must be equal; then the
   low-mem modes on the goldens (step 16 and 100) and the 8 kb pairs
   (step 200): K1 PASS1 (every output and the whole snapshot buffer),
   the checkpoint chain from both snapshot buffers, and K1 TB with the
   decoded checkpoints (every output and traceback byte); then the gaps
   kernel (K3) in SCORE and TB modes at cpw 16 and 4 on every gap fill of
   at most 127 bp in the goldens' chain plans, on seeded random gaps with
   the edge pairs, and with a max_s early stop: every output and every
   traceback byte must be equal;
3. holds the CIGAR walker (W1) against its plain version on phase 2's
   traceback outputs, K1's and K3's: identical run lists;
4. drives the main path, ``align_batch`` on 16 pairs of 100 kb at 2%
   divergence in score, CIGAR and low-mem (step 5000) modes, checks every
   score and CIGAR digest against tests/data/bench_goldens.json, that each
   CIGAR re-scores and consumes both sequences, and that each mode's
   kernels were launched (counts set to 0 just before each run and read
   just after); then the scale fixture dissim150k (150 kb, a 12 kb
   unrelated insert) in low-mem mode, and the chain (-u -c) and auto
   (-t -c) modes on the scale fixtures, up to div5m (5 Mb), against
   tests/data/scale_goldens.json, with the split of div5m auto's wall;
5. times each kernel mode against its plain version (CUDA events) at the
   main path's first dispatch shape of that mode, where the two must again
   agree exactly: SCORE, TB and the walker on its traceback, PASS1, TB
   with the checkpoints PASS1 decoded, and K3 SCORE and TB and the walker
   on K3's traceback at div5m auto's first K3 dispatch.

The tolerance of every comparison is exact equality: both versions run
the same integer algorithm.  Prints a ``kernels`` JSON line (each entry's
``ms``/``plain_ms``/``bound_ms`` are phase 5's: the wavefront entry's
SCORE's, the gaps entry's TB's; ``modes`` holds every mode's launches in
the main path's runs and its phase-5 times; ``launches`` sums the main
path's runs, phase 4) and, last, a JSON line with ``"ok": true`` and the
device.  Exits non-zero without a CUDA device, outside a checkout of the
repository, or if any check fails.

``bound_ms`` is the least time the card could take for the same work: the
larger of the bytes the call must move (inputs read once, outputs written
once, the traceback's in-band cells only) over 3.35 TB/s, and its int32
operations over the card's int32 instruction rate (132 SMs x 64 INT32
lanes x 1.98 GHz, NVIDIA's Hopper white paper and H100 SXM data sheet).
Operations are counted per wavefront cell (Σ n_iter of this run) from the
kernels' transition code, csrc/gaps.cu and csrc/wavefront.cu: OPS_SCORE
for the 5-state recurrence and its extension probe, plus OPS_TB for the
tb byte, or OPS_PASS1 for the pointer choice; the walker's per DP step
and per match word.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MAIN, B_MAIN = 100_000, 16
STEP_MAIN = 5000
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per cell: max/+1/compare-select of the recurrence (19)
# and the extension's XOR/ctz probe (1); the tb byte's 4 compares, shifts
# and ORs (14); PASS1's pointer selects (5) and source tests (4)
OPS_SCORE, OPS_TB, OPS_PASS1 = 20, 14, 9
# the walker: one DP step decodes a tb byte (~12 ops), one match word is
# two funnel shifts, an XOR, a clz and the cursor updates (~8)
OPS_WALK_STEP, OPS_WALK_WORD = 12, 8
# chain (-u -c) and auto (-t -c) runs on the scale fixtures
SCALE_RUNS = (("chain", ("div100k", "sv300k", "rep200k", "dissim150k",
                         "nbear1m")),
              ("auto", ("del50k", "div100k", "dissim150k", "nbear1m",
                        "div5m")))


def _mutate(rng, seq, sub, ind, max_indel=8):
    """Substitutions and short indels (tools/bench_kernel.py::mutate and
    bench.py::mutate, restated here: those modules belong to the JAX
    package's side)."""
    out = []
    bases = "ACGT"
    i, n = 0, len(seq)
    while i < n:
        if rng.random() < ind:
            if rng.random() < 0.5:
                i += rng.randint(1, max_indel)
                continue
            out.append("".join(rng.choice(bases)
                               for _ in range(rng.randint(1, max_indel))))
        c = seq[i]
        if rng.random() < sub:
            c = rng.choice([b for b in bases if b != c])
        out.append(c)
        i += 1
    return "".join(out)


def _rand(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def make_pairs(n, b, seed=7):
    """The benchmark pairs (bench.py::make_pairs, restated): b pairs of
    n bp, 2% substitutions and 0.2% indels."""
    import random
    rng = random.Random(seed)
    pairs = []
    for _ in range(b):
        t = _rand(rng, n)
        pairs.append((t, _mutate(rng, t, sub=0.02, ind=0.002)))
    return pairs


def gen_case(name):
    """The scale fixtures of tests/data/scale_goldens.json
    (tools/make_scale_goldens.py::gen_case, restated without JAX)."""
    import random
    if name == "del50k":         # one 5 kb deletion
        rng = random.Random(501)
        t = _rand(rng, 50_000)
        return t, t[:20_000] + t[25_000:]
    if name == "div100k":        # 2% substitutions, 0.2% indels
        rng = random.Random(1001)
        t = _rand(rng, 100_000)
        return t, _mutate(rng, t, sub=0.02, ind=0.002)
    if name == "div5m":          # the reference's headline 5 Mb pair
        rng = random.Random(5001)
        t = _rand(rng, 5_000_000)
        return t, _mutate(rng, t, sub=0.008, ind=0.002)
    if name == "sv300k":         # multi-kb deletions and insertions
        rng = random.Random(3001)
        t = _rand(rng, 300_000)
        ins15, ins2 = _rand(rng, 15_000), _rand(rng, 2_000)
        q = (t[:50_000] + t[70_000:150_000] + ins15 + t[150_000:200_000]
             + t[203_000:250_000] + ins2 + t[250_000:])
        return t, _mutate(rng, q, sub=0.01, ind=0.0005)
    if name == "rep200k":        # tandem repeats, copy-number changes
        rng = random.Random(2002)
        u1, u2 = _rand(rng, 67), _rand(rng, 171)
        fill = [_rand(rng, n) for n in (60_000, 50_000, 70_000)]
        t = fill[0] + u1 * 150 + fill[1] + u2 * 60 + fill[2]
        q = fill[0] + u1 * 138 + fill[1] + u2 * 66 + fill[2]
        return t, _mutate(rng, q, sub=0.01, ind=0.0005)
    if name == "nbear1m":        # N runs and soft-masked stretches
        rng = random.Random(1101)
        t = _rand(rng, 1_000_000)
        t = (t[:200_000] + "N" * 5_000 + t[200_000:500_000]
             + "N" * 10_000 + t[500_000:700_000].lower()
             + t[700_000:900_000] + "N" * 2_000 + t[900_000:])
        return t, _mutate(rng, t, sub=0.01, ind=0.0005)
    if name == "dissim150k":     # a 12 kb unrelated region in the query
        rng = random.Random(1501)
        t = _rand(rng, 150_000)
        novel = _rand(rng, 12_000)
        q = t[:60_000] + novel + t[72_000:]
        return t, _mutate(rng, q, sub=0.015, ind=0.001)
    raise KeyError(name)


def _reset_counts():
    from miniwfa_tpu_torch.ops import traceback_device as tbd
    from miniwfa_tpu_torch.ops import wavefront_gaps as wg
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    wk.wavefront.launches = 0
    wk.wavefront.launches_by_mode.clear()
    tbd.walk.launches = 0
    wg.gaps.launches = 0


def _read_counts() -> dict:
    from miniwfa_tpu_torch.ops import traceback_device as tbd
    from miniwfa_tpu_torch.ops import wavefront_gaps as wg
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    return {"wavefront": wk.wavefront.launches, "walk": tbd.walk.launches,
            "gaps": wg.gaps.launches,
            "modes": dict(wk.wavefront.launches_by_mode)}


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
        self.err = {"wavefront": 0, "walk": 0, "gaps": 0}

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
        if keep_plain:
            return spec, lanes, got, tw_t, qw_t, want
        return spec, lanes, got, tw_t, qw_t

    def checkpoints(self, label, spec, lanes, got, want):
        """The checkpoint chain (W2) over the kernel's and the plain
        version's snapshot buffers: identical pointers; returns the
        kernel's decoded checkpoint lists."""
        from miniwfa_tpu_torch.models import traceback as tbk
        from miniwfa_tpu_torch.ops import traceback_device as tbd
        from miniwfa_tpu_torch.ops import wavefront_kernel as wk
        o = got[0]
        fin, recs = tbd.chain_ptrs(got[3], o[:, wk.O_LP], o[:, wk.O_SNC])
        pfin, precs = tbd.chain_ptrs(want[3], want[0][:, wk.O_LP],
                                     want[0][:, wk.O_SNC])
        err = int(max(abs(fin - pfin).max(initial=0),
                      abs(recs - precs).max(initial=0)))
        self.err["wavefront"] = max(self.err["wavefront"], err)
        o = o.cpu().numpy()
        segs = [tbk.decode_checkpoints_ptrs(
            recs[:, j], int(fin[j]), int(lanes[j, wk.L_ANC]),
            int(o[j, wk.O_SNC]), spec) for j in range(len(lanes))]
        self.check(err == 0, f"W2 {label}: {sum(map(len, segs))} checkpoints "
                   f"decoded, chain pointers max_abs_err={err}")
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
    print("phase 2+3: kernels against their plain versions", flush=True)
    for run, opt, mode in regimes:
        # the whole corpus packs at cpw=4 (it holds lowercase and
        # non-ACGT bytes); its ACGT-only subset packs at cpw=16
        batches = [(f"goldens-acgt/{run}", acgt)]
        if run in ("score", "cigar"):
            batches.insert(0, (f"goldens/{run}", range(len(cases))))
        for label, sel in batches:
            sub_t, sub_q = [ts[i] for i in sel], [qs[i] for i in sel]
            spec, lanes, got, tw, qw = smoke.k1_pair(
                label, opt, mode, 8192, 4096, sub_t, sub_q)
            o = got[0].cpu().numpy()
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
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        t = _rand(rng, rng.randint(1, maxn))
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


def _drive(label, pairs, opt, card, fn=None, **kw):
    """One run of ``fn`` (default ``align_batch``) on the card with the
    launch counts set to 0 just before it and read just after; returns
    (results, counts, wall seconds)."""
    import torch
    from miniwfa_tpu_torch.models import exact
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = (fn or exact.align_batch)(pairs, opt, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    cells = sum(r.n_iter for r in res)
    print(f"  {label}: wall_s={wall:.6f} cells={cells} "
          f"cells_per_s={cells / wall:.6e} peak_bytes={peak} "
          f"launches wavefront={counts['wavefront']} {counts['modes']} "
          f"walk={counts['walk']} gaps={counts['gaps']} card={card}",
          flush=True)
    return res, counts, wall


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
    launches = {"wavefront": 0, "walk": 0, "modes": {}}
    for mode, opt, kmodes in modes:
        res, counts, _ = _drive(mode, list(zip(ts, qs)), opt, card)
        smoke.check([r.s for r in res] == [g["s"] for g in gold],
                    f"main {mode}: {B_MAIN} scores equal bench_goldens.json")
        if opt.cigar:
            _check_cigars(smoke, f"main {mode}", ts, qs, res,
                          [g["cigar_md5"] for g in gold])
        for k in kmodes:
            n = counts["modes"].get(k, 0)
            smoke.check(n > 0, f"main {mode} launched wavefront[{k}] {n} "
                        f"times")
        if opt.cigar:
            smoke.check(counts["walk"] > 0, f"main {mode} launched walk "
                        f"{counts['walk']} times")
        for k in ("wavefront", "walk"):
            launches[k] += counts[k]
        for k, n in counts["modes"].items():
            launches["modes"][k] = launches["modes"].get(k, 0) + n

    print("phase 4b: scale fixture dissim150k, low-mem step 5000", flush=True)
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

    t, q = fixture("dissim150k")
    g = sgold["dissim150k"]["lowmem_p5000"]
    res, counts, _ = _drive("dissim150k", [(t, q)],
                            Options(cigar=True, step=STEP_MAIN), card)
    smoke.check(res[0].s == g["s"], f"dissim150k: s={res[0].s} equals "
                f"scale_goldens.json ({g['s']})")
    _check_cigars(smoke, "dissim150k", [t], [q], res, [g["cigar_md5"]])
    for k in ("PASS1", "TB+seg"):
        n = counts["modes"].get(k, 0)
        smoke.check(n > 0, f"dissim150k launched wavefront[{k}] {n} times")

    print("phase 4c: chain (-u -c) and auto (-t -c) on the scale fixtures",
          flush=True)
    from miniwfa_tpu_torch.models.auto import align_auto_batch
    from miniwfa_tpu_torch.models.chain import align_chain_batch
    from miniwfa_tpu_torch.utils.spans import Spans
    launches["gaps"] = 0
    launches["walk_on_gaps"] = 0
    fns = {"chain": align_chain_batch, "auto": align_auto_batch}
    for mode, names in SCALE_RUNS:
        for name in names:
            t, q = fixture(name)
            g = sgold[name][mode]
            spans = Spans()
            res, counts, wall = _drive(f"{name} {mode}", [(t, q)],
                                       Options(cigar=True), card,
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
            smoke.check(on_gaps == counts["gaps"],
                        f"{name} {mode}: walk launched {on_gaps} times on "
                        f"K3's {counts['gaps']} tracebacks")
            for k in ("wavefront", "walk", "gaps"):
                launches[k] += counts[k]
            launches["walk_on_gaps"] += on_gaps
            for k, n in counts["modes"].items():
                launches["modes"][k] = launches["modes"].get(k, 0) + n
            if name == "div5m":
                split = " ".join(f"{k}={v:.6f}" for k, v in
                                 sorted(spans.totals.items()))
                rest = wall - sum(spans.totals.values())
                print(f"  div5m auto wall split (s): {split} "
                      f"rest={rest:.6f} wall={wall:.6f} card={card}",
                      flush=True)
    return {"launches": launches, "ts": ts, "qs": qs,
            "div5m": fixture("div5m")}


def _time_pair(smoke, label, spec, args, segs, card):
    """Kernel and plain version once each at one dispatch shape (CUDA
    events); returns (kernel outputs, timing dict)."""
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    got, ms = _ms(lambda: wk.wavefront(spec, *args, segs))
    want, plain_ms = _ms(lambda: wk.wavefront_plain(spec, *args, segs))
    err = max(_max_err(g, w) for g, w in zip(got, want))
    smoke.err["wavefront"] = max(smoke.err["wavefront"], err)
    del want
    mode = wk.launch_mode(spec, segs)
    bound_ms, bound_by = _k1_bound(spec, args, segs, got)
    print(f"  wavefront[{mode}] {label} B={len(args[0])} W={spec.W} "
          f"S_CAP={spec.S_CAP}: kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"bound_ms={bound_ms:.6f} ({bound_by}) card={card}", flush=True)
    smoke.check(err == 0, f"K1 {label} {mode}: max_abs_err={err}")
    return got, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by)


def _time_walk(smoke, label, tb, meta, tw, qw, cpw, pens, card):
    """W1 and walk_plain once each on one traceback (CUDA events)."""
    from miniwfa_tpu_torch.ops import traceback_device as tbd
    k_runs, ms = _ms(lambda: tbd.walk(tb, meta, tw, qw, cpw, pens))
    p_runs, plain_ms = _ms(lambda: tbd.walk_plain(tb, meta, tw, qw, cpw,
                                                  pens))
    err = max(_max_err(a, b) for a, b in zip(k_runs, p_runs))
    smoke.err["walk"] = max(smoke.err["walk"], err)
    bound_ms, bound_by = _walk_bound(tbd.to_cigars(*k_runs), tw, qw, meta,
                                     cpw)
    print(f"  walk {label} B={tb.shape[0]} S_CAP={tb.shape[1]} "
          f"W={tb.shape[2]}: kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"bound_ms={bound_ms:.6f} ({bound_by}) card={card}", flush=True)
    smoke.check(err == 0, f"W1 {label}: max_abs_err={err}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def kernel_times(smoke: Smoke, card: str, ts, qs) -> dict:
    """Phase 5: every K1 mode and W1 against their plain versions at the
    main path's first dispatch shape of that mode."""
    import numpy as np
    import torch
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.models import exact
    from miniwfa_tpu_torch.models import traceback as tbk
    from miniwfa_tpu_torch.ops import traceback_device as tbd
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk

    print("phase 5: kernel vs plain timings at the main path's dispatch "
          "shapes", flush=True)
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
        label = "cigar main" if opt.cigar else "score main"
        got, times[wk.launch_mode(spec, None)] = _time_pair(
            smoke, label, spec, args, None, card)
        if not opt.cigar:
            continue
        meta = torch.from_numpy(
            exact.walk_meta(lanes, got[0].cpu().numpy())).to(dev)
        times["walk"] = _time_walk(smoke, "main", got[1], meta, args[1],
                                   args[2], spec.cpw,
                                   (opt.x, opt.o1, opt.e1, opt.o2, opt.e2),
                                   card)
        del got

    # low-mem: pass 1 at its first dispatch's shape, then pass 2 with the
    # checkpoints that pass 1 decoded
    opt = Options(cigar=True, step=STEP_MAIN)
    bk, _ = exact.first_bucket(opt, wk.MODE_PASS1, ts, qs, 512, 512, dev)
    spec, lanes, args = inputs(opt, wk.MODE_PASS1, bk)
    got, times["PASS1"] = _time_pair(smoke, "lowmem pass 1 main", spec,
                                     args, None, card)
    o = got[0].cpu().numpy()
    ovf = (o[:, wk.O_OVFB] | o[:, wk.O_OVFS]) != 0
    smoke.check(not ovf.any(), f"K1 lowmem pass 1 main: every lane finished "
                f"in its first dispatch ({int(ovf.sum())} overflowed)")
    cnt = np.where(ovf, 0, o[:, wk.O_SNC])
    fin, recs = tbd.chain_ptrs(
        got[3], torch.from_numpy(np.where(ovf, -1, o[:, wk.O_LP])),
        torch.from_numpy(cnt))
    del got
    segs = [tbk.decode_checkpoints_ptrs(recs[:, j], int(fin[j]),
                                        int(lanes[j, wk.L_ANC]),
                                        int(cnt[j]), spec)
            for j in range(len(ts))]
    bk, _ = exact.pass2_bucket(opt, [int(v) for v in o[:, wk.O_S]], ts, qs,
                               512, 512, dev)
    spec, lanes, args = inputs(opt, wk.MODE_TB, bk)
    sg = torch.from_numpy(exact.seg_input(segs)).to(dev)
    got, times["TB+seg"] = _time_pair(smoke, "lowmem pass 2 main", spec,
                                      args, sg, card)
    del got
    return times


def gaps_times(smoke: Smoke, card: str, t: bytes, q: bytes) -> dict:
    """Phase 5, gaps: K3 SCORE and TB, and W1 on K3's traceback, against
    their plain versions at div5m auto's first K3 dispatch (its chain
    plan's gaps ordered by score bound, the first GMAX of them)."""
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
    print(f"phase 5, gaps: div5m's chain plan holds {len(gaps)} gaps of at "
          f"most 127 bp; first dispatch G={len(sel)} S_CAP={s_cap} "
          f"cpw={cpw}", flush=True)
    times = {}
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
    # gaps.cu's shared memory is dynamic, so ptxas does not report it: per
    # gap (warp), the rings plus both sides' words at cpw 4 (mwf_gaps)
    from miniwfa_tpu_torch.ops import pack
    from miniwfa_tpu_torch.ops import wavefront_gaps as wg
    dh, de1, de2 = wg.GSpec(S_CAP=64, x=4, o1=4, e1=2, o2=15, e2=1).rings
    smem = 4 * ((dh + 2 * de1 + 2 * de2) * wg.WIN
                + 2 * pack.n_words(wg.MAX_TOT, 4))
    print(f"  gaps: dynamic shared memory {smem} bytes per gap at the "
          f"default penalties, 4 gaps a block")

    smoke = Smoke(torch.device("cuda", 0))
    t0 = time.perf_counter()
    kernel_phases(smoke)
    t1 = time.perf_counter()
    info = main_path(smoke, card)
    t2 = time.perf_counter()
    times = kernel_times(smoke, card, info["ts"], info["qs"])
    gtimes = gaps_times(smoke, card, *info["div5m"])
    print(f"phase seconds: kernels {t1 - t0:.1f}, main path {t2 - t1:.1f}, "
          f"timings {time.perf_counter() - t2:.1f}", flush=True)
    launches = info["launches"]

    def timed(t):
        return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    modes = {m: {"launches": launches["modes"].get(m, 0), **timed(times[m])}
             for m in ("SCORE", "TB", "PASS1", "TB+seg")}
    kernels = [
        {"name": "wavefront", "route": "cuda",
         "source": "miniwfa_tpu_torch/csrc/wavefront.cu",
         "replaces": "miniwfa_tpu/ops/wavefront_kernel.py:226",
         "launches": launches["wavefront"],
         "max_abs_err": smoke.err["wavefront"], **timed(times["SCORE"]),
         "library_ms": None, "modes": modes},
        {"name": "walk", "route": "cuda",
         "source": "miniwfa_tpu_torch/csrc/walk.cu",
         "replaces": "miniwfa_tpu/ops/traceback_device.py:33",
         "launches": launches["walk"], "max_abs_err": smoke.err["walk"],
         **timed(times["walk"]), "library_ms": None,
         "on_gaps": {"launches": launches["walk_on_gaps"],
                     **timed(gtimes["walk"])}},
        {"name": "gaps", "route": "cuda",
         "source": "miniwfa_tpu_torch/csrc/gaps.cu",
         "replaces": "miniwfa_tpu/ops/wavefront_gaps.py:90",
         "launches": launches["gaps"], "max_abs_err": smoke.err["gaps"],
         **timed(gtimes["TB"]), "library_ms": None,
         "modes": {m: timed(gtimes[m]) for m in ("SCORE", "TB")}}]
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
