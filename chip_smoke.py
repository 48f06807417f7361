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
   decoded checkpoints (every output and traceback byte);
3. holds the CIGAR walker (W1) against its plain version on phase 2's
   traceback output: identical run lists;
4. drives the main path, ``align_batch`` on 16 pairs of 100 kb at 2%
   divergence in score, CIGAR and low-mem (step 5000) modes, checks every
   score and CIGAR digest against tests/data/bench_goldens.json, that each
   CIGAR re-scores and consumes both sequences, and that each mode's
   kernels were launched (counts set to 0 just before each mode and read
   just after); then the scale fixture dissim150k (150 kb, a 12 kb
   unrelated insert) in low-mem mode against
   tests/data/scale_goldens.json;
5. times each kernel mode against its plain version (CUDA events) at the
   main path's first dispatch shape of that mode, where the two must again
   agree exactly: SCORE, TB and the walker on its traceback, PASS1, and TB
   with the checkpoints PASS1 decoded.

The tolerance of every comparison is exact equality: both versions run
the same integer algorithm.  Prints a ``kernels`` JSON line (the
wavefront entry's ``ms``/``plain_ms`` are SCORE's; its ``modes`` field
holds every mode's launches in the main path's runs and its phase-5
times) and, last, a JSON line with
``"ok": true`` and the device.  Exits non-zero without a
CUDA device, outside a checkout of the repository, or if any check fails.
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


def _mutate(rng, seq, sub, ind, max_indel=8):
    """Substitutions and short indels (tools/bench_kernel.py::mutate,
    restated here: that module needs JAX)."""
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


def dissim150k():
    """The scale fixture "dissim150k" (tools/make_scale_goldens.py::
    gen_case, restated without JAX): 150 kb with a 12 kb region of the
    query replaced by unrelated sequence, then 1.5% substitutions and
    0.1% indels."""
    import random
    rng = random.Random(1501)
    t = "".join(rng.choice("ACGT") for _ in range(150_000))
    novel = "".join(rng.choice("ACGT") for _ in range(12_000))
    q = t[:60_000] + novel + t[72_000:]
    return t, _mutate(rng, q, sub=0.015, ind=0.001)


def _reset_counts():
    from miniwfa_tpu_torch.ops import traceback_device as tbd
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    wk.wavefront.launches = 0
    wk.wavefront.launches_by_mode.clear()
    tbd.walk.launches = 0


def _read_counts() -> dict:
    from miniwfa_tpu_torch.ops import traceback_device as tbd
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    return {"wavefront": wk.wavefront.launches, "walk": tbd.walk.launches,
            "modes": dict(wk.wavefront.launches_by_mode)}


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
        self.err = {"wavefront": 0, "walk": 0}

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


def kernel_phases(smoke: Smoke) -> None:
    """Phases 2 and 3: both kernels against their plain versions."""
    import bench
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
    pairs = bench.make_pairs(8000, 64)[:8]
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


def _drive(label, pairs, opt, card):
    """One run of ``align_batch`` on the card with the launch counts set
    to 0 just before it and read just after; returns (results, counts)."""
    import torch
    from miniwfa_tpu_torch.models import exact
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = exact.align_batch(pairs, opt, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    cells = sum(r.n_iter for r in res)
    print(f"  {label}: wall_s={wall:.6f} cells={cells} "
          f"cells_per_s={cells / wall:.6e} peak_bytes={peak} "
          f"launches wavefront={counts['wavefront']} {counts['modes']} "
          f"walk={counts['walk']} card={card}", flush=True)
    return res, counts


def _check_cigars(smoke, label, ts, qs, res, md5s) -> None:
    from miniwfa_tpu_torch import Options, cigar as C
    ok_md5 = ok_cig = True
    for t, q, r, m in zip(ts, qs, res, md5s):
        ok_md5 &= hashlib.md5(r.cigar_str.encode()).hexdigest() == m
        try:
            C.assert_cigar(Options(), r.cigar, len(t), len(q), r.s, t, q)
        except AssertionError:
            ok_cig = False
    smoke.check(ok_md5, f"{label}: {len(res)} CIGAR md5s equal the goldens")
    smoke.check(ok_cig, f"{label}: every CIGAR passes assert_cigar")


def main_path(smoke: Smoke, card: str) -> dict:
    """Phase 4: the main path at full width in each mode, and the
    dissim150k scale fixture.  Returns per-kernel launches (summed over
    the main path's modes) and the main path's pairs."""
    import bench
    from miniwfa_tpu_torch import Options

    with open(os.path.join(ROOT, "tests", "data", "bench_goldens.json")) as f:
        gold = json.load(f)[str(N_MAIN)]
    pairs = bench.make_pairs(N_MAIN, B_MAIN)
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
        res, counts = _drive(mode, list(zip(ts, qs)), opt, card)
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
        sgold = json.load(f)["dissim150k"]["lowmem_p5000"]
    t, q = (x.encode() for x in dissim150k())
    res, counts = _drive("dissim150k", [(t, q)],
                         Options(cigar=True, step=STEP_MAIN), card)
    smoke.check(res[0].s == sgold["s"], f"dissim150k: s={res[0].s} equals "
                f"scale_goldens.json ({sgold['s']})")
    _check_cigars(smoke, "dissim150k", [t], [q], res, [sgold["cigar_md5"]])
    for k in ("PASS1", "TB+seg"):
        n = counts["modes"].get(k, 0)
        smoke.check(n > 0, f"dissim150k launched wavefront[{k}] {n} times")
    return {"launches": launches, "ts": ts, "qs": qs}


def _time_pair(smoke, label, spec, args, segs, card):
    """Kernel and plain version once each at one dispatch shape (CUDA
    events); returns (kernel outputs, kernel ms, plain ms)."""
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    got, ms = _ms(lambda: wk.wavefront(spec, *args, segs))
    want, plain_ms = _ms(lambda: wk.wavefront_plain(spec, *args, segs))
    err = max(_max_err(g, w) for g, w in zip(got, want))
    smoke.err["wavefront"] = max(smoke.err["wavefront"], err)
    del want
    mode = wk.launch_mode(spec, segs)
    print(f"  wavefront[{mode}] {label} B={len(args[0])} W={spec.W} "
          f"S_CAP={spec.S_CAP}: kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"card={card}", flush=True)
    smoke.check(err == 0, f"K1 {label} {mode}: max_abs_err={err}")
    return got, ms, plain_ms


def kernel_times(smoke: Smoke, card: str, ts, qs) -> dict:
    """Phase 5: every kernel mode against its plain version at the main
    path's first dispatch shape of that mode."""
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
        got, ms, plain_ms = _time_pair(smoke, label, spec, args, None, card)
        times[wk.launch_mode(spec, None)] = (ms, plain_ms)
        if not opt.cigar:
            continue
        _, tw, qw = args
        meta = torch.from_numpy(
            exact.walk_meta(lanes, got[0].cpu().numpy())).to(dev)
        pens = (opt.x, opt.o1, opt.e1, opt.o2, opt.e2)
        k_runs, ms = _ms(lambda: tbd.walk(got[1], meta, tw, qw, spec.cpw,
                                          pens))
        p_runs, plain_ms = _ms(lambda: tbd.walk_plain(got[1], meta, tw, qw,
                                                      spec.cpw, pens))
        err = max(_max_err(a, b) for a, b in zip(k_runs, p_runs))
        smoke.err["walk"] = max(smoke.err["walk"], err)
        times["walk"] = (ms, plain_ms)
        print(f"  walk main B={len(ts)} S_CAP={spec.S_CAP} W={spec.W}: "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} card={card}",
              flush=True)
        smoke.check(err == 0, f"W1 main: max_abs_err={err}")
        del got

    # low-mem: pass 1 at its first dispatch's shape, then pass 2 with the
    # checkpoints that pass 1 decoded
    opt = Options(cigar=True, step=STEP_MAIN)
    bk, _ = exact.first_bucket(opt, wk.MODE_PASS1, ts, qs, 512, 512, dev)
    spec, lanes, args = inputs(opt, wk.MODE_PASS1, bk)
    got, ms, plain_ms = _time_pair(smoke, "lowmem pass 1 main", spec, args,
                                   None, card)
    times["PASS1"] = (ms, plain_ms)
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
    got, ms, plain_ms = _time_pair(smoke, "lowmem pass 2 main", spec, args,
                                   sg, card)
    times["TB+seg"] = (ms, plain_ms)
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

    smoke = Smoke(torch.device("cuda", 0))
    t0 = time.perf_counter()
    kernel_phases(smoke)
    t1 = time.perf_counter()
    info = main_path(smoke, card)
    t2 = time.perf_counter()
    times = kernel_times(smoke, card, info["ts"], info["qs"])
    print(f"phase seconds: kernels {t1 - t0:.1f}, main path {t2 - t1:.1f}, "
          f"timings {time.perf_counter() - t2:.1f}", flush=True)
    launches = info["launches"]
    modes = {m: {"launches": launches["modes"].get(m, 0),
                 "ms": times[m][0], "plain_ms": times[m][1]}
             for m in ("SCORE", "TB", "PASS1", "TB+seg")}
    kernels = [
        {"name": "wavefront", "route": "cuda",
         "source": "miniwfa_tpu_torch/csrc/wavefront.cu",
         "replaces": "miniwfa_tpu/ops/wavefront_kernel.py:226",
         "launches": launches["wavefront"],
         "max_abs_err": smoke.err["wavefront"],
         "ms": times["SCORE"][0], "plain_ms": times["SCORE"][1],
         "modes": modes},
        {"name": "walk", "route": "cuda",
         "source": "miniwfa_tpu_torch/csrc/walk.cu",
         "replaces": "miniwfa_tpu/ops/traceback_device.py:33",
         "launches": launches["walk"], "max_abs_err": smoke.err["walk"],
         "ms": times["walk"][0], "plain_ms": times["walk"][1]}]
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
