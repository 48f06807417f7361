#!/usr/bin/env python3
"""Kernel times of two checkouts on one card, in turns (a, b, b, a): K1
(csrc/wavefront.cu) in SCORE, TB, PASS1 and TB+seg at the main path's
first dispatch shapes (the 16 pairs of 100 kb of each checkout's
``chip_smoke.py``, low-mem step 5000; TB+seg with the checkpoints that
pass 1 decoded, at pass 2's first shape), the walker W1 on TB's
traceback (``walk``) and the checkpoint chain W2 on PASS1's snapshots
(``chain_ptrs``, called with host pointers as the low-mem driver calls
it, its copies included), three CUDA-event timings each after a warm-up
call.  Each turn is a process of its own, started in that checkout,
that builds its kernels.

    python3 -m miniwfa_tpu_torch.tools.k1_ab CHECKOUT_A CHECKOUT_B \
        [--paths] [--wide] [--multi] [--gaps]

With ``--paths`` each turn also runs ``chip_smoke.py``'s wide low-mem
fixtures (step 5000: dissim150k, nbear1m, sv300k, div5m) and div5m in auto
mode once each, with CUDA events around every W1 call: W1's kernel ms in
each low-mem run (its pass 2), the run's wall, and div5m auto's
"W1 with host CIGAR lists" span (``W1``) with its kernel ms.

With ``--wide`` each turn also runs ``chip_smoke.py``'s phase-4d wide
runs (score on dissim150k, nbear1m and sv300k; ``-p 5000`` on those and
div5m) through ``align_batch``, with CUDA events around every call of
the wide kernel K2 (``wavefront_wide.wide``, each call of
``run_chunked``): per run its wall, pass 1's wall, K2's calls, kernel
ms, cycles and µs a cycle, its score, and (where the checkout has them)
the variant, n and k and the tiled launches' stats summed over the run
(``wavefront_wide.STATS``: batches, reruns, and block 0's tiles and
clock64 cycles by phase).

With ``--multi`` each turn also times the multi-lane engine K4
(``wavefront_multi``) in SCORE and TB on ``chip_smoke.py``'s 2048 pairs
of 1 kb (the chain's K1 gap fills, W and S_CAP of their first bucket) at
G = 2, 4 and 8, and K1 at C = 1 beside them, each with its µs a cycle
(kernel ms over the lanes' largest score) and the device time of each
kernel of one call (``device_us``, torch.profiler), at the chooser's
variant (with each launch's variant and lanes per block, in a checkout
that has K4's variants) and at the "global" one (``wavefront_kernel.launch``
at G, the only K4 of a checkout without them).  Then ``bench_cuda.py`` at
``MWF_BENCH_N=1000 MWF_BENCH_B=2048 MWF_BENCH_BIG_N=0``, with and without
``MWF_ENGINE=multi``: each run's batch wall and ``checks.route_parity``.

With ``--gaps`` each turn also times K3 (``wavefront_gaps.gaps``) in
SCORE and TB at div5m auto's first gaps dispatch (``chip_smoke.py``'s
``chain_gaps`` of div5m, ordered by score bound, the first GMAX), with
the device time of each kernel of one call (``device_us``): the call's
CUDA events also hold the host's work between its launches.

Prints one JSON line per turn: the checkout, its times in ms by kernel
and mode, and by mode the CTAs per lane K1 ran at with the card's count
of co-resident clusters there (``clusters``; empty for a checkout that
launches one block per lane).
"""

import json
import os
import subprocess
import sys

# Prepended to every child: the kernels built before any timing, the
# card, and the timers.
PRELUDE = r"""
import json
import torch
from miniwfa_tpu_torch.ops import build

build.build()   # no nvcc inside the first run's CUDA events
dev = torch.device("cuda", 0)


def ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


# device time (µs) of each kernel, copy and fill of one call of fn, by
# torch.profiler (CUPTI), summed by name
def device_us(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0)
        if us:
            out[e.key[:72]] = round(us, 3)
    return out
"""

CHILD = r"""
from chip_smoke import B_MAIN, N_MAIN, STEP_MAIN, make_pairs
from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.models import traceback as tbk
from miniwfa_tpu_torch.ops import traceback_device as tbd
from miniwfa_tpu_torch.ops import wavefront_kernel as wk

pairs = make_pairs(N_MAIN, B_MAIN)
ts, qs = [t.encode() for t, _ in pairs], [q.encode() for _, q in pairs]
res = {}


def timed(name, spec, args, segs=None):
    out = wk.wavefront(spec, *args, segs)
    res[name] = [ms(lambda: wk.wavefront(spec, *args, segs))
                 for _ in range(3)]
    return out


def inputs(opt, mode, bk):
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, bk.W, bk.S_CAP,
                                              ts, qs)
    return spec, lanes, [torch.from_numpy(a).to(dev)
                         for a in (lanes, tw, qw)]


for name, opt, mode in (("SCORE", Options(), wk.MODE_SCORE),
                        ("TB", Options(cigar=True), wk.MODE_TB),
                        ("PASS1", Options(cigar=True, step=STEP_MAIN),
                         wk.MODE_PASS1)):
    bk, _ = exact.first_bucket(opt, mode, ts, qs, 512, 512, dev)
    spec, lanes, args = inputs(opt, mode, bk)
    out = timed(name, spec, args)
    if name == "TB":
        meta = torch.from_numpy(
            exact.walk_meta(lanes, out[0].cpu().numpy())).to(dev)
        pens = (opt.x, opt.o1, opt.e1, opt.o2, opt.e2)

        def walk():
            return tbd.walk(out[1], meta, args[1], args[2], spec.cpw, pens)

        walk()
        res["walk"] = [ms(walk) for _ in range(3)]
# pass 2 with the checkpoints that the last pass 1 decoded
o = out[0].cpu().numpy()
lp, cnt = (torch.from_numpy(o[:, c].copy()) for c in (wk.O_LP, wk.O_SNC))


def chain():
    return tbd.chain_ptrs(out[3], lp, cnt)


fin, recs = chain()
res["chain_ptrs"] = [ms(chain) for _ in range(3)]
segs = [tbk.decode_checkpoints_ptrs(recs[:, j], int(fin[j]),
                                    int(lanes[j, wk.L_ANC]),
                                    int(o[j, wk.O_SNC]), spec)
        for j in range(len(ts))]
del out
bk, _ = exact.pass2_bucket(opt, [int(v) for v in o[:, wk.O_S]], ts, qs,
                           512, 512, dev)
spec, _, args = inputs(opt, wk.MODE_TB, bk)
timed("TB+seg", spec, args,
      torch.from_numpy(exact.seg_input(segs)).to(dev))
res["clusters"] = getattr(wk.wavefront, "clusters", {})
print(json.dumps(res))
"""

PATHS = r"""
import time
from chip_smoke import STEP_MAIN, gen_case
from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.models.auto import align_auto_batch
from miniwfa_tpu_torch.ops import traceback_device as tbd
from miniwfa_tpu_torch.utils.spans import Spans

real = tbd.walk
events = []


def timed(*args, **kw):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = real(*args, **kw)
    end.record()
    events.append((start, end))
    return out


timed.__dict__ = real.__dict__
tbd.walk = timed


def run(fn, pair, opt, **kw):
    events.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn([pair], opt, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "w1_calls": len(events),
            "w1_kernel_ms": sum(a.elapsed_time(b) for a, b in events)}


res = {}
for name in ("dissim150k", "nbear1m", "sv300k", "div5m"):
    t, q = (x.encode() for x in gen_case(name))
    res[f"{name} lowmem_p5000"] = run(exact.align_batch, (t, q),
                                      Options(cigar=True, step=STEP_MAIN))
spans = Spans()
res["div5m auto"] = run(align_auto_batch, (t, q), Options(cigar=True),
                        spans=spans)
res["div5m auto"]["W1_span_s"] = spans.totals.get("W1")
print(json.dumps(res))
"""


WIDE = r"""
import time
from chip_smoke import STEP_MAIN, WIDE_RUNS, gen_case
from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.ops import wavefront_wide as ww

real, real_p1 = ww.wide, exact._run_pass1
calls, p1 = [], []


def timed(spec, lanes, tw, qw, state, t_lim):
    t_before = state.row[:, ww.ST_T].clone()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = real(spec, lanes, tw, qw, state, t_lim)
    end.record()
    stats = getattr(real, "last_stats", {}).get(lanes.device.index)
    calls.append((start, end, int((state.row[:, ww.ST_T] - t_before).sum()),
                  None if stats is None else stats.clone()))
    return out


def timed_pass1(*a, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = real_p1(*a, **kw)
    torch.cuda.synchronize()
    p1.append(time.perf_counter() - t0)
    return r


timed.__dict__ = real.__dict__
ww.wide, exact._run_pass1 = timed, timed_pass1
res = {}
for run, names in WIDE_RUNS:
    opt = Options(cigar=True, step=STEP_MAIN) if run != "score" else Options()
    for name in names:
        pair = tuple(x.encode() for x in gen_case(name))
        calls.clear()
        p1.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = exact.align_batch([pair], opt, device="cuda")[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernel_ms = sum(a.elapsed_time(b) for a, b, _, _ in calls)
        cycles = sum(c for _, _, c, _ in calls)
        stats = [s.tolist() for _, _, _, s in calls if s is not None]
        res[f"{name} {run}"] = {
            "s": r.s, "wall_s": wall, "pass1_s": sum(p1),
            "wide_calls": len(calls), "wide_kernel_ms": kernel_ms,
            "wide_cycles": cycles,
            "us_per_cycle": 1e3 * kernel_ms / max(cycles, 1),
            "tiles": dict(getattr(real, "tiles", {})),
            "stats": (dict(zip(ww.STATS, map(sum, zip(*stats))))
                      if stats else None)}
print(json.dumps(res))
"""


MULTI = r"""
from chip_smoke import FILL_B, FILL_N, make_pairs
from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.ops import wavefront_kernel as wk
from miniwfa_tpu_torch.ops import wavefront_multi as wm

pairs = make_pairs(FILL_N, FILL_B)
ts, qs = [t.encode() for t, _ in pairs], [q.encode() for _, q in pairs]
# each launch's variant, in a checkout that has K4's variants
variants = getattr(wm.wavefront_multi, "variants", None)
res = {}
for name, opt, mode in (("SCORE", Options(), wk.MODE_SCORE),
                        ("TB", Options(cigar=True), wk.MODE_TB)):
    bk, _ = exact.first_bucket(opt, mode, ts, qs, 512, 512, dev)
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, bk.W, bk.S_CAP,
                                              ts, qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    runs = {"K1 C=1": lambda: wk.launch(spec, *args, None, C=1)}
    for G in (2, 4, 8):
        runs[f"K4 G={G}"] = (lambda G=G: wm.wavefront_multi(spec, G, *args))
        runs[f"K4 G={G} global"] = (lambda G=G: wk.launch(spec, *args, None,
                                                          G))
    for key, fn in runs.items():
        out = fn()[0]
        s_max = int(out[:, wk.O_S].max())
        times = [ms(fn) for _ in range(3)]
        row = {"ms": times, "max_s": s_max,
               "us_per_cycle": 1e3 * min(times) / max(s_max, 1),
               "cells": int(out[:, wk.O_NITER].sum()),
               "device_us": device_us(fn)}
        if variants is not None and key.startswith("K4") \
                and not key.endswith("global"):
            row.update(variants[0][name])
        res[f"{name} {key} W={spec.W} S_CAP={spec.S_CAP}"] = row
print(json.dumps(res))
"""

GAPS = r"""
from chip_smoke import chain_gaps, gen_case
from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import tiny
from miniwfa_tpu_torch.ops import pack
from miniwfa_tpu_torch.ops import wavefront_gaps as wg

t, q = (x.encode() for x in gen_case("div5m"))
gaps = chain_gaps([t], [q], Options())
cpw = 16 if all(pack.can_pack2(p) for p in gaps) else 4
sb = [tiny._s_bound(Options(), len(a), len(b)) for a, b in gaps]
sel = sorted(range(len(gaps)), key=lambda g: sb[g])[:tiny.GMAX]
s_cap = tiny._scap_bucket(max(sb[g] for g in sel))
res = {}
for name, opt in (("SCORE", Options()), ("TB", Options(cigar=True))):
    spec, lens, tw, qw = tiny.dispatch_inputs(
        opt, [gaps[g][0] for g in sel], [gaps[g][1] for g in sel], cpw,
        s_cap)
    args = [torch.from_numpy(a).to(dev) for a in (lens, tw, qw)]
    out = wg.gaps(spec, *args)[0]
    res[f"gaps {name} G={len(sel)} S_CAP={s_cap}"] = {
        "ms": [ms(lambda: wg.gaps(spec, *args)) for _ in range(3)],
        "cells": int(out[:, wg.GO_NI].sum()),
        "device_us": device_us(lambda: wg.gaps(spec, *args))}
print(json.dumps(res))
"""


def bench_k4_route(root: str) -> dict:
    """``bench_cuda.py``'s K4 route in checkout ``root``: 2048 pairs of 1
    kb, with and without ``MWF_ENGINE=multi``; each run's batch wall and
    route parity."""
    res = {}
    env = {k: v for k, v in os.environ.items()
           if k not in ("MWF_ENGINE", "MWF_KERNEL_G")}
    env.update(MWF_BENCH_N="1000", MWF_BENCH_B="2048", MWF_BENCH_BIG_N="0")
    for name, extra in (("bench K1 route", {}),
                        ("bench K4 route", {"MWF_ENGINE": "multi"})):
        p = subprocess.run([sys.executable, "bench_cuda.py"], cwd=root,
                           env={**env, **extra}, capture_output=True,
                           text=True)
        line = json.loads(p.stdout.strip().splitlines()[-1])
        d = line["detail"]
        res[name] = {"exit": p.returncode, "batch_wall_s": d["batch_wall_s"],
                     "cells_per_s": line["value"],
                     "route_parity": d["checks"].get("route_parity"),
                     "device": d["device"]}
    return res


def main() -> int:
    a, b = sys.argv[1:3]
    flags = sys.argv[3:]
    children = ([CHILD] + ([PATHS] if "--paths" in flags else [])
                + ([WIDE] if "--wide" in flags else [])
                + ([MULTI] if "--multi" in flags else [])
                + ([GAPS] if "--gaps" in flags else []))
    for root in (a, b, b, a):
        times = bench_k4_route(root) if "--multi" in flags else {}
        for child in children:
            # ``python -c`` puts its working directory first on sys.path,
            # so the child imports that checkout's package and
            # chip_smoke.py
            out = subprocess.run([sys.executable, "-c", PRELUDE + child],
                                 cwd=root,
                                 capture_output=True, text=True, check=True)
            times.update(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps({"checkout": root, **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
