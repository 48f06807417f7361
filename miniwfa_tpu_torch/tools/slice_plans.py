"""Time the planned one-CTA-or-many probes at forced plans: the dynamic
slices (P4c, P4d), the refill (P4e) and the one-shot gathers (P3, P6a,
P6b).

    python -m miniwfa_tpu_torch.tools.slice_plans [--probes P4d,P4c,P4e,P3]
        [--iters 0,200,100000] [--rows 1,32,1000] [--outputs 32,16384]
        [--plans auto,1x512] [--rounds N] [--json PATH]

Sizes: P4c at the tool's [1, 8192] and P4d at its [512, 128], at each
loop count of ``--iters``; P4e at the tool's [1, 8192] table with each
row count of ``--rows`` (32, the tool's, on its own inputs); P3 at the six
forms of ``tools/microbench_pallas2.py``, P6a and P6b at [4, 64, 128];
``P3n``: P3's kernel on n outputs of ``--outputs``, idx [n / 2048, 2048]
(or [1, n] below 2048) from a table of 2048 words a row, along it.
Plans are ``CTASxN`` (``SMS`` the card's SM count; ``auto``: the
chooser's): N is threads a CTA for the slices (``probes.slice_plan``) and
the gathers (``probes.once_plan``), warps a CTA for the refill
(``probes.refill_plan``); without ``--plans`` each probe takes its own
list.  For each, the kernel's µs a launch by ``probes.KernelTimer`` (the
median of ``microbench.REPS`` launches; with ``--rounds N``, the median
of N such readings, taken in N rounds over every plan of a size in turn)
and that less the launch floor (``microbench.launch_floor``) and the
dependent-load floor (``microbench.dep_floor``), each read at the start
of every round and taken at its median over the rounds of a size, each
launch's output held equal to the plain
version's (the slices up to ``CHECK_MAX`` iterations; the card tests hold
larger counts).  Inputs are the tools', from seed 0.  Prints the card's
name and power limit first; on the card only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from ..ops import probes as pb
from . import microbench as mb

CHECK_MAX = 4096  # loop counts up to which each slice launch is held equal
PLANS = {
    "P4c": "auto,1x512,2x512,4x512,8x512,32x512,SMSx512,SMSx256,SMSx128",
    "P4e": "auto,1x32,2x16,4x8,8x4,16x2,32x1,SMSx1",
    "P3": "auto,1x1024,4x256,8x128,8x512,16x64,16x256,32x32,32x64,32x128,"
          "64x64,64x128,128x32,SMSx32,SMSx64,SMSx128,SMSx256"}
PLANS.update(P4d=PLANS["P4c"], P6a=PLANS["P3"], P6b=PLANS["P3"],
             P3n="auto")


def plans(spec: str, auto, sms: int):
    """The plans of ``spec`` on a card of ``sms`` SMs, ``auto`` the
    chooser's."""
    out = []
    for p in spec.split(","):
        if p == "auto":
            out.append(auto)
        else:
            c, n = p.split("x")
            out.append((sms if c == "SMS" else int(c), int(n)))
    return out


def runs(pid: str, a, dev, sms: int):
    """(size label, launch(plan), plain output or None, the chooser's
    plan) of each size ``pid`` is timed at."""
    cases = {c.pid: c for c in mb.mosaic3_cases()}
    if pid in ("P4c", "P4d"):
        lane = pid == "P4c"
        launch = pb._lane_slice if lane else pb._sublane_slice
        plain = pb.lane_slice_plain if lane else pb.sublane_slice_plain
        for it in map(int, a.iters.split(",")):
            x, xt = mb.inputs(cases[pid], 0, it, dev)
            want = plain(*(torch.from_numpy(v) for v in x)) \
                if it <= CHECK_MAX else None
            yield (f"it={it}", lambda p, xt=xt: launch(xt[0], xt[1], p),
                   want, pb.slice_plan(it, sms))
    elif pid == "P4e":
        for WR in map(int, a.rows.split(",")):
            if WR == 32:
                x, _ = mb.inputs(cases[pid], 0, 1, "cpu")
            else:
                rng = np.random.default_rng(WR)
                x = (mb._ints(rng, (1, 8192), 1 << 20),
                     mb._ints(rng, (WR, 1), 8192 - 128))
            t = [torch.from_numpy(v) for v in x]
            xt = [v.to(dev) for v in t]
            yield (f"WR={WR}", lambda p, xt=xt: pb._refill(*xt, p),
                   pb.refill_plain(*t), pb.refill_plan(WR, sms))
    elif pid == "P3n":
        for n in map(int, a.outputs.split(",")):
            shape = (max(1, n // 2048), min(n, 2048))
            rng = np.random.default_rng(n)
            tab = torch.from_numpy(mb._ints(rng, (shape[0], 2048), 1 << 20))
            idx = torch.from_numpy(mb._ints(rng, shape, 2048))
            t2, i2 = tab.to(dev), idx.to(dev)
            yield (f"take_along n={n} {list(shape)}",
                   lambda p, t2=t2, i2=i2:
                   pb._gather2d(pb.take_along, t2, i2, 1, 1, False, plan=p),
                   pb.take_along_plain(tab, idx, 1),
                   pb.once_plan(*shape, sms))
    else:
        cs = (mb.pallas2_cases() if pid == "P3" else
              [c for c in mb.multi_probe_cases() if c.pid == pid])
        for c in cs:
            x, xt = mb.inputs(c, 0, 1, dev)
            ax = int(c.label[-1]) if pid == "P3" else 2
            t2, i2, a2 = pb._as_2d(*xt, ax)
            want = c.call(c.plain, "cpu",
                          [torch.from_numpy(v) for v in x], 1)
            yield (c.label if pid == "P3" else f"{c.label} {list(i2.shape)}",
                   lambda p, f=c.fn, t2=t2, i2=i2, a2=a2, s=xt[1].shape:
                   pb._gather2d(f, t2, i2, a2, 1, False, plan=p)
                   .reshape(s), want, pb.once_plan(*i2.shape, sms))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--probes", default="P4d,P4c,P4e,P3,P6a,P6b")
    ap.add_argument("--iters", default="0,1,16,64,200,1000,4096,100000")
    ap.add_argument("--rows", default="1,7,32,132,1000")
    ap.add_argument("--outputs", default="32,128,512,2048,4096,16384,"
                    "65536,262144")
    ap.add_argument("--plans", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--json", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slice_plans: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = mb.card_line()
    print(card, flush=True)
    recs, bad, floors = [], 0, []
    for pid in a.probes.split(","):
        for size, launch, want, auto in runs(pid, a, dev, sms):
            ps = plans(a.plans or PLANS[pid], auto, sms)
            times = {p: [] for p in ps}
            errs, fl = {}, []
            for _ in range(a.rounds):
                fl.append((mb.launch_floor(dev), mb.dep_floor(dev)))
                for plan in ps:
                    launch(plan)                      # warm (and build)
                    got, ms = mb.kernel_ms(lambda: launch(plan))
                    times[plan].append(ms)
                    if want is not None:
                        errs[plan] = max(errs.get(plan, 0),
                                         mb.max_abs_err(got.cpu(), want))
            floor = statistics.median(f for f, _ in fl)
            dep = statistics.median(d for _, d in fl)
            floors.append({"pid": pid, "size": size, "launch_floor_ms": floor,
                           "dep_floor_ms": dep})
            print(f"{pid} {size}: launch floor {floor * 1e3:.3f} us, "
                  f"dependent-load floor {dep * 1e3:.3f} us", flush=True)
            for plan in times:
                ms = statistics.median(times[plan])
                err = errs.get(plan)
                bad += bool(err)
                rec = {"pid": pid, "size": size, "plan": list(plan),
                       "auto": plan == auto, "us": ms * 1e3,
                       "rounds_us": [t * 1e3 for t in times[plan]],
                       "over_floor_us": (ms - floor) * 1e3,
                       "over_dep_floor_us": (ms - dep) * 1e3,
                       "max_abs_err": err}
                recs.append(rec)
                print(f"{pid} {size:36s} plan={plan[0]:5d}x{plan[1]:<4d}"
                      f"{'*' if rec['auto'] else ' '} {rec['us']:9.3f} us  "
                      f"over the floors {rec['over_floor_us']:8.3f} / "
                      f"{rec['over_dep_floor_us']:8.3f} us  "
                      f"max_abs_err={err}", flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"card": card, "floors": floors, "records": recs}, f,
                      indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
