"""Time the dynamic slices (P4c, P4d) at forced plans and loop counts.

    python -m miniwfa_tpu_torch.tools.slice_plans [--iters 0,200,100000]
        [--plans auto,1x512,SMSx512] [--json PATH]

For each probe (P4c at the tool's [1, 8192], P4d at its [512, 128]),
loop count and plan (``CTASxTHREADS``, ``SMS`` the card's SM count;
``auto``: ``probes.slice_plan``'s), the kernel's µs a launch by
``probes.KernelTimer`` (the median of ``microbench.REPS`` launches) and
that less the launch floor (``microbench.launch_floor``), each launch's
output held equal to the plain version's (up to ``CHECK_MAX`` iterations;
the card tests hold larger counts).  Inputs are the tool's, from seed 0.
Prints the card's name and power limit first; on the card only.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import probes as pb
from . import microbench as mb

CHECK_MAX = 4096  # loop counts up to which each launch is held equal


def plans(spec: str, iters: int, sms: int):
    """The plans of ``spec`` at ``iters`` on a card of ``sms`` SMs."""
    out = []
    for p in spec.split(","):
        if p == "auto":
            out.append(pb.slice_plan(iters, sms))
        else:
            c, t = p.split("x")
            out.append((sms if c == "SMS" else int(c), int(t)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", default="0,1,16,64,200,1000,4096,100000")
    ap.add_argument("--plans", default="auto,1x512,2x512,4x512,8x512,"
                    "32x512,SMSx512,SMSx256,SMSx128")
    ap.add_argument("--json", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slice_plans: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = mb.card_line()
    floor = mb.launch_floor(dev)
    print(card, flush=True)
    print(f"launch floor {floor * 1e3:.3f} us", flush=True)
    cases = {c.pid: c for c in mb.mosaic3_cases()}
    launch = {"P4c": pb._lane_slice, "P4d": pb._sublane_slice}
    plain = {"P4c": pb.lane_slice_plain, "P4d": pb.sublane_slice_plain}
    recs, bad = [], 0
    for pid in ("P4d", "P4c"):
        for it in map(int, a.iters.split(",")):
            x, xt = mb.inputs(cases[pid], 0, it, dev)
            want = plain[pid](*(torch.from_numpy(v) for v in x)) \
                if it <= CHECK_MAX else None
            for plan in plans(a.plans, it, sms):
                fn = lambda: launch[pid](xt[0], xt[1], plan)
                fn()                                  # warm (and build)
                got, ms = mb.kernel_ms(fn)
                err = None if want is None else \
                    mb.max_abs_err(got.cpu(), want)
                bad += bool(err)
                rec = {"pid": pid, "iters": it, "plan": list(plan),
                       "us": ms * 1e3, "over_floor_us": (ms - floor) * 1e3,
                       "max_abs_err": err}
                recs.append(rec)
                print(f"{pid} it={it:7d} plan={plan[0]:4d}x{plan[1]:<4d} "
                      f"{rec['us']:9.3f} us  over the floor "
                      f"{rec['over_floor_us']:8.3f} us  max_abs_err={err}",
                      flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"card": card, "launch_floor_ms": floor,
                       "records": recs}, f, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
