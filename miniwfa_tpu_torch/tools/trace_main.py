#!/usr/bin/env python3
"""One ``torch.profiler`` trace of the main path per checkout, on one card:
``align_batch`` on the 16 pairs of 100 kb of each checkout's
``chip_smoke.py`` in score, CIGAR and low-mem (step 5000) mode, each mode
run once to warm up (kernel builds, caches) and once traced.  Each
checkout runs in a process of its own, started in that checkout.

    python3 -m miniwfa_tpu_torch.tools.trace_main CHECKOUT [CHECKOUT ...]

Prints one JSON line per checkout and mode: the traced run's host wall
(synchronised), the card's busy time (the union of its kernel, copy and
set intervals) and busy share of the wall, the device time of the
wavefront kernel K1 (``wavefront_kernel``), of the walker W1 (``walk``),
of the checkpoint chain W2 (``chain_kernel``) and of everything else on
the card, and the host rest (wall minus busy).
A trace with no device event prints ``busy_s: null`` ("not measured").
"""

import json
import subprocess
import sys

CHILD = r"""
import json
import time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from chip_smoke import B_MAIN, N_MAIN, STEP_MAIN, make_pairs
from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import exact

pairs = [(t.encode(), q.encode()) for t, q in make_pairs(N_MAIN, B_MAIN)]
for mode, opt in (("score", Options()), ("cigar", Options(cigar=True)),
                  ("lowmem", Options(cigar=True, step=STEP_MAIN))):
    exact.align_batch(pairs, opt, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exact.align_batch(pairs, opt, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by = [], {"K1": 0.0, "W1": 0.0, "W2": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        # W2's kernel lives in csrc/walk.cu, whose name a mangled symbol
        # may carry: test for it before W1's
        key = ("K1" if "wavefront_kernel" in e.name else
               "W2" if "chain_kernel" in e.name else
               "W1" if "walk" in e.name else "other")
        by[key] += (b - a) / 1e6
    busy = 0.0
    end = None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy_s = busy / 1e6 if spans else None
    print(json.dumps({
        "mode": mode, "wall_s": wall, "busy_s": busy_s,
        "busy_share": busy_s / wall if spans else None,
        "device_s": by if spans else None,
        "host_rest_s": wall - busy_s if spans else None,
        "device_events": len(spans)}), flush=True)
"""


def main() -> int:
    for root in sys.argv[1:]:
        # ``python -c`` puts its working directory first on sys.path, so
        # the child imports that checkout's package and chip_smoke.py
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                             capture_output=True, text=True, check=True)
        for line in out.stdout.strip().splitlines():
            if line.startswith("{"):
                print(json.dumps({"checkout": root, **json.loads(line)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
