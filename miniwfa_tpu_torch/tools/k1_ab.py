#!/usr/bin/env python3
"""K1 (csrc/wavefront.cu) kernel times of two checkouts on one card, in
turns (a, b, b, a): SCORE, TB and PASS1 at the main path's first dispatch
shapes (the 16 pairs of 100 kb of each checkout's ``chip_smoke.py``,
low-mem step 5000), three CUDA-event timings each after a warm-up launch.
Each turn is a process of its own, started in that checkout, that builds
its kernel.

    python3 -m miniwfa_tpu_torch.tools.k1_ab CHECKOUT_A CHECKOUT_B

Prints one JSON line per turn: the checkout and its times in ms.
"""

import json
import subprocess
import sys

CHILD = r"""
import json
import torch
from chip_smoke import B_MAIN, N_MAIN, STEP_MAIN, make_pairs
from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.ops import wavefront_kernel as wk


def ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


dev = torch.device("cuda", 0)
pairs = make_pairs(N_MAIN, B_MAIN)
ts, qs = [t.encode() for t, _ in pairs], [q.encode() for _, q in pairs]
res = {}
for name, opt, mode in (("SCORE", Options(), wk.MODE_SCORE),
                        ("TB", Options(cigar=True), wk.MODE_TB),
                        ("PASS1", Options(cigar=True, step=STEP_MAIN),
                         wk.MODE_PASS1)):
    bk, _ = exact.first_bucket(opt, mode, ts, qs, 512, 512, dev)
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, bk.W, bk.S_CAP,
                                              ts, qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    wk.wavefront(spec, *args)
    res[name] = [ms(lambda: wk.wavefront(spec, *args)) for _ in range(3)]
print(json.dumps(res))
"""


def main() -> int:
    a, b = sys.argv[1:3]
    for root in (a, b, b, a):
        # ``python -c`` puts its working directory first on sys.path, so
        # the child imports that checkout's package and chip_smoke.py
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                             capture_output=True, text=True, check=True)
        times = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": root, **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
