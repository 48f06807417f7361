#!/usr/bin/env python3
"""K1 (csrc/wavefront.cu) kernel times of two checkouts on one card, in
turns (a, b, b, a): SCORE, TB, PASS1 and TB+seg at the main path's first
dispatch shapes (the 16 pairs of 100 kb of each checkout's
``chip_smoke.py``, low-mem step 5000; TB+seg with the checkpoints that
pass 1 decoded, at pass 2's first shape), three CUDA-event timings each
after a warm-up launch.  Each turn is a process of its own, started in
that checkout, that builds its kernel.

    python3 -m miniwfa_tpu_torch.tools.k1_ab CHECKOUT_A CHECKOUT_B

Prints one JSON line per turn: the checkout, its times in ms by mode, and
by mode the CTAs per lane K1 ran at with the card's count of co-resident
clusters there (``clusters``; empty for a checkout that launches one
block per lane).
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
from miniwfa_tpu_torch.models import traceback as tbk
from miniwfa_tpu_torch.ops import traceback_device as tbd
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
# pass 2 with the checkpoints that the last pass 1 decoded
o = out[0].cpu().numpy()
fin, recs = tbd.chain_ptrs(out[3], out[0][:, wk.O_LP], out[0][:, wk.O_SNC])
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
