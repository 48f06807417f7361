#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place with one guarantee of the
configuration broken, and judged as a run is.

The configuration states exact dual-affine scoring (two gap pieces,
o1+L*e1 and o2+L*e2).  The control drops the second piece (single
affine, o2=o1 and e2=e1: three states a cycle instead of five, the step
a faster kernel would be tempted by).  Its answers for the cell's pool
at the cell's size are compared with the reference's by the harness's
``compare``; the control has to come out not correct.

    python3 wfabench/control.py --workload pairs100k-score \
        --seeds 11,12,13

Prints one JSON line a seed: the numbers compared, each beside its
limit, and ``correct`` (which has to be false).  Runs on the first
card the cell asks for, as a run's reference does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from wfabench import gen, harness  # noqa: E402
from wfabench.reference import wfa  # noqa: E402


def control_pens(cfg: dict) -> wfa.Pens:
    """The configuration's penalties with the second gap piece dropped."""
    p = wfa.Pens(**cfg["penalties"])
    return dataclasses.replace(p, o2=p.o1, e2=p.e1)


def run(name: str, seed: int, devices, cfg_override=None,
        traffic_override=None) -> dict:
    """One seed: the control's checks against the reference."""
    _, cell, cfg, traffic = harness.load_cell(name)
    cfg = {**cfg, **(cfg_override or {})}
    traffic = {**traffic, **(traffic_override or {})}
    n = int(traffic["pairs_per_call"])
    pairs = gen.make_pool(cfg, n, seed)
    t0 = time.perf_counter()
    got = harness.reference(pairs, cfg, traffic, devices[0],
                            pens=control_pens(cfg))
    answers = harness.reference(pairs, cfg, traffic, devices[0])
    checks = harness.compare(got, [[harness.digest(r) for r in got]],
                             answers, n)
    correct = all(checks[k] <= harness.LIMITS[k] for k in checks)
    return {"workload": name, "seed": seed, "correct": correct,
            "seconds": time.perf_counter() - t0,
            "checks": {k: {"value": checks[k], "limit": harness.LIMITS[k]}
                       for k in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    _, cell, _, _ = harness.load_cell(args.workload)
    chips = int(cell["chips"])
    if torch.cuda.device_count() < chips:
        print(f"control: the cell needs {chips} cards", file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(chips)]
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(run(args.workload, seed, devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
