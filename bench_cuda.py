#!/usr/bin/env python3
"""Self-validating throughput benchmark of miniwfa_tpu_torch on one card.

The port of ``bench.py`` (which stays the JAX package's): the same rows,
knobs and JSON line, with ``align_batch`` of ``miniwfa_tpu_torch``.

    python bench_cuda.py                    # on the card (cuda)
    MWF_BENCH_N=8000 MWF_BENCH_B=1 MWF_BENCH_REPS=1 MWF_BENCH_BIG_N=0 \\
        python bench_cuda.py --device cpu   # the plain versions, CPU

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.

Headline metric: wavefront cells/s (Σ n_iter per second of host wall
around ``align_batch``, synchronised with the card before each timer
starts and after it stops) in exact score mode, on ``MWF_BENCH_B`` pairs
(16) of ``MWF_BENCH_N`` bp (100 kb) at 2% substitutions and 0.2% indels
(``tools/pairs.make_pairs``, seed 7).  ``vs_baseline`` divides it by
2.3e8 cells/s, the single-core C reference (lh3/miniwfa) on the same
workload (BASELINE.md): a CPU number, not a TPU one.

Rows, as ``bench.py``'s: score (a warm-up, which builds the kernels on a
cold build cache and is timed apart as ``warmup_s``, then
``MWF_BENCH_REPS`` timed runs), with every score held against
tests/data/bench_goldens.json; where that file has the length, CIGAR
(score and ``cigar_md5`` parity) and low-mem at step 5000 (equal to the
CIGAR row, pair by pair), each a warm-up and one timed run; and score on
2 pairs of ``MWF_BENCH_BIG_N`` bp (200 kb, seed 13; 0 turns the row off).
Where the file lacks the length (``MWF_BENCH_N=1000``, say), the score
row's ``s`` and ``n_iter`` of every pair are held instead against one
untimed run of the other route of K1's batches: K4 (``MWF_ENGINE=multi``)
when the run takes the default route, K1 when it takes K4
(``detail.parity_against`` names it; ``checks.route_parity``).
``parity`` is the AND of the checks that ran, null if none ran; unless
it is true the run exits 1.
``detail.peak_hbm`` is the peak-memory meter's report over the whole run
(``miniwfa_tpu_torch/utils/hbm.py``: the largest dispatch's footprint and
the allocator's peak on the card), ``detail.device`` the card's name and
power limit by nvidia-smi (null on the CPU).  With no card and no
``--device cpu`` the run fails: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models.exact import align_batch, check_device
from miniwfa_tpu_torch.tools.pairs import make_pairs
from miniwfa_tpu_torch.utils import hbm

BASELINE_CELLS_PER_S = 2.3e8  # single-core C reference (BASELINE.md)
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "data", "bench_goldens.json")


def card_info(device: torch.device) -> Optional[dict]:
    """The card's name and power limit as nvidia-smi gives them; None on
    the CPU."""
    if device.type != "cuda":
        return None
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[device.index or 0]
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


@contextlib.contextmanager
def engine(value: Optional[str]):
    """``MWF_ENGINE`` set to ``value`` (None: unset) for the block."""
    old = os.environ.pop("MWF_ENGINE", None)
    if value is not None:
        os.environ["MWF_ENGINE"] = value
    try:
        yield
    finally:
        os.environ.pop("MWF_ENGINE", None)
        if old is not None:
            os.environ["MWF_ENGINE"] = old


def run(n: int, b: int, reps: int, big_n: int, device="cuda",
        goldens: Optional[dict] = None) -> dict:
    """The benchmark's rows on ``device``; returns the JSON line's object.
    ``goldens`` is bench_goldens.json's content (rows by str(n))."""
    device = check_device(device)
    gold = (goldens or {}).get(str(n), [])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(pairs, opt, w0, s0, times=1):
        """``times`` runs, synchronised; (the last results, mean wall)."""
        sync()
        t0 = time.perf_counter()
        for _ in range(times):
            res = align_batch(pairs, opt, w0=w0, s0=s0, device=device)
        sync()
        return res, (time.perf_counter() - t0) / times

    hbm.reset()
    pairs = make_pairs(n, b)
    opt = Options()  # score-only exact mode: the fundamental hot path
    w0 = s0 = max(1024, n // 4)  # start near the terminal bucket
    checks = {}
    against = "bench_goldens.json" if gold else None

    res, warmup_s = timed(pairs, opt, w0, s0)  # builds the kernels if cold
    if gold:
        checks["score_parity"] = all(r.s == g["s"] for r, g in zip(res, gold))
    else:
        checks["score_parity"] = None
    res, dt = timed(pairs, opt, w0, s0, reps)
    if not gold:
        # no goldens at this length: every pair's (s, n_iter) against the
        # other route of K1's batches, K1 against K4, in this run
        other = None if os.environ.get("MWF_ENGINE") == "multi" else "multi"
        with engine(other):
            ores = align_batch(pairs, opt, w0=w0, s0=s0, device=device)
        checks["route_parity"] = [(r.s, r.n_iter) for r in res] == \
            [(r.s, r.n_iter) for r in ores]
        against = "MWF_ENGINE=multi" if other else "MWF_ENGINE unset"
    total_cells = sum(r.n_iter for r in res)
    cells_per_s = total_cells / dt
    bp = sum(min(len(t), len(q)) for t, q in pairs)

    # CIGAR row over the full batch: score parity on every pair, digest
    # parity where the C oracle recorded one
    tb_cells = tb_dt = None
    cres = None
    if gold:
        copt = Options(cigar=True)
        timed(pairs, copt, w0, s0)
        cres, tb_dt = timed(pairs, copt, w0, s0)
        tb_cells = sum(r.n_iter for r in cres)
        ok = all(r.s == g["s"] for r, g in zip(cres, gold))
        for r, g in zip(cres, gold):
            if "cigar_md5" in g:
                md5 = hashlib.md5(r.cigar_str.encode()).hexdigest()
                ok &= md5 == g["cigar_md5"]
        checks["cigar_parity"] = ok

    # low-mem row (reference -cp5000) over the full batch: every pair
    # must reproduce the high-mem CIGAR bit for bit
    lm_cells = lm_dt = None
    if gold and cres is not None:
        lopt = Options(cigar=True, step=5000)
        timed(pairs, lopt, w0, s0)
        lres, lm_dt = timed(pairs, lopt, w0, s0)
        lm_cells = sum(r.n_iter for r in lres)
        ok = all(lr.s == cr.s and lr.cigar_str == cr.cigar_str
                 for lr, cr in zip(lres, cres))
        checks["lowmem_parity"] = ok

    # scale row: the same workload shape at 2x the pair length
    big_cells = None
    if big_n:
        bpairs = make_pairs(big_n, 2, seed=13)
        timed(bpairs, opt, big_n // 4, big_n // 4)
        bres, bdt = timed(bpairs, opt, big_n // 4, big_n // 4)
        big_cells = round(sum(r.n_iter for r in bres) / bdt)

    ran = [ok for ok in checks.values() if ok is not None]
    parity = all(ran) if ran else None
    return {
        "metric": "wavefront_cells_per_s_1chip",
        "value": round(cells_per_s),
        "unit": "cells/s",
        "vs_baseline": round(cells_per_s / BASELINE_CELLS_PER_S, 3),
        "detail": {
            "pairs": b, "pair_bp": n, "reps": reps,
            "batch_wall_s": round(dt, 4),
            "warmup_s": round(warmup_s, 4),
            "total_cells": total_cells,
            "aligned_bp_per_s": round(bp / dt),
            "cigar_cells_per_s": round(tb_cells / tb_dt) if tb_dt else None,
            "lowmem_cells_per_s": round(lm_cells / lm_dt) if lm_dt else None,
            "score_cells_per_s_at_2x_bp": big_cells,
            "parity": parity,
            "parity_against": against,
            "checks": checks,
            # km_stat analog: the largest single-dispatch device buffer
            # footprint seen across every row above
            "peak_hbm": hbm.snapshot(),
            "device": card_info(device),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="One-line JSON throughput benchmark of "
                    "miniwfa_tpu_torch (knobs: MWF_BENCH_N, MWF_BENCH_B, "
                    "MWF_BENCH_REPS, MWF_BENCH_BIG_N).")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on [cuda]; cpu runs the "
                         "kernels' plain versions")
    args = ap.parse_args(argv)
    n = int(os.environ.get("MWF_BENCH_N", 100_000))
    # B=16 is the deployment shape: batched pair streams amortise the
    # per-dispatch fixed costs (sizing, packing, copies, decode)
    b = int(os.environ.get("MWF_BENCH_B", 16))
    reps = int(os.environ.get("MWF_BENCH_REPS", 3))
    big_n = int(os.environ.get("MWF_BENCH_BIG_N", 200_000))
    goldens = {}
    if os.path.exists(GOLDENS):
        with open(GOLDENS) as f:
            goldens = json.load(f)
    out = run(n, b, reps, big_n, args.device, goldens)
    print(json.dumps(out))
    return 0 if out["detail"]["parity"] is True else 1


if __name__ == "__main__":
    sys.exit(main())
