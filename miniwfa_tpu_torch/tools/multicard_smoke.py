#!/usr/bin/env python3
"""Multi-card check of the port's sharded path: ``align_batch_sharded``
over N distinct cards, in one process and as N gloo ranks.

    python -m miniwfa_tpu_torch.tools.multicard_smoke [--cards N]
        [--device cuda|cpu] [--set bench|goldens] [--phases abcd]
        [--reps R] [--json PATH]

Run from the root of the repository.  Setup: with no card, or fewer
visible cards than ``--cards`` (default 4), it refuses to run (exit 2)
and runs nothing; else it prints each card's name and power limit
(``nvidia-smi``) and builds the kernels.  Then each phase prints
``ok``/``FAIL`` lines with its walls:

a. one process, N cards: ``make_mesh([cuda:0 ... cuda:N-1])`` over N
   copies of the set's pairs (``bench``: the 16 pairs of 100 kb of
   ``tools/pairs.make_pairs``), copy k on card k (``lane_blocks``), in
   score, CIGAR and low-mem mode (step 5000; 16 on ``goldens``).  Every
   lane's s and CIGAR md5 equal the goldens, every lane's (s, n_iter,
   CIGAR) equals a one-card ``align_batch`` of the same pairs on cuda:0,
   bit for bit (``bench_goldens.json`` holds no n_iter), every card
   launched K1, and W1 in CIGAR mode, W1 and W2 in low-mem mode (counted
   by card, ``utils/launches.py``), and the meter's peak dispatch lies
   above 0 and at most at the allocator's peak.  Prints the walls of R
   runs (default 3), one-card and sharded, and each card's own ``align_batch``
   wall (``align_batch_sharded.card_walls``); one ``torch.profiler``
   trace of the CIGAR run, one card's and the N cards', gives each card's
   busy share (the union of its kernel, copy and set intervals over the
   wall).
b. N gloo ranks, one card each: N processes of ``python -m
   miniwfa_tpu_torch.tools.mp_worker ADDR N RANK --device cuda:RANK
   --multicard SET`` (spawned, never forked), each holding the lanes to
   the same checks (CIGARs on its own lanes) against its own one-card
   run, and printing its walls, its all-gather seconds and its card's
   busy share in the CIGAR run (``MC_RANK`` JSON line).
c. the wide route on N cards at once: score mode on dissim150k, nbear1m,
   sv300k and nbear1m again (the first N), one a card, each card running
   K2, each s equal to scale_goldens.json.
d. scaling: ``python -m miniwfa_tpu_torch.tools.scaling_bench 100000
   16`` (mesh sizes 1, 2, 4, ... up to the visible cards), its lines.

Exits 0 only when every check passed; the last line is one JSON object
with ``ok``, the card count and the failed checks, and ``--json`` writes
every phase's numbers to PATH.  ``--device cpu``
runs phases a, b and d on N CPU entries (they merge into one call, the
plain versions run, no launch to count, no trace) for the tests, with
``--set goldens``, the small golden cases; phase c needs cards.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import Options
from ..models import exact
from ..ops import traceback_device as tbd
from ..ops import wavefront_kernel as wk
from ..ops import wavefront_wide as ww
from ..parallel import batch
from ..parallel.batch import align_batch_sharded
from ..parallel.mesh import make_mesh
from ..utils import hbm
from .pairs import make_pairs, scale_case

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "tests", "data")
N_BENCH, B_BENCH, STEP_BENCH = 100_000, 16, 5000
GOLDEN_PAIRS, STEP_GOLDEN = 4, 16
# phase c's fixtures, one a card, score mode
WIDE_RUNS = ("dissim150k", "nbear1m", "sv300k", "nbear1m")
RANK_TIMEOUT = 900
SCALING_TIMEOUT = 900


class Smoke:
    """The checks' record: each check prints one ok/FAIL line."""

    def __init__(self):
        self.failures: List[str] = []

    def check(self, cond: bool, what: str) -> None:
        print(f"  {'ok  ' if cond else 'FAIL'} {what}", flush=True)
        if not cond:
            self.failures.append(what)


@dataclass
class PairSet:
    """Pairs and, by mode, the options and each pair's golden (s, CIGAR
    md5 or None)."""

    name: str
    pairs: List[Tuple[bytes, bytes]]
    modes: List[Tuple[str, Options, List[Tuple[int, Optional[str]]]]]


def _md5(s: str) -> str:
    return hashlib.md5(s.encode()).hexdigest()


def load_set(name: str) -> PairSet:
    """``bench``: the main path's 16 pairs of 100 kb against
    bench_goldens.json; ``goldens``: the first GOLDEN_PAIRS golden cases
    of at most 256 bp against goldens.json."""
    if name == "bench":
        with open(os.path.join(DATA, "bench_goldens.json")) as f:
            gold = json.load(f)[str(N_BENCH)]
        pairs = [(t.encode(), q.encode())
                 for t, q in make_pairs(N_BENCH, B_BENCH)]
        score = [(g["s"], None) for g in gold]
        cig = [(g["s"], g["cigar_md5"]) for g in gold]
        return PairSet(name, pairs, [
            ("score", Options(), score), ("cigar", Options(cigar=True), cig),
            ("lowmem", Options(cigar=True, step=STEP_BENCH), cig)])
    if name != "goldens":
        raise ValueError(f"unknown pair set {name!r}")
    with open(os.path.join(DATA, "goldens.json")) as f:
        g = json.load(f)
    cases = [(i, c) for i, c in enumerate(g["cases"])
             if max(len(c["t"]), len(c["q"])) <= 256][:GOLDEN_PAIRS]
    pen = g["penalties"]

    def want(run):
        return [(g["runs"][run][i]["s"], None if g["runs"][run][i]["cigar"]
                 is None else _md5(g["runs"][run][i]["cigar"]))
                for i, _ in cases]

    return PairSet(name, [(c["t"].encode(), c["q"].encode())
                          for _, c in cases], [
        ("score", Options(**pen), want("score")),
        ("cigar", Options(**pen, cigar=True), want("cigar")),
        ("lowmem", Options(**pen, cigar=True, step=STEP_GOLDEN),
         want("lowmem_p16"))])


def _row(r) -> tuple:
    return r.s, r.n_iter, r.cigar_str


def _few(lanes: Sequence[int]) -> str:
    return "" if not lanes else f" (failing lanes {list(lanes)[:8]})"


def check_lanes(smoke: Smoke, label: str, res, single, want,
                mine=None) -> None:
    """``res``: the sharded results of copies of the pairs, lane j the
    pair j % P; ``single``: a one-card ``align_batch`` of the P pairs;
    ``want``: each pair's golden (s, md5 or None); ``mine``: the lanes
    whose CIGARs this process ran (None: every lane), the others' must
    be None.  Every lane's s and md5 against the goldens, and its (s,
    n_iter, CIGAR) against the one-card run's."""
    P = len(single)
    bad_s, bad_md5, bad_one = [], [], []
    for j, r in enumerate(res):
        s, md5 = want[j % P]
        o = single[j % P]
        own = mine is None or j in mine
        if r.s != s:
            bad_s.append(j)
        if md5 is not None and own and (r.cigar is None
                                        or _md5(r.cigar_str) != md5):
            bad_md5.append(j)
        if _row(r) != (o.s, o.n_iter, o.cigar_str if own else None):
            bad_one.append(j)
    smoke.check(len(res) % P == 0 and len(res) > 0,
                f"{label}: {len(res)} lanes, {len(res) // P} copies of "
                f"{P} pairs")
    smoke.check(not bad_s, f"{label}: every lane's s equals the goldens"
                + _few(bad_s))
    if any(md5 is not None for _, md5 in want):
        n = len(res) if mine is None else len(mine)
        smoke.check(not bad_md5, f"{label}: {n} CIGAR md5s equal the "
                    f"goldens" + _few(bad_md5))
    smoke.check(not bad_one, f"{label}: every lane's (s, n_iter, CIGAR) "
                f"equals a one-card align_batch, bit for bit"
                + ("" if mine is None else " (CIGARs None off this "
                   "process's lanes)") + _few(bad_one))


# the wrappers whose launches the checks count by card
COUNTED = {"K1": wk.wavefront, "W1": tbd.walk, "W2": tbd.chain_ptrs,
           "K2": ww.wide}


def reset_card_counts() -> None:
    for fn in COUNTED.values():
        fn.launches_by_card.clear()


def card_counts() -> Dict[str, Dict[int, int]]:
    return {k: dict(fn.launches_by_card) for k, fn in COUNTED.items()
            if fn.launches_by_card}


def check_launches(smoke: Smoke, label: str, cards: Sequence[int],
                   kernels: Sequence[str]) -> None:
    """Each kernel of ``kernels`` launched on every card of ``cards``."""
    counts = card_counts()
    for k in kernels:
        got = counts.get(k, {})
        missing = [c for c in cards if not got.get(c)]
        smoke.check(not missing, f"{label}: {k} launched on every card "
                    f"{sorted(cards)}, by card {got}"
                    + (f"; none on {missing}" if missing else ""))


def kernels_of(opt: Options) -> Tuple[str, ...]:
    """The kernels a main-path run in ``opt``'s mode launches."""
    if opt.cigar and opt.step:
        return ("K1", "W1", "W2")
    return ("K1", "W1") if opt.cigar else ("K1",)


def _union_s(spans) -> float:
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6


def busy_by_card(prof) -> Dict[int, float]:
    """Each card's busy seconds in a ``torch.profiler`` trace: the union of
    its device events' intervals (kernels, copies, sets)."""
    from torch.autograd import DeviceType
    spans: Dict[int, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    return {d: _union_s(v) for d, v in sorted(spans.items())}


def traced(fn, cards: Sequence[int]) -> Tuple[float, dict]:
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activities, as
    ``wfabench/trace.py``); returns (the synchronised wall, {card: (busy
    seconds, busy share)})."""
    from torch.profiler import ProfilerActivity, profile
    sync(cards)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(cards)
        wall = time.perf_counter() - t0
    busy = busy_by_card(prof)
    return wall, {c: (busy.get(c, 0.0), busy.get(c, 0.0) / wall)
                       for c in cards}


def sync(cards: Sequence[int]) -> None:
    for c in cards:
        torch.cuda.synchronize(c)


def drive(smoke: Smoke, label: str, mesh, pset: PairSet, single_dev,
          cards: Sequence[int], reps: int, mine=None, gather=None) -> dict:
    """Phase a's body, and each rank's in phase b: every mode of ``pset``
    through ``align_batch_sharded`` on ``mesh`` (copies of the pairs, one
    a mesh entry) and through ``align_batch`` on ``single_dev``, ``reps``
    times each after a warm-up; checks as the module docstring says, the
    launches and the meter on ``cards`` (the cards this process runs;
    none on the CPU).  ``gather``: a list the all-gather's timer appends
    its seconds to (phase b).  Returns each mode's walls, per-card walls,
    all-gather seconds and, in CIGAR mode on cards, busy shares."""
    pairs = pset.pairs * mesh.size
    out = {}
    for mode, opt, want in pset.modes:
        tag = f"{label} {mode}"
        align_batch_sharded(pairs, opt, mesh)           # warm-up
        exact.align_batch(pset.pairs, opt, device=single_dev)
        one, shard, card_walls, gathers, runs = [], [], [], [], []
        single = None
        for rep in range(reps):
            sync(cards)
            t0 = time.perf_counter()
            res1 = exact.align_batch(pset.pairs, opt, device=single_dev)
            sync(cards)
            one.append(time.perf_counter() - t0)
            single = single or res1
            if rep == 0:
                reset_card_counts()
                hbm.reset()
            if gather is not None:
                gather.clear()
            sync(cards)
            t0 = time.perf_counter()
            res = align_batch_sharded(pairs, opt, mesh)
            sync(cards)
            shard.append(time.perf_counter() - t0)
            card_walls.append(_walls())
            if gather is not None:
                gathers.append(sum(gather))
            if rep == 0 and cards:
                check_launches(smoke, tag, cards, kernels_of(opt))
                meter, mtag = hbm.peak()
                peak = hbm.device_peak() or 0
                smoke.check(0 < meter <= peak, f"{tag}: the meter's peak "
                            f"dispatch {meter} bytes ('{mtag}') is above 0 "
                            f"and at most the allocator's peak {peak}")
            runs.append([_row(r) for r in res])
            if rep == 0:
                check_lanes(smoke, tag, res, single, want, mine)
        smoke.check(all(r == runs[0] for r in runs[1:]),
                    f"{tag}: the {reps} sharded runs are equal, bit for bit")
        cells = sum(r[1] for r in runs[0])
        m1, mn = statistics.median(one), statistics.median(shard)
        rec = {"one_card_s": one, "sharded_s": shard, "card_walls_s":
               card_walls, "cells": cells, "cells_per_s": cells / mn,
               "one_card_cells_per_s": cells / mesh.size / m1}
        print(f"  {tag}: wall_s one-card {_fmt(one)} (median {m1:.6f}) "
              f"sharded over {mesh.size} entries {_fmt(shard)} (median "
              f"{mn:.6f}); cells/s one-card {rec['one_card_cells_per_s']:.6e}"
              f" sharded {rec['cells_per_s']:.6e}; each card's align_batch "
              f"wall_s " + "; ".join(_fmt_walls(w) for w in card_walls),
              flush=True)
        if gather is not None:
            rec["gather_s"] = gathers
            shares = [g / w for g, w in zip(gathers, shard)]
            print(f"  {tag}: all-gather s {_fmt(gathers)}, share of the "
                  f"sharded wall {_fmt(shares)}", flush=True)
        if cards and mode == "cigar":
            w1, b1 = traced(lambda: exact.align_batch(
                pset.pairs, opt, device=single_dev), cards)
            wn, bn = traced(lambda: align_batch_sharded(pairs, opt, mesh),
                            cards)
            one_dev = torch.device(single_dev).index or 0
            rec["busy_one_card"] = {"wall_s": w1, "card": one_dev,
                                    "busy_s": b1[one_dev][0],
                                    "share": b1[one_dev][1]}
            rec["busy_sharded"] = {"wall_s": wn, "by_card": {
                str(c): {"busy_s": b, "share": s} for c, (b, s) in
                bn.items()}}
            print(f"  {tag}: traced, busy share one-card (cuda:{one_dev}) "
                  f"{b1[one_dev][1]:.4f} of {w1:.6f} s; sharded "
                  + ", ".join(f"cuda:{c} {s:.4f}" for c, (_, s) in
                              bn.items())
                  + f" of {wn:.6f} s", flush=True)
        out[mode] = rec
    return out


def _fmt(xs) -> str:
    return "[" + ", ".join(f"{x:.6f}" for x in xs) + "]"


def _walls() -> Dict[str, float]:
    """The last sharded call's ``align_batch`` seconds by device."""
    return {str(d): w for d, w in
            sorted(batch.align_batch_sharded.card_walls.items(), key=str)}


def _fmt_walls(walls: dict) -> str:
    return " ".join(f"{d}={w:.6f}" for d, w in walls.items())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_a(smoke: Smoke, devs, cards, pset: PairSet, reps: int) -> dict:
    print(f"phase a: one process, {len(devs)} mesh entries "
          f"({', '.join(map(str, devs))}), {len(devs)} copies of "
          f"{len(pset.pairs)} pairs ({pset.name})", flush=True)
    return drive(smoke, "a", make_mesh(devs), pset, devs[0], cards, reps)


def phase_b(smoke: Smoke, n: int, device: str, pset: PairSet,
            reps: int) -> dict:
    print(f"phase b: {n} gloo ranks, one {device} entry each, "
          f"{len(pset.pairs)} pairs ({pset.name}) a rank", flush=True)
    addr = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "miniwfa_tpu_torch.tools.mp_worker", addr,
         str(n), str(rank), "--device",
         f"cuda:{rank}" if device == "cuda" else "cpu",
         "--multicard", pset.name, "--reps", str(reps)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(n)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                outs.append(f"no end within {RANK_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = {}
    for rank, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            if line.startswith("MC_RANK "):
                ranks[rank] = json.loads(line[len("MC_RANK "):])
            elif line.strip():
                print(f"  [rank {rank}] {line}", flush=True)
        ok = p.returncode == 0 and f"MP_OK pid={rank}" in text \
            and rank in ranks
        smoke.check(ok, f"gloo rank {rank} of {n}: exit {p.returncode}, "
                    f"MP_OK pid={rank} and its MC_RANK line printed"
                    + ("" if ok else f"; its output ends:\n{text[-3000:]}"))
    print(f"  phase b: {n} ranks in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return ranks


def phase_c(smoke: Smoke, devs, cards) -> dict:
    names = WIDE_RUNS[:len(devs)]
    print(f"phase c: the wide route, score mode, {', '.join(names)} on "
          f"{len(devs)} cards at once, one a card", flush=True)
    with open(os.path.join(DATA, "scale_goldens.json")) as f:
        sgold = json.load(f)
    made = {}
    for name in names:
        if name not in made:
            made[name] = tuple(x.encode() for x in scale_case(name))
    pairs = [made[name] for name in names]
    mesh = make_mesh(devs)
    walls = []
    for rep in range(2):
        reset_card_counts()
        sync(cards)
        t0 = time.perf_counter()
        res = align_batch_sharded(pairs, Options(), mesh)
        sync(cards)
        walls.append(time.perf_counter() - t0)
        for j, (name, r) in enumerate(zip(names, res)):
            want = sgold[name]["score"]["s"]
            smoke.check(r.s == want, f"c run {rep}: {name} on {devs[j]}: "
                        f"s={r.s} n_iter={r.n_iter}, scale_goldens.json "
                        f"{want}")
        check_launches(smoke, f"c run {rep}", cards, ("K2",))
        print(f"  c run {rep}: wall_s {walls[-1]:.6f}, each card's "
              f"align_batch wall_s "
              + _fmt_walls(_walls()), flush=True)
    return {"names": list(names), "walls_s": walls}


def phase_d(smoke: Smoke, device: str) -> List[str]:
    args = ["100000", "16"] if device == "cuda" else ["500", "1",
                                                       "--device", "cpu"]
    print(f"phase d: scaling_bench {' '.join(args)}", flush=True)
    p = subprocess.run([sys.executable, "-m",
                        "miniwfa_tpu_torch.tools.scaling_bench", *args],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=SCALING_TIMEOUT)
    lines = p.stdout.strip().splitlines()
    for line in lines:
        print(f"  {line}", flush=True)
    meshes = [line for line in lines if line.startswith("mesh=")]
    smoke.check(p.returncode == 0 and meshes, f"scaling_bench: exit "
                f"{p.returncode}, {len(meshes)} mesh sizes"
                + ("" if p.returncode == 0 else f"; errors:\n"
                   f"{p.stderr[-2000:]}"))
    return meshes


def refuse(cards: int, device: str) -> Optional[str]:
    """Why the run cannot take place on this machine, or None: no card, or
    fewer visible cards than asked (no run on fewer cards)."""
    if cards < 1:
        return f"--cards must be at least 1, got {cards}"
    if device == "cpu":
        return None
    if not torch.cuda.is_available():
        return "no CUDA device (torch.cuda.is_available() is false)"
    n = torch.cuda.device_count()
    if n < cards:
        return f"{cards} cards asked for, {n} visible"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--set", choices=("bench", "goldens"), default="bench",
                    dest="pair_set")
    ap.add_argument("--phases", default="abcd")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed runs of each mode, one-card and sharded")
    ap.add_argument("--json", default=None,
                    help="write every phase's numbers to this file")
    a = ap.parse_args(argv)
    why = refuse(a.cards, a.device)
    if why is None and a.reps < 1:
        why = f"--reps must be at least 1, got {a.reps}"
    if why is None and not set(a.phases) <= set("abcd"):
        why = f"--phases takes letters of 'abcd', got {a.phases!r}"
    if why is None and a.device == "cpu" and "c" in a.phases:
        why = "phase c (the wide route at Mb scale) needs cards"
    if why:
        print(f"multicard_smoke: {why}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    if a.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        for line in smi[:a.cards]:
            print(line, flush=True)
        devs = [torch.device("cuda", i) for i in range(a.cards)]
        cards = list(range(a.cards))
        name = torch.cuda.get_device_name(0)
        from ..ops import build
        t0 = time.perf_counter()
        build.build()
        print(f"setup: {a.cards} of {torch.cuda.device_count()} visible "
              f"cards, torch {torch.__version__} cuda {torch.version.cuda}; "
              f"kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)
    else:
        devs, cards, name = ["cpu"] * a.cards, [], "cpu"
    smoke = Smoke()
    pset = load_set(a.pair_set)
    report = {"cards": a.cards, "kind": name, "set": a.pair_set}
    phases = {"a": lambda: phase_a(smoke, devs, cards, pset, a.reps),
              "b": lambda: phase_b(smoke, a.cards, a.device, pset, a.reps),
              "c": lambda: phase_c(smoke, devs, cards),
              "d": lambda: phase_d(smoke, a.device)}
    for ph in "abcd":
        if ph in a.phases:
            t0 = time.perf_counter()
            report[ph] = phases[ph]()
            print(f"phase {ph}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(report, f, indent=1)
    print(f"multicard_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(json.dumps({"ok": not smoke.failures, "cards": a.cards,
                      "kind": name, "failures": smoke.failures}))
    return 0 if not smoke.failures else 1


if __name__ == "__main__":
    sys.exit(main())
