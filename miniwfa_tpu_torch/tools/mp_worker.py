"""One rank of a multi-process sharded alignment job (gloo).

    python -m miniwfa_tpu_torch.tools.mp_worker ADDR:PORT NPROC RANK
        [--device DEV] [--entries E] [--pairs P] [--fail-rank R]
        [--multicard SET [--reps R]]

Run from the root of the repository, one process per rank.  Each rank
joins the job (``parallel/distributed.py``), adds E entries (default 2)
of ``DEV`` (default ``cuda``, the current card; the tests pass ``cpu``)
to the global mesh and runs ``align_batch_sharded`` on the first P
(default 12) small golden cases in score, CIGAR and low-mem (step 16)
mode.  It checks that every pair's score equals the goldens and that (s,
n_iter) equal this rank's own ``align_batch``, and that CIGARs come back
for the lanes of this rank's blocks, equal to the goldens, and are None
elsewhere; then prints ``MP_OK pid=<rank>``.  With ``--fail-rank R``,
rank R's ``align_batch`` raises instead: every rank must then raise the
same error, without a hang.

With ``--multicard SET`` (``bench``: the main path's 16 pairs of 100 kb;
``goldens``: a few small golden cases) the rank is one of
``tools/multicard_smoke.py`` phase b: one entry of ``DEV`` a rank, one
copy of SET's pairs a rank, every mode held to the goldens and to this
rank's own one-card ``align_batch``, R timed runs each
(``multicard_smoke.drive``), the seconds of each ``_all_gather`` call
timed around it; prints its numbers as one ``MC_RANK`` JSON line, then
``MP_OK pid=<rank>``, and exits 1 if a check failed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from .. import Options
from ..models import exact
from ..parallel import batch, distributed
from ..parallel.batch import align_batch_sharded, lane_blocks

GOLDENS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "data", "goldens.json")


def _check(cond, *what) -> None:
    if not cond:
        raise AssertionError(what)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coordinator")
    ap.add_argument("nproc", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--entries", type=int, default=2)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--fail-rank", type=int, default=None)
    ap.add_argument("--multicard", choices=("bench", "goldens"),
                    default=None)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    dev = torch.device(a.device)
    if dev.type == "cuda" and dev.index is not None:
        # this rank's card is its current one: nothing of it lands on cuda:0
        torch.cuda.set_device(dev)
    distributed.init(a.coordinator, a.nproc, a.rank)
    if a.multicard:
        return multicard(a)
    mesh = distributed.global_mesh(devices=[a.device] * a.entries)
    _check(mesh.size == a.entries * a.nproc, mesh)
    mine = {j for (rank, _), block in zip(mesh.entries,
                                           lane_blocks(a.pairs, mesh.size))
            if rank == a.rank for j in block}

    with open(GOLDENS) as f:
        g = json.load(f)
    cases = [(i, c) for i, c in enumerate(g["cases"])
             if max(len(c["t"]), len(c["q"])) <= 256][:a.pairs]
    _check(len(cases) == a.pairs, "golden cases", len(cases))
    pairs = [(c["t"], c["q"]) for _, c in cases]
    pen = g["penalties"]

    if a.fail_rank is not None:
        if a.rank == a.fail_rank:
            def fail(*_, **__):
                raise RuntimeError(f"injected failure on rank {a.rank}")
            exact.align_batch = fail
        align_batch_sharded(pairs, Options(**pen), mesh)
        raise AssertionError("a rank's failure did not raise")

    for run, opt in (("score", Options(**pen)),
                     ("cigar", Options(**pen, cigar=True)),
                     ("lowmem_p16", Options(**pen, cigar=True, step=16))):
        res = align_batch_sharded(pairs, opt, mesh)
        own = exact.align_batch(pairs, opt, device=a.device)
        exp = g["runs"][run]
        for j, ((i, c), r, o) in enumerate(zip(cases, res, own)):
            _check((r.s, r.n_iter) == (o.s, o.n_iter) and r.s == exp[i]["s"],
                   a.rank, run, c["name"], r.s, r.n_iter, o.s, o.n_iter)
            if opt.cigar and j in mine:
                _check(r.cigar_str == exp[i]["cigar"] == o.cigar_str,
                       a.rank, run, c["name"], r.cigar_str)
            else:
                _check(r.cigar is None, a.rank, run, c["name"], "cigar")
    print(f"MP_OK pid={a.rank} local_cigars={len(mine)}", flush=True)
    dist.destroy_process_group()
    return 0


def multicard(a) -> int:
    """One rank of ``tools/multicard_smoke.py`` phase b (module
    docstring)."""
    from . import multicard_smoke as mc
    smoke = mc.Smoke()
    mesh = distributed.global_mesh(devices=[a.device])
    _check(mesh.size == a.nproc, mesh)
    pset = mc.load_set(a.multicard)
    n = len(pset.pairs) * mesh.size
    mine = {j for (rank, _), block in zip(mesh.entries,
                                           lane_blocks(n, mesh.size))
            if rank == a.rank for j in block}
    gather = []
    real = batch._all_gather

    def timed_gather(t):
        t0 = time.perf_counter()
        out = real(t)
        gather.append(time.perf_counter() - t0)
        return out

    batch._all_gather = timed_gather
    dev = mesh.entries[a.rank][1]
    cards = [dev.index] if dev.type == "cuda" else []
    t0 = time.perf_counter()
    modes = mc.drive(smoke, f"rank {a.rank}", mesh, pset, dev, cards,
                     a.reps, mine=mine, gather=gather)
    print("MC_RANK " + json.dumps({
        "rank": a.rank, "device": str(dev), "lanes": sorted(mine),
        "seconds": time.perf_counter() - t0, "modes": modes,
        "failures": smoke.failures}), flush=True)
    dist.destroy_process_group()
    if smoke.failures:
        return 1
    print(f"MP_OK pid={a.rank} local_cigars={len(mine)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
