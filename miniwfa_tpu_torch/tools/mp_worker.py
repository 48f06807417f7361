"""One rank of a multi-process sharded alignment job (gloo).

    python -m miniwfa_tpu_torch.tools.mp_worker ADDR:PORT NPROC RANK
        [--device DEV] [--fail-rank R]

Run from the root of the repository, one process per rank.  Each rank
joins the job (``parallel/distributed.py``), adds two entries of ``DEV``
(default ``cuda``, the current card; the tests pass ``cpu``) to the global mesh and runs ``align_batch_sharded`` on
the small golden cases in score, CIGAR and low-mem (step 16) mode.  It
checks that every pair's score equals the goldens and that (s, n_iter)
equal this rank's own ``align_batch``, and that CIGARs come back for the
lanes of this rank's blocks, equal to the goldens, and are None
elsewhere; then prints ``MP_OK pid=<rank>``.  With ``--fail-rank R``,
rank R's ``align_batch`` raises instead: every rank must then raise the
same error, without a hang.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from .. import Options
from ..models import exact
from ..parallel import distributed
from ..parallel.batch import align_batch_sharded, lane_blocks

GOLDENS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "data", "goldens.json")


def _check(cond, *what) -> None:
    if not cond:
        raise AssertionError(what)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coordinator")
    ap.add_argument("nproc", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fail-rank", type=int, default=None)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    distributed.init(a.coordinator, a.nproc, a.rank)
    mesh = distributed.global_mesh(devices=[a.device] * 2)
    _check(mesh.size == 2 * a.nproc, mesh)
    mine = {j for (rank, _), block in zip(mesh.entries,
                                           lane_blocks(12, mesh.size))
            if rank == a.rank for j in block}

    with open(GOLDENS) as f:
        g = json.load(f)
    cases = [(i, c) for i, c in enumerate(g["cases"])
             if max(len(c["t"]), len(c["q"])) <= 256][:12]
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


if __name__ == "__main__":
    main()
