"""Data-parallel scaling benchmark of the sharded aligner.

The port of ``tools/scaling_bench.py``: cells/s of
``parallel.batch.align_batch_sharded`` at mesh sizes 1, 2, 4, ... up to
the visible cards, ``pairs_per_device`` pairs of ``pair_bp`` bp
(``tools/pairs.mk_pairs``, seed 0) an entry, exact score mode, and the
scaling efficiency against linear scaling from the first size.  Each size
runs once to warm up and once timed, synchronised with every card before
the timer starts and after it stops.

    python -m miniwfa_tpu_torch.tools.scaling_bench [pair_bp] \
        [pairs_per_device] [--device cpu]

The defaults, 4 pairs of 2 kb an entry, are the JAX tool's: a few
milliseconds of wall, mostly host dispatch, so they check the path and
measure nothing.  The measurement is the main path's shape on every card,
``scaling_bench 100000 16`` (16 pairs of 100 kb a card, seconds of card
work per size).

``--device cpu`` takes 8 CPU entries, as the JAX tool takes 8 virtual CPU
devices: they merge into one ``align_batch`` call, so the lines check the
path, not a speed.  Entries of one card merge the same way, so a mesh
only ever spans distinct cards; with fewer cards than a size, that size
is not measured and the tool says so.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..models.exact import check_device
from ..options import Options
from ..parallel.batch import align_batch_sharded
from ..parallel.mesh import make_mesh
from .pairs import mk_pairs

SIZES = (1, 2, 4, 8, 16, 32)


def _sync(mesh) -> None:
    """Wait for every card of ``mesh``."""
    for dev in {dev for _, dev in mesh.entries if dev.type == "cuda"}:
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pair_bp", type=int, nargs="?", default=2000)
    ap.add_argument("pairs_per_device", type=int, nargs="?", default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="every visible card [cuda], or 8 CPU entries")
    args = ap.parse_args(argv)
    check_device(args.device)
    if args.device == "cpu":
        devs = ["cpu"] * 8
        name = "cpu"
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        name = torch.cuda.get_device_name(0)
    sizes = [d for d in SIZES if d <= len(devs)]
    opt = Options()
    base = None
    print(f"devices: {len(devs)} x {name}", flush=True)
    for nd in sizes:
        mesh = make_mesh(devs[:nd])
        pairs = mk_pairs(args.pairs_per_device * nd, args.pair_bp)
        align_batch_sharded(pairs, opt, mesh)  # warm-up, builds if cold
        _sync(mesh)
        t0 = time.perf_counter()
        res = align_batch_sharded(pairs, opt, mesh)
        _sync(mesh)
        dt = time.perf_counter() - t0
        cells = sum(r.n_iter for r in res)
        cps = cells / dt
        if base is None:
            base = cps
        eff = cps / (base * nd) * 100
        print(f"mesh={nd:2d}  pairs={len(pairs):3d}  wall={dt:7.3f}s  "
              f"cells/s={cps:12.3e}  scaling_eff={eff:6.1f}%", flush=True)
    rest = [d for d in SIZES if d > len(devs)]
    if args.device == "cuda" and rest:
        print(f"mesh sizes {', '.join(map(str, rest))}: not measured "
              f"(they need as many cards; {len(devs)} visible)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
