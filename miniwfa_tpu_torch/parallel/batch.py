"""Sharded batch alignment: a batch's lanes split over a device mesh.

The port of ``miniwfa_tpu/parallel/batch.py``, in all exact modes (score,
high-mem CIGAR and the two-pass low-mem stripe mode).  Lanes are cut into
even blocks, one per mesh entry (``lane_blocks``, the layout of JAX's
``NamedSharding(mesh, P("data"))``).  Each process runs
``models/exact.py::align_batch`` once for each device it owns, over the
union of that device's blocks, one thread per device.  Entries that name
the same device are merged into one call: K1 sizes its grid by the card's
co-resident clusters and K2 is a cooperative grid over the whole card, so
two launches must not share a card at once; and a lane's outputs do not
depend on the batch around it.  So the sharded path can do all that
``align_batch`` can (window caps, the K1/K2 choice, the traceback and
pass-1 budgets, the walker and the checkpoint chain), by construction.

Multi-process contract (batch.py:10-16 of the JAX package): scores and
cell counts are all-gathered, so every process returns them for EVERY
pair; CIGARs come back for the lanes whose block this process ran
(``cigar=None`` elsewhere; callers merge).  Both low-mem passes of a lane
run in one process, so no checkpoint list is exchanged (the JAX package's
``_sync_segs`` existed because ``shard_map`` needs the same pass-2 inputs
on every process).  A process whose call raises still enters the
all-gather, with a sentinel for its lanes, and then every process raises.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models import exact
from ..models.exact import Result
from ..options import Options
from .distributed import process_count, process_index
from .mesh import Mesh, make_mesh

# the all-gathered score of a lane another process ran, and of a lane
# whose call raised (real scores are >= -1)
NOT_MINE, FAILED = -2, -3


def lane_blocks(n: int, ndev: int) -> List[range]:
    """The lanes each of ``ndev`` mesh entries holds: the batch padded to
    a multiple of ``ndev``, even blocks of B / ndev, the padding at the
    end (batch.py:281-282, :319 of the JAX package)."""
    per = -(-max(1, n) // ndev)
    return [range(min(k * per, n), min((k + 1) * per, n))
            for k in range(ndev)]


def align_batch_sharded(pairs: Sequence[Tuple[object, object]], opt: Options,
                        mesh: Optional[Mesh] = None, *, w0: int = 512,
                        s0: int = 512) -> List[Result]:
    """Batch alignment over ``mesh`` (default: every visible card) in
    score, CIGAR or low-mem mode.  Scores and n_iter come back for every
    pair on every process, CIGARs for the pairs this process ran (None
    otherwise).  ``align_batch_sharded.card_walls`` keeps, by device, the
    seconds of the last call's ``align_batch`` on that device in this
    process, timed in its thread."""
    if mesh is None:
        mesh = make_mesh()
    if not pairs:
        return []
    return _dispatch(pairs, opt, mesh, w0, s0)


def _owned(n: int, mesh: Mesh) -> Dict[torch.device, List[int]]:
    """This process's lanes, by the device that runs them (the union of
    the blocks of its entries on that device, in lane order)."""
    me = process_index()
    owned: Dict[torch.device, List[int]] = {}
    for (rank, dev), block in zip(mesh.entries, lane_blocks(n, mesh.size)):
        if rank == me and len(block):
            owned.setdefault(dev, []).extend(block)
    return {dev: sorted(lanes) for dev, lanes in owned.items()}


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """[n] int64 on every process -> [processes, n] on every process."""
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out)


def _dispatch(pairs, opt: Options, mesh: Mesh, w0: int, s0: int
              ) -> List[Result]:
    """One ``align_batch`` per device of this process,
    each in its own thread, then (across processes) the all-gather of the
    scores and n_iter."""
    n = len(pairs)
    owned = _owned(n, mesh)

    def run(dev, lanes):
        with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
            t0 = time.perf_counter()
            res = exact.align_batch([pairs[j] for j in lanes], opt, w0=w0,
                                    s0=s0, device=dev)
            # the results are host ints: the card's work is done
            walls[dev] = time.perf_counter() - t0
            return res

    s = torch.full((n,), NOT_MINE, dtype=torch.int64)
    n_iter = torch.zeros((n,), dtype=torch.int64)
    local: Dict[int, Result] = {}
    errors = []
    walls: Dict[torch.device, float] = {}
    align_batch_sharded.card_walls = walls
    with ThreadPoolExecutor(max_workers=max(1, len(owned))) as pool:
        futures = [(lanes, pool.submit(run, dev, lanes))
                   for dev, lanes in owned.items()]
        for lanes, fut in futures:
            try:
                res = fut.result()
            except Exception as e:  # noqa: BLE001 -- raised on every process below
                # the other processes wait in the all-gather: enter it
                # with the lanes marked, then raise everywhere
                errors.append(e)
                s[lanes] = FAILED
                continue
            for j, r in zip(lanes, res):
                local[j] = r
                s[j], n_iter[j] = r.s, r.n_iter
    if process_count() == 1:
        if errors:
            raise errors[0]
        g_s, g_ni = s[None], n_iter[None]
    else:
        g_s, g_ni = _all_gather(s), _all_gather(n_iter)
    failed = (g_s == FAILED).any(dim=0)
    if failed.any():
        ranks = torch.nonzero((g_s == FAILED).any(dim=1)).flatten().tolist()
        raise RuntimeError(
            f"sharded alignment failed on {int(failed.sum())} lane(s) of "
            f"rank(s) {ranks} (the cause is raised there)") \
            from (errors[0] if errors else None)
    ran = g_s != NOT_MINE
    if not ran.any(dim=0).all():
        missing = torch.nonzero(~ran.any(dim=0)).flatten().tolist()
        raise RuntimeError(f"lane(s) {missing} lie on no device of the job: "
                           f"the mesh's ranks are not its processes'")
    owner = ran.int().argmax(dim=0)
    lane = torch.arange(n)
    s, n_iter = g_s[owner, lane].tolist(), g_ni[owner, lane].tolist()
    return [local[j] if j in local
            else Result(s=s[j], cigar=None, n_iter=n_iter[j])
            for j in range(n)]


align_batch_sharded.card_walls = {}
