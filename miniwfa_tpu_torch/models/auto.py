"""Auto mode: try the exact algorithm under a 100M-cell budget, and fall
back to the chaining heuristic (reference mwf_wfa_auto,
miniwfa.c:898-908)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..options import Options
from ..utils.spans import Spans, span
from . import exact
from .chain import align_chain_batch
from .exact import Result, align_batch, as_bytes

CELL_BUDGET = 100_000_000   # miniwfa.c:903


def align_auto_batch(pairs: Sequence[Tuple[object, object]], opt: Options,
                     device="cuda", spans: Optional[Spans] = None
                     ) -> List[Result]:
    """Auto policy over a batch on ``device``: the exact attempt under the
    cell budget (per-lane early stop), then one batched chain pass over
    the lanes that gave up.

    The attempt is probed in SCORE mode, which holds no traceback table,
    so a doomed attempt on a Mb-scale pair costs one early-stopped score
    run.  In CIGAR mode the lanes that succeed re-run in TB mode, sized
    from the known score: their (score, CIGAR, n_iter) equal a direct
    CIGAR attempt's, since both runs compute the same cells."""
    device = exact.check_device(device)
    o = opt.replace(step=0, max_iter=CELL_BUDGET)
    with span(spans, "probe"):
        res = align_batch(pairs, o.replace(cigar=False), band_limit="stop",
                          w0=512, device=device)
    if opt.cigar:
        ok = [i for i, r in enumerate(res) if r.s >= 0]
        if ok:
            ns = opt.max_pen + 1
            smax = max(res[i].s for i in ok)
            dmax = max(abs(len(as_bytes(pairs[i][0]))
                           - len(as_bytes(pairs[i][1]))) for i in ok)
            # the probe enforced the cell budget and the re-run computes
            # the same cells, so the re-run has no budget
            with span(spans, "tb rerun"):
                sub = align_batch([pairs[i] for i in ok],
                                  o.replace(max_iter=0), band_limit="stop",
                                  w0=2 * smax + dmax + 2 * ns + 24,
                                  s0=smax + 8, device=device)
            for i, r in zip(ok, sub):
                res[i] = r
    failed = [i for i, r in enumerate(res) if r.s < 0]
    if failed:
        oc = opt.replace(step=5000 if opt.cigar else 0, max_iter=0)
        chained = align_chain_batch([pairs[i] for i in failed], oc,
                                    device=device, spans=spans)
        for i, r in zip(failed, chained):
            res[i] = r
    return res


def align_auto(ts, qs, opt: Options, device="cuda") -> Result:
    """Auto-mode alignment of one pair (reference mwf_wfa_auto)."""
    return align_auto_batch([(ts, qs)], opt, device=device)[0]
