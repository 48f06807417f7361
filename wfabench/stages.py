"""The host rest of a traced call, split by the program's stage spans.

The program marks each host stage of ``align_batch`` as a range
``mwf.<stage>`` on the profiler's host timeline (``size``, ``pack``,
``dispatch``, ``cigars``).  A stage's time in a call is the time inside
its ranges, within the call, during which the card ran nothing; the
unnamed rest is the card's idle time in the call that no ``mwf.`` range
covers.  The stages are flat, so the stages and the unnamed rest add up
to the call's rest as ``metrics/host_s_per_call.py`` takes it.  Times are
the profiler's microseconds; a stretch with no range of the stage (a
program without the spans, or a mode that skips the stage) reads None.
"""

from __future__ import annotations

from typing import Optional, Sequence

from wfabench import trace

PREFIX = "mwf."


def idle_in(ranges: Sequence[trace.Span], busy: Sequence[trace.Span],
            a: float, b: float) -> float:
    """Length of the merged ``ranges``, clipped to [a, b], that the
    merged ``busy`` intervals leave uncovered."""
    out = 0.0
    for x, y in ranges:
        x, y = max(x, a), min(y, b)
        if y > x:
            out += y - x - trace.covered(busy, x, y)
    return out


def ms_per_call(rec: dict, stage: Optional[str]) -> Optional[float]:
    """Milliseconds a traced call, averaged over the stretch's calls, that
    the card is idle inside the ranges ``mwf.<stage>``, or (``stage``
    None) inside no ``mwf.`` range."""
    st = rec["stretch"]
    if not st["calls"] or not st["events"]:
        return None
    if stage is None:
        mine = [h for h in st["host"] if h["name"].startswith(PREFIX)]
    else:
        mine = [h for h in st["host"] if h["name"] == PREFIX + stage]
    ranges = trace.union((h["start"], h["end"]) for h in mine)
    if not ranges:
        return None
    busy = trace.union((e["start"], e["end"]) for e in st["events"])
    total = 0.0
    for a, b in st["calls"]:
        named = idle_in(ranges, busy, a, b)
        total += named if stage is not None \
            else b - a - trace.covered(busy, a, b) - named
    return total / len(st["calls"]) / 1e3
