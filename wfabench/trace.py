"""Arithmetic over a ``torch.profiler`` trace of the traced stretch.

The card's busy time is the union of its kernel, copy and set intervals,
as ``miniwfa_tpu_torch/tools/trace_main.py`` takes it (copied from
there); device time by kernel is matched by the kernel's name prefix.
Times are the profiler's microseconds.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Span = Tuple[float, float]


def kernel_name(name: str) -> str:
    """A device event's name without ``void``, namespaces, template
    arguments and parameters: ``void (anonymous
    namespace)::wavefront_kernel<1, 1, true>((anonymous
    namespace)::Params)`` -> ``wavefront_kernel``."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    for c in "<(":
        n = n.split(c, 1)[0]
    return n.strip().split("::")[-1]


def union(spans: Iterable[Span]) -> List[Span]:
    """Sorted, merged intervals."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged: Sequence[Span], a: float, b: float) -> float:
    """Length of [a, b] that the merged intervals cover."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


def busy_by_card(events, lo: float, hi: float) -> Dict[int, float]:
    """Each card's busy microseconds inside [lo, hi]."""
    by: Dict[int, List[Span]] = {}
    for e in events:
        by.setdefault(e["dev"], []).append((e["start"], e["end"]))
    return {dev: covered(union(sp), lo, hi) for dev, sp in by.items()}


def device_time(events, prefixes: Sequence[str]) -> float:
    """Device microseconds of the kernels whose name starts with one of
    ``prefixes``, every launch counted."""
    return sum(e["end"] - e["start"] for e in events
               if kernel_name(e["name"]).startswith(tuple(prefixes)))


def top_ops(events, n: int = 10) -> List[List]:
    """The ``n`` device operations that took the most time: [name,
    seconds]."""
    by: Dict[str, float] = {}
    for e in events:
        k = kernel_name(e["name"])
        by[k] = by.get(k, 0.0) + (e["end"] - e["start"]) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, host, lo: float, hi: float, dev: Optional[int] = None,
              n: int = 10) -> List[List]:
    """The ``n`` longest stretches inside [lo, hi] in which card ``dev``
    (every card if None) ran nothing, each named by the host operation
    that covers most of it, where one covers half of it or more (else
    the host was in Python or NumPy code): [name, seconds]."""
    merged = union((e["start"], e["end"]) for e in events
                   if dev is None or e["dev"] == dev)
    gaps, cur = [], lo
    for a, b in merged:
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:n]
    out = []
    for a, b in gaps:
        best, name = 0.0, "host code outside torch operations"
        for h in host:
            ov = min(b, h["end"]) - max(a, h["start"])
            if ov > best and ov >= 0.5 * (b - a):
                best, name = ov, h["name"]
        out.append([name, (b - a) / 1e6])
    return out


def idle_share(rec: dict):
    """Share of the traced stretch in which the card ran nothing (1 - the
    busy union over the stretch's wall) in %, the mean over the cards
    used; None without a device event."""
    st = rec["stretch"]
    span = st["hi"] - st["lo"]
    if span <= 0 or not st["events"]:
        return None
    busy = busy_by_card(st["events"], st["lo"], st["hi"])
    mean = sum(busy.get(c, 0.0) for c in st["cards"]) / len(st["cards"])
    return 100.0 * (1.0 - mean / span)
