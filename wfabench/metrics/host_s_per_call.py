"""Host rest per call: each traced call's synchronised wall less the
card's busy time inside it, averaged over the traced stretch's calls."""

from wfabench import trace


def read(rec):
    st = rec["stretch"]
    if not st["calls"] or not st["events"]:
        return None
    merged = trace.union((e["start"], e["end"]) for e in st["events"])
    rest = [(b - a - trace.covered(merged, a, b)) / 1e6
            for a, b in st["calls"]]
    return sum(rest) / len(rest)
