"""Kernel launches per call (K1, K2, K3, K4, W1, W2, by the program's
launch counters) over the untraced window's calls: re-run rungs of the
escalation ladder show here."""


def read(rec):
    total = sum(rec["launches"].values())
    if not total or not rec["calls"]:
        return None
    return total / rec["calls"]
