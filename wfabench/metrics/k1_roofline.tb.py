"""K1's roofline share in high-mem CIGAR mode (TB) over the traced
stretch."""

from wfabench import roofline


def read(rec):
    if rec["mode"] != "cigar":
        return None
    return roofline.stretch_share(rec, roofline.K1, "tb")
