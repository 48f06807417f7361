"""K1's roofline share in score mode over the traced stretch."""

from wfabench import roofline


def read(rec):
    if rec["mode"] != "score":
        return None
    return roofline.stretch_share(rec, roofline.K1, "score")
