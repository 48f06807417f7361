"""The wide engine K2's roofline share in low-mem pass 1 over the traced
stretch: the reference's pass-1 cells (``n_iter_p1``) in PASS1 mode over
K2's device time.  K2 runs only pass 1 (pass 2 is K1's)."""

from wfabench import roofline


def read(rec):
    if rec["mode"] != "lowmem":
        return None
    return roofline.stretch_share(rec, roofline.K2, "pass1", "n_iter_p1")
