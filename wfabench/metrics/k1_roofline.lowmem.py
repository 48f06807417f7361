"""K1's roofline share in low-mem mode where K1 runs both passes: the
bounds of pass 1's work (the reference's ``n_iter_p1`` cells in PASS1
mode) and of pass 2's (its ``n_iter`` cells in TB mode with checkpoints)
summed, over K1's device time in the traced stretch (the two passes'
launches share one kernel name, so the two shares over the same time are
added).  None where the wide engine K2 ran (pass 1 was not K1's:
``k1_roofline.seg``)."""

from wfabench import roofline, trace


def read(rec):
    if rec["mode"] != "lowmem" or \
            trace.device_time(rec["stretch"]["events"], roofline.K2) > 0:
        return None
    p1 = roofline.stretch_share(rec, roofline.K1, "pass1", "n_iter_p1")
    p2 = roofline.stretch_share(rec, roofline.K1, "seg")
    return None if p1 is None or p2 is None else p1 + p2
