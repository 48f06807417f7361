"""K1's roofline share in low-mem pass 2 (TB with the band collapsed at
the checkpoints) over the traced stretch, in a cell whose pass 1 runs on
the wide engine K2, so that all of K1's device time is pass 2's; None
where K2 ran nothing (K1 ran both passes: ``k1_roofline.lowmem``)."""

from wfabench import roofline, trace


def read(rec):
    st = rec["stretch"]
    if rec["mode"] != "lowmem" or \
            trace.device_time(st["events"], roofline.K2) <= 0:
        return None
    return roofline.stretch_share(rec, roofline.K1, "seg")
