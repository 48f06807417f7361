"""Device milliseconds of the walker W1 and the checkpoint chain W2 per
traced call."""

from wfabench import roofline, trace


def read(rec):
    st = rec["stretch"]
    us = trace.device_time(st["events"], roofline.W1 + roofline.W2)
    if rec["mode"] == "score" or not st["calls"] or us <= 0:
        return None
    return us / 1e3 / len(st["calls"])
