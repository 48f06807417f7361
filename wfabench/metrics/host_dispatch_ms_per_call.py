"""Milliseconds a traced call in which the card is idle inside the
program's ``mwf.dispatch`` spans: the copies to the card and the launch
wrappers (allocations and the tb table's zero fill enqueued)."""

from wfabench import stages


def read(rec):
    return stages.ms_per_call(rec, "dispatch")
