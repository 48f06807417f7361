"""Milliseconds a traced call in which the card is idle inside the
program's ``mwf.pack`` spans: the kernel's inputs (``kernel_inputs``: the
alphabet check, the word streams, the lanes table)."""

from wfabench import stages


def read(rec):
    return stages.ms_per_call(rec, "pack")
