"""Milliseconds a traced call in which the card is idle inside the
program's ``mwf.cigars`` spans: the walker's inputs, the wait for it,
the copy back and the CIGAR lists (``walk_meta``, ``walk``, ``to_cigars``)."""

from wfabench import stages


def read(rec):
    return stages.ms_per_call(rec, "cigars")
