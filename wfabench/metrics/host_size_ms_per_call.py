"""Milliseconds a traced call in which the card is idle inside the
program's ``mwf.size`` spans: bucket sizing (``first_bucket``,
``pass2_bucket``; in CIGAR mode with the k-mer score estimate)."""

from wfabench import stages


def read(rec):
    return stages.ms_per_call(rec, "size")
