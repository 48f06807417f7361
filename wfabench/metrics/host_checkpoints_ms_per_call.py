"""Milliseconds a traced call in which the card is idle inside the
program's ``mwf.checkpoints`` spans: low-mem pass 1's checkpoint chain
(``chain_ptrs``: its launch, the wait for it and the copy back) and the
checkpoints' decoding (``decode_checkpoints_ptrs``)."""

from wfabench import stages


def read(rec):
    return stages.ms_per_call(rec, "checkpoints")
