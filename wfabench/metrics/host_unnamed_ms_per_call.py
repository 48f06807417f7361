"""Milliseconds a traced call in which the card is idle and no ``mwf.``
span of the program is open: the host rest the stage metrics leave
unnamed."""

from wfabench import stages


def read(rec):
    return stages.ms_per_call(rec, None)
