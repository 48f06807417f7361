"""Share of the traced stretch in which the card ran nothing, one-card
cells (moves ``bp_per_s``)."""

from wfabench import trace


def read(rec):
    return trace.idle_share(rec)
