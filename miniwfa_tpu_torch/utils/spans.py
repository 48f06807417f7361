"""Named host spans of the drivers' stages, with two sinks.

``span(spans, name)`` marks the stage on ``torch.profiler``'s host
timeline as a range named ``mwf.<name>``, always: a traced run reads it on
the clock the profiler aligns the card's events to, so the card's idle
time can be split by stage.  When no profiler is running, a range costs a
check of the profiler's callback list and nothing more.  A caller that
wants the split of a run's wall without a profiler also passes a
``Spans`` (``align_auto_batch`` / ``align_chain_batch`` /
``align_tiny_batch`` take one); the stage then adds its host wall time
under ``name`` to ``spans.totals``.  Every device stage of those drivers
ends by copying its results to the host, which waits for the card, so a
total holds its kernels' time.

``models/exact.py::align_batch`` opens one flat span a stage, in the
order a call runs them: ``size`` (the bucket, with the k-mer score
estimate), ``pack`` (the kernel's inputs), ``dispatch`` (the host-device
copies and the launch wrapper), ``checkpoints`` (low-mem pass 1's
checkpoint chain and its decoding, after each pass-1 dispatch) and
``cigars`` (the walker and the CIGAR lists).  The drivers' spans may
enclose these.

A range is recorded by ``_RecordFunctionFast``, a plain host operation,
not by ``torch.profiler.record_function``: the latter records a user
annotation, which the profiler can mirror onto the card's timeline over
the kernels launched inside it, where a reader of the card's events would
count it as the card's work.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

from torch._C._profiler import _RecordFunctionFast

PREFIX = "mwf."


class Spans:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with _RecordFunctionFast(PREFIX + name):
                yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) \
                + time.perf_counter() - t0


def span(spans: Optional[Spans], name: str):
    """The stage ``name`` as a profiler range ``mwf.<name>``, also timed
    into ``spans.totals`` when ``spans`` is given."""
    return _RecordFunctionFast(PREFIX + name) if spans is None \
        else spans.span(name)
