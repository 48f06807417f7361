"""Wall-clock spans of the chain and auto drivers' stages.

A caller that wants the split of a run's wall passes a ``Spans`` to
``align_auto_batch`` / ``align_chain_batch`` / ``align_tiny_batch``; each
stage adds its host wall time under its name.  Every device stage ends by
copying its results to the host, which waits for the card, so a span
holds its kernels' time.  Without a ``Spans`` nothing is timed.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional


class Spans:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) \
                + time.perf_counter() - t0


def span(spans: Optional[Spans], name: str):
    """``spans.span(name)``, or a no-op when ``spans`` is None."""
    return nullcontext() if spans is None else spans.span(name)
