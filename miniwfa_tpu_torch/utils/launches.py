"""Launch counters of the kernels' wrappers.

Each wrapper that launches a kernel on the card counts it here, where it
launches and nowhere else.  The counters are attributes of the wrapper
function: ``launches`` (every wrapper), plus ``launches_by_mode`` (a
``Counter``: ``wavefront``, ``wavefront_multi``, ``wide``) and
``launches_by_variant`` (a ``Counter``: ``walk``, ``wide``,
``wavefront_multi``, ``gaps``) where it counts by those, and
``launches_by_card`` (a ``Counter`` by the launching card's index: every
wrapper of the main path and the chain) so that a run over several cards
shows which cards launched; ``gaps``, which launches a kernel per width
class a call holds, also counts its calls in ``dispatches``.  The
sharded path launches from one thread per card, and ``+=`` is no atomic
update, so every count goes through one lock.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


def count_launch(fn, *, mode=None, variant=None, card=None) -> None:
    """Add one to ``fn.launches``, and to ``fn.launches_by_mode[mode]``,
    ``fn.launches_by_variant[variant]`` and ``fn.launches_by_card[card]``
    where they are given."""
    with _LOCK:
        fn.launches += 1
        if card is not None:
            fn.launches_by_card[card] += 1
        if mode is not None:
            fn.launches_by_mode[mode] += 1
        if variant is not None:
            fn.launches_by_variant[variant] += 1


def count_dispatch(fn) -> None:
    """Add one to ``fn.dispatches``: a call that launched its kernels."""
    with _LOCK:
        fn.dispatches += 1
