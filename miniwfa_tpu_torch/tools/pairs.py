"""The benchmark pairs, made from a seed.

``make_pairs`` gives ``bench.py::make_pairs``'s pairs (Python's
``random``, substitutions and short indels) and ``mk_pairs``
``tools/scaling_bench.py::mk_pairs``'s (numpy's ``default_rng``,
substitutions only), sequence for sequence; those modules belong to the
JAX package's side, so they are restated here.  ``bench_cuda.py``,
``tools/scaling_bench.py`` of this package and ``chip_smoke.py`` take
their pairs from here.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np


def mutate(rng: random.Random, seq: str, sub: float, ind: float,
           max_indel: int = 8) -> str:
    """``seq`` with substitutions at rate ``sub`` and indels of 1 to
    ``max_indel`` bases at rate ``ind``."""
    out = []
    bases = "ACGT"
    i, n = 0, len(seq)
    while i < n:
        if rng.random() < ind:
            if rng.random() < 0.5:
                i += rng.randint(1, max_indel)
                continue
            out.append("".join(rng.choice(bases)
                               for _ in range(rng.randint(1, max_indel))))
        c = seq[i]
        if rng.random() < sub:
            c = rng.choice([b for b in bases if b != c])
        out.append(c)
        i += 1
    return "".join(out)


def rand_seq(rng: random.Random, n: int) -> str:
    """n random bases."""
    return "".join(rng.choice("ACGT") for _ in range(n))


def make_pairs(n: int, b: int, seed: int = 7) -> List[Tuple[str, str]]:
    """b pairs of n bp, 2% substitutions and 0.2% indels."""
    rng = random.Random(seed)
    pairs = []
    for _ in range(b):
        t = rand_seq(rng, n)
        pairs.append((t, mutate(rng, t, sub=0.02, ind=0.002)))
    return pairs


def mk_pairs(n_pairs: int, n: int, div: float = 0.02,
             seed: int = 0) -> List[Tuple[bytes, bytes]]:
    """n_pairs pairs of n bp, each base of the query substituted (by any
    base, itself included) with probability ``div``."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(n_pairs):
        t = bases[rng.integers(0, 4, n)]
        q = t.copy()
        m = rng.random(n) < div
        q[m] = bases[rng.integers(0, 4, int(m.sum()))]
        pairs.append((t.tobytes(), q.tobytes()))
    return pairs
