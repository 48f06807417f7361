"""The benchmark pairs, made from a seed.

``make_pairs`` gives ``bench.py::make_pairs``'s pairs (Python's
``random``, substitutions and short indels) and ``mk_pairs``
``tools/scaling_bench.py::mk_pairs``'s (numpy's ``default_rng``,
substitutions only) and ``scale_case`` ``tools/make_scale_goldens.py``'s
scale fixtures, sequence for sequence; those modules belong to the JAX
package's side, so they are restated here.  ``bench_cuda.py``,
``tools/scaling_bench.py`` and ``tools/multicard_smoke.py`` of this
package and ``chip_smoke.py`` take their pairs from here.
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


def scale_case(name: str) -> Tuple[str, str]:
    """The scale fixture ``name`` of tests/data/scale_goldens.json, (target,
    query): ``tools/make_scale_goldens.py::gen_case``, restated."""
    if name == "del50k":         # one 5 kb deletion
        rng = random.Random(501)
        t = rand_seq(rng, 50_000)
        return t, t[:20_000] + t[25_000:]
    if name == "div100k":        # 2% substitutions, 0.2% indels
        rng = random.Random(1001)
        t = rand_seq(rng, 100_000)
        return t, mutate(rng, t, sub=0.02, ind=0.002)
    if name == "div5m":          # the reference's headline 5 Mb pair
        rng = random.Random(5001)
        t = rand_seq(rng, 5_000_000)
        return t, mutate(rng, t, sub=0.008, ind=0.002)
    if name == "sv300k":         # multi-kb deletions and insertions
        rng = random.Random(3001)
        t = rand_seq(rng, 300_000)
        ins15, ins2 = rand_seq(rng, 15_000), rand_seq(rng, 2_000)
        q = (t[:50_000] + t[70_000:150_000] + ins15 + t[150_000:200_000]
             + t[203_000:250_000] + ins2 + t[250_000:])
        return t, mutate(rng, q, sub=0.01, ind=0.0005)
    if name == "rep200k":        # tandem repeats, copy-number changes
        rng = random.Random(2002)
        u1, u2 = rand_seq(rng, 67), rand_seq(rng, 171)
        fill = [rand_seq(rng, n) for n in (60_000, 50_000, 70_000)]
        t = fill[0] + u1 * 150 + fill[1] + u2 * 60 + fill[2]
        q = fill[0] + u1 * 138 + fill[1] + u2 * 66 + fill[2]
        return t, mutate(rng, q, sub=0.01, ind=0.0005)
    if name == "nbear1m":        # N runs and soft-masked stretches
        rng = random.Random(1101)
        t = rand_seq(rng, 1_000_000)
        t = (t[:200_000] + "N" * 5_000 + t[200_000:500_000]
             + "N" * 10_000 + t[500_000:700_000].lower()
             + t[700_000:900_000] + "N" * 2_000 + t[900_000:])
        return t, mutate(rng, t, sub=0.01, ind=0.0005)
    if name == "dissim150k":     # a 12 kb unrelated region in the query
        rng = random.Random(1501)
        t = rand_seq(rng, 150_000)
        novel = rand_seq(rng, 12_000)
        q = t[:60_000] + novel + t[72_000:]
        return t, mutate(rng, q, sub=0.015, ind=0.001)
    raise KeyError(name)
