"""The benchmark's pairs, made from ``--seed`` with NumPy.

Copied in its shapes from ``miniwfa_tpu_torch/tools/pairs.py``
(``make_pairs``: 2% substitutions and 0.2% indels of 1-8 bp;
``scale_case("dissim150k")``: a 12 kb stretch of the target replaced by
unrelated bases before the query is mutated), rewritten with NumPy and
drawing from the run's seed.  Every seed gives the same sizes: the
target's length, the novel stretch, and the exact number of
substitutions, insertions and deletions and the multiset of indel
lengths are fixed by the configuration; the seed chooses the bases and
the positions.  So seeds change which pairs are aligned, not how much
work they hold.

A configuration (``configs/<name>.json``) gives ``target_bp``,
``sub_rate``, ``indel_rate``, ``indel_len`` ([min, max]) and optionally
``novel_at``/``novel_bp`` and ``lane_sub_step``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def rng_for(seed: int) -> np.random.Generator:
    """A generator for any whole-number seed (negative ones too)."""
    return np.random.default_rng(np.random.SeedSequence(seed % (1 << 64)))


def mutate(rng: np.random.Generator, seq: np.ndarray, sub_rate: float,
           indel_rate: float, lmin: int, lmax: int,
           extra_subs: int = 0) -> np.ndarray:
    """``seq`` (codes 0..3) with round(indel_rate * n) indels, half
    insertions and half deletions, each kind's lengths cycling through
    lmin..lmax, at positions at least 2*lmax apart, then
    round(sub_rate * n) + ``extra_subs`` substitutions (each by another
    base) among the bases that no deletion removed."""
    n = len(seq)
    n_ind = int(round(indel_rate * n))
    span = 2 * lmax
    if n_ind > n // span:
        raise ValueError(f"{n_ind} indels do not fit {n} bases")
    # the lengths of each kind cycle through lmin..lmax, so the query's
    # length is the same for every seed
    n_ins = n_ind // 2
    lens = np.concatenate([np.resize(np.arange(lmin, lmax + 1), n_ins),
                           np.resize(np.arange(lmin, lmax + 1),
                                     n_ind - n_ins)])
    is_ins = np.arange(n_ind) < n_ins
    order = rng.permutation(n_ind)
    lens, is_ins = lens[order], is_ins[order]
    slots = np.sort(rng.choice(n // span, n_ind, replace=False))
    pos = slots * span + rng.integers(0, lmax, n_ind)
    keep = np.ones(n, bool)
    dpos, dlen = pos[~is_ins], lens[~is_ins]
    if len(dpos):
        gone = np.repeat(dpos, dlen) + (
            np.arange(dlen.sum()) - np.repeat(np.cumsum(dlen) - dlen, dlen))
        keep[gone] = False
    q = seq.copy()
    n_sub = int(round(sub_rate * n)) + extra_subs
    cand = np.flatnonzero(keep)
    sp = rng.choice(cand, n_sub, replace=False)
    q[sp] = (q[sp] + rng.integers(1, 4, n_sub)) % 4
    ipos, ilen = pos[is_ins], lens[is_ins]
    ins = rng.integers(0, 4, int(ilen.sum())).astype(seq.dtype)
    at = np.repeat(ipos, ilen)
    q = np.insert(q, at, ins)
    keep = np.insert(keep, at, True)
    return q[keep]


def make_pair(cfg: dict, rng: np.random.Generator,
              lane: int = 0) -> Tuple[bytes, bytes]:
    """The (target, query) pair of lane ``lane`` of the configuration, as
    ACGT bytes: lane i takes ``lane_sub_step * i`` substitutions more, so
    that no two lanes of a pool share a score."""
    n = int(cfg["target_bp"])
    t = rng.integers(0, 4, n).astype(np.uint8)
    q = t
    nb = int(cfg.get("novel_bp", 0))
    if nb:
        at = int(cfg["novel_at"])
        q = np.concatenate([t[:at], rng.integers(0, 4, nb).astype(np.uint8),
                            t[at + nb:]])
    lmin, lmax = cfg["indel_len"]
    q = mutate(rng, q, float(cfg["sub_rate"]), float(cfg["indel_rate"]),
               int(lmin), int(lmax), int(cfg.get("lane_sub_step", 0)) * lane)
    return BASES[t].tobytes(), BASES[q].tobytes()


def make_pool(cfg: dict, n_pairs: int, seed: int) -> List[Tuple[bytes, bytes]]:
    """The run's pool: ``n_pairs`` pairs of the configuration from
    ``seed``.  The same seed gives the same pairs."""
    rng = rng_for(seed)
    return [make_pair(cfg, rng, i) for i in range(n_pairs)]
