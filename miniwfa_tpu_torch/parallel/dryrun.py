"""A full data-parallel run over an n-entry mesh, with known answers.

The port of ``__graft_entry__.py::dryrun_multichip``: the same fixtures
(scores and canonical co-optimal CIGARs under the reference's tie-breaks)
in score, CIGAR and two-pass low-mem mode, and a 50 kb lane on which
low-mem must equal high-mem bit for bit.
"""

from __future__ import annotations

import numpy as np

from .. import Options
from .. import cigar as C
from .batch import align_batch_sharded
from .mesh import make_mesh

# (target, query, optimal score, canonical CIGAR)
FIXTURES = [
    (b"ACGT", b"ACGT", 0, "4="),
    (b"A", b"G", 4, "1X"),
    (b"AAAA", b"AAAAAAAA", 12, "4=4I"),
    (b"AAAA", b"", 12, "4D"),
    (b"ACGTACGTACGT", b"ACGTACTTACGT", 4, "6=1X5="),
]


def _pair_50kb():
    """A 50 kb pair: 60 substitutions and a 50 bp insertion (seed 77)."""
    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGT", np.uint8)
    t = bases[rng.integers(0, 4, 50_000)].tobytes()
    qb = bytearray(t)
    for p in rng.integers(0, 50_000, 60):
        qb[p] = bases[rng.integers(0, 4)]
    ins = bases[rng.integers(0, 4, 50)].tobytes()
    return t, bytes(qb[:25_000]) + ins + bytes(qb[25_000:])


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Align over a mesh of ``n_devices`` entries of ``device`` in every
    exact mode and assert the known answers; raises AssertionError on a
    wrong one."""
    mesh = make_mesh([device] * n_devices)
    pairs, want = [], []
    for j in range(2 * n_devices):
        t, q, s, cg = FIXTURES[j % len(FIXTURES)]
        pairs.append((t, q))
        want.append((s, cg))

    got = [r.s for r in align_batch_sharded(pairs, Options(), mesh)]
    if got != [s for s, _ in want]:
        raise AssertionError(f"scores {got}")
    for opt in (Options(cigar=True), Options(cigar=True, step=4)):
        for r, (s, cg) in zip(align_batch_sharded(pairs, opt, mesh), want):
            if (r.s, r.cigar_str) != (s, cg):
                raise AssertionError((opt, r.s, r.cigar_str, s, cg))
    # the JAX dry run's kernel lane (non-empty pairs, a 1024 window)
    kp = [(t, q, w) for (t, q), w in zip(pairs, want) if t and q]
    res = align_batch_sharded([(t, q) for t, q, _ in kp],
                              Options(cigar=True), mesh, w0=1024)
    for r, (_, _, (s, cg)) in zip(res, kp):
        if (r.s, r.cigar_str) != (s, cg):
            raise AssertionError((r.s, r.cigar_str, s, cg))

    # the long-sequence machinery (snapshots, checkpoints, the pass-2 band
    # collapse): low-mem equals high-mem, and the CIGAR re-scores to s
    t50, q50 = _pair_50kb()
    big = [(t50, q50)] * n_devices
    opt = Options(cigar=True)
    high = align_batch_sharded(big, opt, mesh)
    low = align_batch_sharded(big, Options(cigar=True, step=100), mesh)
    for h, lo in zip(high, low):
        if (h.s, h.cigar_str) != (lo.s, lo.cigar_str):
            raise AssertionError(f"low-mem {lo.s} != high-mem {h.s} at 50 kb")
        C.assert_cigar(opt, h.cigar, len(t50), len(q50), h.s, t50, q50)
