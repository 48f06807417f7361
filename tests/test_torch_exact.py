"""The port's exact driver (``miniwfa_tpu_torch.models.exact.align_batch``)
on the CPU, i.e. through the plain PyTorch versions of its kernels.

Held against the reference goldens (score, n_iter, CIGAR under three
penalty regimes), against the JAX package's ``align_batch`` on a
numpy-seeded random batch, and against the 8 kb benchmark goldens.
Tolerance: exact equality.
"""

import json
import os

import numpy as np
import pytest
import torch

from miniwfa_tpu_torch import Options, align_exact, cigar as C
from miniwfa_tpu_torch.models.exact import align_batch

torch.set_num_threads(1)   # as in test_torch_chain.py

_DATA = os.path.join(os.path.dirname(__file__), "data")


def _cases(goldens, small):
    return [(i, c) for i, c in enumerate(goldens["cases"])
            if (max(len(c["t"]), len(c["q"])) <= 256) == small]


RUNS = {"score": Options(), "cigar": Options(cigar=True),
        "edit_cigar": Options(cigar=True).as_edit_distance(),
        "affine_cigar": Options(cigar=True).as_single_affine()}


@pytest.mark.parametrize("run,small", [
    ("score", True), ("score", False), ("cigar", True), ("cigar", False),
    ("edit_cigar", True), ("affine_cigar", True)])
def test_goldens(goldens, run, small):
    opt = RUNS[run]
    sel = _cases(goldens, small)
    res = align_batch([(c["t"], c["q"]) for _, c in sel], opt, device="cpu")
    bad = []
    for (i, c), r in zip(sel, res):
        e = goldens["runs"][run][i]
        if r.s != e["s"] or (opt.cigar and r.cigar_str != e["cigar"]):
            bad.append(f"{c['name']}: ({r.s}, {r.cigar_str}) != "
                       f"({e['s']}, {e['cigar']})")
        elif opt.cigar:
            C.assert_cigar(opt, r.cigar, len(c["t"]), len(c["q"]), r.s,
                           c["t"].encode("latin1"), c["q"].encode("latin1"))
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("cigar", [False, True])
def test_n_iter_parity(goldens, cigar):
    """Cell counts equal the reference's r->n_iter (miniwfa.c:421)."""
    names = goldens["niter"]
    cases = {c["name"]: c for c in goldens["cases"]}
    res = align_batch([(cases[n]["t"], cases[n]["q"]) for n in names],
                      Options(cigar=cigar), device="cpu")
    for (name, e), r in zip(names.items(), res):
        assert (r.s, r.n_iter) == (e["s"], e["n_iter"]), name
        if cigar:
            assert r.cigar_str == e["cigar"], name


def _random_pairs(seed, n):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        ln = int(rng.integers(40, 120))
        t = rng.choice(np.frombuffer(b"ACGT", np.uint8), ln)
        q = t.copy()
        sub = rng.random(ln) < 0.1
        q[sub] = rng.choice(np.frombuffer(b"ACGT", np.uint8), int(sub.sum()))
        q = np.delete(q, rng.choice(ln, int(rng.integers(0, 5)),
                                    replace=False))
        q = np.insert(q, int(rng.integers(0, len(q))),
                      rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                 int(rng.integers(0, 6))))
        pairs.append((t.tobytes(), q.tobytes()))
    return pairs


@pytest.mark.parametrize("cigar", [False, True])
def test_matches_jax_align_batch(cigar):
    from miniwfa_tpu import Options as JOptions
    from miniwfa_tpu.models.exact import align_batch as jax_align_batch
    pairs = _random_pairs(11, 8)
    want = jax_align_batch(pairs, JOptions(cigar=cigar))
    got = align_batch(pairs, Options(cigar=cigar), device="cpu")
    assert [(r.s, r.n_iter, r.cigar) for r in got] == \
        [(r.s, r.n_iter, r.cigar) for r in want]


def test_batch_matches_solo(goldens):
    c = next(c for c in goldens["cases"] if c["name"] == "t3")
    opt = Options(cigar=True)
    solo = align_exact(c["t"], c["q"], opt, device="cpu")
    batch = align_batch([(c["t"], c["q"])] * 3 + [("A", "G")], opt,
                        device="cpu")
    for r in batch[:3]:
        assert (r.s, r.cigar_str, r.n_iter) == \
            (solo.s, solo.cigar_str, solo.n_iter)
    assert batch[3].s == 4


def test_empty_vs_empty():
    r = align_batch([("", "")], Options(cigar=True), device="cpu")[0]
    assert r.s == 0 and r.cigar == []


@pytest.mark.parametrize("opt", [Options(max_s=3), Options(max_iter=5)])
def test_early_stops(opt):
    r = align_batch([("ACGTACGTAA", "TGCATGCATT")], opt, device="cpu")[0]
    assert r.s == -1


def test_bench_8000_pairs():
    import bench
    with open(os.path.join(_DATA, "bench_goldens.json")) as f:
        gold = json.load(f)["8000"][:4]
    pairs = bench.make_pairs(8000, 64)[:4]
    res = align_batch(pairs, Options(cigar=True), device="cpu")
    assert [r.s for r in res] == [g["s"] for g in gold]
    for (t, q), r in zip(pairs, res):
        C.assert_cigar(Options(), r.cigar, len(t), len(q), r.s,
                       t.encode(), q.encode())


def test_band_escalation_small_window(goldens):
    """A window far too small for the band re-runs in larger buckets."""
    c = next(c for c in goldens["cases"] if c["name"] == "med3k_bigdel")
    r = align_batch([(c["t"], c["q"])], Options(cigar=True), w0=64, s0=16,
                    device="cpu")[0]
    want = goldens["runs"]["cigar"][goldens["cases"].index(c)]
    assert (r.s, r.cigar_str) == (want["s"], want["cigar"])


def test_lowmem_mode_not_ported(goldens):
    """The low-memory mode (once refused here) runs: t3 at step 16 gives
    the reference's low-mem golden."""
    i, c = next((i, c) for i, c in enumerate(goldens["cases"])
                if c["name"] == "t3")
    r = align_batch([(c["t"], c["q"])], Options(cigar=True, step=16),
                    device="cpu")[0]
    e = goldens["runs"]["lowmem_p16"][i]
    assert (r.s, r.cigar_str) == (e["s"], e["cigar"])
