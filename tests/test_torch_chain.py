"""The port's chaining heuristic (``-u``) and auto mode (``-t``) on the
CPU, through the plain PyTorch versions of their kernels.

Held against the reference goldens (runs ``chain`` and ``auto``, score
and CIGAR), against the JAX package's ``align_chain_batch`` /
``align_auto_batch`` ((score, CIGAR, n_iter) on a subset, one batched
call each), and the k-mer primitives against the JAX package's, over the
native runtime and over numpy.  Tolerance: exact equality.
"""

import random

import numpy as np
import pytest
import torch

from miniwfa_tpu import Options as JOptions
from miniwfa_tpu.models import auto as jauto
from miniwfa_tpu.models import chain as jchain
from miniwfa_tpu.ops import kmer as jkmer
from miniwfa_tpu_torch import Options, align_auto, align_chain
from miniwfa_tpu_torch import cigar as C
from miniwfa_tpu_torch.models import auto, chain, exact
from miniwfa_tpu_torch.models.auto import align_auto_batch
from miniwfa_tpu_torch.models.chain import align_chain_batch
from miniwfa_tpu_torch.models.exact import Result
from miniwfa_tpu_torch.ops import kmer
from miniwfa_tpu_torch.utils import native

# The plain versions run many small ops, and the suite runs several test
# processes side by side: one intra-op thread each keeps them from
# oversubscribing the cores.
torch.set_num_threads(1)


def _mutated_pair(seed, n, alphabet="ACGT"):
    """A random target with a few repeats, and a copy with 3%
    substitutions and short indels."""
    rng = random.Random(seed)
    t = "".join(rng.choice(alphabet) for _ in range(n))
    unit = t[100:180]
    t = t[:1000] + unit * 4 + t[1000:]
    q = []
    for c in t:
        r = rng.random()
        if r < 0.03:
            q.append(rng.choice(alphabet))
        elif r < 0.035:
            q.append(c + rng.choice(alphabet))
        elif r > 0.995:
            continue
        else:
            q.append(c)
    return t.encode(), "".join(q).encode()


@pytest.fixture(params=["native", "numpy"])
def kmer_route(request, monkeypatch):
    if request.param == "native":
        if not native.available():
            pytest.skip("g++ is not available to build the native runtime")
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("alphabet", ["ACGT", "ACGTNacgt"])
def test_kmer_primitives_match_jax(kmer_route, alphabet):
    t, q = _mutated_pair(5, 3000, alphabet)
    for k, occ in ((13, 2), (11, 3)):
        mp = kmer.match_pairs(t, q, k, occ)
        assert np.array_equal(mp, jkmer.match_pairs(t, q, k, occ))
        swapped = (mp >> np.uint64(32)) | (mp << np.uint64(32))
        assert np.array_equal(kmer.lis_indices(swapped),
                              jkmer.lis_indices(swapped))
        anchors = kmer.chain(t, q, k, occ)
        assert np.array_equal(anchors, jkmer.chain(t, q, k, occ))
        for min_len in (0, 30, 200):
            assert np.array_equal(
                kmer.anchor_filter(anchors, len(t), len(q), k, min_len),
                jkmer.anchor_filter(anchors, len(t), len(q), k, min_len))
    rng = np.random.default_rng(1)
    a = rng.integers(0, 50, 200).astype(np.uint64)
    assert np.array_equal(kmer.lis_indices(a), jkmer.lis_indices(a))
    assert kmer.lis_indices(np.zeros(0, np.uint64)).size == 0
    assert kmer.chain(b"ACG", q, 13, 2).size == 0


@pytest.mark.parametrize("run,fn", [("chain", align_chain_batch),
                                    ("auto", align_auto_batch)])
def test_goldens(goldens, run, fn):
    opt = Options(cigar=True)
    cases = goldens["cases"]
    res = fn([(c["t"], c["q"]) for c in cases], opt, device="cpu")
    bad = []
    for c, r, e in zip(cases, res, goldens["runs"][run]):
        if (r.s, r.cigar_str) != (e["s"], e["cigar"]):
            bad.append(f"{c['name']}: ({r.s}, {r.cigar_str}) != "
                       f"({e['s']}, {e['cigar']})")
        else:
            C.assert_cigar(opt, r.cigar, len(c["t"]), len(c["q"]), r.s,
                           c["t"].encode("latin1"), c["q"].encode("latin1"))
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("run,fn,jfn", [
    ("chain", align_chain_batch, jchain.align_chain_batch),
    ("auto", align_auto_batch, jauto.align_auto_batch)])
def test_matches_jax_batch(goldens, run, fn, jfn):
    pairs = [(c["t"], c["q"]) for c in goldens["cases"]
             if max(len(c["t"]), len(c["q"])) <= 256 or c["name"] == "med2k"]
    got = fn(pairs, Options(cigar=True), device="cpu")
    want = jfn(pairs, JOptions(cigar=True))
    assert [(r.s, r.cigar, r.n_iter) for r in got] == \
        [(r.s, r.cigar, r.n_iter) for r in want]


def test_chain_score_only(goldens):
    i, c = next((i, c) for i, c in enumerate(goldens["cases"])
                if c["name"] == "med2k")
    r = align_chain(c["t"], c["q"], Options(), device="cpu")
    assert r.s == goldens["runs"]["chain"][i]["s"] and r.cigar is None
    rc = align_chain(c["t"], c["q"], Options(cigar=True), device="cpu")
    assert rc.n_iter == r.n_iter > 0


def _sequential(opt, pi, kinds, dx, dy, gap_map):
    """The reference's per-segment walk (miniwfa.c:861-891): push with
    run merge, extend with seam merge."""
    s, n_iter, cig = 0, 0, []
    for i, kind in enumerate(kinds):
        if kind == chain.K_EQ:
            C.push(cig, C.OP_EQ, int(dx[i]))
        elif kind == chain.K_SKIP:
            C.push(cig, C.OP_D, int(dx[i]))
            C.push(cig, C.OP_I, int(dy[i]))
            s += opt.o2 * 2 + opt.e2 * int(dx[i] + dy[i])
        elif kind == chain.K_ALIGN:
            r = gap_map[(pi, i)]
            C.extend(cig, r.cigar)
            s += r.s
            n_iter += r.n_iter
        elif kind == chain.K_DEL:
            C.push(cig, C.OP_D, int(dx[i]))
            s += opt.gap_cost(int(dx[i]))
        elif kind == chain.K_INS:
            C.push(cig, C.OP_I, int(dy[i]))
            s += opt.gap_cost(int(dy[i]))
    return s, n_iter, cig


@pytest.mark.parametrize("seed", range(2))
def test_assembly_matches_sequential_walk(seed):
    rng = random.Random(seed)
    opt = Options(cigar=True)
    for _ in range(100):
        n = rng.randint(1, 40)
        kinds = np.array([rng.randrange(6) for _ in range(n)], np.int64)
        dx = np.array([rng.randint(1, 50) for _ in range(n)], np.int64)
        dy = np.array([rng.randint(1, 50) for _ in range(n)], np.int64)
        dx[kinds == chain.K_NONE] = dy[kinds == chain.K_NONE] = 0
        gap_map = {}
        for i in np.nonzero(kinds == chain.K_ALIGN)[0]:
            cg = []   # sometimes empty; seams may merge with neighbours
            for _ in range(rng.randint(0, 5)):
                C.push(cg, rng.choice([C.OP_EQ, C.OP_X, C.OP_I, C.OP_D]),
                       rng.randint(1, 9))
            gap_map[(0, int(i))] = Result(s=rng.randint(0, 100), cigar=cg,
                                          n_iter=rng.randint(0, 999))
        got = chain._assemble_pair(opt, 0, kinds, dx, dy, gap_map)
        assert (got.s, got.n_iter, got.cigar) == \
            _sequential(opt, 0, kinds, dx, dy, gap_map)


@pytest.mark.parametrize("name", ["del50k", "div100k", "sv300k", "rep200k",
                                  "nbear1m", "div5m"])
def test_chip_smoke_generators_match(name):
    """chip_smoke.py's jax-free restatements of the scale fixtures and of
    the benchmark pairs give the same sequences as the originals."""
    import bench
    import chip_smoke
    from tools import make_scale_goldens
    assert chip_smoke.gen_case(name) == make_scale_goldens.gen_case(name)
    if name == "div100k":
        assert chip_smoke.make_pairs(8000, 64) == bench.make_pairs(8000, 64)


def test_band_limit_stop(goldens, monkeypatch):
    """A lane whose band outgrows the device's largest window: "raise"
    raises and "stop" returns s=-1.  Auto falls back to chaining for a
    lane its probe stops."""
    c = next(c for c in goldens["cases"] if c["name"] == "t3")
    small = ("ACGTACGT", "ACGAACGT")
    monkeypatch.setattr(exact, "_device_w_cap", lambda mode, device: 64)
    pairs = [(c["t"], c["q"]), small]
    with pytest.raises(RuntimeError, match="align_auto"):
        exact.align_batch(pairs, Options(), device="cpu")
    res = exact.align_batch(pairs, Options(), band_limit="stop",
                            device="cpu")
    assert res[0].s == -1 and res[0].cigar is None
    assert res[1].s == exact.align_batch([small], Options(),
                                         device="cpu")[0].s
    with pytest.raises(ValueError):
        exact.align_batch(pairs, Options(), band_limit="fail", device="cpu")
    monkeypatch.undo()
    monkeypatch.setattr(auto, "CELL_BUDGET", 100)
    r = align_auto(c["t"], c["q"], Options(cigar=True), device="cpu")
    assert (r.s, r.cigar_str) == (155, "1X16=1X18=128I1X24=")
