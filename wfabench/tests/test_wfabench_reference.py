"""The plain reference against the C oracle's goldens and, at small
sizes, against the program's plain versions in every mode."""

import json
import os

import pytest
import torch

from _tiny import ROOT
from wfabench import gen
from wfabench.reference import wfa

torch.set_num_threads(1)
PENS = wfa.Pens()


def cigar_str(c):
    return "".join(f"{x >> 4}{'MIDNSHP=XB'[x & 15]}" for x in c)


def test_t3_golden_every_mode():
    g = json.load(open(os.path.join(ROOT, "tests", "data", "goldens.json")))
    t3 = next(c for c in g["cases"] if c["name"] == "t3")
    pair = [(t3["t"].encode(), t3["q"].encode())]
    a = wfa.align(pair, PENS, False, 0, "cpu", s_cap=512)[0]
    assert (a.s, a.n_iter, a.cigar) == (155, 16875, None)
    a = wfa.align(pair, PENS, True, 0, "cpu", s_cap=512)[0]
    assert (a.s, a.n_iter) == (155, 16875)
    assert cigar_str(a.cigar) == "1X16=1X14=128I4=1X24="
    for step in (16, 32):
        a = wfa.align(pair, PENS, True, step, "cpu", s_cap=512)[0]
        assert a.s == 155 and cigar_str(a.cigar) == "1X16=1X14=128I4=1X24="


def test_bench_goldens_8000_scores():
    from miniwfa_tpu_torch.tools.pairs import make_pairs
    gold = json.load(open(os.path.join(ROOT, "tests", "data",
                                       "bench_goldens.json")))["8000"]
    pairs = [(t.encode(), q.encode()) for t, q in make_pairs(8000, 3)]
    got = wfa.align(pairs, PENS, False, 0, "cpu", s_cap=2048)
    assert [a.s for a in got] == [g["s"] for g in gold[:3]]


@pytest.mark.parametrize("cigar,step", [(False, 0), (True, 0), (True, 50)])
def test_matches_the_programs_plain_versions(cigar, step):
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.models.exact import align_batch
    pairs = gen.make_pool({"target_bp": 900, "sub_rate": 0.02,
                           "indel_rate": 0.002, "indel_len": [1, 8]}, 2, 7)
    pairs += gen.make_pool({"target_bp": 1500, "novel_at": 500,
                            "novel_bp": 150, "sub_rate": 0.015,
                            "indel_rate": 0.001, "indel_len": [1, 8]}, 1, 8)
    prog = align_batch(pairs, Options(cigar=cigar, step=step), device="cpu")
    ref = wfa.align(pairs, PENS, cigar, step, "cpu", s_cap=1024)
    assert [(r.s, r.n_iter, r.cigar) for r in prog] == \
        [(a.s, a.n_iter, a.cigar) for a in ref]


def test_pool_is_the_seeds():
    cfg = {"target_bp": 3000, "novel_at": 1000, "novel_bp": 300,
           "sub_rate": 0.015, "indel_rate": 0.001, "indel_len": [1, 8]}
    a = gen.make_pool(cfg, 2, 2**31 + 99)
    assert a == gen.make_pool(cfg, 2, 2**31 + 99)
    assert a != gen.make_pool(cfg, 2, 2**31 + 98)
    assert all(len(t) == 3000 for t, _ in a)
    # the same number of indels and substitutions for every seed
    assert len({len(q) for s in (1, 2, 3) for _, q in
                gen.make_pool(cfg, 1, s)}) == 1
    assert gen.make_pool(cfg, 1, -5) == gen.make_pool(cfg, 1, 2**64 - 5)
