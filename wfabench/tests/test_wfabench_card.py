"""On the card: the reference against the program at 8 kb in every mode,
and one short run of each one-card cell.  Marked ``cuda``; skips without
a card."""

import io
import json
import time

import pytest
import torch

from _tiny import SEED
from wfabench import gen, harness
from wfabench.reference import wfa

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.parametrize("cigar,step", [(False, 0), (True, 0), (True, 500)])
def test_reference_matches_the_program_on_the_card(card, cigar, step):
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.models.exact import align_batch
    pairs = gen.make_pool({"target_bp": 8000, "sub_rate": 0.02,
                           "indel_rate": 0.002, "indel_len": [1, 8]}, 4, 3)
    prog = align_batch(pairs, Options(cigar=cigar, step=step), device=card)
    ref = wfa.align(pairs, wfa.Pens(), cigar, step, card, s_cap=2048)
    assert [(r.s, r.n_iter, r.cigar) for r in prog] == \
        [(a.s, a.n_iter, a.cigar) for a in ref]


@pytest.mark.parametrize("cell", ["pairs100k-score", "pairs100k-cigar"])
def test_short_run_on_the_card(card, cell):
    out = io.StringIO()
    rc = harness.run_cell(cell, SEED, 1.0, False, [card],
                          time.perf_counter(), out=out, err=io.StringIO())
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"
