"""Penalty sets with a large gap-open cost (max_pen 41 and 101) through the
port on the CPU, against the JAX package's batch aligners and the DP oracle.

The shrink scan's viability is one plane of last-viable scores, so no
penalty set is bounded by a bit width: t3 and four more goldens cases at
o2=40 e2=1 and o2=100 e2=1 run in exact score, CIGAR, low-mem (step 16),
chain and auto modes.  Each result equals the JAX package's ``align_batch``
/ ``align_chain_batch`` / ``align_auto_batch`` on the CPU in s, CIGAR and
n_iter, and each exact score equals ``tools/dp_oracle.dp_score``.
Tolerance: exact.  Every pair ends before cycle 256, so the two sides'
known n_iter difference past a shrink (ROADMAP §3) cannot show.
"""

import json
import os
import sys

import pytest
import torch

from miniwfa_tpu import Options as JOptions
from miniwfa_tpu.models import auto as jauto
from miniwfa_tpu.models import chain as jchain
from miniwfa_tpu.models import exact as jexact
from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import auto, chain, exact

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.dp_oracle import dp_score  # noqa: E402

torch.set_num_threads(1)   # as in test_torch_chain.py

NAMES = ["t3", "small44", "small10", "unrel5", "homopoly"]
# t3's (s, CIGAR, n_iter) from the JAX package, by o2 and mode
_EX, _CH = "1X16=1X14=128I4=1X24=", "1X16=1X18=128I1X24="
T3 = {40: {"score": (180, None, 18100), "cigar": (180, _EX, 18100),
           "p16": (180, _EX, 17836), "chain": (180, _CH, 11818),
           "auto": (180, _EX, 18100)},
      100: {"score": (240, None, 25510), "cigar": (240, _EX, 25510),
            "p16": (240, _EX, 24900), "chain": (240, _CH, 16708),
            "auto": (240, _EX, 25510)}}
MODES = {"score": (dict(), "align_batch"),
         "cigar": (dict(cigar=True), "align_batch"),
         "p16": (dict(cigar=True, step=16), "align_batch"),
         "chain": (dict(cigar=True), "align_chain_batch"),
         "auto": (dict(cigar=True), "align_auto_batch")}
PORT = {"align_batch": exact.align_batch,
        "align_chain_batch": chain.align_chain_batch,
        "align_auto_batch": auto.align_auto_batch}
JAX = {"align_batch": jexact.align_batch,
       "align_chain_batch": jchain.align_chain_batch,
       "align_auto_batch": jauto.align_auto_batch}

with open(os.path.join(os.path.dirname(__file__), "data",
                       "goldens.json")) as _f:
    _CASES = {c["name"]: c for c in json.load(_f)["cases"]}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("o2", [40, 100])
def test_large_gap_open_matches_jax(o2, mode):
    kw, fn = MODES[mode]
    pairs = [(_CASES[n]["t"], _CASES[n]["q"]) for n in NAMES]
    got = PORT[fn](pairs, Options(o2=o2, e2=1, **kw), device="cpu")
    want = JAX[fn](pairs, JOptions(o2=o2, e2=1, **kw))
    for name, g, w in zip(NAMES, got, want):
        assert (g.s, g.cigar_str, g.n_iter) == \
            (w.s, w.cigar_str, w.n_iter), name
        assert g.s < 256, name
    if mode != "chain":      # chaining is a heuristic: its score may differ
        for (t, q), g in zip(pairs, got):
            assert g.s == dp_score(t.encode("latin1"), q.encode("latin1"),
                                   4, 4, 2, o2, 1)
    assert (got[0].s, got[0].cigar_str, got[0].n_iter) == T3[o2][mode]
