"""The port's plain wavefront kernel against the JAX package's Pallas kernel.

The same pairs go through ``miniwfa_tpu.ops.wavefront_kernel`` in
interpret mode (as tests/test_kernel_interpret.py runs it) and, with the
inputs carried over by ``miniwfa_tpu_torch.convert``, through
``miniwfa_tpu_torch.ops.wavefront_kernel.wavefront`` on CPU tensors (its
plain PyTorch version).  Tolerance: exact equality of every per-lane
output (n_iter as the 30-bit O_NLO/O_NHI halves) and of every traceback
byte inside the band the port records for its row.  W=1024 and small
cycle budgets keep the interpreter fast.
"""

import json
import os

import numpy as np
import pytest
import torch

from miniwfa_tpu.ops import pack as jpack
from miniwfa_tpu.ops import wavefront_kernel as jwk
from miniwfa_tpu_torch import convert
from miniwfa_tpu_torch.ops import wavefront_kernel as wk

torch.set_num_threads(1)   # as in test_torch_chain.py

WR, W = 8, 1024
PENS = dict(x=4, o1=4, e1=2, o2=15, e2=1)
NAMES_SCORE = ["t3", "identity4", "ins4", "mixed", "del4", "empty_t",
               "homopoly", "small0", "small7", "small44", "unrel5", "binary",
               "lower_n"]
NAMES_CIGAR = ["t3", "ins4", "mixed", "homopoly", "small7", "unrel5"]

with open(os.path.join(os.path.dirname(__file__), "data",
                       "goldens.json")) as _f:
    _CASES = {c["name"]: c for c in json.load(_f)["cases"]}


def _pair(name):
    c = _CASES[name]
    return c["t"].encode("latin1"), c["q"].encode("latin1")


def run_both(t, q, mode, *, S_CAP=512, anc=None, max_s=0, max_iter=0,
             pens=PENS):
    """One pair through the JAX kernel (interpret mode) and the port.
    Returns (jax row [1,10], jax tb [1,S,W] or None, port out, port tb,
    port bands)."""
    cpw = 16 if jpack.can_pack2([t, q]) else 4
    spec = jwk.KSpec(B=1, WR=WR, S_CAP=S_CAP, mode=mode, cpw=cpw, **pens)
    scal = np.zeros((1, jwk.SC_SEG + 2), np.int32)
    scal[0, jwk.SC_TL], scal[0, jwk.SC_QL] = len(t), len(q)
    scal[0, jwk.SC_ANC] = (len(q) - len(t)) // 2 - W // 2 if anc is None \
        else anc
    scal[0, jwk.SC_MS] = max_s
    scal[0, jwk.SC_MILO] = max_iter & 0x3FFFFFFF
    scal[0, jwk.SC_MIHI] = max_iter >> 30
    twt, twq = jwk.pack_table([t], cpw), jwk.pack_table([q], cpw)
    raw = jwk.get_kernel(spec, interpret=True).raw(scal, twt, twq)
    jrow = np.asarray(raw[0])
    jtb = convert.tb_from_packed(np.asarray(raw[1])) if mode == jwk.MODE_TB \
        else None
    pspec = wk.KSpec(W=W, S_CAP=S_CAP, mode=mode, cpw=cpw, **pens)
    out, tb, bands, _ = wk.wavefront(
        pspec, torch.from_numpy(convert.lanes_from_scal(scal)),
        torch.from_numpy(convert.words_from_table(twt)),
        torch.from_numpy(convert.words_from_table(twq)))
    return jrow, jtb, out.numpy(), tb, bands


def _assert_rows(jrow, out):
    got = convert.row_from_out(out)
    assert np.array_equal(got, jrow), (got.tolist(), jrow.tolist())
    assert np.array_equal(convert.out_from_row(jrow), out)


@pytest.mark.parametrize("name", NAMES_SCORE)
def test_score_outputs_match_jax_kernel(name):
    t, q = _pair(name)
    jrow, _, out, tb, _ = run_both(t, q, jwk.MODE_SCORE)
    assert out[0, wk.O_DONE] == 1 and tb is None
    _assert_rows(jrow, out)


@pytest.mark.parametrize("name", NAMES_CIGAR)
def test_tb_bytes_match_jax_kernel(name):
    t, q = _pair(name)
    jrow, jtb, out, tb, bands = run_both(t, q, jwk.MODE_TB)
    _assert_rows(jrow, out)
    s = int(out[0, wk.O_S])
    anc = (len(q) - len(t)) // 2 - W // 2
    lo = bands[0, :s, 0].long() - anc
    hi = bands[0, :s, 1].long() - anc
    col = torch.arange(W)
    in_band = (col >= lo[:, None]) & (col <= hi[:, None])
    assert bool(in_band.any(1).all())          # every row holds a band
    ptb = tb[0, :s].numpy()
    assert np.array_equal(ptb[in_band.numpy()], jtb[0, :s][in_band.numpy()])


@pytest.mark.parametrize("side,anc", [("low", -3), ("high", -W + 4)])
def test_forced_band_overflow(side, anc):
    t, q = _pair("t3")
    jrow, _, out, _, _ = run_both(t, q, jwk.MODE_SCORE, anc=anc)
    assert out[0, wk.O_OVFB] == 1, side
    _assert_rows(jrow, out)


def test_forced_cycle_budget_overflow():
    t, q = _pair("t3")
    jrow, _, out, _, _ = run_both(t, q, jwk.MODE_SCORE, S_CAP=32)
    assert out[0, wk.O_OVFS] == 1
    _assert_rows(jrow, out)


@pytest.mark.parametrize("bound", [dict(max_s=50), dict(max_iter=2000)])
def test_early_stops(bound):
    t, q = _pair("t3")
    jrow, _, out, _, _ = run_both(t, q, jwk.MODE_SCORE, **bound)
    assert out[0, wk.O_STOP] == 1 and out[0, wk.O_S] == -1
    _assert_rows(jrow, out)


def test_unsupported_device_raises():
    """A wrapper never falls back: a non-CPU, non-CUDA device raises."""
    spec = wk.KSpec(W=W, S_CAP=8, **PENS)
    lanes = torch.zeros((1, wk.L_N), dtype=torch.int64, device="meta")
    words = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        wk.wavefront(spec, lanes, words, words)


@pytest.mark.parametrize("regime,pens", [
    ("edit", dict(x=1, o1=0, e1=1, o2=0, e2=1)),      # every age is 1
    ("affine", dict(x=4, o1=4, e1=2, o2=4, e2=2))])
def test_tb_bytes_other_penalties(regime, pens):
    t, q = _pair("t3")
    jrow, jtb, out, tb, bands = run_both(t, q, jwk.MODE_TB, pens=pens)
    _assert_rows(jrow, out)
    s = int(out[0, wk.O_S])
    anc = (len(q) - len(t)) // 2 - W // 2
    col = torch.arange(W)
    in_band = ((col >= bands[0, :s, 0:1].long() - anc)
               & (col <= bands[0, :s, 1:2].long() - anc)).numpy()
    assert np.array_equal(tb[0, :s].numpy()[in_band], jtb[0, :s][in_band]), \
        regime
