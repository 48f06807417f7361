"""The port's plain CIGAR walker against the JAX package's walker.

Traceback buffers come from the JAX package's Pallas kernel in interpret
mode.  ``miniwfa_tpu.ops.traceback_device.walk_batch_on_device`` (plain
JAX, runs on the CPU) walks them in the kernel's packed layout;
``miniwfa_tpu_torch.ops.traceback_device.walk`` walks the same bytes in
the port's layout (``convert.tb_from_packed``) on CPU tensors, i.e. its
plain PyTorch version; the port's host walker ``traceback_walk`` is the
specification.  Tolerance: identical run lists, equal to the goldens.
"""

import json
import os

import numpy as np
import pytest
import torch

from miniwfa_tpu.ops import pack as jpack
from miniwfa_tpu.ops import traceback_device as jtbd
from miniwfa_tpu.ops import wavefront_kernel as jwk
from miniwfa_tpu_torch import Options, cigar as C, convert
from miniwfa_tpu_torch.models.traceback import traceback_walk
from miniwfa_tpu_torch.ops import pack
from miniwfa_tpu_torch.ops import traceback_device as tbd

torch.set_num_threads(1)   # as in test_torch_chain.py

WR, W, S_CAP = 8, 1024, 512

with open(os.path.join(os.path.dirname(__file__), "data",
                       "goldens.json")) as _f:
    _G = json.load(_f)
_IDX = {c["name"]: i for i, c in enumerate(_G["cases"])}

REGIMES = {"cigar": Options(cigar=True),
           "edit_cigar": Options(cigar=True).as_edit_distance(),
           "affine_cigar": Options(cigar=True).as_single_affine()}
CASES = [("cigar", n) for n in
         ["t3", "ins4", "mixed", "homopoly", "small7", "unrel5", "lower_n",
          "empty_t", "del4"]] + \
    [(r, n) for r in ("edit_cigar", "affine_cigar") for n in ("t3", "small44")]


@pytest.mark.parametrize("run,name", CASES)
def test_walkers_agree(run, name):
    opt = REGIMES[run]
    case = _G["cases"][_IDX[name]]
    t, q = case["t"].encode("latin1"), case["q"].encode("latin1")
    pens = (opt.x, opt.o1, opt.e1, opt.o2, opt.e2)
    cpw = 16 if jpack.can_pack2([t, q]) else 4
    spec = jwk.KSpec(B=1, WR=WR, S_CAP=S_CAP, x=opt.x, o1=opt.o1, e1=opt.e1,
                     o2=opt.o2, e2=opt.e2, mode=jwk.MODE_TB, cpw=cpw)
    anc = (len(q) - len(t)) // 2 - W // 2
    scal = np.zeros((1, jwk.SC_SEG + 2), np.int32)
    scal[0, :3] = (len(t), len(q), anc)
    row, tb_packed = jwk.get_kernel(spec, interpret=True).raw(
        scal, jwk.pack_table([t], cpw), jwk.pack_table([q], cpw))
    row = np.asarray(row)
    s, ls = int(row[0, jwk.O_S]), int(row[0, jwk.O_LS])
    assert row[0, jwk.O_DONE] == 1

    want = jtbd.walk_batch_on_device(tb_packed, [anc], [t], [q], [s], [ls],
                                     cpw, pens)[0]
    tb = torch.from_numpy(convert.tb_from_packed(np.asarray(tb_packed)))
    meta = torch.tensor([[anc, len(t), len(q), s, ls]], dtype=torch.int64)
    mx = max(len(t), len(q))
    runs, counts = tbd.walk(
        tb, meta, torch.from_numpy(pack.pack_words([t], cpw, mx)),
        torch.from_numpy(pack.pack_words([q], cpw, mx)), cpw, pens)
    got = tbd.to_cigars(runs, counts)[0]
    spec_walk = traceback_walk(opt, tb[0, :max(s, 1)].numpy(),
                               np.full(max(s, 1), anc, np.int32), 0, t, q,
                               s, ls)
    assert got == want == spec_walk
    assert C.to_string(got) == _G["runs"][run][_IDX[name]]["cigar"]


def test_walk_buffer_overflow_raises():
    """A corrupt table that walks past its run buffer raises."""
    runs = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError):
        tbd.to_cigars(runs, torch.tensor([-1], dtype=torch.int32))


@pytest.mark.parametrize("run,name", [("cigar", "t3"), ("cigar", "mixed"),
                                      ("edit_cigar", "small44")])
def test_walk_plain_buffer_is_in_input_order(run, name):
    """The plain walker's buffer holds the JAX walker's runs in input
    order from offset 0, zeros past the count."""
    opt = REGIMES[run]
    case = _G["cases"][_IDX[name]]
    t, q = case["t"].encode("latin1"), case["q"].encode("latin1")
    pens = (opt.x, opt.o1, opt.e1, opt.o2, opt.e2)
    cpw = 16 if jpack.can_pack2([t, q]) else 4
    spec = jwk.KSpec(B=1, WR=WR, S_CAP=S_CAP, x=opt.x, o1=opt.o1, e1=opt.e1,
                     o2=opt.o2, e2=opt.e2, mode=jwk.MODE_TB, cpw=cpw)
    anc = (len(q) - len(t)) // 2 - W // 2
    scal = np.zeros((1, jwk.SC_SEG + 2), np.int32)
    scal[0, :3] = (len(t), len(q), anc)
    row, tb_packed = jwk.get_kernel(spec, interpret=True).raw(
        scal, jwk.pack_table([t], cpw), jwk.pack_table([q], cpw))
    row = np.asarray(row)
    s, ls = int(row[0, jwk.O_S]), int(row[0, jwk.O_LS])
    want = jtbd.walk_batch_on_device(tb_packed, [anc], [t], [q], [s], [ls],
                                     cpw, pens)[0]
    tb = torch.from_numpy(convert.tb_from_packed(np.asarray(tb_packed)))
    meta = torch.tensor([[anc, len(t), len(q), s, ls]], dtype=torch.int64)
    mx = max(len(t), len(q))
    runs, counts = tbd.walk_plain(
        tb, meta, torch.from_numpy(pack.pack_words([t], cpw, mx)),
        torch.from_numpy(pack.pack_words([q], cpw, mx)), cpw, pens)
    n = int(counts[0])
    assert n == len(want) > 0
    assert runs[0, :n].tolist() == want
    assert not bool(runs[0, n:].any())


def test_to_cigars_matches_the_per_lane_conversion():
    """On a seeded batch of 64 lanes: the runs in input order through
    to_cigars equal the former per-lane conversion of the same runs
    written newest first (a slice, flipped, per lane)."""
    rng = np.random.default_rng(3)
    B, CAP = 64, 200
    counts = torch.from_numpy(rng.integers(0, CAP + 1, B).astype(np.int32))
    counts[5] = 0
    counts[7] = CAP
    newest = torch.from_numpy(
        (rng.integers(1, 1000, (B, CAP)) << 4
         | rng.choice([1, 2, 7, 8], (B, CAP))).astype(np.int32))
    old = [newest[b, :int(counts[b])].flip(0).tolist() for b in range(B)]
    j = torch.arange(CAP)
    c = counts.long()[:, None]
    ordered = newest.gather(1, torch.where(j < c, c - 1 - j, j))
    assert tbd.to_cigars(ordered, counts) == old
    assert all(type(v) is int for lane in old for v in lane)


def test_walk_variant_is_checked():
    """A bad variant raises on any device; "warp" and "thread" on CPU
    tensors take the plain version."""
    case = _G["cases"][_IDX["t3"]]
    t, q = case["t"].encode("latin1"), case["q"].encode("latin1")
    tb = torch.zeros((1, 16, 64), dtype=torch.uint8)
    meta = torch.tensor([[-len(t), len(t), len(q), 0, 0]], dtype=torch.int64)
    mx = max(len(t), len(q))
    tw = torch.from_numpy(pack.pack_words([t], 4, mx))
    qw = torch.from_numpy(pack.pack_words([q], 4, mx))
    pens = (4, 6, 2, 24, 1)
    for bad in ("block", "WARP", 1):
        with pytest.raises(ValueError):
            tbd.walk(tb, meta, tw, qw, 4, pens, variant=bad)
    want = tbd.walk_plain(tb, meta, tw, qw, 4, pens)
    for v in (None,) + tbd.VARIANTS:
        got = tbd.walk(tb, meta, tw, qw, 4, pens, variant=v)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("W,length,cpw,want", [
    (128, 127, 16, "thread"),       # K3's gaps
    (128, 127, 4, "thread"),
    (32768, 100_000, 16, "warp"),   # the main path's K1 tb
    (512, 1000, 4, "warp"),         # K1 gap fills of the chain mode
    (1000, 100_000, 16, "thread"),  # W no multiple of 16
])
def test_pick_variant_from_the_shapes(W, length, cpw, want):
    assert tbd.pick_variant(W, pack.n_words(length, cpw), cpw) == want
