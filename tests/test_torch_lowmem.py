"""The port's low-memory stripe mode (``step > 0``, CLI ``-p``) on the CPU,
through the plain PyTorch versions of its kernels.

Held against the reference goldens (runs lowmem_p1/p3/p16/p100), against
the high-mem mode (the huge-step shortcut), against the JAX package's
pass 1 (``miniwfa_tpu.models.exact._run_pass1``: checkpoint lists and
scores), and against the JAX package's Pallas kernel in interpret mode:
PASS1 (final_s, snap_cnt and the decoded checkpoint lists; the two
packages lay their snapshots out differently, so they meet at
``(score, diagonal)`` checkpoints) and TB with those checkpoints (every
output and every in-band traceback byte).  Tolerance: exact equality.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from miniwfa_tpu import Options as JOptions
from miniwfa_tpu.models import exact as jexact
from miniwfa_tpu.models import traceback as jtbk
from miniwfa_tpu.ops import pack as jpack
from miniwfa_tpu.ops import wavefront_kernel as jwk
from miniwfa_tpu_torch import Options, cigar as C, convert
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.models import traceback as tbk
from miniwfa_tpu_torch.models.exact import align_batch
from miniwfa_tpu_torch.ops import traceback_device as tbd
from miniwfa_tpu_torch.ops import wavefront_kernel as wk

torch.set_num_threads(1)   # as in test_torch_chain.py

WR, W = 8, 1024
PENS = dict(x=4, o1=4, e1=2, o2=15, e2=1)
NAMES_LOWMEM = ["t3", "small44"]


def _case(goldens, name):
    return next((i, c) for i, c in enumerate(goldens["cases"])
                if c["name"] == name)


@pytest.mark.parametrize("step,small", [(1, True), (3, True), (16, True),
                                        (100, False)])
def test_lowmem_goldens(goldens, step, small):
    sel = [(i, c) for i, c in enumerate(goldens["cases"])
           if not small or max(len(c["t"]), len(c["q"])) <= 256]
    opt = Options(cigar=True, step=step)
    res = align_batch([(c["t"], c["q"]) for _, c in sel], opt, device="cpu")
    exp = goldens["runs"][f"lowmem_p{step}"]
    bad = []
    for (i, c), r in zip(sel, res):
        e = exp[i]
        if r.s != e["s"] or (e["cigar"] is not None
                             and r.cigar_str != e["cigar"]):
            bad.append(f"{c['name']}: ({r.s}, {r.cigar_str}) != "
                       f"({e['s']}, {e['cigar']})")
        else:
            C.assert_cigar(opt, r.cigar, len(c["t"]), len(c["q"]), r.s,
                           c["t"].encode("latin1"), c["q"].encode("latin1"))
    assert not bad, "\n".join(bad)


def test_lowmem_huge_step_shortcut(goldens):
    """A step above every pair's score bound skips pass 1: score, CIGAR
    and n_iter equal the high-mem run's (and the goldens)."""
    pairs = [(c["t"], c["q"]) for c in goldens["cases"]]
    lm = align_batch(pairs, Options(cigar=True, step=10_000_000),
                     device="cpu")
    hm = align_batch(pairs, Options(cigar=True), device="cpu")
    for c, a, b, e in zip(goldens["cases"], lm, hm,
                          goldens["runs"]["cigar"]):
        assert (a.s, a.cigar_str, a.n_iter) == (b.s, b.cigar_str, b.n_iter), \
            c["name"]
        assert (a.s, a.cigar_str) == (e["s"], e["cigar"]), c["name"]


def _random_pairs(seed, n):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(n):
        t = rng.choice(acgt, int(rng.integers(40, 120)))
        q = t.copy()
        sub = rng.random(len(q)) < 0.12
        q[sub] = rng.choice(acgt, int(sub.sum()))
        q = np.delete(q, rng.choice(len(q), int(rng.integers(0, 6)),
                                    replace=False))
        q = np.insert(q, int(rng.integers(0, len(q))),
                      rng.choice(acgt, int(rng.integers(0, 7))))
        pairs.append((t.tobytes(), q.tobytes()))
    return pairs


@pytest.mark.parametrize("batch,step", [("random", 7), ("t3", 16)])
def test_pass1_matches_jax_run_pass1(goldens, batch, step):
    if batch == "random":
        pairs = _random_pairs(23, 8)
    else:
        c = _case(goldens, "t3")[1]
        pairs = [(c["t"].encode(), c["q"].encode())]
    ts, qs = [t for t, _ in pairs], [q for _, q in pairs]
    jopt, opt = JOptions(cigar=True, step=step), Options(cigar=True,
                                                         step=step)
    jsegs, js = jexact._run_pass1(
        jopt, jexact._buckets_for(jopt, ts, qs, 512, 512), ts, qs)
    segs, s = exact._run_pass1(opt, ts, qs, 512, 512, torch.device("cpu"))
    assert s == js
    assert [[tuple(x) for x in sg] for sg in segs] == \
        [[tuple(map(int, x)) for x in sg] for sg in jsegs]
    assert any(segs)


def _inputs(t, q, S_CAP, seg_cap=1):
    """The JAX kernel's scal/word tables for one pair, and the port's
    lanes/word streams carried over by convert."""
    cpw = 16 if jpack.can_pack2([t, q]) else 4
    scal = np.zeros((1, jwk.SC_SEG + 2 * seg_cap), np.int32)
    scal[0, jwk.SC_TL], scal[0, jwk.SC_QL] = len(t), len(q)
    scal[0, jwk.SC_ANC] = (len(q) - len(t)) // 2 - W // 2
    twt, twq = jwk.pack_table([t], cpw), jwk.pack_table([q], cpw)
    port = (torch.from_numpy(convert.lanes_from_scal(scal)),
            torch.from_numpy(convert.words_from_table(twt)),
            torch.from_numpy(convert.words_from_table(twq)))
    return cpw, scal, twt, twq, port


def _pass1_rows(t, q, step, n_snap, S_CAP=512):
    """PASS1 through the JAX kernel (interpret mode) and the port's plain
    version; returns (jax spec, jax row, jax snapshot buffer, anchor, port
    spec, port outputs)."""
    cpw, scal, twt, twq, port = _inputs(t, q, S_CAP)
    jspec = jwk.KSpec(B=1, WR=WR, S_CAP=S_CAP, mode=jwk.MODE_PASS1, cpw=cpw,
                      step=step, n_snap=n_snap, **PENS)
    raw = jwk.get_kernel(jspec, interpret=True).raw(scal, twt, twq)
    pspec = wk.KSpec(W=W, S_CAP=S_CAP, mode=wk.MODE_PASS1, cpw=cpw,
                     step=step, n_snap=n_snap, **PENS)
    return (jspec, np.asarray(raw[0]), np.asarray(raw[1])[0],
            int(scal[0, jwk.SC_ANC]), pspec, wk.wavefront(pspec, *port))


def _pass1_both(t, q, step, S_CAP=512):
    """PASS1 through both packages; returns (jax row, jax checkpoints,
    port out, port checkpoints).  The JAX checkpoints come from the JAX
    package's own decoder of its snapshot layout."""
    n_snap = S_CAP // step + 2
    jspec, jrow, jsnap, anc, pspec, (out, tb, bands, snap) = _pass1_rows(
        t, q, step, n_snap, S_CAP)
    jsegs = jtbk.decode_checkpoints_kernel(
        jsnap.reshape(n_snap, -1), anc, int(jrow[0, jwk.O_SNC]),
        int(jrow[0, jwk.O_LP]), jspec)
    assert tb is None and bands is None
    assert tuple(snap.shape) == (1, n_snap, wk.snapshot_layout(pspec)[5], W)
    fin, recs = tbd.chain_ptrs(snap, out[:, wk.O_LP], out[:, wk.O_SNC])
    segs = tbk.decode_checkpoints_ptrs(recs[:, 0], int(fin[0]), anc,
                                       int(out[0, wk.O_SNC]), pspec)
    return jrow, jsegs, out.numpy(), segs


@pytest.mark.parametrize("name", NAMES_LOWMEM)
def test_pass1_matches_jax_kernel(goldens, name):
    c = _case(goldens, name)[1]
    t, q = c["t"].encode("latin1"), c["q"].encode("latin1")
    jrow, jsegs, out, segs = _pass1_both(t, q, 16)
    got = convert.row_from_out(out)
    # every column but last_ptr, which indexes each package's own layout
    keep = [j for j in range(convert.JO_N) if j != convert.JO_LP]
    assert np.array_equal(got[:, keep], jrow[:, keep])
    assert out[0, wk.O_SNC] == out[0, wk.O_S] // 16 > 0
    assert segs == [tuple(map(int, x)) for x in jsegs]


@pytest.mark.parametrize("name", NAMES_LOWMEM)
def test_tb_with_checkpoints_matches_jax_kernel(goldens, name):
    c = _case(goldens, name)[1]
    t, q = c["t"].encode("latin1"), c["q"].encode("latin1")
    segs = _pass1_both(t, q, 16)[3]
    S_CAP = 512
    cpw, _, twt, twq, port = _inputs(t, q, S_CAP)
    scal = convert.scal_from_lanes(port[0].numpy(), len(segs) + 1,
                                   exact.seg_input([segs]))
    assert scal[0, jwk.SC_NSEG] == len(segs)
    jspec = jwk.KSpec(B=1, WR=WR, S_CAP=S_CAP, mode=jwk.MODE_TB, cpw=cpw,
                      seg_cap=len(segs) + 1, use_seg=True, **PENS)
    raw = jwk.get_kernel(jspec, interpret=True).raw(scal, twt, twq)
    jrow, jtb = np.asarray(raw[0]), convert.tb_from_packed(np.asarray(raw[1]))
    pspec = wk.KSpec(W=W, S_CAP=S_CAP, mode=wk.MODE_TB, cpw=cpw, **PENS)
    sg = torch.from_numpy(convert.segs_from_scal(scal))
    out, tb, bands, snap = wk.wavefront(pspec, *port, sg)
    assert snap is None
    assert np.array_equal(convert.row_from_out(out.numpy()), jrow)
    s = int(out[0, wk.O_S])
    anc = int(scal[0, jwk.SC_ANC])
    col = torch.arange(W)
    in_band = ((col >= bands[0, :s, 0:1].long() - anc)
               & (col <= bands[0, :s, 1:2].long() - anc)).numpy()
    assert np.array_equal(tb[0, :s].numpy()[in_band], jtb[0, :s][in_band])
    # the collapse really narrows the band: fewer cells than high-mem
    full = wk.wavefront(pspec, *port)[0]
    assert full[0, wk.O_S] == s and full[0, wk.O_NITER] > out[0, wk.O_NITER]


def test_forced_snapshot_overflow_reruns(goldens, monkeypatch):
    """A pass-1 dispatch whose snapshot rows run out stops as a band
    overflow, as in the JAX kernel, and re-runs in an escalated bucket
    (whose rows are sized from its S_CAP again).  gap300's first window
    (512 of its 8192 diagonals) leaves the band room to grow."""
    i, c = _case(goldens, "gap300")
    t, q = c["t"].encode(), c["q"].encode()
    real = exact.kernel_inputs
    specs = []

    def small_capacity(opt, mode, *args):
        spec, *rest = real(opt, mode, *args)
        if mode == wk.MODE_PASS1 and not specs:
            spec = dataclasses.replace(spec, n_snap=2)
        specs.append(spec)
        return (spec, *rest)

    monkeypatch.setattr(exact, "kernel_inputs", small_capacity)
    r = align_batch([(t, q)], Options(cigar=True, step=16), device="cpu")[0]
    e = goldens["runs"]["lowmem_p16"][i]
    assert (r.s, r.cigar_str) == (e["s"], e["cigar"])
    p1 = [s for s in specs if s.mode == wk.MODE_PASS1]
    assert len(p1) == 2 and p1[0].n_snap == 2
    assert p1[1].W > p1[0].W and p1[1].S_CAP == p1[0].S_CAP
    assert p1[1].n_snap == p1[1].S_CAP // 16 + 2
    # the overflowing dispatch itself: two rows taken, then ovf_band
    _, lanes, tw, qw = real(Options(cigar=True, step=16), wk.MODE_PASS1,
                            p1[0].W, p1[0].S_CAP, [t], [q])
    out = wk.wavefront(p1[0], *(torch.from_numpy(a)
                                for a in (lanes, tw, qw)))[0]
    assert out[0, wk.O_OVFB] == 1 and out[0, wk.O_SNC] == 2
    assert out[0, wk.O_DONE] == 0 and out[0, wk.O_OVFS] == 0


def test_snapshot_overflow_matches_jax_kernel(goldens):
    """Out of snapshot rows, both packages' PASS1 stop the lane the same
    way: every output column equal (a band overflow after two rows)."""
    c = _case(goldens, "t3")[1]
    _, jrow, _, _, _, outs = _pass1_rows(c["t"].encode(), c["q"].encode(),
                                         16, n_snap=2)
    got = convert.row_from_out(outs[0].numpy())
    keep = [j for j in range(convert.JO_N) if j != convert.JO_LP]
    assert np.array_equal(got[:, keep], jrow[:, keep])
    assert got[0, convert.JO_OVFB] == 1 and got[0, convert.JO_SNC] == 2
    assert got[0, convert.JO_OVFS] == 0 and got[0, convert.JO_DONE] == 0


def test_convert_seg_columns_and_pass1_outputs():
    lanes = np.array([[10, 20, -512, 0, 0], [7, 9, -100, 0, 0]], np.int64)
    segs = exact.seg_input([[(16, 3), (32, -5)], []])
    assert segs.tolist() == [[[16, 3], [32, -5]], [[-1, 0], [-1, 0]]]
    scal = convert.scal_from_lanes(lanes, 3, segs)
    # the JAX driver's own layout (miniwfa_tpu/models/exact.py): n_seg,
    # then seg_cap scores, then seg_cap diagonals
    assert scal[:, jwk.SC_NSEG].tolist() == [2, 0]
    assert scal[0, jwk.SC_SEG:jwk.SC_SEG + 6].tolist() == [16, 32, 0, 3, -5, 0]
    back = convert.segs_from_scal(scal)
    assert back[:, :2].tolist() == segs.tolist()
    assert (back[:, 2, 0] == -1).all()
    assert np.array_equal(convert.lanes_from_scal(scal), lanes)
    out = np.array([[155, 1, 0, 0, 0, 0, 999, 4242, 9],
                    [-1, 0, 0, 1, 0, 0, 5, wk.WF_NEG_INF, 0]], np.int64)
    row = convert.row_from_out(out)
    assert row[:, convert.JO_LP].tolist() == [4242, wk.WF_NEG_INF]
    assert row[:, convert.JO_SNC].tolist() == [9, 0]
    assert np.array_equal(convert.out_from_row(row), out)


def test_ptr_to_seg_inverts_the_layout():
    """Every plane of the port's snapshot layout decodes to its ring's
    score and the slot's diagonal."""
    spec = wk.KSpec(W=W, S_CAP=512, mode=wk.MODE_PASS1, step=10, n_snap=53,
                    **PENS)
    RH, RE1, RE2 = spec.rings
    depths = [RH] * RH + [RE1] * (2 * RE1) + [RE2] * (2 * RE2)
    slots = list(range(RH)) + list(range(RE1)) * 2 + list(range(RE2)) * 2
    assert len(depths) == wk.snapshot_layout(spec)[5]
    c, anc = 4, -300
    snap_s = 10 * (c + 1) - 1
    for p, (depth, j) in enumerate(zip(depths, slots)):
        s, d = tbk.ptr_to_seg(p * W + 37, c, anc, spec)
        assert d == anc + 37 and snap_s - depth < s <= snap_s
        assert s % depth == j


def test_chip_smoke_dissim150k_matches_generator():
    """chip_smoke.py's jax-free dissim150k pair is the scale fixture's."""
    import chip_smoke
    from tools import make_scale_goldens
    want = make_scale_goldens.gen_case("dissim150k")
    got = chip_smoke.gen_case("dissim150k")
    md5 = [hashlib.md5(s.encode()).hexdigest() for s in got]
    assert md5 == [hashlib.md5(s.encode()).hexdigest() for s in want]
    assert [len(s) for s in got] == [150_000, 150_105]


def test_chain_ptrs_plain_matches_jax_chain():
    """chain_ptrs_plain (and chain_ptrs on CPU tensors, from numpy or
    tensor pointers) against the JAX package's chain_ptrs_on_device on
    seeded snapshot buffers: pointers in and out of range, lanes with
    snapshot count 0 and last pointer -1."""
    from miniwfa_tpu.ops import traceback_device as jtbd
    rng = np.random.default_rng(9)
    B, cap, NP, W = 12, 7, 3, 40
    snap = rng.integers(-5, NP * W + 5, (B, cap, NP, W)).astype(np.int32)
    last = rng.integers(0, NP * W, B).astype(np.int32)
    cnt = rng.integers(0, cap + 1, B).astype(np.int32)
    last[[1, 4]] = -1
    cnt[[1, 4, 6]] = 0
    cnt[2] = cap
    jfin, jrecs = jtbd.chain_ptrs_on_device(snap, last, cnt)
    st = torch.from_numpy(snap)
    for lp, c in ((last, cnt), (torch.from_numpy(last),
                                torch.from_numpy(cnt))):
        for fn in (tbd.chain_ptrs_plain, tbd.chain_ptrs):
            fin, recs = fn(st, lp, c)
            assert fin.dtype == recs.dtype == np.int64
            assert recs.shape == (cap, B)
            assert (fin == jfin).all() and (recs == jrecs).all()
    assert (recs[:, [1, 4, 6]] == -3).all() and (fin[[1, 4]] == -1).all()
