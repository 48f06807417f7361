"""The port's gaps engine (K3's plain version and the tiny-gap driver)
against the JAX package.

``gaps_plain`` takes the same inputs as the JAX package's gaps kernel
(``miniwfa_tpu.ops.wavefront_gaps``) run in Pallas interpret mode, carried
over by ``miniwfa_tpu_torch.convert``; it is also held against the port's
own wavefront kernel (``wavefront_plain`` at W = 128, anchor -tl), the
semantic contract of the gaps kernel.  ``align_tiny_batch`` on the CPU is
held against the JAX ``align_batch`` (the lax engine on the CPU).
Tolerance: exact equality of every output column and of every traceback
byte of rows 0 .. s.
"""

import random

import numpy as np
import pytest
import torch

from miniwfa_tpu import Options as JOptions
from miniwfa_tpu.models import exact as jexact
from miniwfa_tpu.models import tiny as jtiny
from miniwfa_tpu.ops import wavefront_gaps as jwg
from miniwfa_tpu_torch import Options, convert
from miniwfa_tpu_torch.models import exact, tiny
from miniwfa_tpu_torch.ops import pack
from miniwfa_tpu_torch.ops import wavefront_gaps as wg
from miniwfa_tpu_torch.ops import wavefront_kernel as wk

torch.set_num_threads(1)   # as in test_torch_chain.py

R = 8   # JAX rows per grid step: small, to keep the interpreter fast
EDGE = [(b"ACGT", b"ACGT"), (b"A", b"G"), (b"AAAA", b"AAAAAAAA"),
        (b"AAAA", b"GGGGACGT"), (b"AAAA", b""), (b"", b"ACG"), (b"", b""),
        (b"A" * 63, b"C" * 64)]


def _pairs(seed, n, maxn=60, alphabet="ACGT"):
    """Seeded pairs of at most 127 bp in total: a random target and a
    copy with 10% substitutions and 5% insertions."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        t = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, maxn)))
        q = []
        for c in t:
            r = rng.random()
            if r < 0.1:
                q.append(rng.choice(alphabet))
            elif r < 0.15:
                q.append(c + rng.choice(alphabet))
            else:
                q.append(c)
        q = "".join(q)[:wg.MAX_TOT - len(t)]
        out.append((t.encode(), q.encode()))
    return out


def _inputs(opt, pairs, cpw, s_cap):
    return tiny.dispatch_inputs(opt, [p[0] for p in pairs],
                                [p[1] for p in pairs], cpw, s_cap)


def _jax(spec, lens, tw, qw):
    """The JAX gaps kernel in interpret mode on the port's inputs, padded
    to whole grid steps: (out [G, GO_N], tb [G, S_CAP, 128] or None)."""
    G = len(lens)
    nstep = -(-G // R)
    pad = ((0, nstep * R - G), (0, 0))
    meta, st, sq = convert.gaps_planes(np.pad(lens, pad), np.pad(tw, pad),
                                       np.pad(qw, pad))
    jspec = jwg.GSpec(R=R, NSTEP=nstep, S_CAP=spec.S_CAP, x=spec.x,
                      o1=spec.o1, e1=spec.e1, o2=spec.o2, e2=spec.e2,
                      mode=spec.mode, cpw=spec.cpw, max_s=spec.max_s,
                      max_iter=spec.max_iter)
    res = jwg.build_gaps_kernel(jspec)(meta, st, sq, interpret=True)
    out = convert.gaps_out_from_plane(np.asarray(res[0]))[:G]
    tb = convert.tb_from_gaps_packed(np.asarray(res[1]))[:G] \
        if spec.mode == wg.MODE_TB else None
    return out, tb


def _plain(spec, lens, tw, qw):
    out, tb = wg.gaps_plain(spec, torch.from_numpy(lens),
                            torch.from_numpy(tw), torch.from_numpy(qw))
    return out.numpy(), None if tb is None else tb.numpy()


def _assert_tb_rows(out, tb, want_tb, max_s=0):
    """Rows 0 .. s of every finished gap are equal, and rows 0 .. max_s of
    a gap stopped by max_s.  (Past the cycle where every gap of its grid
    step has finished, the JAX kernel leaves a row unwritten.)"""
    for g in range(len(out)):
        s = max_s if out[g, wg.GO_STOP] else out[g, wg.GO_S]
        if out[g, wg.GO_DONE] or max_s:
            assert np.array_equal(tb[g, :s + 1], want_tb[g, :s + 1]), g


@pytest.mark.parametrize("cpw", [16, 4])
@pytest.mark.parametrize("cigar", [False, True])
def test_gaps_plain_matches_jax_kernel(cpw, cigar):
    pairs = _pairs(7 + cpw, 12) + EDGE
    if cpw == 4:   # byte packing: N and lowercase compare as raw bytes
        pairs += _pairs(3, 3, alphabet="ACGTNacgt")
    spec, lens, tw, qw = _inputs(Options(cigar=cigar), pairs, cpw, 512)
    want = _jax(spec, lens, tw, qw)
    got = _plain(spec, lens, tw, qw)
    assert np.array_equal(got[0], want[0])
    assert got[0][:, wg.GO_DONE].all()
    if cigar:
        _assert_tb_rows(got[0], got[1], want[1])


@pytest.mark.parametrize("bound", [dict(max_s=12), dict(max_iter=300)])
def test_gaps_plain_stops_match_jax_kernel(bound):
    pairs = _pairs(11, 14) + EDGE
    spec, lens, tw, qw = _inputs(Options(cigar=True, **bound), pairs, 16,
                                 128)
    want = _jax(spec, lens, tw, qw)
    got = _plain(spec, lens, tw, qw)
    assert np.array_equal(got[0], want[0])
    assert got[0][:, wg.GO_STOP].any() and got[0][:, wg.GO_DONE].any()
    _assert_tb_rows(got[0], got[1], want[1], bound.get("max_s", 0))


def test_gaps_plain_cycle_budget_overflow_matches_jax_kernel():
    pairs = [(b"ACGT" * 15, b"TGCA" * 15), (b"ACGT", b"ACGA")]
    spec, lens, tw, qw = _inputs(Options(), pairs, 16, 32)
    want = _jax(spec, lens, tw, qw)
    got = _plain(spec, lens, tw, qw)
    assert np.array_equal(got[0], want[0])
    assert got[0][:, wg.GO_OVF].tolist() == [1, 0]


@pytest.mark.parametrize("pens", [
    dict(), dict(x=1, o1=0, e1=1, o2=0, e2=1)])      # edit: every age is 1
def test_gaps_plain_matches_wavefront_plain(pens):
    """The gaps engine's contract: the wavefront kernel's outputs and
    traceback bytes for the same pairs, at W = 128 and anchor -tl.  (Past
    a 256-cycle shrink whose hull a new top beyond the matrix edge would
    widen, the wavefront kernel's n_iter departs from the lax engine's and
    the gaps kernel's, in both packages: ROADMAP.md section 3.  Scores
    past 256 are held against the lax engine below.)"""
    pairs = _pairs(5, 16) + EDGE + _pairs(9, 4, maxn=63, alphabet="AC")
    opt = Options(cigar=True, **pens)
    spec, lens, tw, qw = _inputs(opt, pairs, 16, 1024)
    out, tb = _plain(spec, lens, tw, qw)
    kspec = wk.KSpec(W=wg.WIN, S_CAP=spec.S_CAP, x=opt.x, o1=opt.o1,
                     e1=opt.e1, o2=opt.o2, e2=opt.e2, mode=wk.MODE_TB,
                     cpw=16)
    lanes = np.zeros((len(pairs), wk.L_N), np.int64)
    lanes[:, wk.L_TL], lanes[:, wk.L_QL] = lens[:, 0], lens[:, 1]
    lanes[:, wk.L_ANC] = -lens[:, 0]
    kout, ktb, _, _ = wk.wavefront_plain(
        kspec, torch.from_numpy(lanes), torch.from_numpy(tw),
        torch.from_numpy(qw))
    kout = kout.numpy()
    for go, o in ((wg.GO_S, wk.O_S), (wg.GO_DONE, wk.O_DONE),
                  (wg.GO_STOP, wk.O_STOP), (wg.GO_OVF, wk.O_OVFS),
                  (wg.GO_LS, wk.O_LS), (wg.GO_NI, wk.O_NITER)):
        assert np.array_equal(out[:, go], kout[:, o]), go
    assert not kout[:, wk.O_OVFB].any()
    _assert_tb_rows(out, tb, ktb.numpy())


@pytest.mark.parametrize("opt", [
    Options(), Options(cigar=True), Options(cigar=True, max_s=10),
    Options(cigar=True, x=8, o1=8, e1=4, o2=20, e2=2)])   # scores past 256
def test_align_tiny_batch_matches_jax_align_batch(opt):
    pairs = _pairs(13, 16) + EDGE + [(b"ACGTNNNA", b"ACGTANNA")]
    jopt = JOptions(**{f: getattr(opt, f) for f in (
        "x", "o1", "e1", "o2", "e2", "cigar", "max_s")})
    want = jexact.align_batch(pairs, jopt)
    got = tiny.align_tiny_batch(pairs, opt, device="cpu")
    for i, (w, g) in enumerate(zip(want, got)):
        assert (g.s, g.cigar, g.n_iter) == (w.s, w.cigar, w.n_iter), pairs[i]


def test_cycle_budget_overflow_reruns_through_align_batch(monkeypatch):
    """A gap that outlives its dispatch's cycle budget takes the
    align_batch route, with the same result."""
    pairs = [(b"ACGT" * 15, b"TGCA" * 15), (b"ACGTACGT", b"ACGAACGT")]
    opt = Options(cigar=True)
    monkeypatch.setattr(tiny, "_scap_bucket", lambda s: 32)
    routed = []
    real = exact.align_batch

    def spy(sub, o, **kw):
        routed.extend(sub)
        return real(sub, o, **kw)

    monkeypatch.setattr(exact, "align_batch", spy)
    got = tiny.align_tiny_batch(pairs, opt, device="cpu")
    assert routed == pairs[:1]
    want = real(pairs, opt, device="cpu")
    assert [(r.s, r.cigar, r.n_iter) for r in got] == \
        [(r.s, r.cigar, r.n_iter) for r in want]
    assert got[0].s > 30


def test_bounds_and_buckets_match_jax():
    opt, jopt = Options(), JOptions()
    for tl, ql in ((0, 0), (1, 0), (10, 30), (63, 64), (127, 0), (40, 40)):
        assert tiny._s_bound(opt, tl, ql) == jtiny._s_bound(jopt, tl, ql)
    for s in (0, 30, 31, 62, 300, 1022):
        assert tiny._scap_bucket(s) == jtiny._scap_bucket(s)
    with pytest.raises(ValueError):
        tiny._scap_bucket(1023)
    assert tiny.tiny_eligible(opt, 127) and not tiny.tiny_eligible(opt, 128)
    # any penalty set whose rings fit the kernel's shared memory: 447 + 2*2
    # + 2*1 ring planes of 128 slots and both sides' words fit 232448 bytes
    assert tiny.tiny_eligible(Options(x=31), 10)
    assert tiny.tiny_eligible(Options(x=447), 10)
    assert not tiny.tiny_eligible(Options(x=448), 10)


@pytest.mark.parametrize("cpw", [16, 4])
def test_pack_rows_matches_pack_words(cpw):
    """The JAX gaps kernel's word rows (``pack_rows``) are the port's
    ``pack_words`` streams padded to a fixed width; the port packs a
    dispatch's gaps with ``pack_words``."""
    seqs = [t for p in _pairs(17, 20) for t in p] + [b"", b"A" * 127]
    if cpw == 4:
        seqs += [b"ACGTNacgt"]
    rows = pack.pack_words(seqs, cpw)
    assert rows.shape == (len(seqs), pack.n_words(127, cpw))
    jrows = jwg.pack_rows(seqs, cpw)
    assert np.array_equal(jrows[:, :rows.shape[1]], rows)
    assert not jrows[:, rows.shape[1]:].any()
    with pytest.raises(ValueError):   # a row longer than the stated length
        pack.pack_words([b"A" * 100], cpw, 10)


def test_gaps_convert_round_trip():
    """tb_from_gaps_packed undoes the JAX kernel's packing: row t in byte
    t & 3 of word [g, t >> 2, w]."""
    rng = np.random.default_rng(3)
    tb = rng.integers(0, 128, (3, 8, 128), dtype=np.uint8)
    v = tb.reshape(3, 2, 4, 128).astype(np.uint32)
    packed = v[:, :, 0] | (v[:, :, 1] << 8) | (v[:, :, 2] << 16) \
        | (v[:, :, 3] << 24)
    assert (packed[1, 1, 5] >> 16) & 0xFF == tb[1, 6, 5]
    assert np.array_equal(
        convert.tb_from_gaps_packed(packed.view(np.int32)), tb)


def test_gaps_rejects_bad_inputs():
    spec = wg.GSpec(S_CAP=32, x=4, o1=4, e1=2, o2=15, e2=1)
    lens = torch.tensor([[100, 28]], dtype=torch.int32)
    words = torch.zeros((1, 10), dtype=torch.int32)
    with pytest.raises(ValueError):        # 128 bp in total
        wg.gaps(spec, lens, words, words)
    lens = torch.tensor([[40, 20]], dtype=torch.int32)
    with pytest.raises(ValueError):        # padded past the longest's words
        wg.gaps(spec, lens, words, words)
    meta = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        wg.gaps(spec, meta, words.to("meta"), words.to("meta"))


def _goldens_gaps():
    """Every gap fill of at most 127 bp in the chain plans of the goldens
    (the card tests' ``_golden_gaps``)."""
    import json
    import os
    from miniwfa_tpu_torch.models import chain
    with open(os.path.join(os.path.dirname(__file__), "data",
                           "goldens.json")) as f:
        cases = json.load(f)["cases"]
    out = []
    for c in cases:
        t, q = c["t"].encode("latin1"), c["q"].encode("latin1")
        kinds, x0, x1, y0, y1 = chain._plan_segments(t, q, Options())
        for i in (kinds == chain.K_ALIGN).nonzero()[0]:
            if x1[i] - x0[i] + y1[i] - y0[i] <= wg.MAX_TOT:
                out.append((t[x0[i]:x1[i]], q[y0[i]:y1[i]]))
    return out


# sums tl + ql at each class edge: n = tl + ql + 1 of 8 | 9, 16 | 17, 32 |
# 33, 64 | 65 and 128
_EDGES = [(3, 4), (4, 4), (10, 5), (8, 8), (20, 11), (16, 16), (40, 23),
          (32, 32), (60, 67), (0, 0), (0, 7)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_groups_gaps_by_width_class(seed):
    """``plan``: a permutation of the gaps, class by class (the smallest
    window of CLASSES that holds tl + ql + 1 slots), each class in input
    order, with each class's first index and count."""
    rng = np.random.default_rng(seed)
    tot = rng.integers(0, wg.MAX_TOT + 1, 200)
    tl = rng.integers(0, tot + 1)
    lens = np.stack([tl, tot - tl], 1).astype(np.int32)
    lens = np.concatenate([lens, np.array(_EDGES, np.int32)])
    perm, bounds = wg.plan(lens)
    plan = np.array(bounds)
    assert perm.dtype == np.int32 and plan.shape == (len(wg.CLASSES), 2)
    assert sorted(perm.tolist()) == list(range(len(lens)))
    n = lens.sum(1) + 1
    want = np.searchsorted(np.array(wg.CLASSES), n)
    assert plan[:, 1].tolist() == np.bincount(
        want, minlength=len(wg.CLASSES)).tolist()
    assert plan[:, 0].tolist() == (np.cumsum(plan[:, 1])
                                   - plan[:, 1]).tolist()
    for c, (first, count) in enumerate(plan):
        idx = perm[first:first + count]
        assert (want[idx] == c).all()
        assert (np.diff(idx) > 0).all()           # input order kept
        assert (n[idx] <= wg.CLASSES[c]).all()
        if c:
            assert (n[idx] > wg.CLASSES[c - 1]).all()


@pytest.mark.parametrize("cpw", [16, 4])
@pytest.mark.parametrize("opt", [Options(), Options(cigar=True),
                                 Options(cigar=True, max_s=12)])
@pytest.mark.parametrize("source", ["goldens", "random"])
def test_gaps_by_class_equals_gaps_plain(source, opt, cpw):
    """``gaps`` on the CPU dispatches through ``plan``, the plain version
    class by class, and returns every output and traceback byte of
    gaps_plain over the whole dispatch, in input order."""
    pairs = _goldens_gaps() if source == "goldens" else \
        _pairs(23, 40, maxn=120) + EDGE + [
            (b"A" * a, b"C" * b) for a, b in _EDGES]
    if cpw == 4:
        pairs.append((b"ACGTNacgt", b"ACGTnACGT"))
    spec, lens, tw, qw = _inputs(opt, pairs, cpw, 512)
    args = [torch.from_numpy(a) for a in (lens, tw, qw)]
    _, bounds = wg.plan(lens)
    assert sum(n > 0 for _, n in bounds) >= 3   # several classes
    got = wg.gaps(spec, *args)
    want = wg.gaps_plain(spec, *args)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
