"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one; on the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: exact equality (both versions run the same integer algorithm).
"""

import pytest
import torch

from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.models import traceback as tbk
from miniwfa_tpu_torch.ops import traceback_device as tbd
from miniwfa_tpu_torch.ops import wavefront_gaps as wg
from miniwfa_tpu_torch.ops import wavefront_kernel as wk
from miniwfa_tpu_torch.ops import wavefront_multi as wm
from miniwfa_tpu_torch.ops import wavefront_wide as ww

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _golden_pairs(goldens):
    return ([c["t"].encode("latin1") for c in goldens["cases"]],
            [c["q"].encode("latin1") for c in goldens["cases"]])


@pytest.mark.parametrize("opt", [Options(), Options(cigar=True),
                                 Options(cigar=True).as_edit_distance()])
def test_kernels_match_plain(goldens, dev, opt):
    ts, qs = _golden_pairs(goldens)
    mode = wk.MODE_TB if opt.cigar else wk.MODE_SCORE
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, 8192, 4096, ts, qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    before = wk.wavefront.launches
    got = wk.wavefront(spec, *args)
    assert wk.wavefront.launches == before + 1
    want = wk.wavefront_plain(spec, *args)
    assert got[3] is None and want[3] is None
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    if not opt.cigar:
        return
    meta = torch.from_numpy(exact.walk_meta(lanes, got[0].cpu().numpy()))
    pens = (opt.x, opt.o1, opt.e1, opt.o2, opt.e2)
    k = tbd.walk(got[1], meta.to(dev), args[1], args[2], spec.cpw, pens)
    p = tbd.walk_plain(got[1], meta.to(dev), args[1], args[2], spec.cpw, pens)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def test_align_batch_goldens_on_cuda(goldens, dev):
    ts, qs = _golden_pairs(goldens)
    res = exact.align_batch(list(zip(ts, qs)), Options(cigar=True), device=dev)
    for r, e in zip(res, goldens["runs"]["cigar"]):
        assert (r.s, r.cigar_str) == (e["s"], e["cigar"])


@pytest.mark.parametrize("step", [16, 100])
def test_lowmem_kernels_match_plain(goldens, dev, step):
    """K1 PASS1 (outputs and the whole snapshot buffer), the checkpoint
    chain, and K1 TB with the decoded checkpoints, each against its plain
    version; the pass-2 scores equal the low-mem goldens."""
    ts, qs = _golden_pairs(goldens)
    opt = Options(cigar=True, step=step)
    spec, lanes, tw, qw = exact.kernel_inputs(opt, wk.MODE_PASS1, 8192, 2048,
                                              ts, qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    before = wk.wavefront.launches_by_mode["PASS1"]
    got = wk.wavefront(spec, *args)
    assert wk.wavefront.launches_by_mode["PASS1"] == before + 1
    want = wk.wavefront_plain(spec, *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    assert got[1] is None and got[2] is None
    fin, recs = tbd.chain_ptrs(got[3], got[0][:, wk.O_LP],
                               got[0][:, wk.O_SNC])
    pfin, precs = tbd.chain_ptrs(want[3], want[0][:, wk.O_LP],
                                 want[0][:, wk.O_SNC])
    assert (fin == pfin).all() and (recs == precs).all()
    o = got[0].cpu().numpy()
    segs = [tbk.decode_checkpoints_ptrs(recs[:, j], int(fin[j]),
                                        int(lanes[j, wk.L_ANC]),
                                        int(o[j, wk.O_SNC]), spec)
            for j in range(len(ts))]
    tspec, _, _, _ = exact.kernel_inputs(opt, wk.MODE_TB, 8192, 2048, ts, qs)
    sg = torch.from_numpy(exact.seg_input(segs)).to(dev)
    got = wk.wavefront(tspec, *args, sg)
    want = wk.wavefront_plain(tspec, *args, sg)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    assert [int(v) for v in got[0][:, wk.O_S]] == \
        [e["s"] for e in goldens["runs"][f"lowmem_p{step}"]]


def test_align_batch_lowmem_on_cuda(goldens, dev):
    ts, qs = _golden_pairs(goldens)
    before = dict(wk.wavefront.launches_by_mode)
    res = exact.align_batch(list(zip(ts, qs)), Options(cigar=True, step=16),
                            device=dev)
    for r, e in zip(res, goldens["runs"]["lowmem_p16"]):
        assert (r.s, r.cigar_str) == (e["s"], e["cigar"])
    for mode in ("PASS1", "TB+seg"):
        assert wk.wavefront.launches_by_mode[mode] > before.get(mode, 0)


def _golden_gaps(goldens):
    """Every gap fill of at most 127 bp in the chain plans of the
    goldens."""
    from miniwfa_tpu_torch.models import chain
    out = []
    for t, q in zip(*_golden_pairs(goldens)):
        kinds, x0, x1, y0, y1 = chain._plan_segments(t, q, Options())
        for i in (kinds == chain.K_ALIGN).nonzero()[0]:
            if x1[i] - x0[i] + y1[i] - y0[i] <= wg.MAX_TOT:
                out.append((t[x0[i]:x1[i]], q[y0[i]:y1[i]]))
    return out


@pytest.mark.parametrize("cpw", [16, 4])
@pytest.mark.parametrize("opt", [Options(), Options(cigar=True),
                                 Options(cigar=True, max_s=12)])
def test_gaps_kernel_matches_plain(goldens, dev, cpw, opt):
    """K3 against gaps_plain (every output and tb byte), and W1 over K3's
    traceback against walk_plain."""
    from miniwfa_tpu_torch.models import tiny
    pairs = _golden_gaps(goldens) + [
        (b"ACGT", b"ACGT"), (b"A", b"G"), (b"AAAA", b"AAAAAAAA"),
        (b"AAAA", b""), (b"", b"ACG"), (b"", b""), (b"A" * 63, b"C" * 64)]
    if cpw == 4:
        pairs.append((b"ACGTNacgt", b"ACGTnACGT"))
    ts, qs = [p[0] for p in pairs], [p[1] for p in pairs]
    spec, lens, tw, qw = tiny.dispatch_inputs(opt, ts, qs, cpw, 512)
    args = [torch.from_numpy(a).to(dev) for a in (lens, tw, qw)]
    before = wg.gaps.launches
    got = wg.gaps(spec, *args)
    assert wg.gaps.launches == before + 1
    want = wg.gaps_plain(spec, *args)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    out = got[0].cpu().numpy()
    assert out[:, wg.GO_DONE].sum() + out[:, wg.GO_STOP].sum() == len(pairs)
    if not opt.cigar:
        return
    cigs = tiny.walk_gaps(got[1], lens, out, args[1], args[2], cpw,
                          (opt.x, opt.o1, opt.e1, opt.o2, opt.e2))
    meta = torch.from_numpy(tiny.walk_meta(lens, out))
    pens = (opt.x, opt.o1, opt.e1, opt.o2, opt.e2)
    k = tbd.walk(got[1], meta.to(dev), args[1], args[2], cpw, pens)
    p = tbd.walk_plain(got[1], meta.to(dev), args[1], args[2], cpw, pens)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert cigs == tbd.to_cigars(*k)


def test_chain_auto_goldens_on_cuda(goldens, dev):
    from miniwfa_tpu_torch.models.auto import align_auto_batch
    from miniwfa_tpu_torch.models.chain import align_chain_batch
    pairs = list(zip(*_golden_pairs(goldens)))
    before = (wg.gaps.launches, tbd.walk.launches)
    for run, fn in (("chain", align_chain_batch), ("auto", align_auto_batch)):
        res = fn(pairs, Options(cigar=True), device=dev)
        for r, e in zip(res, goldens["runs"][run]):
            assert (r.s, r.cigar_str) == (e["s"], e["cigar"]), run
    assert wg.gaps.launches > before[0] and tbd.walk.launches > before[1]


@pytest.mark.parametrize("chunk", [0, 77])
@pytest.mark.parametrize("step", [0, 16])
def test_wide_kernel_matches_plain(goldens, dev, monkeypatch, step, chunk):
    """The wide kernel on the goldens at W=16384, one call or 77-cycle
    calls per lane, against wide_plain in one call: every output, the
    snapshot rows and (one call) the state row and planes."""
    ts, qs = _golden_pairs(goldens)
    opt = Options(cigar=bool(step), step=step)
    mode = wk.MODE_PASS1 if step else wk.MODE_SCORE
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, 16384, 1100, ts, qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    big = torch.full((len(ts),), 1 << 40, dtype=torch.int64, device=dev)
    pst = ww.new_state(spec, args[0])
    want = ww.wide_plain(spec, *args, pst, big)
    assert int(want[:, wk.O_DONE].sum()) == len(ts)
    before = ww.wide.launches
    if chunk:
        monkeypatch.setattr(ww, "CYCLES_PER_CALL", chunk * len(ts))
        out, snap, kspec = ww.run_chunked(spec, *args)
        assert ww.wide.launches - before >= 3 and kspec == spec
        assert torch.equal(out, want[:, :wk.O_N])
    else:
        kst = ww.new_state(spec, args[0])
        out = ww.wide(spec, *args, kst, big)
        assert ww.wide.launches == before + 1
        assert torch.equal(out, want)
        assert torch.equal(kst.row, pst.row)
        assert torch.equal(kst.planes, pst.planes)
        snap = kst.snap
    assert (snap is None) == (step == 0)
    assert step == 0 or torch.equal(snap, pst.snap)


@pytest.mark.parametrize("opt", [Options(), Options(cigar=True, step=16)])
def test_align_batch_goldens_through_wide_route(goldens, dev, monkeypatch,
                                                opt):
    monkeypatch.setattr(exact, "WIDE_SCORE_W_MIN", 256)
    monkeypatch.setattr(exact, "WIDE_PASS1_W_MIN", 256)
    ts, qs = _golden_pairs(goldens)
    before = ww.wide.launches
    res = exact.align_batch(list(zip(ts, qs)), opt, device=dev)
    assert ww.wide.launches > before
    run = "lowmem_p16" if opt.step else "score"
    for c, r, e in zip(goldens["cases"], res, goldens["runs"][run]):
        assert r.s == e["s"], c["name"]
        if opt.cigar:
            assert r.cigar_str == e["cigar"], c["name"]


@pytest.mark.parametrize("step", [0, 16])
def test_wide_kernel_pauses_on_snapshot_and_shrink_cycles(goldens, dev, step):
    """Calls of 16 cycles on the goldens: every pause falls right after a
    step-16 snapshot cycle, and one right after the 256-cycle shrink; the
    resumed run equals wide_plain in one call, state and planes too."""
    ts, qs = _golden_pairs(goldens)
    opt = Options(cigar=bool(step), step=step)
    mode = wk.MODE_PASS1 if step else wk.MODE_SCORE
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, 16384, 1100, ts, qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    B = len(ts)
    pst = ww.new_state(spec, args[0])
    want = ww.wide_plain(spec, *args, pst,
                         torch.full((B,), 1 << 40, dtype=torch.int64,
                                    device=dev))
    kst = ww.new_state(spec, args[0])
    for lim in range(16, spec.S_CAP + 16, 16):
        out = ww.wide(spec, *args, kst,
                      torch.full((B,), lim, dtype=torch.int64, device=dev))
        if lim == 256:
            paused = out[:, ww.OW_PAUSE] == 1
            assert bool(paused.any())
            assert bool((kst.row[paused, ww.ST_T] == 256).all())
    assert torch.equal(out, want)
    for a, b in ((kst.row, pst.row), (kst.planes, pst.planes),
                 (kst.snap, pst.snap)):
        assert (a is None and b is None) or torch.equal(a, b)


def _equal(got, want):
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("B", [10, 75])
@pytest.mark.parametrize("G", [2, 4, 8])
@pytest.mark.parametrize("run", ["score", "cigar", "cigar+seg"])
def test_multi_kernel_matches_k1_and_plain(goldens, dev, run, G, B):
    """K4 (G lanes per block) against K1 and the plain version on the
    first B goldens (10 and 75 lanes: a ragged last block at every G):
    every output, traceback byte and band row; TB+seg with the
    checkpoints of a step-16 pass 1."""
    ts, qs = [x[:B] for x in _golden_pairs(goldens)]
    opt = Options(cigar=run != "score")
    mode = wk.MODE_TB if opt.cigar else wk.MODE_SCORE
    sg = None
    if run == "cigar+seg":
        segs, _ = exact._run_pass1(opt.replace(step=16), ts, qs, 512, 512,
                                   dev)
        sg = torch.from_numpy(exact.seg_input(segs)).to(dev)
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, 8192, 4096, ts, qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    before = wm.wavefront_multi.launches
    got = wm.wavefront_multi(spec, G, *args, sg)
    assert wm.wavefront_multi.launches == before + 1
    _equal(got, wk.wavefront(spec, *args, sg))
    _equal(got, wk.wavefront_plain(spec, *args, sg))
    assert int(got[0][:, wk.O_DONE].sum()) == B


def test_kernels_at_o2_100_match_plain(goldens, dev):
    """max_pen 101: K1 SCORE and TB, K4 TB at G=4, K2 SCORE in one call
    and K3 TB against their plain versions on the goldens."""
    from miniwfa_tpu_torch.models import tiny
    ts, qs = _golden_pairs(goldens)
    opt = Options(o2=100, e2=1)
    for mode in (wk.MODE_SCORE, wk.MODE_TB):
        spec, lanes, tw, qw = exact.kernel_inputs(
            opt.replace(cigar=mode == wk.MODE_TB), mode, 8192, 4096, ts, qs)
        args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
        want = wk.wavefront_plain(spec, *args)
        assert int(want[0][:, wk.O_DONE].sum()) == len(ts)
        _equal(wk.wavefront(spec, *args), want)
        if mode == wk.MODE_TB:
            _equal(wm.wavefront_multi(spec, 4, *args), want)
    spec, lanes, tw, qw = exact.kernel_inputs(opt, wk.MODE_SCORE, 16384,
                                              4096, ts, qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    big = torch.full((len(ts),), 1 << 40, dtype=torch.int64, device=dev)
    pst, kst = ww.new_state(spec, args[0]), ww.new_state(spec, args[0])
    assert torch.equal(ww.wide(spec, *args, kst, big),
                       ww.wide_plain(spec, *args, pst, big))
    assert torch.equal(kst.row, pst.row) and torch.equal(kst.planes,
                                                         pst.planes)
    gaps = _golden_gaps(goldens)
    copt = opt.replace(cigar=True)
    assert tiny.tiny_eligible(copt, max(len(a) + len(b) for a, b in gaps))
    gspec, lens, gtw, gqw = tiny.dispatch_inputs(
        copt, [a for a, _ in gaps], [b for _, b in gaps], 4, 1024)
    gargs = [torch.from_numpy(a).to(dev) for a in (lens, gtw, gqw)]
    _equal(wg.gaps(gspec, *gargs), wg.gaps_plain(gspec, *gargs))


@pytest.mark.parametrize("opt", [Options(), Options(cigar=True)])
def test_engine_multi_route_on_cuda(goldens, dev, monkeypatch, opt):
    """MWF_ENGINE=multi MWF_KERNEL_G=4: align_batch launches K4 and gives
    the goldens' results; without MWF_ENGINE it launches none."""
    pairs = list(zip(*_golden_pairs(goldens)))
    run = "cigar" if opt.cigar else "score"
    before = wm.wavefront_multi.launches
    exact.align_batch(pairs, opt, device=dev)
    assert wm.wavefront_multi.launches == before
    monkeypatch.setenv("MWF_ENGINE", "multi")
    monkeypatch.setenv("MWF_KERNEL_G", "4")
    res = exact.align_batch(pairs, opt, device=dev)
    assert wm.wavefront_multi.launches > before
    for r, e in zip(res, goldens["runs"][run]):
        assert r.s == e["s"] and (not opt.cigar or r.cigar_str == e["cigar"])
