"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one; on the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: exact equality (both versions run the same integer algorithm).
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from miniwfa_tpu_torch import Options, cigar
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.models import traceback as tbk
from miniwfa_tpu_torch.ops import build
from miniwfa_tpu_torch.ops import kmer
from miniwfa_tpu_torch.ops import probes as pb
from miniwfa_tpu_torch.ops import probes_multi as pm
from miniwfa_tpu_torch.ops import traceback_device as tbd
from miniwfa_tpu_torch.ops import wavefront_gaps as wg
from miniwfa_tpu_torch.ops import wavefront_kernel as wk
from miniwfa_tpu_torch.ops import wavefront_multi as wm
from miniwfa_tpu_torch.ops import wavefront_wide as ww
from miniwfa_tpu_torch.tools import microbench as mb

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
    before = wg.gaps.launches, wg.gaps.dispatches
    got = wg.gaps(spec, *args)
    # one launch per non-empty width class, one dispatch
    assert (wg.gaps.launches, wg.gaps.dispatches) == (
        before[0] + sum(n > 0 for _, n in wg.plan(lens)[1]), before[1] + 1)
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


@pytest.mark.parametrize("k", range(61))
def test_probe_kernel_matches_plain(dev, k):
    """Each group-P probe kernel (csrc/probes.cu) against its plain
    version at its tool's shape, loop counts cut to 16 (P5: 128 cycles),
    one launch counted."""
    cases = mb.all_cases()
    assert len(cases) == 61
    c = cases[k]
    it = mb.check_iters(c)
    _, x = mb.inputs(c, k, it, dev)
    before = c.fn.launches
    got = c.call(c.fn, dev, x, it)
    assert c.fn.launches == before + 1
    torch.cuda.synchronize()
    want = c.call(c.plain, dev, x, it)
    assert mb.max_abs_err(got, want) == 0, (c.pid, c.label)


@pytest.mark.parametrize("T", [63, 64, 65, 129])
@pytest.mark.parametrize("CR,NR,chunked", [(8, 16, True), (8, 184, True),
                                           (32, 16, True), (32, 184, True),
                                           (0, 184, False)])
def test_probe_chunk_matches_plain_across_the_ring(dev, T, CR, NR, chunked):
    """P5 at the tool's WR on chunk_plan's cluster: acc and tb equal the
    plain version's where the 64-slot tb ring wraps and at odd T (one
    chunk more on odd cycles)."""
    before = pb.chunk.launches
    got = pb.chunk(184, CR, T, NR, chunked, device=dev)
    assert pb.chunk.launches == before + 1
    want = pb.chunk_plain(184, CR, T, NR, chunked)
    assert mb.max_abs_err([g.cpu() for g in got], want) == 0


@pytest.mark.parametrize("WR,C", [(16, 1), (16, 2), (16, 4), (16, 8),
                                  (16, 16), (184, 16), (264, 16)])
def test_probe_chunk_at_forced_clusters(dev, WR, C):
    """The sweep at every cluster size whose CTAs hold their planes (a
    round of more than 32 chunks at NR=300), against the plain version."""
    for CR, T, NR, chunked in [(8, 5, 16, True), (4, 3, 300, True),
                               (0, 3, WR, False)]:
        got = pb._launch_chunk(WR, CR, T, NR, chunked, C, 128 // C, dev)
        want = pb.chunk_plain(WR, CR, T, NR, chunked)
        assert mb.max_abs_err([g.cpu() for g in got], want) == 0, (CR, NR)


def test_probe_chunk_refuses_what_a_cluster_cannot_hold(dev):
    """No fallback: a WR past chunk_plan's limit raises, and a plan whose
    planes a CTA cannot hold is refused by the kernel's launcher."""
    big = 4 + max(w for w in range(4, 2000, 4)
                  if pb.chunk_smem(w, 16) <= pb.SMEM_OPTIN)
    with pytest.raises(ValueError):
        pb.chunk(big, 8, 2, 16, True, device=dev)
    before = pb.chunk.launches
    with pytest.raises(RuntimeError):
        pb._launch_chunk(big, 8, 2, 16, True, 16, 8, dev)
    with pytest.raises(RuntimeError):   # 16 lanes x 4: 326 KB a CTA
        pb._launch_chunk(184, 8, 2, 16, True, 4, 32, dev)
    assert pb.chunk.launches == before


@pytest.mark.parametrize("R,M,axis,plan", [
    (8, 2048, 1, (24, 1, 1)),      # 3 blocks a row, the last 682 of 683
    (8, 16384, 1, (8, 1, 8)),      # a block a row, 8 passes of 8 chains
    (64, 2048, 0, (1366, 3, 2)),   # strips of 3 columns, the last of 2
    (512, 128, 0, (384, 1, 4))])   # 3 blocks a column, 171/171/170
@pytest.mark.parametrize("chain", [False, True])
def test_probe_gather_at_forced_plans(dev, R, M, axis, plan, chain):
    """The gather loop at plans with partial last shares and groups, for
    the fake dependence (P1a, P1b) and the real chain (P2, P4a)."""
    rng = np.random.default_rng(R + M)
    tab = torch.from_numpy(rng.integers(0, 1 << 20, (R, M), dtype=np.int32))
    idx = torch.from_numpy(rng.integers(0, (R, M)[axis], (R, M),
                                        dtype=np.int32))
    it = 16
    if chain:
        wrapper, lim = pb.gather_chain, (R, M)[axis]
        want = pb.gather_chain_plain(tab, idx, axis, it)
    else:
        wrapper, lim = (pb.bench_gather if axis else pb.bench_gather_ax0), 1
        want = (pb.bench_gather_plain if axis else
                pb.bench_gather_ax0_plain)(tab, idx, it)
    got = pb._gather2d(wrapper, tab.to(dev), idx.to(dev), axis, it, chain,
                       lim, plan=plan)
    assert torch.equal(got.cpu(), want)


def test_probe_wrappers_raise_past_their_shapes(dev):
    """A shape the kernel does not take raises; it never falls back."""
    x = torch.zeros((1, 2050), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError):
        pb.bench_hbm_row_write(x, 4, 3)      # W % 4 != 0
    with pytest.raises(ValueError):
        pb.chunk(184, 10, 2, 16, True, device=dev)   # CR % 4 != 0


@pytest.mark.parametrize("n", [16384, 16385])
@pytest.mark.parametrize("iters", [0, 1, 17, 1000])
@pytest.mark.parametrize("sync", [False, True])
def test_probe_while_matches_plain(dev, n, iters, sync):
    """P1f on while_plan's blocks, with and without the barrier, against
    the plain version on random state: a whole last block and a partial
    one (16,385 = 128 x 128 + 1)."""
    rng = np.random.default_rng(n + iters)
    x = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (1, n),
                                      dtype=np.int32))
    before = pb.bench_while_scalar.launches
    got = pb.bench_while_scalar(x.to(dev), iters, sync)
    assert pb.bench_while_scalar.launches == before + 1
    assert torch.equal(got.cpu(), pb.bench_while_scalar_plain(x, iters))


@pytest.mark.parametrize("n,plan", [(1, None), (31, None), (8 * 2048, (4, 1024, 4)),
                                    (16385, (5, 1024, 4)), (16385, (65, 64, 4))])
@pytest.mark.parametrize("sync", [False, True])
def test_probe_while_at_forced_plans(dev, n, plan, sync):
    """P1f at one partial thread, at blocks of many warps (the plan of a
    card of one SM) and at a partial last block of two warps."""
    x = torch.arange(n, dtype=torch.int32).reshape(1, n) * 7 - 3
    got = pb._while(x.to(dev), 33, sync, plan)
    assert torch.equal(got.cpu(), pb.bench_while_scalar_plain(x, 33))


@pytest.mark.parametrize("S,iters", [(8, 3 * 8 + 5), (1024, 2500), (1, 9),
                                     (1025, 1000)])
@pytest.mark.parametrize("W", [2048, 2052])
def test_probe_row_write_matches_plain(dev, S, iters, W):
    """P1e on row_write_plan's blocks against the plain version, with
    random x and rows rewritten (iters > S: the later write lands last),
    at W = 2052 too (no multiple of 16), torch.equal."""
    rng = np.random.default_rng(S + iters + W)
    x = torch.from_numpy(rng.integers(-(1 << 31), (1 << 31) - 1, (1, W),
                                      dtype=np.int32))
    before = pb.bench_hbm_row_write.launches
    got = pb.bench_hbm_row_write(x.to(dev), S, iters)
    assert pb.bench_hbm_row_write.launches == before + 1
    assert torch.equal(got.cpu(), pb.bench_hbm_row_write_plain(x, S, iters))


@pytest.mark.parametrize("S,W,iters,plan", [
    (1024, 2048, 2500, (1, 128)),     # one block writes every row
    (1024, 2048, 2500, (1024, 32)),   # a block a row, 4 segments a row
    (64, 2052, 200, (40, 32)),        # 5 segments, the last one word
    (7, 40000, 40, (21, 1024)),       # 3 segments, the last partial
    (3, 40000, 10, (3, 1024))])       # 3 rows in one class
def test_probe_row_write_at_forced_plans(dev, S, W, iters, plan):
    """P1e at plans with one block, a block a row, several segments a row
    and a partial last segment, against the plain version."""
    rng = np.random.default_rng(W)
    x = torch.from_numpy(rng.integers(0, 1 << 20, (1, W), dtype=np.int32))
    got = pb._row_write(x.to(dev), S, iters, plan)
    assert torch.equal(got.cpu(), pb.bench_hbm_row_write_plain(x, S, iters))


def test_probe_while_and_row_write_refuse_bad_plans(dev, monkeypatch):
    """No fallback: a plan the host check refuses raises ValueError, and
    past that check the kernel's own entry refuses it (RuntimeError)."""
    x = torch.zeros((8, 2048), dtype=torch.int32, device=dev)
    xr = torch.zeros((1, 2048), dtype=torch.int32, device=dev)
    bad_while = [(128, 32, 8), (127, 32, 4), (128, 48, 4)]
    bad_rows = [(64, 2048, 200, (33, 64)),   # 2 segments a row
                (1024, 2048, 3, (128, 48)),
                (1024, 2048, 3, (2048, 128))]   # more classes than rows
    for plan in bad_while:
        with pytest.raises(ValueError):
            pb._while(x, 3, True, plan)
    for S, W, it, plan in bad_rows:
        with pytest.raises(ValueError):
            pb._row_write(xr, S, it, plan)
    monkeypatch.setattr(pb, "check_while_plan", lambda *a: None)
    monkeypatch.setattr(pb, "check_row_write_plan", lambda *a: None)
    before = (pb.bench_while_scalar.launches,
              pb.bench_hbm_row_write.launches)
    for plan in bad_while:
        with pytest.raises(RuntimeError):
            pb._while(x, 3, True, plan)
    for S, W, it, plan in bad_rows:
        with pytest.raises(RuntimeError):
            pb._row_write(xr, S, it, plan)
    assert (pb.bench_while_scalar.launches,
            pb.bench_hbm_row_write.launches) == before


# the multi probes' bodies (P6c-P8e): (pid, wrapper, plain, extra input)
MULTI_BODIES = [(c.pid, c.fn, c.plain) for c in mb.all_cases()
                if c.pid >= "P6c"]
# shapes: the tools', every G, L = 130 (a scalar tail; at R = 63 the lanes
# are not 16-byte aligned), odd R, a lane of 56,550 words (4 CTAs a lane)
MULTI_SHAPES = [(4, 64, 128), (1, 64, 128), (2, 33, 130), (4, 63, 130),
                (8, 25, 130), (1, 390, 145)]
# forced plans (C, threads, nv), taken where the kernel takes them: a CTA a
# lane of 1024 or 512 threads, 2, 3, 4 and 8 CTAs a lane (clusters of 2 to
# 8 CTAs for the reductions)
MULTI_PLANS = [(1, 1024, 2), (1, 512, 4), (2, 1024, 1), (3, 704, 1),
               (4, 128, 4), (8, 256, 1)]


def _multi_inputs(pid, G, R, L, seed):
    """(args of the wrapper) as CPU tensors: x [G, R, L] in [0, 100) and
    P6f's bound plane [8, L] or P8d's scalars [G]."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 100, (G, R, L), dtype=np.int32))
    if pid == "P6f":
        return x, torch.from_numpy(rng.integers(0, 50, (8, L),
                                                dtype=np.int32))
    if pid == "P8d":
        return torch.from_numpy(rng.integers(0, 9, (G,), dtype=np.int32)), x
    return (x,)


# the kernel's probe id of each body, as its wrapper's _multi call passes it
MULTI_PROBE = dict(zip(
    ["P6c", "P6d", "P6e", "P6f", "P6g", "P7a", "P7b", "P7c", "P7d", "P7e",
     "P7f", "P8a", "P8b", "P8c", "P8d", "P8e"],
    [pm.LANE_MASK, pm.SHIFT3, pm.RING4, pm.BND, pm.SUB, pm.MIN_MASK,
     pm.MAX_OUT, pm.MIN_MASK, pm.RING4, pm.RING_WRITE, pm.ANY_MASK,
     pm.MAX_MIN, pm.STACK, pm.WHILE_G11, pm.ADD_SCALAR, pm.REGISTRY]))


def _multi_probe_at(pid, fn, args, plan):
    """Run body ``pid``'s kernel (wrapper ``fn``) on ``args`` (on the
    card) at ``plan``, as its wrapper calls ``_multi``."""
    probe = MULTI_PROBE[pid]
    if pid == "P6f":
        x, aux = args
    elif pid == "P8d":
        aux, x = args
    else:
        x, aux = args[0], None
    G = x.shape[0]
    n_s = {pm.LANE_MASK: G, pm.MAX_OUT: G, pm.MAX_MIN: G + 1}.get(probe, 0)
    padded = probe in pm.RINGS
    return pm._multi(fn, probe, pm._pad8(x) if padded else x, aux=aux,
                     n_s=n_s, padded=padded, plan=plan)


def _multi_cells():
    """(pid, shape, plan) of every body at every shape it takes, on the
    chooser's plan for an H100 (None), for a card of one SM, and on every
    forced plan the kernel takes there."""
    cells = []
    for pid, _, _ in MULTI_BODIES:
        probe = MULTI_PROBE[pid]
        for G, R, L in MULTI_SHAPES:
            RX = R + 8 if probe in pm.RINGS else R
            try:
                pm.check_multi_shape(probe, G, R, L, RX)
            except ValueError:
                continue
            plans = [None, pm.multi_plan(G, R, L, 1, pb.SMEM_OPTIN, probe)]
            for plan in MULTI_PLANS:
                try:
                    pm.check_multi_plan(plan, probe, G, R, L)
                except ValueError:
                    continue
                plans.append(plan)
            cells += [(pid, (G, R, L), p) for p in dict.fromkeys(plans)]
    return cells


MULTI_CELLS = _multi_cells()


@pytest.mark.parametrize("cell", range(len(MULTI_CELLS)))
def test_probe_multi_at_every_shape_and_plan(dev, cell):
    """Each multi body (P6c-P8e) against its plain version, bit for bit, at
    G = 1, 2, 4, 8, L = 130, odd R and a lane of 4 CTAs, on the chooser's
    plan, a one-SM card's, and forced plans (clusters of 1-8 CTAs)."""
    pid, (G, R, L), plan = MULTI_CELLS[cell]
    fn, plain = next((f, p) for i, f, p in MULTI_BODIES if i == pid)
    args = _multi_inputs(pid, G, R, L, cell)
    want = plain(*args)
    cargs = [a.to(dev) for a in args]
    before = fn.launches
    got = (fn(*cargs) if plan is None
           else _multi_probe_at(pid, fn, cargs, plan))
    assert fn.launches == before + 1
    torch.cuda.synchronize()
    got = [g.cpu() for g in (got if isinstance(got, tuple) else [got])]
    assert mb.max_abs_err(got, want) == 0, (pid, (G, R, L), plan)


def _while_cells():
    """(G, plan) of the 16-round case: the chooser's plan, and forced plans
    where the kernel takes them (clusters of G x C <= 8 CTAs)."""
    cells = []
    for G in (1, 2, 4, 8):
        cells.append((G, None))
        for plan in [(1, 32, 2), (2, 32, 1), (4, 32, 1)]:
            try:
                pm.check_multi_plan(plan, pm.WHILE_G11, G, 9, 16)
            except ValueError:
                continue
            cells.append((G, plan))
    return cells


@pytest.mark.parametrize("G,plan", _while_cells())
def test_probe_multi_while_runs_every_round(dev, G, plan):
    """P8c's loop of rounds on data that keeps lane 0 below 300 for all 16
    rounds (x = 1 mod 7: two hits an element over 16 rounds, 144 words)
    while the other lanes finish early, at one CTA a lane and at clusters
    of up to 8 CTAs."""
    rng = np.random.default_rng(G)
    x = rng.integers(0, 100, (G, 9, 16), dtype=np.int32)
    x[0] = 7 * (x[0] // 7) + 1
    x = torch.from_numpy(x)
    want = pm.multi3_f_c_plain(x)
    assert int(want[0, 0, 0]) == 2 * 144
    got = (pm.multi3_f_c(x.to(dev)) if plan is None else
           _multi_probe_at("P8c", pm.multi3_f_c, [x.to(dev)], plan))
    assert torch.equal(got.cpu(), want)


def test_probe_multi_refuses_what_the_kernel_refused(dev, monkeypatch):
    """No fallback: a shape the single-block kernel refused and a plan the
    kernel does not take raise ValueError on the host; past those checks
    the kernel's entry refuses both (RuntimeError), with no launch."""
    big = torch.zeros((8, 64, 128), dtype=torch.int32, device=dev)
    x = torch.zeros((4, 64, 128), dtype=torch.int32, device=dev)
    # short of the lane, nv past 4, no whole warps, no CTA, a cluster of 9
    bad = [(1, 1024, 1), (1, 1024, 5), (1, 48, 2), (0, 1024, 2),
           (9, 1024, 1)]
    with pytest.raises(ValueError):
        pm.multi2_f_a(big)
    for plan in bad:
        with pytest.raises(ValueError):
            pm._multi(pm.multi2_f_a, pm.MIN_MASK, x, plan=plan)
    with pytest.raises(ValueError):   # a cluster of 4 x 4 CTAs
        pm._multi(pm.multi3_f_a, pm.MAX_MIN, x, n_s=5, plan=(4, 512, 1))
    monkeypatch.setattr(pm, "check_multi_shape", lambda *a: None)
    monkeypatch.setattr(pm, "check_multi_plan", lambda *a, **k: None)
    before = (pm.multi2_f_a.launches, pm.multi3_f_a.launches)
    with pytest.raises(RuntimeError):
        pm._multi(pm.multi2_f_a, pm.MIN_MASK, big, plan=(1, 1024, 4))
    for plan in bad:
        with pytest.raises(RuntimeError):
            pm._multi(pm.multi2_f_a, pm.MIN_MASK, x, plan=plan)
    with pytest.raises(RuntimeError):
        pm._multi(pm.multi3_f_a, pm.MAX_MIN, x, n_s=5, plan=(4, 512, 1))
    assert (pm.multi2_f_a.launches, pm.multi3_f_a.launches) == before


@pytest.mark.parametrize("M", [256, 200, 1])
@pytest.mark.parametrize("iters", [0, 1, 17, 1000])
def test_probe_roll_matches_plain(dev, M, iters):
    """P4b on roll_plan's CTA against the plain version, bit for bit, at
    M = 256 (the tool's), 200 (no power of two) and 1."""
    rng = np.random.default_rng(M + iters)
    x = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (8, M),
                                      dtype=np.int32))
    before = pb.dynamic_roll.launches
    got = pb.dynamic_roll(x.to(dev), iters)
    assert pb.dynamic_roll.launches == before + 1
    assert torch.equal(got.cpu(), pb.dynamic_roll_plain(x, iters))


@pytest.mark.parametrize("R,M,plan", [
    (8, 256, (64, 32)), (8, 256, (256, 8)), (8, 256, (1024, 4)),
    (8, 200, (64, 32)), (1, 29056, None), (29, 1001, None),
    (1024, 1, None), (7, 3, (32, 1)), (7, 3, None), (56, 513, None)])
def test_probe_roll_at_forced_plans_and_edges(dev, R, M, plan):
    """P4b at forced plans (up to 32 elements a thread, partial last
    warps, threads a multiple of M or not) and at the edges of what it
    takes: the largest tile whose double buffer fits (M past 1024 threads),
    a column of 1024 rows, a tile smaller than a warp, 32 elements a
    thread where no multiple of M holds the tile."""
    rng = np.random.default_rng(R * M)
    x = torch.from_numpy(rng.integers(0, 1 << 20, (R, M), dtype=np.int32))
    got = pb._roll(x.to(dev), 37, plan)
    assert torch.equal(got.cpu(), pb.dynamic_roll_plain(x, 37))


def test_probe_roll_refuses_bad_plans(dev, monkeypatch):
    x = torch.zeros((8, 256), dtype=torch.int32, device=dev)
    bad = [(512, 2), (1024, 3), (48, 64), (2048, 1)]
    for plan in bad:
        with pytest.raises(ValueError):
            pb._roll(x, 3, plan)
    with pytest.raises(ValueError):   # 2 x 29,057 words: past a block
        pb.dynamic_roll(torch.zeros((1, 29057), dtype=torch.int32,
                                    device=dev), 1)
    monkeypatch.setattr(pb, "check_roll_plan", lambda *a: None)
    before = pb.dynamic_roll.launches
    for plan in bad:
        with pytest.raises(RuntimeError):
            pb._roll(x, 3, plan)
    assert pb.dynamic_roll.launches == before


def _slice_inputs(lane, width, iters, seed):
    """A P4c row [1, width] or a P4d table [width, 128], and ``iters``
    starts or rows over the whole legal range and past both of its ends,
    both ends and INT_MIN / INT_MAX first where iters allows."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(-(1 << 31), 1 << 31, (1, width) if lane
                       else (width, 128), dtype=np.int64).astype(np.int32)
    hi = width - 128 if lane else width - 2
    idx = rng.integers(-5, hi + 6, iters).astype(np.int32)
    edges = [0, hi, hi + 1, -1, (1 << 31) - 1, -(1 << 31)]
    idx[:min(iters, 6)] = edges[:min(iters, 6)]
    return torch.from_numpy(tab), torch.from_numpy(idx.reshape(1, iters))


def _slice_on(lane, dev, tab, idx, plan, offset=0):
    """The slice kernel on ``plan`` on ``dev``, its table ``offset`` words
    into a larger buffer (16-byte unaligned where offset % 4 != 0)."""
    full = torch.empty(offset + tab.numel(), dtype=torch.int32, device=dev)
    full[offset:] = tab.reshape(-1).to(dev)
    t = full[offset:].reshape(tab.shape)
    if lane:
        return pb._lane_slice(t, idx.to(dev), plan)
    return pb._sublane_slice(t, idx.to(dev), plan)


@pytest.mark.parametrize("iters", [0, 1, 17, 200, 4097, 100000])
@pytest.mark.parametrize("lane", [True, False])
def test_probe_slices_match_plain(dev, lane, iters):
    """P4c ([1, 8192]) and P4d ([512, 128]) on slice_plan's plan against
    their plain versions, bit for bit, one launch counted."""
    tab, idx = _slice_inputs(lane, 8192 if lane else 512, iters, iters)
    fn = pb.lane_slice if lane else pb.sublane_slice
    plain = pb.lane_slice_plain if lane else pb.sublane_slice_plain
    before = fn.launches
    got = fn(tab.to(dev), idx.to(dev))
    assert fn.launches == before + 1
    assert torch.equal(got.cpu(), plain(tab, idx))


@pytest.mark.parametrize("width,offset", [(128, 0), (8192, 0), (8190, 0),
                                          (8190, 1),
                                          (pb.SMEM_OPTIN // 4, 0),
                                          (2, 0), (512, 0), (512, 3)])
@pytest.mark.parametrize("iters,plan", [
    (17, (1, 32)), (200, (1, 512)), (200, (132, 512)), (200, (300, 64)),
    (4097, None), (4097, (1024, 32)), (100000, (1, 512)),
    (100000, None)])
def test_probe_slices_at_forced_plans_and_widths(dev, width, offset, iters,
                                                 plan):
    """Both kernels at forced plans (one warp, one CTA, the SM count, more
    CTAs than the iterations give SLICE_MIN_ITERS each or than there are
    iterations) and at their edges: P4c rows of 128, 8192, 8190 (a tail
    past the 16-byte staging), 8190 at a 4-byte offset (staged by words)
    and the largest that fits; P4d tables of 2 and 512 rows, 512 at a
    12-byte offset (rows by 4-byte loads)."""
    lane = width not in (2, 512)
    if plan is None:
        plan = pb.slice_plan(iters, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    elif plan[0] == 132:
        plan = (torch.cuda.get_device_properties(dev).multi_processor_count,
                plan[1])
    tab, idx = _slice_inputs(lane, width, iters, width + iters)
    plain = pb.lane_slice_plain if lane else pb.sublane_slice_plain
    got = _slice_on(lane, dev, tab, idx, plan, offset)
    assert torch.equal(got.cpu(), plain(tab, idx)), (plan, width)


@pytest.mark.parametrize("lane", [True, False])
def test_probe_slices_twice_in_a_row(dev, lane):
    """Launches one after another on one stream, at plans of many CTAs,
    one and many again: a ticket or partial a launch leaves does not leak
    into the next (out is never zeroed before a launch)."""
    width = 8192 if lane else 512
    plain = pb.lane_slice_plain if lane else pb.sublane_slice_plain
    for k, (iters, plan) in enumerate([(5000, (132, 512)), (5000, (132, 512)),
                                       (300, (1, 64)), (4097, (77, 256)),
                                       (4097, (132, 512)), (0, (5, 32))]):
        tab, idx = _slice_inputs(lane, width, iters, k)
        got = _slice_on(lane, dev, tab, idx, plan)
        assert torch.equal(got.cpu(), plain(tab, idx)), (k, plan)


def test_probe_slices_refuse_bad_plans(dev, monkeypatch):
    """A plan or width the kernels do not take raises ValueError before a
    launch; past the Python checks, the C entries refuse the same
    (RuntimeError), and no launch is counted."""
    row = torch.zeros((1, 8192), dtype=torch.int32, device=dev)
    tab = torch.zeros((512, 128), dtype=torch.int32, device=dev)
    idx = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    bad = [(0, 32), (1025, 32), (1, 16), (1, 48), (1, 1024)]
    for plan in bad:
        with pytest.raises(ValueError):
            pb._lane_slice(row, idx, plan)
        with pytest.raises(ValueError):
            pb._sublane_slice(tab, idx, plan)
    short = torch.zeros((1, 127), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        pb.lane_slice(short, idx)
    with pytest.raises(ValueError):
        pb.sublane_slice(tab[:1], idx)
    monkeypatch.setattr(pb, "check_slice_plan", lambda *a: None)
    monkeypatch.setattr(pb, "check_lane_slice", lambda *a: None)
    before = (pb.lane_slice.launches, pb.sublane_slice.launches)
    for plan in bad:
        with pytest.raises(RuntimeError):
            pb._lane_slice(row, idx, plan)
        with pytest.raises(RuntimeError):
            pb._sublane_slice(tab, idx, plan)
    with pytest.raises(RuntimeError):
        pb._lane_slice(short, idx, (1, 32))
    big = torch.zeros((1, pb.SMEM_OPTIN // 4 + 1), dtype=torch.int32,
                      device=dev)
    with pytest.raises(RuntimeError):
        pb._lane_slice(big, idx, (1, 32))
    assert (pb.lane_slice.launches, pb.sublane_slice.launches) == before


def test_probe_empty_kernel_counts_no_probe_launch(dev):
    """The launch floor's empty kernel runs, counts on its own wrapper
    only, and leaves the tool's 32 wrappers and 61 cases as they were."""
    wrappers = mb.wrappers()
    before = [f.launches for f in wrappers]
    e0 = pb.empty.launches
    pb.empty(dev)
    torch.cuda.synchronize()
    assert pb.empty.launches == e0 + 1
    assert [f.launches for f in wrappers] == before
    assert len(wrappers) == 32 and len(mb.all_cases()) == 61
    assert pb.empty not in wrappers
    assert mb.launch_floor(dev) > 0


def test_probe_dep_floor_counts_no_probe_launch(dev):
    """The dependent-load floor's kernel runs, counts on its own wrapper
    only, outside the tool's 32 wrappers, and takes longer than nothing."""
    wrappers = mb.wrappers()
    before = [f.launches for f in wrappers]
    d0 = pb.dep_floor.launches
    pb.dep_floor(dev)
    torch.cuda.synchronize()
    assert pb.dep_floor.launches == d0 + 1
    assert [f.launches for f in wrappers] == before
    assert pb.dep_floor not in wrappers
    assert mb.dep_floor(dev) > 0


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _at(dev, t, offset):
    """``t`` on ``dev``, ``offset`` words into a larger buffer (16-byte
    unaligned where offset % 4 != 0)."""
    full = torch.empty(offset + t.numel(), dtype=torch.int32, device=dev)
    full[offset:] = t.reshape(-1).to(dev)
    return full[offset:].reshape(t.shape)


def _refill_inputs(NW, WR, seed):
    """A [1, NW] table and WR bases over the legal range and past both
    ends, both ends and INT_MIN / INT_MAX first where WR allows."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(-(1 << 31), 1 << 31, (1, NW),
                       dtype=np.int64).astype(np.int32)
    bases = rng.integers(-5, NW - 128 + 6, (WR, 1)).astype(np.int32)
    edges = [0, NW - 128, NW - 127, -1, (1 << 31) - 1, -(1 << 31)]
    bases[:min(WR, 6), 0] = edges[:min(WR, 6)]
    return torch.from_numpy(tab), torch.from_numpy(bases)


@pytest.mark.parametrize("WR,NW", [(32, 8192), (1, 128), (7, 8193),
                                   (37, 8192), (1000, 8192)])
@pytest.mark.parametrize("plan", [None, (1, 1), (1, 32), (3, 5), (132, 1),
                                  (2000, 1)])
@pytest.mark.parametrize("offset", [0, 1])
def test_probe_refill_at_forced_plans_and_edges(dev, WR, NW, plan, offset):
    """P4e at the chooser's plan and forced ones (one warp for every row,
    one CTA of 32 warps, a row count no CTA's warps divide, a CTA an SM,
    more warps than rows), at tables of one row's words and odd widths,
    the table one word off 16 bytes, bases out of range both ways."""
    if plan == (132, 1):
        plan = (_sms(dev), 1)
    tab, bases = _refill_inputs(NW, WR, WR + NW + offset)
    before = pb.refill.launches
    got = pb._refill(_at(dev, tab, offset), _at(dev, bases, offset), plan)
    assert pb.refill.launches == before + 1
    assert torch.equal(got.cpu(), pb.refill_plain(tab, bases)), plan


def test_probe_refill_twice_in_a_row(dev):
    """Launches one after another on one stream at other plans and row
    counts: each output holds its own launch's rows only."""
    for k, (WR, plan) in enumerate([(32, None), (32, (1, 32)), (5, (5, 1)),
                                    (300, None), (32, (32, 1))]):
        tab, bases = _refill_inputs(8192, WR, k)
        got = pb._refill(tab.to(dev), bases.to(dev), plan)
        assert torch.equal(got.cpu(), pb.refill_plain(tab, bases)), k


# (Rt, Mt, Ri, Mi, axis): P3's six forms as 2-D, P6's [256, 128], then
# rows no unit of 4 divides and a single element
ONCE_SHAPES = [(8, 2048, 8, 2048, 1), (8, 2048, 8, 512, 1),
               (8, 512, 8, 2048, 1), (64, 512, 8, 512, 0),
               (8, 512, 8, 512, 0), (32, 512, 32, 512, 1),
               (256, 128, 256, 128, 1), (8, 2050, 8, 2050, 1),
               (7, 5, 7, 3, 1), (9, 13, 2, 13, 0), (1, 1, 1, 1, 1)]


def _once_inputs(shape, seed):
    """tab and idx of one gather, the indices over the axis and past both
    of its ends, INT_MIN among them; with the indices clamped, as the
    kernel clamps them, for the plain versions (which raise on them)."""
    Rt, Mt, Ri, Mi, axis = shape
    n_ax = Mt if axis == 1 else Rt
    rng = np.random.default_rng(seed)
    tab = rng.integers(-(1 << 31), 1 << 31, (Rt, Mt),
                       dtype=np.int64).astype(np.int32)
    idx = rng.integers(-3, n_ax + 3, (Ri, Mi)).astype(np.int32)
    idx.reshape(-1)[:4] = [0, n_ax - 1, n_ax, -(1 << 31)][:idx.size]
    return (torch.from_numpy(tab), torch.from_numpy(idx),
            torch.from_numpy(np.clip(idx, 0, n_ax - 1)))


@pytest.mark.parametrize("shape", ONCE_SHAPES)
@pytest.mark.parametrize("plan", [None, (1, 32), (3, 64), (132, 32),
                                  (1000, 1024)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("chain", [False, True])
def test_probe_gather_once_at_forced_plans_and_edges(dev, shape, plan,
                                                     offset, chain):
    """One gather (P3, P6a, P6b; P2's chain at one iteration with
    ``chain``) at the chooser's plan and forced ones that loop or leave
    CTAs idle, by units of 4 and, with tab and idx one word off 16 bytes
    or rows no unit divides, by single outputs; indices out of range
    both ways."""
    Rt, Mt, Ri, Mi, axis = shape
    if plan == (132, 32):
        plan = (_sms(dev), 32)
    tab, idx, clamped = _once_inputs(shape, Rt + Mi + offset)
    lim = (Rt, Mt)[axis] if chain else 1
    wrapper = pb.gather_chain if chain else pb.take_along
    before = wrapper.launches
    got = pb._gather2d(wrapper, _at(dev, tab, offset), _at(dev, idx, offset),
                       axis, 1, chain, lim, plan=plan)
    assert wrapper.launches == before + 1
    want = (pb.gather_chain_plain(tab, clamped, axis, 1) if chain
            else pb.take_along_plain(tab, clamped, axis))
    assert torch.equal(got.cpu(), want), plan


@pytest.mark.parametrize("axis", [1, 0])
def test_probe_gather_chain_at_one_iteration(dev, axis):
    """P2 (``gather_chain``) at iters = 1 goes through the one-shot kernel
    and equals its plain version at the tool's [8, 2048]."""
    c = [c for c in mb.mosaic2_cases() if f"ax{axis}" in c.label][0]
    x, xt = mb.inputs(c, 3, 1, dev)
    before = pb.gather_chain.launches
    got = pb.gather_chain(xt[0], xt[1], axis, 1)
    assert pb.gather_chain.launches == before + 1
    want = pb.gather_chain_plain(*(torch.from_numpy(v) for v in x), axis, 1)
    assert torch.equal(got.cpu(), want)


def test_probe_gather_once_twice_in_a_row(dev):
    """One-shot gathers one after another on one stream at other shapes
    and plans, each held to its plain version."""
    for k, (shape, plan) in enumerate([
            (ONCE_SHAPES[0], None), (ONCE_SHAPES[6], (1, 32)),
            (ONCE_SHAPES[7], None), (ONCE_SHAPES[0], (3, 64)),
            (ONCE_SHAPES[3], None)]):
        tab, idx, clamped = _once_inputs(shape, k)
        got = pb._gather2d(pb.take_along, tab.to(dev), idx.to(dev),
                           shape[4], 1, False, plan=plan)
        assert torch.equal(got.cpu(),
                           pb.take_along_plain(tab, clamped, shape[4])), k


def test_probe_refill_and_once_refuse_bad_plans(dev, monkeypatch):
    """A plan or shape the refill or one gather does not take raises
    ValueError before a launch; past the Python checks, the C entries
    refuse the same (RuntimeError), and no launch is counted."""
    tab = torch.zeros((1, 8192), dtype=torch.int32, device=dev)
    bases = torch.zeros((32, 1), dtype=torch.int32, device=dev)
    t2 = torch.zeros((8, 64), dtype=torch.int32, device=dev)
    short = torch.zeros((1, 127), dtype=torch.int32, device=dev)
    rbad = [(0, 1), (65536, 1), (1, 0), (1, 33)]
    obad = [(0, 32), (65536, 32), (1, 16), (1, 1056)]
    for plan in rbad:
        with pytest.raises(ValueError):
            pb._refill(tab, bases, plan)
    for plan in obad:
        with pytest.raises(ValueError):
            pb._gather2d(pb.take_along, t2, t2, 1, 1, False, plan=plan)
    with pytest.raises(ValueError):
        pb.refill(short, bases)
    with pytest.raises(ValueError):
        pb._gather2d(pb.take_along, t2, t2[:7], 1, 1, False)
    monkeypatch.setattr(pb, "check_refill_plan", lambda *a: None)
    monkeypatch.setattr(pb, "check_refill", lambda *a: None)
    monkeypatch.setattr(pb, "check_once_plan", lambda *a: None)
    monkeypatch.setattr(pb, "check_gather_shape", lambda *a: None)
    before = (pb.refill.launches, pb.take_along.launches)
    for plan in rbad:
        with pytest.raises(RuntimeError):
            pb._refill(tab, bases, plan)
    for plan in obad:
        with pytest.raises(RuntimeError):
            pb._gather2d(pb.take_along, t2, t2, 1, 1, False, plan=plan)
    with pytest.raises(RuntimeError):
        pb._refill(short, bases, (1, 1))
    with pytest.raises(RuntimeError):
        pb._gather2d(pb.take_along, t2, t2[:7], 1, 1, False, plan=(1, 32))
    assert (pb.refill.launches, pb.take_along.launches) == before


# K1 at every cluster size: CTAs per lane, 16 where the card holds one
# cluster of 16 (a non-portable size)
K1_CS = (1, 2, 4, 8, 16)
SHRINK_PAIR, SHRINK_PENS = (b"A" * 63, b"C" * 64), \
    dict(x=8, o1=8, e1=4, o2=20, e2=2)


def _k1_at_every_c(spec, args, segs=None):
    """K1 at every C of K1_CS against the plain version on the same
    inputs: every output, traceback byte, band row and snapshot entry.
    Returns the plain outputs."""
    want = wk.wavefront_plain(spec, *args, segs)
    counts = wk.cluster_counts(spec, args[0].device)
    for C in K1_CS:
        if C == 16 and counts[16] < 1:
            continue
        got = wk.launch(spec, *args, segs, C=C)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w), C
    return want


def _bench8k():
    from chip_smoke import make_pairs
    pairs = make_pairs(8000, 64)[:8]
    return [t.encode() for t, _ in pairs], [q.encode() for _, q in pairs]


def _k1_modes_at_every_c(ts, qs, dev, opt, step, shape=None):
    """SCORE, TB, PASS1 at ``step`` and TB with the decoded checkpoints of
    that whole pass 1, each at ``shape`` (W, S_CAP) or else at its first
    dispatch shape, at every C.  Returns the plain outputs by mode."""
    def inputs(o, mode, bk):
        W, S_CAP = shape or (bk.W, bk.S_CAP)
        spec, lanes, tw, qw = exact.kernel_inputs(o, mode, W, S_CAP, ts, qs)
        return spec, lanes, [torch.from_numpy(a).to(dev)
                             for a in (lanes, tw, qw)]

    outs = {}
    for mode in (wk.MODE_SCORE, wk.MODE_TB):
        o = opt.replace(cigar=mode == wk.MODE_TB)
        bk, _ = exact.first_bucket(o, mode, ts, qs, 512, 512, dev)
        spec, _, args = inputs(o, mode, bk)
        outs[mode] = _k1_at_every_c(spec, args)[0]
    o = opt.replace(cigar=True, step=step)
    bk, _ = exact.first_bucket(o, wk.MODE_PASS1, ts, qs, 512, 512, dev)
    spec, lanes, args = inputs(o, wk.MODE_PASS1, bk)
    out, _, _, snap = _k1_at_every_c(spec, args)
    assert int(out[:, wk.O_DONE].sum()) == len(ts)
    fin, recs = tbd.chain_ptrs(snap, out[:, wk.O_LP], out[:, wk.O_SNC])
    o1 = out.cpu().numpy()
    segs = [tbk.decode_checkpoints_ptrs(recs[:, j], int(fin[j]),
                                        int(lanes[j, wk.L_ANC]),
                                        int(o1[j, wk.O_SNC]), spec)
            for j in range(len(ts))]
    bk, _ = exact.pass2_bucket(o, [int(v) for v in o1[:, wk.O_S]], ts, qs,
                               512, 512, dev)
    tspec, _, args = inputs(o, wk.MODE_TB, bk)
    sg = torch.from_numpy(exact.seg_input(segs)).to(dev)
    outs["TB+seg"] = _k1_at_every_c(tspec, args, sg)[0]
    return outs


def test_k1_clusters_match_plain_on_goldens(goldens, dev):
    ts, qs = _golden_pairs(goldens)
    outs = _k1_modes_at_every_c(ts, qs, dev, Options(), 16, (8192, 2048))
    assert [int(v) for v in outs[wk.MODE_SCORE][:, wk.O_S]] == \
        [e["s"] for e in goldens["runs"]["score"]]
    assert [int(v) for v in outs["TB+seg"][:, wk.O_S]] == \
        [e["s"] for e in goldens["runs"]["lowmem_p16"]]


def test_k1_clusters_match_plain_on_bench8k(dev):
    ts, qs = _bench8k()
    outs = _k1_modes_at_every_c(ts, qs, dev, Options(), 200)
    assert int(outs[wk.MODE_TB][:, wk.O_DONE].sum()) == len(ts)


@pytest.mark.parametrize("o2", [40, 100])
def test_k1_clusters_match_plain_on_t3_large_gap_open(goldens, dev, o2):
    case = next(c for c in goldens["cases"] if c["name"] == "t3")
    ts, qs = [case["t"].encode("latin1")], [case["q"].encode("latin1")]
    outs = _k1_modes_at_every_c(ts, qs, dev, Options(o2=o2, e2=1), 16,
                                (8192, 2048))
    assert int(outs[wk.MODE_SCORE][0, wk.O_S]) == {40: 180, 100: 240}[o2]


@pytest.mark.parametrize("mode", [wk.MODE_SCORE, wk.MODE_TB])
def test_k1_clusters_shrink_pair(dev, mode):
    """ROADMAP's shrink pair past the 256-cycle shrink: s=294 and
    n_iter=27254 at every C, as the plain version."""
    opt = Options(cigar=mode == wk.MODE_TB, **SHRINK_PENS)
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, 1024, 1024,
                                              [SHRINK_PAIR[0]] * 3,
                                              [SHRINK_PAIR[1]] * 3)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    out = _k1_at_every_c(spec, args)[0]
    assert out[:, wk.O_S].tolist() == [294] * 3
    assert out[:, wk.O_NITER].tolist() == [27254] * 3


@pytest.mark.parametrize("mode", [wk.MODE_SCORE, wk.MODE_TB, wk.MODE_PASS1])
def test_k1_clusters_empty_pairs(dev, mode):
    """Empty sequences beside short ones: termination at score 0 (with
    PASS1's origin pointer) and overflow-free ends at every C."""
    ts = [b"", b"", b"AAAA", b"ACGT", b"A"]
    qs = [b"", b"ACG", b"", b"ACGT", b"G"]
    opt = Options(cigar=mode != wk.MODE_SCORE,
                  step=4 if mode == wk.MODE_PASS1 else 0)
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, 512, 256, ts, qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    out = _k1_at_every_c(spec, args)[0]
    assert int(out[:, wk.O_DONE].sum()) == len(ts)
    assert int(out[0, wk.O_S]) == 0


def test_k1_clusters_pass1_out_of_snapshot_rows(goldens, dev):
    """PASS1 with 2 snapshot rows at step 16: every lane past score 47
    stops as a band overflow (O_OVFB), at every C as in the plain
    version."""
    import dataclasses
    ts, qs = _golden_pairs(goldens)
    spec, lanes, tw, qw = exact.kernel_inputs(
        Options(cigar=True, step=16), wk.MODE_PASS1, 8192, 2048, ts, qs)
    spec = dataclasses.replace(spec, n_snap=2)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    out = _k1_at_every_c(spec, args)[0]
    ovf = out[:, wk.O_OVFB] == 1
    assert bool(ovf.any()) and bool((out[ovf, wk.O_SNC] == 2).all())


@pytest.mark.parametrize("run", ["score", "cigar"])
def test_multi_kernel_g4_matches_k1_clusters(dev, run):
    """K4 at G=4 against K1 at its picked C and at C = 1 on the 8 kb
    pairs: every output, traceback byte and band row."""
    ts, qs = _bench8k()
    opt = Options(cigar=run == "cigar")
    mode = wk.MODE_TB if opt.cigar else wk.MODE_SCORE
    bk, _ = exact.first_bucket(opt, mode, ts, qs, 512, 512, dev)
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, bk.W, bk.S_CAP,
                                              ts, qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    got = wm.wavefront_multi(spec, 4, *args)
    picked = wk.wavefront(spec, *args)
    card = args[0].device.index
    assert wk.wavefront.clusters[card][wk.launch_mode(spec, None)]["C"] > 1
    _equal(got, picked)
    _equal(got, wk.launch(spec, *args, None, C=1))


def test_k1_cluster_launch_refused_raises(dev):
    """A cluster size the wrapper does not take raises before any launch;
    the card's counts are positive at every cluster size but 16."""
    spec = wk.KSpec(W=512, S_CAP=64, x=4, o1=4, e1=2, o2=15, e2=1)
    counts = wk.cluster_counts(spec, dev)
    assert all(counts[C] > 0 for C in (2, 4, 8))
    lanes = torch.zeros((1, wk.L_N), dtype=torch.int64, device=dev)
    w = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        wk.launch(spec, lanes, w, w, None, C=32)


# W1: each variant against walk_plain, bit for bit in runs and counts

def _walk_variants(tb, meta, tw, qw, cpw, pens):
    """Each W1 variant equals walk_plain on the same inputs, bit for bit;
    returns the plain outputs."""
    want = tbd.walk_plain(tb, meta, tw, qw, cpw, pens)
    for v in tbd.VARIANTS:
        before = tbd.walk.launches_by_variant[v]
        got = tbd.walk(tb, meta, tw, qw, cpw, pens, variant=v)
        torch.cuda.synchronize()
        assert tbd.walk.launches_by_variant[v] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), v
    return want


def _k1_walk_inputs(dev, opt, ts, qs, W, S_CAP):
    """K1's traceback of the pairs and the walker's inputs for it."""
    spec, lanes, tw, qw = exact.kernel_inputs(opt, wk.MODE_TB, W, S_CAP, ts,
                                              qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    out, tb, _, _ = wk.wavefront(spec, *args)
    meta = torch.from_numpy(exact.walk_meta(lanes, out.cpu().numpy()))
    return (tb, meta.to(dev), args[1], args[2], spec.cpw,
            (opt.x, opt.o1, opt.e1, opt.o2, opt.e2))


@pytest.mark.parametrize("run,opt", [
    ("cigar", Options(cigar=True)),
    ("edit_cigar", Options(cigar=True).as_edit_distance()),
    ("affine_cigar", Options(cigar=True).as_single_affine())])
def test_walk_variants_match_plain_on_goldens(goldens, dev, run, opt):
    """The goldens in one batch (cpw 4: lower_n and the N cases among
    them), then their ACGT-only cases (cpw 16): every variant equals
    walk_plain, and the CIGARs equal the goldens'."""
    ts, qs = _golden_pairs(goldens)
    inputs = _k1_walk_inputs(dev, opt, ts, qs, 8192, 4096)
    assert inputs[4] == 4
    want = _walk_variants(*inputs)
    assert [cigar.to_string(c) for c in tbd.to_cigars(*want)] == \
        [e["cigar"] for e in goldens["runs"][run]]
    acgt = [j for j, (t, q) in enumerate(zip(ts, qs))
            if not (set(t + q) - set(b"ACGT"))]
    inputs = _k1_walk_inputs(dev, opt, [ts[j] for j in acgt],
                             [qs[j] for j in acgt], 8192, 4096)
    assert inputs[4] == 16
    _walk_variants(*inputs)


@pytest.mark.parametrize("o2", [0, 40, 100])
def test_walk_variants_match_plain_on_t3(goldens, dev, o2):
    """t3 (its 128-bp insertion crosses tiles sideways) at the default
    penalties and at o2=40 and o2=100 (e2=1): one gap step of 101 rows
    jumps past a 64-row tile."""
    case = next(c for c in goldens["cases"] if c["name"] == "t3")
    opt = Options(cigar=True, **({"o2": o2, "e2": 1} if o2 else {}))
    inputs = _k1_walk_inputs(dev, opt, [case["t"].encode("latin1")] * 3,
                             [case["q"].encode("latin1")] * 3, 8192, 2048)
    want = _walk_variants(*inputs)
    assert {cigar.to_string(c) for c in tbd.to_cigars(*want)} == \
        {"1X16=1X14=128I4=1X24="}


def test_walk_variants_match_plain_on_bench8k(dev):
    ts, qs = _bench8k()
    opt = Options(cigar=True)
    bk, _ = exact.first_bucket(opt, wk.MODE_TB, ts, qs, 512, 512, dev)
    _walk_variants(*_k1_walk_inputs(dev, opt, ts, qs, bk.W, bk.S_CAP))


def test_walk_variants_match_plain_on_empty_and_skipped_lanes(goldens, dev):
    """Empty pairs beside short ones, and the goldens with every other
    lane skipped (tl = ql = 0, as walk_meta leaves a stopped lane)."""
    opt = Options(cigar=True)
    inputs = _k1_walk_inputs(dev, opt, [b"", b"", b"AAAA", b"ACGT", b"A"],
                             [b"", b"ACG", b"", b"ACGT", b"G"], 512, 256)
    want = _walk_variants(*inputs)
    assert tbd.to_cigars(*want)[:3] == [[], [(3 << 4) | 1], [(4 << 4) | 2]]
    ts, qs = _golden_pairs(goldens)
    tb, meta, *rest = _k1_walk_inputs(dev, opt, ts, qs, 8192, 4096)
    meta[::2, tbd.M_TL:tbd.M_QL + 1] = 0
    want = _walk_variants(tb, meta, *rest)
    assert not bool(want[1][::2].any())


def test_walk_variants_match_plain_at_the_column_clamp(goldens, dev):
    """Lanes walked with their anchor moved past the window, so every
    column clamps to 0 or W-1, and seeded random tb bytes whose walks
    clamp rows and columns and can overflow the run buffer."""
    ts, qs = _golden_pairs(goldens)
    tb, meta, tw, qw, cpw, pens = _k1_walk_inputs(dev, Options(cigar=True),
                                                  ts, qs, 1024, 512)
    for shift in (4096, -4096):
        m = meta.clone()
        m[:, tbd.M_ANC] += shift
        _walk_variants(tb, m, tw, qw, cpw, pens)
    rng = np.random.default_rng(11)
    rtb = torch.from_numpy(rng.integers(0, 128, tb.shape,
                                        dtype=np.uint8)).to(dev)
    m = meta.clone()
    m[:, tbd.M_S] = torch.from_numpy(rng.integers(0, 600, len(ts))).to(dev)
    m[:, tbd.M_ANC] = torch.from_numpy(rng.integers(-1024, 1024,
                                                    len(ts))).to(dev)
    _walk_variants(rtb, m, tw, qw, cpw, pens)


def test_walk_variants_match_plain_on_k3_div100k_gaps(dev):
    """K3's traceback of div100k's first gaps dispatch (its chain plan's
    gaps of at most 127 bp, by score bound)."""
    import chip_smoke
    from miniwfa_tpu_torch.models import tiny
    from miniwfa_tpu_torch.ops import pack
    t, q = (x.encode() for x in chip_smoke.gen_case("div100k"))
    gaps = chip_smoke.chain_gaps([t], [q], Options())
    opt = Options(cigar=True)
    cpw = 16 if all(pack.can_pack2(p) for p in gaps) else 4
    sb = [tiny._s_bound(opt, len(a), len(b)) for a, b in gaps]
    sel = sorted(range(len(gaps)), key=lambda g: sb[g])[:tiny.GMAX]
    spec, lens, tw, qw = tiny.dispatch_inputs(
        opt, [gaps[g][0] for g in sel], [gaps[g][1] for g in sel], cpw,
        tiny._scap_bucket(max(sb[g] for g in sel)))
    args = [torch.from_numpy(a).to(dev) for a in (lens, tw, qw)]
    out, tb = wg.gaps(spec, *args)[:2]
    meta = torch.from_numpy(tiny.walk_meta(lens, out.cpu().numpy()))
    assert tbd.pick_variant(tb.shape[2], tw.shape[1], cpw) == "thread"
    _walk_variants(tb, meta.to(dev), args[1], args[2], cpw,
                   (opt.x, opt.o1, opt.e1, opt.o2, opt.e2))


def test_walk_bad_variant_and_width_raise(dev):
    tb = torch.zeros((1, 8, 24), dtype=torch.uint8, device=dev)
    meta = torch.zeros((1, tbd.M_N), dtype=torch.int64, device=dev)
    w = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        tbd.walk(tb, meta, w, w, 4, (4, 6, 2, 24, 1), variant="block")
    with pytest.raises(ValueError):      # W = 24 is no multiple of 16
        tbd.walk(tb, meta, w, w, 4, (4, 6, 2, 24, 1), variant="warp")


# W2: the chain kernel against chain_ptrs_plain

def _chains_equal(snap, lp, cnt):
    before = tbd.chain_ptrs.launches
    fin, recs = tbd.chain_ptrs(snap, lp, cnt)
    assert tbd.chain_ptrs.launches == before + 1
    pfin, precs = tbd.chain_ptrs_plain(snap, lp, cnt)
    assert fin.dtype == recs.dtype == np.int64
    assert (fin == pfin).all() and (recs == precs).all()
    return fin, recs


@pytest.mark.parametrize("step", [16, 100])
def test_chain_ptrs_matches_plain_on_k1_pass1(goldens, dev, step):
    """K1 PASS1's snapshots of the goldens, as they come, and with lanes
    given snapshot count 0 and last pointer -1 (overflowed lanes)."""
    ts, qs = _golden_pairs(goldens)
    spec, lanes, tw, qw = exact.kernel_inputs(
        Options(cigar=True, step=step), wk.MODE_PASS1, 8192, 2048, ts, qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    out, _, _, snap = wk.wavefront(spec, *args)
    _chains_equal(snap, out[:, wk.O_LP], out[:, wk.O_SNC])
    o = out.cpu().numpy()
    cut = np.arange(len(ts)) % 3 == 0
    fin, recs = _chains_equal(snap, np.where(cut, -1, o[:, wk.O_LP]),
                              np.where(cut, 0, o[:, wk.O_SNC]))
    assert (fin[cut] == -1).all() and (recs[:, cut] == -3).all()


def test_chain_ptrs_matches_plain_on_wide_pass1(goldens, dev):
    """The wide kernel's (K2's) pass-1 snapshots of the goldens at step
    64."""
    ts, qs = _golden_pairs(goldens)
    spec, lanes, tw, qw = exact.kernel_inputs(
        Options(cigar=True, step=64), wk.MODE_PASS1, 16384, 1100, ts, qs)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    out, snap, _ = ww.run_chunked(spec, *args)
    assert int(out[:, wk.O_SNC].max()) > 0
    _chains_equal(snap, out[:, wk.O_LP], out[:, wk.O_SNC])


# K2's tiled variant against wide_plain, bit for bit: every output, the
# state row, the planes and the snapshot rows, at forced small tiles (many
# tile boundaries and edges on the goldens and the 8 kb pairs) and at the
# chooser's

WIDE_TILES = [(32, 1), (32, 7), (64, 7), (64, 32)]
_WIDE_WANT = {}


def _wide_inputs(dev, ts, qs, opt, W=16384, S_CAP=1100, lane=None):
    """The wide engine's spec and card inputs; ``lane`` sets lane columns
    (L_MS, L_MI) of every lane."""
    mode = wk.MODE_PASS1 if opt.step else wk.MODE_SCORE
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, W, S_CAP, ts, qs)
    for col, v in (lane or {}).items():
        lanes[:, col] = v
    return spec, [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]


def _wide_vs_plain(spec, args, lims=(), key=None, **kw):
    """wide_plain in one call against the kernel in calls ending at each of
    ``lims`` and at the end, with ``kw`` forced; returns the plain outputs
    and the kernel's launches by variant over the run."""
    B, dev = args[0].shape[0], args[0].device
    big = torch.full((B,), 1 << 40, dtype=torch.int64, device=dev)
    if key is None or key not in _WIDE_WANT:
        _WIDE_WANT.clear()   # one run's plain state at a time
        pst = ww.new_state(spec, args[0])
        want = ww.wide_plain(spec, *args, pst, big)
        if key is not None:
            _WIDE_WANT[key] = (want, pst)
    else:
        want, pst = _WIDE_WANT[key]
    kst = ww.new_state(spec, args[0])
    before = ww.wide.launches_by_variant.copy()
    for lim in (*lims, 1 << 40):
        got = ww.wide(spec, *args, kst,
                      torch.full((B,), lim, dtype=torch.int64, device=dev),
                      **kw)
    assert torch.equal(got, want)
    assert torch.equal(kst.row, pst.row)
    assert torch.equal(kst.planes, pst.planes)
    assert (kst.snap is None) == (pst.snap is None)
    assert kst.snap is None or torch.equal(kst.snap, pst.snap)
    return want, ww.wide.launches_by_variant - before


@pytest.mark.parametrize("tile,batch", WIDE_TILES)
@pytest.mark.parametrize("step", [0, 16, 64, 100])
def test_wide_tiles_match_plain_on_goldens(goldens, dev, step, tile, batch):
    ts, qs = _golden_pairs(goldens)
    spec, args = _wide_inputs(dev, ts, qs, Options(cigar=bool(step),
                                                   step=step))
    want, used = _wide_vs_plain(spec, args, key=("goldens", step),
                                tile=tile, batch=batch)
    assert int(want[:, wk.O_DONE].sum()) == len(ts)
    assert used == {"tile": 1}


@pytest.mark.parametrize("step", [0, 64])
@pytest.mark.parametrize("kw", [dict(), dict(tile=64, batch=7)])
def test_wide_tiles_match_plain_on_bench8k(dev, step, kw):
    ts, qs = _bench8k()
    spec, args = _wide_inputs(dev, ts, qs, Options(cigar=bool(step),
                                                   step=step), S_CAP=2048)
    want, used = _wide_vs_plain(spec, args, key=("bench8k", step), **kw)
    assert int(want[:, wk.O_DONE].sum()) == len(ts)
    assert used == {"tile": 1}


@pytest.mark.parametrize("chunk", [77, 16])
@pytest.mark.parametrize("kw", [dict(), dict(tile=32, batch=7)])
@pytest.mark.parametrize("step", [0, 16])
def test_wide_tiles_chunked_match_plain(goldens, dev, monkeypatch, step, kw,
                                        chunk):
    """run_chunked's calls of ``chunk`` cycles a lane (pauses on every
    kind of cycle) with the tiled variant: outputs and snapshot rows."""
    ts, qs = _golden_pairs(goldens)
    spec, args = _wide_inputs(dev, ts, qs, Options(cigar=bool(step),
                                                   step=step))
    want, _ = _wide_vs_plain(spec, args, key=("goldens", step))
    real = ww.wide

    def forced(*a):
        return real(*a, **kw)

    # the counters live on the function the module's name points to
    forced.__dict__ = real.__dict__
    monkeypatch.setattr(ww, "wide", forced)
    monkeypatch.setattr(ww, "CYCLES_PER_CALL", chunk * len(ts))
    before = real.launches_by_variant["tile"]
    out, snap, _ = ww.run_chunked(spec, *args)
    assert real.launches_by_variant["tile"] - before >= 3
    assert torch.equal(out, want[:, :wk.O_N])
    assert step == 0 or torch.equal(snap, _WIDE_WANT[("goldens", step)][1]
                                    .snap)


@pytest.mark.parametrize("kw", [dict(), dict(tile=64, batch=32),
                                dict(tile=32, batch=7)])
@pytest.mark.parametrize("step", [0, 16, 64])
def test_wide_tiles_pause_on_snapshot_shrink_and_mid_batch(goldens, dev,
                                                           step, kw):
    """Pauses on snapshot cycles (15, 63), right after them (16, 64), on
    the shrink cycle (255), right after it (256), and inside a batch."""
    ts, qs = _golden_pairs(goldens)
    spec, args = _wide_inputs(dev, ts, qs, Options(cigar=bool(step),
                                                   step=step))
    _wide_vs_plain(spec, args, lims=(5, 15, 16, 40, 63, 64, 101, 255, 256,
                                      257, 300, 777),
                   key=("goldens", step), **kw)


@pytest.mark.parametrize("kw", [dict(), dict(tile=32, batch=1),
                                dict(tile=32, batch=32)])
@pytest.mark.parametrize("step", [0, 100])
def test_wide_tiles_shrink_pair(dev, step, kw):
    """ROADMAP's shrink pair past the 256-cycle shrink: s=294 and
    n_iter=27254, as the plain version."""
    opt = Options(cigar=bool(step), step=step, **SHRINK_PENS)
    spec, args = _wide_inputs(dev, [SHRINK_PAIR[0]] * 3,
                              [SHRINK_PAIR[1]] * 3, opt, W=1024, S_CAP=1024)
    want, _ = _wide_vs_plain(spec, args, lims=(255, 256), **kw)
    assert want[:, wk.O_S].tolist() == [294] * 3
    assert want[:, wk.O_NITER].tolist() == [27254] * 3


@pytest.mark.parametrize("kw", [dict(), dict(tile=32, batch=7)])
@pytest.mark.parametrize("step", [0, 16])
@pytest.mark.parametrize("o2", [40, 100])
def test_wide_tiles_large_gap_open(goldens, dev, o2, step, kw):
    """o2 = 40 and 100 (max_pen 41 and 101) on the goldens of at most
    256 bp, SCORE and PASS1 at step 16, at W=1024 (their bands stay
    narrower; PASS1's snapshot rows at W=16384 would take 36 GB)."""
    small = [c for c in goldens["cases"]
             if max(len(c["t"]), len(c["q"])) <= 256]
    opt = Options(o2=o2, e2=1, cigar=bool(step), step=step)
    spec, args = _wide_inputs(dev, [c["t"].encode("latin1") for c in small],
                              [c["q"].encode("latin1") for c in small], opt,
                              W=1024, S_CAP=512)
    want, used = _wide_vs_plain(spec, args, lims=(100,), **kw)
    assert int(want[:, wk.O_DONE].sum()) == len(small)
    assert used == {"tile": 2}


@pytest.mark.parametrize("kw", [dict(), dict(tile=32, batch=7)])
@pytest.mark.parametrize("step,stop", [
    (0, "max_s"), (0, "max_iter"), (0, "window"), (16, "max_s"),
    (16, "max_iter"), (16, "window"), (16, "rows")])
def test_wide_tiles_stops_inside_a_batch(goldens, dev, step, stop, kw):
    """A max_s stop (score 45), a max_iter stop (3000 cells), a window
    overflow (W = 200) and, in PASS1, running out of snapshot rows (2 rows)
    that fall inside a batch end the lane at that cycle, as the plain
    version."""
    import dataclasses
    ts, qs = _golden_pairs(goldens)
    opt = Options(cigar=bool(step), step=step)
    lane = {"max_s": {wk.L_MS: 45}, "max_iter": {wk.L_MI: 3000}}.get(stop,
                                                                     {})
    spec, args = _wide_inputs(dev, ts, qs, opt,
                              W=200 if stop == "window" else 16384,
                              lane=lane)
    if stop == "rows":
        spec = dataclasses.replace(spec, n_snap=2)
    want, _ = _wide_vs_plain(spec, args, **kw)
    col = {"max_s": wk.O_STOP, "max_iter": wk.O_STOP}.get(stop, wk.O_OVFB)
    assert bool(want[:, col].any())


@pytest.mark.parametrize("kw", [dict(), dict(tile=32, batch=7)])
@pytest.mark.parametrize("step", [0, 4])
def test_wide_tiles_empty_lanes(dev, step, kw):
    ts = [b"", b"", b"AAAA", b"ACGT", b"A"]
    qs = [b"", b"ACG", b"", b"ACGT", b"G"]
    spec, args = _wide_inputs(dev, ts, qs, Options(cigar=bool(step),
                                                   step=step), W=512,
                              S_CAP=256)
    want, _ = _wide_vs_plain(spec, args, **kw)
    assert int(want[:, wk.O_DONE].sum()) == len(ts)


@pytest.mark.parametrize("step", [0, 16])
def test_wide_cycle_variant_on_goldens(goldens, dev, step):
    """The forced "cycle" variant (the per-cycle body) on the goldens."""
    ts, qs = _golden_pairs(goldens)
    spec, args = _wide_inputs(dev, ts, qs, Options(cigar=bool(step),
                                                   step=step))
    _, used = _wide_vs_plain(spec, args, lims=(256,), key=("goldens", step),
                             variant="cycle")
    assert used == {"cycle": 2}


def test_wide_tile_refused_launch_raises(goldens, dev):
    """A forced tile past the card's shared memory is refused and raises,
    naming n, k and the variant; nothing is counted."""
    ts, qs = _golden_pairs(goldens)
    spec, args = _wide_inputs(dev, ts[:2], qs[:2], Options())
    st = ww.new_state(spec, args[0])
    before = ww.wide.launches
    with pytest.raises(RuntimeError, match="variant=tile n=4096 k=256"):
        ww.wide(spec, *args, st,
                torch.full((2,), 100, dtype=torch.int64, device=dev),
                tile=4096, batch=256)
    assert ww.wide.launches == before


@pytest.mark.parametrize("mode", [wk.MODE_SCORE, wk.MODE_PASS1])
def test_wide_tile_smem_matches_the_kernel(dev, mode):
    """The chooser's shared-memory count (tile_smem) equals what the kernel
    asks for at launch (csrc smem_of), at every tile of TILES and the forced
    small ones, at the default, o2 = 40 and o2 = 100 penalties; the budget
    the chooser reads (the opt-in limit less the static shared memory)
    holds the default penalties' largest tile."""
    fn = build.load("wavefront_wide", "mwf_wide_smem",
                    [ctypes.c_int] * 9 + [ctypes.c_void_p])
    got = ctypes.c_longlong(0)
    specs = [wk.KSpec(W=1 << 20, S_CAP=1 << 16, mode=mode, x=4, o1=4, e1=2,
                      o2=o2, e2=1, step=5000 if mode == wk.MODE_PASS1 else 0,
                      n_snap=8 if mode == wk.MODE_PASS1 else 0)
             for o2 in (15, 40, 100)]
    for spec in specs:
        for n, k in ww.TILES + tuple(WIDE_TILES):
            assert fn(ww.VARIANTS.index("tile"), mode, spec.x, spec.o1,
                      spec.e1, spec.o2, spec.e2, n, k,
                      ctypes.addressof(got)) == 0
            assert got.value == ww.tile_smem(spec, n, k), (spec.o2, n, k)
    budget = ww._smem_optin(dev, mode)
    assert ww.tile_smem(specs[0], *ww.TILES[0]) <= budget < 232448


def test_meter_in_a_fresh_process(dev):
    """The peak-memory meter (utils/hbm.py) in a new process, as
    bench_cuda.py runs it: reset() before CUDA is initialised, then one
    CIGAR dispatch, whose note lies above 0 and at most at the allocator's
    peak."""
    code = ("import torch\n"
            "from miniwfa_tpu_torch import Options\n"
            "from miniwfa_tpu_torch.models.exact import align_batch\n"
            "from miniwfa_tpu_torch.utils import hbm\n"
            "hbm.reset()\n"
            "align_batch([('ACGT' * 300, 'ACGA' * 300)],\n"
            "            Options(cigar=True))\n"
            "torch.cuda.synchronize()\n"
            "b, tag = hbm.peak()\n"
            "s = hbm.snapshot()\n"
            "assert tag.startswith('kernel mode=1 ') and "
            "0 < b <= s['device_peak_bytes'], s\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert p.returncode == 0, p.stderr[-2000:]


# K4's variants (csrc/wavefront_multi.cu "smem", csrc/wavefront.cu
# "global") and K3's width classes against their plain versions
EDGE_PAIRS = [(b"", b""), (b"", b"ACG"), (b"AAAA", b""), (b"A", b"G"),
              (b"ACGT" * 16, b"ACGA" * 15 + b"ACG"),     # tl + ql = 127
              (b"A" * 100, b"C" * 27)]                   # tl + ql = 127


def _multi_forced(spec, dev):
    """The global variant at 4 lanes a block, and the smem variant at 1,
    half the most and the most lanes a block the card's budget takes: a
    launch each, straight through ``wk.launch`` and ``_launch_smem``."""
    n = min(wm.LPB_MAX,
            wm._smem_budget(dev, spec.mode) // wm.lane_smem(spec))
    return [("global", lambda *a: wk.launch(spec, *a, 4))] + [
        (f"smem lpb={k}", lambda *a, k=k: wm._launch_smem(spec, *a, k))
        for k in sorted({1, max(1, n // 2), n}) if n]


def _multi_runs(ts, qs, dev, W, S_CAP, pens=None, runs=("score", "cigar",
                                                          "cigar+seg")):
    """K4 by the chooser at G = 2, 4 and 8, the global variant, and the
    smem variant at forced lanes per block, against the plain version on
    one batch in each run: every output, traceback byte and band row.
    Returns the plain outputs by run."""
    outs = {}
    for run in runs:
        opt = Options(cigar=run != "score", **(pens or {}))
        mode = wk.MODE_TB if opt.cigar else wk.MODE_SCORE
        sg = None
        if run == "cigar+seg":
            segs, _ = exact._run_pass1(opt.replace(step=16), ts, qs, 512,
                                       512, dev)
            sg = torch.from_numpy(exact.seg_input(segs)).to(dev)
        spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, W, S_CAP, ts,
                                                  qs)
        args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
        want = wk.wavefront_plain(spec, *args, sg)
        forced = _multi_forced(spec, dev)
        assert len(forced) >= 2
        for _, fn in forced:
            _equal(fn(*args, sg), want)
        for G in (2, 4, 8):
            before = dict(wm.wavefront_multi.launches_by_variant)
            got = wm.wavefront_multi(spec, G, *args, sg)
            v = wm.wavefront_multi.variants[dev.index][
                wk.launch_mode(spec, sg)]
            assert wm.wavefront_multi.launches_by_variant[v["variant"]] == \
                before.get(v["variant"], 0) + 1
            assert v["variant"] == "smem"
            _equal(got, want)
        outs[run] = want[0]
    return outs


@pytest.mark.parametrize("W", [512, 2048])
def test_multi_variants_match_plain_on_goldens(goldens, dev, W):
    """Both variants on the goldens: at W=2048 (one lane of the smem
    variant a block) and at W=512 (4 lanes a block); the widest
    lanes overflow either window, as in the plain version, and every
    other lane's score is its golden."""
    ts, qs = _golden_pairs(goldens)
    outs = _multi_runs(ts, qs, dev, W, 2048)
    out = outs["score"]
    ended = (out[:, wk.O_DONE] == 1).tolist()
    assert sum(ended) >= 60 and bool(out[:, wk.O_OVFB].any())
    assert [int(v) for v, e in zip(out[:, wk.O_S], ended) if e] == \
        [g["s"] for g, e in zip(goldens["runs"]["score"], ended) if e]


def test_multi_variants_match_plain_on_empty_and_127_bp_pairs(dev):
    ts, qs = [p[0] for p in EDGE_PAIRS], [p[1] for p in EDGE_PAIRS]
    outs = _multi_runs(ts, qs, dev, 512, 1024, runs=("score", "cigar"))
    assert int(outs["cigar"][:, wk.O_DONE].sum()) == len(ts)
    assert int(outs["score"][0, wk.O_S]) == 0


def test_multi_variants_shrink_pair(dev):
    """ROADMAP's shrink pair past the 256-cycle shrink in both variants:
    s=294 and n_iter=27254, as the plain version."""
    outs = _multi_runs([SHRINK_PAIR[0]] * 5, [SHRINK_PAIR[1]] * 5, dev,
                       1024, 1024, pens=SHRINK_PENS, runs=("score", "cigar"))
    for out in outs.values():
        assert out[:, wk.O_S].tolist() == [294] * 5
        assert out[:, wk.O_NITER].tolist() == [27254] * 5


def test_multi_smem_lane_bytes_match_the_kernel(dev):
    """``lane_smem`` against the kernel's own count, and an smem launch
    past the budget is refused by the runtime and raises."""
    fn = build.load("wavefront_multi", "mwf_multi_lane_bytes",
                    [ctypes.c_int] * 6 + [ctypes.c_void_p])
    for W in (64, 512, 1000, 2074):
        for pens in (dict(x=4, o1=4, e1=2, o2=15, e2=1),
                     dict(x=4, o1=4, e1=2, o2=100, e2=1), SHRINK_PENS):
            n = ctypes.c_longlong(0)
            assert fn(W, *pens.values(), ctypes.addressof(n)) == 0
            assert n.value == wm.lane_smem(wk.KSpec(W=W, S_CAP=64, **pens))
    spec, lanes, tw, qw = exact.kernel_inputs(Options(), wk.MODE_SCORE,
                                              4096, 64, [b"ACGT"] * 2,
                                              [b"ACGT"] * 2)
    args = [torch.from_numpy(a).to(dev) for a in (lanes, tw, qw)]
    assert wm.lane_smem(spec) > wm._smem_budget(dev, spec.mode)
    with pytest.raises(RuntimeError, match="smem, lanes_per_block=1"):
        wm._launch_smem(spec, *args, None, 1)


def _gaps_equal(pairs, opt, cpw, dev, s_cap=1024):
    from miniwfa_tpu_torch.models import tiny
    spec, lens, tw, qw = tiny.dispatch_inputs(
        opt, [a for a, _ in pairs], [b for _, b in pairs], cpw, s_cap)
    args = [torch.from_numpy(a).to(dev) for a in (lens, tw, qw)]
    got = wg.gaps(spec, *args)
    want = wg.gaps_plain(spec, *args)
    _equal(got, want)
    return got[0].cpu().numpy()


@pytest.mark.parametrize("cpw", [16, 4])
@pytest.mark.parametrize("opt", [Options(), Options(cigar=True)])
def test_gaps_classes_match_plain_on_edges(dev, cpw, opt):
    """Every width class of K3 with its edges: empty gaps (tl = 0 or ql =
    0), tl + ql = 127, and sums at each class's edge (n = tl + ql + 1 of
    8 | 9, 16 | 17, 32 | 33, 64 | 65), many gaps a warp and ragged
    warps."""
    pairs = list(EDGE_PAIRS) * 3
    for a, b in ((3, 4), (4, 4), (10, 5), (8, 8), (20, 11), (16, 16),
                 (40, 23), (32, 32), (60, 67), (0, 7), (7, 0)):
        pairs.append((b"ACGT" * (a // 4) + b"A" * (a % 4),
                      b"AGCT" * (b // 4) + b"C" * (b % 4)))
    out = _gaps_equal(pairs, opt, cpw, dev)
    assert out[:, wg.GO_DONE].all()


@pytest.mark.parametrize("opt", [Options(**SHRINK_PENS),
                                 Options(cigar=True, **SHRINK_PENS)])
def test_gaps_classes_shrink_pair(dev, opt):
    """The shrink pair (s=294, past the 256-cycle shrink; n_iter 25924,
    the JAX K3's and the lax engine's) in the 128-slot class beside small
    gaps that end at once."""
    pairs = [SHRINK_PAIR] * 3 + [(b"A", b"A"), (b"", b"AC")] * 5
    out = _gaps_equal(pairs, opt, 16, dev)
    assert out[:3, wg.GO_S].tolist() == [294] * 3
    # K3's n_iter past the shrink is the lax engine's (ROADMAP fault 2)
    assert out[:3, wg.GO_NI].tolist() == [25924] * 3


def test_gaps_block_matches_the_wrapper(dev):
    """The kernel's block of each class (shared memory, warps) against
    ``block_of``, at three penalty sets."""
    fn = build.load("gaps", "mwf_gaps_block",
                    [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    for pens in (dict(x=4, o1=4, e1=2, o2=15, e2=1),
                 dict(x=4, o1=4, e1=2, o2=100, e2=1), SHRINK_PENS):
        spec = wg.GSpec(S_CAP=64, **pens)
        for c in range(len(wg.CLASSES)):
            smem, warps = ctypes.c_int(0), ctypes.c_int(0)
            assert fn(c, *pens.values(), ctypes.addressof(smem),
                      ctypes.addressof(warps)) == 0
            assert (smem.value, warps.value) == wg.block_of(spec, c)


# the sharded path over several distinct cards
MULTICARD_RUNS = {"score": Options(), "cigar": Options(cigar=True),
                  "lowmem_p16": Options(cigar=True, step=16)}


def _cards(n):
    """Every visible card, at least ``n`` of them, else skip."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs at least {n} CUDA devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _sharded_against_single(pairs, opt, cards, counted, **kw):
    """``align_batch_sharded`` over ``cards`` against ``align_batch`` on
    cards[0], bit for bit; every card launched each wrapper of
    ``counted``.  Returns the sharded results."""
    from miniwfa_tpu_torch.parallel.batch import align_batch_sharded
    from miniwfa_tpu_torch.parallel.mesh import make_mesh
    for fn in counted:
        fn.launches_by_card.clear()
    sharded = align_batch_sharded(pairs, opt, make_mesh(cards), **kw)
    for fn in counted:
        assert set(fn.launches_by_card) == {c.index for c in cards}, \
            (fn.__name__, dict(fn.launches_by_card))
    single = exact.align_batch(pairs, opt, device=cards[0], **kw)
    assert [(r.s, r.n_iter, r.cigar_str) for r in sharded] == \
        [(r.s, r.n_iter, r.cigar_str) for r in single]
    return sharded


@pytest.mark.parametrize("run", list(MULTICARD_RUNS))
def test_multicard_sharded_matches_single_on_goldens(goldens, run):
    cards = _cards(2)
    opt = MULTICARD_RUNS[run]
    counted = [wk.wavefront] + ([tbd.walk] if opt.cigar else []) \
        + ([tbd.chain_ptrs] if opt.step else [])
    res = _sharded_against_single(list(zip(*_golden_pairs(goldens))), opt,
                                  cards, counted)
    for c, r, e in zip(goldens["cases"], res, goldens["runs"][run]):
        assert (r.s, r.cigar_str) == (e["s"], e["cigar"]), c["name"]


@pytest.mark.parametrize("run", ["score", "lowmem_p16"])
def test_multicard_wide_route_matches_single(goldens, monkeypatch, run):
    """Every score and pass-1 dispatch past a 256-diagonal window goes to
    the wide engine: one cooperative grid on each of 2 cards at once."""
    cards = _cards(2)[:2]
    monkeypatch.setattr(exact, "WIDE_SCORE_W_MIN", 256)
    monkeypatch.setattr(exact, "WIDE_PASS1_W_MIN", 256)
    names = ("t3", "small7", "ins4", "identity4")
    cases = [(i, c) for i, c in enumerate(goldens["cases"])
             if c["name"] in names]
    res = _sharded_against_single([(c["t"], c["q"]) for _, c in cases],
                                  MULTICARD_RUNS[run], cards, [ww.wide],
                                  w0=1024)
    for (i, c), r in zip(cases, res):
        e = goldens["runs"][run][i]
        assert (r.s, r.cigar_str) == (e["s"], e["cigar"]), c["name"]


@pytest.mark.parametrize("opt,stages", [
    (Options(), {"size", "pack", "dispatch"}),
    (Options(cigar=True), {"size", "pack", "dispatch", "cigars"}),
    (Options(cigar=True, step=500),
     {"size", "pack", "dispatch", "checkpoints", "cigars"})],
    ids=["score", "cigar", "lowmem"])
def test_align_batch_stages_are_host_ranges_on_the_card(dev, opt, stages):
    """Under ``torch.profiler`` with CUDA activity, each of
    ``align_batch``'s stages is a host range ``mwf.<stage>``, and none is
    mirrored onto the card's timeline, where it would read as work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ts, qs = _bench8k()
    pairs = list(zip(ts, qs))
    exact.align_batch(pairs, opt, device=dev)          # builds the kernels
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exact.align_batch(pairs, opt, device=dev)
        torch.cuda.synchronize(dev)
    events = prof.events()
    on_host = {e.name for e in events if e.name.startswith("mwf.")
               and e.device_type == DeviceType.CPU}
    on_card = [e.name for e in events if e.name.startswith("mwf.")
               and e.device_type == DeviceType.CUDA]
    assert on_host == {"mwf." + s for s in stages}
    assert on_card == []
    # the card ran the call's kernels inside the traced range
    assert any(e.device_type == DeviceType.CUDA
               and "wavefront_kernel" in e.name for e in events)


def _ksim_pool(name):
    """The ksim kernel's pools: the cells' shapes (16 x 100 kb, one 1 Mb
    lane), 64 lanes of 5 kb (first_bucket's most), and the counts' corners
    (a homopolymer, lowercase, U/u and N bytes, unequal lengths)."""
    import json
    from wfabench import gen
    if name == "corners":
        rng = np.random.default_rng(3)
        t = rng.choice(np.frombuffer(b"ACGTacgtUuN", np.uint8), 9000)
        q = t.copy()
        q[rng.choice(q.size, 400, replace=False)] = rng.choice(
            np.frombuffer(b"ACGT", np.uint8), 400)
        t, q = bytes(t), bytes(q)
        return [(b"A" * 10013, b"A" * 9000 + b"C" * 13 + b"A" * 1100),
                (t, q), (t.lower(), t.upper().replace(b"T", b"U")),
                (t, q[1000:4000]), (t[:12], q), (b"N" * 3000, q)]
    cfg_name, n, bp = {"pairs100k": ("pairs100k", 16, None),
                       "mhc1m": ("mhc1m", 1, None),
                       "lanes64": ("pairs100k", 64, 5000),
                       "pairs5k": ("pairs100k", 16, 5000)}[name]
    with open(os.path.join(os.path.dirname(__file__), "..", "wfabench",
                           "configs", f"{cfg_name}.json")) as f:
        cfg = json.load(f)
    if bp:
        cfg["target_bp"] = bp
    return gen.make_pool(cfg, n, 2 ** 31 + 777)


@pytest.mark.parametrize("name,budget", [
    ("pairs100k", None), ("mhc1m", None), ("lanes64", None),
    ("corners", None), ("pairs100k", 6 << 20)])
def test_ksim_kernel_matches_plain(dev, monkeypatch, name, budget):
    """The ksim kernel's (shared, n1, n2) equal its plain version's, and
    its similarities the host's ``ksims``: one launch a batch, 64 lanes
    included, and one a pair where the batch's table would pass the
    budget (6 MiB: 16 lanes of 100 kb)."""
    pairs = _ksim_pool(name)
    if budget is not None:
        monkeypatch.setattr(kmer, "ksim_budget", lambda device: budget)
    before = kmer.ksim_counts.launches
    got = kmer.ksim_counts(pairs, 13, dev)
    torch.cuda.synchronize(dev)
    assert kmer.ksim_counts.launches == before + (len(pairs) if budget
                                                  else 1)
    assert np.array_equal(got, kmer.ksim_counts(pairs, 13, "cpu"))
    assert kmer.ksims_device(pairs, 13, dev) == list(kmer.ksims(pairs, 13))


def _host_ksims(pairs, k, device):
    return list(kmer.ksims(pairs, k))


@pytest.mark.parametrize("name", ["pairs100k", "mhc1m"])
@pytest.mark.parametrize("mode", [wk.MODE_TB, wk.MODE_PASS1])
def test_first_bucket_on_the_card_matches_the_host(dev, monkeypatch, name,
                                                   mode):
    """``first_bucket`` sizes a batch from the card's k-mer counts exactly
    as from the host's, in TB and PASS1 mode, at the cells' shapes."""
    pairs = _ksim_pool(name)
    ts, qs = [t for t, _ in pairs], [q for _, q in pairs]
    opt = Options(cigar=True, step=5000 if mode == wk.MODE_PASS1 else 0)
    assert exact._estimate_s(opt, ts, qs, dev) != (0, 0)
    got = exact.first_bucket(opt, mode, ts, qs, 512, 512, dev)
    monkeypatch.setattr(kmer, "ksims_device", _host_ksims)
    assert got == exact.first_bucket(opt, mode, ts, qs, 512, 512, dev)


def test_ksim_launches_once_a_sized_call(dev):
    """A CIGAR and a low-mem call whose pairs pass 2048 bp launch the ksim
    kernel once each; a score call never."""
    pairs = _ksim_pool("pairs5k")
    for opt, n in ((Options(cigar=True), 1), (Options(), 0),
                   (Options(cigar=True, step=5000), 1)):
        before = kmer.ksim_counts.launches
        exact.align_batch(pairs, opt, device=dev)
        assert kmer.ksim_counts.launches == before + n, opt


@pytest.mark.parametrize("name,step", [("pairs100k", 0), ("pairs100k", 5000),
                                       ("mhc1m", 5000)])
def test_ksim_table_leaves_the_peak_alone(dev, monkeypatch, name, step):
    """A call's peak card memory and its answers are the same with the
    card's k-mer counts as with the host's: the hash table is freed
    before the first dispatch."""
    pairs = _ksim_pool(name)
    opt = Options(cigar=True, step=step)
    exact.align_batch(pairs, opt, device=dev)           # builds the kernels

    def call():
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res = exact.align_batch(pairs, opt, device=dev)
        torch.cuda.synchronize(dev)
        return (torch.cuda.max_memory_allocated(dev),
                [(r.s, r.n_iter, r.cigar_str) for r in res])

    card = call()
    monkeypatch.setattr(kmer, "ksims_device", _host_ksims)
    assert card == call()
