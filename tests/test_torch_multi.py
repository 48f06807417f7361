"""The port's multi-lane wavefront engine (K4) against the JAX package's.

The same lanes go through ``miniwfa_tpu.ops.wavefront_multi`` (G lanes per
grid step) in interpret mode and, with the inputs carried over by
``miniwfa_tpu_torch.convert``, through
``miniwfa_tpu_torch.ops.wavefront_multi.wavefront_multi`` on CPU tensors
(its plain version, K1's).  Tolerance: exact equality of every per-lane
output (n_iter as the 30-bit O_NLO/O_NHI halves) and of every traceback
byte inside the band the port records for its row.  W=1024 and small
cycle budgets keep the interpreter fast.  Then the routing: ``pick_g``,
and which dispatches ``MWF_ENGINE=multi`` sends to K4.
"""

import json
import os

import numpy as np
import pytest
import torch

from miniwfa_tpu.ops import pack as jpack
from miniwfa_tpu.ops import wavefront_kernel as jwk
from miniwfa_tpu.ops import wavefront_multi as jwm
from miniwfa_tpu_torch import Options, convert
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.ops import wavefront_kernel as wk
from miniwfa_tpu_torch.ops import wavefront_multi as wm

torch.set_num_threads(1)   # as in test_torch_chain.py

WR, W = 8, 1024
PENS = dict(x=4, o1=4, e1=2, o2=15, e2=1)

with open(os.path.join(os.path.dirname(__file__), "data",
                       "goldens.json")) as _f:
    _CASES = {c["name"]: c for c in json.load(_f)["cases"]}


def _pair(name):
    c = _CASES[name]
    return c["t"].encode("latin1"), c["q"].encode("latin1")


def _scal(ts, qs, anc=None, max_s=None, segs=None):
    """The JAX kernels' scalar rows for a batch: the window anchored at
    the midpoint of start and end diagonal unless ``anc`` names a lane's,
    per-lane max_s, and the checkpoint lists ``segs``."""
    lanes = np.zeros((len(ts), wk.L_N), np.int64)
    for i, (t, q) in enumerate(zip(ts, qs)):
        lanes[i, wk.L_TL], lanes[i, wk.L_QL] = len(t), len(q)
        lanes[i, wk.L_ANC] = (len(q) - len(t)) // 2 - W // 2
    for i, a in (anc or {}).items():
        lanes[i, wk.L_ANC] = a
    for i, m in (max_s or {}).items():
        lanes[i, wk.L_MS] = m
    sg = None if segs is None else exact.seg_input(segs)
    return convert.scal_from_lanes(lanes, 1, sg)


def run_both(ts, qs, mode, G, *, S_CAP=512, pens=PENS, **kw):
    """A batch through the JAX K4 (interpret mode) and the port's
    wavefront_multi.  Returns (jax row [B, 10], jax tb [B, S, W] or None,
    port out, port tb, port bands, the lanes' window anchors)."""
    cpw = 16 if jpack.can_pack2(list(ts) + list(qs)) else 4
    scal = _scal(ts, qs, **kw)
    seg_cap = (scal.shape[1] - jwk.SC_SEG) // 2
    use_seg = kw.get("segs") is not None
    mspec = jwm.MSpec(B=len(ts), G=G, WR=WR, S_CAP=S_CAP, mode=mode, cpw=cpw,
                      seg_cap=seg_cap, use_seg=use_seg, **pens)
    twt, twq = jwk.pack_table(list(ts), cpw), jwk.pack_table(list(qs), cpw)
    raw = jwm.get_multi_kernel(mspec, interpret=True).raw(scal, twt, twq)
    jrow = np.asarray(raw[0])
    jtb = convert.tb_from_packed(np.asarray(raw[1])) \
        if mode == jwk.MODE_TB else None
    pspec = wk.KSpec(W=W, S_CAP=S_CAP, mode=mode, cpw=cpw, **pens)
    sg = torch.from_numpy(convert.segs_from_scal(scal)) if use_seg else None
    out, tb, bands, snap = wm.wavefront_multi(
        pspec, G, torch.from_numpy(convert.lanes_from_scal(scal)),
        torch.from_numpy(convert.words_from_table(twt)),
        torch.from_numpy(convert.words_from_table(twq)), sg)
    assert snap is None
    return jrow, jtb, out.numpy(), tb, bands, scal[:, jwk.SC_ANC]


def _assert_tb(jtb, out, tb, bands, anc):
    """Every in-band traceback byte of each lane's rows 0..s-1."""
    col = torch.arange(W)
    for b, a in enumerate(anc):
        s = int(out[b, wk.O_S])
        in_band = ((col >= bands[b, :s, 0:1].long() - int(a))
                   & (col <= bands[b, :s, 1:2].long() - int(a))).numpy()
        assert bool(in_band.any(1).all())
        assert np.array_equal(tb[b, :s].numpy()[in_band], jtb[b, :s][in_band])


@pytest.mark.parametrize("G", [2, 4])
def test_score_lanes_that_end_differently(G):
    """One block holds a lane that terminates, one that terminates later,
    one whose band overflows the window and one stopped by max_s."""
    ts, qs = zip(*(_pair(n) for n in ("t3", "small7", "t3", "ins4")))
    jrow, _, out, tb, _, _ = run_both(ts, qs, jwk.MODE_SCORE, G,
                                      anc={2: -3}, max_s={3: 8})
    assert tb is None
    assert np.array_equal(convert.row_from_out(out), jrow)
    assert out[:, wk.O_DONE].tolist() == [1, 1, 0, 0]
    assert out[2, wk.O_OVFB] == 1 and out[3, wk.O_STOP] == 1
    assert out[0, wk.O_S] != out[1, wk.O_S]


@pytest.mark.parametrize("G", [2, 4])
def test_tb_bytes_match_jax_multi_kernel(G):
    ts, qs = zip(*(_pair(n) for n in ("t3", "ins4", "mixed", "small7")))
    jrow, jtb, out, tb, bands, anc = run_both(ts, qs, jwk.MODE_TB, G)
    assert np.array_equal(convert.row_from_out(out), jrow)
    assert out[:, wk.O_DONE].all()
    _assert_tb(jtb, out, tb, bands, anc)


def test_tb_with_checkpoints_matches_jax_multi_kernel():
    """TB+seg: each lane's checkpoints from the port's step-16 pass 1, in
    the seg columns of the JAX kernel's scalar rows."""
    ts, qs = zip(*(_pair(n) for n in ("t3", "small44")))
    segs, _ = exact._run_pass1(Options(**PENS, cigar=True, step=16),
                               list(ts), list(qs), 512, 512,
                               torch.device("cpu"))
    assert all(segs)
    jrow, jtb, out, tb, bands, anc = run_both(ts, qs, jwk.MODE_TB, 2,
                                              segs=segs)
    assert np.array_equal(convert.row_from_out(out), jrow)
    _assert_tb(jtb, out, tb, bands, anc)
    # the collapse narrows the band: fewer cells than without checkpoints
    spec = wk.KSpec(W=W, S_CAP=512, mode=wk.MODE_TB, cpw=16, **PENS)
    full = wk.wavefront_plain(spec, *(torch.from_numpy(a) for a in (
        convert.lanes_from_scal(_scal(ts, qs)),
        convert.words_from_table(jwk.pack_table(list(ts), 16)),
        convert.words_from_table(jwk.pack_table(list(qs), 16)))))[0]
    assert (full[:, wk.O_S].numpy() == out[:, wk.O_S]).all()
    assert (full[:, wk.O_NITER].numpy() > out[:, wk.O_NITER]).all()


def test_shrink_pair_matches_jax_multi_kernel():
    """ROADMAP's shrink pair (A x 63 against C x 64) past the 256-cycle
    shrink: the JAX K4 row equals the JAX K1's, s=294, n_iter=27254."""
    t, q = b"A" * 63, b"C" * 64
    jrow, _, out, _, _, _ = run_both(
        [t, t], [q, q], jwk.MODE_SCORE, 2, S_CAP=2048,
        pens=dict(x=8, o1=8, e1=4, o2=20, e2=2))
    assert np.array_equal(convert.row_from_out(out), jrow)
    assert out[:, wk.O_S].tolist() == [294, 294]
    assert out[:, wk.O_NITER].tolist() == [27254, 27254]


class _Props:
    def __init__(self, sms):
        self.multi_processor_count = sms


@pytest.mark.parametrize("B,sms,want", [
    (16, 132, 1), (131, 132, 1), (264, 132, 2), (528, 132, 4),
    (2048, 132, 8), (1056, 132, 8), (1048, 132, 4), (8, 1, 8), (3, 1, 2),
    (1, 1, 1)])
def test_pick_g_on_a_card(monkeypatch, B, sms, want):
    """The largest G of (8, 4, 2) with G <= B and a block per SM, else 1:
    the main path's 16 lanes stay in K1, a chunk of 2048 gap fills gets
    G=8."""
    monkeypatch.delenv("MWF_KERNEL_G", raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props(sms))
    assert wm.pick_g(wk.MODE_SCORE, B, "cuda") == want
    assert wm.pick_g(wk.MODE_TB, B, "cuda") == want
    assert wm.pick_g(wk.MODE_PASS1, B, "cuda") == 1


def test_pick_g_forced_and_on_the_cpu(monkeypatch):
    monkeypatch.delenv("MWF_KERNEL_G", raising=False)
    assert wm.pick_g(wk.MODE_SCORE, 3, "cpu") == 3
    assert wm.pick_g(wk.MODE_TB, 100, "cpu") == 8
    monkeypatch.setenv("MWF_KERNEL_G", "4")
    assert wm.pick_g(wk.MODE_SCORE, 2, "cpu") == 4
    assert wm.pick_g(wk.MODE_SCORE, 16, "cuda") == 4
    assert wm.pick_g(wk.MODE_PASS1, 16, "cpu") == 1


def test_multi_rejects_what_it_does_not_run():
    t, q = _pair("t3")
    spec, lanes, tw, qw = exact.kernel_inputs(Options(), wk.MODE_SCORE, W,
                                              64, [t, t], [q, q])
    args = [torch.from_numpy(a) for a in (lanes, tw, qw)]
    with pytest.raises(ValueError, match="G must be"):
        wm.wavefront_multi(spec, 3, *args)
    p1 = wk.KSpec(W=W, S_CAP=64, mode=wk.MODE_PASS1, step=16, n_snap=6,
                  **PENS)
    with pytest.raises(ValueError, match="SCORE and TB"):
        wm.wavefront_multi(p1, 2, *args)


@pytest.fixture
def routes(monkeypatch):
    """The G of every K1 dispatch (1: K1, else K4) under MWF_ENGINE=multi
    on the CPU."""
    seen = []
    real = wm.wavefront_multi

    def multi(spec, G, *a, **kw):
        seen.append((spec.mode, G))
        return real(spec, G, *a, **kw)

    def single(spec, *a, **kw):
        seen.append((spec.mode, 1))
        return wk.wavefront_plain(spec, *a, **kw)

    monkeypatch.setattr(wm, "wavefront_multi", multi)
    monkeypatch.setattr(wk, "wavefront", single)
    monkeypatch.setenv("MWF_ENGINE", "multi")
    monkeypatch.delenv("MWF_KERNEL_G", raising=False)
    return seen


@pytest.mark.parametrize("opt", [Options(), Options(cigar=True),
                                 Options(cigar=True, step=16)])
def test_engine_multi_equals_default_route(goldens, routes, monkeypatch, opt):
    """align_batch with MWF_ENGINE=multi on the CPU: SCORE, TB and pass 2's
    TB+seg go to K4 at G = min(8, B), PASS1 stays on K1, and every result
    equals the default route's."""
    sel = [c for c in goldens["cases"]
           if max(len(c["t"]), len(c["q"])) <= 256][:12]
    pairs = [(c["t"], c["q"]) for c in sel]
    got = exact.align_batch(pairs, opt, device="cpu")
    modes = {(m, g) for m, g in routes}
    want_mode = wk.MODE_TB if opt.cigar else wk.MODE_SCORE
    assert (want_mode, 8) in modes
    assert (wk.MODE_PASS1, 8) not in modes
    if opt.step:
        assert (wk.MODE_PASS1, 1) in modes
    monkeypatch.delenv("MWF_ENGINE")
    routes.clear()
    want = exact.align_batch(pairs, opt, device="cpu")
    assert all(g == 1 for _, g in routes)
    assert [(r.s, r.cigar_str, r.n_iter) for r in got] == \
        [(r.s, r.cigar_str, r.n_iter) for r in want]


def test_one_lane_batches_stay_on_k1(routes):
    t, q = _pair("t3")
    r = exact.align_batch([(t, q)], Options(cigar=True), device="cpu")[0]
    assert r.s == 155 and routes and all(g == 1 for _, g in routes)


# the H100's opt-in shared memory a block (227 KB); the smem variant's
# kernel has no static shared memory
H100_SMEM = 232448
O2_100 = dict(x=4, o1=4, e1=2, o2=100, e2=1)


@pytest.mark.parametrize("W,pens,want", [
    (512, PENS, 57488),       # 27 ring planes + lastv, registry 2 x 17
    (64, PENS, 7312),
    (2074, PENS, 232432),     # the widest window one lane fits
    (512, O2_100, 232240),    # 112 ring planes + lastv, registry 2 x 102
    (512, dict(x=1, o1=0, e1=1, o2=0, e2=1), 22544)])   # edit distance
def test_lane_smem(W, pens, want):
    """A lane's shared memory in the smem variant: plane_count planes of W
    int32 (the rings and lastv) and the 2 x RH registry, rounded up to 16
    bytes (csrc/wavefront_multi.cu lane_ints)."""
    spec = wk.KSpec(W=W, S_CAP=64, **pens)
    assert wm.lane_smem(spec) == want
    assert want % 16 == 0
    assert want >= 4 * (wk.plane_count(spec) * W + 2 * spec.rings[0])


@pytest.mark.parametrize("W,B,sms,pens,smem,want", [
    (512, 2048, 132, PENS, H100_SMEM, ("smem", 4)),      # the gap fills
    (512, 16, 132, PENS, H100_SMEM, ("smem", 1)),        # spread over SMs
    (512, 300, 132, PENS, H100_SMEM, ("smem", 3)),
    (512, 132, 132, PENS, H100_SMEM, ("smem", 1)),       # a lane an SM
    (512, 133, 132, PENS, H100_SMEM, ("smem", 2)),
    (64, 2048, 132, PENS, H100_SMEM, ("smem", 8)),       # LPB_MAX
    (64, 2048, 1, PENS, H100_SMEM, ("smem", 8)),
    (64, 5, 1, PENS, H100_SMEM, ("smem", 5)),            # the whole batch
    (2074, 2048, 132, PENS, H100_SMEM, ("smem", 1)),     # the edge: fits
    (2075, 2048, 132, PENS, H100_SMEM, ("global", 0)),   # one slot past
    (512, 2048, 132, O2_100, H100_SMEM, ("smem", 1)),
    (520, 2048, 132, O2_100, H100_SMEM, ("global", 0)),
    (512, 2048, 132, PENS, 101376, ("smem", 1)),         # a 99 KB card
    (512, 2048, 132, PENS, 57487, ("global", 0)),        # a byte short
    (4096, 2048, 132, PENS, H100_SMEM, ("global", 0)),   # bench8k's W
    (65536, 16, 132, PENS, H100_SMEM, ("global", 0))])   # the main shape
def test_pick_variant(W, B, sms, pens, smem, want):
    """smem while one lane's state fits the budget, with as many lanes a
    block as it allows, at most LPB_MAX and ceil(B / sms); else the
    global variant (at pick_g's G)."""
    for mode in (wk.MODE_SCORE, wk.MODE_TB):
        spec = wk.KSpec(W=W, S_CAP=64, mode=mode, **pens)
        v, n = wm.pick_variant(spec, B, sms, smem)
        assert (v, n) == want
        if v == "smem":
            assert 1 <= n <= wm.LPB_MAX
            assert n * wm.lane_smem(spec) <= smem


@pytest.mark.parametrize("G", [2, 4, 8])
def test_every_g_gives_the_plain_outputs_on_the_cpu(G):
    """On the CPU every G runs the plain version: the outputs equal
    wavefront_plain's, in TB mode with and without checkpoints."""
    ts, qs = zip(*(_pair(n) for n in ("t3", "ins4", "mixed")))
    spec, lanes, tw, qw = exact.kernel_inputs(
        Options(cigar=True), wk.MODE_TB, 512, 512, list(ts), list(qs))
    args = [torch.from_numpy(a) for a in (lanes, tw, qw)]
    got = wm.wavefront_multi(spec, G, *args)
    want = wk.wavefront_plain(spec, *args)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
