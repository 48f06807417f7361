"""The port's wide-band engine (``ops/wavefront_wide.py``) on the CPU,
through its plain PyTorch version.

Held against the JAX package's wide kernel (K2,
``miniwfa_tpu/ops/wavefront_wide.py``) run in interpret mode at its
smallest window (WR=128, W=16384), six calls in all: SCORE on t3 and med2k
(med2k crosses s=256, so the shrink), PASS1 at step 16 on both (every
output and the decoded checkpoints; K2's snapshot rows are carried into
the port's layout by ``convert.py``), a PASS1 call paused on a snapshot
cycle (the state columns and the rows taken so far), and the pair whose
``n_iter`` past a 256-cycle shrink differs between the JAX package's
engines.  Then the port alone: chunked runs against one call (pauses on
plain, snapshot and shrink cycles), stops that fall in a later call,
snapshot rows grown between calls, and ``align_batch`` routed through the
wide engine with its thresholds lowered, against ``goldens.json``.
Tolerance: exact equality throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from miniwfa_tpu.models import traceback as jtbk
from miniwfa_tpu.ops import pack as jpack
from miniwfa_tpu.ops import wavefront_kernel as jwk
from miniwfa_tpu.ops import wavefront_wide as jww
from miniwfa_tpu_torch import Options, convert
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.models import traceback as tbk
from miniwfa_tpu_torch.models.exact import align_batch
from miniwfa_tpu_torch.ops import traceback_device as tbd
from miniwfa_tpu_torch.ops import wavefront_kernel as wk
from miniwfa_tpu_torch.ops import wavefront_wide as ww

torch.set_num_threads(1)   # as in test_torch_chain.py

WR, W, S_CAP = 128, 16384, 512
PENS = dict(x=4, o1=4, e1=2, o2=15, e2=1)
# the pair of ROADMAP.md section 3: n_iter past the 256-cycle shrink
SHRINK_PAIR = (b"A" * 63, b"C" * 64)
SHRINK_PENS = dict(x=8, o1=8, e1=4, o2=20, e2=2)


def _case(goldens, name):
    c = next(c for c in goldens["cases"] if c["name"] == name)
    return c["t"].encode("latin1"), c["q"].encode("latin1")


def _port_inputs(t, q, step=0, pens=PENS, n_snap=None, **lane):
    """The port's spec and inputs for one pair at the JAX kernel's
    window, anchored as the JAX driver anchors it."""
    cpw = 16 if jpack.can_pack2([t, q]) else 4
    mode = wk.MODE_PASS1 if step else wk.MODE_SCORE
    spec = wk.KSpec(W=W, S_CAP=S_CAP, mode=mode, cpw=cpw, step=step,
                    n_snap=(n_snap or S_CAP // step + 2) if step else 0,
                    **pens)
    lanes = np.array([[len(t), len(q), (len(q) - len(t)) // 2 - W // 2,
                       lane.get("max_s", 0), lane.get("max_iter", 0)]],
                     np.int64)
    twt, twq = jwk.pack_table([t], cpw), jwk.pack_table([q], cpw)
    args = (torch.from_numpy(lanes),
            torch.from_numpy(convert.words_from_table(twt)),
            torch.from_numpy(convert.words_from_table(twq)))
    return spec, args, twt, twq


def _jax_k2(t, q, step=0, pens=PENS, t_lim=0):
    """One call of the JAX wide kernel in interpret mode from a fresh
    state: (raw out row with the OW_* columns, snapshot rows or None)."""
    spec, args, twt, twq = _port_inputs(t, q, step, pens)
    kw = dict(mode=jwk.MODE_PASS1, step=step, n_snap=spec.n_snap) \
        if step else {}
    jspec = jww.WSpec(B=1, WR=WR, S_CAP=S_CAP, cpw=spec.cpw, **pens, **kw)
    scal = jww._pad_scal(jspec, args[0].numpy()[:, :3].astype(np.int32))
    if t_lim:
        scal[:, jww.RS_LIM] = t_lim
    outs = jww._get_call(jspec, True)(jnp.asarray(scal), twt, twq,
                                      *jww._zero_state(jspec))
    return np.asarray(outs[0]), (np.asarray(outs[5]) if step else None)


def _port_run(spec, args, t_lim=1 << 40):
    state = ww.new_state(spec, args[0])
    out = ww.wide(spec, *args, state, torch.tensor([t_lim]))
    return out, state


def _checkpoints(spec, anc, snap, out):
    """Checkpoints of one lane through the port's chain and decoder."""
    fin, recs = tbd.chain_ptrs(torch.as_tensor(snap),
                               torch.as_tensor(out[:, wk.O_LP]),
                               torch.as_tensor(out[:, wk.O_SNC]))
    return tbk.decode_checkpoints_ptrs(recs[:, 0], int(fin[0]), anc,
                                       int(out[0, wk.O_SNC]), spec)


@pytest.mark.parametrize("name", ["t3", "med2k"])
def test_score_matches_jax_wide_kernel(goldens, name):
    t, q = _case(goldens, name)
    spec, args, _, _ = _port_inputs(t, q)
    out, state = _port_run(spec, args)
    jout, jst = convert.wide_out_from_row(_jax_k2(t, q)[0], spec)
    assert np.array_equal(out.numpy(), jout)
    assert np.array_equal(state.row[:, :ww.ST_BND].numpy(), jst)
    want = goldens["niter"][name]
    assert (int(out[0, wk.O_S]), int(out[0, wk.O_NITER])) == \
        (want["s"], want["n_iter"])


@pytest.mark.parametrize("name", ["t3", "med2k"])
def test_pass1_matches_jax_wide_kernel(goldens, name):
    t, q = _case(goldens, name)
    spec, args, _, _ = _port_inputs(t, q, step=16)
    out, state = _port_run(spec, args)
    row, jsnap = _jax_k2(t, q, step=16)
    wpt = (WR + 8) * 128
    jout, jst = convert.wide_out_from_row(row, spec, wpt)
    assert np.array_equal(out.numpy(), jout)
    assert np.array_equal(state.row[:, :ww.ST_BND].numpy(), jst)
    snc = int(out[0, wk.O_SNC])
    assert snc == int(out[0, wk.O_S]) // 16 > 0
    anc = int(args[0][0, wk.L_ANC])
    segs = _checkpoints(spec, anc, state.snap, out.numpy())
    conv = convert.snap_from_wide(jsnap, [snc], spec)
    assert _checkpoints(spec, anc, conv, jout) == segs
    # the JAX package's own decoder of its layout
    jspec = jww.WSpec(B=1, WR=WR, S_CAP=S_CAP, cpw=spec.cpw,
                      mode=jwk.MODE_PASS1, step=16, n_snap=spec.n_snap,
                      **PENS).kspec()
    jsegs = jtbk.decode_checkpoints_kernel(
        jsnap[0].reshape(jsnap.shape[1], -1), anc, snc,
        int(row[0, convert.JO_LP]), jspec)
    assert segs == [tuple(map(int, x)) for x in jsegs]
    assert len(segs) == snc


def test_pause_on_a_snapshot_cycle_matches_jax_wide_kernel(goldens):
    """Both kernels paused after cycle 79 of t3's PASS1 (a snapshot cycle,
    (t+1) % 16 == 0): the same state columns, the pause flag, and the five
    snapshot rows taken hold the same pointers wherever the port's row
    has one on a ring slot both packages keep."""
    t, q = _case(goldens, "t3")
    spec, args, _, _ = _port_inputs(t, q, step=16)
    out, state = _port_run(spec, args, t_lim=80)
    row, jsnap = _jax_k2(t, q, step=16, t_lim=80)
    jout, jst = convert.wide_out_from_row(row, spec, (WR + 8) * 128)
    assert np.array_equal(out.numpy(), jout)
    assert np.array_equal(state.row[:, :ww.ST_BND].numpy(), jst)
    assert out[0, ww.OW_PAUSE] == 1 and out[0, wk.O_OVFS] == 0
    assert int(state.row[0, ww.ST_T]) == 80 and out[0, wk.O_SNC] == 5
    conv = convert.snap_from_wide(jsnap, [5], spec)
    mine = state.snap.numpy()
    for c in range(5):
        pm = convert._wide_plane_map(spec, 16 * (c + 1) - 1)
        have = mine[0, c, pm] != wk.WF_NEG_INF
        assert have.sum() > 0
        assert np.array_equal(conv[0, c, pm][have], mine[0, c, pm][have])


def test_shrink_pair_n_iter_matches_jax_wide_kernel():
    """Past the 256-cycle shrink the JAX wide kernel counts the cells as
    the JAX K1 does (27254; the lax engine and K3 count 25924): so do the
    port's wide and K1 plain versions."""
    t, q = SHRINK_PAIR
    spec, args, _, _ = _port_inputs(t, q, pens=SHRINK_PENS)
    out, _ = _port_run(spec, args)
    jout, _ = convert.wide_out_from_row(_jax_k2(t, q, pens=SHRINK_PENS)[0],
                                        spec)
    assert np.array_equal(out.numpy(), jout)
    assert (int(out[0, wk.O_S]), int(out[0, wk.O_NITER])) == (294, 27254)
    k1 = wk.wavefront_plain(spec, *args)[0]
    assert torch.equal(k1, out[:, :wk.O_N])


@pytest.mark.parametrize("name,step,chunk", [
    ("t3", 0, 77), ("t3", 16, 77),
    ("t3", 16, 80),        # every pause right after a snapshot cycle
    ("med2k", 0, 256),     # the first pause right after the shrink cycle
    ("med2k", 16, 128)])
def test_chunked_matches_single_call(goldens, monkeypatch, name, step,
                                     chunk):
    t, q = _case(goldens, name)
    spec, args, _, _ = _port_inputs(t, q, step=step)
    out, state = _port_run(spec, args)
    calls = []
    real = ww.wide

    def counting(*a):
        calls.append(int(a[-1][0]))
        return real(*a)

    monkeypatch.setattr(ww, "CYCLES_PER_CALL", chunk)
    ww.wide = counting
    try:
        cout, csnap, cspec = ww.run_chunked(spec, *args)
    finally:
        ww.wide = real
    s = int(out[0, wk.O_S])
    assert len(calls) == -(-(s + 1) // chunk) >= 2
    assert calls[0] == chunk
    assert torch.equal(cout, out[:, :wk.O_N])
    assert cspec == spec
    if step:
        assert torch.equal(csnap, state.snap)
    # and both equal K1's plain version
    k1 = wk.wavefront_plain(spec, *args)
    assert torch.equal(k1[0], cout)
    assert step == 0 or torch.equal(k1[3], csnap)


def test_resumed_state_equals_single_call_state(goldens):
    """The state row and planes after a paused-and-resumed run equal the
    single call's, registry and all."""
    t, q = _case(goldens, "med2k")
    spec, args, _, _ = _port_inputs(t, q, step=16)
    out, state = _port_run(spec, args)
    st = ww.new_state(spec, args[0])
    for lim in (100, 255, 256, 300, 1 << 40):
        o = ww.wide(spec, *args, st, torch.tensor([lim]))
        if lim < 300:
            assert o[0, ww.OW_PAUSE] == 1 and int(st.row[0, ww.ST_T]) == lim
    assert torch.equal(o, out)
    for a, b in ((st.row, state.row), (st.planes, state.planes),
                 (st.snap, state.snap)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 16])
def test_plain_lanes_together_equal_lanes_alone(goldens, step):
    """wide_plain runs neighbouring lanes that stand at one cycle in one
    loop: after calls with a limit per lane, and lanes that end early,
    every output, state row, plane and snapshot row equals each lane run
    alone."""
    cases = goldens["cases"][:16]
    ts = [c["t"].encode("latin1") for c in cases]
    qs = [c["q"].encode("latin1") for c in cases]
    mode = wk.MODE_PASS1 if step else wk.MODE_SCORE
    spec, lanes, tw, qw = exact.kernel_inputs(
        Options(cigar=bool(step), step=step), mode, 1024, 256, ts, qs)
    args = [torch.from_numpy(a) for a in (lanes, tw, qw)]
    B = len(ts)
    # the first half paused at cycle 30, the second at 60 (lanes with
    # s < 30 or 60 end in the first call)
    lims = [torch.tensor([30 if b < B // 2 else 60 for b in range(B)]),
            torch.full((B,), 1 << 40)]
    st = ww.new_state(spec, args[0])
    for lim in lims:
        out = ww.wide_plain(spec, *args, st, lim)
    assert int(out[:, wk.O_DONE].sum()) == B
    for b in range(B):
        one = [a[b:b + 1] for a in args]
        sb = ww.new_state(spec, one[0])
        for lim in lims:
            ob = ww.wide_plain(spec, *one, sb, lim[b:b + 1])
        assert torch.equal(ob, out[b:b + 1])
        assert torch.equal(sb.row, st.row[b:b + 1])
        assert torch.equal(sb.planes, st.planes[b:b + 1])
        assert step == 0 or torch.equal(sb.snap, st.snap[b:b + 1])


@pytest.mark.parametrize("stop", [dict(max_s=100), dict(max_iter=8000)])
def test_stop_in_a_later_call(goldens, monkeypatch, stop):
    """A max_s / max_iter stop in the second of 60-cycle calls."""
    t, q = _case(goldens, "t3")
    spec, args, _, _ = _port_inputs(t, q, **stop)
    out, state = _port_run(spec, args)
    assert 60 < int(state.row[0, ww.ST_T]) <= 120
    monkeypatch.setattr(ww, "CYCLES_PER_CALL", 60)
    cout, _, _ = ww.run_chunked(spec, *args)
    assert torch.equal(cout, out[:, :wk.O_N])
    assert cout[0, wk.O_STOP] == 1 and cout[0, wk.O_DONE] == 0
    assert cout[0, wk.O_S] == -1
    if "max_iter" in stop:
        assert int(cout[0, wk.O_NITER]) > 8000
    assert torch.equal(wk.wavefront_plain(spec, *args)[0], cout)


def test_snapshot_rows_grow_between_calls(goldens, monkeypatch):
    """Two snapshot rows to start with, grown by run_chunked as the run
    needs them: the same outputs and checkpoints as the full buffer.  Under
    a byte budget (old and new rows together) a call pauses where the rows
    end, and a budget that cannot hold the next row raises."""
    t, q = _case(goldens, "med2k")
    spec, args, _, _ = _port_inputs(t, q, step=16)
    out, state = _port_run(spec, args)
    anc = int(args[0][0, wk.L_ANC])
    want = _checkpoints(spec, anc, state.snap, out.numpy())
    small = dataclasses.replace(spec, n_snap=2)
    row_b = wk.snapshot_layout(spec)[5] * W * 4
    monkeypatch.setattr(ww, "CYCLES_PER_CALL", 100)
    for budget, rows, lims in ((None, 27, [100, 200, 300, 400]),
                               (38 * row_b, 20, [100, 200, 300, 335])):
        calls = []
        real = ww.wide

        def counting(*a):
            calls.append((a[0].n_snap, int(a[-1][0])))
            return real(*a)

        ww.wide = counting
        try:
            cout, csnap, cspec = ww.run_chunked(small, *args,
                                                snap_budget=budget)
        finally:
            ww.wide = real
        assert torch.equal(cout, out[:, :wk.O_N])
        assert cspec.n_snap == rows and [c[1] for c in calls] == lims
        assert [c[0] for c in calls] == sorted(c[0] for c in calls)
        assert _checkpoints(cspec, anc, csnap, cout.numpy()) == want
    with pytest.raises(RuntimeError, match="snapshot rows"):
        ww.run_chunked(small, *args, snap_budget=30 * row_b)


@pytest.fixture
def wide_route(monkeypatch):
    """Every score and pass-1 dispatch of align_batch through the wide
    engine; returns the list of its calls' modes."""
    monkeypatch.setattr(exact, "WIDE_SCORE_W_MIN", 256)
    monkeypatch.setattr(exact, "WIDE_PASS1_W_MIN", 256)
    calls = []
    real = ww.wide

    def counting(spec, *a):
        calls.append(spec.mode)
        return real(spec, *a)

    monkeypatch.setattr(ww, "wide", counting)
    return calls


def test_align_batch_score_through_wide_route(goldens, wide_route):
    pairs = [(c["t"], c["q"]) for c in goldens["cases"]]
    res = align_batch(pairs, Options(**goldens["penalties"]), device="cpu")
    assert wide_route and set(wide_route) == {wk.MODE_SCORE}
    for c, r, e in zip(goldens["cases"], res, goldens["runs"]["score"]):
        assert r.s == e["s"], c["name"]
        if c["name"] in goldens["niter"]:
            assert r.n_iter == goldens["niter"][c["name"]]["n_iter"]


@pytest.mark.parametrize("step", [16, 100])
def test_align_batch_lowmem_through_wide_route(goldens, wide_route, step):
    sel = [(i, c) for i, c in enumerate(goldens["cases"])
           if step == 100 or max(len(c["t"]), len(c["q"])) <= 256]
    opt = Options(**goldens["penalties"], cigar=True, step=step)
    res = align_batch([(c["t"], c["q"]) for _, c in sel], opt, device="cpu")
    assert wk.MODE_PASS1 in wide_route
    exp = goldens["runs"][f"lowmem_p{step}"]
    for (i, c), r in zip(sel, res):
        assert (r.s, r.cigar_str) == (exp[i]["s"], exp[i]["cigar"]), \
            c["name"]


def test_wide_routing_thresholds():
    opt = Options()
    el = exact._wide_eligible
    assert not el(opt, wk.MODE_SCORE, 65536) and el(opt, wk.MODE_SCORE,
                                                    65537)
    assert not el(opt, wk.MODE_PASS1, 32768) and el(opt, wk.MODE_PASS1,
                                                    65536)
    assert el(opt, wk.MODE_SCORE, 1 << 20)
    assert not el(opt, wk.MODE_SCORE, (1 << 20) + 1)
    assert not el(opt, wk.MODE_TB, 1 << 20)
    assert el(Options(o2=40), wk.MODE_SCORE, 1 << 17)   # any penalty set


class _Sized(Exception):
    pass


def test_pass1_sizing_in_wide_territory(monkeypatch):
    """A pass-1 window past WIDE_PASS1_W_MIN is sized once at the largest
    band the pair can reach (clipped to W_full), S_CAP from half of it, and
    the dispatch goes to the wide engine."""
    seen = []

    def fake_wide(opt, mode, bk, ts, qs, device):
        seen.append((mode, bk))
        raise _Sized

    monkeypatch.setattr(exact, "WIDE_PASS1_W_MIN", 256)
    monkeypatch.setattr(exact, "_run_wide", fake_wide)
    t = b"ACGT" * 750
    with pytest.raises(_Sized):
        exact._run_pass1(Options(cigar=True, step=100), [t], [t], 512, 512,
                         torch.device("cpu"))
    mode, bk = seen[0]
    assert mode == wk.MODE_PASS1 and (bk.LT, bk.LQ) == (4096, 4096)
    # band_max = 8192 + 2*17 + 64 -> 16384; S_CAP = 8192 + 4*17 + 64 -> 12288
    assert (bk.W, bk.S_CAP) == (16384, 12288)


def test_convert_wide_pointers_decode_as_jax_does():
    """Every plane of the JAX wide kernel's snapshot layout, carried into
    the port's by convert.wide_ptr, decodes to the (score, diagonal) the
    JAX package's own decoder gives."""
    spec = wk.KSpec(W=W, S_CAP=512, mode=wk.MODE_PASS1, step=10, n_snap=53,
                    **PENS)
    jspec = jww.WSpec(B=1, WR=WR, S_CAP=512, mode=jwk.MODE_PASS1, step=10,
                      n_snap=53, **PENS).kspec()
    nring = jwk.snapshot_layout(jspec)[5]
    wpt = (WR + 8) * 128
    for c, anc in ((0, -8192), (4, -300)):
        for p in range(nring):
            v = p * wpt + 37
            mine = tbk.ptr_to_seg(int(convert.wide_ptr(v, c, spec, wpt)), c,
                                  anc, spec)
            assert mine == jtbk._kernel_ptr_to_seg(v, c, anc, jspec)
    assert convert.wide_ptr(-1, 0, spec, wpt) == -1
    assert convert.wide_ptr(wk.WF_NEG_INF, 0, spec, wpt) == wk.WF_NEG_INF


def test_wide_rejects_bad_inputs(goldens):
    t, q = _case(goldens, "t3")
    spec, args, _, _ = _port_inputs(t, q)
    state = ww.new_state(spec, args[0])
    with pytest.raises(ValueError, match="SCORE and PASS1"):
        ww.wide(dataclasses.replace(spec, mode=wk.MODE_TB), *args, state,
                torch.tensor([10]))
    with pytest.raises(ValueError, match="t_lim"):
        ww.wide(spec, *args, state, torch.tensor([10], dtype=torch.int32))
    bad = ww.WideState(state.row[:, :-1].contiguous(), state.planes, None)
    with pytest.raises(ValueError, match="row"):
        ww.wide(spec, *args, bad, torch.tensor([10]))
