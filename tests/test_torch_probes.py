"""Group P: the port's probe functions (ops/probes.py, ops/probes_multi.py)
against the JAX probes of tools/microbench_*.py run in Pallas interpret
mode on the CPU, one case per kernel body (32), exact equality.

The tool files stay as they are: ``pl.pallas_call`` is patched to
``interpret=True``, the loop counts are cut through the modules' ITERS
globals, and each tool's jitted entry is wrapped so that its inputs and
outputs are recorded; the port's wrappers then run on the same inputs as
CPU tensors (their plain versions).
"""

import functools
import re

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from miniwfa_tpu_torch.ops import probes as pb
from miniwfa_tpu_torch.ops import probes_multi as pm
from miniwfa_tpu_torch.tools import microbench as mb
from tools import microbench_chunk as tch
from tools import microbench_mosaic as tmo
from tools import microbench_mosaic2 as tmo2
from tools import microbench_mosaic3 as tmo3
from tools import microbench_multi_probe as tmp1
from tools import microbench_multi_probe2 as tmp2
from tools import microbench_multi_probe3 as tmp3
from tools import microbench_pallas2 as tpa2

torch.set_num_threads(1)

IT = 5   # loop count of every looped probe here


class Recorder:
    """Patches pallas_call to interpret mode and records (inputs, output)
    of every jitted function defined in tools/."""

    def __init__(self, mp):
        self.calls = []
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        real_jit = jax.jit

        def jit(fn, *a, **k):
            j = real_jit(fn, *a, **k)
            if not getattr(fn, "__module__", "").startswith("tools."):
                return j

            def run(*args):
                out = j(*args)
                self.calls.append(([np.asarray(x) for x in args],
                                   [np.asarray(o) for o in
                                    jax.tree_util.tree_leaves(out)]))
                return out
            return run
        mp.setattr(jax, "jit", jit)


@pytest.fixture
def rec(monkeypatch):
    for mod in (tmo, tmo2, tmo3):
        monkeypatch.setattr(mod, "ITERS", IT)
        monkeypatch.setattr(mod, "REPS", 1)
    return Recorder(monkeypatch)


@pytest.fixture(scope="module")
def mosaic3_calls():
    """tools/microbench_mosaic3.py main() once: its six runs, each
    recorded twice (compile + REPS=1)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmo3, "ITERS", IT)
        mp.setattr(tmo3, "REPS", 1)
        r = Recorder(mp)
        tmo3.main()
    assert len(r.calls) == 12
    return r.calls[::2]


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(want, got):
    got = got if isinstance(got, (tuple, list)) else [got]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert tuple(w.shape) == tuple(g.shape)
        assert g.dtype == torch.from_numpy(w).dtype
        assert np.array_equal(w, g.numpy())


def _one(rec, tool_fn, *args):
    """Run a printing tool function; its first recorded call."""
    tool_fn(*args)
    assert rec.calls, "the tool recorded no call (it failed)"
    return rec.calls[0]


# --------------------------------------------------- microbench_mosaic.py

def case_P1a(rec):
    (tab, idx), want = _one(rec, tmo.bench_gather, 8, 2048)
    _same(want, pb.bench_gather(_t(tab), _t(idx), IT))


def case_P1b(rec):
    (tab, idx), want = _one(rec, tmo.bench_gather_ax0, 64, 2048)
    _same(want, pb.bench_gather_ax0(_t(tab), _t(idx), IT))


def case_P1c(rec):
    (x, s), want = _one(rec, tmo.bench_varshift, 8, 2048)
    _same(want, pb.bench_varshift(_t(x), _t(s), IT))


def case_P1d(rec):
    (x,), want = _one(rec, tmo.bench_popcount, 8, 2048)
    _same(want, pb.bench_popcount(_t(x), IT))


def case_P1e(rec):
    (x,), want = _one(rec, tmo.bench_hbm_row_write, 1024, 2048)
    assert want[0][IT:].max() == 0   # rows no t reaches: 0 (uint8 min)
    _same(want, pb.bench_hbm_row_write(_t(x), 1024, IT))


def case_P1f(rec):
    (x,), want = _one(rec, tmo.bench_while_scalar, 2048)
    assert (want[0] == IT).all()
    _same(want, pb.bench_while_scalar(_t(x), IT))


# -------------------------------------------------- mosaic2 and pallas2

def case_P2(rec):
    for axis in (1, 0):
        rec.calls.clear()
        (tab, idx), want = _one(rec, tmo2.bench, 8, 2048, axis, IT)
        _same(want, pb.gather_chain(_t(tab), _t(idx), axis, IT))


def case_P3(rec):
    tpa2.main()
    forms = [1, 1, 1, 0, 0, 2]
    assert len(rec.calls) == len(forms)
    for ((tab, idx), want), axis in zip(rec.calls, forms):
        _same(want, pb.take_along(_t(tab), _t(idx), axis))


# ------------------------------------------------------------ mosaic3

def case_P4a(mosaic3_calls):
    for (tab, idx), want in mosaic3_calls[:2]:
        _same(want, pb.ax1_gather_loop(_t(tab), _t(idx), IT))


def case_P4b(mosaic3_calls):
    (x,), want = mosaic3_calls[2]
    _same(want, pb.dynamic_roll(_t(x), IT))


def case_P4c(mosaic3_calls):
    (tab, starts), want = mosaic3_calls[3]
    assert starts.shape == (1, IT)
    _same(want, pb.lane_slice(_t(tab), _t(starts)))


def case_P4d(mosaic3_calls):
    (tab, rows), want = mosaic3_calls[4]
    _same(want, pb.sublane_slice(_t(tab), _t(rows)))


def case_P4e(mosaic3_calls):
    (tab, bases), want = mosaic3_calls[5]
    _same(want, pb.refill(_t(tab), _t(bases)))


# -------------------------------------------------------------- chunk

def case_P5(rec):
    # WR=16 CR=8 NR=16 overruns (3 chunks on odd cycles: rows 16..31 of
    # the 24-row planes, tb rows 4..5 of 4), WR=32 stays in bounds; T=4
    # ends on an odd cycle, T=70 reuses tb slots 0..5 (t % 64)
    for WR, CR, T, NR, chunked in [(16, 8, 4, 16, True), (32, 8, 4, 16, True),
                                   (16, 0, 3, 16, False),
                                   (16, 8, 70, 16, True)]:
        want = [np.asarray(o) for o in tch.build(WR, CR, T, NR, chunked)()]
        _same(want, pb.chunk(WR, CR, T, NR, chunked, device="cpu"))


# ------------------------------------------------------- multi probes

def _multi1_inputs():
    rng = np.random.default_rng(0)
    G, R, L = tmp1.G, tmp1.R, tmp1.L
    x = rng.integers(0, 100, (G, R, L), dtype=np.int32)
    idx = rng.integers(0, L, (G, R, L), dtype=np.int32)
    b = rng.integers(0, 50, (8, L), dtype=np.int32)
    return x, idx, b


def _jax(fn, *args):
    out = fn(*[jax.numpy.asarray(a) for a in args], interpret=True)
    return [np.asarray(o) for o in jax.tree_util.tree_leaves(out)]


def case_P6a(rec):
    x, idx, _ = _multi1_inputs()
    _same(_jax(tmp1.gather3, x, idx), pm.gather3(_t(x), _t(idx)))


def case_P6b(rec):
    x, idx, _ = _multi1_inputs()
    _same(_jax(tmp1.gather_flat, x, idx), pm.gather_flat(_t(x), _t(idx)))


def case_P6c(rec):
    x, _, _ = _multi1_inputs()
    _same(_jax(tmp1.lane_mask, x), pm.lane_mask(_t(x)))


def case_P6d(rec):
    x, _, _ = _multi1_inputs()
    _same(_jax(tmp1.shift3, x), pm.shift3(_t(x)))


def case_P6e(rec):
    # ring4 itself fails in interpret mode (pl.ds on a value); f_d of
    # multi_probe2 is its fix and defines its function
    x, _, _ = _multi1_inputs()
    with pytest.raises(IndexError):
        _jax(tmp1.ring4, x)
    _same(_jax(tmp2.f_d, x), pm.ring4(_t(x)))


def case_P6f(rec):
    x, _, b = _multi1_inputs()
    _same(_jax(tmp1.bnd, x, b), pm.bnd(_t(x), _t(b)))


def case_P6g(rec):
    x, _, _ = _multi1_inputs()
    _same(_jax(tmp1.sub, x), pm.sub(_t(x)))


def _x2():
    return np.random.default_rng(0).integers(
        0, 100, (tmp2.G, tmp2.R, tmp2.L), dtype=np.int32)


def case_P7a(rec):
    _same(_jax(tmp2.f_a, _x2()), pm.multi2_f_a(_t(_x2())))


def case_P7b(rec):
    _same(_jax(tmp2.f_b, _x2()), pm.multi2_f_b(_t(_x2())))


def case_P7c(rec):
    _same(_jax(tmp2.f_c, _x2()), pm.multi2_f_c(_t(_x2())))


def case_P7d(rec):
    _same(_jax(tmp2.f_d, _x2()), pm.multi2_f_d(_t(_x2())))


def case_P7e(rec):
    _same(_jax(tmp2.f_e, _x2()), pm.multi2_f_e(_t(_x2())))


def case_P7f(rec):
    _same(_jax(tmp2.f_f, _x2()), pm.multi2_f_f(_t(_x2())))


def _x3():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, (tmp3.G, tmp3.R, tmp3.L), dtype=np.int32)
    s = rng.integers(0, 9, (tmp3.G,), dtype=np.int32)
    return x, s


def case_P8a(rec):
    x, _ = _x3()
    _same(_jax(tmp3.f_a, x), pm.multi3_f_a(_t(x)))


def case_P8b(rec):
    x, _ = _x3()
    _same(_jax(tmp3.f_b, x), pm.multi3_f_b(_t(x)))


def case_P8c(rec):
    x, _ = _x3()
    _same(_jax(tmp3.f_c, x), pm.multi3_f_c(_t(x)))


def case_P8d(rec):
    x, s = _x3()
    _same(_jax(tmp3.f_d, s, x), pm.multi3_f_d(_t(s), _t(x)))


def case_P8e(rec):
    x, _ = _x3()
    _same(_jax(tmp3.f_e, x), pm.multi3_f_e(_t(x)))


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("pid", sorted(CASES))
def test_probe_matches_jax_interpret(pid, request):
    fn = CASES[pid]
    arg = fn.__code__.co_varnames[0]
    fn(request.getfixturevalue(arg))


def test_every_probe_body_has_a_case():
    pids = {c.pid for c in mb.all_cases()}
    assert len(CASES) == 32 and set(CASES) == pids
    assert len(mb.wrappers()) == 32


@pytest.mark.parametrize("name", sorted(mb.FILES))
def test_microbench_cpu_runs_plain(name, capsys):
    """The tool on the CPU: every case of the file runs its plain version
    and prints one line."""
    assert mb.main([name, "--device", "cpu", "--iters", "2"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "plain (cpu)" in ln]
    assert len(lines) == len(mb.FILES[name]())


def test_probe_wrappers_refuse_bad_inputs():
    x = torch.zeros((8, 16), dtype=torch.int64)
    with pytest.raises(ValueError):
        pb.bench_popcount(x, 1)
    with pytest.raises(ValueError):
        pb.chunk(18, 8, 1, 16, True, device="cpu")
    with pytest.raises(ValueError):
        pb.take_along(torch.zeros((2, 3, 4), dtype=torch.int32),
                      torch.zeros((2, 3, 4), dtype=torch.int32), 1)


# ------------------------------------------------ the kernels' host plans

def _gather_shapes():
    """(Rt, Mt, Ri, Mi, axis) of every looped gather case the tool runs
    (P1a, P1b, P2, P4a), then tails: an element count that no share
    divides, and groups cut short at the end."""
    shapes = []
    for c in mb.all_cases():
        if c.pid in ("P1a", "P1b", "P2", "P4a"):
            x, _ = mb.inputs(c, 0, 1, "cpu")
            axis = int(re.search(r"ax(\d)", c.label).group(1))
            shapes.append((*x[0].shape, *x[1].shape, axis))
    assert len(shapes) == 13
    shapes += [(8, 1000, 8, 1000, 1), (7, 777, 7, 777, 1),
               (300, 5, 300, 3, 1), (133, 9, 133, 9, 1),
               (64, 2047, 5, 2047, 0), (3, 1001, 17, 1001, 0),
               (1000, 3, 1, 3, 0)]
    return shapes


def _owned(plan, Rt, Mt, Ri, Mi, axis):
    """The idx elements (flat) each block of the gather loop owns, by the
    index math of csrc/probes.cu gather_kernel."""
    blocks, per, _ = plan
    units = Rt if axis == 1 else Mt
    splits = blocks // -(-units // per)
    owned = []
    for b in range(blocks):
        u0 = (b // splits) * per
        w = Mi if axis == 1 else min(per, Mt - u0)
        n = (min(per, Rt - u0) if axis == 1 else Ri) * w
        share = -(-n // splits)
        e0 = min(n, (b % splits) * share)
        e = np.arange(e0, min(n, e0 + share))
        r, c = e // w, e % w
        owned.append((u0 + r) * Mi + c if axis == 1 else r * Mi + u0 + c)
    return owned


@pytest.mark.parametrize("shape", _gather_shapes())
@pytest.mark.parametrize("sms", [132, 8])
def test_gather_plan_owns_every_element_once(shape, sms):
    Rt, Mt, Ri, Mi, axis = shape
    smem = pb.SMEM_OPTIN
    plan = pb.gather_plan(Rt, Mt, Ri, Mi, axis, sms, smem)
    pb.check_gather_plan(plan, Rt, Mt, axis, smem)
    blocks, per, chains = plan
    assert 4 * per * (Mt if axis == 1 else Rt) <= smem
    owned = _owned(plan, Rt, Mt, Ri, Mi, axis)
    assert len(owned) == blocks
    flat = np.concatenate(owned)
    assert np.array_equal(np.sort(flat), np.arange(Ri * Mi))
    # a share runs in one pass where CHAINS allow, and is a warp at least
    # wherever the grid was cut for the SMs
    most = max(len(o) for o in owned)
    assert most <= chains * pb.GATHER_THREADS or chains == 8
    if blocks > -(-(Rt if axis == 1 else Mt) // per):
        assert min(len(o) for o in owned) >= 1


def test_gather_plan_fills_the_card():
    """The tool's largest loops run on every SM of an H100, as many blocks
    on each: P1a [8, 16384] on 32 blocks a row (2 an SM), P1b [512, 128]
    on 2 a column."""
    assert pb.gather_plan(8, 16384, 8, 16384, 1, 132, pb.SMEM_OPTIN) \
        == (256, 1, 2)
    assert pb.gather_plan(512, 128, 512, 128, 0, 132, pb.SMEM_OPTIN) \
        == (256, 1, 1)
    for shape in _gather_shapes()[:13]:
        Rt, Mt, Ri, Mi, axis = shape
        blocks = pb.gather_plan(*shape, 132, pb.SMEM_OPTIN)[0]
        if Ri * Mi >= 132 * pb.GATHER_MIN_SHARE:
            assert blocks >= 132, shape


@pytest.mark.parametrize("smem", [pb.SMEM_OPTIN, 48 * 1024, 4 * 2048])
def test_gather_plan_stays_in_its_budget(smem):
    for Rt, Mt, Ri, Mi, axis in _gather_shapes():
        unit = Mt if axis == 1 else Rt
        if 4 * unit > smem:
            with pytest.raises(ValueError):
                pb.gather_plan(Rt, Mt, Ri, Mi, axis, 132, smem)
            continue
        blocks, per, _ = pb.gather_plan(Rt, Mt, Ri, Mi, axis, 132, smem)
        assert 4 * per * unit <= smem


def test_gather_plan_check_refuses_bad_plans():
    ok = pb.gather_plan(8, 2048, 8, 2048, 1, 132, pb.SMEM_OPTIN)
    pb.check_gather_plan(ok, 8, 2048, 1, pb.SMEM_OPTIN)
    for bad in [(0, 1, 1), (24, 0, 1), (24, 9, 1), (25, 1, 1), (24, 1, 3)]:
        with pytest.raises(ValueError):
            pb.check_gather_plan(bad, 8, 2048, 1, pb.SMEM_OPTIN)
    with pytest.raises(ValueError):   # 8 rows of 2048: 64 KB
        pb.check_gather_plan((1, 8, 1), 8, 2048, 1, 48 * 1024)


def test_chunk_plan_fits_and_refuses():
    # the tool's WR: a cluster of 8 CTAs, 16 lanes each, its planes in
    # shared memory
    assert pb.chunk_plan(184, 232448) == (8, 16)
    assert pb.chunk_smem(184, 8) <= 232448
    # past a cluster of 8, one of 16 (8 lanes a CTA); past that, refused
    wr8 = max(w for w in range(4, 2000, 4) if pb.chunk_smem(w, 8) <= 232448)
    assert pb.chunk_plan(wr8 + 4, 232448) == (16, 8)
    wr16 = max(w for w in range(4, 2000, 4)
               if pb.chunk_smem(w, 16) <= 232448)
    assert wr16 >= 2 * 184
    with pytest.raises(ValueError):
        pb.chunk_plan(wr16 + 4, 232448)
    assert pb.chunk_plan(184, 100_000) == (16, 8)
    with pytest.raises(ValueError):
        pb.chunk_plan(184, 80_000)
    # a lane's rows padded to an odd number of 16-byte groups
    for WR in (4, 8, 184, 188):
        assert (((WR + 8) | 4) // 4) % 2 == 1


@pytest.mark.parametrize("R,M,axis,plan", [
    (8, 2048, 1, (24, 1, 1)), (8, 16384, 1, (8, 1, 8)),
    (64, 2048, 0, (1366, 3, 2)), (512, 128, 0, (384, 1, 4))])
def test_forced_gather_plans_own_every_element_once(R, M, axis, plan):
    """The card tests' forced plans (partial last shares and groups) pass
    the launcher's check and cover idx once."""
    pb.check_gather_plan(plan, R, M, axis, pb.SMEM_OPTIN)
    flat = np.concatenate(_owned(plan, R, M, R, M, axis))
    assert np.array_equal(np.sort(flat), np.arange(R * M))


def _while_owned(plan, n):
    """The state elements each block of the while loop owns, by the index
    math of csrc/probes.cu while_kernel (WHILE_PER a thread, the padding
    past n stored nowhere)."""
    blocks, threads, per = plan
    owned = []
    for b in range(blocks):
        e = (b * threads + np.arange(threads))[:, None] * per + np.arange(per)
        owned.append(e[e < n])
    return owned


@pytest.mark.parametrize("n", [1, 31, 16384, 16385])
@pytest.mark.parametrize("sms", [1, 132])
def test_while_plan_owns_every_element_once(n, sms):
    plan = pb.while_plan(n, sms)
    pb.check_while_plan(plan, n)
    blocks, threads, per = plan
    owned = _while_owned(plan, n)
    assert np.array_equal(np.sort(np.concatenate(owned)), np.arange(n))
    # every block holds state (the last one partial), within 16 KB
    assert min(len(o) for o in owned) >= 1
    assert threads * per * 4 <= 16384


def _row_owned(plan, S, W):
    """(row, first byte, bytes) of every row segment each block of the row
    write owns, by the index math of csrc/probes.cu row_write_kernel."""
    blocks, threads = plan
    seg = 16 * threads
    segs = -(-W // seg)
    rb = blocks // segs
    return [[(r, (b % segs) * seg, min(seg, W - (b % segs) * seg))
             for r in range(b // segs, S, rb)] for b in range(blocks)]


def _row_write_schedule(plan, S, W, iters):
    """Each block's iterations t in the kernel's order."""
    blocks, threads = plan
    segs = -(-W // (16 * threads))
    rb = blocks // segs
    return [[base + r for base in range(0, iters, S)
             for r in range(b // segs, S, rb) if base + r < iters]
            for b in range(blocks)]


@pytest.mark.parametrize("S", [1, 7, 1024, 1025])
@pytest.mark.parametrize("W", [2048, 2052, 40000])
@pytest.mark.parametrize("sms", [1, 132])
def test_row_write_plan_owns_every_row_once(S, W, sms):
    plan = pb.row_write_plan(S, W, sms)
    pb.check_row_write_plan(plan, S, W)
    blocks, threads = plan
    owned = _row_owned(plan, S, W)
    assert len(owned) == blocks and min(len(o) for o in owned) >= 1
    cover = np.zeros((S, W), np.int32)
    for segs in owned:
        for r, c0, n in segs:
            assert n <= 16 * threads   # 16 bytes a thread cover a segment
            cover[r, c0:c0 + n] += 1
    assert (cover == 1).all()
    # the busiest block owns as few rows as the card's SMs allow
    segs = -(-W // (16 * threads))
    most = max(1, min(S, sms // segs))
    assert max(len(o) for o in owned) == -(-S // most)


@pytest.mark.parametrize("S,iters", [(1, 9), (7, 40), (8, 29), (1025, 2600)])
def test_row_write_schedule_runs_every_iteration_in_order(S, iters):
    """Simulate each block's iterations: every t runs once, each block's
    in increasing t, and a row's iterations all in one block, so a byte's
    writes come from one thread in program order (the later lands last)."""
    plan = pb.row_write_plan(S, 2048, 132)
    sched = _row_write_schedule(plan, S, 2048, iters)
    assert sorted(t for ts in sched for t in ts) == list(range(iters))
    rows = {}
    for b, ts in enumerate(sched):
        assert ts == sorted(ts)
        for t in ts:
            assert rows.setdefault(t % S, b) == b


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_row_write_plan_stays_on_the_card(sms):
    """Blocks of whole warps up to 1024 threads, no more blocks than SMs
    where the rows allow, at any W the kernel takes (1 MB rows: 64
    segments of 16 KB)."""
    for S, W in [(1024, 2048), (1025, 2052), (8, 40000), (3, 1 << 20),
                 (1, 4)]:
        blocks, threads = pb.row_write_plan(S, W, sms)
        assert 32 <= threads <= 1024 and threads % 32 == 0
        segs = -(-W // (16 * threads))
        assert blocks <= max(sms, segs)
        pb.check_row_write_plan((blocks, threads), S, W)


def test_probe_plans_fill_the_card():
    """The tool's shapes on every SM of an H100: P1f [8, 2048] on 128
    blocks of a warp, P1e [1024, 2048] on 128 blocks of 8 rows each."""
    assert pb.while_plan(8 * 2048, 132) == (128, 32, 4)
    assert pb.row_write_plan(1024, 2048, 132) == (128, 128)


def test_while_and_row_write_plan_checks_refuse_bad_plans():
    pb.check_while_plan((128, 32, 4), 16384)
    for bad in [(128, 32, 8), (128, 48, 4), (127, 32, 4), (129, 32, 4),
                (1, 2048, 4)]:
        with pytest.raises(ValueError):
            pb.check_while_plan(bad, 16384)
    pb.check_row_write_plan((128, 128), 1024, 2048)
    for bad in [(128, 48), (128, 2048), (2048, 128), (0, 128)]:
        with pytest.raises(ValueError):
            pb.check_row_write_plan(bad, 1024, 2048)
    # 3 segments a row: blocks a multiple of 3, at most 8 row classes
    for bad in [(4, 32), (27, 32)]:
        with pytest.raises(ValueError):
            pb.check_row_write_plan(bad, 8, 1500)
    pb.check_row_write_plan((24, 32), 8, 1500)


# ------------------------------------------ the multi and roll kernels' plans

# shapes: the tools', every G, L = 130 (a scalar tail; at R = 63 the lanes
# are not 16-byte aligned), odd R, a lane of 56,550 words
MULTI_SHAPES = [(4, 64, 128), (1, 64, 128), (2, 33, 130), (4, 63, 130),
                (8, 25, 130), (1, 390, 145)]
OPTIN = pb.SMEM_OPTIN


def _multi_rx(probe, R):
    return R + 8 if probe in pm.RINGS else R


def _multi_words(plan, probe, R, L):
    """The words of a lane each (CTA, thread, vector) holds, by the index
    math of csrc/probes.cu multi_kernel: [C, threads, nv, 4], -1 past the
    CTA's words."""
    C, T, nv = plan
    n = pm.multi_domain(probe, R, L)
    span = pm.multi_span(n, C)
    c0 = (np.arange(C) * span)[:, None, None, None]
    w = c0 + 4 * (np.arange(T)[None, :, None, None]
                  + np.arange(nv)[None, None, :, None] * T) \
        + np.arange(4)[None, None, None, :]
    c1 = np.minimum(n, c0 + span)
    return np.where(w < c1, w, -1)


def _multi_plans(probe, G, R, L):
    """The chooser's plans for an H100 and for a card of one SM."""
    return {pm.multi_plan(G, R, L, sms, OPTIN, probe) for sms in (132, 1)}


@pytest.mark.parametrize("shape", MULTI_SHAPES)
@pytest.mark.parametrize("probe", range(pm.N_MULTI))
def test_multi_plan_holds_every_word_once(probe, shape):
    """Every plan the chooser makes passes the kernel's checks, and its
    CTAs and threads hold each word of a lane once; a cluster is at most 8
    CTAs and a ring's share fits a block (the rings never leave shared
    memory, at any shape the kernel takes)."""
    G, R, L = shape
    try:
        pm.check_multi_shape(probe, G, R, L, _multi_rx(probe, R))
    except ValueError:
        with pytest.raises(ValueError):
            pm.multi_plan(G, R, L, 132, OPTIN, probe)
        return
    n = pm.multi_domain(probe, R, L)
    for plan in _multi_plans(probe, G, R, L):
        pm.check_multi_plan(plan, probe, G, R, L)
        C, T, nv = plan
        w = _multi_words(plan, probe, R, L)
        held = np.sort(w[w >= 0])
        assert np.array_equal(held, np.arange(n)), plan
        assert (w >= 0).reshape(C, -1).any(1).all()   # no CTA without words
        assert pm.multi_cluster(probe, G, C) <= pm.MULTI_CLUSTER
        span = pm.multi_span(n, C)
        assert pm.multi_smem(probe, span, L) + pm.MULTI_STATIC <= OPTIN
        if probe in pm.RINGS:
            assert 3 * 4 * span * C >= 3 * 4 * n


def test_multi_plan_at_the_tools_shape():
    """[4, 64, 128]: a probe reducing within its lane on a CTA a lane of
    512 threads, 16 words each (both cards); the two spanning the lanes on
    2 CTAs a lane, a cluster of 8 (one CTA a lane on a card of one SM); the
    others spread over 8 CTAs a lane (9 for RING4's padded tile) on an
    H100, a CTA a lane on a card of one SM, where RING4's ring share is the
    lane's whole ring, 110,592 bytes."""
    for probe in pm.REDUCING:
        for sms in (132, 1):
            want = ((2, 256, 4) if probe in pm.CROSS and sms > 1
                    else (1, 512, 4))
            assert pm.multi_plan(4, 64, 128, sms, OPTIN, probe) == want
    for probe in (pm.SHIFT3, pm.BND, pm.SUB, pm.RING_WRITE, pm.ADD_SCALAR):
        assert pm.multi_plan(4, 64, 128, 132, OPTIN, probe) == (8, 256, 1)
        assert pm.multi_plan(4, 64, 128, 1, OPTIN, probe) == (1, 1024, 2)
    assert pm.multi_plan(4, 64, 128, 132, OPTIN, pm.RING4) == (9, 256, 1)
    assert pm.multi_plan(4, 64, 128, 1, OPTIN, pm.RING4) == (1, 768, 3)
    assert pm.multi_smem(pm.RING4, pm.multi_span(72 * 128, 1), 128) \
        == 110_592
    # the largest lane: 4 CTAs, a cluster of 4 for its reductions
    assert pm.multi_plan(1, 390, 145, 1, OPTIN, pm.WHILE_G11)[0] == 4
    assert pm.multi_plan(1, 390, 145, 1, OPTIN, pm.RING4)[0] == 4


@pytest.mark.parametrize("probe,G,R,L,RX", [
    (pm.MIN_MASK, 3, 64, 128, 64), (pm.MIN_MASK, 16, 4, 4, 4),
    (pm.MIN_MASK, 4, 0, 128, 0), (pm.SUB, 4, 23, 128, 23),
    (pm.STACK, 4, 8, 128, 8), (pm.RING4, 4, 64, 128, 64),
    (pm.MIN_MASK, 8, 64, 128, 64), (pm.REGISTRY, 1, 451, 128, 451),
    (14, 4, 64, 128, 64)])
def test_multi_shapes_the_kernel_refused_stay_refused(probe, G, R, L, RX):
    """What the single-block kernel refused (G not 1, 2, 4, 8; R < 1; SUB
    R < 24; STACK R <= 8; a ring input not R + 8 rows; a tile past one
    block's shared memory; an unknown probe) raises before a launch."""
    with pytest.raises(ValueError):
        pm.check_multi_shape(probe, G, R, L, RX)
    if RX == _multi_rx(probe, R) and probe < pm.N_MULTI:
        with pytest.raises(ValueError):
            pm.multi_plan(G, R, L, 132, OPTIN, probe)


def test_multi_shapes_at_the_edge_of_the_tile_are_taken():
    """The largest tiles the single-block kernel took still plan; a row
    more is refused."""
    for probe, G, R in [(pm.REGISTRY, 1, 428), (pm.WHILE_G11, 8, 56),
                        (pm.RING4, 1, 444), (pm.MIN_MASK, 1, 452)]:
        pm.multi_plan(G, R, 128, 132, OPTIN, probe)
        with pytest.raises(ValueError):
            pm.multi_plan(G, R + 1, 128, 132, OPTIN, probe)


@pytest.mark.parametrize("plan", [
    (0, 1024, 2), (1, 1024, 1), (1, 1024, 5), (1, 48, 2), (1, 2048, 1),
    (9, 1024, 1), (2049, 32, 1)])
def test_multi_plan_check_refuses_bad_plans(plan):
    """No CTA, short of the lane, nv past 4, no whole warps, past 1024
    threads, a cluster of 9, CTAs without words: refused, as the kernel's
    entry refuses them."""
    with pytest.raises(ValueError):
        pm.check_multi_plan(plan, pm.MIN_MASK, 4, 64, 128)
    # RING4 at one CTA a lane: its ring needs 110,592 bytes
    pm.check_multi_plan((1, 768, 3), pm.RING4, 4, 64, 128)
    with pytest.raises(ValueError):
        pm.check_multi_plan((1, 768, 3), pm.RING4, 4, 64, 128, 100_000)


def test_multi_allocates_out_and_s_only(monkeypatch):
    """The rings live in shared memory: ``_multi`` allocates out [G, R, L]
    and the scalars, passes the plan, and no ring buffer."""
    calls = []
    monkeypatch.setattr(pm, "_launch", lambda *a: calls.append(a))
    allocs = []
    real_zeros = torch.zeros

    def zeros(*a, **k):
        t = real_zeros(*a, **k)
        allocs.append(tuple(t.shape))
        return t
    monkeypatch.setattr(torch, "zeros", zeros)
    x = pm._pad8(torch.ones((4, 64, 128), dtype=torch.int32))
    for probe, plan in [(pm.RING4, (9, 256, 1)), (pm.RING_WRITE, (8, 256, 1)),
                        (pm.RING4, (1, 768, 3))]:
        allocs.clear()
        out = pm._multi(pm.ring4, probe, x, padded=True, plan=plan)
        assert tuple(out.shape) == (4, 64, 128)
        assert allocs == [(4, 64, 128), (1,)]
        args = calls[-1][4:]
        assert len(args) == 12 and tuple(args[-3:]) == plan


def _emulate_multi(probe, x, plan):
    """out of SHIFT3, SUB, STACK, RING4 and RING_WRITE by the kernel's index
    math: each thread's words, SHIFT3's left neighbour from the thread
    before (or from memory at a warp's edge), the ring's five writes and
    read at each word's own place in its CTA's share."""
    G, RX, L = x.shape
    R = RX - 8 if probe in pm.RINGS else RX
    n = pm.multi_domain(probe, R, L)
    span = pm.multi_span(n, plan[0])
    out = np.full((G, R * L), -77, np.int64)
    w = _multi_words(plan, probe, R, L)
    for g in range(G):
        xg = x[g].reshape(-1).astype(np.int64)
        v = np.where(w >= 0, xg[np.maximum(w, 0)], 0)
        ok = w >= 0
        if probe == pm.SHIFT3:
            T = plan[1]
            up = np.roll(v[..., 3], 1, axis=1)   # the thread before's .w
            lane0 = (np.arange(T) % 32 == 0)[None, :, None]
            edge = xg[np.maximum(w[..., 0] - 1, 0)]
            prev = np.where(lane0, edge, up)
            prev = np.where(w[..., 0] == 0, -9, prev)
            o = np.concatenate([prev[..., None], v[..., :3]], -1)
            out[g, w[ok]] = o[ok]
        elif probe == pm.SUB:
            y = xg[np.minimum(np.maximum(w, 0) + 16 * L, R * L - 1)]
            o = np.where(w < 8 * L, 2 * y, v)
            out[g, w[ok]] = o[ok]
        elif probe == pm.STACK:
            a = min(max(int(xg[:n].min()) % (R - pm.SR), 0), R - pm.SR)
            o = np.where((w >= a * L) & (w < (a + pm.SR) * L), 2 * v, v)
            out[g, w[ok]] = o[ok]
        else:   # the rings: [C][3][span] shares
            ring = np.zeros((plan[0], 3, span), np.int64)
            c = np.broadcast_to(np.arange(plan[0])[:, None, None, None],
                                w.shape)
            q = w - c * span
            for j in range(5):
                ring[c[ok], j % 3, q[ok]] = v[ok] + j
            r = ring[c[ok], 1, q[ok]]
            dst = w[ok] - (8 * L if probe == pm.RING4 else 0)
            keep = dst >= 0
            out[g, dst[keep]] = r[keep]
    return torch.from_numpy(out.reshape(G, R, L).astype(np.int32))


@pytest.mark.parametrize("shape", MULTI_SHAPES)
@pytest.mark.parametrize("probe,fn", [
    (pm.SHIFT3, pm.shift3_plain), (pm.SUB, pm.sub_plain),
    (pm.STACK, pm.multi3_f_b_plain), (pm.RING4, pm.ring4_plain),
    (pm.RING_WRITE, pm.multi2_f_e_plain)])
def test_multi_index_math_matches_plain(probe, fn, shape):
    """The kernel's word placement, neighbour and ring offsets, emulated
    on each plan of the chooser and on forced plans of 2, 3 and 8 CTAs a
    lane, equal the plain version."""
    G, R, L = shape
    try:
        pm.check_multi_shape(probe, G, R, L, _multi_rx(probe, R))
    except ValueError:
        return
    rng = np.random.default_rng(R * L)
    x = torch.from_numpy(rng.integers(-1000, 1000, (G, R, L),
                                      dtype=np.int32))
    xin = pm._pad8(x) if probe in pm.RINGS else x
    plans = _multi_plans(probe, G, R, L) | {(2, 1024, 4), (3, 704, 1),
                                            (8, 256, 1)}
    want = fn(x)
    for plan in plans:
        try:
            pm.check_multi_plan(plan, probe, G, R, L)
        except ValueError:
            continue
        assert torch.equal(_emulate_multi(probe, xin.numpy(), plan), want), \
            plan


ROLL_SHAPES = [(8, 256), (8, 200), (8, 1), (1, 29056), (29, 1001), (1024, 1),
               (7, 3), (56, 513)]


def _emulate_roll(x, iters, plan):
    """The roll by csrc roll_kernel's index math: element e = t + k *
    threads; where threads % M == 0 one offset d = sh - (col < sh ? M : 0)
    a thread from its column t mod M, else each element's column stepped
    on by threads mod M from the one before."""
    R, M = x.shape
    T, per = plan
    n = R * M
    t = np.arange(T)[:, None]
    k = np.arange(per)[None, :]
    e = t + k * T
    col = (t % M + k * (T % M)) % M        # the stepped columns
    assert np.array_equal(col, e % M)
    ok = e < n
    a = x.reshape(-1).astype(np.int64).copy()
    for _ in range(iters):
        sh = (int(a[0]) & 0xFF) % M
        b = np.empty_like(a)
        if T % M == 0:
            d = sh - np.where(t % M < sh, M, 0) + 0 * k
            b[e[ok]] = a[(e - d)[ok]] + 1
        else:
            b[e[ok]] = a[(e - sh + np.where(col < sh, M, 0))[ok]] + 1
        a = b
    return torch.from_numpy(a.reshape(R, M).astype(np.int32))


@pytest.mark.parametrize("shape", ROLL_SHAPES)
def test_roll_plan_covers_every_element_once(shape):
    R, M = shape
    plan = pb.roll_plan(R, M)
    pb.check_roll_plan(plan, R, M)
    T, per = plan
    e = (np.arange(T)[:, None] + np.arange(per)[None, :] * T).reshape(-1)
    assert np.array_equal(np.sort(e[e < R * M]), np.arange(R * M))
    assert per == 1 or T * (per // 2) < R * M   # the fewest elements a thread
    # a thread's elements share a column wherever a multiple of M holds
    # the tile at 32 elements a thread
    assert (T % M == 0) == (M <= 1024 and (M, R) != (513, 56))
    rng = np.random.default_rng(R + M)
    x = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (R, M),
                                      dtype=np.int32))
    it = 3 if R * M > 4096 else 9
    assert torch.equal(_emulate_roll(x.numpy(), it, plan),
                       pb.dynamic_roll_plain(x, it))


def test_roll_plan_at_the_tools_shape_and_refusals():
    """[8, 256]: 512 threads of 4 elements, two rows a pass; a double
    buffer past one block, or an empty tile, is refused; bad plans too."""
    assert pb.roll_plan(8, 256) == (512, 4)
    assert pb.roll_plan(1, 29056) == (1024, 32)
    for R, M in [(1, 29057), (0, 4), (4, 0)]:
        with pytest.raises(ValueError):
            pb.roll_plan(R, M)
    pb.check_roll_plan((1024, 2), 8, 256)
    for bad in [(512, 2), (1024, 3), (48, 64), (2048, 1), (16, 32),
                (0, 32)]:
        with pytest.raises(ValueError):
            pb.check_roll_plan(bad, 8, 256)


# ------------------------------------------- the dynamic slices' plan

def _slice_emulate(tab, idx, plan, lane: bool):
    """P4c (``lane``) or P4d by the index math of csrc/probes.cu
    slice_range and slice_finish: CTA ranges, warp chunks, the warps' sums
    per CTA, the CTAs' partials summed.  Returns (out, the iterations each
    warp of each CTA ran)."""
    ctas, T = plan
    warps = T // 32
    idx = idx.reshape(-1).astype(np.int64)
    iters = idx.size
    if lane:
        row = tab.reshape(-1).astype(np.int64)
        take = lambda s: row[min(max(s, 0), row.size - 128):][:128]
        W = 128
    else:
        t2 = tab.astype(np.int64)
        take = lambda s: t2[min(max(s, 0), t2.shape[0] - 2):][:2].reshape(-1)
        W = 256
    share = -(-iters // ctas)
    parts, ran = np.zeros((ctas, W), np.int64), []
    for c in range(ctas):
        lo = min(iters, c * share)
        hi = min(iters, lo + share)
        chunk = min(32, max(1, -(-share // warps)))
        for w in range(warps):
            mine = []
            for base in range(lo + w * chunk, hi, warps * chunk):
                mine += range(base, min(base + chunk, hi))
            ran.append(mine)
            for n in mine:
                parts[c] += take(int(idx[n]))
    out = parts.sum(0)
    out = ((out + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    return out.reshape((1, 128) if lane else (2, 128)), ran


def test_slice_plan_at_the_tools_shape():
    """200 iterations (the tool's): one CTA; 4096: 32; 100000: a CTA an
    SM; 512 threads a CTA at every count.  A card of 7 SMs takes 7 CTAs
    from 896 up."""
    assert pb.slice_plan(200, 132) == (1, 512)
    assert pb.slice_plan(100000, 132) == (132, 512)
    assert pb.slice_plan(4096, 132) == (32, 512)
    for it in (0, 1, 17, 255):
        assert pb.slice_plan(it, 132)[0] == 1
    assert pb.slice_plan(256, 132) == (2, 512)
    assert pb.slice_plan(100000, 7) == (7, 512)
    assert pb.slice_plan(895, 7) == (6, 512)


@pytest.mark.parametrize("iters", [0, 1, 31, 200, 100000])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_slice_plan_runs_every_iteration_once(iters, sms):
    """Every iteration falls in exactly one CTA's range and one warp's
    chunks, in order within a chunk, on the chooser's plan."""
    plan = pb.slice_plan(iters, sms)
    pb.check_slice_plan(plan)
    ctas, T = plan
    assert ctas <= sms
    idx = np.zeros(iters, np.int32)
    _, ran = _slice_emulate(np.zeros((4, 128), np.int32), idx, plan, False)
    flat = np.concatenate([np.asarray(r, np.int64) for r in ran])
    assert np.array_equal(np.sort(flat), np.arange(iters))


@pytest.mark.parametrize("plan", [None, (1, 32), (3, 64), (7, 512),
                                  (132, 512), (300, 32), (9, 128)])
@pytest.mark.parametrize("lane", [True, False])
def test_slice_index_math_matches_plain(plan, lane):
    """The kernels' cut and reduce, emulated, equal the plain versions at
    200 iterations with starts before 0 and past the last (clamped) and
    int32 wrap: the chooser's plan, one warp, CTAs with no iterations."""
    rng = np.random.default_rng(17)
    NW, NR = 8190, 512
    tab = rng.integers(-(1 << 31), 1 << 31, (1, NW) if lane else (NR, 128),
                       dtype=np.int64).astype(np.int32)
    hi = NW - 128 if lane else NR - 2
    idx = rng.integers(-3, hi + 4, (1, 200)).astype(np.int32)
    idx[0, :4] = [0, hi, hi + 1, -(1 << 31)]
    plan = plan or pb.slice_plan(200, 132)
    got, _ = _slice_emulate(tab, idx, plan, lane)
    plain = pb.lane_slice_plain if lane else pb.sublane_slice_plain
    assert torch.equal(torch.from_numpy(got),
                       plain(torch.from_numpy(tab), torch.from_numpy(idx)))


def test_slice_refusals_match_the_kernels():
    """The C entries' refusals, raised as ValueError before any launch:
    1 to 1024 CTAs of whole warps up to 512 threads; P4c rows of 128 to
    SMEM_OPTIN / 4 words; P4d tables of at least 2 rows."""
    for good in [(1, 32), (1024, 512), (132, 96)]:
        pb.check_slice_plan(good)
    for bad in [(0, 32), (1025, 32), (1, 0), (1, 16), (1, 48), (1, 544),
                (1, 1024)]:
        with pytest.raises(ValueError):
            pb.check_slice_plan(bad)
    for NW in (128, 8190, pb.SMEM_OPTIN // 4):
        pb.check_lane_slice(NW)
    for NW in (127, pb.SMEM_OPTIN // 4 + 1):
        with pytest.raises(ValueError):
            pb.check_lane_slice(NW)
    before = (pb.lane_slice.launches, pb.sublane_slice.launches)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    with pytest.raises(ValueError):
        pb._lane_slice(i32(1, 127), i32(1, 4), (1, 32))
    with pytest.raises(ValueError):
        pb._lane_slice(i32(1, 256), i32(1, 4), (1, 48))
    with pytest.raises(ValueError):
        pb._sublane_slice(i32(1, 128), i32(1, 4), (1, 32))
    with pytest.raises(ValueError):
        pb._sublane_slice(i32(4, 128), i32(1, 4), (2000, 32))
    assert (pb.lane_slice.launches, pb.sublane_slice.launches) == before


# ------------------------------------ the refill's and one gather's plans

def _refill_emulate(tab, bases, plan):
    """P4e by the index math of csrc/probes.cu refill_kernel: row r on
    global warp r, r + W, ... of W = ctas * warps, each lane words lane +
    32k of the row from the clamped base.  Returns (out, the rows each
    warp ran)."""
    ctas, warps = plan
    row = tab.reshape(-1).astype(np.int64)
    b = bases.reshape(-1).astype(np.int64)
    WR, W = b.size, ctas * warps
    out = np.full((WR, 128), 7777, np.int64)   # a word no warp writes shows
    ran = []
    for gw in range(W):
        mine = list(range(gw, WR, W))
        ran.append(mine)
        for r in mine:
            src = min(max(int(b[r]), 0), row.size - 128)
            for lane in range(32):
                for k in range(4):
                    out[r, lane + 32 * k] = row[src + lane + 32 * k]
    return out.astype(np.int32), ran


@pytest.mark.parametrize("WR", [1, 7, 32, 33, 132, 1000, 5000])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_refill_plan_owns_every_row_once(WR, sms):
    """Every row falls to exactly one warp on the chooser's plan, which
    passes the launcher's check and stays within the card's SMs."""
    plan = pb.refill_plan(WR, sms)
    pb.check_refill_plan(plan)
    ctas, warps = plan
    assert ctas <= sms and warps <= pb.REFILL_MAX_WARPS
    W = ctas * warps
    owner = np.zeros(WR, np.int64)
    for gw in range(W):
        owner[gw::W] += 1
    assert (owner == 1).all()
    if WR <= 32 * sms:    # one row a warp where the warps allow
        assert W >= WR


def test_refill_plan_at_the_tools_shape():
    """The tool's 32 rows: a warp a CTA on 32 SMs of an H100; a card of 7
    SMs takes 7 CTAs of 5 warps."""
    assert pb.refill_plan(32, 132) == (32, 1)
    assert pb.refill_plan(32, 7) == (7, 5)
    assert pb.refill_plan(1, 132) == (1, 1)
    assert pb.refill_plan(100000, 132) == (132, 32)


@pytest.mark.parametrize("plan", [None, (1, 1), (1, 32), (3, 5), (7, 1),
                                  (32, 1), (50, 2)])
@pytest.mark.parametrize("WR,NW", [(32, 8192), (37, 8192), (5, 128),
                                   (64, 8193)])
def test_refill_index_math_matches_plain(WR, NW, plan):
    """The kernel's rows-to-warps cut and its clamp, emulated, equal the
    plain version: bases below 0 and past NW - 128 (clamped), INT_MIN
    and INT_MAX, a row count no CTA's warps divide, more warps than rows,
    a table of exactly one row's words."""
    rng = np.random.default_rng(WR + NW)
    tab = rng.integers(-(1 << 31), 1 << 31, (1, NW),
                       dtype=np.int64).astype(np.int32)
    bases = rng.integers(-5, NW - 128 + 6, (WR, 1)).astype(np.int32)
    edges = [0, NW - 128, NW - 127, -1, (1 << 31) - 1, -(1 << 31)]
    bases[:min(WR, 6), 0] = edges[:min(WR, 6)]
    plan = plan or pb.refill_plan(WR, 132)
    got, _ = _refill_emulate(tab, bases, plan)
    assert torch.equal(torch.from_numpy(got),
                       pb.refill_plain(_t(tab), _t(bases)))


def _once_shapes():
    """(Rt, Mt, Ri, Mi, axis) of every one-shot gather the tools run (P3's
    six forms as 2-D, P6a and P6b's [4, 64, 128] as [256, 128]), then
    rows whose width no unit of 4 divides, one element, and a tail."""
    shapes = []
    for c in mb.pallas2_cases() + mb.multi_probe_cases()[:2]:
        x, xt = mb.inputs(c, 0, 1, "cpu")
        ax = int(c.label[-1]) if c.pid == "P3" else 2
        t2, i2, a2 = pb._as_2d(*xt, ax)
        shapes.append((*t2.shape, *i2.shape, a2))
    assert len(shapes) == 8
    return shapes + [(8, 2050, 8, 2050, 1), (7, 5, 7, 3, 1),
                     (9, 13, 2, 13, 0), (1, 1, 1, 1, 1),
                     (33, 100, 33, 100, 1)]


def _once_emulate(tab, idx, axis, chain, lim, plan, vec):
    """One gather by the index math of csrc/probes.cu gather_once_kernel:
    units of 4 outputs (``vec``) or one, a grid-stride loop over ctas *
    threads, row and column by one division, indices clamped into the
    table, ``chain`` taking floor_mod(v, lim).  Returns (out, how often
    each output was written)."""
    ctas, threads = plan
    Ri, Mi = idx.shape
    t = tab.astype(np.int64)
    flat = idx.reshape(-1).astype(np.int64)
    V = 4 if vec else 1
    units, step = Ri * Mi // V, ctas * threads
    hi = (t.shape[1] if axis == 1 else t.shape[0]) - 1
    out = np.zeros(Ri * Mi, np.int64)
    hits = np.zeros(Ri * Mi, np.int64)
    for g in range(min(step, units)):
        for u in range(g, units, step):
            e = V * u
            r, c = e // Mi, e - (e // Mi) * Mi
            for k in range(V):
                j = min(max(int(flat[e + k]), 0), hi)
                v = int(t[r, j] if axis == 1 else t[j, c + k])
                out[e + k] = v % lim if chain else v  # floor_mod for lim > 0
                hits[e + k] += 1
    return out.reshape(Ri, Mi).astype(np.int32), hits


@pytest.mark.parametrize("shape", _once_shapes())
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_once_plan_owns_every_element_once(shape, sms):
    """Every output falls to exactly one thread on the chooser's plan (a
    CTA an SM, the fewest warps that give each unit a thread), by units
    of 4 where Mi % 4 == 0 and by one (the kernel's path for idx or out
    off 16 bytes) on the same plan."""
    Rt, Mt, Ri, Mi, axis = shape
    plan = pb.once_plan(Ri, Mi, sms)
    pb.check_once_plan(plan)
    units = Ri * Mi // 4 if Mi % 4 == 0 else Ri * Mi
    assert plan[0] == max(sms, -(-units // pb.MAX_THREADS))
    assert plan[0] * plan[1] >= units > plan[0] * (plan[1] - 32)
    z = np.zeros((Rt, Mt), np.int32)
    for vec in ([True, False] if Mi % 4 == 0 else [False]):
        _, hits = _once_emulate(z, np.zeros((Ri, Mi), np.int32), axis,
                                False, 1, plan, vec)
        assert (hits == 1).all(), vec


def test_once_plan_at_the_tools_shapes():
    """An H100 (132 SMs): every SM a CTA, of the fewest warps that give
    each unit a thread: one warp up to 4,224 units (16,384 outputs in
    units of 4), two for P6's 8,192; a row of 2050 words by single
    outputs, 4 warps; past 1024 units an SM, CTAs of 1024 beyond the
    SMs; a card of 7 SMs and of one."""
    assert pb.once_plan(8, 2048, 132) == (132, 32)
    assert pb.once_plan(8, 512, 132) == (132, 32)
    assert pb.once_plan(32, 512, 132) == (132, 32)
    assert pb.once_plan(256, 128, 132) == (132, 64)
    assert pb.once_plan(8, 2050, 132) == (132, 128)
    assert pb.once_plan(1, 1, 132) == (132, 32)
    assert pb.once_plan(1000, 1000, 132) == (245, 1024)
    assert pb.once_plan(8, 2048, 7) == (7, 608)
    assert pb.once_plan(8, 2048, 1) == (4, 1024)
    assert pb.once_plan(1 << 15, 1 << 16, 132) == (pb.ONCE_MAX_CTAS, 1024)


@pytest.mark.parametrize("plan", [None, (1, 32), (3, 64), (5, 1024),
                                  (200, 32)])
@pytest.mark.parametrize("shape", _once_shapes())
def test_once_index_math_matches_plain(shape, plan):
    """One gather's units, loop and clamp, emulated, equal the plain
    versions on every form: take_along (P3, P6a, P6b), and P2's chain at
    one iteration (floor_mod by the axis' length, of negative table words
    too), with indices before 0 and past the axis clamped as the kernel
    clamps them (the plain versions raise on those: they run on the
    clamped indices); forced plans that loop, and the one-output path
    where units of 4 fit."""
    Rt, Mt, Ri, Mi, axis = shape
    rng = np.random.default_rng(Rt * Mt + Ri)
    n_ax = Mt if axis == 1 else Rt
    tab = rng.integers(-(1 << 31), 1 << 31, (Rt, Mt),
                       dtype=np.int64).astype(np.int32)
    idx = rng.integers(-3, n_ax + 3, (Ri, Mi)).astype(np.int32)
    idx.reshape(-1)[:4] = [0, n_ax - 1, n_ax, -(1 << 31)][:idx.size]
    clamped = _t(np.clip(idx, 0, n_ax - 1))
    plan = plan or pb.once_plan(Ri, Mi, 132)
    for vec in ([True, False] if Mi % 4 == 0 else [False]):
        got, _ = _once_emulate(tab, idx, axis, False, 1, plan, vec)
        assert torch.equal(torch.from_numpy(got),
                           pb.take_along_plain(_t(tab), clamped, axis))
        got, _ = _once_emulate(tab, idx, axis, True, n_ax, plan, vec)
        assert torch.equal(torch.from_numpy(got),
                           pb.gather_chain_plain(_t(tab), clamped, axis, 1))


def test_once_emulation_on_the_tools_own_forms():
    """The six P3 forms and P6a, P6b on the tools' seed-0 inputs, through
    the emulated kernel on the chooser's plan, equal the probes' plain
    versions in their own shapes (3-D forms folded as the wrappers fold
    them)."""
    for c in mb.pallas2_cases() + mb.multi_probe_cases()[:2]:
        x, xt = mb.inputs(c, 0, 1, "cpu")
        ax = int(c.label[-1]) if c.pid == "P3" else 2
        t2, i2, a2 = pb._as_2d(*xt, ax)
        plan = pb.once_plan(*i2.shape, 132)
        got, _ = _once_emulate(t2.numpy(), i2.numpy(), a2, False, 1, plan,
                               i2.shape[1] % 4 == 0)
        want = c.call(c.plain, "cpu", list(xt), 1)
        assert np.array_equal(got.reshape(want.shape), want.numpy()), c.label


def test_refill_and_once_refusals_match_the_kernels():
    """The C entries' refusals, raised as ValueError before any launch:
    the refill at NW < 128, WR < 1 and plans past 1..65535 CTAs of 1..32
    warps; one gather at shapes that do not agree off the axis, empty
    ones, lim < 1, 2^31 elements or more, and plans past 1..65535 CTAs of
    whole warps up to 1024 threads.  No launch is counted."""
    for good in [(1, 1), (65535, 32), (132, 7)]:
        pb.check_refill_plan(good)
    for bad in [(0, 1), (65536, 1), (1, 0), (1, 33)]:
        with pytest.raises(ValueError):
            pb.check_refill_plan(bad)
    pb.check_refill(128, 1)
    for NW, WR in [(127, 1), (8192, 0)]:
        with pytest.raises(ValueError):
            pb.check_refill(NW, WR)
    for good in [(1, 32), (65535, 1024), (129, 96)]:
        pb.check_once_plan(good)
    for bad in [(0, 32), (65536, 32), (1, 0), (1, 16), (1, 48), (1, 1056)]:
        with pytest.raises(ValueError):
            pb.check_once_plan(bad)
    pb.check_gather_shape(8, 2048, 8, 512, 1, 1, True)
    pb.check_gather_shape(64, 512, 8, 512, 0, 64, True)
    pb.check_gather_shape(1 << 16, 1 << 15, 1 << 16, (1 << 15) - 1, 1, 1,
                          True)
    for bad in [(8, 2048, 7, 2048, 1), (64, 512, 8, 511, 0),
                (8, 0, 8, 0, 1), (8, 8, 8, 8, 2)]:
        with pytest.raises(ValueError):
            pb.check_gather_shape(*bad, 1, True)
    with pytest.raises(ValueError):
        pb.check_gather_shape(8, 8, 8, 8, 1, 0, True)
    with pytest.raises(ValueError):
        pb.check_gather_shape(1 << 16, 1 << 15, 1 << 16, 1 << 15, 1, 1,
                              True)
    pb.check_gather_shape(1 << 16, 1 << 15, 1 << 16, 1 << 15, 1, 1, False)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    before = (pb.refill.launches, pb.take_along.launches,
              pb.gather_chain.launches)
    with pytest.raises(ValueError):
        pb._refill(i32(1, 127), i32(4, 1), (1, 4))
    with pytest.raises(ValueError):
        pb._refill(i32(1, 8192), i32(0, 1), (1, 4))
    with pytest.raises(ValueError):
        pb._refill(i32(1, 8192), i32(4, 1), (1, 33))
    with pytest.raises(ValueError):
        pb._gather2d(pb.take_along, i32(8, 64), i32(8, 64), 1, 1, False,
                     plan=(1, 16))
    with pytest.raises(ValueError):
        pb._gather2d(pb.take_along, i32(8, 64), i32(7, 64), 1, 1, False)
    with pytest.raises(ValueError):
        pb._gather2d(pb.gather_chain, i32(8, 64), i32(8, 64), 1, 1, True,
                     0)
    assert (pb.refill.launches, pb.take_along.launches,
            pb.gather_chain.launches) == before


def test_sass_tool_finds_loop_bodies():
    """tools/sass.py on cuobjdump's layout: functions by name, opcodes
    without their guards, a loop from its label to the branch back."""
    from miniwfa_tpu_torch.tools import sass
    text = """
        Function : _Z15popcount_kernelPKiPiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x000 */
.L_x_1:
        /*0100*/                   POPC R5, R4 ;            /* 0x000 */
        /*0110*/                   IADD3 R4, R5, 0x7, RZ ;  /* 0x000 */
        /*0120*/               @P0 BRA `(.L_x_1) ;          /* 0x000 */
        /*0130*/                   EXIT ;                   /* 0x000 */
.L_x_2:
        /*0140*/                   BRA `(.L_x_2);
        Function : _Z7empty_kernelv
        /*0000*/                   EXIT ;
"""
    fns = sass.functions(text)
    assert list(fns) == ["_Z15popcount_kernelPKiPiii", "_Z7empty_kernelv"]
    assert sass.loops(fns["_Z15popcount_kernelPKiPiii"]) == [
        ["POPC", "IADD3", "BRA"], ["BRA"]]
    assert sass.opcode("@!P1 LDG.E.128.CONSTANT R4, desc[UR4][R2.64]") \
        == "LDG.E.128.CONSTANT"
    by_address = """
        /*0080*/                   POPC R5, R4 ;
        /*0090*/                   IADD3 R4, R5, 0x7, RZ ;
        /*00a0*/               @P0 BRA 0x80 ;
        /*00b0*/                   BRA 0xc0 ;
        /*00c0*/                   EXIT ;
"""
    assert sass.loops(by_address.splitlines()) == [["POPC", "IADD3", "BRA"]]
