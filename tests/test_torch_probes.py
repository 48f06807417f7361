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
