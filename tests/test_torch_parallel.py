"""The port's sharded path (``miniwfa_tpu_torch.parallel``) on the CPU,
i.e. through the plain PyTorch versions of its kernels.

Twins of tests/test_sharding.py on ``make_mesh(["cpu"] * 8)``: the
sharded path equals the port's ``align_batch`` (s, n_iter, CIGAR) and the
reference goldens in score, CIGAR and low-mem (``-p 16``) mode, on K1's
route and on the wide engine's.  The lane layout equals JAX's
``NamedSharding(mesh, P("data"))`` on the 8 virtual devices, and a few
cases equal JAX's ``align_batch_sharded``.  Tolerance: exact equality.
"""

import collections
import sys
import threading

import numpy as np
import pytest
import torch

from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.models.exact import align_batch
from miniwfa_tpu_torch.ops import wavefront_kernel as wk
from miniwfa_tpu_torch.ops import wavefront_wide as ww
from miniwfa_tpu_torch.parallel import batch as pb
from miniwfa_tpu_torch.parallel.batch import align_batch_sharded, lane_blocks
from miniwfa_tpu_torch.parallel.mesh import Mesh, make_mesh
from miniwfa_tpu_torch.utils.launches import count_launch

torch.set_num_threads(1)   # as in test_torch_chain.py

CPU8 = ["cpu"] * 8
RUNS = {"score": Options(), "cigar": Options(cigar=True),
        "lowmem_p16": Options(cigar=True, step=16)}


def _small(goldens, names=None):
    return [(i, c) for i, c in enumerate(goldens["cases"])
            if max(len(c["t"]), len(c["q"])) <= 256
            and (names is None or c["name"] in names)]


def _row(r):
    return r.s, r.n_iter, r.cigar_str


@pytest.mark.parametrize("ndev", [3, 8])
@pytest.mark.parametrize("n", [1, 5, 8, 13, 24])
def test_lane_blocks_match_named_sharding(n, ndev):
    import jax
    from jax.sharding import Mesh as JMesh, NamedSharding
    from jax.sharding import PartitionSpec as P
    devs = jax.devices()[:ndev]
    B = -(-n // ndev) * ndev
    arr = jax.device_put(np.zeros(B, np.int32), NamedSharding(
        JMesh(np.array(devs), ("data",)), P("data")))
    idx = {sh.device: sh.index[0] for sh in arr.addressable_shards}
    want = [range(min(idx[d].start or 0, n), min(idx[d].stop or B, n))
            for d in devs]
    assert lane_blocks(n, ndev) == want


@pytest.mark.parametrize("devices", [CPU8, ["cpu"]], ids=["8", "1"])
@pytest.mark.parametrize("run", list(RUNS))
def test_sharded_matches_single(goldens, run, devices):
    pairs = [(c["t"], c["q"]) for _, c in _small(goldens)[:24]]
    mesh = make_mesh(devices)
    sharded = align_batch_sharded(pairs, RUNS[run], mesh)
    single = align_batch(pairs, RUNS[run], device="cpu")
    assert [_row(r) for r in sharded] == [_row(r) for r in single]
    assert align_batch_sharded([], RUNS[run], mesh) == []


@pytest.mark.parametrize("run", list(RUNS))
def test_sharded_matches_goldens(goldens, run):
    cases = _small(goldens)
    res = align_batch_sharded([(c["t"], c["q"]) for _, c in cases],
                              RUNS[run], make_mesh(CPU8))
    exp = goldens["runs"][run]
    for (i, c), r in zip(cases, res):
        assert r.s == exp[i]["s"], c["name"]
        assert r.cigar_str == exp[i]["cigar"], c["name"]


def test_sharded_wide_route_matches_goldens(goldens, monkeypatch):
    """The twin of test_sharded_wide_fallback_matches_goldens: every score
    and pass-1 dispatch past a 256-diagonal window goes to the wide
    engine, on every entry of the mesh."""
    monkeypatch.setattr(exact, "WIDE_SCORE_W_MIN", 256)
    monkeypatch.setattr(exact, "WIDE_PASS1_W_MIN", 256)
    modes = []
    real = ww.wide

    def counting(spec, *a):
        modes.append(spec.mode)
        return real(spec, *a)

    monkeypatch.setattr(ww, "wide", counting)
    cases = _small(goldens, ("t3", "small7", "ins4", "identity4"))
    pairs = [(c["t"], c["q"]) for _, c in cases]
    mesh = make_mesh(CPU8)
    for run in ("score", "lowmem_p16"):
        modes.clear()
        res = align_batch_sharded(pairs, RUNS[run], mesh, w0=1024)
        assert set(modes) == {wk.MODE_SCORE if run == "score"
                              else wk.MODE_PASS1}, run
        exp = goldens["runs"][run]
        for (i, c), r in zip(cases, res):
            assert (r.s, r.cigar_str) == (exp[i]["s"], exp[i]["cigar"]), \
                (run, c["name"])


def test_sharded_matches_jax_sharded(goldens):
    """s and CIGAR against the JAX package's align_batch_sharded on the 8
    virtual devices; n_iter against the reference's counts (the JAX
    sharded path runs the lax engine on the CPU, whose n_iter differs
    from K1's past a 256-cycle shrink: ROADMAP section 3, fault 2)."""
    from miniwfa_tpu import Options as JOptions
    from miniwfa_tpu.parallel.batch import align_batch_sharded as jsharded
    from miniwfa_tpu.parallel.mesh import make_mesh as jmake_mesh
    cases = _small(goldens, ("t3", "ins4", "mixed", "homopoly", "del4"))
    pairs = [(c["t"], c["q"]) for _, c in cases]
    want = jsharded(pairs, JOptions(cigar=True), jmake_mesh())
    got = align_batch_sharded(pairs, Options(cigar=True), make_mesh(CPU8))
    assert [(r.s, r.cigar_str) for r in got] == \
        [(r.s, r.cigar_str) for r in want]
    niter = goldens["niter"]
    checked = 0
    for (_, c), r in zip(cases, got):
        if c["name"] in niter:
            assert (r.s, r.n_iter) == (niter[c["name"]]["s"],
                                       niter[c["name"]]["n_iter"])
            checked += 1
    assert checked == 2


def test_dryrun_multichip():
    from miniwfa_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8, device="cpu")


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for devices in (None, ["cuda:0"] * 4):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(devices)
    with pytest.raises(RuntimeError, match="CUDA"):
        align_batch_sharded([("ACGT", "ACGA")], Options())


def test_init_of_one_process_is_a_no_op(monkeypatch):
    from miniwfa_tpu_torch.parallel import distributed
    monkeypatch.delenv("MWF_NUM_PROCESSES", raising=False)
    distributed.init()
    assert (distributed.process_index(), distributed.process_count()) == \
        (0, 1)
    assert make_mesh(["cpu"]).entries == ((0, torch.device("cpu")),)
    with pytest.raises(ValueError, match="rank"):
        distributed.init("127.0.0.1:1", 2)


def test_one_call_per_device_one_thread_each(goldens, monkeypatch):
    """Entries on one device are merged into one align_batch call over the
    union of their blocks, each device in its own thread; a mesh with
    lanes on no process of the job raises."""
    pairs = [(c["t"], c["q"]) for _, c in _small(goldens)[:10]]
    opt = Options(cigar=True)
    a, b = torch.device("cpu", 0), torch.device("cpu", 1)
    calls = []
    real = exact.align_batch

    def recording(sub, o, device, **kw):
        calls.append((device, len(sub), threading.get_ident()))
        return real(sub, o, device="cpu", **kw)

    monkeypatch.setattr(exact, "align_batch", recording)
    res = pb._dispatch(pairs, opt, Mesh(((0, a), (0, b), (0, a))), 512, 512)
    # blocks of 4, 4 and 2 lanes: a runs lanes 0-3 and 8-9, b lanes 4-7
    assert sorted((str(d), n) for d, n, _ in calls) == [("cpu:0", 6),
                                                        ("cpu:1", 4)]
    assert len({c[2] for c in calls}) == 2
    single = real(pairs, opt, device="cpu")
    assert [_row(r) for r in res] == [_row(r) for r in single]
    with pytest.raises(RuntimeError, match="no device"):
        pb._dispatch(pairs, opt, Mesh(((0, a), (1, b))), 512, 512)


def test_launch_counts_survive_threads():
    """The kernels' launch counters take one lock (utils/launches.py):
    16 threads with a short switch interval lose no update."""
    def fn():
        pass

    fn.launches = 0
    fn.launches_by_mode = collections.Counter()
    fn.launches_by_variant = collections.Counter()

    def bump():
        for k in range(2000):
            count_launch(fn, mode=k % 3, variant=k % 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == 32000
    assert fn.launches_by_mode == {0: 10672, 1: 10672, 2: 10656}
    assert fn.launches_by_variant == {0: 16000, 1: 16000}
