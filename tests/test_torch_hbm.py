"""The port's peak device-memory meter (``miniwfa_tpu_torch/utils/hbm.py``)
on the CPU, through the plain PyTorch versions of the kernels.

Twins of tests/test_hbm_and_guards.py's meter tests, plus what the port
adds: torch tensors are counted, every kernel's dispatch notes under the
JAX package's tag with its inputs, scratch and outputs, and the peak
holds under many threads noting at once (the sharded path notes from one
thread per card).  Tolerance: exact equality of byte counts.
"""

import contextlib
import itertools
import sys
import threading

import numpy as np
import pytest
import torch

from miniwfa_tpu.utils import hbm as jax_hbm
from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.models.exact import align_batch
from miniwfa_tpu_torch.models.tiny import align_tiny_batch
from miniwfa_tpu_torch.models import tiny
from miniwfa_tpu_torch.ops import wavefront_gaps as wg
from miniwfa_tpu_torch.ops import wavefront_kernel as wk
from miniwfa_tpu_torch.ops import wavefront_multi as wm
from miniwfa_tpu_torch.parallel.batch import align_batch_sharded
from miniwfa_tpu_torch.parallel.mesh import make_mesh
from miniwfa_tpu_torch.tools.pairs import make_pairs
from miniwfa_tpu_torch.utils import hbm

torch.set_num_threads(1)   # as in test_torch_chain.py

NOTES = (("small", 10), ("big", 1000), ("mid", 500))
MODES = {"score": Options(), "cigar": Options(cigar=True),
         "lowmem_p500": Options(cigar=True, step=500)}


def _pair_2kb():
    """A 2 kb pair at 2% substitutions and 0.2% indels."""
    return make_pairs(2000, 1, seed=3)


@pytest.mark.parametrize("order", list(itertools.permutations(range(3))))
def test_meter_keeps_max(order):
    """test_hbm_and_guards.py::test_hbm_meter_keeps_max, in every order of
    the notes."""
    hbm.reset()
    assert hbm.peak() == (0, "")
    for i in order:
        hbm.note(*NOTES[i])
    assert hbm.peak() == (1000, "big")
    total = hbm.note_arrays("arrays", np.zeros(4096))
    assert total == 4096 * 8
    assert hbm.peak() == (4096 * 8, "arrays")
    hbm.reset()
    assert hbm.peak() == (0, "")


def test_note_arrays_counts_tensors_and_arrays():
    """numel * element_size for tensors, nbytes for numpy arrays; None is
    skipped."""
    hbm.reset()
    t32 = torch.zeros((4, 1024), dtype=torch.int32)
    u8 = torch.zeros((3, 5, 7), dtype=torch.uint8)
    i64 = torch.zeros(9, dtype=torch.int64)
    total = hbm.note_arrays("mix", t32, None, u8, np.zeros(100, np.int16),
                            i64)
    assert total == 4 * 1024 * 4 + 105 + 200 + 72
    assert hbm.peak() == (total, "mix")
    # a view counts its own elements
    assert hbm.note_arrays("view", t32[:1]) == 1024 * 4


def test_module_has_the_jax_meters_functions():
    public = {n for n in dir(jax_hbm) if not n.startswith("_")
              and callable(getattr(jax_hbm, n))
              and getattr(getattr(jax_hbm, n), "__module__", "")
              == jax_hbm.__name__}
    assert public == {"reset", "note", "note_arrays", "peak",
                      "device_peak", "snapshot"}
    for name in public:
        assert callable(getattr(hbm, name)), name


@pytest.mark.parametrize("mode", list(MODES))
def test_align_batch_notes(mode):
    """test_hbm_and_guards.py::test_hbm_meter_records_dispatches in each
    exact mode: a dispatch was noted, with its mode in the tag, and the
    snapshot carries the JAX meter's keys (no card: no device peak)."""
    hbm.reset()
    res = align_batch(_pair_2kb(), MODES[mode], device="cpu")
    assert res[0].s > 0
    nbytes, tag = hbm.peak()
    assert nbytes > 0 and "mode=" in tag and tag.startswith("kernel ")
    snap = hbm.snapshot()
    assert {"peak_dispatch_bytes", "peak_dispatch_gb",
            "peak_dispatch"} <= set(snap)
    assert snap["peak_dispatch_bytes"] == nbytes
    assert snap["peak_dispatch"] == tag
    if not torch.cuda.is_available():
        assert "device_peak_bytes" not in snap
        assert hbm.device_peak() is None


@pytest.mark.parametrize("mode", [wk.MODE_SCORE, wk.MODE_TB, wk.MODE_PASS1])
def test_kernel_note_counts_planes_and_outputs(mode):
    """K1's note is its inputs, its planes (global memory on the card:
    27 int32 ring planes and lastv a lane at the default penalties outside
    PASS1) and its outputs, exactly."""
    (t, q), = _pair_2kb()
    opt = Options(cigar=mode != wk.MODE_SCORE, step=500)
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, 1024, 2048,
                                              [t.encode()], [q.encode()])
    lanes, tw, qw = (torch.from_numpy(x) for x in (lanes, tw, qw))
    hbm.reset()
    out, tb, bands, snap = wk.wavefront(spec, lanes, tw, qw)
    planes = wk.plane_count(spec) * spec.W * 4
    if mode != wk.MODE_PASS1:
        assert wk.plane_count(spec) == 28
    want = sum(x.numel() * x.element_size()
               for x in (lanes, tw, qw, out, tb, bands, snap)
               if x is not None) + planes
    assert hbm.peak() == (want, f"kernel mode={mode} B=1 W=1024 "
                                f"S_CAP=2048")


def _nb(*bufs):
    return sum(x.numel() * x.element_size() for x in bufs if x is not None)


@pytest.mark.parametrize("mode", [wk.MODE_SCORE, wk.MODE_TB])
def test_multi_smem_note_has_no_planes(monkeypatch, mode):
    """K4's smem variant notes what its launch allocates: the inputs, out,
    tb and bands (TB) and the lane counter, and no planes (the rings live
    in shared memory).
    Its launch path runs here with CPU tensors and a stand-in for the
    kernel's entry point."""
    (t, q), = _pair_2kb()
    opt = Options(cigar=mode == wk.MODE_TB)
    spec, lanes, tw, qw = exact.kernel_inputs(opt, mode, 512, 1024,
                                              [t.encode()] * 3,
                                              [q.encode()] * 3)
    lanes, tw, qw = (torch.from_numpy(x) for x in (lanes, tw, qw))
    calls = []

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(wm.build, "load",
                        lambda *a: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    hbm.reset()
    out, tb, bands, snap = wm._launch_smem(spec, lanes, tw, qw, None, 2)
    assert len(calls) == 1 and snap is None
    counter = 4
    want = _nb(lanes, tw, qw, out, tb, bands) + counter
    assert hbm.peak() == (want, f"kernel mode={mode} B=3 W=512 S_CAP=1024")
    # K1's note of the same dispatch adds exactly the planes
    hbm.reset()
    wk.wavefront(spec, lanes, tw, qw)
    assert hbm.peak()[0] - want + counter == \
        wk.plane_count(spec) * spec.W * 4 * 3


def test_gaps_note_counts_the_class_plan():
    """K3 notes its inputs, the class permutation (perm int32 [G]) and its
    outputs, exactly; no rings (shared memory)."""
    pairs = [(b"ACGT" * k, b"ACGA" * k) for k in (1, 3, 7, 15)]
    opt = Options(cigar=True)
    spec, lens, tw, qw = tiny.dispatch_inputs(
        opt, [a for a, _ in pairs], [b for _, b in pairs], 16, 128)
    args = [torch.from_numpy(a) for a in (lens, tw, qw)]
    hbm.reset()
    out, tb = wg.gaps(spec, *args)
    want = _nb(*args, out, tb) + 4 * len(pairs)
    assert hbm.peak() == (want, f"gaps mode={wk.MODE_TB} G=4 S_CAP=128")


@pytest.fixture
def tags(monkeypatch):
    """Every note's tag (its first word) and bytes."""
    seen = []
    real = hbm.note

    def rec(tag, nbytes):
        seen.append((tag.split()[0], nbytes))
        real(tag, nbytes)

    monkeypatch.setattr(hbm, "note", rec)
    return seen


@pytest.mark.parametrize("route", ["k1", "k4", "k3", "k2_score",
                                   "k2_pass1"])
def test_every_engine_notes_under_its_tag(goldens, monkeypatch, tags, route):
    """K1 and K4 note ``kernel``, K3 ``gaps``, K2 ``wide-planes`` each call
    and ``wide-out`` each run (the JAX package's tags)."""
    case = next(c for c in goldens["cases"] if c["name"] == "t3")
    pair = [(case["t"], case["q"])]
    want = {"kernel"}
    if route == "k4":
        monkeypatch.setenv("MWF_ENGINE", "multi")
        pair = pair * 2
    if route == "k3":
        pair = [("ACGTACGTTGCA" * 4, "ACGTACGATGCA" * 4)]
        res = align_tiny_batch(pair, Options(cigar=True), device="cpu")
        want = {"gaps"}
    elif route.startswith("k2"):
        monkeypatch.setattr(exact, "WIDE_SCORE_W_MIN", 256)
        monkeypatch.setattr(exact, "WIDE_PASS1_W_MIN", 256)
        opt = Options() if route == "k2_score" \
            else Options(cigar=True, step=16)
        res = align_batch(pair, opt, w0=1024, device="cpu")
        want = {"wide-planes", "wide-out"}
    else:
        res = align_batch(pair, Options(cigar=True), device="cpu")
    assert res[0].s > 0
    assert want <= {t for t, _ in tags}
    assert all(n > 0 for _, n in tags)


def test_threads_keep_the_true_max():
    """8 threads noting at once, with a short switch interval, keep the
    largest note and its tag: the meter updates under one lock."""
    hbm.reset()
    rng = np.random.default_rng(5)
    values = rng.permutation(8 * 4000).reshape(8, 4000)

    def work(row):
        for v in values[row]:
            hbm.note(f"t{row} {v}", int(v))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    top = int(values.max())
    row = int(np.argwhere(values == top)[0][0])
    assert hbm.peak() == (top, f"t{row} {top}")


def test_sharded_path_notes():
    """align_batch_sharded over 4 CPU entries notes through align_batch."""
    hbm.reset()
    pairs = make_pairs(500, 4, seed=11)
    res = align_batch_sharded(pairs, Options(cigar=True),
                              make_mesh(["cpu"] * 4))
    assert all(r.s > 0 for r in res)
    nbytes, tag = hbm.peak()
    assert nbytes > 0 and tag.startswith("kernel mode=1 B=4 ")
