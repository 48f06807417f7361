"""The low-mem cells (``mhc1m-lowmem``, ``pairs100k-lowmem``) on the CPU
at tiny sizes: the wide engine's pass 1 against the reference through
``align_batch``; both cells end to end, traced (each traced call opens
``mwf.checkpoints`` once, after pass 1's dispatch); the control not
correct on mhc1m's shape; and the new readers on a made-up record."""

import io
import json
import time

import pytest
import torch

import _tiny_lowmem  # noqa: F401  (the tiny sizes of the low-mem cells)
from _tiny import CFG, SEED, TRAFFIC, devices
from wfabench import control, gen, harness, roofline

torch.set_num_threads(1)
CELLS = ("mhc1m-lowmem", "pairs100k-lowmem")


def test_wide_pass1_matches_the_reference(monkeypatch):
    # a pair of mhc1m's shape at 4 kb: with K1's pass-1 window cut to 256
    # diagonals, pass 1 takes the wide engine's plain version over the
    # largest band the pair can reach, its snapshot rows grown between
    # calls; pass 2 is K1's
    from miniwfa_tpu_torch import Options
    from miniwfa_tpu_torch.models import exact
    from miniwfa_tpu_torch.ops import wavefront_wide as ww
    from wfabench.reference import wfa
    monkeypatch.setattr(exact, "WIDE_PASS1_W_MIN", 256)
    runs = []
    real = ww.run_chunked

    def spy(spec, *a, **k):
        out, snap, fin = real(spec, *a, **k)
        runs.append((spec.mode, spec.W, spec.n_snap, fin.n_snap))
        return out, snap, fin
    monkeypatch.setattr(ww, "run_chunked", spy)
    _, _, cfg, _ = harness.load_cell("mhc1m-lowmem")
    pairs = gen.make_pool({**cfg, "target_bp": 4000}, 1, SEED)
    got = exact.align_batch(pairs, Options(cigar=True, step=64),
                            device="cpu")
    want = wfa.align(pairs, wfa.Pens(), True, 64, "cpu", s_cap=512)
    assert [(r.s, r.n_iter, r.cigar) for r in got] == \
        [(a.s, a.n_iter, a.cigar) for a in want]
    (mode, W, rows0, rows) = runs[0]
    assert len(runs) == 1 and mode == exact.MODE_PASS1 and W == 16384
    assert rows0 == exact.WIDE_SNAP_ROWS0 and rows > rows0
    assert want[0].s // 64 >= 3     # pass 2 collapses at three or more


@pytest.mark.parametrize("cell", CELLS)
def test_traced_lowmem_call_opens_checkpoints_once(cell, monkeypatch):
    # the untraced run of every cell at its tiny size is
    # test_wfabench_run.py::test_cell_runs_end_to_end
    monkeypatch.setattr(harness, "STRETCH_S", 0.0)
    got = []
    real = harness._stretch

    def keep(prof, devs):
        st = real(prof, devs)
        got.append(st)
        return st
    monkeypatch.setattr(harness, "_stretch", keep)
    # the CPU profiler records every operation of the plain versions:
    # up to two pairs of 600 bp at step 16
    _, w, _, traffic = harness.load_cell(cell)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(
        cell, SEED, 0.2, True, devices(w), time.perf_counter(), out=out,
        err=err, cfg_override={**CFG[w["config"]], "target_bp": 600},
        traffic_override={**TRAFFIC[w["traffic"]], "step": 16,
                          "pairs_per_call": min(2, traffic["pairs_per_call"])})
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert all(v == {"value": 0, "limit": 0}
               for v in line["checks"].values())
    (st,) = got
    for a, b in st["calls"]:
        inside = sorted((h["start"], h["end"], h["name"]) for h in st["host"]
                        if h["name"].startswith("mwf.")
                        and a <= h["start"] and h["end"] <= b)
        # pass 1 (one dispatch at these sizes), then pass 2, flat
        assert [n for _, _, n in inside] == [
            "mwf.size", "mwf.pack", "mwf.dispatch", "mwf.checkpoints",
            "mwf.size", "mwf.pack", "mwf.dispatch", "mwf.cigars"]
        for (_, end, _), (start, _, _) in zip(inside, inside[1:]):
            assert start >= end


def test_control_is_not_correct_on_the_mhc_shape():
    _, w, _, _ = harness.load_cell("mhc1m-lowmem")
    got = control.run("mhc1m-lowmem", SEED, ["cpu"], CFG[w["config"]],
                      TRAFFIC[w["traffic"]])
    assert got["correct"] is False
    assert got["checks"]["lanes_n_iter_wrong"]["value"] == 1


# -- the readers on a made-up record -------------------------------------

MS = 1000.0


def ev(name, a, b):
    return {"name": name, "dev": 0, "start": a * MS, "end": b * MS}


def rec(events, hosts=(), mode="lowmem"):
    """Two calls of 100 ms over one pair of 1000 bp: pass 1 of 2e6
    cells, pass 2 of 1e5, s 60 at step 16."""
    return {"mode": mode, "step": 16, "cards": 1, "calls": 2,
            "launches": {}, "stretch": {
                "calls": [(0.0, 100 * MS), (100 * MS, 200 * MS)],
                "events": list(events), "host": list(hosts), "lo": 0.0,
                "hi": 200 * MS, "cards": [0]},
            "tl": [1000], "ql": [1000],
            "ref": {"s": [60], "n_iter": [10 ** 5],
                    "n_iter_p1": [2 * 10 ** 6]}}


K1 = "void wavefront_kernel<2, 4, true>(Params)"
K2 = "void (anonymous namespace)::wide_tiled<960, 32>(WParams)"


def bound(mode, cells):
    return roofline.bound_s(*roofline.work(mode, [cells], [1000], [1000],
                                           [60], 16))


def test_k2_and_k1_seg_readers_by_hand():
    # mhc1m's shape: K2 ran pass 1 (30 ms a call), K1 pass 2 (5 ms)
    r = rec([ev(K2, 10, 40), ev(K1, 50, 55), ev(K2, 110, 140),
             ev(K1, 150, 155)])
    want2 = 100 * 2 * bound("pass1", 2 * 10 ** 6) / 60e-3
    want1 = 100 * 2 * bound("seg", 10 ** 5) / 10e-3
    assert harness.reader("k2_roofline.pass1")(r) == pytest.approx(want2)
    assert harness.reader("k1_roofline.seg")(r) == pytest.approx(want1)
    # both passes on K1: the lowmem share is the one that reads
    assert harness.reader("k1_roofline.lowmem")(r) is None


def test_k1_lowmem_reader_by_hand():
    # pairs100k's shape: K1 ran both passes, 20 + 5 ms a call
    r = rec([ev(K1, 10, 30), ev(K1, 50, 55), ev(K1, 110, 130),
             ev(K1, 150, 155)])
    want = 100 * 2 * (bound("pass1", 2 * 10 ** 6) + bound("seg", 10 ** 5)) \
        / 50e-3
    assert harness.reader("k1_roofline.lowmem")(r) == pytest.approx(want)
    assert harness.reader("k1_roofline.seg")(r) is None
    assert harness.reader("k2_roofline.pass1")(r) is None   # no K2 time
    # other modes, or no cards' events, read nothing
    for m in ("k1_roofline.lowmem", "k1_roofline.seg", "k2_roofline.pass1"):
        assert harness.reader(m)(rec(r["stretch"]["events"],
                                     mode="cigar")) is None
        assert harness.reader(m)(rec([])) is None


def test_checkpoints_reader_by_hand():
    # call 1: checkpoints [40, 50], the card busy [45, 60]; call 2: none
    hosts = [{"name": "mwf.checkpoints", "start": 40 * MS, "end": 50 * MS},
             {"name": "mwf.dispatch", "start": 0.0, "end": 40 * MS}]
    r = rec([ev(K1, 45, 60), ev(K1, 100, 200)], hosts)
    assert harness.reader("host_checkpoints_ms_per_call")(r) == \
        pytest.approx(5.0 / 2)
    rest = 1000 * harness.reader("host_s_per_call")(r)
    parts = [harness.reader(f"host_{s}_ms_per_call")(r) or 0.0
             for s in ("size", "pack", "dispatch", "checkpoints", "cigars",
                       "unnamed")]
    assert sum(parts) == pytest.approx(rest)
    r["stretch"]["host"] = hosts[1:]     # a program without the span
    assert harness.reader("host_checkpoints_ms_per_call")(r) is None
