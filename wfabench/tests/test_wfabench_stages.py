"""The host rest split by the program's stage spans: the five readers on a
synthetic traced stretch with known host ranges and device events (the
stages and the unnamed rest add up to ``host_s_per_call``), a stretch
without spans (the readers give nothing), and a traced tiny run of each
cell on the CPU, whose stretch holds the stages its mode runs."""

import io
import json
import time

import pytest
import torch

from _tiny import CFG, SEED, TRAFFIC, devices
from wfabench import harness, stages

torch.set_num_threads(1)
STAGES = ("size", "pack", "dispatch", "cigars")
MS = 1000.0      # the profiler's microseconds in a millisecond


def host(name, a, b):
    return {"name": name, "start": a * MS, "end": b * MS}


def dev(a, b, card=0):
    return {"name": "wavefront_kernel", "dev": card, "start": a * MS,
            "end": b * MS}


def rec_of(calls, events, hosts):
    return {"mode": "cigar", "calls": len(calls), "stretch": {
        "calls": [(a * MS, b * MS) for a, b in calls], "events": events,
        "host": hosts, "lo": calls[0][0] * MS, "hi": calls[-1][1] * MS,
        "cards": [0]}}


def synthetic():
    """Two calls of 100 ms.  Call 1: the card busy at [40, 60] and [90,
    100]; size [0, 10], pack [10, 50] (half of it under the card's work),
    dispatch [50, 55] (all of it under the card's), cigars [60, 80], and
    [80, 90] in no span.  Call 2, at [200, 300]: the card busy at [200,
    250], no span at all, so its 50 ms of rest are unnamed.  Host
    operations of torch and ranges outside the calls are left out."""
    calls = [(0, 100), (200, 300)]
    events = [dev(40, 60), dev(90, 100), dev(200, 250)]
    hosts = [host("mwf.size", 0, 10), host("mwf.pack", 10, 50),
             host("aten::copy_", 12, 48), host("mwf.dispatch", 50, 55),
             host("mwf.cigars", 60, 80), host("mwf.pack", 150, 170),
             host("cudaLaunchKernel", 52, 53)]
    return rec_of(calls, events, hosts)


# per call: size 10 + 0, pack 30 + 0, dispatch 0 + 0, cigars 20 + 0,
# unnamed 10 + 50 (ms), over two calls
WANT = {"host_size_ms_per_call": 5.0, "host_pack_ms_per_call": 15.0,
        "host_dispatch_ms_per_call": 0.0, "host_cigars_ms_per_call": 10.0,
        "host_unnamed_ms_per_call": 30.0}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_stage_reader_on_a_synthetic_stretch(metric):
    assert harness.reader(metric)(synthetic()) == pytest.approx(WANT[metric])


def test_stages_and_unnamed_add_up_to_the_host_rest():
    rec = synthetic()
    rest = harness.reader("host_s_per_call")(rec)
    assert rest == pytest.approx(0.060)
    assert sum(harness.reader(m)(rec) for m in WANT) == \
        pytest.approx(1000 * rest)


def test_ranges_are_clipped_to_the_call_and_merged():
    # a pack range that starts before the call and one that repeats inside
    # it: only the call's idle time in their union counts
    rec = rec_of([(100, 200)], [dev(150, 200)],
                 [host("mwf.pack", 50, 130), host("mwf.pack", 120, 140),
                  host("mwf.size", 140, 170)])
    assert stages.ms_per_call(rec, "pack") == pytest.approx(40.0)
    assert stages.ms_per_call(rec, "size") == pytest.approx(10.0)
    assert stages.ms_per_call(rec, None) == pytest.approx(0.0)
    assert 1000 * harness.reader("host_s_per_call")(rec) == \
        pytest.approx(50.0)


def test_a_stretch_without_spans_reads_nothing():
    # the program before its spans: every reader gives None, none raises
    rec = synthetic()
    rec["stretch"]["host"] = [h for h in rec["stretch"]["host"]
                              if not h["name"].startswith("mwf.")]
    assert all(harness.reader(m)(rec) is None for m in WANT)
    # a score call opens no cigars span
    rec = synthetic()
    rec["stretch"]["host"] = [h for h in rec["stretch"]["host"]
                              if h["name"] != "mwf.cigars"]
    assert harness.reader("host_cigars_ms_per_call")(rec) is None
    assert harness.reader("host_unnamed_ms_per_call")(rec) == \
        pytest.approx(40.0)


def test_no_card_events_read_nothing():
    rec = synthetic()
    rec["stretch"]["events"] = []
    assert all(harness.reader(m)(rec) is None for m in WANT)


@pytest.fixture
def captured(monkeypatch):
    """A short traced stretch, its ``_stretch`` record kept."""
    monkeypatch.setattr(harness, "STRETCH_S", 0.0)
    got = []
    real = harness._stretch

    def keep(prof, devs):
        st = real(prof, devs)
        got.append(st)
        return st
    monkeypatch.setattr(harness, "_stretch", keep)
    return got


@pytest.mark.parametrize("cell,want", [
    ("pairs100k-cigar", {"size", "pack", "dispatch", "cigars"}),
    ("pairs100k-score", {"size", "pack", "dispatch"})],
    ids=["cigar", "score"])
def test_traced_run_holds_the_stages(captured, cell, want):
    _, w, _, _ = harness.load_cell(cell)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(
        cell, SEED, 0.2, True, devices(w), time.perf_counter(), out=out,
        err=err, cfg_override={**CFG[w["config"]], "target_bp": 300},
        traffic_override={**TRAFFIC[w["traffic"]], "pairs_per_call": 2})
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    (st,) = captured
    names = {h["name"] for h in st["host"] if h["name"].startswith("mwf.")}
    assert names == {"mwf." + s for s in want}
    # every traced call opens each of its stages once, flat
    for a, b in st["calls"]:
        inside = sorted((h["start"], h["end"], h["name"]) for h in st["host"]
                        if h["name"].startswith("mwf.")
                        and a <= h["start"] and h["end"] <= b)
        assert [n for _, _, n in inside] == [
            "mwf." + s for s in STAGES if s in want]
        for (_, end, _), (start, _, _) in zip(inside, inside[1:]):
            assert start >= end
