"""The host spans of ``utils/spans.py`` on the CPU: each span is a host
operation ``mwf.<name>`` on the profiler's timeline, with or without a
``Spans``; ``align_batch`` opens its stages (size, pack, dispatch,
checkpoints, cigars) flat and in the order a call runs them, in every
mode, and the benchmark's stage readers split a call's rest by them to
the last digit; and the chain driver's ``Spans.totals`` fill as they did
before the ranges."""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.models.chain import align_chain_batch
from miniwfa_tpu_torch.utils import spans as sp

torch.set_num_threads(1)


def _pairs(n=2, bp=300, seed=7):
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        t = torch.randint(0, 4, (bp,), generator=g)
        q = t.clone()
        pos = torch.randint(0, bp, (bp // 40,), generator=g)
        q[pos] = (q[pos] + 1) % 4
        out.append((bytes(b"ACGT"[i] for i in t.tolist()),
                    bytes(b"ACGT"[i] for i in q.tolist())))
    return out


def _ranges(prof):
    """(name, start, end) of every ``mwf.`` event, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(sp.PREFIX)),
                  key=lambda r: r[1])


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("with_spans", [False, True],
                         ids=["profiler_only", "both_sinks"])
def test_span_is_a_host_operation(with_spans):
    spans = sp.Spans() if with_spans else None

    def run():
        with sp.span(spans, "stage"):
            torch.ones(8).sum()
    _, prof = _traced(run)
    ev = [e for e in prof.events() if e.name == "mwf.stage"]
    assert len(ev) == 1
    # a host operation, not a user annotation: the profiler mirrors only
    # user annotations onto the card's timeline
    assert ev[0].device_type == DeviceType.CPU
    assert not ev[0].is_user_annotation
    assert ev[0].time_range.end > ev[0].time_range.start
    if with_spans:
        assert list(spans.totals) == ["stage"] and spans.totals["stage"] > 0


def test_spans_totals_add_up_without_a_profiler():
    spans = sp.Spans()
    for _ in range(3):
        with sp.span(spans, "a"):
            pass
    with sp.span(spans, "b"):
        with sp.span(None, "inner"):
            pass
    assert sorted(spans.totals) == ["a", "b"]
    assert all(v >= 0 for v in spans.totals.values())


def test_span_closes_on_an_exception():
    spans = sp.Spans()

    def run():
        with pytest.raises(ValueError):
            with sp.span(spans, "failing"):
                raise ValueError("stage failed")
    _, prof = _traced(run)
    assert [r[0] for r in _ranges(prof)] == ["mwf.failing"]
    assert "failing" in spans.totals


@pytest.mark.parametrize("opt,stages", [
    (Options(), ["size", "pack", "dispatch"]),
    (Options(cigar=True), ["size", "pack", "dispatch", "cigars"]),
    # low-mem: pass 1's sizing, packing, dispatch and checkpoints, then
    # pass 2's
    (Options(cigar=True, step=40),
     ["size", "pack", "dispatch", "checkpoints", "size", "pack", "dispatch",
      "cigars"]),
], ids=["score", "cigar", "lowmem"])
def test_align_batch_stages_in_order(opt, stages):
    res, prof = _traced(lambda: exact.align_batch(_pairs(), opt,
                                                  device="cpu"))
    assert all(r.s > 0 for r in res)
    got = _ranges(prof)
    assert [n for n, _, _ in got] == [sp.PREFIX + s for s in stages]
    # flat: no stage opens before the last one closed
    for (_, _, end), (_, start, _) in zip(got, got[1:]):
        assert start >= end


def test_align_batch_escalation_repeats_its_stages():
    # a window too narrow for the pairs: the ladder re-runs the batch, and
    # each rung packs and dispatches again under the same names
    _, prof = _traced(lambda: exact.align_batch(
        _pairs(bp=200), Options(cigar=True), w0=16, s0=16, device="cpu"))
    names = [n for n, _, _ in _ranges(prof)]
    assert names[0] == "mwf.size"
    assert names.count("mwf.pack") == names.count("mwf.dispatch") \
        == names.count("mwf.cigars") >= 2
    assert set(names) == {"mwf.size", "mwf.pack", "mwf.dispatch",
                          "mwf.cigars"}


def _split(prof):
    """The benchmark's stage readers on the profiled call, the card taken
    as idle throughout (one empty device event): (the call's rest in ms,
    {stage: ms})."""
    from wfabench import stages
    ev = [(e.time_range.start, e.time_range.end) for e in prof.events()]
    a, b = min(x for x, _ in ev), max(y for _, y in ev)
    rec = {"stretch": {
        "calls": [(a, b)], "lo": a, "hi": b, "cards": [0],
        "events": [{"name": "none", "dev": 0, "start": a, "end": a}],
        "host": [{"name": e.name, "start": e.time_range.start,
                  "end": e.time_range.end} for e in prof.events()]}}
    names = {n[len(sp.PREFIX):] for n, _, _ in _ranges(prof)}
    return (b - a) / 1e3, {n: stages.ms_per_call(rec, n)
                           for n in [*names, None]}


def test_lowmem_checkpoints_once_a_pass1_dispatch():
    # a window and cycle budget too small for the pairs: pass 1 re-runs
    # on the ladder, and each of its dispatches decodes its checkpoints
    # (the overflowed lanes' none) under one flat span
    pairs = _pairs(bp=400)
    opt = Options(cigar=True, step=16)
    res, prof = _traced(lambda: exact.align_batch(pairs, opt, w0=16, s0=16,
                                                  device="cpu"))
    ref = exact.align_batch(pairs, opt, device="cpu")
    assert [(r.s, r.n_iter, r.cigar) for r in res] == \
        [(r.s, r.n_iter, r.cigar) for r in ref]
    got = _ranges(prof)
    names = [n[len(sp.PREFIX):] for n, _, _ in got]
    p2 = names.index("size", 1)          # pass 2's sizing
    assert names[0] == "size" and p2 > 4
    assert names[1:p2] == ["pack", "dispatch", "checkpoints"] * (
        (p2 - 1) // 3)
    assert "checkpoints" not in names[p2:]
    for (_, _, end), (_, start, _) in zip(got, got[1:]):
        assert start >= end
    # the stages and the unnamed rest add up to the call's rest
    rest, parts = _split(prof)
    assert all(v >= 0 for v in parts.values())
    assert parts["checkpoints"] > 0
    assert sum(parts.values()) == pytest.approx(rest)


def test_align_batch_wide_route_dispatches_under_its_span(monkeypatch):
    # the wide engine's run opens the same stages as K1's
    monkeypatch.setattr(exact, "WIDE_SCORE_W_MIN", 256)
    res, prof = _traced(lambda: exact.align_batch(
        _pairs(n=1, bp=400), Options(), w0=512, device="cpu"))
    ref = exact.align_batch(_pairs(n=1, bp=400), Options(), device="cpu")
    assert [(r.s, r.n_iter) for r in res] == [(r.s, r.n_iter) for r in ref]
    assert [n for n, _, _ in _ranges(prof)] == [
        "mwf.size", "mwf.pack", "mwf.dispatch"]


def test_chain_driver_totals_fill_as_before(goldens):
    # t3 and a 2 kb case: gaps for K3 and W1, and one for K1's fills
    sel = [0, 71]
    cases = [goldens["cases"][i] for i in sel]
    spans = sp.Spans()
    res = align_chain_batch([(c["t"], c["q"]) for c in cases],
                            Options(cigar=True), device="cpu", spans=spans)
    want = [goldens["runs"]["chain"][i] for i in sel]
    assert [(r.s, r.cigar_str) for r in res] == [(w["s"], w["cigar"])
                                                 for w in want]
    # the driver's stages alone: align_batch's inside the gap fills reach
    # the profiler's timeline, not the totals
    assert sorted(spans.totals) == ["K1 gap fills", "K3", "W1", "assembly",
                                    "gap packing", "plan"]
    assert all(v >= 0 for v in spans.totals.values())
    assert spans.totals["K1 gap fills"] > 0
