"""Each cell end to end on the CPU at a tiny size through the plain
versions: the contract's last line, ``correct`` true; with the timed path
broken underneath (an answer altered where it is produced, answers given
to the wrong lanes, half of the batch left out, one later call altered),
``correct`` false; the control (reference with one guarantee
broken) not correct; and no module of JAX or of the JAX package loaded."""

import dataclasses
import io
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from _tiny import CFG, LOWMEM, ROOT, SEED, TRAFFIC, devices
from wfabench import control, gen, harness

torch.set_num_threads(1)
CELLS = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]


def run(cell, traced=False, wrap=None, seconds=0.2, pairs=None, bp=None,
        traffic=None):
    _, w, _, _ = harness.load_cell(cell)
    out, err = io.StringIO(), io.StringIO()
    tr = {**TRAFFIC[w["traffic"]], **(traffic or {})}
    if pairs:
        tr["pairs_per_call"] = pairs
    cf = dict(CFG[w["config"]])
    if bp:
        cf["target_bp"] = bp
    rc = harness.run_cell(cell, SEED, seconds, traced, devices(w),
                          time.perf_counter(), out=out, err=err, wrap=wrap,
                          cfg_override=cf, traffic_override=tr)
    assert rc == 0, err.getvalue()
    last = out.getvalue().strip().splitlines()[-1]
    tail = err.getvalue().strip().splitlines()
    return json.loads(last), tail


@pytest.mark.parametrize("cell", [w["name"] for w in CELLS])
def test_cell_runs_end_to_end(cell):
    line, tail = run(cell)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert {"setup_s", "peak_mem_gib"} <= set(line["metrics"])
    assert any(k.startswith("bp_per_s") for k in line["metrics"])
    for k, v in line["checks"].items():
        assert v == {"value": 0, "limit": 0}
    assert tail[-len(line["checks"]):] == [
        f"check {k} 0 limit 0" for k in line["checks"]]
    assert line["device"]["count"] == len(devices(
        harness.load_cell(cell)[1]))


@pytest.fixture
def short_stretch(monkeypatch):
    # three traced calls of a small pool: the CPU profiler records every
    # operation of the plain versions
    monkeypatch.setattr(harness, "STRETCH_S", 0.0)


def test_traced_run_line(short_stretch):
    line, _ = run("pairs100k-cigar", traced=True, pairs=2, bp=300)
    assert line["correct"] is True
    assert "busy_s" in line["device"] and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "bp_per_s" not in line["metrics"]


def altered(field, lane=0, from_call=0):
    """The entry with one lane's answer altered where it is produced, in
    every call from ``from_call`` on (the warm-up is call 0)."""
    def wrap(fn):
        n = [0]

        def call(pairs):
            res = list(fn(pairs))
            n[0] += 1
            if n[0] - 1 >= from_call:
                r = res[lane]
                if field == "cigar":
                    cig = list(r.cigar)
                    cig[-1] += 16
                    res[lane] = dataclasses.replace(r, cigar=cig)
                else:
                    res[lane] = dataclasses.replace(
                        r, **{field: getattr(r, field) + 1})
            return res
        return call
    return wrap


@pytest.mark.parametrize("field,check", [
    ("s", "lanes_s_wrong"), ("n_iter", "lanes_n_iter_wrong"),
    ("cigar", "lanes_cigar_wrong")])
def test_altered_answer_is_not_correct(field, check):
    line, _ = run("pairs100k-cigar", wrap=altered(field, lane=3))
    assert line["correct"] is False
    assert line["checks"][check]["value"] == 1


def test_altered_later_call_is_not_correct(short_stretch):
    # the first window call is sound; every later one (the traced
    # stretch's, at least three) has lane 1's score altered
    line, _ = run("pairs100k-score", traced=True, pairs=2, bp=300,
                  wrap=altered("s", lane=1, from_call=2))
    assert line["correct"] is False
    assert line["checks"]["lanes_s_wrong"]["value"] == 0
    assert line["checks"]["calls_unlike_reference"]["value"] >= 3


def half_left_out(fn):
    """Aligns half of the batch and answers the rest with copies."""
    def call(pairs):
        h = len(pairs) // 2
        res = list(fn(pairs[:h]))
        return res + res[:len(pairs) - h]
    return call


def swapped(fn):
    """Gives lane 0's answer to lane 1 and lane 1's to lane 0."""
    def call(pairs):
        res = list(fn(pairs))
        res[0], res[1] = res[1], res[0]
        return res
    return call


def test_answers_to_the_wrong_lanes_are_not_correct():
    # score mode answers only s and n_iter: the pool's lanes differ in
    # their substitutions (lane_sub_step), so no two lanes answer alike
    line, _ = run("pairs100k-score", wrap=swapped)
    assert line["correct"] is False
    assert line["checks"]["lanes_s_wrong"]["value"] == 2


def test_lanes_of_a_pool_answer_differently():
    _, _, cfg, traffic = harness.load_cell("pairs100k-score")
    cfg = {**cfg, **CFG["pairs100k"]}
    pairs = gen.make_pool(cfg, 16, SEED)
    answers = harness.reference(pairs, cfg, traffic, "cpu")
    assert len({(a.s, a.n_iter) for a in answers}) == 16


def one_pair_halved(fn):
    """Aligns the first half of the one pair of the call."""
    def call(pairs):
        t, q = pairs[0]
        return fn([(t[:len(t) // 2], q[:len(q) // 2])])
    return call


# low-mem: the harness and the reference support it, though no cell of
# BENCHMARK.json runs it yet
LOWMEM_RUN = {"traffic": {**LOWMEM, "pairs_per_call": 1}, "bp": 2400}


@pytest.mark.parametrize("cell,wrap,extra", [
    ("pairs100k-score", half_left_out, {}),
    ("pairs100k-cigar", one_pair_halved, LOWMEM_RUN)],
    ids=["score", "lowmem"])
def test_half_of_the_batch_left_out_is_not_correct(cell, wrap, extra):
    line, _ = run(cell, wrap=wrap, **extra)
    assert line["correct"] is False


def test_lowmem_runs_end_to_end():
    line, _ = run("pairs100k-cigar", **LOWMEM_RUN)
    assert line["correct"] is True
    assert all(v["value"] == 0 for v in line["checks"].values())


@pytest.mark.parametrize("cell,lowmem", [("pairs100k-score", False),
                                         ("pairs100k-cigar", True)],
                         ids=["score", "lowmem"])
def test_control_is_not_correct(cell, lowmem):
    _, w, _, _ = harness.load_cell(cell)
    cfg, traffic = dict(CFG[w["config"]]), TRAFFIC[w["traffic"]]
    if lowmem:
        cfg["target_bp"], traffic = LOWMEM_RUN["bp"], LOWMEM_RUN["traffic"]
    got = control.run(cell, SEED, ["cpu"], cfg, traffic)
    assert got["correct"] is False
    assert got["checks"]["lanes_n_iter_wrong"]["value"] >= 1


def test_forbidden_modules_compared_whole(monkeypatch):
    for m in ("miniwfa_tpu_torch", "miniwfa_tpu_torch.ops", "jaxtyping",
              "flaxen"):
        monkeypatch.setitem(sys.modules, m, sys)
    assert harness.forbidden_modules() == []
    for m in ("jax", "jaxlib.xla_client", "flax", "miniwfa_tpu.ops"):
        monkeypatch.setitem(sys.modules, m, sys)
    assert harness.forbidden_modules() == [
        "flax", "jax", "jaxlib.xla_client", "miniwfa_tpu.ops"]


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, io; sys.path.insert(0, 'wfabench/tests');"
        "import torch; torch.set_num_threads(1);"
        "from _tiny import CFG, SEED; from wfabench import harness;"
        "rc = harness.run_cell('pairs100k-score', SEED, 0.1, False, ['cpu'],"
        " time.perf_counter(), out=io.StringIO(), err=io.StringIO(),"
        " cfg_override=CFG['pairs100k']);"
        "print(rc, sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'miniwfa_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.stdout.strip().splitlines()[-1] == "0 []", out.stderr


def test_no_card_exits_without_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run([sys.executable, "wfabench/run.py", "--workload",
                          "pairs100k-score", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
