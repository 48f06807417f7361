"""Every cell, configuration, traffic mix and metric of BENCHMARK.json is
a file of its own, found by name, and the file keeps the contract's
shape."""

import json
import os
import re

import pytest

from _tiny import ROOT
from wfabench import harness

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_read_by_name(cell):
    bench, w, cfg, traffic = harness.load_cell(cell)
    assert w["name"] == cell
    assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
    assert traffic["entry"] == "align_batch"
    assert traffic["mode"] in ("score", "cigar", "lowmem")
    for key in ("target_bp", "sub_rate", "indel_rate", "indel_len",
                "penalties", "ref_s_cap"):
        assert key in cfg
    reports = [m["name"] for m in bench["end_to_end"]
               if harness.applies(m, cell)]
    assert "setup_s" in reports and len(reports) >= 2
    assert any(harness.applies(m, cell) for m in bench["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_is_read_by_name(metric):
    assert callable(harness.reader(metric))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("wfabench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        # every cell the metric is read in reports the metric it moves
        for c in m.get("workloads", cells):
            assert harness.applies(moved, c), (m["name"], c)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
