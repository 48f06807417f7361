"""The port's benchmarks on the CPU: ``bench_cuda.py`` (the port of
``bench.py``) and ``miniwfa_tpu_torch/tools/scaling_bench.py`` (the port of
``tools/scaling_bench.py``), through the plain PyTorch versions of the
kernels, and their pair generators (``miniwfa_tpu_torch/tools/pairs.py``)
against the JAX side's.  Tolerance: exact equality (cell counts, scores,
sequences).
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import bench
import bench_cuda
from miniwfa_tpu import Options as JaxOptions
from miniwfa_tpu.models.exact import align_batch as jax_align_batch
from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models.exact import align_batch
from miniwfa_tpu_torch.tools import pairs as tp
from miniwfa_tpu_torch.tools import scaling_bench
from tools import scaling_bench as jax_scaling_bench

torch.set_num_threads(1)   # as in test_torch_chain.py

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"MWF_BENCH_N": "8000", "MWF_BENCH_B": "1", "MWF_BENCH_REPS": "1",
         "MWF_BENCH_BIG_N": "0"}
# bench.py's detail keys (bench.py:157-172)
DETAIL = {"pairs", "pair_bp", "reps", "batch_wall_s", "total_cells",
          "aligned_bp_per_s", "cigar_cells_per_s", "lowmem_cells_per_s",
          "score_cells_per_s_at_2x_bp", "parity", "checks", "peak_hbm"}


@pytest.fixture(scope="module")
def small_run():
    """``python bench_cuda.py --device cpu`` at 1 pair of 8 kb, once."""
    env = {**os.environ, **SMALL, "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, "bench_cuda.py", "--device", "cpu"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    return p


def test_bench_cuda_cpu_line(small_run):
    assert small_run.returncode == 0, small_run.stderr[-2000:]
    lines = small_run.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "wavefront_cells_per_s_1chip"
    assert out["unit"] == "cells/s" and out["value"] > 0
    d = out["detail"]
    assert DETAIL <= set(d)
    assert (d["pairs"], d["pair_bp"], d["reps"]) == (1, 8000, 1)
    assert d["parity"] is True
    assert d["parity_against"] == "bench_goldens.json"
    assert d["checks"] == {"score_parity": True, "cigar_parity": True,
                           "lowmem_parity": True}
    assert d["score_cells_per_s_at_2x_bp"] is None
    assert d["peak_hbm"]["peak_dispatch_bytes"] > 0
    assert "mode=" in d["peak_hbm"]["peak_dispatch"]
    assert d["device"] is None


def test_bench_cuda_cells_equal_jax(small_run):
    """total_cells is Σ n_iter, bit-exact with the JAX package's
    align_batch on bench.py's pairs."""
    d = json.loads(small_run.stdout)["detail"]
    res = jax_align_batch(bench.make_pairs(8000, 1), JaxOptions(),
                          w0=2000, s0=2000)
    assert d["total_cells"] == sum(r.n_iter for r in res) == 895070


def _goldens(n, b):
    """Goldens of make_pairs(n, b) from the port itself, scores only."""
    res = align_batch(tp.make_pairs(n, b), Options(), device="cpu")
    return {str(n): [{"s": r.s} for r in res]}


def test_run_without_parity():
    """A changed golden score turns its checks and parity false (the
    low-mem row is held against the CIGAR row, so it stays true)."""
    gold = _goldens(2000, 2)
    assert bench_cuda.run(2000, 2, 1, 0, "cpu", gold)["detail"]["parity"]
    gold["2000"][1]["s"] += 1
    d = bench_cuda.run(2000, 2, 1, 0, "cpu", gold)["detail"]
    assert d["parity"] is False
    assert d["checks"] == {"score_parity": False, "cigar_parity": False,
                           "lowmem_parity": True}


def test_main_returns_1_without_parity(monkeypatch, capsys, tmp_path):
    gold = _goldens(1000, 1)
    gold["1000"][0]["s"] += 4
    path = tmp_path / "goldens.json"
    path.write_text(json.dumps(gold))
    monkeypatch.setattr(bench_cuda, "GOLDENS", str(path))
    for k, v in {"MWF_BENCH_N": "1000", "MWF_BENCH_B": "1",
                 "MWF_BENCH_REPS": "1", "MWF_BENCH_BIG_N": "0"}.items():
        monkeypatch.setenv(k, v)
    assert bench_cuda.main(["--device", "cpu"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["detail"]["parity"] is False


@pytest.mark.parametrize("engine", [None, "multi"])
def test_run_without_goldens_holds_the_other_route(monkeypatch, engine):
    """At a length with no goldens the score row is held, pair by pair in
    s and n_iter, against the other route of K1's batches (K4 under the
    default, K1 under MWF_ENGINE=multi); the environment is restored."""
    if engine is None:
        monkeypatch.delenv("MWF_ENGINE", raising=False)
    else:
        monkeypatch.setenv("MWF_ENGINE", engine)
    d = bench_cuda.run(1000, 4, 1, 0, "cpu", {})["detail"]
    assert d["checks"] == {"score_parity": None, "route_parity": True}
    assert d["parity"] is True
    assert d["parity_against"] == ("MWF_ENGINE unset" if engine
                                   else "MWF_ENGINE=multi")
    assert d["cigar_cells_per_s"] is None and d["lowmem_cells_per_s"] is None
    assert os.environ.get("MWF_ENGINE") == engine


def test_route_mismatch_fails(monkeypatch):
    """A route whose n_iter differs from the timed route's turns
    route_parity and parity false."""
    monkeypatch.delenv("MWF_ENGINE", raising=False)
    real = bench_cuda.align_batch

    def skewed(*args, **kw):
        res = real(*args, **kw)
        if os.environ.get("MWF_ENGINE") == "multi":
            res[-1] = dataclasses.replace(res[-1], n_iter=res[-1].n_iter + 1)
        return res

    monkeypatch.setattr(bench_cuda, "align_batch", skewed)
    d = bench_cuda.run(1000, 2, 1, 0, "cpu", {})["detail"]
    assert d["checks"] == {"score_parity": None, "route_parity": False}
    assert d["parity"] is False


def test_no_card_fails(monkeypatch):
    """Without a card and without ``--device cpu`` the bench fails with
    check_device's message: it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bench_cuda.main([])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        scaling_bench.main([])


@pytest.mark.parametrize("n,b,seed", [(8000, 4, 7), (300, 9, 13)])
def test_make_pairs_equals_bench(n, b, seed):
    assert tp.make_pairs(n, b, seed) == bench.make_pairs(n, b, seed)


@pytest.mark.parametrize("args", [(4, 2000), (3, 500, 0.1, 5)])
def test_mk_pairs_equals_scaling_bench(args):
    assert tp.mk_pairs(*args) == jax_scaling_bench.mk_pairs(*args)


def test_scaling_bench_cpu(capsys):
    """One line per mesh size over the 8 CPU entries."""
    assert scaling_bench.main(["500", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "devices: 8 x cpu"
    sizes = [int(ln.split("mesh=")[1].split()[0]) for ln in lines[1:]]
    assert sizes == [1, 2, 4, 8]
    for ln, nd in zip(lines[1:], sizes):
        assert f"pairs={nd:3d}" in ln and "cells/s=" in ln \
            and "scaling_eff=" in ln
