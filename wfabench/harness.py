"""One run of one cell of BENCHMARK.json.

A cell names a configuration (``configs/<name>.json``: the pairs' shape,
the penalties, the reference's cycle budget) and a traffic mix
(``traffic/<name>.json``: the mode, pairs per call, the entry point);
per-layer metrics are readers ``metrics/<name>.py`` with a function
``read(rec)`` that returns a number or None.  Nothing here names a cell.

A run: the pool of pairs from the seed (``gen.py``); one warm-up call;
a closed loop of calls of the pool, each synchronised with the card(s)
before its timer stops, until ``seconds`` have passed; with ``trace``,
then a stretch of calls under ``torch.profiler`` (a schedule with one
warm-up step); the check that no module of JAX or of the JAX package
was loaded; the program's state freed; then the plain reference
(``reference/wfa.py``) over the pool, and every call's answers compared
with it.  The last stdout line is the result; the last stderr lines
are the numbers compared, each beside its limit.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch

from . import gen, program, trace
from .reference import wfa

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names a run may not hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "miniwfa_tpu")
STRETCH_S = 2.0         # the traced stretch: at least this long, 3 calls
GIB = float(1 << 30)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str):
    """(benchmark, cell, configuration, traffic) of the cell ``name``."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    return bench, cell, cfg, traffic


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "wfabench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def digest(r) -> int:
    """One answer as a number: its score, cell count and CIGAR."""
    cig = None if r.cigar is None else tuple(r.cigar)
    return hash((int(r.s), int(r.n_iter), cig))


# every number compared is a count of answers unlike the reference's:
# the comparison is exact, so each limit is 0
LIMITS = {"lanes_missing": 0, "lanes_s_wrong": 0, "lanes_n_iter_wrong": 0,
          "lanes_cigar_wrong": 0, "calls_unlike_reference": 0}


def compare(first, digests: List[List[int]], answers, n: int) -> dict:
    """The numbers compared: lanes missing from any call; the first
    call's lanes against the reference's answers one by one (score,
    cell count, CIGAR); and calls whose answers (as digests) differ from
    the reference's anywhere."""
    ref_d = [digest(a) for a in answers]
    got = [first[i] if i < len(first) else None for i in range(n)]

    def wrong(field):
        return sum(r is None or getattr(r, field) != getattr(a, field)
                   for r, a in zip(got, answers))
    return {
        "lanes_missing": max((n - len(dg) for dg in digests), default=n),
        "lanes_s_wrong": wrong("s"),
        "lanes_n_iter_wrong": wrong("n_iter"),
        "lanes_cigar_wrong": wrong("cigar"),
        "calls_unlike_reference": sum(
            [dg[i] if i < len(dg) else None for i in range(n)] != ref_d
            for dg in digests),
    }


def reference(pairs, cfg: dict, traffic: dict, device, pens=None):
    """The plain reference's answers for ``pairs`` on ``device``
    (``pens``: the configuration's penalties unless given)."""
    mode = traffic["mode"]
    step = int(traffic.get("step", 0)) if mode == "lowmem" else 0
    pens = pens or wfa.Pens(**cfg["penalties"])
    return wfa.align(pairs, pens, mode != "score", step, device,
                     s_cap=int(cfg["ref_s_cap"]))


def _sync(devices: Sequence[torch.device]) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _device_info(devices, peak: int) -> dict:
    cuda = devices[0].type == "cuda"
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(devices[0]) if cuda
            else "cpu", "count": len(devices), "memory_peak_bytes": peak}


def _stretch(prof, devices) -> dict:
    """Calls, device events and host operations of the traced stretch."""
    from torch.autograd import DeviceType
    calls, dev_ev, host = [], [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.name == "wfabench.call":
            # the call's range on the host; on the device it is a user
            # annotation, no work of the card
            if e.device_type != DeviceType.CUDA:
                calls.append((a, b))
        elif e.device_type == DeviceType.CUDA:
            dev_ev.append({"name": e.name, "dev": e.device_index,
                           "start": a, "end": b})
        elif not e.name.startswith("ProfilerStep"):
            host.append({"name": e.name, "start": a, "end": b})
    calls.sort()
    lo = calls[0][0] if calls else 0.0
    hi = calls[-1][1] if calls else 0.0
    cards = [d.index for d in devices if d.type == "cuda"]
    return {"calls": calls, "events": dev_ev, "host": host, "lo": lo,
            "hi": hi, "cards": cards}


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             devices: Sequence[str], t0: float, out=None, err=None,
             wrap: Optional[Callable] = None,
             cfg_override: Optional[dict] = None,
             traffic_override: Optional[dict] = None,
             marks: Optional[dict] = None) -> int:
    """One run; prints the result line.  ``t0`` is the process's start;
    ``marks`` the set-up's earlier moments (name -> perf_counter).
    ``wrap`` (tests) replaces the entry point by ``wrap(entry)``;
    ``cfg_override`` and ``traffic_override`` (tests) replace keys of the
    configuration and the traffic.  Returns the exit code."""
    out = out or sys.stdout
    err = err or sys.stderr
    bench, cell, cfg, traffic = load_cell(name)
    cfg = {**cfg, **(cfg_override or {})}
    traffic = {**traffic, **(traffic_override or {})}
    devs = [torch.device(d) for d in devices]
    n = int(traffic["pairs_per_call"])
    pairs = gen.make_pool(cfg, n, seed)
    bases = sum(len(t) for t, _ in pairs)
    t_pool = time.perf_counter()
    fn = program.entry(cfg, traffic, devices)
    if wrap is not None:
        fn = wrap(fn)
    t_entry = time.perf_counter()

    fn(pairs)                                   # warm-up: the cell's shapes
    _sync(devs)
    for d in devs:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    l0 = program.launches()
    walls: List[float] = []
    digests: List[List[int]] = []
    first = None
    failed = 0
    start = time.perf_counter()
    setup_s = start - t0
    end = start
    while True:
        a = time.perf_counter()
        try:
            res = fn(pairs)
            _sync(devs)
        except Exception:  # noqa: BLE001 -- a failed call is reported
            traceback.print_exc(file=err)
            failed += n
            break
        end = time.perf_counter()
        walls.append(end - a)
        digests.append([digest(r) for r in res])
        if first is None:
            first = res
        if end - start >= seconds:
            break
    window_s = end - start
    peak = max((torch.cuda.max_memory_allocated(d) for d in devs
                if d.type == "cuda"), default=0)
    l1 = program.launches()

    stretch = None
    if traced and walls and not failed:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function, schedule)
        acts = [ProfilerActivity.CPU]
        if devs[0].type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        n_act = max(3, math.ceil(STRETCH_S / statistics.median(walls)))
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=n_act, repeat=1)) as prof:
            for _ in range(1 + n_act):
                with record_function("wfabench.call"):
                    res = fn(pairs)
                    _sync(devs)
                digests.append([digest(r) for r in res])
                prof.step()
        stretch = _stretch(prof, devs)

    bad = forbidden_modules()
    if bad:
        print(f"wfabench: the run loaded {bad}", file=err)
        return 3
    fn = res = None
    for d in devs:
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()

    # the plain reference over the pool, after the window
    r0 = time.perf_counter()
    answers = reference(pairs, cfg, traffic, devs[0])
    reference_s = time.perf_counter() - r0
    mode = traffic["mode"]
    step = int(traffic.get("step", 0)) if mode == "lowmem" else 0

    checks = compare(first or [], digests, answers, n)
    correct = bool(walls) and not failed and all(
        checks[k] <= LIMITS[k] for k in checks)
    limits = LIMITS

    metrics = {}
    extra = {}
    if not traced:
        vals = {"bp_per_s": ("bp/s", len(walls) * bases / window_s
                             if window_s > 0 else None),
                "call_p90_s": ("s", statistics.quantiles(walls, n=10)[8]
                               if len(walls) >= 2 else None),
                "peak_mem_gib": ("GiB", peak / GIB),
                "setup_s": ("s", setup_s)}
        # a metric named <quantity>.<part> is that quantity, split by cells
        for m in bench["end_to_end"]:
            v = vals.get(m["name"].split(".")[0], (0, None))[1]
            if applies(m, name) and v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    elif stretch is not None:
        rec = {"mode": mode, "step": step, "cards": len(devs),
               "calls": len(walls),
               "launches": {k: l1[k] - l0[k] for k in l0},
               "stretch": stretch,
               "tl": [len(t) for t, _ in pairs],
               "ql": [len(q) for _, q in pairs],
               "ref": {"s": [a.s for a in answers],
                       "n_iter": [a.n_iter for a in answers],
                       "n_iter_p1": None if step == 0
                       else [a.n_iter_p1 for a in answers]}}
        for m in bench["per_layer"]:
            if applies(m, name):
                v = reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        span = stretch["hi"] - stretch["lo"]
        extra["traced_bp_per_s"] = len(stretch["calls"]) * bases \
            / (span / 1e6) if span > 0 else None

    device = _device_info(devs, peak)
    line = {"correct": correct, "attempted": n * (len(walls) + (failed > 0)),
            "failed": failed, "metrics": metrics, "device": device}
    if stretch is not None:
        span = stretch["hi"] - stretch["lo"]
        busy = trace.busy_by_card(stretch["events"], stretch["lo"],
                                  stretch["hi"])
        cards = stretch["cards"]
        device["busy_s"] = (sum(busy.get(c, 0.0) for c in cards)
                            / len(cards) / 1e6) if cards else 0.0
        device["window_s"] = span / 1e6
        line["breakdown"] = {
            "device_ops": trace.top_ops(stretch["events"]),
            "idle_gaps": trace.idle_gaps(
                stretch["events"], stretch["host"], stretch["lo"],
                stretch["hi"], dev=cards[0] if len(cards) == 1 else None)}
    line["notes"] = {"cell": name, "seed": seed, "calls": len(walls),
                     "window_s": window_s, "setup_s": setup_s,
                     "setup_marks_s": {k: v - t0 for k, v in {
                         **(marks or {}), "pool": t_pool,
                         "program_import": t_entry,
                         "warmup": start}.items()},
                     "reference_s": reference_s,
                     "call_median_s": statistics.median(walls)
                     if walls else None,
                     "call_first_s": walls[0] if walls else None,
                     "call_max_s": max(walls, default=None), **extra}
    line["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                      for k in checks}
    for k in checks:
        print(f"check {k} {checks[k]} limit {limits[k]}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0


def main(argv: Sequence[str], t0: float, t_import: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell of "
                                 "BENCHMARK.json once on the card(s).")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, cell, _, _ = load_cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available():
        print("wfabench: no CUDA device (torch.cuda.is_available() is "
              "false); the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"wfabench: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    return run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace), [f"cuda:{i}" for i in range(chips)],
                    t0, marks={"imports": t_import,
                               "cuda_checks": time.perf_counter()})
