"""Hopper microbenchmarks of the TPU primitive probes (group P).

    python -m miniwfa_tpu_torch.tools.microbench FILE [--device cpu]
        [--iters N] [--json PATH]

FILE is one of the JAX probe files under tools/ (``mosaic``, ``mosaic2``,
``pallas2``, ``mosaic3``, ``chunk``, ``multi_probe``, ``multi_probe2``,
``multi_probe3``) or ``all``; each runs that file's own list of shapes
(its ``main`` / ``__main__``) through ``ops/probes.py`` and
``ops/probes_multi.py``.

On the card (the default) it prints the card's name and power limit, then
for every case: the kernel held equal to its plain version at
CHECK_ITERS loop iterations (16; P5 CHECK_CYCLES, 128 cycles), and the
kernel's time per op (per cycle for the chunk sweep, per row for the row
write) from CUDA events around the one launch that runs the whole loop
(``probes.KernelTimer``: the kernel alone, not the host's launch cost;
the median of 3 calls), at the tool's loop count and at half of it (the
ratio, and the marginal time per op between the two, show that the loop
was not hoisted), beside the time of one PyTorch call that computes one
op where there is one (``torch.gather``, ``torch.where``).  ``--device
cpu`` runs the plain versions only, at ``--iters`` (default 3), and
prints a digest of each output.

Inputs are made with numpy from seed 0 at the tools' shapes and value
ranges.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ops import probes as pb
from ..ops import probes_multi as pm

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
CHECK_ITERS, CHECK_CYCLES = 16, 128
REPS = 3   # a kernel's or library call's ms is the median of REPS calls
# the pallas_call site of each probe body (PERF.md §6)
SITES = {
    "P1a": "tools/microbench_mosaic.py:43", "P1b": "tools/microbench_mosaic.py:68",
    "P1c": "tools/microbench_mosaic.py:93", "P1d": "tools/microbench_mosaic.py:118",
    "P1e": "tools/microbench_mosaic.py:148", "P1f": "tools/microbench_mosaic.py:184",
    "P2": "tools/microbench_mosaic2.py:27", "P3": "tools/microbench_pallas2.py:22",
    **{p: "tools/microbench_mosaic3.py:25"
       for p in ("P4a", "P4b", "P4c", "P4d", "P4e")},
    "P5": "tools/microbench_chunk.py:111",
    "P6a": "tools/microbench_multi_probe.py:35",
    "P6b": "tools/microbench_multi_probe.py:49",
    "P6c": "tools/microbench_multi_probe.py:66",
    "P6d": "tools/microbench_multi_probe.py:87",
    "P6e": "tools/microbench_multi_probe.py:103",
    "P6f": "tools/microbench_multi_probe.py:118",
    "P6g": "tools/microbench_multi_probe.py:132",
    **{f"P7{k}": f"tools/microbench_multi_probe2.py:{ln}"
       for k, ln in zip("abcdef", (34, 47, 64, 78, 96, 110))},
    **{f"P8{k}": f"tools/microbench_multi_probe3.py:{ln}"
       for k, ln in zip("abcde", (43, 68, 93, 110, 132))}}


@dataclass
class Case:
    """One probe at one shape: ``make(rng, iters)`` builds its numpy
    inputs; ``call(fn, dev, tensors, iters)`` runs wrapper or plain ``fn``
    on them as tensors on ``dev``; ``ops(inputs, iters)`` counts its int32
    operations; ``library(tensors)`` computes one op with one PyTorch call
    (or is None)."""

    pid: str
    fn: Callable
    plain: Callable
    label: str
    make: Callable
    call: Callable
    iters: int = 1              # the tool's loop count (1: no loop)
    unit: str = "op"
    ops: Callable = lambda inputs, iters: 0
    library: Optional[Callable] = None


def inputs(c: Case, seed: int, iters: int, dev) -> tuple:
    """(numpy inputs, the same as tensors on ``dev``) of one case."""
    x = c.make(np.random.default_rng(seed), iters)
    return x, tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                    .to(dev) for a in x)


def _ints(rng, shape, hi, lo=0):
    return rng.integers(lo, hi, shape, dtype=np.int32)


# ------------------------------------------------------------- mosaic

def _gather_case(pid, fn, plain, R, M, axis, iters, label,
                 pass_axis=False):
    """A gather probe on tab [R, M] in [0, 2**20) and idx [R, M] in range
    along ``axis``; ``pass_axis``: the probe takes the axis (P2)."""
    def make(rng, it):
        return (_ints(rng, (R, M), 1 << 20),
                _ints(rng, (R, M), M if axis == 1 else R))

    def call(f, dev, x, it):
        extra = (axis,) if pass_axis else ()
        return f(x[0], x[1], *extra, it)

    return Case(pid, fn, plain, label, make, call, iters,
                ops=lambda x, it: 3 * x[1].size * it,
                library=lambda x: torch.gather(x[0], axis, x[1]))


def mosaic_cases() -> List[Case]:
    """tools/microbench_mosaic.py main(): ITERS = 1000."""
    it = 1000
    cases = [_gather_case("P1a", pb.bench_gather, pb.bench_gather_plain, R,
                          M, 1, it, f"gather ax1 [{R},{M}]")
             for R, M in [(8, 512), (8, 2048), (8, 8192), (8, 16384),
                          (32, 2048), (128, 1024)]]
    cases += [_gather_case("P1b", pb.bench_gather_ax0,
                           pb.bench_gather_ax0_plain, R, M, 0, it,
                           f"gather ax0 [{R},{M}]")
              for R, M in [(8, 2048), (64, 2048), (512, 128)]]
    for R, M in [(8, 2048), (128, 1024)]:
        cases.append(Case(
            "P1c", pb.bench_varshift, pb.bench_varshift_plain,
            f"varshift [{R},{M}]",
            lambda rng, _, R=R, M=M: (_ints(rng, (R, M), 1 << 20),
                                      _ints(rng, (R, M), 31)),
            lambda f, dev, x, it: f(x[0], x[1], it), it,
            ops=lambda x, it: 2 * x[0].size * it))
    for R, M in [(8, 2048), (128, 1024)]:
        cases.append(Case(
            "P1d", pb.bench_popcount, pb.bench_popcount_plain,
            f"popcount [{R},{M}]",
            lambda rng, _, R=R, M=M: (_ints(rng, (R, M), 1 << 20),),
            lambda f, dev, x, it: f(x[0], it), it,
            ops=lambda x, it: 2 * x[0].size * it))
    for sync in (False, True):
        cases.append(Case(
            "P1f", pb.bench_while_scalar, pb.bench_while_scalar_plain,
            f"while+smem [8,2048]{' +barrier' if sync else ''}",
            lambda rng, _: (np.zeros((8, 2048), np.int32),),
            lambda f, dev, x, it, sync=sync: f(x[0], it, sync),
            it, unit="iter", ops=lambda x, it: x[0].size * it))
    cases.append(Case(
        "P1e", pb.bench_hbm_row_write, pb.bench_hbm_row_write_plain,
        "hbm row wr [1024,2048]",
        lambda rng, _: (np.zeros((1, 2048), np.int32),),
        lambda f, dev, x, it: f(x[0], 1024, it), it, unit="row",
        ops=lambda x, it: 2 * x[0].size * it))
    return cases


def mosaic2_cases() -> List[Case]:
    """tools/microbench_mosaic2.py __main__: [8, 2048] on axis 1 and 0,
    ITERS = 200."""
    return [_gather_case("P2", pb.gather_chain, pb.gather_chain_plain, 8,
                         2048, ax, 200, f"gather ax{ax} [8,2048] loop",
                         pass_axis=True) for ax in (1, 0)]


def pallas2_cases() -> List[Case]:
    """tools/microbench_pallas2.py main(): six take_along_axis forms."""
    forms = [((8, 2048), (8, 2048), 1), ((8, 2048), (8, 512), 1),
             ((8, 512), (8, 2048), 1), ((64, 512), (8, 512), 0),
             ((8, 512), (8, 512), 0), ((8, 4, 512), (8, 4, 512), 2)]
    cases = []
    for st, si, ax in forms:
        cases.append(Case(
            "P3", pb.take_along, pb.take_along_plain,
            f"take_along {list(st)}<-{list(si)} ax{ax}",
            lambda rng, _, st=st, si=si, ax=ax: (
                _ints(rng, st, 1 << 20), _ints(rng, si, st[ax])),
            lambda f, dev, x, it, ax=ax: f(x[0], x[1], ax),
            ops=lambda x, it: 3 * x[1].size,
            library=lambda x, ax=ax: torch.gather(
                x[0], ax, x[1])))
    return cases


def mosaic3_cases() -> List[Case]:
    """tools/microbench_mosaic3.py main(): ITERS = 200; the refill loops
    over its WR = 32 rows."""
    it = 200
    cases = [_gather_case("P4a", pb.ax1_gather_loop, pb.ax1_gather_loop_plain,
                          WR, 128, 1, it, f"ax1 gather [{WR},128] loop")
             for WR in (32, 128)]
    cases.append(Case(
        "P4b", pb.dynamic_roll, pb.dynamic_roll_plain,
        "dynamic roll lanes [8,256]",
        lambda rng, _: (_ints(rng, (8, 256), 1 << 20),),
        lambda f, dev, x, it: f(x[0], it), it,
        ops=lambda x, it: 3 * x[0].size * it))
    cases.append(Case(
        "P4c", pb.lane_slice, pb.lane_slice_plain,
        "dyn lane slice [1,8192]->128",
        lambda rng, n: (_ints(rng, (1, 8192), 1 << 20),
                        _ints(rng, (1, n), 8192 - 128)),
        lambda f, dev, x, it: f(x[0], x[1]), it,
        ops=lambda x, it: 128 * it))
    cases.append(Case(
        "P4d", pb.sublane_slice, pb.sublane_slice_plain,
        "dyn sublane slice [512,128]->2 rows",
        lambda rng, n: (_ints(rng, (512, 128), 1 << 20),
                        _ints(rng, (1, n), 512 - 2)),
        lambda f, dev, x, it: f(x[0], x[1]), it,
        ops=lambda x, it: 256 * it))
    cases.append(Case(
        "P4e", pb.refill, pb.refill_plain, "refill 32 rows via smem scalars",
        lambda rng, _: (_ints(rng, (1, 8192), 1 << 20),
                        _ints(rng, (32, 1), 8192 - 128)),
        lambda f, dev, x, it: f(x[0], x[1]), 32,
        unit="row", ops=lambda x, it: 128 * 32))
    return cases


def chunk_rows(WR, CR, T, NR, chunked) -> int:
    """Rows the sweep processes over T cycles (clamped chunks included)."""
    if not chunked:
        return WR * T
    base = -(-NR // CR)
    return CR * (base * T + T // 2)


def chunk_cases() -> List[Case]:
    """tools/microbench_chunk.py __main__: T = 20000, WR = 184, the full
    sweep, then CR in (8, 16, 32) x NR in (16, 48, 80, 184)."""
    WR, T = 184, 20000
    specs = [(0, WR, False)] + [(CR, NR, True) for CR in (8, 16, 32)
                                for NR in (16, 48, 80, 184)]
    return [Case(
        "P5", pb.chunk, pb.chunk_plain,
        f"WR={WR} CR={CR} NR={NR} chunked={int(ch)}",
        lambda rng, _: (),
        (lambda f, dev, x, it, CR=CR, NR=NR, ch=ch:
         f(WR, CR, it, NR, ch, device=dev)), T, unit="cycle",
        ops=lambda x, it, CR=CR, NR=NR, ch=ch:
        24 * 128 * chunk_rows(WR, CR, it, NR, ch))
        for CR, NR, ch in specs]


# -------------------------------------------------------------- multi

G, R, L = 4, 64, 128


def _multi_case(pid, fn, plain, label, extra=None, ops=1, library=None):
    """A multi probe on the tools' x [4, 64, 128] in [0, 100) (with the
    gather index, the bound plane or the scalars of its file)."""
    def make(rng, _):
        x = _ints(rng, (G, R, L), 100)
        if extra == "idx":
            return (x, _ints(rng, (G, R, L), L))
        if extra == "b":
            return (x, _ints(rng, (8, L), 50))
        if extra == "s":
            return (x, _ints(rng, (G,), 9))
        return (x,)

    def call(f, dev, x, it):
        if extra == "s":
            return f(x[1], x[0])
        return f(*x)

    return Case(pid, fn, plain, label, make, call,
                ops=lambda x, it: ops * x[0].size, library=library)


def _while_ops(x, it) -> int:
    """P8c's operations: 3 per element per round of its while loop."""
    xs = x[0].reshape(G, -1).astype(np.int64)
    acc, t = np.zeros(G, np.int64), 0
    while t < 16 and not (acc > 300).all():
        acc += ((xs + t) % 7 == 0).sum(1)
        t += 1
    return 3 * x[0].size * t


def multi_probe_cases() -> List[Case]:
    """tools/microbench_multi_probe.py __main__: seven probes."""
    gat = lambda x: torch.gather(x[0], 2, x[1])
    return [
        _multi_case("P6a", pm.gather3, pm.gather3_plain, "gather3", "idx", 3,
                    gat),
        _multi_case("P6b", pm.gather_flat, pm.gather_flat_plain,
                    "gather_flat", "idx", 3, gat),
        _multi_case("P6c", pm.lane_mask, pm.lane_mask_plain, "lane_mask",
                    ops=4),
        _multi_case("P6d", pm.shift3, pm.shift3_plain, "shift3"),
        _multi_case("P6e", pm.ring4, pm.ring4_plain, "ring4", ops=6),
        _multi_case("P6f", pm.bnd, pm.bnd_plain, "bnd", "b", 2,
                    lambda x: torch.where(
                        x[0] >= x[1][:G, :1].reshape(G, 1, 1), x[0], -3)),
        _multi_case("P6g", pm.sub, pm.sub_plain, "sub")]


def multi_probe2_cases() -> List[Case]:
    """tools/microbench_multi_probe2.py __main__: f_a .. f_f."""
    return [
        _multi_case("P7a", pm.multi2_f_a, pm.multi2_f_a_plain,
                    "A keepdims-red", ops=3),
        _multi_case("P7b", pm.multi2_f_b, pm.multi2_f_b_plain,
                    "B smem-extract"),
        _multi_case("P7c", pm.multi2_f_c, pm.multi2_f_c_plain,
                    "C two-step-red", ops=3),
        _multi_case("P7d", pm.multi2_f_d, pm.ring4_plain, "D ring4-read",
                    ops=6),
        _multi_case("P7e", pm.multi2_f_e, pm.multi2_f_e_plain,
                    "E ring4-write", ops=6),
        _multi_case("P7f", pm.multi2_f_f, pm.multi2_f_f_plain, "F any3d",
                    ops=3)]


def multi_probe3_cases() -> List[Case]:
    """tools/microbench_multi_probe3.py __main__: f_a .. f_e."""
    cases = [
        _multi_case("P8a", pm.multi3_f_a, pm.multi3_f_a_plain,
                    "A scalar-extract"),
        _multi_case("P8b", pm.multi3_f_b, pm.multi3_f_b_plain,
                    "B per-g-stack", ops=2),
        _multi_case("P8c", pm.multi3_f_c, pm.multi3_f_c_plain,
                    "C while-G11"),
        _multi_case("P8d", pm.multi3_f_d, pm.multi3_f_d_plain,
                    "D build-G11", "s"),
        _multi_case("P8e", pm.multi3_f_e, pm.multi3_f_e_plain,
                    "E bnd-registry", ops=2)]
    cases[2].ops = _while_ops
    return cases


FILES = {"mosaic": mosaic_cases, "mosaic2": mosaic2_cases,
         "pallas2": pallas2_cases, "mosaic3": mosaic3_cases,
         "chunk": chunk_cases, "multi_probe": multi_probe_cases,
         "multi_probe2": multi_probe2_cases,
         "multi_probe3": multi_probe3_cases}


def all_cases() -> List[Case]:
    return [c for name in FILES for c in FILES[name]()]


def wrappers() -> List[Callable]:
    """Every probe wrapper once (32 kernel bodies)."""
    seen = []
    for c in all_cases():
        if c.fn not in seen:
            seen.append(c.fn)
    return seen


# ------------------------------------------------------------ measuring

def _leaves(out) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def max_abs_err(a, b) -> int:
    """Largest absolute difference over every output (1 << 62 on a shape
    or count mismatch)."""
    a, b = _leaves(a), _leaves(b)
    if len(a) != len(b):
        return 1 << 62
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            return 1 << 62
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def nbytes(inputs, out) -> int:
    """Bytes the function must move: each input read and each output
    written once."""
    return (sum(int(a.nbytes) for a in inputs)
            + sum(t.numel() * t.element_size() for t in _leaves(out)))


def bound(nb: int, ops: int):
    """(bound_ms, bound_by): bytes over 3.35 TB/s against int32 operations
    over 132 SMs x 64 lanes x 1.98 GHz."""
    b_ms = nb / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def cuda_ms(fn, reps: int = 1) -> tuple:
    """(result, ms): the median over ``reps`` calls, CUDA events around
    each, a spin kernel queued before the start event so that the host's
    first launch cost is not timed (later host work between launches
    is)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(pb.SPIN_CYCLES)
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return res, statistics.median(times)


def looped(c: Case) -> bool:
    """Whether the case's loop count is free (P4e's is its row count)."""
    return c.iters > 1 and c.pid != "P4e"


def kernel_ms(fn) -> tuple:
    """(result, ms) of a wrapper call: the median over REPS calls of the
    probe kernel's own time (``probes.KernelTimer``), without the
    wrapper's allocations."""
    times = []
    for _ in range(REPS):
        with pb.KernelTimer() as t:
            res = fn()
        times.append(t.ms())
    return res, statistics.median(times)


def check_iters(c: Case) -> int:
    """The equality check's loop count: CHECK_ITERS (CHECK_CYCLES for the
    chunk sweep), at most the tool's; a case whose count is not free
    keeps its own."""
    if not looped(c):
        return c.iters
    return min(c.iters, CHECK_CYCLES if c.unit == "cycle" else CHECK_ITERS)


def measure(c: Case, dev, iters: Optional[int] = None,
            check: bool = True) -> dict:
    """One case on the card: the kernel against its plain version at
    ``check_iters`` (when ``check``), then the kernel's ms at ``iters``
    (default the tool's) and at half of it, the plain version's ms at the
    check count and one library op's ms.  Loop counts tied to the shape
    (P4e's rows, the single-shot probes) stay as they are."""
    free = looped(c)
    it = (iters or c.iters) if free else c.iters
    rec = {"pid": c.pid, "label": c.label, "iters": it, "unit": c.unit}
    if check:
        ci = min(it, check_iters(c))
        _, xt = inputs(c, 0, ci, dev)
        c.call(c.fn, dev, xt, ci)                 # warm (and build)
        got, check_ms = kernel_ms(lambda: c.call(c.fn, dev, xt, ci))
        want, plain_ms = cuda_ms(lambda: c.call(c.plain, dev, xt, ci))
        rec.update(check_iters=ci, max_abs_err=max_abs_err(got, want),
                   plain_ms=plain_ms, check_kernel_ms=check_ms)
    x, xt = inputs(c, 0, it, dev)
    c.call(c.fn, dev, xt, it)                     # warm (and build)
    out, ms = kernel_ms(lambda: c.call(c.fn, dev, xt, it))
    rec.update(ms=ms, per_op_us=ms * 1e3 / it)
    if free:
        h = max(it // 2, 1)
        _, xh = inputs(c, 0, h, dev)
        c.call(c.fn, dev, xh, h)
        _, ms_h = kernel_ms(lambda: c.call(c.fn, dev, xh, h))
        # the marginal cost of one op, free of the launch's fixed cost
        rec.update(half_iters=h, half_ms=ms_h,
                   slope_us=(ms - ms_h) * 1e3 / max(it - h, 1))
    b_ms, b_by = bound(nbytes(x, out), c.ops(x, it))
    rec.update(bound_ms=b_ms, bound_by=b_by)
    lib = None
    if c.library is not None:
        c.library(xt)
        _, lib = cuda_ms(lambda: c.library(xt), REPS)
    rec["library_ms"] = lib
    return rec


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _fmt(rec: dict) -> str:
    s = (f"{rec['pid']:4s} {rec['label']:42s} {rec['per_op_us']:10.4f} "
         f"us/{rec['unit']} (it={rec['iters']}, {rec['ms']:.4f} ms")
    if "half_ms" in rec:
        s += (f"; it={rec['half_iters']} {rec['half_ms']:.4f} ms, ratio "
              f"{rec['ms'] / max(rec['half_ms'], 1e-9):.2f}, marginal "
              f"{rec['slope_us']:.4f} us/{rec['unit']}")
    s += f"; bound {rec['bound_ms']:.6f} ms by {rec['bound_by']}"
    if rec.get("library_ms") is not None:
        s += f"; library {rec['library_ms']:.4f} ms/op"
    if "max_abs_err" in rec:
        s += (f"; plain / kernel {rec['plain_ms']:.3f} / "
              f"{rec['check_kernel_ms']:.4f} ms at it={rec['check_iters']}"
              f", max_abs_err={rec['max_abs_err']}")
    return s + ")"


def run(names, dev, iters: Optional[int] = None, check: bool = True,
        out=None) -> List[dict]:
    """Every case of ``names`` on ``dev``: on a card ``measure`` each; on
    the CPU run the plain versions at ``iters`` (default 3) and report a
    digest.  Returns one record per case."""
    dev = torch.device(dev)
    out = out or sys.stdout
    recs = []
    for name in names:
        print(f"# {name}", file=out, flush=True)
        for c in FILES[name]():
            if dev.type == "cuda":
                rec = measure(c, dev, iters, check)
                print(_fmt(rec), file=out, flush=True)
            else:
                it = min(iters or 3, c.iters) if looped(c) else c.iters
                _, xt = inputs(c, 0, it, dev)
                res = _leaves(c.call(c.fn, dev, xt, it))
                digest = [int(t.long().sum()) for t in res]
                rec = {"pid": c.pid, "label": c.label, "iters": it,
                       "shapes": [tuple(t.shape) for t in res],
                       "digest": digest}
                print(f"{c.pid:4s} {c.label:42s} it={it} plain (cpu): "
                      f"shapes {rec['shapes']} sums {digest}", file=out,
                      flush=True)
            recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("file", choices=[*FILES, "all"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=None,
                    help="loop count (default: the tool's on the card, 3 "
                         "on the CPU)")
    ap.add_argument("--json", default=None,
                    help="also write every record, with the card line, to "
                         "this file")
    a = ap.parse_args(argv)
    names = list(FILES) if a.file == "all" else [a.file]
    card = "cpu (plain versions)"
    if torch.device(a.device).type == "cuda":
        if not torch.cuda.is_available():
            print("microbench: no CUDA device; use --device cpu for the "
                  "plain versions", file=sys.stderr)
            return 2
        card = card_line()
        print(card, flush=True)
    recs = run(names, a.device, a.iters)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"card": card, "records": recs}, f, indent=1)
    bad = [r for r in recs if r.get("max_abs_err", 0)]
    for r in bad:
        print(f"FAIL {r['pid']} {r['label']}: max_abs_err="
              f"{r['max_abs_err']}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
