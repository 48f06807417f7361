"""Times of the exact path's k-mer similarity on one card, and the card's
memory around its hash table.

    python -m miniwfa_tpu_torch.tools.ksim_bench [--memory card|host]

Without ``--memory``: at the two shapes the benchmark's CIGAR and low-mem
cells size (16 pairs of 100 kb; one pair of 1 Mb; ``tools/pairs``
``make_pairs``, 2% substitutions and 0.2% indels), one JSON line each
with the median of 5 timings of

- ``wrapper_ms``: ``kmer.ksim_counts`` as ``_estimate_s`` calls it (the
  join, the bytes' copy, the table, the ksim kernel, the counts back),
  host clock;
- ``launch_ms``: ``kmer._launch`` on the bytes already on the card (the
  table's zero fill and the two kernels), CUDA events;
- ``kernels_us``: each ksim kernel's device time (torch.profiler), by
  name;
- ``plain_ms``: ``kmer.ksim_counts_plain`` on the same card tensors (the
  sort, ``torch.unique`` on the card), CUDA events, and ``plain_wall_ms``
  its host clock;
- ``host_ms``: ``kmer.ksims``, the host's sorts, host clock;

and ``equal``: the kernel's counts equal the plain version's on the card
and on the CPU, and its similarities ``kmer.ksims``'.  ``bound_ms`` is
the bytes the launch must move (the bytes read once, the table swept
once, the counts written) over 3.35 TB/s.

With ``--memory``: the 1 Mb pair in low-mem mode (step 5000: its pass 1
runs in the wide engine), two warm-up calls of ``align_batch`` and then 5
calls, the k-mer estimate on the card (``card``) or from the host's
``kmer.ksims`` (``host``); one JSON line with each call's wall, the wall
of each pass-1 dispatch (``run_chunked``), and, at the first such
dispatch of the last call, ``torch.cuda.memory_reserved``,
``memory_allocated`` and the allocator's segments by size.  Run each
side in its own process, so that neither sees the other's cache.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from unittest import mock

import numpy as np
import torch

from ..models import exact
from ..ops import kmer
from ..ops import wavefront_wide as ww
from ..options import Options
from .pairs import make_pairs

HBM_BYTES_PER_S = 3.35e12
SHAPES = (("16x100kb", 100_000, 16), ("1x1Mb", 1_000_000, 1))
K = 13


def _pairs(n: int, b: int):
    return [(t.encode(), q.encode()) for t, q in make_pairs(n, b, seed=26)]


def _events_ms(fn):
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def _wall_ms(fn, dev):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _median(fn, n=5):
    runs = [fn() for _ in range(n)]
    return runs[0][0], statistics.median(ms for _, ms in runs)


def _device_us(event) -> float:
    """An averaged profiler event's device time a call, in µs (named
    ``device_time`` in newer PyTorch, ``cuda_time`` before)."""
    for name in ("device_time", "cuda_time"):
        if hasattr(event, name):
            return getattr(event, name)
    return float("nan")


def time_counts(pairs, dev) -> dict:
    """The timings and checks of the module docstring, for one batch."""
    seqs = [s for p in pairs for s in p]
    lens = np.array([len(s) for s in seqs], np.int64)
    seg = torch.from_numpy(np.stack([np.cumsum(lens) - lens, lens],
                                    1)).to(dev)
    buf = torch.frombuffer(bytearray().join(seqs),
                           dtype=torch.uint8).to(dev)
    slots = kmer.ksim_slots(int(np.maximum(lens - K + 1, 0).sum()))
    launch = lambda: kmer._launch(buf, seg, int(lens.max()), K, slots)
    launch()                                    # builds and loads
    got, wrapper_ms = _median(lambda: _wall_ms(
        lambda: kmer.ksim_counts(pairs, K, dev), dev))
    on_card, launch_ms = _median(lambda: _events_ms(launch))
    plain, plain_ms = _median(lambda: _events_ms(
        lambda: kmer.ksim_counts_plain(buf, seg, K)))
    _, plain_wall_ms = _median(lambda: _wall_ms(
        lambda: kmer.ksim_counts_plain(buf, seg, K), dev))
    sims, host_ms = _median(lambda: _wall_ms(
        lambda: list(kmer.ksims(pairs, K)), dev))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            launch()
        torch.cuda.synchronize(dev)
    kernels_us = {e.key: _device_us(e) for e in prof.key_averages()
                  if "ksim" in e.key}
    nbytes = buf.numel() + seg.numel() * 8 + slots * kmer.KSIM_SLOT_BYTES \
        + len(pairs) * 3 * 8
    return {
        "lanes": len(pairs), "bytes_in": buf.numel(), "slots": slots,
        "table_mib": slots * kmer.KSIM_SLOT_BYTES / 2 ** 20,
        "wrapper_ms": wrapper_ms, "launch_ms": launch_ms,
        "kernels_us": kernels_us, "plain_ms": plain_ms,
        "plain_wall_ms": plain_wall_ms, "host_ms": host_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "equal": bool(np.array_equal(got, on_card.cpu().numpy())
                      and np.array_equal(got, plain.cpu().numpy())
                      and np.array_equal(got,
                                         kmer.ksim_counts(pairs, K, "cpu"))
                      and kmer.ksims_device(pairs, K, dev) == sims)}


def memory(side: str, dev) -> dict:
    """The ``--memory`` run of the module docstring."""
    pairs = _pairs(1_000_000, 1)
    opt = Options(cigar=True, step=5000)
    seen: dict = {"dispatch_ms": []}
    real = ww.run_chunked

    def watched(*a, **kw):
        if "reserved" not in seen:
            segs = torch.cuda.memory_snapshot()
            seen.update(
                reserved=torch.cuda.memory_reserved(dev),
                allocated=torch.cuda.memory_allocated(dev),
                segments=sorted((s["total_size"] for s in segs),
                                reverse=True))
        t0 = time.perf_counter()
        out = real(*a, **kw)
        seen["dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    host = lambda p, k, d: list(kmer.ksims(p, k))
    with mock.patch.object(kmer, "ksims_device",
                           host if side == "host" else kmer.ksims_device):
        for _ in range(2):
            exact.align_batch(pairs, opt, device=dev)
        walls = []
        with mock.patch.object(ww, "run_chunked", watched):
            for i in range(5):
                if i == 4:
                    seen.pop("reserved", None)
                    seen["dispatch_ms"].clear()
                walls.append(_wall_ms(lambda: exact.align_batch(
                    pairs, opt, device=dev), dev)[1])
    return {"side": side, "call_ms": walls, **seen,
            "ksim_launches": kmer.ksim_counts.launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--memory", choices=("card", "host"))
    args = ap.parse_args()
    dev = exact.check_device("cuda")
    if args.memory:
        print(json.dumps(memory(args.memory, dev)), flush=True)
        return 0
    ok = True
    for name, n, b in SHAPES:
        res = time_counts(_pairs(n, b), dev)
        ok &= res["equal"]
        print(json.dumps({"shape": name, **res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
