"""The system under test: the entry point of ``miniwfa_tpu_torch`` that
a cell's traffic names, and its launch counters.  This is the one
module of the benchmark that imports the program."""

from __future__ import annotations

from typing import Callable, Dict, Sequence

ENTRIES = ("align_batch",)


def options(cfg: dict, traffic: dict):
    """The program's ``Options`` for a configuration's penalties and a
    traffic's mode (score, cigar, lowmem with its ``step``)."""
    from miniwfa_tpu_torch import Options
    mode = traffic["mode"]
    return Options(**cfg["penalties"], cigar=mode != "score",
                   step=int(traffic.get("step", 0)) if mode == "lowmem"
                   else 0)


def entry(cfg: dict, traffic: dict, devices: Sequence[str]) -> Callable:
    """The call the window makes: pairs -> the program's results
    (objects with ``s``, ``n_iter``, ``cigar``)."""
    opt = options(cfg, traffic)
    name = traffic["entry"]
    if name == "align_batch":
        from miniwfa_tpu_torch.models.exact import align_batch
        dev = devices[0]
        return lambda pairs: align_batch(pairs, opt, device=dev)
    raise ValueError(f"unknown entry {name!r} (one of {ENTRIES})")


def launches() -> Dict[str, int]:
    """The program's launch counters: K1, K2, K3, K4, W1, W2."""
    from miniwfa_tpu_torch.ops import traceback_device as tbd
    from miniwfa_tpu_torch.ops import wavefront_gaps as wg
    from miniwfa_tpu_torch.ops import wavefront_kernel as wk
    from miniwfa_tpu_torch.ops import wavefront_multi as wm
    from miniwfa_tpu_torch.ops import wavefront_wide as ww
    return {"K1": wk.wavefront.launches, "K2": ww.wide.launches,
            "K3": wg.gaps.launches, "K4": wm.wavefront_multi.launches,
            "W1": tbd.walk.launches, "W2": tbd.chain_ptrs.launches}

