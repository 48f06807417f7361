"""Multi-lane wavefront engine (K4): G alignments per thread block.

Counterpart of ``miniwfa_tpu/ops/wavefront_multi.py`` (the Pallas kernel
``build_kernel`` with ``get_multi_kernel`` and ``pick_g``), which packs G
lanes' whole DP states into one TPU grid step.  It computes what K1
(``ops/wavefront_kernel.py``) computes, with K1's spec, inputs and outputs,
in SCORE and TB modes, with or without the pass-2 checkpoints; PASS1 stays
on K1, as in the JAX package.  Two implementations:

* the plain version is K1's, ``wavefront_kernel.wavefront_plain``: one
  function, so no second copy of the recurrence;
* ``csrc/wavefront.cu`` with G lanes per block (``mwf_wavefront_multi``):
  G groups of 512/G threads, each owning one lane with its own band
  registry, flags and named barrier.

``wavefront_multi`` dispatches on the device of its inputs: CPU tensors run
the plain version, CUDA tensors launch the kernel (or raise).

On the card K1 spreads a lane over a cluster of 512-thread blocks (one
block per lane past the card's co-resident clusters), so a batch of
fewer lanes than SMs gains nothing from packing; ``pick_g`` packs only
batches with at least one block of G lanes per SM (the chain's K1 gap
fills, in chunks of 2048).  The route is opt-in (``MWF_ENGINE=multi``,
models/exact.py), as in the JAX package.
"""

from __future__ import annotations

import collections
import os
from typing import Optional

import torch

from ..utils.launches import count_launch
from . import build
from . import wavefront_kernel as wk

GS = (8, 4, 2)   # lanes per block the kernel is built for


def pick_g(mode: int, B: int, device) -> int:
    """Lanes per block for a batch of B lanes in ``mode`` on ``device``
    (the JAX package's ``pick_g``, wavefront_multi.py:1033, on the card's
    terms): ``MWF_KERNEL_G`` if set; on a card, the largest G of GS with
    G <= B and at least one block per SM (ceil(B/G) >= the card's SM
    count), else 1 (K1); on the CPU, where every G runs the same plain
    version, min(8, B).  PASS1 is always 1."""
    if mode == wk.MODE_PASS1:
        return 1
    forced = os.environ.get("MWF_KERNEL_G")
    if forced is not None:
        return int(forced)
    device = torch.device(device)
    if device.type != "cuda":
        return min(8, B)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for g in GS:
        if g <= B and -(-B // g) >= sms:
            return g
    return 1


def wavefront_multi(spec: wk.KSpec, G: int, lanes: torch.Tensor,
                    tw: torch.Tensor, qw: torch.Tensor,
                    segs: Optional[torch.Tensor] = None):
    """Run the wavefront loop for every lane, G lanes per block; outputs
    as ``wavefront_kernel.wavefront_plain``.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/wavefront.cu``'s multi-lane entry
    and count the launch in ``wavefront_multi.launches`` and, by mode,
    ``wavefront_multi.launches_by_mode``."""
    if spec.mode not in (wk.MODE_SCORE, wk.MODE_TB):
        raise ValueError("the multi-lane kernel runs SCORE and TB only")
    if G not in GS:
        raise ValueError(f"G must be one of {GS}, got {G}")
    wk._check_spec(spec)
    wk._check_inputs(spec, lanes, tw, qw, segs)
    if lanes.device.type == "cpu":
        return wk.wavefront_plain(spec, lanes, tw, qw, segs)
    if lanes.device.type != "cuda":
        raise ValueError(f"unsupported device {lanes.device}")
    res = wk.launch(spec, lanes, tw, qw, segs, G)
    count_launch(wavefront_multi, mode=wk.launch_mode(spec, segs))
    return res


wavefront_multi.launches = 0
wavefront_multi.launches_by_mode = collections.Counter()
