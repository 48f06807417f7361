"""Multi-lane wavefront engine (K4): many alignments per thread block.

Counterpart of ``miniwfa_tpu/ops/wavefront_multi.py`` (the Pallas kernel
``build_kernel`` with ``get_multi_kernel`` and ``pick_g``), which packs G
lanes' whole DP states into one TPU grid step.  It computes what K1
(``ops/wavefront_kernel.py``) computes, with K1's spec, inputs and outputs,
in SCORE and TB modes, with or without the pass-2 checkpoints; PASS1 stays
on K1, as in the JAX package.  Three implementations:

* the plain version is K1's, ``wavefront_kernel.wavefront_plain``: one
  function, so no second copy of the recurrence;
* "smem", ``csrc/wavefront_multi.cu`` (``mwf_wavefront_multi_smem``): one
  warp per lane, the lane's rings, lastv and band registry in shared
  memory, up to ``LPB_MAX`` lanes a block, every warp taking lanes from an
  atomic counter; no planes buffer in global memory;
* "global", ``csrc/wavefront.cu`` with G lanes per block
  (``mwf_wavefront_multi``): G groups of 512/G threads, each owning one
  lane with its rings in global memory and its own band registry, flags
  and named barrier; for windows whose rings do not fit shared memory.

``pick_variant`` chooses between the two by size alone (a lane's shared
memory, ``lane_smem``, against the card's opt-in budget), never by a
failed launch; every variant, G and lanes per block give the same
outputs.

``wavefront_multi`` dispatches on the device of its inputs: CPU tensors run
the plain version, CUDA tensors launch a kernel (or raise).

On the card K1 spreads a lane over a cluster of 512-thread blocks (one
block per lane past the card's co-resident clusters), so a batch of
fewer lanes than SMs gains nothing from packing; ``pick_g`` packs only
batches with at least one block of G lanes per SM (the chain's K1 gap
fills, in chunks of 2048).  The route is opt-in (``MWF_ENGINE=multi``,
models/exact.py), as in the JAX package.
"""

from __future__ import annotations

import collections
import ctypes
import os
from typing import Optional, Tuple

import torch

from ..utils.launches import count_launch
from . import build
from . import wavefront_kernel as wk

GS = (8, 4, 2)   # lanes per block the global variant is built for
LPB_MAX = 8      # lanes (warps) per block of the smem variant at most


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


def lane_smem(spec: wk.KSpec) -> int:
    """Shared-memory bytes of one lane in the smem variant
    (csrc/wavefront_multi.cu ``lane_ints``): the value rings and lastv,
    ``plane_count`` planes of W int32, and the band registry's 2 x RH,
    rounded up to 16 bytes."""
    ints = wk.plane_count(spec) * spec.W + 2 * spec.rings[0]
    return 4 * (-(-ints // 4) * 4)


def pick_variant(spec: wk.KSpec, B: int, sms: int,
                 smem: int) -> Tuple[str, int]:
    """(variant, lanes per block) of a K4 launch of B lanes on a card of
    ``sms`` SMs whose blocks may opt in to ``smem`` bytes of dynamic
    shared memory.  "smem" when one lane's state fits (``lane_smem``),
    with as many lanes a block as the budget allows, at most LPB_MAX and
    at most ceil(B / sms), so that a small batch spreads over the SMs;
    else ("global", 0): the global variant runs at ``pick_g``'s G."""
    per = lane_smem(spec)
    if per > smem:
        return "global", 0
    return "smem", max(1, min(LPB_MAX, smem // per, -(-B // sms)))


_SMEM = {}


def _smem_budget(dev, mode: int) -> int:
    """The dynamic shared memory a block of the smem variant in ``mode``
    may opt in to on ``dev``: the card's opt-in limit less the kernel's
    static shared memory, from ``cudaFuncGetAttributes`` (cached per card
    and mode)."""
    if (dev.index, mode) not in _SMEM:
        fn = build.load("wavefront_multi", "mwf_multi_smem_optin",
                        [ctypes.c_int, ctypes.c_void_p])
        n = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = fn(mode, ctypes.addressof(n))
        if rc:
            raise RuntimeError(f"multi-lane kernel shared-memory query "
                               f"failed: CUDA error {rc}")
        _SMEM[dev.index, mode] = n.value
    return _SMEM[dev.index, mode]


def _launch_smem(spec: wk.KSpec, lanes, tw, qw, segs, lpb: int):
    """Launch the smem variant at ``lpb`` lanes per block; outputs as
    ``wavefront_plain``.  A launch the card refuses raises.  Notes what it
    allocates in the peak-memory meter: out, tb and bands (TB) and the
    lane counter, no planes (the rings live in shared memory)."""
    fn = build.load("wavefront_multi", "mwf_wavefront_multi_smem",
                    [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                    + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                    + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    dev = lanes.device
    B = lanes.shape[0]
    out = torch.empty((B, wk.O_N), dtype=torch.int64, device=dev)
    tb = bands = None
    if spec.mode == wk.MODE_TB:
        tb = torch.zeros((B, spec.S_CAP, spec.W), dtype=torch.uint8,
                         device=dev)
        bands = torch.zeros((B, spec.S_CAP, 2), dtype=torch.int32,
                            device=dev)
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    seg_cap = 0 if segs is None else segs.shape[1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(lanes.data_ptr(), tw.data_ptr(), qw.data_ptr(), tw.shape[1],
                out.data_ptr(), tb.data_ptr() if tb is not None else None,
                bands.data_ptr() if bands is not None else None,
                segs.data_ptr() if seg_cap else None, seg_cap,
                counter.data_ptr(), B, spec.W, spec.S_CAP,
                spec.mode, spec.cpw, spec.x, spec.o1, spec.e1, spec.o2,
                spec.e2, lpb, stream)
    if rc:
        raise RuntimeError(f"multi-lane kernel launch failed (smem, "
                           f"lanes_per_block={lpb}, {lpb * lane_smem(spec)} "
                           f"bytes of shared memory): CUDA error {rc}")
    wk._note(spec, lanes, tw, qw, segs, out, tb, bands, counter)
    return out, tb, bands, None


def wavefront_multi(spec: wk.KSpec, G: int, lanes: torch.Tensor,
                    tw: torch.Tensor, qw: torch.Tensor,
                    segs: Optional[torch.Tensor] = None):
    """Run the wavefront loop for every lane, many lanes per block; outputs
    as ``wavefront_kernel.wavefront_plain``.  CPU tensors take the plain
    version; CUDA tensors launch ``pick_variant``'s variant (the global
    one at G lanes per block).  Counts the launch in
    ``wavefront_multi.launches``, by mode in
    ``wavefront_multi.launches_by_mode`` and by variant in
    ``wavefront_multi.launches_by_variant``;
    ``wavefront_multi.variants[card][mode]`` keeps the card's last launch's
    variant, lanes per block and G."""
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
    dev = lanes.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    v, n = pick_variant(spec, lanes.shape[0], sms,
                        _smem_budget(dev, spec.mode))
    if v == "smem":
        res = _launch_smem(spec, lanes, tw, qw, segs, n)
    else:
        res, n = wk.launch(spec, lanes, tw, qw, segs, G), G
    mode = wk.launch_mode(spec, segs)
    count_launch(wavefront_multi, mode=mode, variant=v, card=dev.index)
    # keyed by card: the sharded path launches from one thread per card
    wavefront_multi.variants.setdefault(dev.index, {})[mode] = {
        "variant": v, "lanes_per_block": n, "G": G}
    return res


wavefront_multi.launches = 0
wavefront_multi.launches_by_mode = collections.Counter()
wavefront_multi.launches_by_variant = collections.Counter()
wavefront_multi.launches_by_card = collections.Counter()
wavefront_multi.variants = {}
