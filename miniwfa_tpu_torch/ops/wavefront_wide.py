"""Wide-band wavefront engine: one alignment over the whole card, SCORE and
PASS1 modes, resumable across calls.

Counterpart of ``miniwfa_tpu/ops/wavefront_wide.py`` (the Pallas kernel
``build_kernel_wide`` with ``get_kernel_wide`` and ``run_chunked``): the
engine for bands past the one-block-per-lane kernel's windows, score runs
past 65536 diagonals and low-mem pass 1 past 32768, up to 2^20
(``models/exact.py::_wide_eligible``).  It computes what K1
(``ops/wavefront_kernel.py``) computes, with K1's spec, inputs, outputs and
snapshot layout, so the checkpoint chain and decoder serve its pass 1
unchanged.  Two implementations:

* ``wide_plain`` — K1's plain cycle code (``wavefront_kernel.run_cycles``),
  each lane from its state to its cycle limit;
* ``csrc/wavefront_wide.cu`` — a persistent cooperative launch over the
  whole card, lanes one after another, in one of two variants:
  ``"tile"``, time-blocked tiles of the band in shared memory (each block
  loads every plane of a tile plus a halo of k slots a side, runs a batch
  of up to k cycles on it with block barriers only, and writes the tile
  back; one grid barrier a batch), and ``"cycle"``, the per-cycle body
  (every SM takes a share of the band each cycle, 2-4 grid barriers a
  cycle) for penalty sets whose smallest tile does not fit in shared
  memory, a zero recurrence age, or a window that is no multiple of 4
  (the tiles load each plane row by one 16-byte aligned bulk copy).
  ``pick_tiles`` chooses the variant and the tile's n (output slots) and
  k (cycles a batch) from the spec and the card's shared memory (its
  opt-in limit less the tiled kernel's static shared memory, both as the
  card reports them); ``wide(..., tile=n, batch=k, variant=...)`` forces
  them.

``wide`` dispatches on the device of its inputs: CPU tensors run the plain
version, CUDA tensors launch the kernel (or raise).

Resume protocol.  A run's state is a ``WideState``: the per-lane state row
``row [B, state_width] int64`` (ST_* columns: cycle t, committed band
wf_lo/wf_hi, top band t_lo/t_hi, n_iter, last_ptr, snap_cnt, final_s, the
done/stopped/overflow flags, then the band registry: RH lows, RH highs),
the planes ``[B, plane_count, W] int32`` (``wavefront_kernel.new_planes``)
and, in PASS1, the snapshot rows ``snap [B, n_snap, NP, W] int32``.  A call
runs each lane while its t is below its limit ``t_lim`` (and S_CAP-1),
pauses between two cycles, updates the state in place and returns ``out
[B, OW_N] int64``: K1's O_* columns, where O_OVFS marks a lane that really
exhausted S_CAP, and OW_PAUSE one alive below it.  A run resumed from the
state equals one uninterrupted call bit for bit.

``run_chunked`` drives a run to its end in calls of bounded work (the
sqrt(t^2 + cells) rule: the band grows about 2 diagonals a cycle, so the
cells of cycles t0..t1 are about t1^2 - t0^2), split over the lanes still
live, and grows the snapshot rows between calls as the run needs them,
under the caller's byte budget.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import hbm
from ..utils.launches import count_launch
from . import build
from . import wavefront_kernel as wk

# state-row columns (csrc/wavefront_wide.cu); the band registry follows
(ST_T, ST_WLO, ST_WHI, ST_TLO, ST_THI, ST_NITER, ST_LP, ST_SNC, ST_S,
 ST_DONE, ST_STOP, ST_OVFB, ST_BND) = range(13)
# out columns: K1's, then the pause flag
OW_PAUSE = wk.O_N
OW_N = wk.O_N + 1
# run_chunked's work per call, split over the live lanes
CYCLES_PER_CALL = 65536
CELLS_PER_CALL = 1.0e10
F_N = 5   # "cycle": flag words per cycle parity (csrc/wavefront_wide.cu F_*)
VARIANTS = ("tile", "cycle")
# the tiled variant's (n, k), largest first: output slots a tile at most
# (a batch takes the band over the grid's blocks, at least 512 - 2k, up to
# n), cycles a batch (a batch also ends at each shrink, snapshot and pause)
TILES = ((960, 32), (448, 32), (192, 32), (96, 16), (32, 1))
K_MAX = 256         # cycles a batch at most (the shrink period)
LOG_N = 8 + 2 * K_MAX   # "tile": log words per batch (csrc LG_N), 3 sets
# a tiled launch's stats (csrc SS_*): batches and reruns, then block 0's
# tiles and its clock64 cycles loading, extending (a cycle's start to the
# barrier after its extension), in cycles, writing back, at the grid
# barrier, and summed over the batches the slowest tile's cycles and the
# most a tile spent extending
STATS = ("batches", "reruns", "tiles", "clk_load", "clk_ext", "clk_cycles",
         "clk_write", "clk_wait", "clk_tile_max", "clk_ext_max")


def state_width(spec: wk.KSpec) -> int:
    return ST_BND + 2 * spec.rings[0]


@dataclass
class WideState:
    """A wide run between calls (module docstring)."""

    row: torch.Tensor
    planes: torch.Tensor
    snap: Optional[torch.Tensor]


def new_state(spec: wk.KSpec, lanes: torch.Tensor) -> WideState:
    """The state of a fresh run on the lanes' device."""
    _check_spec(spec)
    B, RH = lanes.shape[0], spec.rings[0]
    row = torch.zeros((B, state_width(spec)), dtype=torch.int64,
                      device=lanes.device)
    row[:, ST_LP] = wk.WF_NEG_INF
    row[:, ST_S] = -1
    row[:, ST_BND:ST_BND + RH] = 1    # empty bands until really recorded
    snap = None
    if spec.mode == wk.MODE_PASS1:
        snap = torch.full((B, spec.n_snap, wk.snapshot_layout(spec)[5],
                           spec.W), wk.WF_NEG_INF, dtype=torch.int32,
                          device=lanes.device)
    return WideState(row, wk.new_planes(spec, lanes), snap)


def _check_spec(spec: wk.KSpec) -> None:
    wk._check_spec(spec)
    if spec.mode not in (wk.MODE_SCORE, wk.MODE_PASS1):
        raise ValueError("the wide kernel runs SCORE and PASS1 only")


def _check_state(spec: wk.KSpec, lanes, state: WideState, t_lim) -> None:
    B, dev = lanes.shape[0], lanes.device
    want = {"row": (state.row, torch.int64, (B, state_width(spec))),
            "planes": (state.planes, torch.int32,
                       (B, wk.plane_count(spec), spec.W)),
            "t_lim": (t_lim, torch.int64, (B,))}
    if spec.mode == wk.MODE_PASS1:
        want["snap"] = (state.snap, torch.int32,
                        (B, spec.n_snap, wk.snapshot_layout(spec)[5], spec.W))
    elif state.snap is not None:
        raise ValueError("a SCORE run has no snapshot rows")
    for name, (x, dtype, shape) in want.items():
        if x is None or x.dtype != dtype or tuple(x.shape) != shape \
                or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape} "
                             f"on {dev}")


def _machine(spec: wk.KSpec, rows: torch.Tensor) -> wk.PlainState:
    """The state rows of lanes at one cycle -> the plain loop's state."""
    RH = spec.rings[0]
    m = wk.PlainState(spec, rows.shape[0], rows.device)

    def col(c):
        return rows[:, c].clone()

    m.t, m.t_lane = int(rows[0, ST_T]), col(ST_T)
    m.wf_lo, m.wf_hi, m.t_lo, m.t_hi = \
        col(ST_WLO), col(ST_WHI), col(ST_TLO), col(ST_THI)
    m.n_iter, m.last_ptr, m.snap_cnt, m.final_s = \
        col(ST_NITER), col(ST_LP), col(ST_SNC), col(ST_S)
    m.done, m.stopped, m.ovf = \
        col(ST_DONE) != 0, col(ST_STOP) != 0, col(ST_OVFB) != 0
    m.bnd[:, :, 0] = rows[:, ST_BND:ST_BND + RH]
    m.bnd[:, :, 1] = rows[:, ST_BND + RH:ST_BND + 2 * RH]
    return m


def _store(spec: wk.KSpec, m: wk.PlainState, rows: torch.Tensor) -> None:
    RH = spec.rings[0]
    for col, v in ((ST_T, m.t_lane), (ST_WLO, m.wf_lo), (ST_WHI, m.wf_hi),
                   (ST_TLO, m.t_lo), (ST_THI, m.t_hi), (ST_NITER, m.n_iter),
                   (ST_LP, m.last_ptr), (ST_SNC, m.snap_cnt),
                   (ST_S, m.final_s), (ST_DONE, m.done),
                   (ST_STOP, m.stopped), (ST_OVFB, m.ovf)):
        rows[:, col] = v.long()
    rows[:, ST_BND:ST_BND + RH] = m.bnd[:, :, 0]
    rows[:, ST_BND + RH:ST_BND + 2 * RH] = m.bnd[:, :, 1]


def _outputs(spec: wk.KSpec, row: torch.Tensor) -> torch.Tensor:
    alive = (row[:, ST_DONE] | row[:, ST_STOP] | row[:, ST_OVFB]) == 0
    cap = row[:, ST_T] >= spec.S_CAP - 1
    out = torch.zeros((row.shape[0], OW_N), dtype=torch.int64,
                      device=row.device)
    for o, col in ((wk.O_S, ST_S), (wk.O_DONE, ST_DONE),
                   (wk.O_STOP, ST_STOP), (wk.O_OVFB, ST_OVFB),
                   (wk.O_NITER, ST_NITER), (wk.O_LP, ST_LP),
                   (wk.O_SNC, ST_SNC)):
        out[:, o] = row[:, col]
    out[:, wk.O_OVFS] = (alive & cap).long()
    out[:, OW_PAUSE] = (alive & ~cap).long()
    return out


def wide_plain(spec: wk.KSpec, lanes: torch.Tensor, tw: torch.Tensor,
               qw: torch.Tensor, state: WideState,
               t_lim: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the wide kernel: each lane runs from its
    state while t < min(t_lim, S_CAP-1), neighbouring lanes at the same
    cycle with the same limit in one loop; the state is updated in place.
    Returns out int64 [B, OW_N]."""
    _check_spec(spec)
    B = lanes.shape[0]
    key = list(zip(state.row[:, ST_T].tolist(),
                   t_lim.clamp(max=spec.S_CAP - 1).tolist()))
    b = 0
    while b < B:
        e = b + 1
        while e < B and key[e] == key[b]:
            e += 1
        sl = slice(b, e)
        m = _machine(spec, state.row[sl])
        wk.run_cycles(spec, m, state.planes[sl], lanes[sl], tw[sl], qw[sl],
                      key[b][1],
                      snap=None if state.snap is None else state.snap[sl])
        _store(spec, m, state.row[sl])
        b = e
    return _outputs(spec, state.row)


def tile_cap(n: int, k: int) -> int:
    """Slots a tile of the tiled variant holds: its output slots (at most
    max(n, 4k): a band's middle that narrow is one tile, and the tiles
    that hold its edges take 2k each) and a halo of k a side."""
    return max(n, 4 * k) + 2 * k


def tile_smem(spec: wk.KSpec, n: int, k: int) -> int:
    """Dynamic shared memory of a tiled block (csrc ``smem_of``): the band
    registry (2 RH ints) and the batch's band log (2 (k+1)), rounded up to
    16 bytes, then every plane of a tile (``plane_count`` rows of
    tile_cap + 11 ints rounded up to 16 bytes: the bulk copy of a row
    starts and ends on 16-byte slot boundaries, up to 3 slots past the
    tile a side, with a pad slot either side)."""
    def up4(v):
        return (v + 3) // 4 * 4
    return 4 * (up4(2 * spec.rings[0] + 2 * (k + 1))
                + wk.plane_count(spec) * up4(tile_cap(n, k) + 11))


def pick_tiles(spec: wk.KSpec, smem: int) -> Tuple[str, int, int]:
    """(variant, n, k) of a launch for ``spec`` on a card whose blocks may
    take ``smem`` bytes of dynamic shared memory: the first of TILES whose
    tile fits, else ``"cycle"`` (n = k = 0).  The tiled variant needs every
    recurrence age at least 1 (x, e1, e2 >= 1), or a cycle's transition
    would read the score it writes, and a window of whole 16-byte words
    (W % 4 == 0) for its bulk copies."""
    if _tiles_apply(spec):
        for n, k in TILES:
            if tile_smem(spec, n, k) <= smem:
                return "tile", n, k
    return "cycle", 0, 0


def _tiles_apply(spec: wk.KSpec) -> bool:
    return min(spec.x, spec.e1, spec.e2) >= 1 and spec.W % 4 == 0


def _check_forced(spec: wk.KSpec, tile, batch, variant) -> None:
    if variant not in (None,) + VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    forced = tile is not None or batch is not None
    if variant == "cycle" and forced:
        raise ValueError("the cycle variant takes no tile or batch")
    if tile is not None and (not isinstance(tile, int) or tile < 1):
        raise ValueError(f"tile must be an int >= 1, got {tile!r}")
    if batch is not None and (not isinstance(batch, int)
                              or not 1 <= batch <= K_MAX):
        raise ValueError(f"batch must be an int in [1, {K_MAX}], got "
                         f"{batch!r}")
    if (variant == "tile" or forced) and not _tiles_apply(spec):
        raise ValueError(f"the tiled variant needs x, e1, e2 >= 1 and "
                         f"W % 4 == 0, got x={spec.x} e1={spec.e1} "
                         f"e2={spec.e2} W={spec.W}")


def _smem_optin(dev, mode: int) -> int:
    """The dynamic shared memory a tiled block in ``mode`` may opt in to on
    ``dev``: the card's opt-in limit less the kernel's static shared
    memory, as the card reports them (cached per card and mode)."""
    if (dev.index, mode) not in _SMEM:
        fn = build.load("wavefront_wide", "mwf_wide_smem_optin",
                        [ctypes.c_int, ctypes.c_void_p])
        n = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = fn(mode, ctypes.addressof(n))
        if rc:
            raise RuntimeError(f"wide kernel shared-memory query failed: "
                               f"CUDA error {rc}")
        _SMEM[dev.index, mode] = n.value
    return _SMEM[dev.index, mode]


_SMEM = {}


def _grid(spec: wk.KSpec, variant: str, n: int, k: int) -> int:
    """Blocks of the wide kernel's cooperative launch (its variant, mode,
    penalties and tile) on the current card: as many as can be co-resident
    (occupancy x SMs).  A tile the card cannot hold raises."""
    fn = build.load("wavefront_wide", "mwf_wide_grid",
                    [ctypes.c_int] * 9 + [ctypes.c_void_p])
    blocks = ctypes.c_int(0)
    rc = fn(VARIANTS.index(variant), spec.mode, spec.x, spec.o1, spec.e1,
            spec.o2, spec.e2, n, k, ctypes.addressof(blocks))
    if rc:
        raise RuntimeError(f"wide kernel launch refused (variant={variant} "
                           f"n={n} k={k}, {tile_smem(spec, n, k)} bytes of "
                           f"shared memory): CUDA error {rc}")
    return blocks.value


def wide(spec: wk.KSpec, lanes: torch.Tensor, tw: torch.Tensor,
         qw: torch.Tensor, state: WideState, t_lim: torch.Tensor, *,
         tile: Optional[int] = None, batch: Optional[int] = None,
         variant: Optional[str] = None) -> torch.Tensor:
    """One call of the wide engine (module docstring); outputs as
    ``wide_plain``.  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/wavefront_wide.cu`` over the whole card at
    ``pick_tiles``' variant, n and k, or at the forced ``variant``, ``tile``
    (n) and ``batch`` (k); a forced tile or batch implies the tiled variant,
    and the other one comes from the chooser (or TILES[0]).  A launch the
    card refuses raises, naming them.  Counts the launch in
    ``wide.launches``, by mode in ``wide.launches_by_mode`` and by variant
    in ``wide.launches_by_variant``; by card index, ``wide.tiles[card][mode]``
    keeps the card's last launch's variant, n, k and blocks, and
    ``wide.last_stats[card]`` its STATS (an int64 tensor on the card; 0 in
    "cycle").  Either notes its buffers in the peak-memory meter."""
    _check_spec(spec)
    wk._check_inputs(spec, lanes, tw, qw, None)
    _check_state(spec, lanes, state, t_lim)
    _check_forced(spec, tile, batch, variant)
    if lanes.device.type == "cpu":
        _note(spec, lanes, tw, qw, state, t_lim)
        return wide_plain(spec, lanes, tw, qw, state, t_lim)
    if lanes.device.type != "cuda":
        raise ValueError(f"unsupported device {lanes.device}")
    dev = lanes.device
    with torch.cuda.device(dev):
        v, n, k = pick_tiles(spec, _smem_optin(dev, spec.mode))
        if tile is not None or batch is not None or variant == "tile":
            n0, k0 = (n, k) if v == "tile" else TILES[0]
            v, n, k = "tile", tile or n0, batch or k0
        elif variant == "cycle":
            v, n, k = "cycle", 0, 0
        if v == "tile" and state.planes.data_ptr() % 16:
            raise ValueError("the tiled variant copies plane rows in 16-byte "
                             "words: the planes must start on 16 bytes")
        key = (dev.index, v, spec.mode, spec.x, spec.o1, spec.e1, spec.o2,
               spec.e2, n, k)
        if key not in wide.blocks:
            wide.blocks[key] = _grid(spec, v, n, k)
        fn = build.load("wavefront_wide", "mwf_wide",
                        [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                 ctypes.c_void_p, ctypes.c_int]
                        + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 16
                        + [ctypes.c_void_p])
        B = lanes.shape[0]
        out = torch.empty((B, OW_N), dtype=torch.int64, device=dev)
        stats = torch.zeros((len(STATS),), dtype=torch.int64, device=dev)
        if v == "tile":
            flags = torch.empty((3 * LOG_N,), dtype=torch.int32, device=dev)
            scratch = torch.empty((wk.plane_count(spec), spec.W),
                                  dtype=torch.int32, device=dev)
        else:
            flags = torch.empty((2 * F_N,), dtype=torch.int32, device=dev)
            scratch = None
        _note(spec, lanes, tw, qw, state, t_lim, out, stats, flags, scratch)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(lanes.data_ptr(), tw.data_ptr(), qw.data_ptr(), tw.shape[1],
                state.row.data_ptr(), state.row.shape[1], t_lim.data_ptr(),
                state.planes.data_ptr(),
                state.snap.data_ptr() if state.snap is not None else None,
                out.data_ptr(), flags.data_ptr(),
                scratch.data_ptr() if scratch is not None else None,
                stats.data_ptr(), B, spec.W, spec.S_CAP, spec.mode, spec.cpw,
                spec.x, spec.o1, spec.e1, spec.o2, spec.e2,
                spec.step, spec.n_snap, VARIANTS.index(v), n, k,
                wide.blocks[key], stream)
    if rc:
        raise RuntimeError(f"wide kernel launch refused (variant={v} n={n} "
                           f"k={k}): CUDA error {rc}")
    mode = wk.launch_mode(spec, None)
    count_launch(wide, mode=mode, variant=v, card=dev.index)
    # keyed by card: the sharded path launches from one thread per card
    wide.tiles.setdefault(dev.index, {})[mode] = {
        "variant": v, "n": n, "k": k, "blocks": wide.blocks[key]}
    wide.last_stats[dev.index] = stats
    return out


def _note(spec: wk.KSpec, lanes: torch.Tensor, tw, qw, state: WideState,
          *bufs) -> None:
    """The peak-memory meter's note of one call: the inputs, the run's
    state (row, planes, snapshot rows) and the launch's own buffers
    (``utils/hbm.py``, tag ``wide-planes``; ``run_chunked`` makes one call
    a step, after growing the snapshot rows)."""
    hbm.note_arrays(f"wide-planes mode={spec.mode} B={lanes.shape[0]} "
                    f"W={spec.W} n_snap={spec.n_snap}", lanes, tw, qw,
                    state.row, state.planes, state.snap, *bufs)


wide.launches = 0
wide.launches_by_mode = collections.Counter()
wide.launches_by_variant = collections.Counter()
wide.launches_by_card = collections.Counter()
wide.tiles = {}
wide.last_stats = {}
# cooperative grid size per (CUDA device, variant, mode, penalties, n, k)
wide.blocks = {}


def _grow_snap(spec: wk.KSpec, state: WideState, n2: int) -> wk.KSpec:
    """Snapshot rows grown to ``n2`` in a new buffer, the new rows unset
    (WF_NEG_INF); the old and the new buffers are all it holds at once."""
    B, n, NP, W = state.snap.shape
    snap = torch.empty((B, n2, NP, W), dtype=torch.int32,
                       device=state.snap.device)
    snap[:, :n] = state.snap
    snap[:, n:] = wk.WF_NEG_INF
    state.snap = snap
    return dataclasses.replace(spec, n_snap=n2)


def run_chunked(spec: wk.KSpec, lanes: torch.Tensor, tw: torch.Tensor,
                qw: torch.Tensor, *, snap_budget: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], wk.KSpec]:
    """A whole wide run in calls of bounded work (module docstring): at
    most CYCLES_PER_CALL cycles and about CELLS_PER_CALL cells a call,
    split over the live lanes.

    PASS1 starts with ``spec.n_snap`` snapshot rows and grows them ahead of
    each call to the rows its cycles can take, by at least half, up to the
    S_CAP//step + 2 a run can use; the old and the new rows must fit
    ``snap_budget`` bytes together (the copy holds both).  A call whose
    rows cannot grow far enough pauses before the cycle that would take the
    next row; a lane that cannot take its next snapshot raises.  Returns
    (out int64 [B, O_N], snapshot rows or None, the spec with the final
    n_snap)."""
    _check_spec(spec)
    B = lanes.shape[0]
    state = new_state(spec, lanes)
    is_p1 = spec.mode == wk.MODE_PASS1
    full = spec.S_CAP // spec.step + 2 if is_p1 else 0
    row_b = wk.snapshot_layout(spec)[5] * spec.W * 4
    out = None
    live = np.ones(B, bool)
    while live.any():
        n_act = int(live.sum())
        cyc = max(1, CYCLES_PER_CALL // n_act)
        cells = CELLS_PER_CALL / n_act
        t_now = state.row[:, ST_T].cpu().numpy()
        step_n = np.maximum(1, np.minimum(
            cyc, np.sqrt(t_now.astype(np.float64) ** 2 + cells) - t_now + 1
        ).astype(np.int64))
        t_lim = np.where(live, np.minimum(t_now + step_n, spec.S_CAP), 0)
        if is_p1:
            need = min(full, int(t_lim[live].max()) // spec.step)
            if need > spec.n_snap:
                afford = (snap_budget // (B * row_b) - spec.n_snap
                          if snap_budget else full)
                n2 = min(full, max(need, spec.n_snap * 3 // 2), afford)
                if n2 > spec.n_snap:
                    spec = _grow_snap(spec, state, n2)
            # the cycle that would take row n_snap ends the call
            t_lim = np.where(live, np.minimum(
                t_lim, (spec.n_snap + 1) * spec.step - 1), 0)
            if (t_lim[live] <= t_now[live]).any():
                raise RuntimeError(
                    f"low-mem snapshot rows ({spec.n_snap} of "
                    f"{row_b / 2**20:.0f} MiB for {B} lane(s)) cannot grow "
                    f"under the {snap_budget / 2**30:.1f} GiB budget at "
                    f"step={spec.step}, W={spec.W} — use a larger step or "
                    f"the chain mode")
        out = wide(spec, lanes, tw, qw, state,
                   torch.from_numpy(t_lim).to(lanes.device))
        live = out[:, OW_PAUSE].cpu().numpy() != 0
    return out[:, :wk.O_N], state.snap, spec
