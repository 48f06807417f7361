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
* ``csrc/wavefront_wide.cu`` — a cooperative launch that spreads one lane
  over every SM, the lanes one after another.

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
F_N = 5   # flag words per cycle parity (csrc/wavefront_wide.cu F_*)


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


def _grid(spec: wk.KSpec) -> int:
    """Blocks of the wide kernel's cooperative launch for ``spec`` (its
    mode and its band registry's RH scores of shared memory) on the
    current card: as many as can be co-resident (occupancy x SMs)."""
    fn = build.load("wavefront_wide", "mwf_wide_grid",
                    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    blocks = ctypes.c_int(0)
    rc = fn(spec.mode, spec.rings[0], ctypes.addressof(blocks))
    if rc:
        raise RuntimeError(f"wide kernel occupancy query failed: CUDA error "
                           f"{rc}")
    return blocks.value


def wide(spec: wk.KSpec, lanes: torch.Tensor, tw: torch.Tensor,
         qw: torch.Tensor, state: WideState,
         t_lim: torch.Tensor) -> torch.Tensor:
    """One call of the wide engine (module docstring); outputs as
    ``wide_plain``.  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/wavefront_wide.cu`` over the whole card and count the
    launch in ``wide.launches`` and, by mode, ``wide.launches_by_mode``."""
    _check_spec(spec)
    wk._check_inputs(spec, lanes, tw, qw, None)
    _check_state(spec, lanes, state, t_lim)
    if lanes.device.type == "cpu":
        return wide_plain(spec, lanes, tw, qw, state, t_lim)
    if lanes.device.type != "cuda":
        raise ValueError(f"unsupported device {lanes.device}")
    fn = build.load("wavefront_wide", "mwf_wide",
                    [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                             ctypes.c_void_p, ctypes.c_int]
                    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                    + [ctypes.c_void_p])
    dev = lanes.device
    B = lanes.shape[0]
    out = torch.empty((B, OW_N), dtype=torch.int64, device=dev)
    flags = torch.empty((2 * F_N,), dtype=torch.int32, device=dev)
    key = (dev.index, spec.mode, spec.rings[0])
    with torch.cuda.device(dev):
        if key not in wide.blocks:
            wide.blocks[key] = _grid(spec)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(lanes.data_ptr(), tw.data_ptr(), qw.data_ptr(), tw.shape[1],
                state.row.data_ptr(), state.row.shape[1], t_lim.data_ptr(),
                state.planes.data_ptr(),
                state.snap.data_ptr() if state.snap is not None else None,
                out.data_ptr(), flags.data_ptr(),
                B, spec.W, spec.S_CAP, spec.mode, spec.cpw,
                spec.x, spec.o1, spec.e1, spec.o2, spec.e2,
                spec.step, spec.n_snap, wide.blocks[key], stream)
    if rc:
        raise RuntimeError(f"wide kernel launch failed: CUDA error {rc}")
    wide.launches += 1
    wide.launches_by_mode[wk.launch_mode(spec, None)] += 1
    return out


wide.launches = 0
wide.launches_by_mode = collections.Counter()
wide.blocks = {}   # cooperative grid size per (CUDA device, mode, RH)


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
