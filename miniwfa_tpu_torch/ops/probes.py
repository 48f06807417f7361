"""Group P, single primitives: the TPU probes of tools/microbench_mosaic.py,
microbench_mosaic2.py, microbench_pallas2.py, microbench_mosaic3.py and
microbench_chunk.py as Hopper microbenchmarks (the multi-lane probes are in
``ops/probes_multi.py``).

Each probe has two implementations of one function:

* ``<name>_plain`` — plain PyTorch that repeats the TPU kernel's body step
  by step, its dependent loop included; any device;
* ``<name>`` — the wrapper: CPU tensors run the plain version, CUDA
  tensors launch the probe's kernel in ``csrc/probes.cu`` (or raise) and
  count the launch in ``<name>.launches``.

Inputs are int32 and contiguous; the tolerance is exact equality (integer
arithmetic).  Out-of-range gather indices raise in the plain versions
(``torch.gather``) and are clamped into the table by the kernel, once per
element before its loop, so that no launch reads past shared memory.

Facts about the reference (tools/, JAX 0.9 interpret mode), which the
port reproduces:

* ``microbench_chunk.py`` overruns its own buffers at its own settings
  (WR=184, CR in {8, 16, 32}, NR up to 184): the chunk count
  ceil(NR/CR) + (t & 1) takes odd cycles past the [WR + 8, 128] planes and
  tb rows past WR / 4.  Interpret mode clamps the start of each dynamic
  slice, load, store and copy alike, into its buffer (as
  ``lax.dynamic_slice`` does); ``chunk`` and ``chunk_plain`` clamp so too.
* An output a probe never writes holds the dtype's minimum in interpret
  mode (``pallas.primitives.uninitialized_value``): 0 in
  ``bench_hbm_row_write``'s uint8 rows that no t reaches, -2**31 in
  ``microbench_chunk``'s int32 tb slots that no cycle writes.  Both
  versions start their outputs so.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

INT_MIN = -(1 << 31)
_P, _I = ctypes.c_void_p, ctypes.c_int
# GPU cycles of the spin queued before a timed launch (~100 us), so that
# the host's own launch cost falls inside the spin, not the timing
SPIN_CYCLES = 200_000


def _device(*tensors: torch.Tensor) -> torch.device:
    """The tensors' common device, after checking dtype and layout."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"probe inputs on {t.device} and {dev}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("probe inputs must be contiguous int32")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class KernelTimer:
    """While active (``with KernelTimer() as t``), every probe launch is
    timed by CUDA events around the kernel alone, a spin kernel queued
    before its start event so the host's launch cost is not timed;
    ``t.ms()`` sums them."""

    active = None

    def __enter__(self):
        self.events = []
        KernelTimer.active = self
        return self

    def __exit__(self, *exc):
        KernelTimer.active = None

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def _launch(wrapper, dev: torch.device, fn: str, argtypes, *args) -> None:
    """Launch ``mwf_probe_<fn>`` of csrc/probes.cu on the current stream of
    ``dev`` and count it on ``wrapper``."""
    f = build.load("probes", f"mwf_probe_{fn}", [*argtypes, _P])
    timer = KernelTimer.active
    with torch.cuda.device(dev):
        if timer is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            torch.cuda._sleep(SPIN_CYCLES)
            ev[0].record()
        rc = f(*args, torch.cuda.current_stream(dev).cuda_stream)
        if timer is not None:
            ev[1].record()
            timer.events.append(ev)
    if rc:
        raise RuntimeError(f"probe kernel {fn} failed to launch: CUDA "
                           f"error {rc}")
    wrapper.launches += 1


def _counted(fn):
    fn.launches = 0
    return fn


# ------------------------------------------------------------------ gathers

def _gather2d(wrapper, tab, idx, axis: int, iters: int, chain: bool,
              lim: int = 1) -> torch.Tensor:
    """Launch the shared gather kernel on 2-D ``tab`` and ``idx``."""
    dev = _device(tab, idx)
    if tab.dim() != 2 or idx.dim() != 2:
        raise ValueError("the gather kernel takes 2-D tab and idx")
    out = torch.zeros(idx.shape, dtype=torch.int32, device=dev)
    _launch(wrapper, dev, "gather", [_P, _I, _I, _P, _I, _I, _P] + [_I] * 5,
            tab.data_ptr(), tab.shape[0], tab.shape[1], idx.data_ptr(),
            idx.shape[0], idx.shape[1], out.data_ptr(), axis, iters,
            int(chain), lim, 0)
    return out


def bench_gather_plain(tab, idx, iters: int):
    acc = idx
    for _ in range(iters):
        acc = torch.gather(tab, 1, idx + (acc[0, 0] & 0))
    return acc


@_counted
def bench_gather(tab, idx, iters: int):
    """P1a. ``tools/microbench_mosaic.py:34`` ``bench_gather`` (pallas_call
    :43): ``iters`` times ``take_along_axis(tab, idx + (acc[0, 0] & 0),
    1)`` on [R, M]; the result is one gather.  On the card the fake
    dependence is each element's own ``v & zero`` with ``zero`` a kernel
    argument, so the gather stays in the loop."""
    if _device(tab, idx).type == "cpu":
        return bench_gather_plain(tab, idx, iters)
    return _gather2d(bench_gather, tab, idx, 1, iters, False)


def bench_gather_ax0_plain(tab, idx, iters: int):
    acc = idx
    for _ in range(iters):
        acc = torch.gather(tab, 0, idx + (acc[0, 0] & 0))
    return acc


@_counted
def bench_gather_ax0(tab, idx, iters: int):
    """P1b. ``tools/microbench_mosaic.py:60`` ``bench_gather_ax0``
    (pallas_call :68): ``bench_gather`` along axis 0 (columns over
    blocks on the card)."""
    if _device(tab, idx).type == "cpu":
        return bench_gather_ax0_plain(tab, idx, iters)
    return _gather2d(bench_gather_ax0, tab, idx, 0, iters, False)


def gather_chain_plain(tab, idx, axis: int, iters: int):
    lim = tab.shape[axis]
    for _ in range(iters):
        idx = torch.remainder(torch.gather(tab, axis, idx), lim)
    return idx


@_counted
def gather_chain(tab, idx, axis: int, iters: int):
    """P2. ``tools/microbench_mosaic2.py:16`` ``bench`` (pallas_call :27):
    ``iters`` dependent gathers ``idx = take_along_axis(tab, idx, axis) %
    lim`` on [R, M], lim the axis' length."""
    if _device(tab, idx).type == "cpu":
        return gather_chain_plain(tab, idx, axis, iters)
    return _gather2d(gather_chain, tab, idx, axis, iters, True,
                     tab.shape[axis])


def _as_2d(tab, idx, axis: int):
    """(tab, idx, axis) as 2-D arrays: the last axis with the leading ones
    folded, or axis 0 of a 2-D pair."""
    if axis == tab.dim() - 1 and tab.dim() >= 2:
        return tab.reshape(-1, tab.shape[-1]), idx.reshape(-1, idx.shape[-1]), 1
    if axis == 0 and tab.dim() == 2:
        return tab, idx, 0
    raise ValueError(f"take_along gathers the last axis or axis 0 of 2-D "
                     f"arrays, not axis {axis} of {tuple(tab.shape)}")


def take_along_plain(tab, idx, axis: int):
    return torch.gather(tab, axis, idx)


@_counted
def take_along(tab, idx, axis: int):
    """P3. ``tools/microbench_pallas2.py:12`` ``try_case`` (pallas_call
    :22): one ``take_along_axis(tab, idx, axis)`` where idx's shape may
    differ from tab's along ``axis`` (the P1a/P1b kernel on general
    shapes)."""
    t2, i2, a2 = _as_2d(tab, idx, axis)
    if _device(tab, idx).type == "cpu":
        return take_along_plain(tab, idx, axis)
    return _gather2d(take_along, t2, i2, a2, 1, False).reshape(idx.shape)


def ax1_gather_loop_plain(tab, idx, iters: int):
    for _ in range(iters):
        idx = torch.remainder(torch.gather(tab, 1, idx), 128)
    return idx


@_counted
def ax1_gather_loop(tab, idx, iters: int):
    """P4a. ``tools/microbench_mosaic3.py:22`` ``run_case`` (pallas_call
    :25), case 1: ``iters`` dependent gathers ``idx = take_along_axis(tab,
    idx, 1) % 128`` on [WR, 128]."""
    if _device(tab, idx).type == "cpu":
        return ax1_gather_loop_plain(tab, idx, iters)
    return _gather2d(ax1_gather_loop, tab, idx, 1, iters, True, 128)


# -------------------------------------------------------------- ALU chains

def _u32_to_i32(v: torch.Tensor) -> torch.Tensor:
    return (((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def bench_varshift_plain(x, s, iters: int):
    acc = x.long() & 0xFFFFFFFF
    sh = s.long() & 0xFFFFFFFF
    for _ in range(iters):
        acc = torch.where(sh < 32, acc >> sh.clamp(max=31), 0) | 1
    return _u32_to_i32(acc)


@_counted
def bench_varshift(x, s, iters: int):
    """P1c. ``tools/microbench_mosaic.py:85`` ``bench_varshift``
    (pallas_call :93): ``iters`` times ``acc = (acc >> s) | 1`` on uint32
    (logical shift, counts 0-30 in the tool); returned as int32."""
    dev = _device(x, s)
    if dev.type == "cpu":
        return bench_varshift_plain(x, s, iters)
    out = torch.zeros_like(x)
    _launch(bench_varshift, dev, "varshift", [_P, _P, _P, _I, _I],
            x.data_ptr(), s.data_ptr(), out.data_ptr(), x.numel(), iters)
    return out


def bench_popcount_plain(x, iters: int):
    pop8 = torch.tensor([bin(i).count("1") for i in range(256)],
                        dtype=torch.int64, device=x.device)
    acc = x
    for _ in range(iters):
        v = acc.long() & 0xFFFFFFFF
        acc = (sum(pop8[(v >> b) & 0xFF] for b in (0, 8, 16, 24))
               + 7).to(torch.int32)
    return acc


@_counted
def bench_popcount(x, iters: int):
    """P1d. ``tools/microbench_mosaic.py:110`` ``bench_popcount``
    (pallas_call :118): ``iters`` times ``acc = popcount(acc) + 7``."""
    dev = _device(x)
    if dev.type == "cpu":
        return bench_popcount_plain(x, iters)
    out = torch.zeros_like(x)
    _launch(bench_popcount, dev, "popcount", [_P, _P, _I, _I],
            x.data_ptr(), out.data_ptr(), x.numel(), iters)
    return out


# ------------------------------------------------------------ row writes

def bench_hbm_row_write_plain(x, S: int, iters: int):
    out = torch.zeros((S, x.shape[-1]), dtype=torch.uint8, device=x.device)
    for t in range(iters):
        out[t % S] = ((x.reshape(-1) + t) & 0xFF).to(torch.uint8)
    return out


@_counted
def bench_hbm_row_write(x, S: int, iters: int):
    """P1e. ``tools/microbench_mosaic.py:134`` ``bench_hbm_row_write``
    (pallas_call :148): iteration t writes ``uint8(x + t)`` (x [1, W])
    into row ``t % S`` of a uint8 [S, W] output; rows no t reaches stay 0.
    On the card: plain 32-bit stores of 4 packed bytes, then
    ``__threadfence()`` and a block barrier per row (the TPU's DMA start
    and wait)."""
    dev = _device(x)
    if dev.type == "cpu":
        return bench_hbm_row_write_plain(x, S, iters)
    W = x.shape[-1]
    out = torch.zeros((S, W), dtype=torch.uint8, device=dev)
    _launch(bench_hbm_row_write, dev, "row_write", [_P, _P, _I, _I, _I],
            x.data_ptr(), out.data_ptr(), S, W, iters)
    return out


def bench_while_scalar_plain(x, iters: int, sync: bool = False):
    del sync  # a barrier changes the kernel's timing, not its result
    acc = x.clone()
    c = 0
    while c < iters:
        acc = acc + 1
        c += 1
    return acc


@_counted
def bench_while_scalar(x, iters: int, sync: bool = False):
    """P1f. ``tools/microbench_mosaic.py:167`` ``bench_while_scalar``
    (pallas_call :184): a while loop of ``iters`` rounds of ``acc += 1``
    on [8, M] kept in shared memory.  ``sync`` adds a block barrier per
    round on the card (the TPU loop has none; K1 pays one per phase)."""
    dev = _device(x)
    if dev.type == "cpu":
        return bench_while_scalar_plain(x, iters)
    out = torch.zeros_like(x)
    _launch(bench_while_scalar, dev, "while", [_P, _P, _I, _I, _I],
            x.data_ptr(), out.data_ptr(), x.numel(), iters, int(sync))
    return out


# ------------------------------------------------------- mosaic3 (P4b-e)

def dynamic_roll_plain(x, iters: int):
    acc = x
    M = x.shape[1]
    for _ in range(iters):
        sh = int(acc[0, 0]) & 0xFF
        acc = torch.roll(acc, sh % M, 1) + 1
    return acc


@_counted
def dynamic_roll(x, iters: int):
    """P4b. ``tools/microbench_mosaic3.py:22`` ``run_case`` (pallas_call
    :25), case 2: ``iters`` times ``acc = roll(acc, acc[0, 0] & 0xFF,
    axis 1) + 1`` on [8, 256], ``out[i] = acc[(i - sh) mod M]`` (the
    direction of ``pltpu.roll`` in the reference's interpret run)."""
    dev = _device(x)
    if x.dim() != 2:
        raise ValueError("dynamic_roll takes a 2-D x")
    if dev.type == "cpu":
        return dynamic_roll_plain(x, iters)
    out = torch.zeros_like(x)
    _launch(dynamic_roll, dev, "roll", [_P, _P, _I, _I, _I],
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], iters)
    return out


def lane_slice_plain(tab, starts):
    row = tab.reshape(-1)
    acc = torch.zeros(128, dtype=torch.int32, device=tab.device)
    for n in range(starts.numel()):
        b = min(max(int(starts.reshape(-1)[n]), 0), row.numel() - 128)
        acc = acc + row[b:b + 128]
    return acc.reshape(1, 128)


@_counted
def lane_slice(tab, starts):
    """P4c. ``tools/microbench_mosaic3.py:22`` ``run_case`` (pallas_call
    :25), case 3: ``acc += tab[0, s[n] : s[n] + 128]`` over the
    ``starts [1, iters]`` from a [1, NW] table (shared memory on the
    card)."""
    dev = _device(tab, starts)
    if dev.type == "cpu":
        return lane_slice_plain(tab, starts)
    out = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    _launch(lane_slice, dev, "lane_slice", [_P, _I, _P, _P, _I],
            tab.data_ptr(), tab.numel(), starts.data_ptr(), out.data_ptr(),
            starts.numel())
    return out


def sublane_slice_plain(tab, rows):
    acc = torch.zeros((2, 128), dtype=torch.int32, device=tab.device)
    for n in range(rows.numel()):
        r = min(max(int(rows.reshape(-1)[n]), 0), tab.shape[0] - 2)
        acc = acc + tab[r:r + 2]
    return acc


@_counted
def sublane_slice(tab, rows):
    """P4d. ``tools/microbench_mosaic3.py:22`` ``run_case`` (pallas_call
    :25), case 4: ``acc += tab[r[n] : r[n] + 2, :]`` over ``rows [1,
    iters]`` from [NR, 128] (256 KB at NR=512: global memory on the
    card)."""
    dev = _device(tab, rows)
    if tab.dim() != 2 or tab.shape[1] != 128:
        raise ValueError("sublane_slice takes a [NR, 128] table")
    if dev.type == "cpu":
        return sublane_slice_plain(tab, rows)
    out = torch.zeros((2, 128), dtype=torch.int32, device=dev)
    _launch(sublane_slice, dev, "sublane_slice", [_P, _I, _P, _P, _I],
            tab.data_ptr(), tab.shape[0], rows.data_ptr(), out.data_ptr(),
            rows.numel())
    return out


def refill_plain(tab, bases):
    row = tab.reshape(-1)
    smem = [int(b) for b in bases.reshape(-1)]
    out = torch.zeros((len(smem), 128), dtype=torch.int32, device=tab.device)
    for r, b in enumerate(smem):
        b = min(max(b, 0), row.numel() - 128)
        out[r] = row[b:b + 128]
    return out


@_counted
def refill(tab, bases):
    """P4e. ``tools/microbench_mosaic3.py:22`` ``run_case`` (pallas_call
    :25), case 5: the [WR, 1] bases go to SMEM scalars (shared memory on
    the card), then ``out[r] = tab[0, b[r] : b[r] + 128]``."""
    dev = _device(tab, bases)
    if dev.type == "cpu":
        return refill_plain(tab, bases)
    out = torch.zeros((bases.numel(), 128), dtype=torch.int32, device=dev)
    _launch(refill, dev, "refill", [_P, _I, _P, _P, _I],
            tab.data_ptr(), tab.numel(), bases.data_ptr(), out.data_ptr(),
            bases.numel())
    return out


# ------------------------------------------------------- chunk sweep (P5)

def _chunk_check(WR: int, CR: int, NR: int, chunked: bool) -> None:
    if WR < 4 or WR % 4 or (chunked and (CR < 4 or CR % 4 or CR > WR
                                         or NR < 1)):
        raise ValueError(f"chunk wants WR % 4 == 0 and, chunked, CR % 4 == "
                         f"0 with 4 <= CR <= WR and NR >= 1: WR={WR} "
                         f"CR={CR} NR={NR}")


def _alu(blks, c: int):
    """The transition-sized ALU block of microbench_chunk.py:41-51."""
    a, b_, c_, d, e, f, g = blks
    e1 = torch.maximum(a, b_) + c
    e2 = torch.maximum(c_, d) + 1
    f1 = torch.maximum(e, f) + 1
    f2 = torch.maximum(g, a) + 1
    z = torch.where(e1 >= e2, 1, 3)
    h = torch.maximum(torch.maximum(e1, e2), torch.maximum(f1, f2))
    z = torch.where(a + 1 >= h, 0, z)
    bits = ((e1 < e2).to(torch.int32) << 3) | z
    return h, e1, f1, e2, f2, bits.to(torch.int32)


def chunk_plain(WR: int, CR: int, T: int, NR: int, chunked: bool,
                device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    _chunk_check(WR, CR, NR, chunked)
    WRP, WR4 = WR + 8, WR // 4
    rings = [torch.full((WRP, 128), 3, dtype=torch.int32, device=device)
             for _ in range(7)]
    tops = [torch.full((WRP, 128), 1, dtype=torch.int32, device=device)
            for _ in range(5)]
    vb = torch.full((WRP, 128), 1, dtype=torch.int32, device=device)
    tb = torch.full((64, WR4, 128), INT_MIN, dtype=torch.int32, device=device)
    cr = CR if chunked else WR
    ld_rows = CR + 8 if chunked else WRP
    acc = 0
    for t in range(T):
        nc = -(-NR // CR) + (t & 1) if chunked else 1
        acc_t = 0
        for ci in range(nc):
            ro = ci * cr
            ld = min(max(ro, 0), WRP - ld_rows)
            st = min(max(ro, 0), WRP - cr)
            tbs = min(max(ro // 4, 0), WR4 - cr // 4)
            blks = [r[ld:ld + cr] for r in rings]
            h, e1, f1, e2, f2, bits = _alu(blks, t)
            for plane, v in zip(tops, (h, e1, f1, e2, f2)):
                plane[st:st + cr] = v
            vb[st:st + cr] = (vb[st:st + cr] << 1) & 0xFFFF
            p = bits.reshape(cr // 4, 4, 128)
            tb[t % 64, tbs:tbs + cr // 4] = (p[:, 0] | (p[:, 1] << 8)
                                             | (p[:, 2] << 16)
                                             | (p[:, 3] << 24))
            acc_t += int(h.max())
        acc = acc_t
    return (torch.full((1, 1), acc, dtype=torch.int32, device=device), tb)


@_counted
def chunk(WR: int, CR: int, T: int, NR: int, chunked: bool,
          device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """P5. ``tools/microbench_chunk.py:28`` ``build`` (pallas_call :111):
    T cycles of K1's sweep skeleton over [WR + 8, 128] planes, full (WR
    rows a cycle) or chunked (ceil(NR/CR) + (t & 1) chunks of CR rows).
    Per row 7 plane loads, the ALU block (:41-51), 5 stores and the vb
    shift; 4 rows' tb bytes packed per int32 (row 4k + j in byte j) into
    ``tb[t % 64, ro/4 : ro/4 + CR/4]``.  Returns (acc [1, 1]: the last
    cycle's sum of its chunks' max(h); tb [64, WR/4, 128]).  Slice starts
    clamp into their buffers (module docstring).  On the card: K1's
    512-thread block, the 13 planes in global memory."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return chunk_plain(WR, CR, T, NR, chunked, dev)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _chunk_check(WR, CR, NR, chunked)
    acc = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    tb = torch.full((64, WR // 4, 128), INT_MIN, dtype=torch.int32,
                    device=dev)
    planes = torch.empty((13, WR + 8, 128), dtype=torch.int32, device=dev)
    _launch(chunk, dev, "chunk", [_P, _P, _P] + [_I] * 5,
            acc.data_ptr(), tb.data_ptr(), planes.data_ptr(), WR, CR, T, NR,
            int(chunked))
    return acc, tb
