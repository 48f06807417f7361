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
import functools
from typing import Tuple

import torch

from . import build

INT_MIN = -(1 << 31)
_P, _I = ctypes.c_void_p, ctypes.c_int
# GPU cycles of the spin queued before a timed launch (~100 us), so that
# the host's own launch cost falls inside the spin, not the timing
SPIN_CYCLES = 200_000
# the dynamic shared memory a block may opt in to on Hopper (csrc SMEM_CAP;
# the kernels of csrc/probes.cu have no static shared memory)
SMEM_OPTIN = 232448


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


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _counted(fn):
    fn.launches = 0
    return fn


@_counted
def empty(dev) -> None:
    """The empty kernel (``mwf_probe_empty``), launched and timed as a
    probe is: a launch's fixed cost, the floor that every one-launch probe
    is read against (``tools/microbench.py``).  No probe's wrapper: it
    counts its launches here only.  Nothing to run on the CPU."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        _launch(empty, dev, "empty", [])


DEP_FLOOR_WORDS = 8192  # the dependent-load floor's table (32 KB, in L2)
_DEP_FLOOR = {}


@_counted
def dep_floor(dev) -> None:
    """The dependent-load floor (``mwf_probe_dep_floor``), launched and
    timed as a probe is: one warp loads 32 indices, one word of a
    ``DEP_FLOOR_WORDS`` table at each, and stores the 32 words: one chain
    of what the one-shot gathers (P3, P6a, P6b) and the refill (P4e) do,
    the floor they are read against (``tools/microbench.py``).  No
    probe's wrapper: it counts its launches here only.  Its table,
    indices (seed 0) and output are made once a card.  Nothing to run on
    the CPU."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _DEP_FLOOR:
        g = torch.Generator().manual_seed(0)
        _DEP_FLOOR[key] = tuple(t.to(dev) for t in (
            torch.randint(0, 1 << 20, (DEP_FLOOR_WORDS,), generator=g,
                          dtype=torch.int32),
            torch.randint(0, DEP_FLOOR_WORDS, (32,), generator=g,
                          dtype=torch.int32),
            torch.zeros(32, dtype=torch.int32)))
    tab, idx, out = _DEP_FLOOR[key]
    _launch(dep_floor, dev, "dep_floor", [_P, _P, _P], tab.data_ptr(),
            idx.data_ptr(), out.data_ptr())


# ------------------------------------------------------------------ gathers

GATHER_THREADS = 256        # threads a block of the gather loop
GATHER_CHAINS = (1, 2, 4, 8)  # independent chains a thread
GATHER_MIN_SHARE = 32       # elements a block at least (a warp's)
# blocks an SM holds at once: its threads' limit, and its shared memory
# (Hopper: SMEM_OPTIN plus the 1 KB each block reserves)
GATHER_BLOCKS_SM = 2048 // GATHER_THREADS
BLOCK_RESERVED = 1024
SM_SMEM = SMEM_OPTIN + BLOCK_RESERVED


@functools.lru_cache(maxsize=None)
def gather_plan(Rt: int, Mt: int, Ri: int, Mi: int, axis: int, sms: int,
                smem: int) -> Tuple[int, int, int]:
    """(blocks, per, chains) of the gather loop on tab [Rt, Mt], idx [Ri,
    Mi] along ``axis`` on a card of ``sms`` SMs and ``smem`` bytes of
    shared memory a block.  A group is ``per`` table rows (axis 1) or a
    strip of ``per`` columns of every row (axis 0), staged whole by each
    of the ``blocks / groups`` blocks that share its idx elements.

    An op costs an SM its elements' loads, so the plan takes the (per,
    splits) whose busiest SM runs the fewest warps of elements (the blocks
    it holds at once x a block's share), then the fewest staged bytes an
    SM, the fewest staged a block, the fewest blocks; the grid reaches
    ``sms`` blocks wherever the shares can stay a warp or more.
    ``chains`` is the fewest chains a thread (of ``GATHER_CHAINS``) that
    cover a share in one pass."""
    units, unit = (Rt, Mt) if axis == 1 else (Mt, Rt)
    each = Mi if axis == 1 else Ri  # idx elements of one unit
    if 4 * unit > smem:
        raise ValueError(f"one table {'row' if axis == 1 else 'column'} of "
                         f"{unit} int32 does not fit {smem} bytes of shared "
                         f"memory")
    best = None
    # the least per of each group count: a larger one only adds work
    pers = sorted({-(-units // g) for g in range(1, units + 1)})
    for per in [p for p in pers if p <= smem // (4 * unit)]:
        groups = -(-units // per)
        n = per * each
        top = max(1, n // GATHER_MIN_SHARE)
        lo = min(top, -(-sms // groups))
        staged = 4 * per * unit
        held = min(GATHER_BLOCKS_SM, SM_SMEM // (staged + BLOCK_RESERVED))
        for splits in range(lo, top + 1):
            k = -(-groups * splits // sms)  # blocks the busiest SM holds
            if k > held:
                break
            warps = -(-n // (splits * 32))  # of a block's share
            cost = (k * warps, k * staged, per, groups * splits)
            if best is None or cost < best[0]:
                best = (cost, groups * splits, per, -(-n // splits))
    _, blocks, per, share = best
    chains = next((c for c in GATHER_CHAINS
                   if c * GATHER_THREADS >= share), GATHER_CHAINS[-1])
    return blocks, per, chains


def check_gather_plan(plan, Rt: int, Mt: int, axis: int, smem: int) -> None:
    """Raise ValueError unless ``plan`` is one the gather loop takes: whole
    groups of ``per`` rows or columns, the same number of blocks a group,
    a chain count of ``GATHER_CHAINS``, the staged group within ``smem``
    bytes (the kernel's own checks, made before a launch)."""
    blocks, per, chains = plan
    units, unit = (Rt, Mt) if axis == 1 else (Mt, Rt)
    if not 1 <= per <= units or blocks < 1 or blocks % -(-units // per):
        raise ValueError(f"gather plan {plan}: per in [1, {units}] and "
                         f"blocks a multiple of the groups")
    if chains not in GATHER_CHAINS:
        raise ValueError(f"gather plan {plan}: chains in {GATHER_CHAINS}")
    if 4 * per * unit > smem:
        raise ValueError(f"gather plan {plan}: {4 * per * unit} bytes of "
                         f"shared memory past {smem}")


ONCE_MAX_CTAS = 65535   # CTAs of one gather (csrc ONCE_MAX_CTAS)
ONCE_MAX_ELEMS = (1 << 31) - 1  # idx elements of one gather (32-bit math)


def once_plan(Ri: int, Mi: int, sms: int) -> Tuple[int, int]:
    """(ctas, threads) of one gather into idx [Ri, Mi] on a card of ``sms``
    SMs.  A thread owns a unit: 4 outputs of a row where Mi % 4 == 0 (one
    16-byte index load and store), else one.  The plan takes the whole
    card: ``sms`` CTAs (more, of 1024 threads, past 1024 units an SM; past
    ``ONCE_MAX_CTAS`` a thread loops) of the fewest whole warps that give
    every unit a thread of its own, so each SM queues as few scattered
    table loads as the card allows; CTAs past the units exit at once.  On
    an H100 (PERF.md §6) it was the fastest of the 16 plans timed, or
    within 0.07 µs of it, at each of the tools' eight shapes (P3, P6a,
    P6b): CTAs of 8 warps or more ran up to 0.7 µs slower, and a plan
    whose threads loop pays ≈0.4 µs more for every pass."""
    units = Ri * Mi // 4 if Mi % 4 == 0 else Ri * Mi
    ctas = min(ONCE_MAX_CTAS, max(sms, -(-units // MAX_THREADS)))
    return ctas, min(MAX_THREADS, 32 * max(1, -(-units // (32 * ctas))))


def check_once_plan(plan) -> None:
    """Raise ValueError unless one gather takes ``plan`` (the C entry's
    own checks, made before a launch): 1 to ``ONCE_MAX_CTAS`` CTAs of
    whole warps up to 1024 threads."""
    ctas, threads = plan
    if (not 1 <= ctas <= ONCE_MAX_CTAS or not 32 <= threads <= MAX_THREADS
            or threads % 32):
        raise ValueError(f"gather_once plan {plan}: 1 to {ONCE_MAX_CTAS} "
                         f"CTAs of whole warps up to {MAX_THREADS} threads")


def check_gather_shape(Rt: int, Mt: int, Ri: int, Mi: int, axis: int,
                       lim: int, once: bool) -> None:
    """Raise ValueError unless the gather entries take these shapes (their
    own checks, made before a launch): non-empty tab [Rt, Mt] and idx [Ri,
    Mi] that agree off ``axis`` (0 or 1), a modulus lim >= 1, and for one
    gather (``once``) fewer than 2^31 idx elements."""
    if (min(Rt, Mt, Ri, Mi, lim) < 1 or axis not in (0, 1)
            or (axis == 1 and Ri != Rt) or (axis == 0 and Mi != Mt)):
        raise ValueError(f"gather of idx [{Ri}, {Mi}] from tab [{Rt}, "
                         f"{Mt}] along axis {axis} (lim {lim}): non-empty, "
                         f"the same length off the axis")
    if once and Ri * Mi > ONCE_MAX_ELEMS:
        raise ValueError(f"one gather of {Ri * Mi} elements: at most "
                         f"{ONCE_MAX_ELEMS}")


def _gather2d(wrapper, tab, idx, axis: int, iters: int, chain: bool,
              lim: int = 1, plan=None) -> torch.Tensor:
    """Launch the shared gather kernels on 2-D ``tab`` and ``idx``: a loop
    (iters > 1) on ``plan``, by default ``gather_plan``'s for the card;
    one gather on ``plan``, by default ``once_plan``'s."""
    dev = _device(tab, idx)
    if tab.dim() != 2 or idx.dim() != 2:
        raise ValueError("the gather kernel takes 2-D tab and idx")
    (Rt, Mt), (Ri, Mi) = tab.shape, idx.shape
    check_gather_shape(Rt, Mt, Ri, Mi, axis, lim, iters == 1)
    if iters == 1:
        if plan is None:
            plan = once_plan(Ri, Mi, _sms(dev))
        check_once_plan(plan)
    else:
        if plan is None:
            plan = gather_plan(Rt, Mt, Ri, Mi, axis, _sms(dev), SMEM_OPTIN)
        check_gather_plan(plan, Rt, Mt, axis, SMEM_OPTIN)
    out = torch.zeros(idx.shape, dtype=torch.int32, device=dev)
    args = (tab.data_ptr(), Rt, Mt, idx.data_ptr(), Ri, Mi, out.data_ptr(),
            axis)
    if iters == 1:
        _launch(wrapper, dev, "gather_once", [_P, _I, _I, _P, _I, _I, _P]
                + [_I] * 5, *args, int(chain), lim, *plan)
    else:
        _launch(wrapper, dev, "gather", [_P, _I, _I, _P, _I, _I, _P]
                + [_I] * 8, *args, iters, int(chain), lim, 0, *plan)
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

MAX_THREADS = 1024  # threads a block


def row_write_plan(S: int, W: int, sms: int) -> Tuple[int, int]:
    """(blocks, threads) of the row write into [S, W] on a card of ``sms``
    SMs.  A row is cut into segments of 16 bytes a thread (one segment up
    to W = 16 KB); block b owns segment b % segs of the rows r with r % rb
    == b // segs (rb = blocks // segs row classes).  rb is the fewest
    classes, at most ``sms // segs`` and S, that give the busiest block no
    more rows than the most classes would."""
    quads = -(-W // 16)
    threads = min(MAX_THREADS, 32 * -(-quads // 32))
    segs = -(-quads // threads)
    most = max(1, min(S, sms // segs))
    rb = -(-S // -(-S // most))
    return rb * segs, threads


def check_row_write_plan(plan, S: int, W: int) -> None:
    """Raise ValueError unless the row write takes ``plan`` (the kernel's
    own checks, made before a launch): whole warps up to 1024 threads,
    blocks a multiple of the segments a row and at most S row classes."""
    blocks, threads = plan
    if not (32 <= threads <= MAX_THREADS and threads % 32 == 0):
        raise ValueError(f"row write plan {plan}: threads a multiple of 32 "
                         f"up to {MAX_THREADS}")
    segs = -(-W // (16 * threads))
    if blocks < 1 or blocks % segs or blocks // segs > S:
        raise ValueError(f"row write plan {plan}: blocks a multiple of the "
                         f"{segs} segments a row, at most {S} row classes")


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
    On the card every SM writes rows (``row_write_plan``): a block runs
    every iteration of its rows in order, 16 bytes a thread by one plain
    store, with no fence and no barrier (the TPU's DMA start and wait per
    row become stores kept in flight; a byte of a row is always written
    by the same thread, so its writes land in order)."""
    dev = _device(x)
    if dev.type == "cpu":
        return bench_hbm_row_write_plain(x, S, iters)
    return _row_write(x, S, iters)


def _row_write(x, S: int, iters: int, plan=None) -> torch.Tensor:
    """Launch the row write on ``plan``, by default ``row_write_plan``'s
    for the card; shapes it does not take are refused by the kernel."""
    dev = x.device
    W = x.shape[-1]
    if plan is None:
        plan = row_write_plan(S, W, _sms(dev))
    check_row_write_plan(plan, S, W)
    out = torch.zeros((S, W), dtype=torch.uint8, device=dev)
    _launch(bench_hbm_row_write, dev, "row_write", [_P, _P] + [_I] * 5,
            x.data_ptr(), out.data_ptr(), S, W, iters, *plan)
    return out


# ------------------------------------------------------------- while loop

WHILE_PER = 4  # elements a thread: one 16-byte access (csrc WHILE_PER)


def while_plan(n: int, sms: int) -> Tuple[int, int, int]:
    """(blocks, threads, per) of the while loop on n elements on a card of
    ``sms`` SMs: ``per`` = 4 elements a thread, the fewest warps a block
    (up to 32) that put every warp on an SM of its own where the warps
    allow, and the blocks that cover n (the last one partial)."""
    warps = -(-n // (32 * WHILE_PER))
    threads = 32 * min(MAX_THREADS // 32, -(-warps // sms))
    return -(-n // (threads * WHILE_PER)), threads, WHILE_PER


def check_while_plan(plan, n: int) -> None:
    """Raise ValueError unless the while loop takes ``plan`` (the kernel's
    own checks): ``WHILE_PER`` elements a thread, whole warps up to 1024
    threads, exactly the blocks that cover n."""
    blocks, threads, per = plan
    if (per != WHILE_PER or not 32 <= threads <= MAX_THREADS
            or threads % 32 or blocks != -(-n // (threads * per))):
        raise ValueError(f"while plan {plan} for n={n}: per = {WHILE_PER}, "
                         f"threads a multiple of 32 up to {MAX_THREADS}, "
                         f"ceil(n / (threads * per)) blocks")


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
    on [8, M].  On the card the state is spread over every SM
    (``while_plan``), each block's slice in its shared memory, and every
    round loads and stores all of it (16 bytes a thread); ``sync`` adds a
    block barrier per round (the TPU loop has none; K1 pays one per
    phase)."""
    dev = _device(x)
    if dev.type == "cpu":
        return bench_while_scalar_plain(x, iters)
    return _while(x, iters, sync)


def _while(x, iters: int, sync: bool, plan=None) -> torch.Tensor:
    """Launch the while loop on ``plan``, by default ``while_plan``'s for
    the card."""
    dev = x.device
    if plan is None:
        plan = while_plan(x.numel(), _sms(dev))
    check_while_plan(plan, x.numel())
    out = torch.zeros_like(x)
    _launch(bench_while_scalar, dev, "while", [_P, _P] + [_I] * 6,
            x.data_ptr(), out.data_ptr(), x.numel(), iters, int(sync), *plan)
    return out


# ------------------------------------------------------- mosaic3 (P4b-e)

ROLL_PERS = (1, 2, 4, 8, 16, 32)  # elements a thread (csrc roll_kernel<PER>)
ROLL_PER = 4  # the elements a thread roll_plan aims at (fastest at [8, 256])


def roll_plan(R: int, M: int) -> Tuple[int, int]:
    """(threads, per) of the dynamic roll on [R, M] in its one CTA.  Where
    M <= 1024 the threads are a multiple of M, rp rows at a time, so that
    a thread's elements (one every ``threads``) share a column: rp =
    ceil(R / ROLL_PER) rows, at most 1024 // M (the tool's [8, 256]: 512
    threads of 4 elements).  Else, or where that leaves more than 32
    elements a thread, 1024 threads.  ``per`` is the fewest of
    ``ROLL_PERS`` that cover R * M.  A shape whose double buffer does not
    fit a block's shared memory raises ValueError, as the kernel refuses
    it."""
    n = R * M
    if R < 1 or M < 1 or 8 * n > SMEM_OPTIN:
        raise ValueError(f"dynamic roll [{R}, {M}]: R, M >= 1 and a double "
                         f"buffer of {8 * n} bytes within {SMEM_OPTIN}")
    threads = MAX_THREADS
    if M <= MAX_THREADS:
        rp = min(MAX_THREADS // M, -(-R // ROLL_PER))
        if -(-R // rp) <= ROLL_PERS[-1]:
            threads = rp * M
    per = next(p for p in ROLL_PERS if p * threads >= n)
    return threads, per


def check_roll_plan(plan, R: int, M: int) -> None:
    """Raise ValueError unless the roll takes ``plan`` (the kernel's own
    checks, made before a launch): ``per`` of ``ROLL_PERS``, 1 to 1024
    threads, threads x per >= R * M."""
    threads, per = plan
    if (per not in ROLL_PERS or not 1 <= threads <= MAX_THREADS
            or threads * per < R * M):
        raise ValueError(f"roll plan {plan} for [{R}, {M}]: per in "
                         f"{ROLL_PERS}, 1 to {MAX_THREADS} threads, "
                         f"threads * per >= {R * M}")


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
    direction of ``pltpu.roll`` in the reference's interpret run).  On the
    card one CTA (``roll_plan``), the tile double-buffered in its shared
    memory, a thread's column in registers, one barrier a round."""
    dev = _device(x)
    if x.dim() != 2:
        raise ValueError("dynamic_roll takes a 2-D x")
    if dev.type == "cpu":
        return dynamic_roll_plain(x, iters)
    return _roll(x, iters)


def _roll(x, iters: int, plan=None) -> torch.Tensor:
    """Launch the roll on ``plan``, by default ``roll_plan``'s."""
    R, M = x.shape
    if plan is None:
        plan = roll_plan(R, M)
    check_roll_plan(plan, R, M)
    out = torch.zeros_like(x)
    _launch(dynamic_roll, x.device, "roll", [_P, _P] + [_I] * 5,
            x.data_ptr(), out.data_ptr(), R, M, iters, *plan)
    return out


# ------------------------------------------- dynamic slices (P4c, P4d)

SLICE_MAX_THREADS = 512   # threads a CTA (csrc SLICE_MAX_THREADS)
SLICE_MAX_CTAS = 1024     # CTAs a launch (csrc SLICE_MAX_CTAS)
SLICE_MIN_ITERS = 128     # iterations a CTA at least (timed: PERF.md §6)
SLICE_LANE_MAX_NW = SMEM_OPTIN // 4   # P4c's row in one block's smem


def slice_plan(iters: int, sms: int) -> Tuple[int, int]:
    """(ctas, threads) of a dynamic slice's ``iters`` summed iterations on
    a card of ``sms`` SMs: contiguous ranges of at least
    ``SLICE_MIN_ITERS`` iterations a CTA, at most one CTA an SM (one CTA
    at the tool's 200, 32 at 4096, one an SM at 100000), each of
    ``SLICE_MAX_THREADS`` threads.  Both were the fastest or within 0.3 µs
    of it at every count an H100 timed, 0 to 100000 (PERF.md §6): fewer
    threads stage P4c's row slower, a split of fewer iterations pays more
    for the sum across CTAs (≈1 µs) than it saves."""
    return max(1, min(sms, iters // SLICE_MIN_ITERS)), SLICE_MAX_THREADS


def check_slice_plan(plan) -> None:
    """Raise ValueError unless the slice kernels take ``plan`` (the C
    entries' own checks, made before a launch): 1 to ``SLICE_MAX_CTAS``
    CTAs of whole warps up to ``SLICE_MAX_THREADS`` threads."""
    ctas, threads = plan
    if (not 1 <= ctas <= SLICE_MAX_CTAS or not 32 <= threads
            <= SLICE_MAX_THREADS or threads % 32):
        raise ValueError(f"slice plan {plan}: 1 to {SLICE_MAX_CTAS} CTAs "
                         f"of whole warps up to {SLICE_MAX_THREADS} "
                         f"threads")


_SLICE_SCRATCH = {}


def _slice_scratch(fn: str, dev: torch.device, W: int) -> torch.Tensor:
    """Slice probe ``fn``'s ticket (word 0) and cross-CTA sum (W words from
    word 4) on the current stream of ``dev``: zeroed once when made, and
    left at zero by the last CTA of every launch."""
    key = (fn, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _SLICE_SCRATCH:
        _SLICE_SCRATCH[key] = torch.zeros(4 + W, dtype=torch.int32,
                                          device=dev)
    return _SLICE_SCRATCH[key]


def _slice(wrapper, fn: str, tab, width: int, idx, W: int, out_shape,
           plan=None) -> torch.Tensor:
    """Launch slice probe ``fn`` (its table ``width`` words or rows wide)
    on ``plan``, by default ``slice_plan``'s for the card; every word of
    out is written by the launch."""
    dev = tab.device
    iters = idx.numel()
    if plan is None:
        plan = slice_plan(iters, _sms(dev))
    check_slice_plan(plan)
    out = torch.empty(out_shape, dtype=torch.int32, device=dev)
    scratch = _slice_scratch(fn, dev, W)
    _launch(wrapper, dev, fn, [_P, _I, _P, _P, _I, _I, _I, _P],
            tab.data_ptr(), width, idx.data_ptr(), out.data_ptr(), iters,
            *plan, scratch.data_ptr())
    return out


def lane_slice_plain(tab, starts):
    row = tab.reshape(-1)
    acc = torch.zeros(128, dtype=torch.int32, device=tab.device)
    for n in range(starts.numel()):
        b = min(max(int(starts.reshape(-1)[n]), 0), row.numel() - 128)
        acc = acc + row[b:b + 128]
    return acc.reshape(1, 128)


def check_lane_slice(NW: int) -> None:
    """Raise ValueError unless P4c's kernel takes a row of NW words: 128
    up to what one block's shared memory holds."""
    if not 128 <= NW <= SLICE_LANE_MAX_NW:
        raise ValueError(f"lane_slice row of {NW} words: 128 to "
                         f"{SLICE_LANE_MAX_NW}")


@_counted
def lane_slice(tab, starts):
    """P4c. ``tools/microbench_mosaic3.py:22`` ``run_case`` (pallas_call
    :25), case 3: ``acc += tab[0, s[n] : s[n] + 128]`` over the
    ``starts [1, iters]`` from a [1, NW] table.  On the card the
    iterations are cut over CTAs and warps (``slice_plan``), each CTA
    with the row in its shared memory, and summed once in the launch."""
    dev = _device(tab, starts)
    if dev.type == "cpu":
        return lane_slice_plain(tab, starts)
    return _lane_slice(tab, starts)


def _lane_slice(tab, starts, plan=None) -> torch.Tensor:
    check_lane_slice(tab.numel())
    return _slice(lane_slice, "lane_slice", tab, tab.numel(), starts, 128,
                  (1, 128), plan)


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
    iters]`` from [NR, 128] (256 KB at NR=512: read through L1/L2 on the
    card).  On the card the iterations are cut over CTAs and warps
    (``slice_plan``), a thread's 4 columns of both rows by two 16-byte
    loads, and summed once in the launch."""
    dev = _device(tab, rows)
    if tab.dim() != 2 or tab.shape[1] != 128:
        raise ValueError("sublane_slice takes a [NR, 128] table")
    if dev.type == "cpu":
        return sublane_slice_plain(tab, rows)
    return _sublane_slice(tab, rows)


def _sublane_slice(tab, rows, plan=None) -> torch.Tensor:
    if tab.shape[0] < 2:
        raise ValueError(f"sublane_slice table of {tab.shape[0]} rows: "
                         f"at least 2")
    return _slice(sublane_slice, "sublane_slice", tab, tab.shape[0], rows,
                  256, (2, 128), plan)


def refill_plain(tab, bases):
    row = tab.reshape(-1)
    smem = [int(b) for b in bases.reshape(-1)]
    out = torch.zeros((len(smem), 128), dtype=torch.int32, device=tab.device)
    for r, b in enumerate(smem):
        b = min(max(b, 0), row.numel() - 128)
        out[r] = row[b:b + 128]
    return out


REFILL_MAX_WARPS = 32     # warps a CTA (csrc REFILL_MAX_WARPS)
REFILL_MAX_CTAS = 65535   # CTAs a launch (csrc REFILL_MAX_CTAS)


def refill_plan(WR: int, sms: int) -> Tuple[int, int]:
    """(ctas, warps a CTA) of the refill of WR rows on a card of ``sms``
    SMs: a row a warp, one warp a CTA on as many SMs as there are rows,
    up to ``sms``, then more warps a CTA (up to 32), then rows a warp.
    On an H100 (PERF.md §6) the plans took the tool's 32 rows within 0.2
    µs of each other, one CTA of 32 warps among the slowest; at 132 rows
    a CTA an SM ran 1.2 µs faster than any plan of 32 warps in all, whose
    warps take rows in turn."""
    ctas = max(1, min(WR, sms))
    return ctas, max(1, min(REFILL_MAX_WARPS, -(-WR // ctas)))


def check_refill_plan(plan) -> None:
    """Raise ValueError unless the refill takes ``plan`` (the C entry's own
    checks, made before a launch): 1 to ``REFILL_MAX_CTAS`` CTAs of 1 to
    ``REFILL_MAX_WARPS`` warps."""
    ctas, warps = plan
    if not (1 <= ctas <= REFILL_MAX_CTAS and 1 <= warps <= REFILL_MAX_WARPS):
        raise ValueError(f"refill plan {plan}: 1 to {REFILL_MAX_CTAS} CTAs "
                         f"of 1 to {REFILL_MAX_WARPS} warps")


def check_refill(NW: int, WR: int) -> None:
    """Raise ValueError unless the refill takes a table of NW words and WR
    rows (the C entry's own checks): NW >= 128, WR >= 1."""
    if NW < 128 or WR < 1:
        raise ValueError(f"refill of {WR} rows from {NW} words: NW >= 128 "
                         f"and WR >= 1")


@_counted
def refill(tab, bases):
    """P4e. ``tools/microbench_mosaic3.py:22`` ``run_case`` (pallas_call
    :25), case 5: the [WR, 1] bases go to SMEM scalars, then ``out[r] =
    tab[0, b[r] : b[r] + 128]``, b clamped into [0, NW - 128].  On the
    card a row is a warp's (``refill_plan``): each lane reads the row's
    base itself and issues its 4 loads of the row before its stores."""
    dev = _device(tab, bases)
    if dev.type == "cpu":
        return refill_plain(tab, bases)
    return _refill(tab, bases)


def _refill(tab, bases, plan=None) -> torch.Tensor:
    """Launch the refill on ``plan``, by default ``refill_plan``'s for the
    card."""
    dev = tab.device
    NW, WR = tab.numel(), bases.numel()
    check_refill(NW, WR)
    if plan is None:
        plan = refill_plan(WR, _sms(dev))
    check_refill_plan(plan)
    out = torch.empty((WR, 128), dtype=torch.int32, device=dev)
    _launch(refill, dev, "refill", [_P, _I, _P, _P] + [_I] * 3,
            tab.data_ptr(), NW, bases.data_ptr(), out.data_ptr(), WR, *plan)
    return out


# ------------------------------------------------------- chunk sweep (P5)

CHUNK_ROUND = 32             # chunks one cluster exchange combines
CHUNK_CLUSTERS = (8, 16)     # cluster sizes chunk_plan tries, in order


def chunk_smem(WR: int, C: int) -> int:
    """Shared-memory bytes of a CTA of the sweep at width WR on a cluster
    of C CTAs (csrc ``chunk_words``): the 13 planes of its 128 / C lanes,
    a lane's WR + 8 rows padded to an odd number of 16-byte groups, 3
    mbarriers, its chunk maxima of two rounds and CTA 0's exchange slots
    of three."""
    return 4 * (13 * (128 // C) * ((WR + 8) | 4) + 8 + 2 * CHUNK_ROUND
                + 3 * CHUNK_ROUND * C)


def chunk_plan(WR: int, smem: int) -> Tuple[int, int]:
    """(C, lanes a CTA) of the sweep at width WR: the first cluster size of
    ``CHUNK_CLUSTERS`` whose CTAs hold their lanes' planes in ``smem``
    bytes; a WR that fits none raises ValueError."""
    for C in CHUNK_CLUSTERS:
        if chunk_smem(WR, C) <= smem:
            return C, 128 // C
    raise ValueError(f"chunk: the planes of WR={WR} fit no cluster of "
                     f"{CHUNK_CLUSTERS} CTAs in {smem} bytes a CTA")


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
    clamp into their buffers (module docstring).  On the card: one
    thread-block cluster (``chunk_plan``), each CTA holding its lanes' 13
    planes in shared memory, a cycle's chunks side by side and one
    cluster exchange of their maxima a round."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return chunk_plain(WR, CR, T, NR, chunked, dev)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _chunk_check(WR, CR, NR, chunked)
    return _launch_chunk(WR, CR, T, NR, chunked, *chunk_plan(WR, SMEM_OPTIN),
                         dev)


def _launch_chunk(WR: int, CR: int, T: int, NR: int, chunked: bool, C: int,
                  lanes: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the sweep on one cluster of C CTAs of ``lanes`` lanes each
    (a power of two C <= 16, lanes = 128 / C); a plan whose planes the
    card's CTAs cannot hold is refused by the kernel and raises."""
    if C not in (1, 2, 4, 8, 16) or lanes != 128 // C:
        raise ValueError(f"chunk plan C={C} lanes={lanes}: C a power of two "
                         f"up to 16, lanes = 128 / C")
    acc = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    tb = torch.full((64, WR // 4, 128), INT_MIN, dtype=torch.int32,
                    device=dev)
    _launch(chunk, dev, "chunk", [_P, _P] + [_I] * 7, acc.data_ptr(),
            tb.data_ptr(), WR, CR, T, NR, int(chunked), C, lanes)
    return acc, tb
