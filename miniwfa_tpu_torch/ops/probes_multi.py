"""Group P, the multi-lane probes: tools/microbench_multi_probe.py,
microbench_multi_probe2.py and microbench_multi_probe3.py (the questions
K4's Pallas lowering asked) as Hopper microbenchmarks.

Every probe takes x [G, R, L] int32 (the tools: G=4, R=64, L=128, x in
[0, 100)) and returns what its JAX function returns, a tensor or a tuple.
``<name>_plain`` is plain PyTorch on any device; ``<name>`` runs it for
CPU tensors and launches csrc/probes.cu's ``multi_kernel`` for CUDA ones
(one 512-thread block, G groups of 512/G threads each with its own named
barrier, the x tile in shared memory, the 3-slot rings in global memory),
counting the launch in ``<name>.launches``.  Names are the JAX
functions'; the two later files' ``f_a``... are ``multi2_f_a``... and
``multi3_f_a``...

Fact about the reference: ``microbench_multi_probe.py:102`` ``ring4``
fails in interpret mode (``ring[1][:, pl.ds(8, R), :]`` indexes a value
with ``pl.ds``); ``microbench_multi_probe2.py:77`` ``f_d`` is the fix and
computes what ``ring4`` meant, so ``ring4`` here computes ``f_d``'s
function (and is tested against it).
"""

from __future__ import annotations

import torch

from .probes import _I, _P, _counted, _device, _gather2d, _launch

SR = 8           # multi3's sub-window rows
NEG30 = -(1 << 30)
# the kernel's probe ids (csrc/probes.cu, enum MultiProbe)
(LANE_MASK, SHIFT3, RING4, BND, SUB, MIN_MASK, MAX_OUT, RING_WRITE, ANY_MASK,
 MAX_MIN, STACK, WHILE_G11, ADD_SCALAR, REGISTRY) = range(14)


def _multi(wrapper, probe: int, x, aux=None, n_s: int = 0,
           padded: bool = False):
    """Launch probe ``probe`` of the multi kernel on x [G, RX, L]
    (RX = R + 8 for the ring probes' padded input); returns out [G, R, L]
    and, when ``n_s``, the int32 [n_s] scalar output."""
    dev = _device(x) if aux is None else _device(x, aux)
    if x.dim() != 3:
        raise ValueError("the multi probes take x [G, R, L]")
    G, RX, L = x.shape
    R = RX - 8 if padded else RX
    out = torch.zeros((G, R, L), dtype=torch.int32, device=dev)
    s = torch.zeros(max(n_s, 1), dtype=torch.int32, device=dev)
    ring = (torch.zeros((3, G, RX, L), dtype=torch.int32, device=dev)
            if padded else None)
    _launch(wrapper, dev, "multi", [_I, _P, _P, _P, _P, _P] + [_I] * 4,
            probe, x.data_ptr(), 0 if aux is None else aux.data_ptr(),
            out.data_ptr(), s.data_ptr(),
            0 if ring is None else ring.data_ptr(), G, R, L, RX)
    return (out, s) if n_s else out


def _pad8(x):
    """jnp.pad(x, ((0, 0), (0, 8), (0, 0))): 8 zero rows after R."""
    return torch.nn.functional.pad(x, (0, 0, 0, 8)).contiguous()


def _lane(x, op):
    """Per-lane reduction (``torch.amin``/``amax``) of [G, R, L] to
    [G, 1, 1]."""
    return op(x.reshape(x.shape[0], -1), dim=1).reshape(-1, 1, 1)


# ------------------------------------------------ microbench_multi_probe.py

def gather3_plain(x, i):
    return torch.gather(x, 2, i)


@_counted
def gather3(x, i):
    """P6a. ``tools/microbench_multi_probe.py:34`` ``gather3``
    (pallas_call :35): ``take_along_axis(x, i, axis=2)`` on [G, R, L]
    (the shared gather kernel on [G*R, L])."""
    dev = _device(x, i)
    if dev.type == "cpu":
        return gather3_plain(x, i)
    G, R, L = x.shape
    return _gather2d(gather3, x.reshape(G * R, L), i.reshape(G * R, L), 1,
                     1, False).reshape(G, R, L)


def gather_flat_plain(x, i):
    G, R, L = x.shape
    return torch.gather(x.reshape(G * R, L), 1,
                        i.reshape(G * R, L)).reshape(G, R, L)


@_counted
def gather_flat(x, i):
    """P6b. ``tools/microbench_multi_probe.py:48`` ``gather_flat``
    (pallas_call :49): reshape to [G*R, L], gather along axis 1, reshape
    back."""
    dev = _device(x, i)
    if dev.type == "cpu":
        return gather_flat_plain(x, i)
    G, R, L = x.shape
    return _gather2d(gather_flat, x.reshape(G * R, L), i.reshape(G * R, L),
                     1, 1, False).reshape(G, R, L)


def lane_mask_plain(x):
    lo = _lane(x, torch.amin)
    m = x >= lo + 5
    o = torch.where(m, x, -1).to(torch.int32)
    red = _lane(torch.where(m, x, NEG30), torch.amax).reshape(-1)
    return o, red.to(torch.int32)


@_counted
def lane_mask(x):
    """P6c. ``tools/microbench_multi_probe.py:65`` ``lane_mask``
    (pallas_call :66): per-lane min ``lo``; ``o = where(x >= lo + 5, x,
    -1)``; ``s[g]`` = the lane's max of the kept values (-2**30 if none).
    Returns (o, s [G])."""
    if _device(x).type == "cpu":
        return lane_mask_plain(x)
    return _multi(lane_mask, LANE_MASK, x, n_s=x.shape[0])


def shift3_plain(x):
    G, R, L = x.shape
    left = torch.cat([torch.full((G, R, 1), -7, dtype=x.dtype,
                                 device=x.device), x[:, :, :-1]], 2)
    carry = torch.cat([torch.full((G, 1, L), -9, dtype=x.dtype,
                                  device=x.device), x[:, :-1, :]],
                      1)[:, :, L - 1:L]
    ii = torch.arange(L, device=x.device).reshape(1, 1, L)
    return torch.where(ii == 0, carry, left)


@_counted
def shift3(x):
    """P6d. ``tools/microbench_multi_probe.py:86`` ``shift3`` (pallas_call
    :87): a one-lane shift along L (fill -7) whose column 0 takes the
    previous row's last value (fill -9 on row 0)."""
    if _device(x).type == "cpu":
        return shift3_plain(x)
    return _multi(shift3, SHIFT3, x)


def ring4_plain(x):
    xp = _pad8(x)
    ring = torch.zeros((3,) + tuple(xp.shape), dtype=x.dtype,
                       device=x.device)
    for j in range(5):
        ring[j % 3] = xp + j
    return ring[1, :, 8:8 + x.shape[1], :].clone()


@_counted
def ring4(x):
    """P6e. ``tools/microbench_multi_probe.py:102`` ``ring4`` (pallas_call
    :103), which fails in interpret mode (module docstring): its function
    as ``microbench_multi_probe2.py:77`` ``f_d`` computes it.  x padded by
    8 zero rows; ``ring[j % 3] = xp + j`` for j < 5 in a [3, G, R+8, L]
    ring (global memory on the card); returns ``ring[1, :, 8:8+R]``."""
    if _device(x).type == "cpu":
        return ring4_plain(x)
    return _multi(ring4, RING4, _pad8(x), padded=True)


def bnd_plain(x, b):
    blv = b[0:x.shape[0], 0:1].reshape(-1, 1, 1)
    return torch.where(x >= blv, x, -3).to(torch.int32)


@_counted
def bnd(x, b):
    """P6f. ``tools/microbench_multi_probe.py:117`` ``bnd`` (pallas_call
    :118): ``where(x >= b[g, 0], x, -3)`` with b an [8, L] bound plane."""
    if b.dim() != 2 or b.shape[0] < x.shape[0] or b.shape[1] != x.shape[2]:
        raise ValueError("bnd takes a bound plane [>= G, L]")
    if _device(x, b).type == "cpu":
        return bnd_plain(x, b)
    return _multi(bnd, BND, x, aux=b)


def sub_plain(x):
    o = torch.empty_like(x)
    o[:, 0:8] = x[:, 16:24] * 2
    o[:, 8:] = x[:, 8:]
    return o


@_counted
def sub(x):
    """P6g. ``tools/microbench_multi_probe.py:131`` ``sub`` (pallas_call
    :132): ``o[:, 0:8] = 2 * x[:, 16:24]``, ``o[:, 8:] = x[:, 8:]``."""
    if _device(x).type == "cpu":
        return sub_plain(x)
    return _multi(sub, SUB, x)


# ----------------------------------------------- microbench_multi_probe2.py

def multi2_f_a_plain(x):
    lo = _lane(x, torch.amin)
    return torch.where(x >= lo + 5, x, -1).to(torch.int32)


@_counted
def multi2_f_a(x):
    """P7a. ``tools/microbench_multi_probe2.py:33`` ``f_a`` (pallas_call
    :34): keepdims per-lane min ``lo``; ``where(x >= lo + 5, x, -1)``."""
    if _device(x).type == "cpu":
        return multi2_f_a_plain(x)
    return _multi(multi2_f_a, MIN_MASK, x)


def multi2_f_b_plain(x):
    return x.clone(), _lane(x, torch.amax).reshape(-1)


@_counted
def multi2_f_b(x):
    """P7b. ``tools/microbench_multi_probe2.py:46`` ``f_b`` (pallas_call
    :47): ``o = x`` and the per-lane max to s [G]."""
    if _device(x).type == "cpu":
        return multi2_f_b_plain(x)
    return _multi(multi2_f_b, MAX_OUT, x, n_s=x.shape[0])


def multi2_f_c_plain(x):
    lo = torch.min(torch.min(x, dim=2, keepdim=True).values, dim=1,
                   keepdim=True).values
    return torch.where(x >= lo + 5, x, -1).to(torch.int32)


@_counted
def multi2_f_c(x):
    """P7c. ``tools/microbench_multi_probe2.py:63`` ``f_c`` (pallas_call
    :64): ``f_a`` with the min taken in two steps (axis 2, then 1); one
    group reduction on the card."""
    if _device(x).type == "cpu":
        return multi2_f_c_plain(x)
    return _multi(multi2_f_c, MIN_MASK, x)


@_counted
def multi2_f_d(x):
    """P7d. ``tools/microbench_multi_probe2.py:77`` ``f_d`` (pallas_call
    :78): the fixed ring4, ``ring4_plain``'s function."""
    if _device(x).type == "cpu":
        return ring4_plain(x)
    return _multi(multi2_f_d, RING4, _pad8(x), padded=True)


def multi2_f_e_plain(x):
    G, R, L = x.shape
    ring = torch.zeros((3, G, R + 8, L), dtype=x.dtype, device=x.device)
    for j in range(5):
        ring[j % 3, :, 8:8 + R] = x + j
    return ring[1, :, 8:8 + R].clone()


@_counted
def multi2_f_e(x):
    """P7e. ``tools/microbench_multi_probe2.py:95`` ``f_e`` (pallas_call
    :96): ``ring[j % 3, :, 8:8+R] = x + j`` for j < 5 (x the first R rows
    of the padded input); returns ``ring[1, :, 8:8+R]``."""
    if _device(x).type == "cpu":
        return multi2_f_e_plain(x)
    return _multi(multi2_f_e, RING_WRITE, _pad8(x), padded=True)


def multi2_f_f_plain(x):
    anyg = _lane(torch.where(x > 50, 1, 0), torch.amax)
    return torch.where(anyg > 0, x, 0).to(torch.int32)


@_counted
def multi2_f_f(x):
    """P7f. ``tools/microbench_multi_probe2.py:109`` ``f_f`` (pallas_call
    :110): per-lane any(x > 50) keeps the lane's x, else 0."""
    if _device(x).type == "cpu":
        return multi2_f_f_plain(x)
    return _multi(multi2_f_f, ANY_MASK, x)


# ----------------------------------------------- microbench_multi_probe3.py

def multi3_f_a_plain(x):
    red = _lane(x, torch.amax).reshape(-1)
    return x.clone(), torch.cat([red, red.min().reshape(1)]).to(torch.int32)


@_counted
def multi3_f_a(x):
    """P8a. ``tools/microbench_multi_probe3.py:42`` ``f_a`` (pallas_call
    :43): ``o = x``; s[0:G] the per-lane maxes, s[G] their min (a block
    barrier on the card: it spans the lanes)."""
    if _device(x).type == "cpu":
        return multi3_f_a_plain(x)
    return _multi(multi3_f_a, MAX_MIN, x, n_s=x.shape[0] + 1)


def multi3_f_b_plain(x):
    G, R, _ = x.shape
    offs = _lane(x, torch.amin).reshape(-1)
    o = x.clone()
    for g in range(G):
        a = min(max(int(offs[g]) % (R - SR), 0), R - SR)
        o[g, a:a + SR] = x[g, a:a + SR] * 2
    return o


@_counted
def multi3_f_b(x):
    """P8b. ``tools/microbench_multi_probe3.py:67`` ``f_b`` (pallas_call
    :68): per lane, the SR=8-row window at ``clip(min % (R - SR), 0, R -
    SR)`` is doubled in place of x."""
    if _device(x).type == "cpu":
        return multi3_f_b_plain(x)
    return _multi(multi3_f_b, STACK, x)


def multi3_f_c_plain(x):
    G = x.shape[0]
    t = 0
    done = torch.zeros(G, dtype=torch.int32, device=x.device)
    acc = torch.zeros(G, dtype=torch.int32, device=x.device)
    while t < 16 and int(done.min()) == 0:
        cnt = ((x + t) % 7 == 0).reshape(G, -1).sum(1).to(torch.int32)
        acc = acc + cnt
        done = torch.where(acc > 300, 1, done).to(torch.int32)
        t += 1
    return (x * 0 + acc.reshape(G, 1, 1)).to(torch.int32)


@_counted
def multi3_f_c(x):
    """P8c. ``tools/microbench_multi_probe3.py:92`` ``f_c`` (pallas_call
    :93): while t < 16 and some lane is not done: add the lane's count of
    ``(x + t) % 7 == 0`` to its acc, done once acc > 300; returns acc
    broadcast over [G, R, L]."""
    if _device(x).type == "cpu":
        return multi3_f_c_plain(x)
    return _multi(multi3_f_c, WHILE_G11, x)


def multi3_f_d_plain(s, x):
    return (x + s.reshape(-1, 1, 1)).to(torch.int32)


@_counted
def multi3_f_d(s, x):
    """P8d. ``tools/microbench_multi_probe3.py:109`` ``f_d`` (pallas_call
    :110): ``x + s[g]`` with s [G] the scalar-prefetch operand."""
    if s.numel() != x.shape[0]:
        raise ValueError("multi3_f_d takes one scalar per lane")
    if _device(s, x).type == "cpu":
        return multi3_f_d_plain(s, x)
    return _multi(multi3_f_d, ADD_SCALAR, x, aux=s)


def multi3_f_e_plain(x):
    G, _, L = x.shape
    lo = _lane(x, torch.amin).reshape(G, 1)
    row = torch.cat([lo.expand(G, L),
                     torch.zeros((8 - G, L), dtype=x.dtype,
                                 device=x.device)], 0)
    reg = torch.zeros((3, 8, L), dtype=x.dtype, device=x.device)
    for j in range(5):
        reg[j % 3] = row + j
    return (x + reg[1, 0:G, 0:1].reshape(G, 1, 1)).to(torch.int32)


@_counted
def multi3_f_e(x):
    """P8e. ``tools/microbench_multi_probe3.py:131`` ``f_e`` (pallas_call
    :132): per-lane mins into rows 0..G-1 of an [8, L] row (zeros below),
    written ``row + j`` into slot j % 3 of a [3, 8, L] registry for j < 5
    (shared memory on the card); returns ``x + reg[1, g, 0]``."""
    if _device(x).type == "cpu":
        return multi3_f_e_plain(x)
    return _multi(multi3_f_e, REGISTRY, x)
