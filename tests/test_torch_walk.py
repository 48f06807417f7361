"""The port's plain CIGAR walker against the JAX package's walker.

Traceback buffers come from the JAX package's Pallas kernel in interpret
mode.  ``miniwfa_tpu.ops.traceback_device.walk_batch_on_device`` (plain
JAX, runs on the CPU) walks them in the kernel's packed layout;
``miniwfa_tpu_torch.ops.traceback_device.walk`` walks the same bytes in
the port's layout (``convert.tb_from_packed``) on CPU tensors, i.e. its
plain PyTorch version; the port's host walker ``traceback_walk`` is the
specification.  Tolerance: identical run lists, equal to the goldens.
"""

import json
import os

import numpy as np
import pytest
import torch

from miniwfa_tpu.ops import pack as jpack
from miniwfa_tpu.ops import traceback_device as jtbd
from miniwfa_tpu.ops import wavefront_kernel as jwk
from miniwfa_tpu_torch import Options, cigar as C, convert
from miniwfa_tpu_torch.models.traceback import traceback_walk
from miniwfa_tpu_torch.ops import pack
from miniwfa_tpu_torch.ops import traceback_device as tbd

torch.set_num_threads(1)   # as in test_torch_chain.py

WR, W, S_CAP = 8, 1024, 512

with open(os.path.join(os.path.dirname(__file__), "data",
                       "goldens.json")) as _f:
    _G = json.load(_f)
_IDX = {c["name"]: i for i, c in enumerate(_G["cases"])}

REGIMES = {"cigar": Options(cigar=True),
           "edit_cigar": Options(cigar=True).as_edit_distance(),
           "affine_cigar": Options(cigar=True).as_single_affine()}
CASES = [("cigar", n) for n in
         ["t3", "ins4", "mixed", "homopoly", "small7", "unrel5", "lower_n",
          "empty_t", "del4"]] + \
    [(r, n) for r in ("edit_cigar", "affine_cigar") for n in ("t3", "small44")]


@pytest.mark.parametrize("run,name", CASES)
def test_walkers_agree(run, name):
    opt = REGIMES[run]
    case = _G["cases"][_IDX[name]]
    t, q = case["t"].encode("latin1"), case["q"].encode("latin1")
    pens = (opt.x, opt.o1, opt.e1, opt.o2, opt.e2)
    cpw = 16 if jpack.can_pack2([t, q]) else 4
    spec = jwk.KSpec(B=1, WR=WR, S_CAP=S_CAP, x=opt.x, o1=opt.o1, e1=opt.e1,
                     o2=opt.o2, e2=opt.e2, mode=jwk.MODE_TB, cpw=cpw)
    anc = (len(q) - len(t)) // 2 - W // 2
    scal = np.zeros((1, jwk.SC_SEG + 2), np.int32)
    scal[0, :3] = (len(t), len(q), anc)
    row, tb_packed = jwk.get_kernel(spec, interpret=True).raw(
        scal, jwk.pack_table([t], cpw), jwk.pack_table([q], cpw))
    row = np.asarray(row)
    s, ls = int(row[0, jwk.O_S]), int(row[0, jwk.O_LS])
    assert row[0, jwk.O_DONE] == 1

    want = jtbd.walk_batch_on_device(tb_packed, [anc], [t], [q], [s], [ls],
                                     cpw, pens)[0]
    tb = torch.from_numpy(convert.tb_from_packed(np.asarray(tb_packed)))
    meta = torch.tensor([[anc, len(t), len(q), s, ls]], dtype=torch.int64)
    mx = max(len(t), len(q))
    runs, counts = tbd.walk(
        tb, meta, torch.from_numpy(pack.pack_words([t], cpw, mx)),
        torch.from_numpy(pack.pack_words([q], cpw, mx)), cpw, pens)
    got = tbd.to_cigars(runs, counts)[0]
    spec_walk = traceback_walk(opt, tb[0, :max(s, 1)].numpy(),
                               np.full(max(s, 1), anc, np.int32), 0, t, q,
                               s, ls)
    assert got == want == spec_walk
    assert C.to_string(got) == _G["runs"][run][_IDX[name]]["cigar"]


def test_walk_buffer_overflow_raises():
    """A corrupt table that walks past its run buffer raises."""
    runs = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError):
        tbd.to_cigars(runs, torch.tensor([-1], dtype=torch.int32))
