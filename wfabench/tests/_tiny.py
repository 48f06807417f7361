"""Tiny sizes of the cells for CPU tests (the plain versions): the
configurations' shapes at a few kb; a low-mem traffic with a small step
(no cell runs low-mem yet; the harness and the reference support it) so
that pass 2 collapses at several checkpoints."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CFG = {"pairs100k": {"target_bp": 1200, "ref_s_cap": 512,
                     "lane_sub_step": 2}}
TRAFFIC = {"score": {}, "cigar": {}}
LOWMEM = {"mode": "lowmem", "step": 64}
SEED = 2**31 + 12345


def devices(cell):
    return ["cpu"] * int(cell["chips"])
