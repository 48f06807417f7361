"""Real gloo jobs of the port's sharded path on the CPU.

Each rank (miniwfa_tpu_torch/tools/mp_worker.py) holds its ``cpu``
entries of the global mesh (two a rank in a 2-rank job, one a rank in a
4-rank job over 10 pairs, not a multiple of 4, and over 3, fewer than
the ranks) and checks its own results: every score on every rank,
CIGARs on its own lanes and None elsewhere, in score, CIGAR and low-mem
mode.  When one rank's ``align_batch`` raises, both ranks raise the same
error and neither hangs.
"""

import os
import re
import socket
import subprocess
import sys

import pytest

from miniwfa_tpu_torch.parallel.batch import lane_blocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _job(*extra, nproc=2):
    """Run every rank to its end (300 s each at most); returns their
    (exit code, output)."""
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "miniwfa_tpu_torch.tools.mp_worker", addr,
         str(nproc), str(rank), "--device", "cpu", *extra], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.mark.parametrize("nproc,entries,pairs", [(2, 2, 12), (4, 1, 10),
                                                  (4, 1, 3)])
def test_two_process_gloo(nproc, entries, pairs):
    blocks = lane_blocks(pairs, nproc * entries)
    res = _job("--entries", str(entries), "--pairs", str(pairs), nproc=nproc)
    for rank, (rc, out) in enumerate(res):
        mine = sum(len(b) for b in blocks[rank * entries:
                                         (rank + 1) * entries])
        assert rc == 0, f"rank {rank}:\n{out[-3000:]}"
        assert f"MP_OK pid={rank} local_cigars={mine}" in out, out[-3000:]


def test_one_rank_failure_raises_on_every_rank():
    res = _job("--fail-rank", "1")
    errors = []
    for rank, (rc, out) in enumerate(res):
        assert rc != 0, f"rank {rank}:\n{out[-3000:]}"
        errors.append(re.findall(r"RuntimeError: sharded alignment failed.*",
                                 out))
    assert errors[0] and errors[0] == errors[1], errors
    assert "injected failure on rank 1" in res[1][1]
