"""tools/multicard_smoke.py and the per-card launch counts on the CPU.

The script's phases a (one process, 4 mesh entries) and b (4 gloo ranks
of tools/mp_worker.py --multicard) run on 4 CPU entries at a few small
golden pairs: every check passes on the real results and fails on a
lane tampered with (its s, n_iter or CIGAR).  With fewer visible cards
than ``--cards`` the script refuses to run.  Tolerance: exact equality.
"""

import collections
import dataclasses
import json
import sys
import threading

import pytest
import torch

from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.parallel.batch import align_batch_sharded
from miniwfa_tpu_torch.parallel.mesh import make_mesh
from miniwfa_tpu_torch.tools import multicard_smoke as mc
from miniwfa_tpu_torch.utils.launches import count_launch

torch.set_num_threads(1)   # as in test_torch_chain.py

CPU_ARGS = ["--device", "cpu", "--cards", "4", "--set", "goldens",
            "--reps", "1"]


def _last(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_phases_pass_on_cpu_entries(capsys):
    rc = mc.main(CPU_ARGS + ["--phases", "ab"])
    out = capsys.readouterr().out
    assert rc == 0, out[-4000:]
    assert "FAIL" not in out
    assert _last(out) == {"ok": True, "cards": 4, "kind": "cpu",
                          "failures": []}
    for rank in range(4):
        assert f"ok   gloo rank {rank} of 4" in out
    for mode in ("score", "cigar", "lowmem"):
        assert f"ok   a {mode}: every lane's (s, n_iter, CIGAR) equals" in out


# lane 5: the second copy's second pair
TAMPER = {"s": lambda r: dataclasses.replace(r, s=r.s + 1),
          "n_iter": lambda r: dataclasses.replace(r, n_iter=r.n_iter + 1),
          "cigar": lambda r: r if r.cigar is None else dataclasses.replace(
              r, cigar=list(r.cigar[:-1]) + [r.cigar[-1] + 16])}
FAILS = {"s": ("every lane's s equals the goldens (failing lanes [5]",
               "bit for bit (failing lanes [5]"),
         "n_iter": ("bit for bit (failing lanes [5]",),
         "cigar": ("CIGAR md5s equal the goldens (failing lanes [5]",
                   "bit for bit (failing lanes [5]")}


@pytest.mark.parametrize("field", list(TAMPER))
def test_checks_fail_on_a_tampered_lane(monkeypatch, capsys, field):
    def tampered(pairs, opt, mesh):
        res = align_batch_sharded(pairs, opt, mesh)
        res[5] = TAMPER[field](res[5])
        return res

    monkeypatch.setattr(mc, "align_batch_sharded", tampered)
    rc = mc.main(CPU_ARGS + ["--phases", "a"])
    out = capsys.readouterr().out
    assert rc == 1, out[-4000:]
    last = _last(out)
    assert last["ok"] is False and last["failures"]
    fails = [line for line in out.splitlines() if "FAIL" in line]
    for want in FAILS[field]:
        assert any(want in line for line in fails), (want, fails)
    # only the tampered lane fails, in every mode it shows in
    modes = ("score", "cigar", "lowmem") if field != "cigar" \
        else ("cigar", "lowmem")
    for mode in modes:
        assert any(f"a {mode}:" in line for line in fails), (mode, fails)
    assert all("failing lanes [5])" in line for line in fails), fails


@pytest.mark.parametrize("available,visible,cards", [
    (False, 0, 4), (True, 1, 2), (True, 3, 4)])
def test_refuses_fewer_cards_than_asked(monkeypatch, capsys, available,
                                        visible, cards):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)

    def ran(*_, **__):
        raise AssertionError("a phase ran")

    monkeypatch.setattr(mc, "load_set", ran)
    monkeypatch.setattr(mc.subprocess, "run", ran)
    assert mc.main(["--cards", str(cards)]) == 2
    err = capsys.readouterr().err
    want = (f"{cards} cards asked for, {visible} visible" if available
            else "no CUDA device")
    assert want in err


@pytest.mark.parametrize("argv", [["--cards", "0"], ["--phases", "ax"],
                                  ["--phases", "c"], ["--reps", "0"]])
def test_refuses_bad_arguments_on_cpu(capsys, argv):
    assert mc.main(["--device", "cpu"] + argv) == 2
    assert "multicard_smoke:" in capsys.readouterr().err


def test_launches_counted_by_card_from_threads():
    def fn():
        pass

    fn.launches = 0
    fn.launches_by_card = collections.Counter()

    def bump(card):
        for _ in range(2000):
            count_launch(fn, card=card)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump, args=(k % 4,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == 32000
    assert fn.launches_by_card == {0: 8000, 1: 8000, 2: 8000, 3: 8000}


def test_card_walls_of_the_last_call(goldens):
    pairs = [(c["t"], c["q"]) for c in goldens["cases"][:6]
             if max(len(c["t"]), len(c["q"])) <= 256]
    align_batch_sharded(pairs, Options(), make_mesh(["cpu"] * 3))
    walls = align_batch_sharded.card_walls
    assert list(walls) == [torch.device("cpu")]
    assert walls[torch.device("cpu")] > 0


def test_cpu_wrappers_count_no_launch(goldens):
    """On the CPU the wrappers run their plain versions: no launch, and no
    card, is counted."""
    mc.reset_card_counts()
    pairs = [(c["t"], c["q"]) for c in goldens["cases"]
             if max(len(c["t"]), len(c["q"])) <= 256][:4]
    align_batch_sharded(pairs, Options(cigar=True, step=16),
                        make_mesh(["cpu"] * 2))
    assert mc.card_counts() == {}
