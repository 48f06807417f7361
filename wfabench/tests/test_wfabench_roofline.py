"""The roofline's counts against a hand computation, and the metric
readers on a made-up record."""

import pytest

import _tiny  # noqa: F401
from wfabench import harness, roofline


def test_work_by_hand():
    cells, tl, ql, s = [1000, 2000], [100, 100], [104, 96], [40, 50]
    # 2-bit sequences: ceil(204/4) + ceil(196/4) = 51 + 49; lanes: 2 x 128
    base = 100 + 256
    assert roofline.work("score", cells, tl, ql, s) == (3000 * 20, base)
    assert roofline.work("tb", cells, tl, ql, s) == (
        3000 * 34, base + 3000 + 8 * 90)
    assert roofline.work("seg", cells, tl, ql, s, step=16) == (
        3000 * 34, base + 3000 + 8 * 90 + 16 * (2 + 3))
    assert roofline.work("pass1", cells, tl, ql, s) == (3000 * 29, base)


def test_bound_and_share_by_hand():
    peak_ops = 132 * 64 * 1.98e9
    assert roofline.INT32_OPS_PER_S == pytest.approx(1.672704e13)
    ops, nb = 10 ** 9, 10 ** 6
    b = roofline.bound_s(ops, nb)
    assert b == pytest.approx(ops / peak_ops)          # operations bound
    assert roofline.bound_s(1, 10 ** 9) == pytest.approx(1e9 / 3.35e12)
    # a kernel that took twice the bound is at 50%
    assert roofline.share(ops, nb, 2 * b * 1e6) == pytest.approx(50.0)
    assert roofline.share(ops, nb, 0.0) is None


def rec(mode="score", events=(), calls=((0.0, 100.0), (100.0, 200.0))):
    return {"mode": mode, "step": 5000, "cards": 1, "calls": 4,
            "launches": {"K1": 4, "K2": 0, "K3": 0, "K4": 0, "W1": 4,
                         "W2": 0},
            "stretch": {"calls": list(calls), "events": list(events),
                        "host": [], "lo": 0.0, "hi": 200.0, "cards": [0]},
            "tl": [100], "ql": [100],
            "ref": {"s": [40], "n_iter": [10 ** 6], "n_iter_p1": None}}


def ev(name, a, b):
    return {"name": name, "dev": 0, "start": a, "end": b}


def test_readers_by_hand():
    r = rec(events=[ev("void wavefront_kernel<0, 1, true>(Params)", 10, 60),
                    ev("walk_warp_kernel(Params)", 150, 160)])
    assert harness.reader("idle_share")(r) == pytest.approx(70.0)
    assert harness.reader("host_s_per_call")(r) == pytest.approx(
        ((100 - 50) + (100 - 10)) / 2 / 1e6)
    assert harness.reader("launches_per_call")(r) == pytest.approx(2.0)
    assert harness.reader("walk_ms_per_call")(r) is None   # score mode
    # K1: 2 calls x 1e6 cells x 20 ops against 50 us of device time
    want = 100 * (2 * 2e7 / roofline.INT32_OPS_PER_S) / 50e-6
    assert harness.reader("k1_roofline.score")(r) == pytest.approx(want)
    assert harness.reader("k1_roofline.tb")(r) is None
    c = rec(mode="cigar", events=[ev("walk_warp_kernel", 0, 500),
                                  ev("chain_kernel", 500, 1000)])
    assert harness.reader("walk_ms_per_call")(c) == pytest.approx(0.5)
    empty = rec(events=[])
    for m in ("idle_share", "host_s_per_call", "k1_roofline.score"):
        assert harness.reader(m)(empty) is None
