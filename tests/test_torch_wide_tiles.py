"""The wide engine's launch parameters on the CPU: the chooser of the
variant and the tile (``ops/wavefront_wide.py::pick_tiles``) and the
wrapper's checks on a forced ``tile`` (n), ``batch`` (k) and ``variant``.

The tiled kernel itself runs only on a card (``tests/test_torch_cuda.py``,
marked ``cuda``); on the CPU every variant runs ``wide_plain``.  Shared
memory is counted in bytes, exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.ops import wavefront_kernel as wk
from miniwfa_tpu_torch.ops import wavefront_wide as ww

torch.set_num_threads(1)   # as in test_torch_chain.py

# an H100's opt-in shared memory a block (232,448 bytes) less 1 KB, more
# than the tiled kernel's static shared memory, which ww._smem_optin
# subtracts on the card
H100_SMEM = 232448 - 1024
PENS = dict(x=4, o1=4, e1=2, o2=15, e2=1)


def _spec(mode=wk.MODE_SCORE, **pens):
    p = dict(PENS, **pens)
    return wk.KSpec(W=1 << 20, S_CAP=1 << 16, mode=mode,
                    step=5000 if mode == wk.MODE_PASS1 else 0,
                    n_snap=8 if mode == wk.MODE_PASS1 else 0, **p)


@pytest.mark.parametrize("mode", [wk.MODE_SCORE, wk.MODE_PASS1])
@pytest.mark.parametrize("o2", [15, 40, 100])
def test_pick_tiles_fits_the_budget(mode, o2):
    """At the default penalties and at o2 = 40 and 100 the chooser takes
    the tiled variant with the largest tile of TILES that fits."""
    spec = _spec(mode, o2=o2)
    v, n, k = ww.pick_tiles(spec, H100_SMEM)
    assert v == "tile" and (n, k) in ww.TILES
    assert ww.tile_smem(spec, n, k) <= H100_SMEM
    for bigger in ww.TILES[:ww.TILES.index((n, k))]:
        assert ww.tile_smem(spec, *bigger) > H100_SMEM


def test_pick_tiles_default_tiles():
    """The default penalties (NP = 27 planes): up to 960 output slots and
    32 cycles a batch in both modes, 112 and 220 bytes a slot; a plane's
    row of 1,024 slots takes 1,036 (16-byte aligned copies and pads), the
    head (2 x 17 registry entries, 2 x 33 log entries) 100."""
    for mode, per_slot in ((wk.MODE_SCORE, 112), (wk.MODE_PASS1, 220)):
        spec = _spec(mode)
        assert ww.pick_tiles(spec, H100_SMEM) == ("tile", 960, 32)
        cap = ww.tile_cap(960, 32)
        assert cap == 1024 and spec.rings[0] == 17
        assert ww.tile_smem(spec, 960, 32) == per_slot * 1036 + 4 * 100


@pytest.mark.parametrize("mode", [wk.MODE_SCORE, wk.MODE_PASS1])
def test_pick_tiles_cycle_exactly_when_the_smallest_tile_does_not_fit(mode):
    """Past some max_pen not even the smallest tile of TILES fits: the
    chooser falls to "cycle" there and nowhere below it."""
    smallest = ww.TILES[-1]
    fits = [o2 for o2 in range(15, 4000, 5)
            if ww.tile_smem(_spec(mode, o2=o2), *smallest) <= H100_SMEM]
    edge = max(fits)
    assert 500 < edge < 2000   # PASS1 near 580, SCORE near 1145
    for o2 in (edge - 5, edge, edge + 5, edge + 500):
        spec = _spec(mode, o2=o2)
        v = ww.pick_tiles(spec, H100_SMEM)[0]
        assert (v == "cycle") == (ww.tile_smem(spec, *smallest)
                                  > H100_SMEM), o2


@pytest.mark.parametrize("pens", [dict(x=0), dict(e1=0), dict(e2=0)])
def test_pick_tiles_cycle_at_a_zero_age(pens):
    """A recurrence age of 0 (x, e1 or e2 = 0) takes the cycle variant."""
    assert ww.pick_tiles(_spec(**pens), H100_SMEM) == ("cycle", 0, 0)


@pytest.mark.parametrize("W", [1022, 1025, 16383])
def test_pick_tiles_cycle_at_a_window_of_partial_words(W):
    """The tiles copy plane rows in 16-byte words: a window that is no
    multiple of 4 slots takes the cycle variant, a multiple of 4 tiles."""
    spec = _spec()
    assert ww.pick_tiles(dataclasses.replace(spec, W=W),
                         H100_SMEM) == ("cycle", 0, 0)
    assert ww.pick_tiles(dataclasses.replace(spec, W=W + 4 - W % 4),
                         H100_SMEM)[0] == "tile"


def test_tile_cap_holds_both_edges():
    """A tile holds max(n, 4k) output slots and a halo of k a side."""
    assert ww.tile_cap(448, 32) == 512
    assert ww.tile_cap(32, 32) == 128 + 64
    assert ww.tile_cap(64, 7) == 64 + 14
    assert ww.tile_cap(32, 1) == 34


def _inputs(step=0, **pens):
    opt = Options(**dict(PENS, **pens), cigar=bool(step), step=step)
    mode = wk.MODE_PASS1 if step else wk.MODE_SCORE
    spec, lanes, tw, qw = exact.kernel_inputs(
        opt, mode, 512, 256, [b"ACGTACGTAAAC", b""], [b"ACGTTCGTAAC", b"A"])
    return spec, [torch.from_numpy(a) for a in (lanes, tw, qw)]


@pytest.mark.parametrize("kw", [
    dict(variant="warp"), dict(variant="cycle", tile=64),
    dict(variant="cycle", batch=8), dict(tile=0), dict(tile=-3),
    dict(tile=64.0), dict(batch=0), dict(batch=ww.K_MAX + 1),
    dict(batch="32")])
def test_wide_rejects_bad_forced_parameters(kw):
    spec, args = _inputs()
    st = ww.new_state(spec, args[0])
    with pytest.raises(ValueError):
        ww.wide(spec, *args, st, torch.full((2,), 100, dtype=torch.int64),
                **kw)


@pytest.mark.parametrize("kw", [dict(variant="tile"), dict(tile=32),
                                dict(batch=7)])
def test_wide_rejects_tiles_at_a_zero_age(kw):
    spec, args = _inputs(x=0)
    st = ww.new_state(spec, args[0])
    with pytest.raises(ValueError):
        ww.wide(spec, *args, st, torch.full((2,), 100, dtype=torch.int64),
                **kw)


@pytest.mark.parametrize("kw", [dict(variant="tile"), dict(tile=32),
                                dict(batch=7)])
def test_wide_rejects_tiles_at_a_window_of_partial_words(kw):
    opt = Options(**PENS)
    spec, lanes, tw, qw = exact.kernel_inputs(
        opt, wk.MODE_SCORE, 510, 256, [b"ACGTACGTAAAC"], [b"ACGTTCGTAAC"])
    args = [torch.from_numpy(a) for a in (lanes, tw, qw)]
    st = ww.new_state(spec, args[0])
    with pytest.raises(ValueError, match="W % 4"):
        ww.wide(spec, *args, st, torch.full((1,), 100, dtype=torch.int64),
                **kw)


@pytest.mark.parametrize("step", [0, 4])
@pytest.mark.parametrize("kw", [dict(), dict(variant="tile"),
                                dict(variant="cycle"),
                                dict(tile=32, batch=1), dict(tile=64),
                                dict(batch=ww.K_MAX)])
def test_wide_takes_forced_parameters_on_the_cpu(kw, step):
    """Accepted forced parameters change nothing on the CPU: the plain
    version runs, equal to wide_plain, and no launch is counted."""
    spec, args = _inputs(step=step)
    lim = torch.full((2,), 1 << 20, dtype=torch.int64)
    before = ww.wide.launches
    st, pst = ww.new_state(spec, args[0]), ww.new_state(spec, args[0])
    got = ww.wide(spec, *args, st, lim, **kw)
    assert ww.wide.launches == before
    assert torch.equal(got, ww.wide_plain(spec, *args, pst, lim))
    assert torch.equal(st.planes, pst.planes)
    assert np.array_equal(got[:, wk.O_DONE].numpy(), [1, 1])
