"""K1's cluster size (CTAs per lane) on the CPU.

``pick_cluster`` takes the largest C whose co-resident clusters hold the
whole batch, from the counts the card's occupancy calculator gives
(``cluster_counts`` on a card); ``launch`` checks C before anything is
built or launched.
"""

import pytest
import torch

from miniwfa_tpu_torch import Options
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.ops import wavefront_kernel as wk

torch.set_num_threads(1)   # as in test_torch_chain.py

# counts as an H100's uneven GPCs may give them: 14 clusters of 8, not 16
UNEVEN = {16: 7, 8: 14, 4: 33, 2: 66, 1: 132}
EVEN = {16: 8, 8: 16, 4: 33, 2: 66, 1: 132}


@pytest.mark.parametrize("B,counts,want", [
    (16, UNEVEN, 4),     # 14 clusters of 8 cannot start 16 lanes at once
    (16, EVEN, 8),
    (1, UNEVEN, 16),
    (7, UNEVEN, 16),
    (8, UNEVEN, 8),
    (14, UNEVEN, 8),
    (33, UNEVEN, 4),
    (34, UNEVEN, 2),
    (66, UNEVEN, 2),
    (66, {**UNEVEN, 2: 65}, 1),
    (67, UNEVEN, 1),
    (2048, UNEVEN, 1),   # the chain's gap fills: one block per lane
    (4, {16: 0, 8: 4, 4: 8, 2: 16, 1: 132}, 8),   # no cluster of 16 fits
    (4, {16: 0, 8: 0, 4: 0, 2: 0, 1: 132}, 1),
])
def test_pick_cluster(B, counts, want):
    assert wk.pick_cluster(B, counts) == want


def _inputs():
    spec, lanes, tw, qw = exact.kernel_inputs(Options(), wk.MODE_SCORE, 512,
                                              64, [b"ACGTACGTAC"],
                                              [b"ACGAACGTTAC"])
    return spec, [torch.from_numpy(a) for a in (lanes, tw, qw)]


@pytest.mark.parametrize("G,C", [(1, 0), (1, 3), (1, 32), (1, -2),
                                 (2, 2), (4, 8), (8, 16)])
def test_launch_rejects_bad_cluster_size(G, C):
    """C outside {1, 2, 4, 8, 16}, or C > 1 with the multi-lane kernel,
    raises before anything is built or launched."""
    spec, args = _inputs()
    with pytest.raises(ValueError, match="C"):
        wk.launch(spec, *args, None, G, C)
