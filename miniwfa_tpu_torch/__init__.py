"""miniwfa_tpu_torch — the WFA aligner in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper.

The port of ``miniwfa_tpu`` (JAX / Pallas on TPU), which stays the
reference.  Modules mirror that package's names.  It serves the exact
score, high-memory CIGAR and low-memory stripe modes (``align_exact`` /
``align_batch``, models/exact.py), the chaining heuristic
(``align_chain``, models/chain.py) and the auto mode (``align_auto``,
models/auto.py).  On a CUDA device they run through the wavefront kernel
(csrc/wavefront.cu), the gaps kernel for the chain's small gap fills
(csrc/gaps.cu) and the CIGAR walker (csrc/walk.cu); on the CPU through
their plain PyTorch versions.
"""

from .options import Options
from .models.auto import align_auto
from .models.chain import align_chain
from .models.exact import Result, align_exact

__all__ = ["Options", "Result", "align_exact", "align_chain", "align_auto"]
