"""Tiny sizes of the configurations and traffic mixes that came after
``_tiny.py``, added to its tables on import (``wfabench/conftest.py``
imports this before any test module reads them, so that the tests
parametrized over every cell of BENCHMARK.json run these cells too).
Low-mem traffic takes step 32 here, so that pass 2 collapses at a few
checkpoints of a pair of a few kb."""

import _tiny

# mhc1m's shape at 2.4 kb: s about 135, four checkpoints
_tiny.CFG.setdefault("mhc1m", {"target_bp": 2400, "ref_s_cap": 512})
_tiny.TRAFFIC.setdefault("lowmem", {"step": 32})
_tiny.TRAFFIC.setdefault("lowmem1", {"step": 32})
