#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card(s), from the root of
a checkout:

    python3 wfabench/run.py --workload pairs100k-score --seed 7 \
        --seconds 40 --trace 0

Prints one JSON line (correct, attempted, failed, metrics, device; with
``--trace 1`` the per-layer metrics, the traced stretch's busy and
window seconds, and a breakdown).  Exits non-zero, with no result, when
no CUDA card (or fewer than the cell asks for) is visible, or when the
run loaded JAX or the JAX package.  See wfabench/harness.py.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# build and kernel caches live at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

from wfabench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0, time.perf_counter()))
