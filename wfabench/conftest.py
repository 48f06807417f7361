"""The tiny sizes of every cell, for the CPU tests of ``wfabench/tests``,
in place before any test module reads them (``tests/_tiny_lowmem.py``)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

import _tiny_lowmem  # noqa: E402,F401
