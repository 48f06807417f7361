"""ctypes bridge to the native C++ host runtime (``native/mwfrt.cpp``).

The port uses three of its entry points, all behind ops/kmer.py: the
k-mer coder (``ksim``, the exact driver's sizing estimate, and the chain
mode's anchors), the match pairing and the longest increasing
subsequence of the anchor chain.  The library is compiled with ``g++``
into ``build/miniwfa_tpu_torch/`` at first use; when no compiler is
present ops/kmer.py computes the same results with numpy (seconds at
Mb scale, so a timed run needs the library).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "mwfrt.cpp")
_SO = os.path.join(_ROOT, "build", "miniwfa_tpu_torch", "libmwfrt.so")

_LOCK = threading.Lock()
_STATE = {"tried": False, "lib": None}


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, _SO)
    return True


def _load():
    with _LOCK:
        if _STATE["tried"]:
            return _STATE["lib"]
        _STATE["tried"] = True
        if not os.path.exists(_SRC):
            return None
        fresh = os.path.exists(_SO) and \
            os.path.getmtime(_SO) >= os.path.getmtime(_SRC)
        if not fresh and not _build():
            return None
        lib = ctypes.CDLL(_SO)
        lib.mwf_kmer_codes.restype = ctypes.c_int64
        lib.mwf_kmer_codes.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64)]
        lib.mwf_match_pairs.restype = ctypes.c_int64
        lib.mwf_match_pairs.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,   # ts, tn
            ctypes.c_char_p, ctypes.c_int64,   # qs, qn
            ctypes.c_int32, ctypes.c_int32,    # k, max_occ
            ctypes.POINTER(ctypes.c_uint64),   # scratch [2*(tn+qn)]
            ctypes.POINTER(ctypes.c_uint64),   # out [cap]
            ctypes.c_int64]                    # cap
        lib.mwf_lis_u64.restype = ctypes.c_int64
        lib.mwf_lis_u64.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64)]
        _STATE["lib"] = lib
        return lib


def available() -> bool:
    return _load() is not None


def kmer_codes(seq: bytes, rid: int, k: int,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """(kmer<<1|rid)<<32|end_pos codes (reference mg_fc_kmer semantics),
    written to the front of ``out`` (contiguous uint64, len(seq) at
    least) when it is given."""
    lib = _load()
    if out is None:
        out = np.empty(max(len(seq), 1), dtype=np.uint64)
    elif (out.dtype != np.uint64 or not out.flags.c_contiguous
          or out.size < len(seq)):
        raise ValueError(f"kmer_codes needs a contiguous uint64 out of "
                         f"{len(seq)} codes at least")
    n = lib.mwf_kmer_codes(
        seq, len(seq), rid, k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out[:n]


def match_pairs_u64(ts: bytes, qs: bytes, k: int, max_occ: int) -> np.ndarray:
    """Sorted pos_t<<32|pos_q match pairs (reference mg_chain first
    half, miniwfa.c:741-765)."""
    lib = _load()
    nn = len(ts) + len(qs)
    scratch = np.empty(max(2 * nn, 2), dtype=np.uint64)
    cap = max(max_occ * max_occ * nn // 2 + 16, 2 * nn + 16)
    out = np.empty(cap, dtype=np.uint64)
    m = lib.mwf_match_pairs(
        ts, len(ts), qs, len(qs), k, max_occ,
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), cap)
    if m < 0:
        raise RuntimeError("mwf_match_pairs output capacity exceeded")
    return out[:m].copy()


def lis_u64(a: np.ndarray) -> np.ndarray:
    """Indices of the longest strictly increasing subsequence of ``a``
    (reference mg_lis_64, miniwfa.c:678-697)."""
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.uint64)
    out = np.zeros(a.size, dtype=np.int64)
    n = lib.mwf_lis_u64(
        a.size, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out[:n]
