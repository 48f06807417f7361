"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` holds kernels and one plain C entry point per
kernel that launches it on a given stream and returns
``cudaGetLastError()``.  ``nvcc`` compiles a source into
``build/miniwfa_tpu_torch/lib<name>.so``, keyed by a hash of the source,
the shared ``csrc/*.cuh`` headers, ``NVCC_FLAGS`` and ``nvcc --version``
(kept beside it in ``lib<name>.key``): a change to any of them rebuilds
it.  Without an ``nvcc``, libraries built earlier (each with its key) are
loaded as they are.  No PyTorch header is included, so a build takes
seconds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from typing import Dict, Iterable, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "miniwfa_tpu_torch")
SOURCES = ("wavefront", "walk", "gaps", "wavefront_wide", "probes")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "miniwfa_tpu_torch are compiled from csrc/ at first use")
    return path


def _paths(name: str):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _key(name: str, nvcc: str, version: str) -> str:
    """Hash of what ``lib<name>.so`` is built from: the source, every
    shared header, the flags, the compiler and its version."""
    h = hashlib.sha256()
    for f in [_paths(name)[0],
              *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        h.update(os.path.basename(f).encode() + b"\0")
        with open(f, "rb") as fh:
            h.update(fh.read())
    h.update("\0".join([*NVCC_FLAGS, nvcc, version]).encode())
    return h.hexdigest()


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale source, one ``nvcc`` per source, all started
    together.  Returns the compiler output (``-Xptxas=-v`` register and
    shared-memory report) of each source that was compiled.  With no
    ``nvcc`` the sources are not checked: if every library was built
    before, they are used as they are (and a note says so), else it
    raises."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    names = list(names)
    try:
        nvcc = _nvcc()
    except RuntimeError:
        if all(os.path.exists(p) for n in names
               for p in (_paths(n)[1], _paths(n)[1][:-3] + ".key")):
            print(f"miniwfa_tpu_torch: no nvcc; using the libraries built "
                  f"before in {BUILD_DIR} unchecked", file=sys.stderr)
            return {}
        raise
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    procs = {}
    for name in names:
        src, so = _paths(name)
        key = _key(name, nvcc, version)
        kfile = so[:-3] + ".key"
        if os.path.exists(so) and os.path.exists(kfile):
            with open(kfile) as f:
                if f.read().strip() == key:
                    continue
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (tmp, so, kfile, key, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = {}
    for name, (tmp, so, kfile, key, proc) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
        os.replace(tmp, so)
        with open(kfile, "w") as f:
            f.write(key + "\n")
        logs[name] = out
    return logs


def load(name: str, fn: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``fn`` of ``csrc/<name>.cu``, built if needed,
    with its argument types declared (pointers and the stream as
    ``c_void_p``, so none is cut to 32 bits)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _LIBS[name] = lib
    f = getattr(lib, fn)
    f.restype = ctypes.c_int
    f.argtypes = list(argtypes)
    return f
