"""The opcodes of a kernel's SASS in one of the port's built libraries.

    python -m miniwfa_tpu_torch.tools.sass KERNEL [--lib probes]

Builds the library (``ops/build.py``) and disassembles it with the CUDA
toolkit's ``cuobjdump -sass``.  For every function whose name holds
KERNEL it prints the count of each opcode (with its modifiers, e.g.
``LDG.E.128.CONSTANT``) and, for each loop (a backward branch to a label),
the opcodes of the loop's body in order.  It shows what an instruction
bound assumes: which instructions one iteration of a probe's loop issues.
Exit 2 without ``cuobjdump``, 1 when no function matches.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List

from ..ops import build

_FUNC = re.compile(r"^\s*Function : (\S+)")
_LABEL = re.compile(r"^\s*(\.L_\w+):")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
# a branch's target: a label, or an address (older cuobjdump)
_TARGET = re.compile(r"`\((\.L_\w+)\)|BRA\s+(?:`\()?0x([0-9a-f]+)")


def cuobjdump() -> str:
    path = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(path):
        raise FileNotFoundError("cuobjdump not found (PATH or "
                                "$CUDA_HOME/bin)")
    return path


def functions(sass: str) -> Dict[str, List[str]]:
    """Each function's lines of ``cuobjdump -sass`` output, by its
    (mangled) name."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)
    return out


def opcode(insn: str) -> str:
    """The opcode of one instruction, its guard predicate dropped."""
    toks = insn.split()
    if toks and toks[0].startswith("@"):
        toks = toks[1:]
    return toks[0] if toks else ""


def loops(lines: List[str]) -> List[List[str]]:
    """The opcodes of each loop body: the instructions from a label (or
    address) to a branch back to it, the branch included."""
    at, insns, bodies = {}, [], []
    for line in lines:
        m = _LABEL.match(line)
        if m:
            at[m.group(1)] = len(insns)
            continue
        m = _INSN.search(line)
        if not m:
            continue
        at[int(m.group(1), 16)] = len(insns)
        insns.append(m.group(2))
        t = _TARGET.search(m.group(2))
        if not t or "BRA" not in opcode(m.group(2)):
            continue
        dest = t.group(1) or int(t.group(2), 16)
        if dest in at:  # seen already: a branch back
            bodies.append([opcode(i) for i in insns[at[dest]:]])
    return bodies


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel")
    ap.add_argument("--lib", default="probes", choices=build.SOURCES)
    a = ap.parse_args(argv)
    try:
        tool = cuobjdump()
    except FileNotFoundError as e:
        print(f"sass: {e}", file=sys.stderr)
        return 2
    build.build([a.lib])
    lib = os.path.join(build.BUILD_DIR, f"lib{a.lib}.so")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    found = {n: ls for n, ls in functions(sass).items() if a.kernel in n}
    for name, lines in found.items():
        ops = [opcode(m.group(2)) for m in map(_INSN.search, lines) if m]
        print(f"{name}: {len(ops)} instructions")
        for op, n in collections.Counter(ops).most_common():
            print(f"  {n:5d} {op}")
        for k, body in enumerate(loops(lines)):
            print(f"  loop {k} ({len(body)}): {' '.join(body)}")
    if not found:
        print(f"sass: no function of lib{a.lib}.so holds {a.kernel!r}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
