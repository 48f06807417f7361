"""mwf-torch — test-mwf-compatible command-line driver: exact modes
(score, high-mem and low-mem CIGAR), chaining (-u) and auto (-t).

Same flags and the same PAF-like 10/11-column TSV output as the reference
binary (main.c:29-83) and ``miniwfa_tpu/cli.py``:

    python -m miniwfa_tpu_torch.cli [options] <in1.fa> <in2.fa>

Reads the two (optionally gzipped) FASTA/FASTQ files in lockstep and aligns
record i of file 1 (target) against record i of file 2 (query).
"""

from __future__ import annotations

import getopt
import sys
import time

from . import Options
from . import cigar as C
from .models.auto import align_auto_batch
from .models.chain import align_chain_batch
from .models.exact import align_batch
from .ops import build
from .utils.io import read_fastx

USAGE = """Usage: python -m miniwfa_tpu_torch.cli [options] <in1.fa> <in2.fa>
Options:
  -c       generate CIGAR
  -u       heuristic chaining mode
  -t       auto mode: exact under a 100M-cell budget, else chaining
  -p INT   low-memory mode: checkpoint every INT scores (implies -c)
  -a       mimic affine gap
  -e       mimic edit distance
  -B INT   batch size for device dispatch [64]
  -T       true per-pair timing: dispatch one pair at a time
  -l INT   min gapless length for chain filtering [30]
  -f INT   max k-mer occurrence [2]
  -K       (accepted for compatibility; no allocator to disable)
  -d       debug logging
  --device DEV  torch device to run on [cuda]
  --prewarm  build every CUDA kernel (ops/build.py) before aligning, so
           that the first alignment does not wait for nvcc; a failed
           build fails the run
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(argv, "cKdeTp:autl:f:B:",
                                       ["device=", "prewarm"])
    except getopt.GetoptError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    opt = Options()
    batch_size = 64
    per_pair = False
    debug = False
    device = "cuda"
    prewarm = False
    align = align_batch
    for o, a in opts:
        if o == "-c":
            opt = opt.replace(cigar=True)
        elif o == "-p":
            opt = opt.replace(cigar=True, step=int(a))
        elif o == "-a":
            opt = opt.as_single_affine()
        elif o == "-e":
            opt = opt.as_edit_distance()
        elif o == "-l":
            opt = opt.replace(min_len=int(a))
        elif o == "-f":
            opt = opt.replace(max_occ=int(a))
        elif o == "-B":
            batch_size = int(a)
        elif o == "-T":
            per_pair = True
        elif o == "-d":
            debug = True
        elif o == "--device":
            device = a
        elif o == "--prewarm":
            prewarm = True
        elif o == "-u":
            align = align_chain_batch
        elif o == "-t":
            align = align_auto_batch
    if per_pair:
        batch_size = 1
    if len(args) < 2:
        print(USAGE, file=sys.stderr)
        return 1
    if prewarm:
        t0 = time.perf_counter()
        try:
            build.build()
        except RuntimeError as e:
            print(f"ERROR: --prewarm: {e}", file=sys.stderr)
            return 1
        print(f"P\tprewarmed {len(build.SOURCES)} specs in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    def flush(pending):
        if not pending:
            return
        # batched pairs share one device dispatch, so each pair's T line
        # reports the batch wall time amortized per pair
        t0 = time.perf_counter()
        results = align([(r1.seq, r2.seq) for r1, r2 in pending], opt,
                        device=device)
        dt = (time.perf_counter() - t0) / len(pending)
        for (r1, r2), r in zip(pending, results):
            if opt.cigar and r.cigar is not None:
                C.assert_cigar(opt, r.cigar, len(r1.seq), len(r2.seq), r.s)
            row = (f"{r1.name}\t{len(r1.seq)}\t0\t{len(r1.seq)}\t+\t"
                   f"{r2.name}\t{len(r2.seq)}\t0\t{len(r2.seq)}\t{r.s}")
            if opt.cigar:
                row += "\t" + (r.cigar_str or "")
            print(row, flush=True)
            if debug:
                ncig = len(r.cigar) if r.cigar is not None else 0
                print(f"D\t{r1.name}\t{r2.name}\ts={r.s}\tn_iter={r.n_iter}"
                      f"\tcigar_runs={ncig}", file=sys.stderr)
            print(f"T\t{r1.name}\t{r2.name}\t{dt:.3f}", file=sys.stderr)

    pending = []
    for r1, r2 in zip(read_fastx(args[0]), read_fastx(args[1])):
        pending.append((r1, r2))
        if len(pending) >= batch_size:
            flush(pending)
            pending = []
    flush(pending)
    return 0


if __name__ == "__main__":
    sys.exit(main())
