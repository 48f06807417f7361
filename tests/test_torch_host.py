"""The port's host modules against their JAX-package twins, on seeded
inputs: options, cigar, FASTA/FASTQ reading, word packing, the k-mer
similarity and the driver's bucket sizing.  Plus: the port imports no JAX,
asks for a CUDA device honestly, and its CLI prints the reference TSV."""

import gzip
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import miniwfa_tpu.cigar as jcigar
import miniwfa_tpu.models.exact as jexact
import miniwfa_tpu.options as joptions
from miniwfa_tpu.ops import kmer as jkmer
from miniwfa_tpu.ops import pack as jpack
from miniwfa_tpu.ops import traceback_device as jtbd
from miniwfa_tpu.ops import wavefront_kernel as jwk
from miniwfa_tpu.utils import io as jio
from miniwfa_tpu_torch import Options, cigar as C, convert
from miniwfa_tpu_torch.models import exact
from miniwfa_tpu_torch.ops import kmer, pack
from miniwfa_tpu_torch.utils import io, native

OPTS = [Options(), Options().as_edit_distance(), Options().as_single_affine(),
        Options(x=6, o1=5, e1=3, o2=20, e2=1, max_s=100)]


def _jopt(o):
    return joptions.Options(**{f: getattr(o, f) for f in (
        "x", "o1", "e1", "o2", "e2", "cigar", "step", "max_s", "max_iter",
        "kmer", "max_occ", "min_len")})


@pytest.mark.parametrize("i", range(len(OPTS)))
def test_options_match(i):
    o, j = OPTS[i], _jopt(OPTS[i])
    assert o.max_pen == j.max_pen
    assert [o.gap_cost(n) for n in range(-1, 40)] == \
        [j.gap_cost(n) for n in range(-1, 40)]
    assert _jopt(o.as_edit_distance()) == j.as_edit_distance()
    assert _jopt(o.as_single_affine()) == j.as_single_affine()


def _random_cigar(rng):
    out = []
    for _ in range(int(rng.integers(1, 30))):
        C.push(out, int(rng.choice([1, 2, 7, 8])), int(rng.integers(1, 50)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_cigar_matches(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        cig = _random_cigar(rng)
        text = C.to_string(cig)
        assert text == jcigar.to_string(cig)
        assert C.from_string(text) == jcigar.from_string(text) == cig
        for o in OPTS:
            assert C.cigar_score(o, cig) == jcigar.cigar_score(_jopt(o), cig)
        a, b = list(cig), list(cig)
        extra = _random_cigar(rng)
        C.extend(a, extra)
        jcigar.extend(b, extra)
        assert a == b


def test_assert_cigar_rejects():
    opt = Options()
    C.assert_cigar(opt, C.from_string("2=1X"), 3, 3, 4, b"ACG", b"ACT")
    for bad in ("3=", "2=1X1I"):
        with pytest.raises(AssertionError):
            C.assert_cigar(opt, C.from_string(bad), 3, 3, 4, b"ACG", b"ACT")


def test_read_fastx_matches(tmp_path):
    fa = tmp_path / "a.fa"
    fa.write_bytes(b">r1 first\nACGT\nAC\n>r2\n\n>r3 x y\nTTTT\n")
    fq = tmp_path / "b.fq.gz"
    with gzip.open(fq, "wb") as f:
        f.write(b"@q1 c\nACGT\n+\nIIII\n@q2\nAC\n+\n##\n")
    for path in (fa, fq):
        got = [(r.name, r.comment, r.seq, r.qual)
               for r in io.read_fastx(str(path))]
        want = [(r.name, r.comment, r.seq, r.qual)
                for r in jio.read_fastx(str(path))]
        assert got == want and got


def _random_seqs(seed, n, alphabet=b"ACGT", lo=0, hi=300):
    rng = np.random.default_rng(seed)
    return [rng.choice(np.frombuffer(alphabet, np.uint8),
                       int(rng.integers(lo, hi))).tobytes()
            for _ in range(n)]


_NT2 = np.zeros(256, dtype=np.uint32)
_NT2[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)


def _scatter_pack_words(seqs, cpw, length=None):
    """The port's first packer, frozen: uint32 codes by one masked
    scatter, then ``cpw`` strided planes ORed into the words."""
    bits = 2 if cpw == 16 else 8
    lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
    if length is None:
        length = int(lens.max(initial=0))
    nw = pack.n_words(length, cpw)
    codes = np.zeros((len(seqs), nw * cpw), dtype=np.uint32)
    raw = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    codes[np.arange(nw * cpw) < lens[:, None]] = \
        _NT2[raw] if cpw == 16 else raw
    v = codes.reshape(len(seqs), nw, cpw)
    w = np.zeros((len(seqs), nw), dtype=np.uint32)
    for j in range(cpw):
        w |= v[:, :, j] << np.uint32(bits * j)
    return w.view(np.int32)


# (cpw, rows, shortest, longest + 1, alphabet, length beyond the longest
# row); more than pack._ROW_COPY_MAX rows take the masked scatter
PACK_CASES = [
    pytest.param(16, 6, 0, 300, b"ACGT", 0, id="16-ACGT"),
    pytest.param(4, 6, 0, 300, b"ACGTNacgt", 0, id="4-ACGTNacgt"),
    pytest.param(16, 1, 1, 300, b"ACGT", 0, id="16-one-row"),
    pytest.param(4, 1, 1, 300, b"ACGTNacgt", 0, id="4-one-row"),
    pytest.param(16, 16, 20000, 40001, b"ACGT", 0, id="16-16x40kb"),
    pytest.param(4, 16, 20000, 40001, b"ACGTUacgtu", 0, id="4-16x40kb"),
    pytest.param(16, 4096, 0, 128, b"ACGT", 0, id="16-4096x127"),
    pytest.param(4, 4096, 0, 128, b"ACGTNacgt", 0, id="4-4096x127"),
    pytest.param(16, 7, 0, 301, b"ACGT", 37, id="16-length-beyond"),
    pytest.param(4, 300, 0, 64, b"ACGTN", 5, id="4-length-beyond"),
]


@pytest.mark.parametrize("cpw,rows,lo,hi,alphabet,extra", PACK_CASES)
def test_pack_words_match(cpw, rows, lo, hi, alphabet, extra):
    seqs = _random_seqs(3, rows, alphabet, lo, hi)
    if rows > 1:   # an empty row, and one of cpw - 1 characters mod cpw
        n = (hi - 1) // cpw * cpw - 1
        seqs[1], seqs[-1] = b"", _random_seqs(4, 1, alphabet, n, n + 1)[0]
    assert pack.can_pack2(seqs) == jpack.can_pack2(seqs)
    longest = max(map(len, seqs))
    length = longest + extra if extra else None
    words = pack.pack_words(seqs, cpw, length)
    assert words.dtype == np.int32 and words.flags.c_contiguous
    assert words.shape == (rows, pack.n_words(longest + extra, cpw))
    assert np.array_equal(words, _scatter_pack_words(seqs, cpw, length))
    for s, w in zip(seqs, words):
        jw = jtbd.pack_flat_words(s, cpw)   # same stream, other padding
        n = (len(s) + cpw - 1) // cpw
        assert np.array_equal(w[:n], jw[:n])
        assert not w[n:].any()
    # the JAX kernel's word tables, on at most 16 rows (a table is 64 KiB)
    head, words = seqs[:16], words[:16]
    flat = convert.words_from_table(jwk.pack_table(head, cpw))
    assert np.array_equal(flat[:, :words.shape[1]], words)
    assert np.array_equal(convert.table_from_words(words),
                          jwk.pack_table(head, cpw))


@pytest.mark.parametrize("seqs,want", [
    ([b"ACGT", b"TTGCA"], True),
    ([b"ACGTN"], False),
    ([b"acgt"], False),            # case-sensitive like the reference
    ([b"ACGU"], False),
    ([b"ACGT" * 1000, b"ACGT", b"GATTACAn"], False),
    ([b"", b"ACGT"], True),
    ([b"", b""], True),
    ([], True),
])
def test_can_pack2_match(seqs, want):
    assert pack.can_pack2(seqs) is want
    assert jpack.can_pack2(seqs) is want


def test_convert_round_trips():
    rng = np.random.default_rng(5)
    tb = rng.integers(0, 128, (2, 3, 1024), dtype=np.uint8)
    assert np.array_equal(convert.tb_from_packed(convert.packed_from_tb(tb)),
                          tb)
    assert np.array_equal(convert.tb_from_packed(convert.packed_from_tb(tb)
                                                 [:1, :2])[0, 1],
                          jwk.unpack_tb(convert.packed_from_tb(tb)[0])[1])
    lanes = np.array([[10, 20, -512, 0, (3 << 30) + 7],
                      [0, 0, -100, 9, 0]], np.int64)
    assert np.array_equal(convert.lanes_from_scal(
        convert.scal_from_lanes(lanes)), lanes)
    out = np.array([[155, 1, 0, 0, 0, 3, (5 << 30) + 11, 1234, 2]], np.int64)
    assert np.array_equal(convert.out_from_row(convert.row_from_out(out)),
                          out)


@pytest.mark.parametrize("seed", range(3))
def test_ksim_matches(seed):
    rng = np.random.default_rng(seed)
    t = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 3000).tobytes()
    q = bytearray(t)
    for i in rng.choice(len(q), 120, replace=False):
        q[i] = int(rng.choice(np.frombuffer(b"ACGT", np.uint8)))
    q = bytes(q)
    assert kmer.ksim(t, q, 13) == jkmer.ksim(t, q, 13)
    assert np.array_equal(kmer.kmer_codes(t, 1, 13),
                          jkmer.kmer_codes(t, 1, 13))


@pytest.mark.parametrize("backend", ["native", "numpy", "plain"])
def test_ksims_match(backend, monkeypatch):
    """``ksims`` reuses its work arrays from pair to pair: longest pair
    first, then pairs with k-mer runs longer than one, with no valid
    k-mer, shorter than k, and one sequence against itself.  "plain":
    ``ksims_device`` on the CPU (the ksim kernel's plain version) gives
    the same floats."""
    if backend == "native" and not native.available():
        pytest.skip("g++ is not available to build the native runtime")
    if backend == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.default_rng(11)
    t = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 5000).tobytes()
    q = bytearray(t[:4000])
    for i in rng.choice(len(q), 200, replace=False):
        q[i] = int(rng.choice(np.frombuffer(b"ACGT", np.uint8)))
    pairs = [(t, bytes(q)), (b"ACGT" * 60, b"ACGTTACG" * 20 + b"ACGT" * 9),
             (b"N" * 40, b"ACGT" * 10), (b"ACG", b"ACGTACGT" * 5),
             (t[:700], t[:700]), (b"GATTACA" * 3, b"")]
    for k in (13, 5):
        want = [jkmer.ksim(a, b, k) for a, b in pairs]
        assert list(kmer.ksims(pairs, k)) == want
        assert [kmer.ksim(a, b, k) for a, b in pairs] == want
        if backend == "plain":
            assert kmer.ksims_device(pairs, k, "cpu") == want
    out = np.full(len(t) + 7, 9, np.uint64)
    codes = kmer.kmer_codes(t, 1, 13, out)
    assert np.shares_memory(codes, out)
    assert np.array_equal(codes, jkmer.kmer_codes(t, 1, 13))
    if backend == "native":
        with pytest.raises(ValueError):   # too short for the sequence
            native.kmer_codes(t, 1, 13, out[:100])


def _ksim_pairs(case):
    """Pairs of the ksim cases: ``test_ksims_match``'s shapes and the
    k-mer counts' corners."""
    rng = np.random.default_rng(7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if case == "homopolymer":     # one k-mer ~10k times a side
        return [(b"A" * 10013, b"A" * 9000 + b"C" * 13 + b"A" * 1100),
                (b"T" * 5000, b"T" * 7000)]
    if case == "alphabet":        # lowercase, U/u and N bytes
        t = rng.choice(np.frombuffer(b"ACGTacgtUuN", np.uint8), 6000)
        q = t.copy()
        q[rng.choice(q.size, 300, replace=False)] = rng.choice(acgt, 300)
        low = bytes(t).lower()
        return [(bytes(t), bytes(q)), (low, low.upper().replace(b"T", b"U")),
                (b"acgtn" * 500, b"ACGTN" * 400)]
    if case == "unequal":
        t = rng.choice(acgt, 9000).tobytes()
        return [(t, t[1000:4000]), (t[:40], t), (t[:12], t[:5000]),
                (t[:13], t[:13])]
    import json
    from wfabench import gen
    with open(os.path.join(os.path.dirname(__file__), "..", "wfabench",
                           "configs", "pairs100k.json")) as f:
        cfg = json.load(f)
    cfg["target_bp"] = 3000
    return gen.make_pool(cfg, 16, 2 ** 31 + 12345)


@pytest.mark.parametrize("case,k", [
    ("homopolymer", 13), ("alphabet", 13), ("unequal", 13), ("pool16", 13),
    ("alphabet", 15), ("unequal", 5)])
def test_ksim_counts_plain_match(case, k):
    """The ksim kernel's plain version: each lane's (shared, n1, n2) are
    the host's integer counts, and its similarity is ``kmer.ksims``' and
    the JAX package's ``ksim`` to the bit."""
    pairs = _ksim_pairs(case)
    got = kmer.ksim_counts(pairs, k, "cpu")
    assert got.shape == (len(pairs), 3) and got.dtype == np.int64
    for (t, q), (shared, n1, n2) in zip(pairs, got.tolist()):
        assert (n1, n2) == (kmer.kmer_codes(t, 0, k).size,
                            kmer.kmer_codes(q, 1, k).size)
        assert 0 <= shared <= min(n1, n2)
    want = [jkmer.ksim(t, q, k) for t, q in pairs]
    assert list(kmer.ksims(pairs, k)) == want
    assert kmer.ksims_device(pairs, k, "cpu") == want


@pytest.mark.parametrize("n,slots", [
    (0, 2), (1, 2), (2, 4), (3, 8), (176, 512),
    (16 * (2 * 100_000 - 24), 1 << 23), (2 * 1_000_000 - 24, 1 << 22)])
def test_ksim_slots(n, slots):
    """A launch's table: the power of two at or above twice its k-mers
    (16 x 100 kb: 2^23 slots, 128 MiB; one 1 Mb pair: 2^22, 64 MiB)."""
    assert kmer.ksim_slots(n) == slots
    assert slots >= 2 * n and slots & (slots - 1) == 0


def _escalated(fn, bk, ovf_band, ovf_scap):
    try:
        e = fn(bk, ovf_band, ovf_scap)
    except RuntimeError:    # nothing left to escalate
        return "stuck"
    return e.W, e.S_CAP


@pytest.mark.parametrize("seed", range(2))
def test_bucket_sizing_matches(seed):
    rng = np.random.default_rng(seed)
    pairs = [(bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                               int(rng.integers(2100, 4000)))),
              bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                               int(rng.integers(2100, 4000)))))
             for _ in range(3)]
    ts, qs = [p[0] for p in pairs], [p[1] for p in pairs]
    for o in OPTS:
        for w0, s0 in ((512, 512), (64, 16), (4096, 100)):
            b = exact._buckets_for(o, ts, qs, w0, s0)
            jb = jexact._buckets_for(_jopt(o), ts, qs, w0, s0)
            assert (b.LT, b.LQ, b.W, b.S_CAP, b.W_full, b.S_full) == \
                (jb.LT, jb.LQ, jb.W, jb.S_CAP, jb.W_full, jb.S_full)
            for fb, fs in ((True, False), (False, True), (True, True)):
                assert _escalated(exact._escalate, b, fb, fs) == \
                    _escalated(jexact._escalate, jb, fb, fs)
        assert exact._estimate_s(o, ts, qs) == jexact._estimate_s(
            _jopt(o), ts, qs)


def test_port_imports_no_jax():
    code = ("import sys, importlib\n"
            "for m in ('miniwfa_tpu_torch', 'miniwfa_tpu_torch.cli', "
            "'miniwfa_tpu_torch.convert', 'miniwfa_tpu_torch.models.exact', "
            "'miniwfa_tpu_torch.models.traceback', "
            "'miniwfa_tpu_torch.models.tiny', "
            "'miniwfa_tpu_torch.models.chain', "
            "'miniwfa_tpu_torch.models.auto', "
            "'miniwfa_tpu_torch.ops.build', 'miniwfa_tpu_torch.ops.kmer', "
            "'miniwfa_tpu_torch.ops.traceback_device', "
            "'miniwfa_tpu_torch.ops.wavefront_gaps', "
            "'miniwfa_tpu_torch.ops.wavefront_kernel', "
            "'miniwfa_tpu_torch.ops.wavefront_wide', "
            "'miniwfa_tpu_torch.ops.wavefront_multi', "
            "'miniwfa_tpu_torch.ops.probes', "
            "'miniwfa_tpu_torch.ops.probes_multi', "
            "'miniwfa_tpu_torch.tools.k1_ab', "
            "'miniwfa_tpu_torch.tools.ksim_bench', "
            "'miniwfa_tpu_torch.tools.microbench', "
            "'miniwfa_tpu_torch.tools.mp_worker', "
            "'miniwfa_tpu_torch.tools.multicard_smoke', "
            "'miniwfa_tpu_torch.tools.pairs', "
            "'miniwfa_tpu_torch.tools.scaling_bench', "
            "'miniwfa_tpu_torch.parallel.batch', "
            "'miniwfa_tpu_torch.parallel.distributed', "
            "'miniwfa_tpu_torch.parallel.dryrun', "
            "'miniwfa_tpu_torch.parallel.mesh', "
            "'miniwfa_tpu_torch.utils.launches', "
            "'miniwfa_tpu_torch.utils.native', "
            "'miniwfa_tpu_torch.utils.spans', 'chip_smoke'):\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'miniwfa_tpu', 'bench', 'tools')]\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.stdout.strip() == ""


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        exact.align_batch([("ACGT", "ACGA")], Options(), device="cuda")


def test_cli_prints_reference_tsv(goldens, tmp_path, capsys):
    from miniwfa_tpu_torch import cli
    c = next(c for c in goldens["cases"] if c["name"] == "t3")
    (tmp_path / "t.fa").write_text(f">t3\n{c['t']}\n")
    (tmp_path / "q.fa").write_text(f">q3\n{c['q']}\n")
    rc = cli.main(["-c", "--device", "cpu", str(tmp_path / "t.fa"),
                   str(tmp_path / "q.fa")])
    assert rc == 0
    row = capsys.readouterr().out.strip().split("\t")
    assert row == ["t3", str(len(c["t"])), "0", str(len(c["t"])), "+", "q3",
                   str(len(c["q"])), "0", str(len(c["q"])), "155",
                   "1X16=1X14=128I4=1X24="]
    rc = cli.main(["-c", "-p", "16", "--device", "cpu",
                   str(tmp_path / "t.fa"), str(tmp_path / "q.fa")])
    assert rc == 0
    row = capsys.readouterr().out.strip().split("\t")
    assert row[9:] == ["155", "1X16=1X14=128I4=1X24="]
    for flag, cig in (("-u", "1X16=1X18=128I1X24="),
                      ("-t", "1X16=1X14=128I4=1X24=")):
        rc = cli.main([flag, "-c", "--device", "cpu",
                       str(tmp_path / "t.fa"), str(tmp_path / "q.fa")])
        assert rc == 0
        row = capsys.readouterr().out.strip().split("\t")
        assert row[9:] == ["155", cig], flag


def test_cli_prewarm(goldens, tmp_path, monkeypatch, capsys):
    """--prewarm builds every source before aligning: with no nvcc and no
    library built before, the run fails with build's error and prints no
    row; with every library built, it prints the P line, then the TSV."""
    from miniwfa_tpu_torch import cli
    from miniwfa_tpu_torch.ops import build
    c = next(c for c in goldens["cases"] if c["name"] == "t3")
    (tmp_path / "t.fa").write_text(f">t3\n{c['t']}\n")
    (tmp_path / "q.fa").write_text(f">q3\n{c['q']}\n")
    argv = ["--prewarm", "-c", "--device", "cpu", str(tmp_path / "t.fa"),
            str(tmp_path / "q.fa")]
    out = tmp_path / "out"
    monkeypatch.setattr(build, "BUILD_DIR", str(out))

    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_nvcc", missing)
    assert cli.main(argv) == 1
    got = capsys.readouterr()
    assert got.out == "" and "nvcc not found" in got.err
    for name in build.SOURCES:
        (out / f"lib{name}.so").write_text("lib")
        (out / f"lib{name}.key").write_text("0\n")
    assert cli.main(argv) == 0
    got = capsys.readouterr()
    assert re.search(rf"^P\tprewarmed {len(build.SOURCES)} specs in "
                     rf"[0-9.]+s$", got.err, re.M)
    assert got.out.strip().split("\t")[9:] == ["155",
                                               "1X16=1X14=128I4=1X24="]


def test_build_key_tracks_source_headers_flags_and_nvcc(tmp_path,
                                                       monkeypatch):
    """ops/build.py rebuilds a library when its source, a shared header,
    NVCC_FLAGS or the nvcc version changes, and only then (nvcc stubbed
    by a script that writes its -o file)."""
    from miniwfa_tpu_torch.ops import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    (csrc / "h.cuh").write_text("// h1\n")
    ver = tmp_path / "version"
    ver.write_text("Cuda compilation tools, release 12.8\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import os, sys\n"
        "if '--version' in sys.argv:\n"
        "    print(open(os.environ['STUB_NVCC_VERSION']).read())\n"
        "    sys.exit(0)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
        "print('ptxas info: compiled')\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("STUB_NVCC_VERSION", str(ver))
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))

    def built():
        return sorted(build.build(["k"]))

    assert built() == ["k"]
    assert (tmp_path / "out" / "libk.so").read_text() == "lib"
    assert sorted(os.listdir(tmp_path / "out")) == ["libk.key", "libk.so"]
    assert built() == []
    os.utime(csrc / "k.cu", (1e10, 1e10))      # newer file, same content
    assert built() == []
    (csrc / "k.cu").write_text("// v2\n")
    assert built() == ["k"]
    (csrc / "h.cuh").write_text("// h2\n")
    assert built() == ["k"]
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-lineinfo"))
    assert built() == ["k"]
    assert built() == []
    ver.write_text("Cuda compilation tools, release 12.9\n")
    assert built() == ["k"]
    assert built() == []


def test_build_without_nvcc_uses_built_libraries(tmp_path, monkeypatch,
                                                 capsys):
    """With no nvcc, ops/build.py uses a library built before (with its
    key) as it is, and raises for one that was never built."""
    from miniwfa_tpu_torch.ops import build
    out = tmp_path / "out"
    out.mkdir()
    (out / "libk.so").write_text("lib")
    (out / "libk.key").write_text("0\n")
    monkeypatch.setattr(build, "BUILD_DIR", str(out))

    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_nvcc", missing)
    assert build.build(["k"]) == {}
    assert "no nvcc" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["k", "j"])
