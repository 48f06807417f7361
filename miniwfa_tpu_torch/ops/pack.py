"""Sequence word-packing for the wavefront kernel and the CIGAR walker.

Both kernels read a sequence as a flat little-endian stream of 32-bit
words: word ``j`` holds the ``cpw`` characters starting at ``j*cpw``,
character ``c`` of the word in bits ``[c*bits, (c+1)*bits)``.  An
unaligned probe of ``cpw`` characters at any position is one funnel shift
of two neighbouring words, so no pre-rotated copies are needed.

Packing modes:
  * cpw=16 — 2 bits/char, valid only when every byte is in {A,C,G,T}
    (exact bytes; case-sensitive like the reference's byte compare).
  * cpw=4  — 8 bits/char (raw bytes), always valid.

Equality of packed words is equality of the underlying byte runs because
both mappings are injective on the allowed alphabet.  Reads past a
sequence's end are prevented by the callers' advance caps, and every
stream carries at least two words of zero padding so the funnel shift's
second word always exists.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# bytes.translate table: A/C/G/T -> 0..3, every other byte -> 0
_CODE2 = bytes(b"ACGT".index(c) if c in b"ACGT" else 0 for c in range(256))
# up to this many rows a batch is checked and packed a row at a time, each
# row's work in a scratch that stays in cache; more rows (a chain dispatch
# packs up to 16384 gaps) are joined and placed by one masked scatter
_ROW_COPY_MAX = 256


def can_pack2(seqs: Sequence[bytes]) -> bool:
    """True iff every byte of every sequence is uppercase A/C/G/T."""
    if len(seqs) > _ROW_COPY_MAX:
        return not b"".join(seqs).translate(None, b"ACGT")
    return all(not s.translate(None, b"ACGT") for s in seqs)


def n_words(length: int, cpw: int) -> int:
    """Stream length in words for a sequence of ``length`` characters:
    the packed words plus two words of zero padding."""
    return length // cpw + 2


def _fold(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """2-bit codes, a byte each, eight to a uint64 of ``x``, folded in
    place into the uint64's bytes 0 and 4 (c0 | c1<<2 | c2<<4 | c3<<6);
    ``y`` is scratch of x's shape.  Returns those bytes, a strided view:
    the packed bytes in order."""
    np.right_shift(x, np.uint64(6), out=y)
    x |= y
    np.right_shift(x, np.uint64(12), out=y)
    x |= y
    return x.view(np.uint8)[..., ::4]


def pack_words(seqs: Sequence[bytes], cpw: int,
               length: Optional[int] = None) -> np.ndarray:
    """Pack a batch into flat word streams, int32 ``[B, NW]`` with NW =
    n_words(length), ``length`` defaulting to the longest sequence;
    shorter rows are zero-padded.

    At cpw=4 the bytes already are the little-endian words.  At cpw=16
    ``bytes.translate`` codes the bytes and every four codes fold into a
    byte.  A few rows are packed one by one; many rows are joined, coded
    together and placed by one scatter."""
    assert cpw in (4, 16)
    lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
    longest = int(lens.max(initial=0))
    if length is None:
        length = longest
    elif longest > length:
        raise ValueError(f"a sequence of {longest} characters is longer "
                         f"than the stated length {length}")
    nw = n_words(length, cpw)
    if len(seqs) > _ROW_COPY_MAX:
        raw = b"".join(seqs)
        codes = np.zeros((len(seqs), nw * cpw), dtype=np.uint8)
        # row-major boolean assignment fills each row's first len(s)
        # slots with the batch's characters in order
        codes[np.arange(nw * cpw) < lens[:, None]] = np.frombuffer(
            raw.translate(_CODE2) if cpw == 16 else raw, np.uint8)
        if cpw == 16:
            x = codes.view(np.uint64)
            codes = np.ascontiguousarray(_fold(x, np.empty_like(x)))
        return codes.view("<i4")
    out = np.zeros((len(seqs), nw * 4), dtype=np.uint8)
    if cpw == 4:
        for row, s in zip(out, seqs):
            row[:len(s)] = np.frombuffer(s, np.uint8)
        return out.view("<i4")
    codes = np.zeros(nw * 16, dtype=np.uint8)   # one row's, reused
    x = codes.view(np.uint64)
    y = np.empty_like(x)
    for row, s in zip(out, seqs):
        n = len(s)
        m = -(-n // 8)                  # the uint64s holding the row
        codes[:n] = np.frombuffer(s.translate(_CODE2), np.uint8)
        codes[n:8 * m] = 0
        row[:2 * m] = _fold(x[:m], y[:m])
    return out.view("<i4")
