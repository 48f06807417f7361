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

_NT2 = np.zeros(256, dtype=np.uint32)
_NT2[ord("A")] = 0
_NT2[ord("C")] = 1
_NT2[ord("G")] = 2
_NT2[ord("T")] = 3
_ACGT = frozenset(b"ACGT")


def can_pack2(seqs: Sequence[bytes]) -> bool:
    """True iff every byte of every sequence is uppercase A/C/G/T."""
    return all(not (set(s) - _ACGT) for s in seqs)


def n_words(length: int, cpw: int) -> int:
    """Stream length in words for a sequence of ``length`` characters:
    the packed words plus two words of zero padding."""
    return length // cpw + 2


def pack_words(seqs: Sequence[bytes], cpw: int,
               length: Optional[int] = None) -> np.ndarray:
    """Pack a batch into flat word streams, int32 ``[B, NW]`` with NW =
    n_words(length), ``length`` defaulting to the longest sequence;
    shorter rows are zero-padded.  One scatter for the whole batch: a
    chain dispatch packs up to 16384 gaps."""
    assert cpw in (4, 16)
    bits = 2 if cpw == 16 else 8
    lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
    if length is None:
        length = int(lens.max(initial=0))
    nw = n_words(length, cpw)
    codes = np.zeros((len(seqs), nw * cpw), dtype=np.uint32)
    # row-major boolean assignment fills each row's first len(s) slots
    # with the batch's characters in order
    raw = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    codes[np.arange(nw * cpw) < lens[:, None]] = \
        _NT2[raw] if cpw == 16 else raw
    v = codes.reshape(len(seqs), nw, cpw)
    w = np.zeros((len(seqs), nw), dtype=np.uint32)
    for j in range(cpw):
        w |= v[:, :, j] << np.uint32(bits * j)
    return w.view(np.int32)
