"""Carry wavefront state between the JAX package's kernel and this port.

The JAX package's Pallas kernel (``miniwfa_tpu/ops/wavefront_kernel.py``)
lays its buffers out for the TPU; this port lays the same information out
for its own kernels.  These numpy functions turn one into the other, in
both directions, so the two engines can be fed the same inputs and their
outputs compared value for value:

* the kernel's scalar rows ``scal [B, 7 + 2*seg_cap] int32`` (columns
  SC_*) ↔ the port's per-lane inputs ``lanes [B, L_N] int64`` and, for
  the pass-2 checkpoints (SC_NSEG, SC_SEG...), ``segs [B, seg_cap, 2]
  int64`` padded with score -1;
* the segmented word tables ``pack_table`` ``[B, nseg, 128, 128]`` (128
  words per column, segments overlapping by one 128-word block) ↔ the
  port's flat word streams ``[B, NW] int32``;
* the packed traceback ``tb_packed [B, S_CAP, W/512, 128] int32`` (band
  row ``r`` in byte ``r % 4`` of packed row ``r // 4``: ``unpack_tb``) ↔
  the port's ``tb [B, S_CAP, W] uint8``;
* the 10-column output row (O_*; n_iter split into 30-bit halves) ↔ the
  port's ``out [B, O_N] int64``.  Every column means the same in both
  (a PASS1 lane out of snapshot rows is a band overflow in both) except
  PASS1's ``last_ptr``, a flat index into each package's own snapshot
  layout: the two packages' pass 1 meet at decoded ``(score, diagonal)``
  checkpoints, the JAX package's through its own decoder.

And for the gaps kernel (``miniwfa_tpu/ops/wavefront_gaps.py``, K3):

* its per-row planes ``meta`` (``tl | ql << 16``) and ``seqT``/``seqQ``
  (word j of gap g at ``[g, j]``), all ``[G, 128] int32``, ↔ the port's
  ``lens [G, 2] int32`` and flat word streams ``[G, NW] int32``;
* its result plane ``[G, 128] int32`` ↔ the port's ``out [G, GO_N]``
  (the same GO_* columns);
* its traceback ``[G, S_CAP/4, 128] int32`` (4 cycles per word: row t in
  byte ``t & 3`` of word ``[g, t >> 2, w]``) ↔ the port's
  ``tb [G, S_CAP, 128] uint8``.

And for the wide kernel (``miniwfa_tpu/ops/wavefront_wide.py``, K2):

* its out row, the 10 O_* columns then OW_T, OW_WLO, OW_WHI, OW_TLO,
  OW_THI, OW_PAUSE and the band registry, ↔ the port's ``out [B, OW_N]``
  (O_* + OW_PAUSE) and the scalar columns of its state row (ST_*);
* its snapshot rows ``[B, n_snap+1, NRING, WR+8, 128]``: rows below
  snap_cnt are the snapshots, the next one holds the live pointer rings;
  rings of depth max age (DH, DE1, DE2), not max age + 1 as in the port,
  and flat pointers ``plane * WPT + w`` with ``WPT = (WR+8) * 128``.  A
  pointer into snapshot row c names ring slot j, which at that snapshot's
  score ``(c+1)*step - 1`` held one score; the port's slot of that score
  gives the port's pointer (``wide_ptr``), so the converted rows decode
  with the port's checkpoint chain and decoder.

The JAX package's column numbers are restated here, so this module needs
neither JAX nor that package.
"""

from __future__ import annotations

import numpy as np

from .ops import wavefront_gaps as wg
from .ops import wavefront_kernel as wk
from .ops import wavefront_wide as ww

# scalar-input columns of the JAX kernel
(SC_TL, SC_QL, SC_ANC, SC_NSEG, SC_MS, SC_MILO, SC_MIHI, SC_SEG) = range(8)
# scalar-output columns of the JAX kernel
(JO_S, JO_DONE, JO_STOP, JO_OVFB, JO_OVFS, JO_LS, JO_NLO, JO_NHI,
 JO_LP, JO_SNC, JO_N) = range(11)
# the JAX wide kernel's out-row columns after the O_* ones
(JW_T, JW_WLO, JW_WHI, JW_TLO, JW_THI, JW_PAUSE, JW_BND) = \
    range(JO_N, JO_N + 7)
NTAB = 128        # word-table rows/cols: one segment = 128*128 words
SEGSTRIDE = 127   # segment stride in 128-word blocks
_LO30 = (1 << 30) - 1


def lanes_from_scal(scal: np.ndarray) -> np.ndarray:
    scal = np.asarray(scal, np.int64)
    lanes = np.zeros((scal.shape[0], wk.L_N), np.int64)
    lanes[:, wk.L_TL] = scal[:, SC_TL]
    lanes[:, wk.L_QL] = scal[:, SC_QL]
    lanes[:, wk.L_ANC] = scal[:, SC_ANC]
    lanes[:, wk.L_MS] = scal[:, SC_MS]
    lanes[:, wk.L_MI] = (scal[:, SC_MIHI] << 30) | scal[:, SC_MILO]
    return lanes


def segs_from_scal(scal: np.ndarray) -> np.ndarray:
    """The checkpoint columns of ``scal`` -> segs [B, seg_cap, 2] int64,
    rows past each lane's n_seg padded with score -1."""
    scal = np.asarray(scal, np.int64)
    cap = (scal.shape[1] - SC_SEG) // 2
    segs = np.zeros((scal.shape[0], cap, 2), np.int64)
    segs[:, :, 0] = scal[:, SC_SEG:SC_SEG + cap]
    segs[:, :, 1] = scal[:, SC_SEG + cap:SC_SEG + 2 * cap]
    segs[np.arange(cap)[None, :] >= scal[:, SC_NSEG:SC_NSEG + 1], 0] = -1
    return segs


def scal_from_lanes(lanes: np.ndarray, seg_cap: int = 1,
                    segs: np.ndarray = None) -> np.ndarray:
    lanes = np.asarray(lanes, np.int64)
    if segs is not None:
        seg_cap = max(seg_cap, segs.shape[1])
    scal = np.zeros((lanes.shape[0], SC_SEG + 2 * seg_cap), np.int32)
    scal[:, SC_TL] = lanes[:, wk.L_TL]
    scal[:, SC_QL] = lanes[:, wk.L_QL]
    scal[:, SC_ANC] = lanes[:, wk.L_ANC]
    scal[:, SC_MS] = lanes[:, wk.L_MS]
    scal[:, SC_MILO] = lanes[:, wk.L_MI] & _LO30
    scal[:, SC_MIHI] = lanes[:, wk.L_MI] >> 30
    if segs is not None:
        segs = np.asarray(segs, np.int64)
        n = (segs[:, :, 0] >= 0).sum(1)
        scal[:, SC_NSEG] = n
        for i, k in enumerate(n):
            scal[i, SC_SEG:SC_SEG + k] = segs[i, :k, 0]
            scal[i, SC_SEG + seg_cap:SC_SEG + seg_cap + k] = segs[i, :k, 1]
    return scal


def words_from_table(table: np.ndarray) -> np.ndarray:
    """Segmented word tables -> flat word streams [B, NW] int32."""
    table = np.asarray(table)
    B, nseg = table.shape[:2]
    flat = np.zeros((B, ((nseg - 1) * SEGSTRIDE + NTAB) * NTAB), np.int32)
    for s in range(nseg):
        off = s * SEGSTRIDE * NTAB
        flat[:, off:off + NTAB * NTAB] = \
            table[:, s].transpose(0, 2, 1).reshape(B, NTAB * NTAB)
    return flat


def table_from_words(words: np.ndarray, nseg: int = 1) -> np.ndarray:
    """Flat word streams -> segmented word tables [B, nseg, 128, 128]."""
    words = np.asarray(words, np.int32)
    B = words.shape[0]
    flat = np.zeros((B, ((nseg - 1) * SEGSTRIDE + NTAB) * NTAB), np.int32)
    n = min(words.shape[1], flat.shape[1])
    flat[:, :n] = words[:, :n]
    out = np.empty((B, nseg, NTAB, NTAB), np.int32)
    for s in range(nseg):
        off = s * SEGSTRIDE * NTAB
        out[:, s] = flat[:, off:off + NTAB * NTAB] \
            .reshape(B, NTAB, NTAB).transpose(0, 2, 1)
    return out


def tb_from_packed(tb_packed: np.ndarray) -> np.ndarray:
    """[B, S_CAP, W/512, 128] int32 (4 band rows per word) -> [B, S_CAP, W]
    uint8, the 7-bit bytes."""
    p = np.asarray(tb_packed).view(np.uint32)
    B, S, WR4, _ = p.shape
    out = np.empty((B, S, WR4, 4, 128), np.uint8)
    for j in range(4):
        out[:, :, :, j, :] = (p >> np.uint32(8 * j)) & 0x7F
    return out.reshape(B, S, WR4 * 512)


def packed_from_tb(tb: np.ndarray) -> np.ndarray:
    """[B, S_CAP, W] uint8 -> [B, S_CAP, W/512, 128] int32."""
    tb = np.asarray(tb, np.uint8)
    B, S, W = tb.shape
    v = tb.reshape(B, S, W // 512, 4, 128).astype(np.uint32)
    out = v[:, :, :, 0] | (v[:, :, :, 1] << 8) | (v[:, :, :, 2] << 16) \
        | (v[:, :, :, 3] << 24)
    return out.view(np.int32)


# (JAX column, port column) pairs copied as they are; last_ptr is a flat
# index into each package's own snapshot layout, so it compares equal
# only outside PASS1 (WF_NEG_INF) — PASS1 results meet at checkpoints
_SAME = ((JO_S, wk.O_S), (JO_DONE, wk.O_DONE), (JO_STOP, wk.O_STOP),
         (JO_OVFB, wk.O_OVFB), (JO_OVFS, wk.O_OVFS), (JO_LS, wk.O_LS),
         (JO_LP, wk.O_LP), (JO_SNC, wk.O_SNC))


def row_from_out(out: np.ndarray) -> np.ndarray:
    """Port outputs [B, O_N] -> the JAX kernel's [B, 10] row."""
    out = np.asarray(out, np.int64)
    row = np.zeros((out.shape[0], JO_N), np.int32)
    for jo, o in _SAME:
        row[:, jo] = out[:, o]
    row[:, JO_NLO] = out[:, wk.O_NITER] & _LO30
    row[:, JO_NHI] = out[:, wk.O_NITER] >> 30
    return row


def out_from_row(row: np.ndarray) -> np.ndarray:
    """The JAX kernel's [B, 10] row -> port outputs [B, O_N]."""
    row = np.asarray(row, np.int64)
    out = np.zeros((row.shape[0], wk.O_N), np.int64)
    for jo, o in _SAME:
        out[:, o] = row[:, jo]
    out[:, wk.O_NITER] = (row[:, JO_NHI] << 30) | row[:, JO_NLO]
    return out


def gaps_planes(lens: np.ndarray, tw: np.ndarray, qw: np.ndarray):
    """The port's gaps inputs -> the JAX gaps kernel's (meta, seqT, seqQ)
    planes, [G, 128] int32 each."""
    lens = np.asarray(lens, np.int64)
    meta = np.broadcast_to(
        (lens[:, 0] | (lens[:, 1] << 16)).astype(np.int32)[:, None],
        (lens.shape[0], 128)).copy()

    def plane(words):
        words = np.asarray(words, np.int32)
        out = np.zeros((words.shape[0], 128), np.int32)
        n = min(words.shape[1], 128)
        out[:, :n] = words[:, :n]
        return out

    return meta, plane(tw), plane(qw)


def gaps_out_from_plane(plane: np.ndarray) -> np.ndarray:
    """The JAX gaps kernel's result plane [G, 128] -> out [G, GO_N]."""
    return np.asarray(plane, np.int32)[:, :wg.GO_N].copy()


def tb_from_gaps_packed(tb_packed: np.ndarray) -> np.ndarray:
    """[G, S_CAP/4, 128] int32 (byte t & 3 of word [g, t >> 2, w] holds
    row t) -> [G, S_CAP, 128] uint8."""
    p = np.asarray(tb_packed).view(np.uint32)
    G, S4, W = p.shape
    out = np.empty((G, S4, 4, W), np.uint8)
    for j in range(4):
        out[:, :, j, :] = (p >> np.uint32(8 * j)) & 0xFF
    return out.reshape(G, S4 * 4, W)


def _wide_plane_map(spec: wk.KSpec, t: int) -> np.ndarray:
    """The port's snapshot plane of each JAX wide-kernel ring plane, at a
    snapshot taken at score ``t``."""
    port = wk.snapshot_layout(spec)
    out = []
    for p0, depth in zip(port[:5], (spec.rings[0], spec.rings[1],
                                    spec.rings[1], spec.rings[2],
                                    spec.rings[2])):
        dj = depth - 1           # the JAX ring's depth
        for j in range(dj):
            out.append(p0 + (t - (t - j) % dj) % depth)
    return np.array(out, np.int64)


def wide_ptr(v, c: int, spec: wk.KSpec, wpt: int) -> np.ndarray:
    """JAX wide-kernel flat pointers into snapshot row ``c`` -> the port's
    (-1, the chain's origin, and unset entries stay as they are)."""
    v = np.asarray(v, np.int64)
    pm = _wide_plane_map(spec, spec.step * (c + 1) - 1)
    plane, w = v // wpt, v % wpt
    ok = (v >= 0) & (plane < len(pm)) & (w < spec.W)
    return np.where(ok, pm[np.clip(plane, 0, len(pm) - 1)] * spec.W + w,
                    np.where(v == -1, -1, wk.WF_NEG_INF))


def wide_out_from_row(row: np.ndarray, spec: wk.KSpec, wpt: int = 0):
    """The JAX wide kernel's out row -> (the port's out [B, OW_N], the
    scalar columns of its state row [B, ST_BND]).  In PASS1 ``wpt`` is
    the JAX snapshot stride, and last_ptr is carried into the port's
    layout."""
    row = np.asarray(row, np.int64)
    out = np.zeros((row.shape[0], ww.OW_N), np.int64)
    out[:, :wk.O_N] = out_from_row(row[:, :JO_N])
    out[:, ww.OW_PAUSE] = row[:, JW_PAUSE]
    if spec.mode == wk.MODE_PASS1:
        for b in range(row.shape[0]):
            snc = int(out[b, wk.O_SNC])
            if snc:
                out[b, wk.O_LP] = wide_ptr(out[b, wk.O_LP], snc - 1, spec,
                                           wpt)
    st = np.zeros((row.shape[0], ww.ST_BND), np.int64)
    for c, src in ((ww.ST_T, row[:, JW_T]), (ww.ST_WLO, row[:, JW_WLO]),
                   (ww.ST_WHI, row[:, JW_WHI]), (ww.ST_TLO, row[:, JW_TLO]),
                   (ww.ST_THI, row[:, JW_THI]),
                   (ww.ST_NITER, out[:, wk.O_NITER]),
                   (ww.ST_LP, out[:, wk.O_LP]), (ww.ST_SNC, out[:, wk.O_SNC]),
                   (ww.ST_S, out[:, wk.O_S]), (ww.ST_DONE, out[:, wk.O_DONE]),
                   (ww.ST_STOP, out[:, wk.O_STOP]),
                   (ww.ST_OVFB, out[:, wk.O_OVFB])):
        st[:, c] = src
    return out, st


def snap_from_wide(snap: np.ndarray, snap_cnt, spec: wk.KSpec) -> np.ndarray:
    """The JAX wide kernel's snapshot rows [B, n_snap+1, NRING, WR+8, 128]
    -> the port's layout [B, n_snap, NP, W]: each lane's first snap_cnt
    rows, every pointer carried into the port's planes; the rest
    WF_NEG_INF."""
    snap = np.asarray(snap)
    B, R1, NR, WRT, _ = snap.shape
    wpt, W = WRT * 128, spec.W
    out = np.full((B, R1 - 1, wk.snapshot_layout(spec)[5], W),
                  wk.WF_NEG_INF, np.int32)
    for c in range(R1 - 1):
        vals = snap[:, c].reshape(B, NR, wpt)[:, :, :W].astype(np.int64)
        if c:
            vals = wide_ptr(vals, c - 1, spec, wpt)
        else:   # row 0 holds the chain's origin and nothing else
            vals = np.where(vals == -1, -1, wk.WF_NEG_INF)
        pm = _wide_plane_map(spec, spec.step * (c + 1) - 1)
        taken = np.asarray(snap_cnt)[:, None, None] > c
        out[:, c, pm] = np.where(taken, vals, wk.WF_NEG_INF)
    return out
