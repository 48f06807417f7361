// The wide-band WFA wavefront kernel for Hopper (sm_90a): one alignment over
// the whole card, SCORE and PASS1 modes, resumable across calls.
//
// Replaces miniwfa_tpu/ops/wavefront_wide.py::build_kernel_wide (the Pallas
// TPU kernel for bands past the VMEM kernel's windows: SCORE past 65536
// diagonals, low-mem PASS1 past 32768, up to 2^20) and run_chunked's
// chunks.  Its semantics are K1's (csrc/wavefront.cu, whose notes describe
// the cycle, the ring planes, the band registry and the PASS1 snapshots);
// the two share their per-diagonal code through wavefront_common.cuh, and
// the plain PyTorch twin is miniwfa_tpu_torch/ops/wavefront_wide.py::
// wide_plain, which runs K1's plain cycle code.
//
// Two variants, picked from the shapes by ops/wavefront_wide.py::pick_tiles.
//
// "tile" (wide_tiled): time-blocked tiles of the band in shared memory.
// The transition into score t+1 at diagonal d reads diagonals d-1, d, d+1
// of scores t+1-age (age >= 1), the extension and lastv only d itself.  So
// a block that loads every plane of slots [a-kp, b+kp] (the ring slots,
// PASS1's pointer rings and lastv) runs kp cycles on them with block
// barriers only, the trapezoid of exact cells shrinking one slot a side a
// cycle, and ends with exact planes on its output slots [a, b], which it
// writes back.  A batch of kb <= k cycles:
//   * plan (thread 0 of every block, the same everywhere): kb stops short
//     of every event that could fall inside the batch and is not known at
//     its start -- the 256-cycle shrink (the batch's last cycle), t_lim,
//     max_s, the next PASS1 snapshot cycle (a batch's first), the window
//     overflow (the band grows at most one diagonal a side a cycle) and
//     max_iter (a bound on the cells); an overflow, an out-of-rows
//     snapshot or a snapshot cycle's own termination (extended here) known
//     at the start make it an extension-only batch of one cycle;
//   * tiles: the written slots (the top band, the committed band +- kb,
//     and on a snapshot cycle every ring score's band) are cut into tiles
//     of ceil(slots / blocks) output slots, at least one a thread (512 -
//     2k), at most n, that a persistent cooperative grid takes from an
//     atomic queue.  The committed band +- kb is the middle; its first
//     and last tiles hold the two edges (2*kb slots each at least), see
//     every boundary commit and log lo(t) / hi(t) and the final wf_lo /
//     wf_hi; every other tile
//     lies inside the band of every score of the batch (the band only
//     grows between two shrinks) or outside all its new bands, so it needs
//     no scalar but the start's.  A narrow band in one tile is its own;
//   * a tile's load: one cp.async.bulk a plane row on an mbarrier, from
//     the 16-byte slot at or below its first slot to the one at or past
//     its last (W % 4 == 0; ops/wavefront_wide.py::pick_tiles), a NEG pad
//     written either side after; a proxy fence before every load orders
//     the block's use of the tile and the grid's plane writes before the
//     last grid barrier ahead of the copies;
//   * one grid barrier, then every block updates the lane's scalars, the
//     band registry and n_iter from the log.  A termination at cycle j
//     inside the batch (the tile that holds the end diagonal logs it) runs
//     the batch again, cut at j: the second grid barrier of such a batch.
// Tiles read one plane buffer and write the other (the caller's planes
// and a scratch buffer of one lane, in turns), so a write-back never races
// with a halo load still to come and a cut batch reruns from untouched
// planes; each batch also carries over the slots the previous one wrote
// and it does not, so the planes equal wide_plain's, stale out-of-band
// cells included.  The first batch of a lane carries the whole window.
//
// "cycle" (wide_cycle): the per-cycle body, for penalty sets whose
// smallest tile does not fit in shared memory (max_pen past ~1145 in
// SCORE, ~580 in PASS1), a zero age or a window that is no multiple of 4,
// or forced.  A cooperative launch puts as many blocks on the card as can be
// co-resident, and every block takes a contiguous share of the live band
// in each phase of a cycle; grid.sync() stands where K1 has a block
// barrier: after the extension, after the PASS1 snapshot, after the
// transition and after the 256-cycle shrink.  Every plane access is
// ld/st.global.cg (the partition moves every cycle).  Uniform scalars:
// every thread of every block keeps an identical copy of the lane's
// scalars and updates them from the same global flag words, double-
// buffered by cycle parity.
//
// Both run the lanes of a launch one after another, each over the whole
// grid, with the band registry (2 x RH ints) in each block's shared memory.
//
// Resume.  A launch runs each lane from the state row it is given (t, the
// committed and top bands, n_iter, last_ptr, snap_cnt, final_s, the
// done/stopped/overflow flags and the RH-entry band registry) to its cycle
// limit t_lim, and writes the state row back; the planes and snapshot rows
// stay in the caller's tensors between launches.  A pause falls between two
// cycles, so a resumed run equals a single call bit for bit; out[O_OVFS] is
// set only when S_CAP is really exhausted, out[OW_PAUSE] when the lane is
// alive below S_CAP.  Offsets into the planes and snapshot rows are 64-bit.
//
// What bounds it.  "tile": a tile's cycle is latency-bound work for one
// block of 16 warps (512 threads, 128 registers each: one block an SM):
// the extension's sequence-word loads (read-only path; a lane's run past
// its first nine words goes to its whole warp, 32 words a step), a
// block barrier, then the transition's shared-memory reads (its sources
// described once a cycle by thread 0 ahead of the barrier), unchecked in
// a cycle whose source bands all cover the tile.  Per batch come the
// tiles' bulk loads and write-backs, 2 x (NP+1) words a slot in SCORE and
// 2 x (2NP+1) in PASS1 (plus the halos, 2k a tile), against ~90-130
// bytes a diagonal a cycle of L2/HBM traffic and 2-4 grid barriers a
// cycle in "cycle"; and, when the band fills less than a wave of tiles,
// the slowest tile of each batch.  Block 0 counts its clock cycles by
// phase (the launch's stats, SS_*).  No wgmma: the recurrence is integer
// max/compare.

#include <cooperative_groups.h>

#include "bulk.cuh"
#include "wavefront_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mwf;

constexpr int THREADS = 512;
constexpr int K_MAX = 256;  // cycles a batch (the shrink period)

// state row (int64, per lane): scalars, then the band registry bnd_lo[RH],
// bnd_hi[RH] (ops/wavefront_wide.py ST_*)
enum {
  ST_T, ST_WLO, ST_WHI, ST_TLO, ST_THI, ST_NITER, ST_LP, ST_SNC, ST_S,
  ST_DONE, ST_STOP, ST_OVFB, ST_BND
};
enum { OW_PAUSE = O_N, OW_N };
// per-cycle flag words of the "cycle" variant, one set per cycle parity
enum { F_TERM, F_LOQ, F_HIQ, F_MN, F_MX, F_N };
enum { V_TILE, V_CYCLE };

struct Params {
  const long long* lanes;     // [B, L_N]
  const unsigned* tw;         // [B, nw] flat packed words
  const unsigned* qw;
  long long nw;
  long long* state;           // [B, st_n] (in and out)
  int st_n;
  const long long* t_lim;     // [B] cycle limit of this call
  int* planes;                // [B, NP (x2 in PASS1) + 1, W]
  int* snap;                  // [B, n_snap, NP, W] (PASS1) or null
  long long* out;             // [B, OW_N]
  int* flags;                 // "cycle": [2, F_N]; "tile": [3, LG_N] log
  int* scratch;               // "tile": [NP (x2) + 1, W], one lane's planes
  long long* stats;           // "tile": [SS_N] (wide_tiled's SS_*)
  int B, W, S_CAP, mode, cpw;
  int x, o1, e1, o2, e2;
  int step, n_snap;
  int n, k;                   // "tile": output slots a tile, cycles a batch
};

// Slots a tile holds: output (at most max(n, 4k): a middle that small is
// one tile) and a halo of k a side.  ops/wavefront_wide.py::tile_smem.
__host__ __device__ constexpr int tile_cap(int n, int k) {
  return (n > 4 * k ? n : 4 * k) + 2 * k;
}

// Ints a tile plane takes in shared memory: a row is copied from its
// 16-byte aligned slot la & ~3 up to lb | 3 (at most 3 slots more a side)
// into offset 4, a pad slot either side of [la, lb], 16-byte rows.
__host__ __device__ constexpr int tile_stride(int n, int k) {
  return (tile_cap(n, k) + 11 + 3) & ~3;
}

// Ints before the first tile plane: the band registry and the batch's
// band log, rounded up to 16 bytes.
__host__ __device__ constexpr int tile_head(int RH, int k) {
  return (2 * RH + 2 * (k + 1) + 3) & ~3;
}

// This block's contiguous share [lo, hi] of slots [a, e].
__device__ __forceinline__ void share(int a, int e, int& lo, int& hi) {
  const int n = e - a + 1;
  if (n <= 0) {
    lo = 0;
    hi = -1;
    return;
  }
  const int per = (n + (int)gridDim.x - 1) / (int)gridDim.x;
  lo = a + (int)blockIdx.x * per;
  hi = min(e, lo + per - 1);
}

__device__ __forceinline__ void st(int* p, int v) { __stcg(p, v); }

template <bool IS_P1>
__global__ void __launch_bounds__(THREADS) wide_cycle(Params p) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const bool lead = blockIdx.x == 0 && tid == 0;
  const int W = p.W;
  const size_t Wz = (size_t)W;
  const int ag_x = p.x, ag_o1 = p.o1 + p.e1, ag_o2 = p.o2 + p.e2;
  const int DH = max(ag_x, max(ag_o1, ag_o2));
  const int NS = DH + 1, RH = DH + 1;
  const int RE1 = max(p.e1, 1) + 1, RE2 = max(p.e2, 1) + 1;
  constexpr bool is_p1 = IS_P1;
  const int NP = RH + 2 * RE1 + 2 * RE2;
  const int cpw = p.cpw, bits = 32 / cpw;
  const int logc = cpw == 16 ? 4 : 2, logb = cpw == 16 ? 1 : 3;
  const size_t poff = is_p1 ? NP * Wz : 0;
  const size_t lane_planes = (size_t)(NP * (is_p1 ? 2 : 1) + 1) * Wz;

  extern __shared__ int registry[];
  int* bnd_lo = registry;
  int* bnd_hi = registry + RH;

  for (int b = 0; b < p.B; ++b) {
    const long long* ln = p.lanes + (size_t)b * L_N;
    const int tl = (int)ln[L_TL], ql = (int)ln[L_QL], anc = (int)ln[L_ANC];
    const long long max_s = ln[L_MS], max_iter = ln[L_MI];
    const int d_end = ql - tl;
    int* H = p.planes + (size_t)b * lane_planes;
    int* E1 = H + RH * Wz;
    int* F1 = E1 + RE1 * Wz;
    int* E2 = F1 + RE1 * Wz;
    int* F2 = E2 + RE2 * Wz;
    int* lastv = H + NP * Wz + poff;
    const unsigned* tw = p.tw + (size_t)b * p.nw;
    const unsigned* qw = p.qw + (size_t)b * p.nw;
    long long* sr = p.state + (size_t)b * p.st_n;

    // the lane's state (the previous launch, or the host, wrote the row)
    int t = (int)sr[ST_T];
    int wf_lo = (int)sr[ST_WLO], wf_hi = (int)sr[ST_WHI];
    int t_lo = (int)sr[ST_TLO], t_hi = (int)sr[ST_THI];
    long long n_iter = sr[ST_NITER];
    int last_ptr = (int)sr[ST_LP], snap_cnt = (int)sr[ST_SNC];
    int final_s = (int)sr[ST_S];
    bool done = sr[ST_DONE] != 0, stopped = sr[ST_STOP] != 0;
    bool ovf = sr[ST_OVFB] != 0;
    const long long lim = min(p.t_lim[b], (long long)p.S_CAP - 1);
    for (int j = tid; j < RH; j += THREADS) {
      bnd_lo[j] = (int)sr[ST_BND + j];
      bnd_hi[j] = (int)sr[ST_BND + RH + j];
    }
    if (lead) {
      for (int q = 0; q < 2; ++q) {
        int* F = p.flags + q * F_N;
        F[F_TERM] = F[F_LOQ] = F[F_HIQ] = 0;
        F[F_MN] = BIG;
        F[F_MX] = -BIG;
      }
    }
    grid.sync();

    while (!(done || stopped || ovf) && t < lim) {
      const int par = t & 1;
      int* F = p.flags + par * F_N;
      if (tid == 0) {
        bnd_lo[t % RH] = t_lo;
        bnd_hi[t % RH] = t_hi;
      }
      // --- 1. extension of the top band
      int* Ht = H + (size_t)(t % RH) * Wz;
      {
        int a, e;
        share(max(t_lo - anc, 0), min(t_hi - anc, W - 1), a, e);
        for (int s = a + tid; s <= e; s += THREADS) {
          const int d = anc + s, k = __ldcg(Ht + s);
          if (!(k >= -1 && d + k >= -1 && k < tl && d + k < ql)) continue;
          const int kn = extend(tw, qw, k, d, tl, ql, cpw, logc, bits, logb);
          st(Ht + s, kn);
          if (d == d_end && kn == tl - 1) atomicExch(F + F_TERM, 1);
        }
      }
      grid.sync();
      if (lead) {
        int* G = p.flags + (par ^ 1) * F_N;
        st(G + F_TERM, 0);
        st(G + F_LOQ, 0);
        st(G + F_HIQ, 0);
        st(G + F_MN, BIG);
        st(G + F_MX, -BIG);
      }

      // --- 2. termination
      const bool term = __ldcg(F + F_TERM) != 0;
      if (term) {
        done = true;
        final_s = t;
        if (is_p1) last_ptr = __ldcg(Ht + poff + (d_end - anc));
      }

      // --- 3. growth + window-overflow check
      const int lo = max(wf_lo - 1, -tl), hi = min(wf_hi + 1, ql);
      const bool ovf_now = !term && (lo < anc || hi > anc + W - 1);
      ovf = ovf || ovf_now;
      bool act = !term && !ovf_now;

      // --- 3b. PASS1 snapshot into row c = (t+1)/step - 1; out of rows is
      // a band overflow, as in K1
      if (is_p1 && act && (t + 1) % p.step == 0) {
        const int row = (t + 1) / p.step - 1;
        if (row >= p.n_snap) {
          ovf = true;
          act = false;
        } else {
          int* srow = p.snap + ((size_t)b * p.n_snap + row) * NP * Wz;
          for (int pl = 0; pl < NP; ++pl) {
            int depth, j;
            plane_slot(pl, RH, RE1, RE2, depth, j);
            const int sj = t - ((t - j) % depth + depth) % depth;
            if (sj < 0) continue;
            int a, e;
            share(max(bnd_lo[sj % RH] - anc, 0),
                  min(bnd_hi[sj % RH] - anc, W - 1), a, e);
            int* P = H + poff + (size_t)pl * Wz;
            int* S = srow + (size_t)pl * Wz;
            for (int s = a + tid; s <= e; s += THREADS) {
              st(S + s, __ldcg(P + s));
              st(P + s, pl * W + s);
            }
          }
          ++snap_cnt;
          grid.sync();
        }
      }
      if (act) {
        // --- 4. viability of the retired slice (lastv) + transition into
        // t+1
        const int re1 = t % RE1, re2 = t % RE2;
        const int* E1t = E1 + re1 * Wz;
        const int* F1t = F1 + re1 * Wz;
        const int* E2t = E2 + re2 * Wz;
        const int* F2t = F2 + re2 * Wz;
        int* Hn = H + (size_t)((t + 1) % RH) * Wz;
        int* E1n = E1 + (size_t)((t + 1) % RE1) * Wz;
        int* F1n = F1 + (size_t)((t + 1) % RE1) * Wz;
        int* E2n = E2 + (size_t)((t + 1) % RE2) * Wz;
        int* F2n = F2 + (size_t)((t + 1) % RE2) * Wz;
        auto mk = [&](const int* ring, int depth, int age) {
          const int ss = t + 1 - age;
          Src r;
          if (ss < 0) {
            r.p = ring;
            r.lo = 1;
            r.hi = 0;
          } else {
            r.p = ring + (size_t)(ss % depth) * Wz;
            r.lo = bnd_lo[ss % RH];
            r.hi = bnd_hi[ss % RH];
          }
          return r;
        };
        const Sources S{mk(H, RH, ag_x),   mk(H, RH, ag_o1),
                        mk(H, RH, ag_o2),  mk(E1, RE1, p.e1),
                        mk(F1, RE1, p.e1), mk(E2, RE2, p.e2),
                        mk(F2, RE2, p.e2)};
        int a, e;
        share(max(min(t_lo, lo) - anc, 0), min(max(t_hi, hi) - anc, W - 1),
              a, e);
        bool loq = false, hiq = false;
        for (int s = a + tid; s <= e; s += THREADS) {
          const int d = anc + s;
          if (d >= t_lo && d <= t_hi &&
              (good_diag(__ldcg(Ht + s), d, tl, ql) ||
               good_diag(__ldcg(E1t + s), d, tl, ql) ||
               good_diag(__ldcg(F1t + s), d, tl, ql) ||
               good_diag(__ldcg(E2t + s), d, tl, ql) ||
               good_diag(__ldcg(F2t + s), d, tl, ql)))
            st(lastv + s, t + 1);
          if (d < lo || d > hi) continue;
          const Cell c = transition<true>(S, s, anc);
          st(Hn + s, c.h);
          st(E1n + s, c.e1);
          st(F1n + s, c.f1);
          st(E2n + s, c.e2);
          st(F2n + s, c.f2);
          if (is_p1) {  // copy the chosen source's pointer
            const Cell q = pointers<true>(S, s, anc, poff, c.tb);
            st(Hn + poff + s, q.h);
            st(E1n + poff + s, q.e1);
            st(F1n + poff + s, q.f1);
            st(E2n + poff + s, q.e2);
            st(F2n + poff + s, q.f2);
          }
          if (any_viable(c)) {
            loq |= d == lo;
            hiq |= d == hi;
          }
        }
        if (loq) atomicExch(F + F_LOQ, 1);
        if (hiq) atomicExch(F + F_HIQ, 1);
        grid.sync();
        if (__ldcg(F + F_LOQ)) wf_lo = lo;  // boundary commit (miniwfa.c:325)
        if (__ldcg(F + F_HIQ)) wf_hi = hi;
        t_lo = lo;
        t_hi = hi;

        // --- 5. shrink every 256 cycles (miniwfa.c:420)
        if (((t + 1) & 0xFF) == 0) {
          int sa, se;
          share(max(wf_lo - anc, 0), min(wf_hi - anc, W - 1), sa, se);
          const int vfloor = viable_floor(t, NS);
          int mn = BIG, mx = -BIG;
          for (int s = sa + tid; s <= se; s += THREADS) {
            const int d = anc + s;
            const bool top =
                d >= lo && d <= hi &&
                (__ldcg(Hn + s) >= -1 || __ldcg(E1n + s) >= -1 ||
                 __ldcg(F1n + s) >= -1 || __ldcg(E2n + s) >= -1 ||
                 __ldcg(F2n + s) >= -1);
            if (top || __ldcg(lastv + s) >= vfloor) {
              mn = min(mn, d);
              mx = max(mx, d);
            }
          }
          if (mx >= mn) {
            atomicMin(F + F_MN, mn);
            atomicMax(F + F_MX, mx);
          }
          grid.sync();
          const int fmn = __ldcg(F + F_MN), fmx = __ldcg(F + F_MX);
          if (fmx >= fmn) {
            wf_lo = fmn;
            wf_hi = fmx;
          }
        }

        // --- 6. accounting + early stop (miniwfa.c:421-425)
        n_iter += hi - lo + 1;
        stopped = (max_iter > 0 && n_iter > max_iter) ||
                  (max_s > 0 && t + 1 > max_s);
      }
      ++t;
    }
    if (lead) {
      sr[ST_T] = t;
      sr[ST_WLO] = wf_lo;
      sr[ST_WHI] = wf_hi;
      sr[ST_TLO] = t_lo;
      sr[ST_THI] = t_hi;
      sr[ST_NITER] = n_iter;
      sr[ST_LP] = last_ptr;
      sr[ST_SNC] = snap_cnt;
      sr[ST_S] = final_s;
      sr[ST_DONE] = done;
      sr[ST_STOP] = stopped;
      sr[ST_OVFB] = ovf;
      for (int j = 0; j < RH; ++j) {
        sr[ST_BND + j] = bnd_lo[j];
        sr[ST_BND + RH + j] = bnd_hi[j];
      }
      const bool alive = !(done || stopped || ovf);
      long long* o = p.out + (size_t)b * OW_N;
      o[O_S] = final_s;
      o[O_DONE] = done;
      o[O_STOP] = stopped;
      o[O_OVFB] = ovf;
      o[O_OVFS] = alive && t >= p.S_CAP - 1;
      o[O_LS] = 0;
      o[O_NITER] = n_iter;
      o[O_LP] = last_ptr;
      o[O_SNC] = snap_cnt;
      o[OW_PAUSE] = alive && t < p.S_CAP - 1;
    }
    grid.sync();  // the next lane reuses the flags and the registry
  }
}

// ---------------------------------------------------------------------------
// The tiled variant.

// Lane scalars, kept by thread 0 of every block (identical copies).
struct Lane {
  long long n_iter;
  int t, wf_lo, wf_hi, t_lo, t_hi, last_ptr, snap_cnt, final_s;
  int done, stopped, ovf;
};

// One batch (slots are diagonals - anc).  Cycles t0 .. t0+kb-1 run, the
// tiles' halos are kp wide; cut >= 0 ends the batch with an extension-only
// cycle t0+cut (termination, or an overflow known at the start).  The
// tiles cover the written slots [c_lo, c_hi]: outer tiles of n left and
// right of the middle [m_lo, m_hi] = the committed band +- kp, whose
// first and last tiles (e_lo and e_hi slots wide) hold its two edges.
// n is the tiles' width this batch (at most the launch's n).
struct Plan {
  int t0, kb, cut, kp, snap, row, n;
  int c_lo, c_hi, m_lo, m_hi, e_lo, e_hi, n_ol, n_m, ntiles;
};

// log words of one batch (three sets, by batch count mod 3)
enum { LG_TERM, LG_MN, LG_MX, LG_WLO, LG_WHI, LG_Q, LG_TCYC, LG_TEXT,
       LG_LO = 8,
       LG_HI = LG_LO + K_MAX, LG_N = LG_HI + K_MAX };

__device__ __forceinline__ void reset_log(int* lg) {
  lg[LG_TERM] = BIG;
  lg[LG_MN] = BIG;
  lg[LG_MX] = -BIG;
  lg[LG_Q] = 0;
  lg[LG_TCYC] = lg[LG_TEXT] = 0;
}

// Slots [a, b] of tile j of the plan.
__device__ __forceinline__ void tile_range(const Plan& P, int n, int j, int& a,
                                           int& b) {
  if (j < P.n_ol) {
    a = P.c_lo + j * n;
    b = min(a + n - 1, P.m_lo - 1);
    return;
  }
  j -= P.n_ol;
  if (j < P.n_m) {
    if (j == 0) {
      a = P.m_lo;
      b = P.m_lo + P.e_lo - 1;
    } else if (j == P.n_m - 1) {
      a = P.m_hi - P.e_hi + 1;
      b = P.m_hi;
    } else {
      a = P.m_lo + P.e_lo + (j - 1) * n;
      b = min(a + n - 1, P.m_hi - P.e_hi);
    }
    return;
  }
  a = P.m_hi + 1 + (j - P.n_m) * n;
  b = min(a + n - 1, P.c_hi);
}

// The near part of a match run, lane by lane: the first word alone (most
// runs end in it), then two steps of four words whose loads are
// independent.  True with kn = extend's result when the run ends there or
// at the matrix edge; else false, its first `adv` characters matched.  A
// word at or past the cap is not read.
constexpr int NEAR_STEPS = 2;

__device__ __forceinline__ bool extend_near(const unsigned* tw,
                                            const unsigned* qw, int k, int d,
                                            int tl, int ql, int cpw, int logc,
                                            int bits, int logb, int& kn,
                                            int& adv) {
  const int cap = min(tl - 1 - k, ql - 1 - (d + k));
  const long long pt = (long long)k + 1, pq = (long long)d + k + 1;
  kn = k + max(cap, 0);
  if (cap <= 0) return true;
  const unsigned x0 = chars_at<true>(tw, pt, logc, bits, cpw) ^
                      chars_at<true>(qw, pq, logc, bits, cpw);
  if (x0) {
    kn = k + min((__ffs((int)x0) - 1) >> logb, cap);
    return true;
  }
  for (adv = cpw; adv < cap && adv < (1 + 4 * NEAR_STEPS) * cpw;
       adv += 4 * cpw) {
    unsigned x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int a = adv + u * cpw;
      x[u] = a < cap ? chars_at<true>(tw, pt + a, logc, bits, cpw) ^
                           chars_at<true>(qw, pq + a, logc, bits, cpw)
                     : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (x[u]) {
        kn = k + min(adv + u * cpw + ((__ffs((int)x[u]) - 1) >> logb), cap);
        return true;
      }
  }
  return adv >= cap;
}

// The rest of one lane's match run from `adv` on, by the whole warp (every
// lane calls it with the same arguments): 32 words a step, the first
// mismatch found by a ballot.  Returns extend's result.
__device__ __forceinline__ int extend_warp(const unsigned* tw,
                                           const unsigned* qw, int k, int d,
                                           int tl, int ql, int cpw, int logc,
                                           int bits, int logb, int adv) {
  const int lane = threadIdx.x & 31;
  const int cap = min(tl - 1 - k, ql - 1 - (d + k));
  const long long pt = (long long)k + 1, pq = (long long)d + k + 1;
  for (; adv < cap; adv += 32 * cpw) {
    const int a = adv + lane * cpw;
    const unsigned x = a < cap ? chars_at<true>(tw, pt + a, logc, bits, cpw) ^
                                     chars_at<true>(qw, pq + a, logc, bits, cpw)
                               : 0u;
    const unsigned m = __ballot_sync(0xffffffffu, x != 0);
    if (m) {
      const int f = __ffs((int)m) - 1;
      const unsigned xf = __shfl_sync(0xffffffffu, x, f);
      return k + min(adv + f * cpw + ((__ffs((int)xf) - 1) >> logb), cap);
    }
  }
  return k + cap;
}

// Stats of a tiled launch (int64): batches and reruns over the launch,
// then block 0's tiles and its clock64 cycles loading tiles, extending
// (from a cycle's start to the barrier after its extension), running
// cycles in all, writing tiles back and waiting at the grid barrier, and
// summed over the batches the slowest tile's cycles in all and the most
// cycles a tile spent extending.
enum { SS_BATCH, SS_RERUN, SS_TILES, SS_LOAD, SS_EXT, SS_CYC, SS_WRITE,
       SS_WAIT, SS_TCYC, SS_TEXT, SS_N };

// A source plane of a tile: slot s at tile[off + s], its band [lo, hi].
struct TSrc {
  int off, lo, hi;
};

// The read of a tile's source (the transition's reader): NEG outside the
// source's band when CHECK, unchecked for a cycle whose every source band
// covers the tile.
template <bool CHECK>
struct TileRead {
  const int* tile;
  int anc;
  __device__ __forceinline__ int operator()(const TSrc& q, int slot,
                                            size_t off = 0) const {
    if (CHECK) {
      const int d = anc + slot;
      if (d < q.lo || d > q.hi) return NEG;
    }
    return tile[q.off + (int)off + slot];
  }
};

// A cycle's sources and planes in a tile, the same for every thread:
// built by thread 0 ahead of the cycle's first barrier (double-buffered by
// cycle parity), read by all after it.
struct CycTab {
  SourcesOf<TSrc> S;
  int inb;   // every source band covers the loaded slots and their pads
  int o[9];  // offsets: E1, F1, E2, F2 of score t; H, E1, F1, E2, F2 of t+1
};

template <bool IS_P1>
__global__ void __launch_bounds__(THREADS) wide_tiled(Params p) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const bool lead = blockIdx.x == 0 && tid == 0;
  const int W = p.W;
  const size_t Wz = (size_t)W;
  const int ag_x = p.x, ag_o1 = p.o1 + p.e1, ag_o2 = p.o2 + p.e2;
  const int DH = max(ag_x, max(ag_o1, ag_o2));
  const int NS = DH + 1, RH = DH + 1;
  const int RE1 = max(p.e1, 1) + 1, RE2 = max(p.e2, 1) + 1;
  const int NP = RH + 2 * RE1 + 2 * RE2;
  const int NPL = NP * (IS_P1 ? 2 : 1) + 1;  // planes, lastv last
  const int cpw = p.cpw, bits = 32 / cpw;
  const int logc = cpw == 16 ? 4 : 2, logb = cpw == 16 ? 1 : 3;
  const int n = p.n, K = p.k;
  const int STR = tile_stride(n, K);
  const int poff = IS_P1 ? NP * STR : 0;
  const long long gth = (long long)gridDim.x * THREADS;
  const long long gid = (long long)blockIdx.x * THREADS + tid;

  extern __shared__ __align__(16) int sm[];
  int* bnd_lo = sm;
  int* bnd_hi = sm + RH;
  int* blo = sm + 2 * RH;  // bands of the batch's scores t0+1 ..
  int* bhi = blo + K + 1;
  int* tile = sm + tile_head(RH, K);
  __shared__ __align__(8) unsigned long long s_bar;  // the tile's copies
  __shared__ Lane L;
  __shared__ Plan P;
  __shared__ int s_flag[3], s_term, s_tile;
  __shared__ CycTab ctab[2];

  // slots [lo, hi] of every plane, src -> dst, by the whole grid
  auto carry = [&](const int* src, int* dst, int lo, int hi) {
    for (int pl = 0; pl < NPL; ++pl)
#pragma unroll 4
      for (long long s = lo + gid; s <= hi; s += gth)
        __stcg(dst + pl * Wz + s, __ldcg(src + pl * Wz + s));
  };

  if (tid == 0) {
    bar_init(&s_bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  unsigned phase = 0;  // parity of s_bar's current phase

  long long n_batch = 0, n_rerun = 0;
  long long ss[SS_N] = {};  // block 0's counters (its thread 0)
  const bool clk = blockIdx.x == 0 && tid == 0;
  long long c0 = 0, c1 = 0, u0 = 0, u1 = 0, uext = 0;
  for (int b = 0; b < p.B; ++b) {
    const long long* ln = p.lanes + (size_t)b * L_N;
    const int tl = (int)ln[L_TL], ql = (int)ln[L_QL], anc = (int)ln[L_ANC];
    const long long max_s = ln[L_MS], max_iter = ln[L_MI];
    const int d_end = ql - tl;
    int* planes = p.planes + (size_t)b * NPL * Wz;
    const unsigned* tw = p.tw + (size_t)b * p.nw;
    const unsigned* qw = p.qw + (size_t)b * p.nw;
    long long* sr = p.state + (size_t)b * p.st_n;
    const long long lim = min(p.t_lim[b], (long long)p.S_CAP - 1);
    if (tid == 0) {
      L.t = (int)sr[ST_T];
      L.wf_lo = (int)sr[ST_WLO];
      L.wf_hi = (int)sr[ST_WHI];
      L.t_lo = (int)sr[ST_TLO];
      L.t_hi = (int)sr[ST_THI];
      L.n_iter = sr[ST_NITER];
      L.last_ptr = (int)sr[ST_LP];
      L.snap_cnt = (int)sr[ST_SNC];
      L.final_s = (int)sr[ST_S];
      L.done = sr[ST_DONE] != 0;
      L.stopped = sr[ST_STOP] != 0;
      L.ovf = sr[ST_OVFB] != 0;
    }
    for (int j = tid; j < RH; j += THREADS) {
      bnd_lo[j] = (int)sr[ST_BND + j];
      bnd_hi[j] = (int)sr[ST_BND + RH + j];
    }
    if (lead)
      for (int q = 0; q < 3; ++q) reset_log(p.flags + q * LG_N);
    grid.sync();

    bool scr = false;  // the lane's planes are in the scratch buffer
    int cp_lo = 0, cp_hi = W - 1;  // written by the previous batch
    int nb = 0;
    for (;;) {
      // --- the batch's plan (thread 0; the same in every block)
      if (tid == 0) {
        P.kb = 0;
        if (!(L.done || L.stopped || L.ovf) && L.t < lim) {
          const int t0 = L.t;
          const int* Pc = scr ? p.scratch : planes;
          bnd_lo[t0 % RH] = L.t_lo;
          bnd_hi[t0 % RH] = L.t_hi;
          const int lo0 = max(L.wf_lo - 1, -tl), hi0 = min(L.wf_hi + 1, ql);
          const bool ovf0 = lo0 < anc || hi0 > anc + W - 1;
          const bool snapb = IS_P1 && (t0 + 1) % p.step == 0;
          const int row = snapb ? (t0 + 1) / p.step - 1 : 0;
          const bool stop0 = ovf0 || (snapb && row >= p.n_snap);
          // a snapshot cycle's own termination decides whether its
          // snapshot is taken: extend the end diagonal here
          bool term0 = false;
          const int se = d_end - anc;
          if (snapb && !stop0 && d_end >= L.t_lo && d_end <= L.t_hi &&
              se >= 0 && se < W) {
            const int k = __ldcg(Pc + (size_t)(t0 % RH) * Wz + se);
            if (k >= -1 && d_end + k >= -1 && k < tl && d_end + k < ql)
              term0 = extend<true>(tw, qw, k, d_end, tl, ql, cpw, logc,
                                   bits, logb) == tl - 1;
          }
          int kb = 1, cut = 0;
          if (!(stop0 || term0)) {
            // the batch ends where an event could fall inside it
            cut = -1;
            kb = (int)min((long long)K, lim - t0);
            kb = min(kb, 256 - (t0 & 0xFF));  // the shrink cycle
            if (max_s > 0) kb = (int)min((long long)kb, max_s - t0 + 1);
            if (IS_P1) {
              const int r = (t0 + 1) % p.step;
              kb = min(kb, r ? p.step - r : p.step);
            }
            if (-tl < anc) kb = min(kb, max(1, L.wf_lo - anc));
            if (ql > anc + W - 1) kb = min(kb, max(1, anc + W - 1 - L.wf_hi));
            if (max_iter > 0) {
              // the band grows at most one diagonal a side a cycle
              const long long w0 = L.wf_hi - L.wf_lo + 1;
              long long cum = L.n_iter;
              for (int j = 0; j + 1 < kb; ++j) {
                cum += w0 + 2 + 2 * j;
                if (cum > max_iter) {
                  kb = j + 1;
                  break;
                }
              }
            }
          }
          const int kp = kb;
          P.t0 = t0;
          P.kb = kb;
          P.cut = cut;
          P.kp = kp;
          P.snap = snapb && !stop0 && !term0;
          P.row = row;
          int clo = min(L.t_lo, L.wf_lo - kp), chi = max(L.t_hi, L.wf_hi + kp);
          if (P.snap)  // the pointer reset touches every ring score's band
            for (int s = max(0, t0 - RH + 1); s <= t0; ++s)
              if (bnd_lo[s % RH] <= bnd_hi[s % RH]) {
                clo = min(clo, bnd_lo[s % RH]);
                chi = max(chi, bnd_hi[s % RH]);
              }
          P.c_lo = max(clo - anc, 0);
          P.c_hi = min(chi - anc, W - 1);
          // tiles of n_eff output slots: the band spread over the grid,
          // at least a slot a thread, at most n (two cells a thread
          // overlap their latencies once the tiles pass one wave)
          const int cw = P.c_hi - P.c_lo + 1;
          const int n_eff = min(n, max(max(THREADS - 2 * kp, 1),
                                       (cw + (int)gridDim.x - 1) /
                                           (int)gridDim.x));
          P.n = n_eff;
          int m_lo = max(L.wf_lo - kp - anc, P.c_lo);
          int m_hi = min(L.wf_hi + kp - anc, P.c_hi);
          const int len = m_hi - m_lo + 1;
          const int N = max(n_eff, 4 * kp), E = max(n_eff, 2 * kp);
          int n_m;
          if (len <= 0) {
            m_lo = P.c_hi + 1;
            m_hi = P.c_hi;
            n_m = 0;
          } else if (len <= N) {
            n_m = 1;
            P.e_lo = len;
            P.e_hi = 0;
          } else if (len < 2 * E) {
            n_m = 2;
            P.e_lo = (len + 1) / 2;
            P.e_hi = len - P.e_lo;
          } else {
            P.e_lo = P.e_hi = E;
            n_m = 2 + (len - 2 * E + n_eff - 1) / n_eff;
          }
          P.m_lo = m_lo;
          P.m_hi = m_hi;
          P.n_m = n_m;
          P.n_ol = max(m_lo - P.c_lo, 0) / n_eff +
                   (max(m_lo - P.c_lo, 0) % n_eff != 0);
          const int rt = max(P.c_hi - m_hi, 0);
          P.ntiles = P.n_ol + n_m + rt / n_eff + (rt % n_eff != 0);
        }
      }
      __syncthreads();
      if (P.kb == 0) break;
      int kb = P.kb, cut = P.cut;
      for (int pass = 0;; ++pass) {
        const int* Pc = scr ? p.scratch : planes;
        int* Pn = scr ? planes : p.scratch;
        int* lg = p.flags + (nb % 3) * LG_N;
        if (lead) reset_log(p.flags + ((nb + 1) % 3) * LG_N);
        // the previous batch's slots this one does not write
        carry(Pc, Pn, cp_lo, min(cp_hi, P.c_lo - 1));
        carry(Pc, Pn, max(cp_lo, P.c_hi + 1), cp_hi);

        // --- the tiles, from an atomic queue
        for (;;) {
          if (tid == 0) s_tile = atomicAdd(lg + LG_Q, 1);
          // the block's generic accesses of the tile (and the grid's plane
          // writes before the last grid barrier) before the bulk copies
          asm volatile("fence.proxy.async;" ::: "memory");
          __syncthreads();
          const int jt = s_tile;
          if (jt >= P.ntiles) break;
          int a, e;
          tile_range(P, P.n, jt, a, e);
          if (clk) c0 = clock64();
          const int la = max(a - P.kp, 0), lb = min(e + P.kp, W - 1);
          // plane pl of the tile at tile[at(pl) + slot]
          const int la4 = la & ~3;
          auto at = [&](int pl) { return pl * STR + 4 - la4; };
          // one bulk copy a plane of slots [la & ~3, lb | 3] (W % 4 == 0),
          // then NEG pads at la - 1 and lb + 1
          const unsigned row_b = (unsigned)((lb | 3) - la4 + 1) * 4u;
          if (tid == 0) bar_expect(&s_bar, row_b * NPL);
          for (int pl = tid; pl < NPL; pl += THREADS)
            bulk_copy(tile + (size_t)pl * STR + 4, Pc + pl * Wz + la4, row_b,
                      &s_bar);
          bar_wait(&s_bar, phase);
          phase ^= 1;
          for (int pl = tid; pl < NPL; pl += THREADS) {
            tile[at(pl) + la - 1] = NEG;
            tile[at(pl) + lb + 1] = NEG;
          }
          if (tid == 0) s_term = s_flag[0] = s_flag[1] = s_flag[2] = 0;
          __syncthreads();
          if (clk) {
            c1 = clock64();
            ss[SS_LOAD] += c1 - c0;
            ++ss[SS_TILES];
          }
          if (tid == 0) {
            u0 = clock64();
            uext = 0;
          }

          const int oLv = at(NPL - 1);
          const int A = anc + a, Bd = anc + e;  // output diagonals
          const int t0 = P.t0;
          // the tile's band: exact in the tiles that hold an edge (they
          // see every boundary commit), and inside every tile elsewhere
          int wlo = L.wf_lo, whi = L.wf_hi, tlo = L.t_lo, thi = L.t_hi;
          int lo = 0, hi = -1, i = 0;
          // ring slots of score t (t % RH, t % RE1, t % RE2), advanced a
          // cycle at a time: no division in the cycle loop
          int hs = t0 % RH, r1 = t0 % RE1, r2 = t0 % RE2;
          const int pE1 = RH, pF1 = RH + RE1, pE2 = RH + 2 * RE1,
                    pF2 = RH + 2 * RE1 + RE2;
          bool term = false;
          for (; i < kb; ++i) {
            const int t = t0 + i;
            if (i > 0) {
              tlo = lo;
              thi = hi;
            }
            if (tid == 0) {
              u1 = clock64();
              // the source of age a (1 <= a <= depth-1): score t+1-a, its
              // slot `cur`+1-a wrapped, its band logged in the batch (blo)
              // or recorded before it (the registry, at its H slot)
              auto mk = [&](int base, int cur, int depth, int age) {
                int sl = cur + 1 - age;
                sl += sl < 0 ? depth : 0;
                TSrc r;
                r.off = at(base + sl);
                if (age > t + 1) {
                  r.lo = 1;
                  r.hi = 0;
                } else if (age <= i) {
                  r.lo = blo[i + 1 - age];
                  r.hi = bhi[i + 1 - age];
                } else {
                  int hsl = hs + 1 - age;
                  hsl += hsl < 0 ? RH : 0;
                  r.lo = bnd_lo[hsl];
                  r.hi = bnd_hi[hsl];
                }
                return r;
              };
              CycTab& c = ctab[i & 1];
              c.S = SourcesOf<TSrc>{
                  mk(0, hs, RH, ag_x),    mk(0, hs, RH, ag_o1),
                  mk(0, hs, RH, ag_o2),   mk(pE1, r1, RE1, p.e1),
                  mk(pF1, r1, RE1, p.e1), mk(pE2, r2, RE2, p.e2),
                  mk(pF2, r2, RE2, p.e2)};
              const int dlo = anc + la - 1, dhi = anc + lb + 1;
              auto covers = [&](const TSrc& q) {
                return q.lo <= dlo && q.hi >= dhi;
              };
              c.inb = covers(c.S.x) && covers(c.S.h1) && covers(c.S.h2) &&
                      covers(c.S.e1) && covers(c.S.f1) && covers(c.S.e2) &&
                      covers(c.S.f2);
              const int h1 = hs + 1 == RH ? 0 : hs + 1;
              const int n1 = r1 + 1 == RE1 ? 0 : r1 + 1;
              const int n2 = r2 + 1 == RE2 ? 0 : r2 + 1;
              c.o[0] = at(pE1 + r1);
              c.o[1] = at(pF1 + r1);
              c.o[2] = at(pE2 + r2);
              c.o[3] = at(pF2 + r2);
              c.o[4] = at(h1);
              c.o[5] = at(pE1 + n1);
              c.o[6] = at(pF1 + n1);
              c.o[7] = at(pE2 + n2);
              c.o[8] = at(pF2 + n2);
            }
            // --- extension of the top band: each thread its own cells
            // through their near part, then each warp its lanes' longer
            // runs one by one (the loop is uniform over a warp)
            const int oHt = at(hs);
            for (int base = la; base <= lb; base += THREADS) {
              const int s = base + tid, d = anc + s;
              int k = 0, kn = 0, adv = 0;
              bool todo = false, near = true;
              if (s <= lb && d >= tlo && d <= thi) {
                k = tile[oHt + s];
                todo = k >= -1 && d + k >= -1 && k < tl && d + k < ql;
                if (todo)
                  near = extend_near(tw, qw, k, d, tl, ql, cpw, logc, bits,
                                     logb, kn, adv);
              }
              for (unsigned pend = __ballot_sync(0xffffffffu, !near); pend;
                   pend &= pend - 1) {
                const int src = __ffs((int)pend) - 1;
                const int r = extend_warp(
                    tw, qw, __shfl_sync(0xffffffffu, k, src),
                    __shfl_sync(0xffffffffu, d, src), tl, ql, cpw, logc, bits,
                    logb, __shfl_sync(0xffffffffu, adv, src));
                if ((tid & 31) == src) kn = r;
              }
              if (!todo) continue;
              tile[oHt + s] = kn;
              if (d == d_end && kn == tl - 1 && d >= A && d <= Bd) {
                s_term = 1;
                atomicMin(lg + LG_TERM, i);
              }
            }
            __syncthreads();
            if (tid == 0) uext += clock64() - u1;
            if (i > 0) {  // the boundary commit of cycle t-1
              const int f = s_flag[(i - 1) % 3];
              if (f & 1) wlo = lo;
              if (f & 2) whi = hi;
            }
            if (i == cut) break;  // the extension-only cycle
            if (s_term) {
              term = true;
              break;
            }
            if (tid == 0 && i >= 2) s_flag[(i + 1) % 3] = 0;
            lo = max(wlo - 1, -tl);
            hi = min(whi + 1, ql);
            if (tid == 0) {
              blo[i + 1] = lo;
              bhi[i + 1] = hi;
              if (lo >= A && lo <= Bd) lg[LG_LO + i] = lo;
              if (hi >= A && hi <= Bd) lg[LG_HI + i] = hi;
            }
            // --- PASS1 snapshot (the batch's first cycle): the output
            // cells go to the row, every loaded in-band cell is reset
            if (IS_P1 && i == 0 && P.snap) {
              int* srow = p.snap + ((size_t)b * p.n_snap + P.row) * NP * Wz;
              for (int pl = 0; pl < NP; ++pl) {
                int depth, jj;
                plane_slot(pl, RH, RE1, RE2, depth, jj);
                const int sj = t - ((t - jj) % depth + depth) % depth;
                if (sj < 0) continue;
                const int bl = bnd_lo[sj % RH], bh = bnd_hi[sj % RH];
                const int oP = at(NP + pl);
                for (int s = la + tid; s <= lb; s += THREADS) {
                  const int d = anc + s;
                  if (d < bl || d > bh) continue;
                  if (d >= A && d <= Bd)
                    __stcg(srow + pl * Wz + s, tile[oP + s]);
                  tile[oP + s] = pl * W + s;
                }
              }
              __syncthreads();
            }
            // --- lastv of the retired slice + transition into t+1, from
            // the cycle's table
            const CycTab& ct = ctab[i & 1];
            const SourcesOf<TSrc> S = ct.S;
            const bool inb = ct.inb;
            const int oE1t = ct.o[0], oF1t = ct.o[1], oE2t = ct.o[2];
            const int oF2t = ct.o[3], oHn = ct.o[4], oE1n = ct.o[5];
            const int oF1n = ct.o[6], oE2n = ct.o[7], oF2n = ct.o[8];
            hs = hs + 1 == RH ? 0 : hs + 1;  // score t+1's slots
            r1 = r1 + 1 == RE1 ? 0 : r1 + 1;
            r2 = r2 + 1 == RE2 ? 0 : r2 + 1;
            auto update = [&](const auto& rd) {
              bool loq = false, hiq = false;
              for (int s = la + tid; s <= lb; s += THREADS) {
                const int d = anc + s;
                if (d >= tlo && d <= thi &&
                    (good_diag(tile[oHt + s], d, tl, ql) ||
                     good_diag(tile[oE1t + s], d, tl, ql) ||
                     good_diag(tile[oF1t + s], d, tl, ql) ||
                     good_diag(tile[oE2t + s], d, tl, ql) ||
                     good_diag(tile[oF2t + s], d, tl, ql)))
                  tile[oLv + s] = t + 1;
                if (d < lo || d > hi) continue;
                const Cell c = transition_by(rd, S, s);
                tile[oHn + s] = c.h;
                tile[oE1n + s] = c.e1;
                tile[oF1n + s] = c.f1;
                tile[oE2n + s] = c.e2;
                tile[oF2n + s] = c.f2;
                if (IS_P1) {
                  const Cell q = pointers_by(rd, S, s, poff, c.tb);
                  tile[oHn + poff + s] = q.h;
                  tile[oE1n + poff + s] = q.e1;
                  tile[oF1n + poff + s] = q.f1;
                  tile[oE2n + poff + s] = q.e2;
                  tile[oF2n + poff + s] = q.f2;
                }
                if (any_viable(c) && d >= A && d <= Bd) {
                  loq |= d == lo;
                  hiq |= d == hi;
                }
              }
              if (loq || hiq)
                atomicOr(&s_flag[i % 3], (loq ? 1 : 0) | (hiq ? 2 : 0));
            };
            if (inb)
              update(TileRead<false>{tile, anc});
            else
              update(TileRead<true>{tile, anc});
          }
          __syncthreads();
          if (tid == 0) {
            const long long u = clock64();
            atomicMax(lg + LG_TCYC, (int)min(u - u0, (long long)BIG));
            atomicMax(lg + LG_TEXT, (int)min(uext, (long long)BIG));
            if (clk) {
              c0 = u;
              ss[SS_CYC] += c0 - c1;
              ss[SS_EXT] += uext;
            }
          }
          if (term) continue;  // the batch runs again, cut there
          if (i == kb) {
            const int f = s_flag[(kb - 1) % 3];
            if (f & 1) wlo = lo;
            if (f & 2) whi = hi;
          }
          if (tid == 0 && i > 0) {  // i full cycles ran
            if (lo >= A && lo <= Bd) lg[LG_WLO] = wlo;
            if (hi >= A && hi <= Bd) lg[LG_WHI] = whi;
          }
          // --- the shrink hull's share of the output cells
          if (i == kb && ((t0 + kb) & 0xFF) == 0) {
            const int tn = t0 + kb;
            const int vfloor = viable_floor(tn - 1, NS);
            const int oH = at(tn % RH), oE1 = at(RH + tn % RE1);
            const int oF1 = at(RH + RE1 + tn % RE1);
            const int oE2 = at(RH + 2 * RE1 + tn % RE2);
            const int oF2 = at(RH + 2 * RE1 + RE2 + tn % RE2);
            int mn = BIG, mx = -BIG;
            for (int s = la + tid; s <= lb; s += THREADS) {
              const int d = anc + s;
              if (d < A || d > Bd || d < wlo || d > whi) continue;
              const bool top =
                  d >= lo && d <= hi &&
                  (tile[oH + s] >= -1 || tile[oE1 + s] >= -1 ||
                   tile[oF1 + s] >= -1 || tile[oE2 + s] >= -1 ||
                   tile[oF2 + s] >= -1);
              if (top || tile[oLv + s] >= vfloor) {
                mn = min(mn, d);
                mx = max(mx, d);
              }
            }
            mn = __reduce_min_sync(0xffffffffu, mn);
            mx = __reduce_max_sync(0xffffffffu, mx);
            if ((tid & 31) == 0 && mx >= mn) {
              atomicMin(lg + LG_MN, mn);
              atomicMax(lg + LG_MX, mx);
            }
          }
          // --- write-back of the output cells, every plane
          for (int pl = 0; pl < NPL; ++pl) {
            const int* src = tile + at(pl) + a;
            int* dst = Pn + pl * Wz + a;
            for (int c = tid; c <= e - a; c += THREADS) __stcg(dst + c, src[c]);
          }
          if (clk) ss[SS_WRITE] += clock64() - c0;
        }
        if (clk) c0 = clock64();
        grid.sync();
        if (clk) {
          ss[SS_WAIT] += clock64() - c0;
          ss[SS_TCYC] += __ldcg(lg + LG_TCYC);
          ss[SS_TEXT] += __ldcg(lg + LG_TEXT);
        }
        ++nb;
        ++n_batch;
        if (pass == 0 && cut < 0) {
          const int tj = __ldcg(lg + LG_TERM);
          if (tj < BIG) {  // terminated inside: run it again, cut there
            kb = tj + 1;
            cut = tj;
            ++n_rerun;
            continue;
          }
        }
        // --- the lane's scalars after the batch
        if (tid == 0) {
          const int t0 = P.t0;
          const int nfull = cut >= 0 ? cut : kb, last = cut >= 0 ? cut : kb - 1;
          for (int i = 1; i <= last; ++i) {
            bnd_lo[(t0 + i) % RH] = __ldcg(lg + LG_LO + i - 1);
            bnd_hi[(t0 + i) % RH] = __ldcg(lg + LG_HI + i - 1);
          }
          for (int i = 0; i < nfull; ++i)
            L.n_iter += __ldcg(lg + LG_HI + i) - __ldcg(lg + LG_LO + i) + 1;
          if (nfull > 0) {
            L.t_lo = __ldcg(lg + LG_LO + nfull - 1);
            L.t_hi = __ldcg(lg + LG_HI + nfull - 1);
            L.wf_lo = __ldcg(lg + LG_WLO);
            L.wf_hi = __ldcg(lg + LG_WHI);
          }
          if (P.snap) ++L.snap_cnt;
          if (cut >= 0) {
            if (__ldcg(lg + LG_TERM) == cut) {
              L.done = 1;
              L.final_s = t0 + cut;
              if (IS_P1)
                L.last_ptr = __ldcg(Pn + (size_t)(NP + (t0 + cut) % RH) * Wz +
                                    (d_end - anc));
            } else {
              L.ovf = 1;
            }
            L.t = t0 + cut + 1;
          } else {
            const int tz = t0 + kb - 1;
            if (((tz + 1) & 0xFF) == 0) {
              const int mn = __ldcg(lg + LG_MN), mx = __ldcg(lg + LG_MX);
              if (mx >= mn) {
                L.wf_lo = mn;
                L.wf_hi = mx;
              }
            }
            L.stopped = (max_iter > 0 && L.n_iter > max_iter) ||
                        (max_s > 0 && tz + 1 > max_s);
            L.t = tz + 1;
          }
        }
        __syncthreads();
        break;
      }
      scr = !scr;
      cp_lo = P.c_lo;
      cp_hi = P.c_hi;
    }
    if (scr) {  // the last batch wrote the scratch buffer
      carry(p.scratch, planes, cp_lo, cp_hi);
      grid.sync();
    }
    if (lead) {
      sr[ST_T] = L.t;
      sr[ST_WLO] = L.wf_lo;
      sr[ST_WHI] = L.wf_hi;
      sr[ST_TLO] = L.t_lo;
      sr[ST_THI] = L.t_hi;
      sr[ST_NITER] = L.n_iter;
      sr[ST_LP] = L.last_ptr;
      sr[ST_SNC] = L.snap_cnt;
      sr[ST_S] = L.final_s;
      sr[ST_DONE] = L.done;
      sr[ST_STOP] = L.stopped;
      sr[ST_OVFB] = L.ovf;
      for (int j = 0; j < RH; ++j) {
        sr[ST_BND + j] = bnd_lo[j];
        sr[ST_BND + RH + j] = bnd_hi[j];
      }
      const bool alive = !(L.done || L.stopped || L.ovf);
      long long* o = p.out + (size_t)b * OW_N;
      o[O_S] = L.final_s;
      o[O_DONE] = L.done;
      o[O_STOP] = L.stopped;
      o[O_OVFB] = L.ovf;
      o[O_OVFS] = alive && L.t >= p.S_CAP - 1;
      o[O_LS] = 0;
      o[O_NITER] = L.n_iter;
      o[O_LP] = L.last_ptr;
      o[O_SNC] = L.snap_cnt;
      o[OW_PAUSE] = alive && L.t < p.S_CAP - 1;
    }
    grid.sync();  // the next lane reuses the log, the registry, the scratch
  }
  if (lead) {
    ss[SS_BATCH] = n_batch;
    ss[SS_RERUN] = n_rerun;
    for (int j = 0; j < SS_N; ++j) p.stats[j] = ss[j];
  }
}

// The instantiation of a variant and mode: SCORE compiles no pointer code.
const void* kernel_of(int variant, int mode) {
  const bool p1 = mode == MODE_PASS1;
  if (variant == V_CYCLE)
    return p1 ? (const void*)wide_cycle<true> : (const void*)wide_cycle<false>;
  return p1 ? (const void*)wide_tiled<true> : (const void*)wide_tiled<false>;
}

// Dynamic shared memory of a launch: the band registry, and for "tile" the
// batch's band log and the tile's planes (ops/wavefront_wide.py::tile_smem).
long long smem_of(int variant, int mode, int RH, int NP, int n, int k) {
  long long ints = 2LL * RH;
  if (variant == V_TILE)
    ints = tile_head(RH, k) +
           (long long)(NP * (mode == MODE_PASS1 ? 2 : 1) + 1) *
               tile_stride(n, k);
  return ints * (long long)sizeof(int);
}

// smem_of at these penalties (RH ring slots of H, NP planes).
long long launch_smem(int variant, int mode, int x, int o1, int e1, int o2,
                      int e2, int n, int k) {
  const int RH = max(x, max(o1 + e1, o2 + e2)) + 1;
  const int NP = RH + 2 * (max(e1, 1) + 1) + 2 * (max(e2, 1) + 1);
  return smem_of(variant, mode, RH, NP, n, k);
}

cudaError_t prepare(int variant, int mode, int x, int o1, int e1, int o2,
                    int e2, int n, int k, int* smem) {
  if (variant != V_TILE && variant != V_CYCLE) return cudaErrorInvalidValue;
  if (variant == V_TILE && (n < 1 || k < 1 || k > K_MAX))
    return cudaErrorInvalidValue;
  const long long bytes = launch_smem(variant, mode, x, o1, e1, o2, e2, n, k);
  if (bytes > (1 << 30)) return cudaErrorInvalidValue;
  *smem = (int)bytes;
  if (*smem <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel_of(variant, mode),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

}  // namespace

// The dynamic shared memory a tiled block in `mode` may opt in to on the
// current card: the card's opt-in limit less the kernel's static shared
// memory, as the runtime reports both.
extern "C" int mwf_wide_smem_optin(int mode, int* bytes) {
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel_of(V_TILE, mode));
  if (err != cudaSuccess) return (int)err;
  *bytes = optin - (int)fa.sharedSizeBytes;
  return 0;
}

// The dynamic shared memory a launch of `variant` in `mode` at these
// penalties and tile asks for (ops/wavefront_wide.py::tile_smem).
extern "C" int mwf_wide_smem(int variant, int mode, int x, int o1, int e1,
                             int o2, int e2, int n, int k, long long* bytes) {
  *bytes = launch_smem(variant, mode, x, o1, e1, o2, e2, n, k);
  return 0;
}

// Blocks of one cooperative launch of `variant` in `mode` at these
// penalties (and, for "tile", n and k): as many as can be co-resident.
extern "C" int mwf_wide_grid(int variant, int mode, int x, int o1, int e1,
                             int o2, int e2, int n, int k, int* blocks) {
  int dev, per_sm = 0, smem;
  cudaError_t err = prepare(variant, mode, x, o1, e1, o2, e2, n, k, &smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceProp prop;
  err = cudaGetDeviceProperties(&prop, dev);
  if (err != cudaSuccess) return (int)err;
  if (!prop.cooperativeLaunch) return (int)cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_of(variant, mode), THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * prop.multiProcessorCount;
  return *blocks > 0 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

extern "C" int mwf_wide(const long long* lanes, const unsigned* tw,
                        const unsigned* qw, long long nw, long long* state,
                        int st_n, const long long* t_lim, int* planes,
                        int* snap, long long* out, int* flags, int* scratch,
                        long long* stats, int B, int W, int S_CAP, int mode,
                        int cpw, int x, int o1, int e1, int o2, int e2,
                        int step, int n_snap, int variant, int n, int k,
                        int blocks, void* stream) {
  Params p{lanes, tw, qw, nw, state, st_n, t_lim, planes, snap, out, flags,
           scratch, stats, B, W, S_CAP, mode, cpw, x, o1, e1, o2, e2, step,
           n_snap, n, k};
  void* args[] = {&p};
  int smem;
  cudaError_t err = prepare(variant, mode, x, o1, e1, o2, e2, n, k, &smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel(kernel_of(variant, mode), dim3(blocks),
                                    dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
