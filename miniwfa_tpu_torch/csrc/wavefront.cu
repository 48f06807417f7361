// K1: the fused-cycle WFA wavefront kernel for Hopper (sm_90a), SCORE, TB
// and PASS1 modes, with the pass-2 checkpoint collapse, one lane per
// thread-block cluster; and K4, the same kernel with several lanes per
// block (SCORE, TB and TB+seg).
//
// Replaces miniwfa_tpu/ops/wavefront_kernel.py::build_kernel (K1) and
// miniwfa_tpu/ops/wavefront_multi.py::build_kernel (K4, G co-resident
// lanes per grid step), the Pallas TPU kernels.  Same semantics, which mirror lh3/miniwfa mwf_wfa_core
// (miniwfa.c:380-435); the plain PyTorch twin is
// miniwfa_tpu_torch/ops/wavefront_kernel.py::wavefront_plain, and the
// module docstring there describes the state layout both share.
//
// The per-diagonal code (extension probe, band-masked reads, the 5-state
// transition of one cell, the PASS1 pointer choice) lives in
// wavefront_common.cuh, shared with the wide kernel (wavefront_wide.cu).
//
// Design: one group of threads per lane runs that lane's whole `while s +=
// 1` loop.  K1 (LPB = 1) spreads a lane over a thread-block cluster of C
// CTAs of 512 threads (C in {1, 2, 4, 8, 16}, picked by the wrapper from
// the count of co-resident clusters; C = 1 is a plain launch of one block
// per lane).  K4 (LPB = G in {2, 4, 8}, C = 1) splits a block into G
// groups of 512/G threads, group g owning lane blockIdx.x * G + g, with
// its own band registry and flags in shared memory and its own named
// barrier (bar.sync 1+g, 512/G), so the lanes of a block advance
// independently (the TPU kernel's shared cycle loop was a Pallas
// constraint, not semantics); groups past the last lane exit at once.
// Every thread of a lane (in every CTA of its cluster) keeps an identical
// copy of the lane's scalars (score t, committed band wf_lo/wf_hi, top
// band t_lo/t_hi, flags, n_iter) and updates them from identical flags, so
// no broadcast of the scalars is needed.  In each pass over a diagonal
// span, CTA rank r of the cluster takes the r-th contiguous share of the
// span and strides it with its threads.  A cycle t is:
//   1. termination at score t, found by the transition that wrote score t
//      (or the prologue, for score 0): last_state (TB) is that cell's own
//      tb state on a zero-extension termination, last_ptr (PASS1) its H
//      pointer.
//   2. pass-2 checkpoint collapse (miniwfa.c:413-416), a uniform scalar
//      update, then band growth and the window-overflow check.
//   3. PASS1 snapshot, on its cycles, then a lane barrier.
//   4. shrink viability of the retired score-t slice (lastv) + the 5-state
//      transition into score t+1 over [min(t_lo,lo), max(t_hi,hi)], with
//      the exact '>=' / '<' tie-breaks of wf_next_tb (miniwfa.c:287-307);
//      TB mode stores the 7-bit byte at tb[t][d - anc].  The thread that
//      computes H at diagonal d extends it at once along its match run
//      (miniwfa.c:400-411: the extension of a diagonal reads nothing of
//      any other), reading the flat packed word streams straight from
//      global memory (a funnel shift for unaligned probes and __ffs of the
//      XOR for the first mismatch, capped at the matrix edge
//      min(tl-1-k, ql-1-(d+k))), stores the extended value, and reports
//      score t+1's termination at d_end.  Then the cycle's one lane
//      barrier.
//   5. every 256 cycles, the shrink hull (a min/max over the cluster) and
//      its barrier.
//   6. accounting (n_iter adds the grown width on transition cycles only)
//      and the max_s / max_iter stops, which end the loop before the
//      termination found at score t+1 is read: the reference never ran
//      that extension (miniwfa.c:421-425).
//
// Flags (termination with its last_state / last_ptr, the boundary-commit
// flags, the shrink hull) live in each CTA's shared memory.  A flag's rare
// writer (the thread of the cell at d_end, lo or hi) sets it in its own
// CTA; with C > 1, after a block barrier, thread 0 of the CTA that owns
// the cell stores it into every CTA of the cluster (distributed shared
// memory), as each CTA's thread 0 does with its share of the shrink hull,
// so no store to another SM sits in the hot loop; after the cluster
// barrier every thread reads its own CTA's copy.  Flags carry the cycle (termination: the score) they
// belong to instead of being cleared, double-buffered by parity: with one
// barrier a cycle, the set cycle t+2 writes was last read before barrier
// t+1.  Each CTA keeps its own band registry with the same values, the
// entry of score t+1 written after the transition that reads none of it.
//
// Cross-SM coherence.  Ring planes stay in global memory; a slot may have
// been written by another SM of the cluster, so with C > 1 every plane
// read is ld.global.cg (L2, never a stale L1 line) and every plane store
// st.global.cg, and the barrier is the cluster's (barrier.cluster
// arrive.release / wait.acquire).  With C = 1 one block owns the lane and
// __syncthreads orders plain loads, as before.
//
// Low-mem stripe mode (reference mwf_wfa_seg, miniwfa.c:551-601).  PASS1
// keeps a pointer plane beside every value plane, laid out as the value
// rings one block further on (`poff`), so a source's pointer sits at the
// same slot offset as its value.  The transition copies the pointer of the
// source its tb bits chose.  A snapshot (when (t+1) % step == 0, after
// growth and before the transition) is one pass over every ring slot's
// recorded band: copy the pointer into snapshot row c, then reset it to
// its own flat index plane*W + w; each element is read and rewritten by
// the same thread, and one barrier fences the pass from the transition's
// neighbour reads.  Outside a slot's band nothing is written: band-masked
// reads never look there.
//
// State lives in global memory: at W=65536 with the default penalties the
// rings take 27 planes of 256 KB per lane, far past the 227 KB of shared
// memory.  Each state kind's ring is one deeper than its largest age, so
// score t+1 is written while every source score stays intact (the "tops"
// are the ring slot of score t, and age-1 sources read it like any other).
// Ring reads are masked by the band recorded for the source score in a
// shared-memory registry (2 x RH ints of dynamic shared memory per lane):
// stale slots, negative source scores and neighbours outside the window
// read as WF_NEG_INF, so no plane is ever cleared.  The shrink hull uses
// the good-diagonal test only for the retired slices of scores t-NS+2..t
// (the stale slice t-NS+1 is excluded) and ">= -1" for the new tops (the
// extension keeps a value >= -1 so).  One int32 plane `lastv` holds, per
// slot, one past the last score whose retired slice was viable there (0:
// never), set during the transition pass over the update span; every slot
// the shrink reads lies in [wf_lo, wf_hi], inside this cycle's span, so
// the plane is exact for any NS and no penalty set is bounded by it.
// Under edit-distance penalties every age is 1.  At cpw=4 the words hold
// raw bytes, so the compare is case-sensitive like the reference's (the
// `lower_n` golden).  Empty sequences need no special case: the extension
// cap min(tl-1-k, ql-1-(d+k)) is 0 at k = -1, and an anchor that leaves
// d=0 outside the window overflows at the first cycle.
//
// What bounds it: a cycle is one barrier plus O(band / (512 C)) work per
// thread, each diagonal ≈13 ring loads and ≈6 stores through L2, so the
// barrier's latency and the L2 traffic of the ring planes set the pace.
// Clusters put up to 16 SMs on a lane where one block per lane left 116 of
// the 132 SMs idle on a batch of 16; the fused extension removes a pass
// over the top band and a barrier from every cycle.  K4 here is the
// "global" variant, for windows whose rings do not fit shared memory: G
// lanes share an SM's block slots, each with 512/G threads.  Lanes that
// fit take K4's "smem" variant (wavefront_multi.cu: a warp per lane, its
// rings in shared memory).

#include <cooperative_groups.h>

#include "wavefront_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mwf;

constexpr int THREADS = 512;
constexpr int CMAX = 16;  // largest cluster (non-portable past 8)

struct Params {
  const long long* lanes;     // [B, L_N]
  const unsigned* tw;         // [B, nw] flat packed words
  const unsigned* qw;
  long long nw;
  int* planes;                // [B, NP (x2 in PASS1) + 1, W]
  long long* out;             // [B, O_N]
  unsigned char* tb;          // [B, S_CAP, W] (TB mode) or null
  int* bands;                 // [B, S_CAP, 2] (TB mode) or null
  const long long* segs;      // [B, seg_cap, 2] checkpoints or null
  int seg_cap;
  int* snap;                  // [B, n_snap, NP, W] (PASS1) or null
  int B, W, S_CAP, mode, cpw;
  int x, o1, e1, o2, e2;
  int step, n_snap;
  int C;                      // CTAs per lane (cluster size)
};

// The barrier of this CTA's threads of the lane: the block's in K1, the
// group's named barrier 1+g in K4 (barrier 0 is __syncthreads').
template <int LPB>
__device__ __forceinline__ void cta_sync(int g) {
  if constexpr (LPB == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(THREADS / LPB)
                 : "memory");
  }
}

// The barrier of a lane's threads: the cluster's with C > 1 (release /
// acquire, so global and distributed shared stores before it are seen
// after it), else the CTA's.
template <int LPB, bool CL>
__device__ __forceinline__ void lane_sync(int g) {
  if constexpr (CL) {
    cg::this_cluster().sync();
  } else {
    cta_sync<LPB>(g);
  }
}

template <bool CG>
__device__ __forceinline__ void stv(int* p, int v) {
  if constexpr (CG) {
    __stcg(p, v);
  } else {
    *p = v;
  }
}

// Store v into flag word f of every CTA of the cluster (CL), or of this
// CTA only.
template <bool CL>
__device__ __forceinline__ void push(int* f, int v, int C) {
  if constexpr (CL) {
    cg::cluster_group cl = cg::this_cluster();
    for (int r = 0; r < C; ++r) *cl.map_shared_rank(f, r) = v;
  } else {
    *f = v;
  }
}

// The r-th of C contiguous shares [lo, hi] of slots [a, e] (lo > hi:
// empty).
__device__ __forceinline__ void share(int a, int e, int r, int C, int& lo,
                                      int& hi) {
  const int per = (max(e - a + 1, 0) + C - 1) / C;
  lo = a + r * per;
  hi = min(e, lo + per - 1);
}

// One instantiation per mode, lanes per block and cluster use, so a mode
// compiles none of the others' code (SCORE computes no tb byte and copies
// no pointer) and C = 1 keeps plain loads and the block barrier.
template <int MODE, int LPB, bool CL>
__global__ void __launch_bounds__(THREADS) wavefront_kernel(Params p) {
  constexpr int NT = THREADS / LPB;  // threads of one lane in one CTA
  constexpr bool CG = CL;            // L2 loads and stores across SMs
  const int C = CL ? p.C : 1;
  const int g = LPB == 1 ? 0 : (int)threadIdx.x / NT;
  const int tid = LPB == 1 ? (int)threadIdx.x : (int)threadIdx.x % NT;
  const int rank = CL ? (int)cg::this_cluster().block_rank() : 0;
  const int b = CL ? (int)blockIdx.x / C : (int)blockIdx.x * LPB + g;
  if constexpr (LPB > 1) {
    if (b >= p.B) return;  // past the last lane: no barrier of its group
  }
  const long long* ln = p.lanes + (size_t)b * L_N;
  const int tl = (int)ln[L_TL], ql = (int)ln[L_QL], anc = (int)ln[L_ANC];
  const int W = p.W, d_end = ql - tl;
  const size_t Wz = (size_t)W;
  const int ag_x = p.x, ag_o1 = p.o1 + p.e1, ag_o2 = p.o2 + p.e2;
  const int DH = max(ag_x, max(ag_o1, ag_o2));
  const int NS = DH + 1, RH = DH + 1;
  const int RE1 = max(p.e1, 1) + 1, RE2 = max(p.e2, 1) + 1;
  constexpr bool is_tb = MODE == MODE_TB, is_p1 = MODE == MODE_PASS1;
  const int NP = RH + 2 * RE1 + 2 * RE2;
  const int cpw = p.cpw, bits = 32 / cpw;
  const int logc = cpw == 16 ? 4 : 2, logb = cpw == 16 ? 1 : 3;

  const size_t poff = is_p1 ? NP * Wz : 0;  // pointer plane of a value plane
  int* H = p.planes + (size_t)b * (NP * (is_p1 ? 2 : 1) + 1) * Wz;
  int* E1 = H + RH * Wz;
  int* F1 = E1 + RE1 * Wz;
  int* E2 = F1 + RE1 * Wz;
  int* F2 = E2 + RE2 * Wz;
  int* lastv = H + NP * Wz + poff;
  const long long* segs =
      p.seg_cap ? p.segs + (size_t)b * p.seg_cap * 2 : nullptr;
  const unsigned* tw = p.tw + (size_t)b * p.nw;
  const unsigned* qw = p.qw + (size_t)b * p.nw;
  unsigned char* tb = is_tb ? p.tb + (size_t)b * p.S_CAP * Wz : nullptr;
  int* bands = is_tb ? p.bands + (size_t)b * p.S_CAP * 2 : nullptr;

  // the lane's score-band registry (score s at s % RH) and flags: by
  // parity, f_term holds the score found terminated (with f_ls / f_lp its
  // last_state / last_ptr), f_loq / f_hiq the cycle whose lo / hi cell is
  // viable; f_mn / f_mx each CTA's share of the shrink hull, by rank, and
  // sp_mn / sp_mx this CTA's partial hull
  extern __shared__ int registry[];
  int* bnd_lo = registry + (size_t)g * 2 * RH;
  int* bnd_hi = bnd_lo + RH;
  __shared__ int sf_term[LPB][2], sf_ls[LPB][2], sf_lp[LPB][2],
      sf_loq[LPB][2], sf_hiq[LPB][2], sf_mn[LPB][CMAX], sf_mx[LPB][CMAX],
      sp_mn[LPB], sp_mx[LPB];
  int *f_term = sf_term[g], *f_ls = sf_ls[g], *f_lp = sf_lp[g],
      *f_loq = sf_loq[g], *f_hiq = sf_hiq[g], *f_mn = sf_mn[g],
      *f_mx = sf_mx[g];
  for (int j = tid; j < RH; j += NT) {
    bnd_lo[j] = 1;  // empty band until really recorded
    bnd_hi[j] = 0;
  }
  if (tid < 2) f_term[tid] = f_loq[tid] = f_hiq[tid] = -1;
  if (tid == 0) {
    bnd_lo[0] = bnd_hi[0] = 0;  // score 0: d = 0
    sp_mn[g] = BIG;
    sp_mx[g] = -BIG;
  }
  lane_sync<LPB, CL>(g);  // every CTA's flags are set before any push
  if (rank == 0 && tid == 0 && -anc >= 0 && -anc < W) {
    // score-0 top: H[d=0] = -1, extended (always a good diagonal)
    const int s0 = -anc;
    const int kn = extend(tw, qw, -1, 0, tl, ql, cpw, logc, bits, logb);
    stv<CG>(H + s0, kn);
    stv<CG>(E1 + s0, NEG);
    stv<CG>(F1 + s0, NEG);
    stv<CG>(E2 + s0, NEG);
    stv<CG>(F2 + s0, NEG);
    if (is_p1) {  // the pointer chain's origin
      stv<CG>(H + poff + s0, -1);
      stv<CG>(E1 + poff + s0, NEG);
      stv<CG>(F1 + poff + s0, NEG);
      stv<CG>(E2 + poff + s0, NEG);
      stv<CG>(F2 + poff + s0, NEG);
    }
    if (d_end == 0 && kn == tl - 1) {
      if (is_tb) push<CL>(&f_ls[0], 0, C);
      if (is_p1) push<CL>(&f_lp[0], -1, C);
      push<CL>(&f_term[0], 0, C);
    }
  }
  lane_sync<LPB, CL>(g);

  int t = 0, wf_lo = 0, wf_hi = 0, t_lo = 0, t_hi = 0;
  int final_s = -1, last_state = 0, last_ptr = NEG, snap_cnt = 0, sid = 0;
  bool done = false, stopped = false, ovf = false;
  long long n_iter = 0;
  while (!(done || stopped || ovf) && t < p.S_CAP - 1) {
    const int par = t & 1, npar = par ^ 1;
    // --- 1. termination at score t
    const bool term = f_term[par] == t;
    if (term) {
      done = true;
      final_s = t;
      if (is_tb) last_state = f_ls[par];
      if (is_p1) last_ptr = f_lp[par];
    }

    // --- 2. pass-2 checkpoint collapse, growth + window-overflow check
    if (!term && sid < p.seg_cap && segs[2 * sid] == t) {
      wf_lo = wf_hi = (int)segs[2 * sid + 1];
      ++sid;
    }
    const int lo = max(wf_lo - 1, -tl), hi = min(wf_hi + 1, ql);
    const bool ovf_now = !term && (lo < anc || hi > anc + W - 1);
    ovf = ovf || ovf_now;
    bool act = !term && !ovf_now;

    // --- 3. PASS1 snapshot into row c = (t+1)/step - 1; out of rows is a
    // band overflow, as in the JAX kernel
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
                min(bnd_hi[sj % RH] - anc, W - 1), rank, C, a, e);
          int* P = H + poff + (size_t)pl * Wz;
          int* S = srow + (size_t)pl * Wz;
          for (int s = a + tid; s <= e; s += NT) {
            S[s] = ld<CG>(P + s);
            stv<CG>(P + s, pl * W + s);
          }
        }
        ++snap_cnt;
        lane_sync<LPB, CL>(g);
      }
    }
    if (act) {
      // --- 4. viability of the retired slice (lastv) + transition into
      // t+1 with its extension
      const int* Ht = H + (size_t)(t % RH) * Wz;
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
      const Sources S{mk(H, RH, ag_x),     mk(H, RH, ag_o1),
                      mk(H, RH, ag_o2),    mk(E1, RE1, p.e1),
                      mk(F1, RE1, p.e1),   mk(E2, RE2, p.e2),
                      mk(F2, RE2, p.e2)};
      int a, e;
      share(max(min(t_lo, lo) - anc, 0), min(max(t_hi, hi) - anc, W - 1),
            rank, C, a, e);
      for (int s = a + tid; s <= e; s += NT) {
        const int d = anc + s;
        if (d >= t_lo && d <= t_hi &&
            (good_diag(ld<CG>(Ht + s), d, tl, ql) ||
             good_diag(ld<CG>(E1t + s), d, tl, ql) ||
             good_diag(ld<CG>(F1t + s), d, tl, ql) ||
             good_diag(ld<CG>(E2t + s), d, tl, ql) ||
             good_diag(ld<CG>(F2t + s), d, tl, ql)))
          stv<CG>(lastv + s, t + 1);
        if (d < lo || d > hi) continue;
        const Cell c = transition<CG>(S, s, anc);
        int h = c.h;
        bool term1 = false, zero1 = false;
        if (good_diag(h, d, tl, ql)) {  // the extension of score t+1
          const int kn = extend(tw, qw, h, d, tl, ql, cpw, logc, bits, logb);
          term1 = d == d_end && kn == tl - 1;
          zero1 = kn == h;
          h = kn;
        }
        stv<CG>(Hn + s, h);
        stv<CG>(E1n + s, c.e1);
        stv<CG>(F1n + s, c.f1);
        stv<CG>(E2n + s, c.e2);
        stv<CG>(F2n + s, c.f2);
        if (is_tb) tb[(size_t)t * Wz + s] = (unsigned char)c.tb;
        int ptr_h = 0;
        if (is_p1) {  // copy the chosen source's pointer
          const Cell q = pointers<CG>(S, s, anc, poff, c.tb);
          stv<CG>(Hn + poff + s, q.h);
          stv<CG>(E1n + poff + s, q.e1);
          stv<CG>(F1n + poff + s, q.f1);
          stv<CG>(E2n + poff + s, q.e2);
          stv<CG>(F2n + poff + s, q.f2);
          ptr_h = q.h;
        }
        // this CTA's copy of the flags; with C > 1 its thread 0 forwards
        // them to the cluster below
        if (term1) {  // score t+1 ends here: its last_state / last_ptr
          if (is_tb) f_ls[npar] = zero1 ? (c.tb & 7) : 0;
          if (is_p1) f_lp[npar] = ptr_h;
          f_term[npar] = t + 1;
        }
        if (any_viable(c)) {
          if (d == lo) f_loq[par] = t;
          if (d == hi) f_hiq[par] = t;
        }
      }
      if constexpr (CL) cta_sync<LPB>(g);
      if (tid == 0) {  // no source of this transition is score t+1-RH
        bnd_lo[(t + 1) % RH] = lo;
        bnd_hi[(t + 1) % RH] = hi;
        if (is_tb && rank == 0) {
          bands[2 * t] = lo;
          bands[2 * t + 1] = hi;
        }
        if constexpr (CL) {  // the flags of the cells this CTA owns
          const auto own = [&](int dd) {
            return dd - anc >= a && dd - anc <= e;
          };
          if (own(d_end) && f_term[npar] == t + 1) {
            if (is_tb) push<CL>(&f_ls[npar], f_ls[npar], C);
            if (is_p1) push<CL>(&f_lp[npar], f_lp[npar], C);
            push<CL>(&f_term[npar], t + 1, C);
          }
          if (own(lo) && f_loq[par] == t) push<CL>(&f_loq[par], t, C);
          if (own(hi) && f_hiq[par] == t) push<CL>(&f_hiq[par], t, C);
        }
      }
      lane_sync<LPB, CL>(g);
      if (f_loq[par] == t) wf_lo = lo;  // boundary commit (miniwfa.c:325-326)
      if (f_hiq[par] == t) wf_hi = hi;
      t_lo = lo;
      t_hi = hi;

      // --- 5. shrink every 256 cycles (miniwfa.c:420)
      if (((t + 1) & 0xFF) == 0) {
        const int vfloor = viable_floor(t, NS);
        int sa, se, mn = BIG, mx = -BIG;
        share(max(wf_lo - anc, 0), min(wf_hi - anc, W - 1), rank, C, sa, se);
        for (int s = sa + tid; s <= se; s += NT) {
          const int d = anc + s;
          const bool top = d >= lo && d <= hi &&
                           (ld<CG>(Hn + s) >= -1 || ld<CG>(E1n + s) >= -1 ||
                            ld<CG>(F1n + s) >= -1 || ld<CG>(E2n + s) >= -1 ||
                            ld<CG>(F2n + s) >= -1);
          if (top || ld<CG>(lastv + s) >= vfloor) {
            mn = min(mn, d);
            mx = max(mx, d);
          }
        }
        if (mn <= mx) {
          atomicMin(&sp_mn[g], mn);
          atomicMax(&sp_mx[g], mx);
        }
        cta_sync<LPB>(g);
        if (tid == 0) {  // this CTA's share, into slot `rank` everywhere
          push<CL>(&f_mn[rank], sp_mn[g], C);
          push<CL>(&f_mx[rank], sp_mx[g], C);
          sp_mn[g] = BIG;
          sp_mx[g] = -BIG;
        }
        lane_sync<LPB, CL>(g);
        mn = BIG;
        mx = -BIG;
        for (int r = 0; r < C; ++r) {
          mn = min(mn, f_mn[r]);
          mx = max(mx, f_mx[r]);
        }
        if (mx >= mn) {
          wf_lo = mn;
          wf_hi = mx;
        }
      }

      // --- 6. accounting + early stop (miniwfa.c:421-425)
      n_iter += hi - lo + 1;
      const long long max_s = ln[L_MS], max_iter = ln[L_MI];
      stopped = (max_iter > 0 && n_iter > max_iter) ||
                (max_s > 0 && t + 1 > max_s);
    }
    ++t;
  }
  if (rank == 0 && tid == 0) {
    long long* o = p.out + (size_t)b * O_N;
    o[O_S] = final_s;
    o[O_DONE] = done;
    o[O_STOP] = stopped;
    o[O_OVFB] = ovf;
    o[O_OVFS] = !(done || stopped || ovf);
    o[O_LS] = last_state;
    o[O_NITER] = n_iter;
    o[O_LP] = last_ptr;
    o[O_SNC] = snap_cnt;
  }
  // no CTA leaves while another of its cluster may still reach its shared
  // memory
  if constexpr (CL) cg::this_cluster().sync();
}

// K1's kernel in `mode`, with (CL) or without cluster barriers.
template <bool CL>
const void* k1_fn(int mode) {
  if (mode == MODE_TB) return (const void*)wavefront_kernel<MODE_TB, 1, CL>;
  if (mode == MODE_PASS1)
    return (const void*)wavefront_kernel<MODE_PASS1, 1, CL>;
  return (const void*)wavefront_kernel<MODE_SCORE, 1, CL>;
}

int reg_rh(const Params& p) {
  return max(p.x, max(p.o1 + p.e1, p.o2 + p.e2)) + 1;
}

// The cluster kernel of `mode` set up for clusters of C CTAs (16 is a
// non-portable size) with a registry of RH scores (*smem bytes).
cudaError_t cluster_setup(int mode, int C, int RH, const void** fn,
                          int* smem) {
  *fn = k1_fn<true>(mode);
  cudaError_t err = registry_smem(*fn, 1, RH, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        *fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int blocks, int C, int smem, cudaStream_t st) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Launch in p.mode with LPB lanes per block (PASS1 only in K1) and, in K1,
// p.C CTAs per lane; a refused launch returns its error.
template <int LPB>
int launch(const Params& p, cudaStream_t st) {
  const int RH = reg_rh(p);
  Params q = p;
  void* args[] = {&q};
  int smem;
  cudaError_t err;
  if (LPB == 1 && p.C > 1) {
    const void* fn;
    err = cluster_setup(p.mode, p.C, RH, &fn, &smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(&cfg, &attr, p.B * p.C, p.C, smem, st);
    err = cudaLaunchKernelExC(&cfg, fn, args);
  } else {
    const void* fn = (const void*)wavefront_kernel<MODE_SCORE, LPB, false>;
    if (p.mode == MODE_TB)
      fn = (const void*)wavefront_kernel<MODE_TB, LPB, false>;
    if constexpr (LPB == 1) fn = k1_fn<false>(p.mode);
    err = registry_smem(fn, LPB, RH, &smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernel(fn, dim3((p.B + LPB - 1) / LPB), dim3(THREADS),
                           args, smem, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mwf_wavefront(const long long* lanes, const unsigned* tw,
                             const unsigned* qw, long long nw, int* planes,
                             long long* out, unsigned char* tb, int* bands,
                             const long long* segs, int seg_cap, int* snap,
                             int B, int W, int S_CAP, int mode, int cpw,
                             int x, int o1, int e1, int o2, int e2, int step,
                             int n_snap, int C, void* stream) {
  if (C < 1 || C > CMAX || (C & (C - 1)))
    return (int)cudaErrorInvalidValue;
  Params p{lanes, tw, qw, nw, planes, out, tb, bands, segs, seg_cap, snap,
           B, W, S_CAP, mode, cpw, x, o1, e1, o2, e2, step, n_snap, C};
  return launch<1>(p, (cudaStream_t)stream);
}

// How many clusters of C > 1 CTAs of K1 in `mode` (with x..e2's band
// registry in dynamic shared memory) the card holds at once, into *count.
extern "C" int mwf_wavefront_clusters(int mode, int C, int x, int o1, int e1,
                                      int o2, int e2, int* count) {
  if (C < 2 || C > CMAX || (C & (C - 1)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.o1 = o1;
  p.e1 = e1;
  p.o2 = o2;
  p.e2 = e2;
  const void* fn;
  int smem;
  cudaError_t err = cluster_setup(mode, C, reg_rh(p), &fn, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, C, C, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(count, fn, &cfg);
}

// K4: G in {2, 4, 8} lanes per block, SCORE and TB (with or without
// checkpoints); PASS1 stays on K1, as in the JAX package.
extern "C" int mwf_wavefront_multi(const long long* lanes, const unsigned* tw,
                                   const unsigned* qw, long long nw,
                                   int* planes, long long* out,
                                   unsigned char* tb, int* bands,
                                   const long long* segs, int seg_cap,
                                   int B, int W, int S_CAP, int mode, int cpw,
                                   int x, int o1, int e1, int o2, int e2,
                                   int G, void* stream) {
  if (mode != MODE_SCORE && mode != MODE_TB) return (int)cudaErrorInvalidValue;
  Params p{lanes, tw, qw, nw, planes, out, tb, bands, segs, seg_cap, nullptr,
           B, W, S_CAP, mode, cpw, x, o1, e1, o2, e2, 0, 0, 1};
  cudaStream_t st = (cudaStream_t)stream;
  switch (G) {
    case 2: return launch<2>(p, st);
    case 4: return launch<4>(p, st);
    case 8: return launch<8>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
