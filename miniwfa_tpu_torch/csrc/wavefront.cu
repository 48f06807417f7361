// K1: the fused-cycle WFA wavefront kernel for Hopper (sm_90a), SCORE, TB
// and PASS1 modes, with the pass-2 checkpoint collapse; and K4, the same
// kernel with several lanes per block (SCORE, TB and TB+seg).
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
// 1` loop.  K1 (LPB = 1) is one 512-thread block per lane; K4 (LPB = G in
// {2, 4, 8}) splits a block into G groups of 512/G threads, group g owning
// lane blockIdx.x * G + g, with its own band registry and flags in shared
// memory and its own named barrier (bar.sync 1+g, 512/G), so the lanes of
// a block advance independently (the TPU kernel's shared cycle loop was a
// Pallas constraint, not semantics); groups past the last lane exit at
// once.  Every thread of a group keeps an identical copy of the lane's
// scalars (score t, committed band wf_lo/wf_hi, top band t_lo/t_hi, flags,
// n_iter) and updates them from the same shared-memory flags, so no
// broadcast is needed.  Per cycle, the group's threads stride over the
// live band's diagonals in these phases, with a group barrier between
// them (__syncthreads() in K1):
//   1. LCP extension of the top band (miniwfa.c:400-411), reading the flat
//      packed word streams straight from global memory: a funnel shift for
//      unaligned probes and __ffs of the XOR for the first mismatch, capped
//      at the matrix edge min(tl-1-k, ql-1-(d+k)).
//   2. termination at d_end; last_state is set only on a zero-extension
//      termination (TB mode), from the tb byte of the previous row.
//   3. band growth and window-overflow check.
//   4. shrink viability of the retired score-t slice + the 5-state
//      transition into score t+1 over [min(t_lo,lo), max(t_hi,hi)], with
//      the exact '>=' / '<' tie-breaks of wf_next_tb (miniwfa.c:287-307);
//      TB mode stores the 7-bit byte at tb[t][d - anc].
//   5. every 256 cycles, the shrink hull (block-wide atomicMin/atomicMax).
//   6. accounting (n_iter adds the grown width on transition cycles only)
//      and the max_s / max_iter stops.
//
// Low-mem stripe mode (reference mwf_wfa_seg, miniwfa.c:551-601).  PASS1
// keeps a pointer plane beside every value plane, laid out as the value
// rings one block further on (`poff`), so a source's pointer sits at the
// same slot offset as its value.  The transition copies the pointer of the
// source its tb bits chose.  A snapshot (when (t+1) % step == 0, after
// growth and before the transition) is one block-wide pass over every
// ring slot's recorded band: copy the pointer into snapshot row c, then
// reset it to its own flat index plane*W + w; each element is read and
// rewritten by the same thread, and one barrier fences the pass from the
// transition's neighbour reads.  Outside a slot's band nothing is written:
// band-masked reads never look there.  Termination takes last_ptr from the
// H pointer plane at d_end after the extension barrier.  Pass 2's
// checkpoint collapse (miniwfa.c:413-416) is a uniform scalar update that
// every thread applies, after termination and before growth.
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
// (the stale slice t-NS+1 is excluded) and ">= -1" for the new tops.  One
// int32 plane `lastv` holds, per slot, one past the last score whose
// retired slice was viable there (0: never), set during the transition
// pass over the update span; every slot the shrink reads lies in
// [wf_lo, wf_hi], inside this cycle's span, so the plane is exact for any
// NS and no penalty set is bounded by it.  Under edit-distance penalties every age is 1.
// At cpw=4 the words hold raw bytes, so the compare is case-sensitive like
// the reference's (the `lower_n` golden).  Empty sequences need no special
// case: the extension cap min(tl-1-k, ql-1-(d+k)) is 0 at k = -1, and an
// anchor that leaves d=0 outside the window overflows at the first cycle.
//
// What bounds it: a cycle is a handful of group barriers plus O(band/512)
// work per thread, so at 100 kb the per-cycle barrier latency and the L2
// traffic of the ring planes dominate, with only B of the 132 SMs busy.
// K4 serves batches of more lanes than SMs with narrow bands (the chain's
// gap fills): G lanes share an SM's block slots, each with 512/G threads.
// This is the correctness-first design; making it fast (a cluster or
// several CTAs per lane, shared-memory rings for narrow bands) is later
// work.

#include "wavefront_common.cuh"

namespace {

using namespace mwf;

constexpr int THREADS = 512;

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
};

// The barrier of a lane's threads: the block's in K1, the group's named
// barrier 1+g in K4 (barrier 0 is __syncthreads').
template <int LPB>
__device__ __forceinline__ void lane_sync(int g) {
  if constexpr (LPB == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(THREADS / LPB)
                 : "memory");
  }
}

// One instantiation per mode and lanes per block, so a mode compiles none
// of the others' code (SCORE computes no tb byte and copies no pointer).
template <int MODE, int LPB>
__global__ void __launch_bounds__(THREADS) wavefront_kernel(Params p) {
  constexpr int NT = THREADS / LPB;  // threads of one lane
  const int g = LPB == 1 ? 0 : (int)threadIdx.x / NT;
  const int tid = LPB == 1 ? (int)threadIdx.x : (int)threadIdx.x % NT;
  const int b = blockIdx.x * LPB + g;
  if constexpr (LPB > 1) {
    if (b >= p.B) return;  // past the last lane: no barrier of its group
  }
  const long long* ln = p.lanes + (size_t)b * L_N;
  const int tl = (int)ln[L_TL], ql = (int)ln[L_QL], anc = (int)ln[L_ANC];
  const long long max_s = ln[L_MS], max_iter = ln[L_MI];
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

  // the lane's score-band registry (score s at s % RH) and per-cycle
  // flags.  Flags are double-buffered by cycle parity: cycle t uses set
  // t&1, and thread 0 clears set (t+1)&1 right after cycle t's first
  // barrier, when every thread has finished reading it in cycle t-1.
  extern __shared__ int registry[];
  int* bnd_lo = registry + (size_t)g * 2 * RH;
  int* bnd_hi = bnd_lo + RH;
  __shared__ int sf_term[LPB][2], sf_zero[LPB][2], sf_loq[LPB][2],
      sf_hiq[LPB][2], sf_mn[LPB][2], sf_mx[LPB][2];
  int *f_term = sf_term[g], *f_zero = sf_zero[g], *f_loq = sf_loq[g],
      *f_hiq = sf_hiq[g], *f_mn = sf_mn[g], *f_mx = sf_mx[g];
  for (int j = tid; j < RH; j += NT) {
    bnd_lo[j] = 1;  // empty band until really recorded
    bnd_hi[j] = 0;
  }
  if (tid < 2) {
    f_term[tid] = f_zero[tid] = f_loq[tid] = f_hiq[tid] = 0;
    f_mn[tid] = BIG;
    f_mx[tid] = -BIG;
  }
  if (tid == 0 && -anc >= 0 && -anc < W) {  // score-0 top: H[d=0] = -1
    H[-anc] = -1;
    E1[-anc] = F1[-anc] = E2[-anc] = F2[-anc] = NEG;
    if (is_p1) {  // the pointer chain's origin
      const size_t o = poff + (size_t)(-anc);
      H[o] = -1;
      E1[o] = F1[o] = E2[o] = F2[o] = NEG;
    }
  }
  lane_sync<LPB>(g);

  int t = 0, wf_lo = 0, wf_hi = 0, t_lo = 0, t_hi = 0;
  int final_s = -1, last_state = 0, last_ptr = NEG, snap_cnt = 0, sid = 0;
  bool done = false, stopped = false, ovf = false;
  long long n_iter = 0;
  while (!(done || stopped || ovf) && t < p.S_CAP - 1) {
    const int par = t & 1;
    if (tid == 0) {
      bnd_lo[t % RH] = t_lo;
      bnd_hi[t % RH] = t_hi;
    }
    // --- 1. extension of the top band
    int* Ht = H + (size_t)(t % RH) * Wz;
    {
      const int a = max(t_lo - anc, 0), e = min(t_hi - anc, W - 1);
      for (int s = a + tid; s <= e; s += NT) {
        const int d = anc + s, k = Ht[s];
        if (!(k >= -1 && d + k >= -1 && k < tl && d + k < ql)) continue;
        const int kn = extend(tw, qw, k, d, tl, ql, cpw, logc, bits, logb);
        Ht[s] = kn;
        if (d == d_end && kn == tl - 1) {
          f_term[par] = 1;
          if (kn == k) f_zero[par] = 1;
        }
      }
    }
    lane_sync<LPB>(g);
    if (tid == 0) {
      const int q = par ^ 1;
      f_term[q] = f_zero[q] = f_loq[q] = f_hiq[q] = 0;
      f_mn[q] = BIG;
      f_mx[q] = -BIG;
    }

    // --- 2. termination
    const bool term = f_term[par] != 0;
    if (is_tb && term && t > 0 && f_zero[par])
      last_state = tb[(size_t)(t - 1) * Wz + (d_end - anc)] & 7;
    if (term) {
      done = true;
      final_s = t;
      if (is_p1) last_ptr = Ht[poff + (d_end - anc)];
    }

    // --- 2b. pass-2 checkpoint collapse
    if (!term && sid < p.seg_cap && segs[2 * sid] == t) {
      wf_lo = wf_hi = (int)segs[2 * sid + 1];
      ++sid;
    }

    // --- 3. growth + window-overflow check
    const int lo = max(wf_lo - 1, -tl), hi = min(wf_hi + 1, ql);
    const bool ovf_now = !term && (lo < anc || hi > anc + W - 1);
    ovf = ovf || ovf_now;
    bool act = !term && !ovf_now;

    // --- 3b. PASS1 snapshot into row c = (t+1)/step - 1; out of rows is a
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
          const int a = max(bnd_lo[sj % RH] - anc, 0);
          const int e = min(bnd_hi[sj % RH] - anc, W - 1);
          int* P = H + poff + (size_t)pl * Wz;
          int* S = srow + (size_t)pl * Wz;
          for (int s = a + tid; s <= e; s += NT) {
            S[s] = P[s];
            P[s] = pl * W + s;
          }
        }
        ++snap_cnt;
        lane_sync<LPB>(g);
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
      const Sources S{mk(H, RH, ag_x),     mk(H, RH, ag_o1),
                      mk(H, RH, ag_o2),    mk(E1, RE1, p.e1),
                      mk(F1, RE1, p.e1),   mk(E2, RE2, p.e2),
                      mk(F2, RE2, p.e2)};
      const int a = max(min(t_lo, lo) - anc, 0);
      const int e = min(max(t_hi, hi) - anc, W - 1);
      for (int s = a + tid; s <= e; s += NT) {
        const int d = anc + s;
        if (d >= t_lo && d <= t_hi &&
            (good_diag(Ht[s], d, tl, ql) || good_diag(E1t[s], d, tl, ql) ||
             good_diag(F1t[s], d, tl, ql) || good_diag(E2t[s], d, tl, ql) ||
             good_diag(F2t[s], d, tl, ql)))
          lastv[s] = t + 1;
        if (d < lo || d > hi) continue;
        const Cell c = transition<false>(S, s, anc);
        Hn[s] = c.h;
        E1n[s] = c.e1;
        F1n[s] = c.f1;
        E2n[s] = c.e2;
        F2n[s] = c.f2;
        if (is_tb) tb[(size_t)t * Wz + s] = (unsigned char)c.tb;
        if (is_p1) {  // copy the chosen source's pointer
          const Cell q = pointers<false>(S, s, anc, poff, c.tb);
          Hn[poff + s] = q.h;
          E1n[poff + s] = q.e1;
          F1n[poff + s] = q.f1;
          E2n[poff + s] = q.e2;
          F2n[poff + s] = q.f2;
        }
        if (any_viable(c)) {
          if (d == lo) f_loq[par] = 1;
          if (d == hi) f_hiq[par] = 1;
        }
      }
      if (is_tb && tid == 0) {
        bands[2 * t] = lo;
        bands[2 * t + 1] = hi;
      }
      lane_sync<LPB>(g);
      if (f_loq[par]) wf_lo = lo;  // boundary commit (miniwfa.c:325-326)
      if (f_hiq[par]) wf_hi = hi;
      t_lo = lo;
      t_hi = hi;

      // --- 5. shrink every 256 cycles (miniwfa.c:420)
      if (((t + 1) & 0xFF) == 0) {
        const int vfloor = viable_floor(t, NS);
        const int sa = max(wf_lo - anc, 0), se = min(wf_hi - anc, W - 1);
        for (int s = sa + tid; s <= se; s += NT) {
          const int d = anc + s;
          const bool top = d >= lo && d <= hi &&
                           (Hn[s] >= -1 || E1n[s] >= -1 || F1n[s] >= -1 ||
                            E2n[s] >= -1 || F2n[s] >= -1);
          if (top || lastv[s] >= vfloor) {
            atomicMin(&f_mn[par], d);
            atomicMax(&f_mx[par], d);
          }
        }
        lane_sync<LPB>(g);
        if (f_mx[par] >= f_mn[par]) {
          wf_lo = f_mn[par];
          wf_hi = f_mx[par];
        }
      }

      // --- 6. accounting + early stop (miniwfa.c:421-425)
      n_iter += hi - lo + 1;
      stopped = (max_iter > 0 && n_iter > max_iter) ||
                (max_s > 0 && t + 1 > max_s);
    }
    ++t;
  }
  if (tid == 0) {
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
}

// Launch in p.mode with LPB lanes per block (PASS1 only in K1).
template <int LPB>
int launch(const Params& p, cudaStream_t st) {
  const void* fn = (const void*)wavefront_kernel<MODE_SCORE, LPB>;
  if (p.mode == MODE_TB) fn = (const void*)wavefront_kernel<MODE_TB, LPB>;
  if constexpr (LPB == 1) {
    if (p.mode == MODE_PASS1)
      fn = (const void*)wavefront_kernel<MODE_PASS1, 1>;
  }
  const int RH = max(p.x, max(p.o1 + p.e1, p.o2 + p.e2)) + 1;
  int smem;
  cudaError_t err = registry_smem(fn, LPB, RH, &smem);
  if (err != cudaSuccess) return (int)err;
  Params q = p;
  void* args[] = {&q};
  err = cudaLaunchKernel(fn, dim3((p.B + LPB - 1) / LPB), dim3(THREADS), args,
                         smem, st);
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
                             int n_snap, void* stream) {
  Params p{lanes, tw, qw, nw, planes, out, tb, bands, segs, seg_cap, snap,
           B, W, S_CAP, mode, cpw, x, o1, e1, o2, e2, step, n_snap};
  return launch<1>(p, (cudaStream_t)stream);
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
           B, W, S_CAP, mode, cpw, x, o1, e1, o2, e2, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  switch (G) {
    case 2: return launch<2>(p, st);
    case 4: return launch<4>(p, st);
    case 8: return launch<8>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
