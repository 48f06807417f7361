// The wide-band WFA wavefront kernel for Hopper (sm_90a): one alignment over
// the whole card, SCORE and PASS1 modes, resumable across calls.
//
// Replaces miniwfa_tpu/ops/wavefront_wide.py::build_kernel_wide (the Pallas
// TPU kernel for bands past the VMEM kernel's windows: SCORE past 65536
// diagonals, low-mem PASS1 past 32768, up to 2^20).  Its semantics are K1's
// (csrc/wavefront.cu, whose notes describe the cycle, the ring planes, the
// band registry and the PASS1 snapshots); the two share their per-diagonal
// code through wavefront_common.cuh, and the plain PyTorch twin is
// miniwfa_tpu_torch/ops/wavefront_wide.py::wide_plain, which runs K1's
// plain cycle code.
//
// Design.  On the TPU the wide kernel streams a band too large for one
// core's VMEM through it in chunks; on the card the same job is one
// alignment spread over every SM.  A cooperative launch puts as many
// blocks on the card as can be co-resident (occupancy x SMs), and every
// block takes a contiguous share of the live band in each phase of a
// cycle; cooperative_groups' grid.sync() stands where K1 has a block
// barrier: after the extension, after the PASS1 snapshot, after the
// transition and after the 256-cycle shrink.  Lanes of a batch run one
// after another, each over the whole grid.
//
// Cross-SM coherence.  The band's partition moves every cycle, so a block
// reads ring slots, the lastv plane and pointer planes that another block
// wrote
// earlier in the same launch: every such read is ld.global.cg (L2, never a
// stale L1 line), and every plane store is st.global.cg.
//
// Uniform scalars.  Every thread of every block keeps an identical copy of
// the lane's scalars and updates them from the same global flag words:
// termination, the boundary-commit flags and the shrink hull's min/max, all
// double-buffered by cycle parity (atomics before a grid.sync, cg reads
// after it; block 0 clears the other parity's set after the cycle's first
// grid.sync, when every read of it from the previous cycle is done).  Each
// block keeps its own copy of the band registry in dynamic shared memory
// (2 x RH ints), written by its thread 0 with the same values.
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
// What bounds it: the grid barriers (2 a cycle, 3-4 on snapshot and shrink
// cycles) and the L2/HBM traffic of the live band's ring planes, which at
// 500k diagonals (27 value planes, twice that in PASS1) pass the 50 MB L2.
// No wgmma and no TMA: the recurrence is integer max/compare, and this is
// the correctness-first design.

#include <cooperative_groups.h>

#include "wavefront_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mwf;

constexpr int THREADS = 512;

// state row (int64, per lane): scalars, then the band registry bnd_lo[RH],
// bnd_hi[RH] (ops/wavefront_wide.py ST_*)
enum {
  ST_T, ST_WLO, ST_WHI, ST_TLO, ST_THI, ST_NITER, ST_LP, ST_SNC, ST_S,
  ST_DONE, ST_STOP, ST_OVFB, ST_BND
};
enum { OW_PAUSE = O_N, OW_N };
// per-cycle flag words, one set per cycle parity
enum { F_TERM, F_LOQ, F_HIQ, F_MN, F_MX, F_N };

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
  int* flags;                 // [2, F_N] scratch
  int B, W, S_CAP, mode, cpw;
  int x, o1, e1, o2, e2;
  int step, n_snap;
};

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
__global__ void __launch_bounds__(THREADS) wide_kernel(Params p) {
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

// The instantiation of a mode: SCORE compiles no pointer code.
const void* kernel_of(int mode) {
  return mode == MODE_PASS1 ? (const void*)wide_kernel<true>
                            : (const void*)wide_kernel<false>;
}

}  // namespace

// Blocks of one cooperative launch in `mode` with a registry of RH scores:
// as many as can be co-resident.
extern "C" int mwf_wide_grid(int mode, int RH, int* blocks) {
  int dev, per_sm = 0, smem;
  cudaError_t err = registry_smem(kernel_of(mode), 1, RH, &smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceProp prop;
  err = cudaGetDeviceProperties(&prop, dev);
  if (err != cudaSuccess) return (int)err;
  if (!prop.cooperativeLaunch) return (int)cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(mode),
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * prop.multiProcessorCount;
  return *blocks > 0 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

extern "C" int mwf_wide(const long long* lanes, const unsigned* tw,
                        const unsigned* qw, long long nw, long long* state,
                        int st_n, const long long* t_lim, int* planes,
                        int* snap, long long* out, int* flags, int B, int W,
                        int S_CAP, int mode, int cpw, int x, int o1, int e1,
                        int o2, int e2, int step, int n_snap, int blocks,
                        void* stream) {
  Params p{lanes, tw, qw, nw, state, st_n, t_lim, planes, snap, out, flags,
           B, W, S_CAP, mode, cpw, x, o1, e1, o2, e2, step, n_snap};
  void* args[] = {&p};
  int smem;
  cudaError_t err = registry_smem(
      kernel_of(mode), 1, max(x, max(o1 + e1, o2 + e2)) + 1, &smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel(kernel_of(mode), dim3(blocks),
                                    dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
