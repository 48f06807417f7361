// K4's "smem" variant for Hopper (sm_90a): the multi-lane wavefront engine
// with each lane's whole state in shared memory and one warp per lane,
// SCORE and TB modes (with or without the pass-2 checkpoints).
//
// Replaces miniwfa_tpu/ops/wavefront_multi.py::build_kernel (K4, G lanes
// per TPU grid step) for lanes whose rings fit shared memory; wider
// windows keep K4's "global" variant (wavefront_kernel<MODE, G, false> in
// wavefront.cu, rings in global memory).  Same semantics as K1, which
// mirror lh3/miniwfa mwf_wfa_core (miniwfa.c:380-435); the plain PyTorch
// twin is miniwfa_tpu_torch/ops/wavefront_kernel.py::wavefront_plain, and
// wavefront.cu's notes describe the cycle both variants run.
//
// Design: the lanes K4 serves are many and short (the chain's gap fills
// come in chunks of 2048; a 1 kb lane at 2% divergence runs ≈100 cycles
// over a band of ≤ 200 slots), so one warp sweeps a lane's band and every
// row reduction of the cycle is a warp vote:
//   - the lane's value rings (H | E1 | F1 | E2 | F2, in K1's layout, score
//     s at ring slot s % depth), the lastv plane and the band registry
//     (score s's [lo, hi] at s % RH) sit in the warp's slice of dynamic
//     shared memory, lane_ints(W, RH, NP) ints: no `planes` buffer in
//     global memory, and no ring traffic through L2;
//   - termination (the thread of the cell at d_end, with its tb state) by
//     __ballot_sync and __shfl_sync, the boundary commit by __any_sync,
//     the 256-cycle shrink hull by __reduce_min_sync / __reduce_max_sync,
//     and __syncwarp where K4's global variant has a named barrier;
//   - a block holds lpb warps (lanes per block, from the wrapper's
//     chooser: as many lanes as the shared-memory budget allows, at most
//     LPB_MAX), and every warp takes lanes from one atomic counter
//     until none is left, so a block whose lanes end early takes others
//     instead of idling until its slowest lane ends.
// The recurrence, its '>=' / '<' tie-breaks, the band growth, commit and
// shrink, the n_iter accounting, the checkpoint collapse and the 7-bit tb
// byte at tb[t][d - anc] are K1's (wavefront_common.cuh's transition and
// extension).  The packed words are read from global memory through the
// read-only path (a lane's words are a few hundred bytes; L1 holds them:
// staged in shared memory they gained nothing on the card).  Every ring
// slot and registry index is a counter that wraps, not a modulo: a
// cycle's fixed work is a few dozen integer operations.  lastv is kept
// only in the NS-1 cycles before each shrink,
// the only ones whose values the shrink's test lastv >= t-NS+3 can see
// (an older value is smaller, so a skipped write changes no test).
//
// What bounds it: a cycle is one warp's pass over the band, ≈15 shared
// loads and 6 stores a slot and the extension's probes, one chain of
// dependent latencies; the slowest lane's cycles on one warp set the
// kernel's time (2048 x 1 kb: 226 cycles, bands of up to 450 slots).
// Shared memory holds 4 lanes of W=512 an SM at the default penalties
// (57,488 bytes a lane).  Tried on the card and left out, as they gained
// nothing measurable there: 16-bit rings (8 lanes an SM), two slots a
// pass with their extensions interleaved, the words staged in shared
// memory.

#include "wavefront_common.cuh"

namespace {

using namespace mwf;

constexpr int LPB_MAX = 8;  // lanes (warps) per block at most
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Params {
  const long long* lanes;     // [B, L_N]
  const unsigned* tw;         // [B, nw] flat packed words
  const unsigned* qw;
  long long nw;
  long long* out;             // [B, O_N]
  unsigned char* tb;          // [B, S_CAP, W] (TB mode) or null
  int* bands;                 // [B, S_CAP, 2] (TB mode) or null
  const long long* segs;      // [B, seg_cap, 2] checkpoints or null
  int seg_cap;
  int* next;                  // the lane counter, 0 at launch
  int B, W, S_CAP, cpw;
  int x, o1, e1, o2, e2;
  int stride;                 // ints of one lane's slice
};

// Ints of one lane's slice: NP ring planes and lastv of W slots, and the
// registry's 2 x RH, rounded up to 16 bytes.
__host__ __device__ inline long long lane_ints(int W, int RH, int NP) {
  return ((long long)(NP + 1) * W + 2 * RH + 3) / 4 * 4;
}

// v in [-n, 2n) brought into [0, n).
__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : v >= n ? v - n : v;
}

struct Depths {
  int RH, RE1, RE2, NP;
};

__host__ __device__ inline Depths depths(int x, int o1, int e1, int o2,
                                         int e2) {
  Depths d;
  d.RH = max(x, max(o1 + e1, o2 + e2)) + 1;
  d.RE1 = max(e1, 1) + 1;
  d.RE2 = max(e2, 1) + 1;
  d.NP = d.RH + 2 * d.RE1 + 2 * d.RE2;
  return d;
}

template <int MODE>
__global__ void __launch_bounds__(32 * LPB_MAX) multi_smem_kernel(Params p) {
  constexpr bool is_tb = MODE == MODE_TB;
  extern __shared__ int sm[];
  const int lane = (int)threadIdx.x & 31;
  const int W = p.W;
  const size_t Wz = (size_t)W;
  const int ag_x = p.x, ag_o1 = p.o1 + p.e1, ag_o2 = p.o2 + p.e2;
  const Depths dp = depths(p.x, p.o1, p.e1, p.o2, p.e2);
  const int RH = dp.RH, RE1 = dp.RE1, RE2 = dp.RE2, NP = dp.NP;
  const int NS = RH;
  const int cpw = p.cpw, bits = 32 / cpw;
  const int logc = cpw == 16 ? 4 : 2, logb = cpw == 16 ? 1 : 3;

  int* H = sm + (size_t)(threadIdx.x >> 5) * p.stride;
  int* E1 = H + RH * Wz;
  int* F1 = E1 + RE1 * Wz;
  int* E2 = F1 + RE1 * Wz;
  int* F2 = E2 + RE2 * Wz;
  int* lastv = H + NP * Wz;
  int* bnd_lo = lastv + Wz;
  int* bnd_hi = bnd_lo + RH;

  for (;;) {
    int b = 0;
    if (lane == 0) b = atomicAdd(p.next, 1);
    b = __shfl_sync(FULL, b, 0);
    if (b >= p.B) return;
    const long long* ln = p.lanes + (size_t)b * L_N;
    const int tl = (int)ln[L_TL], ql = (int)ln[L_QL], anc = (int)ln[L_ANC];
    const int d_end = ql - tl;
    const long long max_s = ln[L_MS], max_iter = ln[L_MI];
    const long long* segs =
        p.seg_cap ? p.segs + (size_t)b * p.seg_cap * 2 : nullptr;
    const unsigned* tw = p.tw + (size_t)b * p.nw;
    const unsigned* qw = p.qw + (size_t)b * p.nw;
    unsigned char* tb = is_tb ? p.tb + (size_t)b * p.S_CAP * Wz : nullptr;
    int* bands = is_tb ? p.bands + (size_t)b * p.S_CAP * 2 : nullptr;

    // a fresh lane: lastv 0 (never viable), every registry band empty but
    // score 0's, d = 0; ring slots are read only inside a recorded band
    __syncwarp();  // the last lane's reads of the slice are done
    for (int s = lane; s < W; s += 32) lastv[s] = 0;
    for (int j = lane; j < RH; j += 32) {
      bnd_lo[j] = j ? 1 : 0;
      bnd_hi[j] = 0;
    }
    bool term0 = false;
    if (lane == 0 && -anc >= 0 && -anc < W) {
      // score-0 top: H[d=0] = -1, extended (always a good diagonal)
      const int s0 = -anc;
      const int kn =
          extend<true>(tw, qw, -1, 0, tl, ql, cpw, logc, bits, logb);
      H[s0] = kn;
      E1[s0] = F1[s0] = E2[s0] = F2[s0] = NEG;
      term0 = d_end == 0 && kn == tl - 1;
    }
    // score t's termination, found by the transition that wrote score t
    // (or the prologue, for score 0), and its last_state
    bool term_at = __shfl_sync(FULL, (int)term0, 0) != 0;
    int ls_at = 0;
    __syncwarp();

    int t = 0, wf_lo = 0, wf_hi = 0, t_lo = 0, t_hi = 0;
    int final_s = -1, last_state = 0, sid = 0;
    int rt = 0, r1 = 0, r2 = 0;  // t % RH, t % RE1, t % RE2
    bool done = false, stopped = false, ovf = false;
    long long n_iter = 0;
    while (!(done || stopped || ovf) && t < p.S_CAP - 1) {
      const int rn = rt + 1 == RH ? 0 : rt + 1;  // (t+1) % RH
      const int n1 = r1 + 1 == RE1 ? 0 : r1 + 1;
      const int n2 = r2 + 1 == RE2 ? 0 : r2 + 1;
      // --- 1. termination at score t
      const bool term = term_at;
      if (term) {
        done = true;
        final_s = t;
        if (is_tb) last_state = ls_at;
      }

      // --- 2. pass-2 checkpoint collapse, growth + window-overflow check
      if (!term && sid < p.seg_cap && segs[2 * sid] == t) {
        wf_lo = wf_hi = (int)segs[2 * sid + 1];
        ++sid;
      }
      const int lo = max(wf_lo - 1, -tl), hi = min(wf_hi + 1, ql);
      const bool ovf_now = !term && (lo < anc || hi > anc + W - 1);
      ovf = ovf || ovf_now;
      if (!term && !ovf_now) {
        // --- 3. viability of the retired slice (lastv) + transition into
        // t+1 with its extension
        const int* Ht = H + (size_t)rt * Wz;
        const int* E1t = E1 + r1 * Wz;
        const int* F1t = F1 + r1 * Wz;
        const int* E2t = E2 + r2 * Wz;
        const int* F2t = F2 + r2 * Wz;
        int* Hn = H + (size_t)rn * Wz;
        int* E1n = E1 + n1 * Wz;
        int* F1n = F1 + n1 * Wz;
        int* E2n = E2 + n2 * Wz;
        int* F2n = F2 + n2 * Wz;
        // score t+1-age's slot of a ring of `depth` whose score t+1 sits
        // at slot `next`, with its recorded band
        auto mk = [&](const int* ring, int next, int depth, int age) {
          Src r;
          if (t + 1 - age < 0) {
            r.p = ring;
            r.lo = 1;
            r.hi = 0;
          } else {
            const int reg = wrap(rn - age, RH);
            r.p = ring + (size_t)wrap(next - age, depth) * Wz;
            r.lo = bnd_lo[reg];
            r.hi = bnd_hi[reg];
          }
          return r;
        };
        const Sources S{mk(H, rn, RH, ag_x),       mk(H, rn, RH, ag_o1),
                        mk(H, rn, RH, ag_o2),      mk(E1, n1, RE1, p.e1),
                        mk(F1, n1, RE1, p.e1),     mk(E2, n2, RE2, p.e2),
                        mk(F2, n2, RE2, p.e2)};
        const int a = max(min(t_lo, lo) - anc, 0);
        const int e = min(max(t_hi, hi) - anc, W - 1);
        bool my_term = false, lo_ok = false, hi_ok = false;
        int my_ls = 0;
        // lastv is read only by a shrink, for the NS-1 cycles before it:
        // then the retired slice's viable slots of the top band
        if (255 - (t & 0xFF) <= NS - 2) {
          const int ve = min(t_hi - anc, W - 1);
          for (int s = max(t_lo - anc, 0) + lane; s <= ve; s += 32) {
            const int d = anc + s;
            if (good_diag(Ht[s], d, tl, ql) || good_diag(E1t[s], d, tl, ql) ||
                good_diag(F1t[s], d, tl, ql) || good_diag(E2t[s], d, tl, ql) ||
                good_diag(F2t[s], d, tl, ql))
              lastv[s] = t + 1;
          }
        }
        for (int s = a + lane; s <= e; s += 32) {
          const int d = anc + s;
          if (d < lo || d > hi) continue;
          const Cell c = transition<false>(S, s, anc);
          int h = c.h;
          if (good_diag(h, d, tl, ql)) {  // the extension of score t+1
            const int kn =
                extend<true>(tw, qw, h, d, tl, ql, cpw, logc, bits, logb);
            if (d == d_end && kn == tl - 1) {  // score t+1 ends here
              my_term = true;
              my_ls = kn == h ? (c.tb & 7) : 0;
            }
            h = kn;
          }
          Hn[s] = h;
          E1n[s] = c.e1;
          F1n[s] = c.f1;
          E2n[s] = c.e2;
          F2n[s] = c.f2;
          if (is_tb) tb[(size_t)t * Wz + s] = (unsigned char)c.tb;
          if (any_viable(c)) {
            lo_ok |= d == lo;
            hi_ok |= d == hi;
          }
        }
        if (lane == 0) {  // no source of this transition is score t+1-RH
          bnd_lo[rn] = lo;
          bnd_hi[rn] = hi;
          if (is_tb) {
            bands[2 * t] = lo;
            bands[2 * t + 1] = hi;
          }
        }
        const unsigned tm = __ballot_sync(FULL, my_term);
        term_at = tm != 0;
        if (is_tb && tm) ls_at = __shfl_sync(FULL, my_ls, __ffs((int)tm) - 1);
        if (__any_sync(FULL, lo_ok)) wf_lo = lo;  // boundary commit
        if (__any_sync(FULL, hi_ok)) wf_hi = hi;  // (miniwfa.c:325-326)
        __syncwarp();  // score t+1's slots and registry entry are written
        t_lo = lo;
        t_hi = hi;

        // --- 4. shrink every 256 cycles (miniwfa.c:420)
        if (((t + 1) & 0xFF) == 0) {
          const int vfloor = viable_floor(t, NS);
          int mn = BIG, mx = -BIG;
          const int se = min(wf_hi - anc, W - 1);
          for (int s = max(wf_lo - anc, 0) + lane; s <= se; s += 32) {
            const int d = anc + s;
            const bool top = d >= lo && d <= hi &&
                             (Hn[s] >= -1 || E1n[s] >= -1 || F1n[s] >= -1 ||
                              E2n[s] >= -1 || F2n[s] >= -1);
            if (top || lastv[s] >= vfloor) {
              mn = min(mn, d);
              mx = max(mx, d);
            }
          }
          mn = __reduce_min_sync(FULL, mn);
          mx = __reduce_max_sync(FULL, mx);
          if (mx >= mn) {
            wf_lo = mn;
            wf_hi = mx;
          }
        }

        // --- 5. accounting + early stop (miniwfa.c:421-425)
        n_iter += hi - lo + 1;
        stopped = (max_iter > 0 && n_iter > max_iter) ||
                  (max_s > 0 && t + 1 > max_s);
      }
      ++t;
      rt = rn;
      r1 = n1;
      r2 = n2;
    }
    if (lane == 0) {
      long long* o = p.out + (size_t)b * O_N;
      o[O_S] = final_s;
      o[O_DONE] = done;
      o[O_STOP] = stopped;
      o[O_OVFB] = ovf;
      o[O_OVFS] = !(done || stopped || ovf);
      o[O_LS] = last_state;
      o[O_NITER] = n_iter;
      o[O_LP] = NEG;
      o[O_SNC] = 0;
    }
  }
}

const void* kernel_of(int mode) {
  return mode == MODE_TB ? (const void*)multi_smem_kernel<MODE_TB>
                         : (const void*)multi_smem_kernel<MODE_SCORE>;
}

}  // namespace

// The dynamic shared memory a block of the smem variant may opt in to on
// the current card: the card's opt-in limit less the kernel's static
// shared memory, as the runtime reports both.
extern "C" int mwf_multi_smem_optin(int mode, int* bytes) {
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel_of(mode));
  if (err != cudaSuccess) return (int)err;
  *bytes = optin - (int)fa.sharedSizeBytes;
  return 0;
}

// Shared-memory bytes of one lane at window W and these penalties
// (ops/wavefront_multi.py::lane_smem).
extern "C" int mwf_multi_lane_bytes(int W, int x, int o1, int e1, int o2,
                                    int e2, long long* bytes) {
  const Depths d = depths(x, o1, e1, o2, e2);
  *bytes = 4 * lane_ints(W, d.RH, d.NP);
  return 0;
}

// K4's smem variant: lpb lanes (warps) per block, every warp taking lanes
// from *next (0 at launch) until none is left; SCORE and TB (with or
// without checkpoints).  A block past the opt-in budget returns the
// runtime's error, never a launch.
extern "C" int mwf_wavefront_multi_smem(
    const long long* lanes, const unsigned* tw, const unsigned* qw,
    long long nw, long long* out, unsigned char* tb, int* bands,
    const long long* segs, int seg_cap, int* next, int B, int W, int S_CAP,
    int mode, int cpw, int x, int o1, int e1, int o2, int e2, int lpb,
    void* stream) {
  if ((mode != MODE_SCORE && mode != MODE_TB) || lpb < 1 || lpb > LPB_MAX)
    return (int)cudaErrorInvalidValue;
  const Depths d = depths(x, o1, e1, o2, e2);
  const long long stride = lane_ints(W, d.RH, d.NP);
  const long long smem = 4 * stride * lpb;
  if (smem > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(mode);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params p{lanes, tw,  qw, nw, out, tb, bands, segs, seg_cap, next,
           B,     W,   S_CAP, cpw, x, o1, e1, o2, e2, (int)stride};
  void* args[] = {&p};
  err = cudaLaunchKernel(fn, dim3((B + lpb - 1) / lpb), dim3(32 * lpb), args,
                         (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
