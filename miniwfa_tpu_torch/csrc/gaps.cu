// K3: the gaps kernel for Hopper (sm_90a): many tiny exact alignments
// (tl + ql <= 127) at once, SCORE and TB modes.
//
// Replaces miniwfa_tpu/ops/wavefront_gaps.py::build_gaps_kernel (the
// gaps-in-sublanes Pallas kernel), which serves the chain mode's exact gap
// fills.  Same semantics, which are the wavefront kernel's (K1,
// csrc/wavefront.cu) for pairs this small; the plain PyTorch twin is
// miniwfa_tpu_torch/ops/wavefront_gaps.py::gaps_plain, and the module
// docstring there gives the layouts both share.
//
// Design: one warp per gap, each gap looping over its own cycles with no
// block barrier.  Chosen over a 128-thread block per gap because a gap's
// row reductions (termination, boundary commit, shrink hull) then become
// warp votes and reductions instead of block barriers every cycle, and
// the gaps of a block, which end at different cycles, never wait for
// each other.  A gap's window is 128 diagonals (slot w = diagonal
// w - tl), which spans the whole legal range [-tl, ql], so the band never
// overflows and every sweep is the full window: lane j owns slots
// 4j .. 4j+3.  The score rings (H: max age deep, E1/F1: e1, E2/F2: e2) sit
// in the warp's slice of shared memory, score s in slot s % depth, with
// both packed sequences (at most 33 words each).  Per cycle:
//   1. LCP extension of the lane's top-band slots (funnel shift of two
//      words, __ffs of the XOR), capped at the matrix edge; termination
//      and its zero-extension flag by __any_sync; last_state comes from
//      the owning lane's previous tb byte by __shfl_sync.
//   2. viability of the retired score-t slice: per slot, in a register,
//      one past the last score whose slice was viable there (0: never).
//   3. the 5-state transition into t+1 with the '>=' / '<' tie-breaks of
//      wf_next_tb (miniwfa.c:287-307).  Neighbour diagonals are read from
//      shared memory; a __syncwarp separates every read of the source
//      rings from the writes of score t+1 (the oldest source slot is the
//      one score t+1 takes).  Out-of-band slots are written WF_NEG_INF.
//   4. TB mode: each lane packs its 4 tb bytes into one 32-bit store, so a
//      gap's traceback row is one coalesced 128-byte write to
//      tb [G, S_CAP, 128] (row t = transition into t+1, the wavefront
//      kernel's layout with anchor -tl, which the walker reads as is).
//   5. boundary commit by __any_sync, the 256-cycle shrink hull by
//      __reduce_min_sync / __reduce_max_sync, n_iter and the early stops.
//
// What bounds it: a cycle is a few dozen dependent integer operations per
// slot and a handful of warp votes, so the time is the warps' instruction
// latency over s cycles, with 4 gaps a block and 16 gaps an SM resident
// (12 KB of rings each at the default penalties).  The rings bound the
// penalties: one gap's must fit a block's shared memory, at most 453 ring
// planes (max_pen 449 at e1 = e2 = 1; ops/wavefront_gaps.py::fits).  DRAM traffic is only
// the inputs, the outputs and the traceback rows.  Correctness first:
// skipping the slots outside the live band and packing several small gaps
// per warp are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -0x40000000;  // reference sentinel (miniwfa.c:67)
constexpr int BIG = 0x3FFFFFFF;
constexpr int WIN = 128;          // diagonals per gap window
constexpr int MAX_TOT = 127;      // tl + ql of a gap at most
constexpr int MAX_NW = MAX_TOT / 4 + 2;  // n_words(MAX_TOT, cpw=4) per side
constexpr int WARPS = 4;          // gaps per block at most
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int SMEM_CAP = 232448;  // dynamic shared memory a block may use

enum { GO_S, GO_DONE, GO_STOP, GO_OVF, GO_LS, GO_NI, GO_N };
enum { MODE_SCORE, MODE_TB };

struct Params {
  const int* lens;       // [G, 2] (tl, ql)
  const unsigned* tw;    // [G, nw] flat packed words
  const unsigned* qw;
  int nw;
  int* out;              // [G, GO_N]
  unsigned char* tb;     // [G, S_CAP, 128] (TB mode) or null
  int G, S_CAP, mode, cpw;
  int x, o1, e1, o2, e2, max_s;
  long long max_iter;
  int DH, DE1, DE2, wpb;
};

__device__ __forceinline__ unsigned chars_at(const unsigned* w, int pos,
                                             int logc, int bits, int cpw) {
  const int j = pos >> logc;
  return __funnelshift_r(w[j], w[j + 1], (pos & (cpw - 1)) * bits);
}

// k advanced along the diagonal's match run, capped at the matrix edge.
__device__ int extend(const unsigned* tw, const unsigned* qw, int k, int d,
                      int tl, int ql, int cpw, int logc, int bits, int logb) {
  const int cap = min(tl - 1 - k, ql - 1 - (d + k));
  int adv = 0;
  while (adv < cap) {
    const unsigned x = chars_at(tw, k + 1 + adv, logc, bits, cpw) ^
                       chars_at(qw, d + k + 1 + adv, logc, bits, cpw);
    if (x) {
      adv += (__ffs((int)x) - 1) >> logb;
      break;
    }
    adv += cpw;
  }
  return k + min(adv, cap);
}

// k in [-1, tl) and d+k in [-1, ql) (miniwfa.c:139-171)
__device__ __forceinline__ bool good_diag(int v, int d, int tl, int ql) {
  return v >= -1 && v < tl && d + v >= -1 && d + v < ql;
}

__device__ __forceinline__ int ring_slot(int t, int age, int depth) {
  return ((t + 1 - age) % depth + depth) % depth;
}

__global__ void __launch_bounds__(32 * WARPS) gaps_kernel(Params p) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * p.wpb + warp;
  if (g >= p.G) return;  // the warp's whole gap; no block barrier follows
  const int DH = p.DH, DE1 = p.DE1, DE2 = p.DE2;
  const int ring_n = DH + 2 * DE1 + 2 * DE2;
  int* rH = smem + (size_t)warp * (ring_n * WIN + 2 * MAX_NW);
  int* rE1 = rH + DH * WIN;
  int* rF1 = rE1 + DE1 * WIN;
  int* rE2 = rF1 + DE1 * WIN;
  int* rF2 = rE2 + DE2 * WIN;
  unsigned* sT = (unsigned*)(rF2 + DE2 * WIN);
  unsigned* sQ = sT + MAX_NW;
  const int tl = p.lens[2 * g], ql = p.lens[2 * g + 1], d_end = ql - tl;
  const int ag_x = p.x, ag_o1 = p.o1 + p.e1, ag_o2 = p.o2 + p.e2;
  const int NS = max(ag_x, max(ag_o1, ag_o2)) + 1;
  const bool is_tb = p.mode == MODE_TB;
  const int cpw = p.cpw, bits = 32 / cpw;
  const int logc = cpw == 16 ? 4 : 2, logb = cpw == 16 ? 1 : 3;

  for (int j = lane; j < MAX_NW; j += 32) {
    const bool in = j < p.nw;
    sT[j] = in ? p.tw[(size_t)g * p.nw + j] : 0u;
    sQ[j] = in ? p.qw[(size_t)g * p.nw + j] : 0u;
  }
  for (int i = lane; i < ring_n * WIN; i += 32) rH[i] = NEG;
  __syncwarp();
  if (lane == 0) rH[tl] = -1;  // score-0 top: H[d=0] = -1 (miniwfa.c:119)
  __syncwarp();

  const int s0 = 4 * lane;     // this lane's first slot
  int lastv[4] = {0, 0, 0, 0};
  unsigned pbits = 0u;         // this lane's 4 bytes of the last tb row
  int t = 0, wlo = 0, whi = 0, tlo = 0, thi = 0;
  int final_s = -1, last_state = 0, n_iter = 0;
  bool done = false, stopped = false;
  while (!(done || stopped) && t < p.S_CAP - 1) {
    // --- 1. extension of the top band (miniwfa.c:400-411)
    int* Ht = rH + (t % DH) * WIN;
    bool at_end = false, at_zero = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + i, d = s - tl;
      if (d < tlo || d > thi) continue;
      const int k = Ht[s];
      if (!good_diag(k, d, tl, ql)) continue;
      const int kn = extend(sT, sQ, k, d, tl, ql, cpw, logc, bits, logb);
      Ht[s] = kn;
      if (d == d_end && kn == tl - 1) {
        at_end = true;
        at_zero = kn == k;
      }
    }
    const bool term = __any_sync(FULL, at_end);
    const bool zero = __any_sync(FULL, at_zero);

    // --- 2. termination (miniwfa.c:405-408): last_state only on a
    // zero-extension termination, from the previous row's byte at d_end
    if (term) {
      const unsigned pb = __shfl_sync(FULL, pbits, ql >> 2);
      if (is_tb && zero && t > 0) last_state = (pb >> (8 * (ql & 3))) & 7;
      final_s = t;
      done = true;
      break;
    }
    __syncwarp();  // the extended tops are read by the neighbours below

    // --- 3. band growth, clamped to the matrix (miniwfa.c:417-418)
    const int lo = max(wlo - 1, -tl), hi = min(whi + 1, ql);

    // --- 4. viability of the retired score-t slice
    {
      const int* E1t = rE1 + (t % DE1) * WIN;
      const int* F1t = rF1 + (t % DE1) * WIN;
      const int* E2t = rE2 + (t % DE2) * WIN;
      const int* F2t = rF2 + (t % DE2) * WIN;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + i, d = s - tl;
        if (good_diag(Ht[s], d, tl, ql) || good_diag(E1t[s], d, tl, ql) ||
            good_diag(F1t[s], d, tl, ql) || good_diag(E2t[s], d, tl, ql) ||
            good_diag(F2t[s], d, tl, ql))
          lastv[i] = t + 1;
      }
    }

    // --- 5. transition into score t+1 (wf_next_tb semantics)
    const int* Sx = rH + ring_slot(t, ag_x, DH) * WIN;
    const int* So1 = rH + ring_slot(t, ag_o1, DH) * WIN;
    const int* So2 = rH + ring_slot(t, ag_o2, DH) * WIN;
    const int* Se1 = rE1 + ring_slot(t, p.e1, DE1) * WIN;
    const int* Sf1 = rF1 + ring_slot(t, p.e1, DE1) * WIN;
    const int* Se2 = rE2 + ring_slot(t, p.e2, DE2) * WIN;
    const int* Sf2 = rF2 + ring_slot(t, p.e2, DE2) * WIN;
    int nh[4], ne1[4], nf1[4], ne2[4], nf2[4];
    unsigned bm = 0u;
    bool lo_ok = false, hi_ok = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + i, d = s - tl;
      const bool m = s > 0, pl = s < WIN - 1;
      const int ho1m = m ? So1[s - 1] : NEG, ho1p = pl ? So1[s + 1] : NEG;
      const int ho2m = m ? So2[s - 1] : NEG, ho2p = pl ? So2[s + 1] : NEG;
      const int e1m = m ? Se1[s - 1] : NEG, f1p = pl ? Sf1[s + 1] : NEG;
      const int e2m = m ? Se2[s - 1] : NEG, f2p = pl ? Sf2[s + 1] : NEG;
      const int hx = Sx[s] + 1;
      const int a1 = max(ho1m, e1m), a2 = max(ho2m, e2m);
      const int b1 = max(ho1p, f1p) + 1, b2 = max(ho2p, f2p) + 1;
      const int ev = max(a1, a2), fv = max(b1, b2);
      int z = ev >= fv ? (a1 >= a2 ? 1 : 3) : (b1 >= b2 ? 2 : 4);
      const int hv = max(ev, fv);
      if (hx >= hv) z = 0;
      const int h = max(hx, hv);
      const bool in_new = d >= lo && d <= hi;
      nh[i] = in_new ? h : NEG;
      ne1[i] = in_new ? a1 : NEG;
      nf1[i] = in_new ? b1 : NEG;
      ne2[i] = in_new ? a2 : NEG;
      nf2[i] = in_new ? b2 : NEG;
      if (in_new) {
        bm |= (unsigned)(((ho1m < e1m) << 3) | ((ho1p < f1p) << 4) |
                         ((ho2m < e2m) << 5) | ((ho2p < f2p) << 6) | z)
              << (8 * i);
        const bool viable = h >= -1 || a1 >= -1 || b1 >= -1 || a2 >= -1 ||
                            b2 >= -1;
        lo_ok |= viable && d == lo;
        hi_ok |= viable && d == hi;
      }
    }
    __syncwarp();  // every source read before score t+1 takes its slot
    {
      int* Hn = rH + ((t + 1) % DH) * WIN;
      int* E1n = rE1 + ((t + 1) % DE1) * WIN;
      int* F1n = rF1 + ((t + 1) % DE1) * WIN;
      int* E2n = rE2 + ((t + 1) % DE2) * WIN;
      int* F2n = rF2 + ((t + 1) % DE2) * WIN;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + i;
        Hn[s] = nh[i];
        E1n[s] = ne1[i];
        F1n[s] = nf1[i];
        E2n[s] = ne2[i];
        F2n[s] = nf2[i];
      }
    }
    if (is_tb)
      reinterpret_cast<unsigned*>(
          p.tb + ((size_t)g * p.S_CAP + t) * WIN)[lane] = bm;
    pbits = bm;

    // --- 6. boundary commit (miniwfa.c:325-326)
    if (__any_sync(FULL, lo_ok)) wlo = lo;
    if (__any_sync(FULL, hi_ok)) whi = hi;
    tlo = lo;
    thi = hi;

    // --- 7. shrink every 256 cycles (miniwfa.c:420): hull of the new
    // tops' good diagonals and the NS-1 youngest retired slices
    if (((t + 1) & 0xFF) == 0) {
      const int vfloor = max(t - NS + 3, 1);  // last viable >= t-NS+2
      int mn = BIG, mx = -BIG;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = s0 + i - tl;
        const bool top =
            good_diag(nh[i], d, tl, ql) || good_diag(ne1[i], d, tl, ql) ||
            good_diag(nf1[i], d, tl, ql) || good_diag(ne2[i], d, tl, ql) ||
            good_diag(nf2[i], d, tl, ql);
        if ((top || lastv[i] >= vfloor) && d >= wlo && d <= whi) {
          mn = min(mn, d);
          mx = max(mx, d);
        }
      }
      mn = __reduce_min_sync(FULL, mn);
      mx = __reduce_max_sync(FULL, mx);
      if (mn <= mx) {
        wlo = mn;
        whi = mx;
      }
    }

    // --- 8. accounting + early stop (miniwfa.c:421-425)
    n_iter += hi - lo + 1;
    stopped = (p.max_iter > 0 && n_iter > p.max_iter) ||
              (p.max_s > 0 && t + 1 > p.max_s);
    ++t;
  }
  if (lane == 0) {
    int* o = p.out + (size_t)g * GO_N;
    o[GO_S] = final_s;
    o[GO_DONE] = done;
    o[GO_STOP] = stopped;
    o[GO_OVF] = !(done || stopped);
    o[GO_LS] = last_state;
    o[GO_NI] = n_iter;
  }
}

}  // namespace

extern "C" int mwf_gaps(const int* lens, const unsigned* tw,
                        const unsigned* qw, int nw, int* out,
                        unsigned char* tb, int G, int S_CAP, int mode,
                        int cpw, int x, int o1, int e1, int o2, int e2,
                        int max_s, long long max_iter, void* stream) {
  if (nw < 2 || nw > MAX_NW) return (int)cudaErrorInvalidValue;
  const int DH = max(x, max(o1 + e1, o2 + e2));
  const int DE1 = max(e1, 1), DE2 = max(e2, 1);
  const int per_warp =
      ((DH + 2 * DE1 + 2 * DE2) * WIN + 2 * MAX_NW) * (int)sizeof(int);
  const int wpb = min(WARPS, SMEM_CAP / per_warp);
  if (wpb < 1) return (int)cudaErrorInvalidValue;
  const int smem = wpb * per_warp;
  cudaError_t err = cudaFuncSetAttribute(
      gaps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Params p{lens, tw, qw, nw, out, tb, G, S_CAP, mode, cpw, x, o1, e1, o2, e2,
           max_s, max_iter, DH, DE1, DE2, wpb};
  gaps_kernel<<<(G + wpb - 1) / wpb, 32 * wpb, smem, (cudaStream_t)stream>>>(
      p);
  return (int)cudaGetLastError();
}
