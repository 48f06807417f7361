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
// Design: a gap's legal diagonals are [-tl, ql], n = tl + ql + 1 <= 128
// slots, and a gap of a chain's first dispatch averages a dozen cells, so
// each gap gets a tile sized to it: the window of WD = 8, 16, 32, 64 or 128
// slots (the smallest that holds n; slot w = diagonal w - tl), T = 8, 16,
// 16, 32 or 32 threads, K = WD / T slots a thread (slot r + i*T for thread
// r of the tile, so a tile's shared-memory accesses never meet in a bank),
// and 32 / T gaps a warp: two a warp at 32 slots, where a chain's first
// dispatch holds nearly all its gaps.  The wrapper groups a dispatch's
// gaps by width class on the host (ops/wavefront_gaps.py::plan: a
// permutation, each class in input order) and launches one instantiation
// per non-empty class on the caller's stream, with its slice of the
// permutation and its count; each kernel reads and writes every gap at
// its own index, so outputs come back in input order.  Per warp, its
// gaps' tiles run in lockstep, each with its own state, until every one
// has ended: a tile's reductions (termination, boundary commit) are the
// warp's __ballot_sync masked to the tile, the last tb byte comes by
// __shfl_sync from the thread that owns slot ql, and the 256-cycle shrink
// hull is a butterfly of __shfl_xor_sync inside the tile.  The score
// rings (H: max age deep, E1/F1: e1, E2/F2: e2; score s in slot s %
// depth) and both packed sequences sit in the tile's slice of shared
// memory.  Per cycle:
//   1. LCP extension of the top band's slots (funnel shift of two words,
//      __ffs of the XOR), capped at the matrix edge, and termination.
//   2. viability of the retired score-t slice over the top band (its other
//      slots hold WF_NEG_INF): per slot, in a register, one past the last
//      score whose slice was viable there (0: never); only in the NS-1
//      cycles before a shrink, since the shrink reads lastv >= t-NS+3 and
//      a value from before is smaller.
//   3. the 5-state transition into t+1 with the '>=' / '<' tie-breaks of
//      wf_next_tb (miniwfa.c:287-307), computed only over the new band
//      [lo, hi]; the tile's other reachable slots (0 .. n) are written
//      WF_NEG_INF, so a neighbour read needs no band test.  A __syncwarp
//      separates every read of the source rings from the writes of score
//      t+1 (the oldest source slot is the one score t+1 takes).
//   4. TB mode: the byte of every in-band cell that is not 0 goes to
//      tb [G, S_CAP, 128] (row t = transition into t+1, the wavefront
//      kernel's layout with anchor -tl, which the walker reads as is); the
//      wrapper's zeroing gives every other byte, as the plain version's.
//   5. boundary commit, the shrink, n_iter and the early stops.
// Only the slots the band can reach, 0 .. n, are initialised, and every
// ring slot is a counter that wraps, not a modulo.
//
// What bounds it: a cycle is a few dozen dependent integer operations per
// slot and a handful of warp votes, so the time is the warps' instruction
// latency over the gaps' cycles.  A warp's shared memory is 2.9 KB (8 and
// 16 slots) to 11.5 KB (128) at the default penalties (22 ring planes of
// WD slots for each of its gaps), so up to 8 warps a block, and registers,
// not shared memory, bound the warps an SM holds, where the 128-slot
// window of every gap held 16.  The rings bound the penalties: a 128-slot
// gap's must fit a block's shared memory, at most 453 ring planes
// (max_pen 449 at e1 = e2 = 1; ops/wavefront_gaps.py::fits).  DRAM
// traffic is only the inputs, the outputs and the traceback bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -0x40000000;  // reference sentinel (miniwfa.c:67)
constexpr int BIG = 0x3FFFFFFF;
constexpr int WIN = 128;          // tb row width (the largest window)
constexpr int MAX_TOT = 127;      // tl + ql of a gap at most
constexpr int MAX_NW = MAX_TOT / 4 + 2;  // n_words(MAX_TOT, cpw=4) per side
constexpr int WPB = 8;            // warps per block at most
constexpr int NCLS = 5;           // width classes: 8, 16, 32, 64, 128 slots
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
  const int* perm;       // [count] the class's gap indices
  int count;
  int S_CAP, mode, cpw;
  int x, o1, e1, o2, e2, max_s;
  long long max_iter;
  int DH, DE1, DE2, wpb;
};

// Words of one side a tile of WD slots keeps: its sequences have at most
// WD - 1 characters, n_words(WD - 1, cpw=4).
__host__ __device__ constexpr int tile_words(int WD) {
  return (WD - 1) / 4 + 2;
}

// Ints of shared memory a gap's tile of WD slots takes.
__host__ __device__ inline int gap_ints(int WD, int ring_n) {
  return ring_n * WD + 2 * tile_words(WD);
}

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

// v in [-n, 2n) brought into [0, n).
__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : v >= n ? v - n : v;
}

// One warp's GPW gaps of a class, from index w0 of the class's gaps in
// perm: tiles of T threads, K slots a thread (WD = T * K), in the warp's
// slice `ws` of shared memory.
template <int T, int K>
__device__ __forceinline__ void gaps_tile(const Params& p, int* ws, int lane,
                                          int w0) {
  constexpr int WD = T * K, NWT = tile_words(WD);
  constexpr unsigned TMASK = T == 32 ? FULL : (1u << (T & 31)) - 1;
  const int tile = lane / T, r = lane % T, base = tile * T;
  const bool has = w0 + tile < p.count;
  const int g = has ? p.perm[w0 + tile] : 0;
  const int DH = p.DH, DE1 = p.DE1, DE2 = p.DE2;
  const int ring_n = DH + 2 * DE1 + 2 * DE2;
  int* rH = ws + (size_t)tile * gap_ints(WD, ring_n);
  int* rE1 = rH + DH * WD;
  int* rF1 = rE1 + DE1 * WD;
  int* rE2 = rF1 + DE1 * WD;
  int* rF2 = rE2 + DE2 * WD;
  unsigned* sT = (unsigned*)(rF2 + DE2 * WD);
  unsigned* sQ = sT + NWT;
  const int tl = has ? p.lens[2 * g] : 0, ql = has ? p.lens[2 * g + 1] : 0;
  const int d_end = ql - tl;
  const int reach = min(tl + ql + 2, WD);  // slots 0 .. n the band can read
  const int ag_x = p.x, ag_o1 = p.o1 + p.e1, ag_o2 = p.o2 + p.e2;
  const int NS = max(ag_x, max(ag_o1, ag_o2)) + 1;
  const bool is_tb = p.mode == MODE_TB;
  const int cpw = p.cpw, bits = 32 / cpw;
  const int logc = cpw == 16 ? 4 : 2, logb = cpw == 16 ? 1 : 3;

  for (int j = r; j < NWT; j += T) {
    const bool in = has && j < p.nw;
    sT[j] = in ? p.tw[(size_t)g * p.nw + j] : 0u;
    sQ[j] = in ? p.qw[(size_t)g * p.nw + j] : 0u;
  }
  for (int pl = 0; pl < ring_n; ++pl)
    for (int s = r; s < reach; s += T) rH[pl * WD + s] = NEG;
  __syncwarp();
  if (has && r == 0) rH[tl] = -1;  // score-0 top: H[d=0] = -1 (miniwfa.c:119)
  __syncwarp();

  // per slot of the thread: one past the last score whose retired slice
  // was viable there (0: never), and its byte of the last tb row
  int lastv[K], pb[K];
#pragma unroll
  for (int i = 0; i < K; ++i) lastv[i] = pb[i] = 0;
  int t = 0, wlo = 0, whi = 0, tlo = 0, thi = 0;
  int final_s = -1, last_state = 0, n_iter = 0;
  bool done = !has, stopped = false;  // a tile with no gap has ended
  int ht = 0, h1 = 0, h2 = 0;  // t % DH, t % DE1, t % DE2: counters
  for (;;) {
    const int hn = ht + 1 == DH ? 0 : ht + 1;  // (t+1) % DH
    const int n1 = h1 + 1 == DE1 ? 0 : h1 + 1;
    const int n2 = h2 + 1 == DE2 ? 0 : h2 + 1;
    const bool run = !(done || stopped) && t < p.S_CAP - 1;
    if (!__any_sync(FULL, run)) break;
    // --- 1. extension of the top band (miniwfa.c:400-411)
    int* Ht = rH + ht * WD;
    bool at_end = false, at_zero = false;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int s = r + i * T, d = s - tl;
      if (!run || d < tlo || d > thi) continue;
      const int k = Ht[s];
      if (!good_diag(k, d, tl, ql)) continue;
      const int kn = extend(sT, sQ, k, d, tl, ql, cpw, logc, bits, logb);
      Ht[s] = kn;
      if (d == d_end && kn == tl - 1) {
        at_end = true;
        at_zero = kn == k;
      }
    }
    const bool term = (__ballot_sync(FULL, at_end) >> base) & TMASK;
    const bool zero = (__ballot_sync(FULL, at_zero) >> base) & TMASK;

    // --- 2. termination (miniwfa.c:405-408): last_state only on a
    // zero-extension termination, from the previous row's byte at d_end
    // (slot ql, thread ql % T's byte ql / T)
    int mine = 0;
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i == ql / T) mine = pb[i];
    const int pbq = __shfl_sync(FULL, mine, base + ql % T);
    if (run && term) {
      if (is_tb && zero && t > 0) last_state = pbq & 7;
      final_s = t;
      done = true;
    }
    __syncwarp();  // the extended tops are read by the neighbours below
    const bool act = run && !term;

    // --- 3. band growth, clamped to the matrix (miniwfa.c:417-418)
    const int lo = max(wlo - 1, -tl), hi = min(whi + 1, ql);

    // --- 4. viability of the retired score-t slice (its top band), kept
    // only in the NS-1 cycles before a shrink, the only ones the shrink's
    // test can see (an older value is smaller)
    if (act && 255 - (t & 0xFF) <= NS - 2) {
      const int* E1t = rE1 + h1 * WD;
      const int* F1t = rF1 + h1 * WD;
      const int* E2t = rE2 + h2 * WD;
      const int* F2t = rF2 + h2 * WD;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int s = r + i * T, d = s - tl;
        if (d >= tlo && d <= thi &&
            (good_diag(Ht[s], d, tl, ql) || good_diag(E1t[s], d, tl, ql) ||
             good_diag(F1t[s], d, tl, ql) || good_diag(E2t[s], d, tl, ql) ||
             good_diag(F2t[s], d, tl, ql)))
          lastv[i] = t + 1;
      }
    }

    // --- 5. transition into score t+1 (wf_next_tb semantics) over the
    // new band
    // score t+1-age sits at slot (t+1-age) % depth; a negative score's
    // slot holds WF_NEG_INF until score t+1 first takes it
    const int* Sx = rH + wrap(ht + 1 - ag_x, DH) * WD;
    const int* So1 = rH + wrap(ht + 1 - ag_o1, DH) * WD;
    const int* So2 = rH + wrap(ht + 1 - ag_o2, DH) * WD;
    const int* Se1 = rE1 + wrap(h1 + 1 - p.e1, DE1) * WD;
    const int* Sf1 = rF1 + wrap(h1 + 1 - p.e1, DE1) * WD;
    const int* Se2 = rE2 + wrap(h2 + 1 - p.e2, DE2) * WD;
    const int* Sf2 = rF2 + wrap(h2 + 1 - p.e2, DE2) * WD;
    int nh[K], ne1[K], nf1[K], ne2[K], nf2[K], bm[K];
    bool lo_ok = false, hi_ok = false;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int s = r + i * T, d = s - tl;
      nh[i] = ne1[i] = nf1[i] = ne2[i] = nf2[i] = NEG;
      bm[i] = 0;
      if (!act || d < lo || d > hi) continue;
      const bool m = s > 0, pl = s < WD - 1;
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
      nh[i] = h;
      ne1[i] = a1;
      nf1[i] = b1;
      ne2[i] = a2;
      nf2[i] = b2;
      bm[i] = ((ho1m < e1m) << 3) | ((ho1p < f1p) << 4) |
              ((ho2m < e2m) << 5) | ((ho2p < f2p) << 6) | z;
      const bool viable =
          h >= -1 || a1 >= -1 || b1 >= -1 || a2 >= -1 || b2 >= -1;
      lo_ok |= viable && d == lo;
      hi_ok |= viable && d == hi;
    }
    __syncwarp();  // every source read before score t+1 takes its slot
    if (act) {
      int* Hn = rH + hn * WD;
      int* E1n = rE1 + n1 * WD;
      int* F1n = rF1 + n1 * WD;
      int* E2n = rE2 + n2 * WD;
      int* F2n = rF2 + n2 * WD;
      unsigned char* row =
          is_tb ? p.tb + ((size_t)g * p.S_CAP + t) * WIN : nullptr;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int s = r + i * T;
        if (s >= reach) continue;
        Hn[s] = nh[i];
        E1n[s] = ne1[i];
        F1n[s] = nf1[i];
        E2n[s] = ne2[i];
        F2n[s] = nf2[i];
        if (is_tb && bm[i]) row[s] = (unsigned char)bm[i];
        pb[i] = bm[i];
      }
    }

    // --- 6. boundary commit (miniwfa.c:325-326)
    const bool lo_c = (__ballot_sync(FULL, lo_ok) >> base) & TMASK;
    const bool hi_c = (__ballot_sync(FULL, hi_ok) >> base) & TMASK;
    if (act) {
      if (lo_c) wlo = lo;
      if (hi_c) whi = hi;
      tlo = lo;
      thi = hi;
    }

    // --- 7. shrink every 256 cycles (miniwfa.c:420): hull of the new
    // tops' good diagonals and the NS-1 youngest retired slices
    if (((t + 1) & 0xFF) == 0) {
      const int vfloor = max(t - NS + 3, 1);  // last viable >= t-NS+2
      int mn = BIG, mx = -BIG;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int d = r + i * T - tl;
        const bool top =
            good_diag(nh[i], d, tl, ql) || good_diag(ne1[i], d, tl, ql) ||
            good_diag(nf1[i], d, tl, ql) || good_diag(ne2[i], d, tl, ql) ||
            good_diag(nf2[i], d, tl, ql);
        if (act && (top || lastv[i] >= vfloor) && d >= wlo && d <= whi) {
          mn = min(mn, d);
          mx = max(mx, d);
        }
      }
#pragma unroll
      for (int o = T / 2; o > 0; o >>= 1) {
        mn = min(mn, __shfl_xor_sync(FULL, mn, o));
        mx = max(mx, __shfl_xor_sync(FULL, mx, o));
      }
      if (act && mn <= mx) {
        wlo = mn;
        whi = mx;
      }
    }

    // --- 8. accounting + early stop (miniwfa.c:421-425)
    if (act) {
      n_iter += hi - lo + 1;
      stopped = (p.max_iter > 0 && n_iter > p.max_iter) ||
                (p.max_s > 0 && t + 1 > p.max_s);
    }
    ++t;
    ht = hn;
    h1 = n1;
    h2 = n2;
  }
  if (has && r == 0) {
    int* o = p.out + (size_t)g * GO_N;
    o[GO_S] = final_s;
    o[GO_DONE] = done;
    o[GO_STOP] = stopped;
    o[GO_OVF] = !(done || stopped);
    o[GO_LS] = last_state;
    o[GO_NI] = n_iter;
  }
}

// One width class: tiles of T threads, K slots a thread (WD = T * K);
// warp i of block j takes the class's gaps (j * wpb + i) * GPW onwards.
template <int T, int K>
__global__ void __launch_bounds__(32 * WPB) gaps_kernel(Params p) {
  constexpr int WD = T * K, GPW = 32 / T;
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = (blockIdx.x * p.wpb + warp) * GPW;
  if (w0 >= p.count) return;
  gaps_tile<T, K>(p, smem + (size_t)warp * GPW * gap_ints(WD, p.DH + 2 *
                  p.DE1 + 2 * p.DE2), lane, w0);
}

struct Class {
  const void* fn;
  int T, WD;
};

const Class CLASSES[NCLS] = {
    {(const void*)gaps_kernel<8, 1>, 8, 8},
    {(const void*)gaps_kernel<16, 1>, 16, 16},
    {(const void*)gaps_kernel<16, 2>, 16, 32},
    {(const void*)gaps_kernel<32, 2>, 32, 64},
    {(const void*)gaps_kernel<32, 4>, 32, 128}};

// A block of class c: as many warps as fit the shared-memory cap, at most
// WPB, each with its 32 / T gaps' slices (*smem bytes in all).
cudaError_t block_of(int c, int x, int o1, int e1, int o2, int e2, int* smem,
                     int* warps) {
  if (c < 0 || c >= NCLS) return cudaErrorInvalidValue;
  const int ring_n =
      max(x, max(o1 + e1, o2 + e2)) + 2 * max(e1, 1) + 2 * max(e2, 1);
  const int per_warp = (32 / CLASSES[c].T) *
                       gap_ints(CLASSES[c].WD, ring_n) * (int)sizeof(int);
  *warps = min(WPB, SMEM_CAP / per_warp);
  *smem = *warps * per_warp;
  return *warps < 1 ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace

// Width class c's gaps, perm [count] (their indices, ops/wavefront_gaps.py
// plan), on the stream: ceil(count / gaps a block) blocks of as many warps
// as fit the shared-memory cap.
extern "C" int mwf_gaps(int c, const int* lens, const unsigned* tw,
                        const unsigned* qw, int nw, int* out,
                        unsigned char* tb, const int* perm, int count,
                        int S_CAP, int mode, int cpw, int x, int o1, int e1,
                        int o2, int e2, int max_s, long long max_iter,
                        void* stream) {
  if (nw < 2 || nw > MAX_NW || count < 1) return (int)cudaErrorInvalidValue;
  int smem, wpb;
  cudaError_t err = block_of(c, x, o1, e1, o2, e2, &smem, &wpb);
  if (err != cudaSuccess) return (int)err;
  const Class& k = CLASSES[c];
  err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const int DH = max(x, max(o1 + e1, o2 + e2));
  const int DE1 = max(e1, 1), DE2 = max(e2, 1);
  const int per_block = wpb * (32 / k.T);
  Params p{lens, tw, qw, nw, out, tb, perm, count, S_CAP, mode, cpw,
           x, o1, e1, o2, e2, max_s, max_iter, DH, DE1, DE2, wpb};
  void* args[] = {&p};
  err = cudaLaunchKernel(k.fn, dim3((count + per_block - 1) / per_block),
                         dim3(32 * wpb), args, (size_t)smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory (bytes) and warps a block of width class c takes
// at these penalties, as mwf_gaps launches it (ops/wavefront_gaps.py
// block_of).
extern "C" int mwf_gaps_block(int c, int x, int o1, int e1, int o2, int e2,
                              int* smem, int* warps) {
  return (int)block_of(c, x, o1, e1, o2, e2, smem, warps);
}
