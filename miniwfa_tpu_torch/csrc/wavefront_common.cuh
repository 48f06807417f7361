// Device code shared by the wavefront kernels: K1 (wavefront.cu, one
// cluster of blocks per lane) and the wide kernel (wavefront_wide.cu, one
// lane over the whole card).  Both run the same recurrence (see the notes in
// wavefront.cu); what they share here is the per-diagonal work: the
// extension probe, the good-diagonal test, the band-masked source read, the
// 5-state transition of one cell with its tb bits, the PASS1 pointer choice,
// and the snapshot plane -> ring slot map.  The load policy is a template
// flag: K1 at one block per lane (and K4) reads its planes with plain loads
// (__syncthreads orders every access), K1's clusters and the wide kernel
// with ld.global.cg, which skips the SM's L1: another SM may have written
// the line in the same launch, and L1 is not coherent across SMs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mwf {

constexpr int NEG = -0x40000000;  // reference sentinel (miniwfa.c:67)
constexpr int BIG = 0x3FFFFFFF;
constexpr int SMEM_DEFAULT = 48 * 1024;  // dynamic shared memory without opt-in

enum { L_TL, L_QL, L_ANC, L_MS, L_MI, L_N };
enum { O_S, O_DONE, O_STOP, O_OVFB, O_OVFS, O_LS, O_NITER, O_LP, O_SNC, O_N };
enum { MODE_SCORE, MODE_TB, MODE_PASS1 };

template <bool CG>
__device__ __forceinline__ int ld(const int* p) {
  if constexpr (CG) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// A source plane of the transition: the ring slot of score t+1-age and
// that score's recorded band (empty for negative scores).
struct Src {
  const int* p;
  int lo, hi;
};

// LDG: read the words through the read-only data path (ld.global.nc).
template <bool LDG = false>
__device__ __forceinline__ unsigned chars_at(const unsigned* w, long long pos,
                                             int logc, int bits, int cpw) {
  const long long j = pos >> logc;
  if constexpr (LDG) {
    return __funnelshift_r(__ldg(w + j), __ldg(w + j + 1),
                           (int)(pos & (cpw - 1)) * bits);
  } else {
    return __funnelshift_r(w[j], w[j + 1], (int)(pos & (cpw - 1)) * bits);
  }
}

// k advanced along the diagonal's match run, capped at the matrix edge.
template <bool LDG = false>
__device__ __forceinline__ int extend(const unsigned* tw, const unsigned* qw,
                                      int k, int d, int tl, int ql, int cpw,
                                      int logc, int bits, int logb) {
  const int cap = min(tl - 1 - k, ql - 1 - (d + k));
  const long long pt = (long long)k + 1, pq = (long long)d + k + 1;
  int adv = 0;
  while (adv < cap) {
    const unsigned x = chars_at<LDG>(tw, pt + adv, logc, bits, cpw) ^
                       chars_at<LDG>(qw, pq + adv, logc, bits, cpw);
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

// value (off = 0) or pointer (off = poff) of a source slot, NEG outside
// its score's band
template <bool CG>
__device__ __forceinline__ int rd(const Src& s, int slot, int anc,
                                  size_t off = 0) {
  const int d = anc + slot;
  return (d >= s.lo && d <= s.hi) ? ld<CG>(s.p + off + slot) : NEG;
}

// The sources of the transition into score t+1, in the order Hx, Ho1, Ho2,
// E1, F1, E2, F2 (ages x, o1+e1, o2+e2, e1, e1, e2, e2), each a T that a
// reader turns into the value at a slot.
template <class T>
struct SourcesOf {
  T x, h1, h2, e1, f1, e2, f2;
};
using Sources = SourcesOf<Src>;

// The band-masked read of a source in global memory (rd).
template <bool CG>
struct GlobalRead {
  int anc;
  __device__ __forceinline__ int operator()(const Src& s, int slot,
                                            size_t off = 0) const {
    return rd<CG>(s, slot, anc, off);
  }
};

// One cell of the transition into score t+1 (miniwfa.c:243-327), with the
// exact '>=' / '<' tie-breaks of wf_next_tb (miniwfa.c:287-307); `tb` is
// the 7-bit traceback byte.
struct Cell {
  int h, e1, f1, e2, f2, tb;
};

template <class R, class T>
__device__ __forceinline__ Cell transition_by(const R& rd, const SourcesOf<T>& S,
                                              int s) {
  const int ho1m = rd(S.h1, s - 1), ho1p = rd(S.h1, s + 1);
  const int ho2m = rd(S.h2, s - 1), ho2p = rd(S.h2, s + 1);
  const int e1m = rd(S.e1, s - 1), f1p = rd(S.f1, s + 1);
  const int e2m = rd(S.e2, s - 1), f2p = rd(S.f2, s + 1);
  const int hx = rd(S.x, s) + 1;
  const int ne1 = max(ho1m, e1m), ne2 = max(ho2m, e2m);
  const int nf1 = max(ho1p, f1p) + 1, nf2 = max(ho2p, f2p) + 1;
  const int ev = max(ne1, ne2), fv = max(nf1, nf2);
  int z = ev >= fv ? (ne1 >= ne2 ? 1 : 3) : (nf1 >= nf2 ? 2 : 4);
  const int hv = max(ev, fv);
  if (hx >= hv) z = 0;
  Cell c;
  c.h = max(hx, hv);
  c.e1 = ne1;
  c.f1 = nf1;
  c.e2 = ne2;
  c.f2 = nf2;
  c.tb = ((ho1m < e1m) << 3) | ((ho1p < f1p) << 4) | ((ho2m < e2m) << 5) |
         ((ho2p < f2p) << 6) | z;
  return c;
}

template <bool CG>
__device__ __forceinline__ Cell transition(const Sources& S, int s, int anc) {
  return transition_by(GlobalRead<CG>{anc}, S, s);
}

// PASS1: each state copies the pointer of the source its tb bits chose
// (reference wf_next_seg, miniwfa.c:495-523); pointer planes sit `poff`
// after their value planes.
template <class R, class T>
__device__ __forceinline__ Cell pointers_by(const R& rd, const SourcesOf<T>& S,
                                            int s, size_t poff, int tb) {
  Cell p;
  p.e1 = (tb & 0x08) ? rd(S.e1, s - 1, poff) : rd(S.h1, s - 1, poff);
  p.f1 = (tb & 0x10) ? rd(S.f1, s + 1, poff) : rd(S.h1, s + 1, poff);
  p.e2 = (tb & 0x20) ? rd(S.e2, s - 1, poff) : rd(S.h2, s - 1, poff);
  p.f2 = (tb & 0x40) ? rd(S.f2, s + 1, poff) : rd(S.h2, s + 1, poff);
  const int z = tb & 7;
  p.h = z == 0   ? rd(S.x, s, poff)
        : z == 1 ? p.e1
        : z == 2 ? p.f1
        : z == 3 ? p.e2
                 : p.f2;
  p.tb = 0;
  return p;
}

template <bool CG>
__device__ __forceinline__ Cell pointers(const Sources& S, int s, int anc,
                                         size_t poff, int tb) {
  return pointers_by(GlobalRead<CG>{anc}, S, s, poff, tb);
}

__device__ __forceinline__ bool any_viable(const Cell& c) {
  return c.h >= -1 || c.e1 >= -1 || c.f1 >= -1 || c.e2 >= -1 || c.f2 >= -1;
}

// The shrink hull keeps a retired slot whose last viable score is one of
// t-NS+2 .. t.  `lastv` holds one past that score (0: never viable), so
// the test is lastv >= t-NS+3, and lastv >= 1 rules out "never".
__device__ __forceinline__ int viable_floor(int t, int NS) {
  return max(t - NS + 3, 1);
}

// Dynamic shared memory of `lanes` band registries (lo and hi for RH
// scores each), with the kernel opted in past the default 48 KB; a
// registry past the block's limit returns an error, never a launch.
inline cudaError_t registry_smem(const void* fn, int lanes, int RH,
                                 int* bytes) {
  *bytes = lanes * 2 * RH * (int)sizeof(int);
  if (*bytes <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *bytes);
}

// Ring depth and slot of snapshot plane pl (H | E1 | F1 | E2 | F2).
__device__ __forceinline__ void plane_slot(int pl, int RH, int RE1, int RE2,
                                           int& depth, int& j) {
  if (pl < RH) {
    depth = RH;
    j = pl;
  } else if (pl < RH + 2 * RE1) {
    depth = RE1;
    j = (pl - RH) % RE1;
  } else {
    depth = RE2;
    j = (pl - RH - 2 * RE1) % RE2;
  }
}

}  // namespace mwf
