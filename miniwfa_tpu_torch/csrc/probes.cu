// Group P: the TPU primitive probes of tools/microbench_*.py as Hopper
// microbenchmarks (sm_90a).
//
// Replaces the 28 pl.pallas_call sites (32 kernel bodies) of
// tools/microbench_mosaic.py, microbench_mosaic2.py, microbench_pallas2.py,
// microbench_mosaic3.py, microbench_chunk.py and microbench_multi_probe*.py:
// the probes that priced, one primitive at a time, what the TPU kernels
// K1, K2 and K4 are built from.  Each entry point computes its probe's
// function; the plain PyTorch twins, and which probe each entry serves,
// are in miniwfa_tpu_torch/ops/probes.py and ops/probes_multi.py.
//
// What bounds them: every probe is a loop of dependent integer work on a
// few KB to a few hundred KB, so each is latency-bound (a load or an ALU
// chain per iteration, a barrier per cycle), far below both the memory and
// the instruction roof; the timings price exactly that latency.  Design
// choices that keep the timing honest:
//   * loop-invariant work stays in the loop: the gather probes' fake
//     dependence `acc[0, 0] & 0` (microbench_mosaic.py:37) becomes
//     `carry & zero` with `zero` a kernel argument (always 0), so nvcc can
//     neither fold it nor hoist the gather; the while probe's state is
//     volatile shared memory, so `acc += 1` is a load, an add and a store
//     per iteration, as the TPU's VMEM round trip is;
//   * tables a TPU tile keeps in VMEM sit in shared memory when they fit
//     (one gather row of at most 64 KB, one [G, R, L] multi tile of 128-144
//     KB, with the kernel opted in past 48 KB); larger ones stay in global
//     memory (the [512, 128] sublane table, P5's 13 planes, the 3-slot
//     multi rings);
//   * dynamic slices clamp their start into range, as the reference's
//     interpret mode does (lax.dynamic_slice / dynamic_update_slice).

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_CAP = 232448;  // shared memory one block may use

inline cudaError_t opt_in(const void* fn, int bytes) {
  if (bytes > SMEM_CAP) return cudaErrorInvalidValue;
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// ---------------------------------------------------------------- gathers
// P1a bench_gather, P1b bench_gather_ax0, P2 microbench_mosaic2.bench,
// P3 microbench_pallas2.try_case, P4a the mosaic3 [WR, 128] chain, P6a
// gather3, P6b gather_flat.  out = take_along_axis(tab, idx, AXIS) of 2-D
// arrays, iterated `iters` times: chain=0 re-gathers at idx + (v & zero)
// (the fake dependence), chain=1 at floor_mod(v, lim) (the real one).
// AXIS 1: a block holds `per` whole table rows in shared memory; AXIS 0: a
// strip of `per` columns of every row.  Each thread runs 4 chains at once.
// A loop of one gather takes gather_once_kernel instead.
constexpr int GATHER_THREADS = 256;

template <int AXIS>
__global__ void __launch_bounds__(GATHER_THREADS)
    gather_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                  int* __restrict__ out, int Rt, int Mt, int Ri, int Mi,
                  int per, int iters, int chain, int lim, int zero) {
  extern __shared__ int s_tab[];
  const int tid = threadIdx.x;
  int n;  // elements of idx this block owns
  if (AXIS == 1) {
    const int r0 = blockIdx.x * per;
    const int rows = min(per, Rt - r0);
    for (int k = tid; k < rows * Mt; k += blockDim.x)
      s_tab[k] = tab[(long long)r0 * Mt + k];
    n = min(per, Ri - r0) * Mi;
  } else {
    const int c0 = blockIdx.x * per;
    const int cols = min(per, Mt - c0);
    for (int k = tid; k < Rt * per; k += blockDim.x) {
      const int r = k / per, cc = k % per;
      if (cc < cols) s_tab[k] = tab[(long long)r * Mt + c0 + cc];
    }
    n = Ri * per;
  }
  __syncthreads();
  const int stride = AXIS == 1 ? 1 : per;
  for (int base = tid; base < n; base += 4 * blockDim.x) {
    int cur[4], i0[4], off[4], v[4];
    long long at[4];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = base + u * blockDim.x;
      ok[u] = e < n;
      v[u] = 0;
      if (AXIS == 1) {
        const int r = e / Mi, c = e % Mi;
        off[u] = r * Mt;
        at[u] = ((long long)blockIdx.x * per + r) * Mi + c;
      } else {
        const int r = e / per, cc = e % per;
        const int c = blockIdx.x * per + cc;
        ok[u] = ok[u] && c < Mi;
        off[u] = cc;
        at[u] = (long long)r * Mi + c;
      }
      // clamped into the table once, outside the loop: a memory-safety
      // guard the plain version's torch.gather has as a raise
      i0[u] = ok[u] ? clampi(idx[at[u]], 0, (AXIS == 1 ? Mt : Rt) - 1) : 0;
      cur[u] = i0[u];
    }
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!ok[u]) continue;
        v[u] = s_tab[off[u] + cur[u] * stride];
        cur[u] = chain ? floor_mod(v[u], lim) : i0[u] + (v[u] & zero);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (ok[u]) out[at[u]] = chain ? cur[u] : v[u];
  }
}

// One gather (iters == 1: P3, P6a, P6b, and any cut loop): nothing to
// reuse, so no shared-memory staging; one thread per output element over
// as many blocks as it takes, the table read through L1/L2.
template <int AXIS>
__global__ void gather_once_kernel(const int* __restrict__ tab,
                                   const int* __restrict__ idx,
                                   int* __restrict__ out, int Rt, int Mt,
                                   int Ri, int Mi, int chain, int lim) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)Ri * Mi) return;
  const int r = (int)(e / Mi), c = (int)(e % Mi);
  const int i = clampi(idx[e], 0, (AXIS == 1 ? Mt : Rt) - 1);
  const int v = __ldg(tab + (AXIS == 1 ? (long long)r * Mt + i
                                       : (long long)i * Mt + c));
  out[e] = chain ? floor_mod(v, lim) : v;
}

// ------------------------------------------------------- ALU chains (P1c/d)
// P1c bench_varshift: acc = (acc >> s) | 1 on uint32 (logical; counts past
// 31 give 0, as XLA's shift does).  P1d bench_popcount: acc = popc(acc) + 7.
__global__ void varshift_kernel(const int* __restrict__ x,
                                const int* __restrict__ s,
                                int* __restrict__ out, int n, int iters) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    unsigned acc = (unsigned)x[e];
    const unsigned sh = (unsigned)s[e];
    for (int k = 0; k < iters; ++k) acc = (sh < 32u ? acc >> sh : 0u) | 1u;
    out[e] = (int)acc;
  }
}

__global__ void popcount_kernel(const int* __restrict__ x,
                                int* __restrict__ out, int n, int iters) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    int acc = x[e];
    for (int k = 0; k < iters; ++k) acc = __popc((unsigned)acc) + 7;
    out[e] = acc;
  }
}

// ------------------------------------------------------ row write (P1e)
// bench_hbm_row_write: iteration t writes uint8(x + t) into row t % S of
// out [S, W].  One block; each thread packs 4 bytes into one 32-bit plain
// store; __threadfence() and a block barrier per row make the row visible
// device-wide before the next starts (the TPU's DMA start + wait; K1 writes
// its tb rows with plain stores the same way).
__global__ void row_write_kernel(const int* __restrict__ x,
                                 unsigned* __restrict__ out, int S, int W,
                                 int iters) {
  const int words = W / 4;
  for (int t = 0; t < iters; ++t) {
    unsigned* row = out + (long long)(t % S) * words;
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      unsigned word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= (unsigned)((x[4 * w + j] + t) & 0xFF) << (8 * j);
      row[w] = word;
    }
    __threadfence();
    __syncthreads();
  }
}

// ------------------------------------------------------ while loop (P1f)
// bench_while_scalar: state [8, M] in (volatile) shared memory, `iters`
// rounds of acc += 1; SYNC adds a block barrier per round (K1 pays one per
// phase of its cycle), so the two instantiations price that barrier.
template <bool SYNC>
__global__ void __launch_bounds__(512)
    while_kernel(const int* __restrict__ x, int* __restrict__ out, int n,
                 int iters) {
  extern __shared__ int st_raw[];
  volatile int* st = st_raw;
  for (int e = threadIdx.x; e < n; e += blockDim.x) st[e] = x[e];
  __syncthreads();
  for (int c = 0; c < iters; ++c) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) st[e] = st[e] + 1;
    if (SYNC) __syncthreads();
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) out[e] = st[e];
}

// ----------------------------------------------------- mosaic3 (P4b-e)
// P4b dynamic roll: acc = roll(acc, acc[0, 0] & 0xFF, axis 1) + 1, with
// out[i] = acc[(i - sh) mod M] (pltpu.roll's direction in the reference's
// interpret mode, the shift taken mod M).  Double buffer in shared memory,
// a block barrier per iteration: every element depends on acc[0, 0].
__global__ void roll_kernel(const int* __restrict__ x, int* __restrict__ out,
                            int R, int M, int iters) {
  extern __shared__ int buf[];
  const int n = R * M;
  int* a = buf;
  int* b = buf + n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) a[e] = x[e];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const int sh = (a[0] & 0xFF) % M;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / M, i = e % M;
      int src = i - sh;
      if (src < 0) src += M;
      b[e] = a[r * M + src] + 1;
    }
    __syncthreads();
    int* t = a;
    a = b;
    b = t;
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x) out[e] = a[e];
}

// P4c dynamic lane slice: acc[128] += tab[s[n] : s[n] + 128] from a [1, NW]
// table in shared memory (one thread per lane).
__global__ void lane_slice_kernel(const int* __restrict__ tab, int NW,
                                  const int* __restrict__ starts,
                                  int* __restrict__ out, int iters) {
  extern __shared__ int s_row[];
  for (int k = threadIdx.x; k < NW; k += blockDim.x) s_row[k] = tab[k];
  __syncthreads();
  const int lane = threadIdx.x;
  int acc = 0;
  for (int it = 0; it < iters; ++it) {
    const int b = clampi(__ldg(starts + it), 0, NW - 128);
    acc += s_row[b + lane];
  }
  out[lane] = acc;
}

// P4d dynamic sublane slice: acc[2, 128] += tab[r[n] : r[n] + 2, :] from a
// [NR, 128] table (256 KB at the tool's NR: past shared memory, so read
// through L1/L2); one thread per element of the [2, 128] accumulator.
__global__ void sublane_slice_kernel(const int* __restrict__ tab, int NR,
                                     const int* __restrict__ rows,
                                     int* __restrict__ out, int iters) {
  const int j = threadIdx.x / 128, lane = threadIdx.x % 128;
  int acc = 0;
  for (int it = 0; it < iters; ++it) {
    const int r = clampi(__ldg(rows + it), 0, NR - 2);
    acc += __ldg(tab + (r + j) * 128 + lane);
  }
  out[j * 128 + lane] = acc;
}

// P4e refill through SMEM scalars: the per-row bases go to shared memory
// (the TPU's SMEM scratch), then row r of out is tab[b[r] : b[r] + 128].
__global__ void refill_kernel(const int* __restrict__ tab, int NW,
                              const int* __restrict__ bases,
                              int* __restrict__ out, int WR) {
  extern __shared__ int s_base[];
  for (int r = threadIdx.x; r < WR; r += blockDim.x) s_base[r] = bases[r];
  __syncthreads();
  const int lane = threadIdx.x;
  for (int r = 0; r < WR; ++r) {
    const int b = clampi(s_base[r], 0, NW - 128);
    out[r * 128 + lane] = __ldg(tab + b + lane);
  }
}

// ------------------------------------------------------- chunk sweep (P5)
// microbench_chunk.build: T cycles of K1's sweep skeleton on 13 planes of
// [WR + 8, 128] int32 in global memory (rA..rG read, tA..tE and vb
// written), K1's 512-thread block.  Full sweep: one chunk of WR rows;
// chunked: ceil(NR / CR) + (t & 1) chunks of CR rows.  Per row: 7 plane
// loads, the transition-sized ALU block, 5 stores, the vb shift; 4
// consecutive rows' bits are packed into one int32 (row 4k + j in byte j)
// and stored to tb [64, WR / 4, 128] at row t % 64.  Each thread owns a
// (4-row, lane) quad, so the packing needs no exchange.  Slice starts are
// clamped into their buffers (the reference overruns them at its own
// settings; its interpret mode clamps).  A block max-reduction per chunk
// (two barriers) gives acc; the output is the last cycle's.
constexpr int CHUNK_THREADS = 512;
constexpr int N_PLANES = 13;

__device__ __forceinline__ int block_max(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, nw = blockDim.x / 32;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < nw; ++w) r = max(r, red[w]);
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(CHUNK_THREADS)
    chunk_kernel(int* __restrict__ acc_out, int* __restrict__ tb,
                 int* __restrict__ planes, int WR, int CR, int T, int NR,
                 int chunked) {
  __shared__ int red[CHUNK_THREADS / 32];
  const int WRP = WR + 8, WR4 = WR / 4;
  const int plane = WRP * 128;
  for (int k = threadIdx.x; k < N_PLANES * plane; k += blockDim.x)
    planes[k] = k < 7 * plane ? 3 : 1;
  __syncthreads();
  const int cr = chunked ? CR : WR;
  // full sweep: loads from row 0 (r[:][:WR]); chunked: CR + 8 rows at ro
  const int ld_rows = chunked ? CR + 8 : WRP;
  int acc = 0;
  for (int t = 0; t < T; ++t) {
    const int nc = chunked ? (NR + CR - 1) / CR + (t & 1) : 1;
    int acc_t = 0;
    for (int ci = 0; ci < nc; ++ci) {
      const int ro = ci * cr;
      const int ld = clampi(ro, 0, WRP - ld_rows);
      const int st = clampi(ro, 0, WRP - cr);
      const int tbs = clampi(ro / 4, 0, WR4 - cr / 4);
      int hmax = INT_MIN;
      for (int q = threadIdx.x; q < (cr / 4) * 128; q += blockDim.x) {
        const int k = q / 128, l = q % 128;
        int packed = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ri = (ld + 4 * k + j) * 128 + l;
          const int so = (st + 4 * k + j) * 128 + l;
          const int a = planes[0 * plane + ri], b = planes[1 * plane + ri];
          const int c = planes[2 * plane + ri], d = planes[3 * plane + ri];
          const int e = planes[4 * plane + ri], f = planes[5 * plane + ri];
          const int g = planes[6 * plane + ri];
          const int e1 = max(a, b) + t;
          const int e2 = max(c, d) + 1;
          const int f1 = max(e, f) + 1;
          const int f2 = max(g, a) + 1;
          int z = e1 >= e2 ? 1 : 3;
          const int h = max(max(e1, e2), max(f1, f2));
          z = a + 1 >= h ? 0 : z;
          const int bits = ((e1 < e2 ? 1 : 0) << 3) | z;
          planes[7 * plane + so] = h;
          planes[8 * plane + so] = e1;
          planes[9 * plane + so] = f1;
          planes[10 * plane + so] = e2;
          planes[11 * plane + so] = f2;
          planes[12 * plane + so] = (planes[12 * plane + so] << 1) & 0xFFFF;
          packed |= bits << (8 * j);
          hmax = max(hmax, h);
        }
        tb[((long long)(t % 64) * WR4 + tbs + k) * 128 + l] = packed;
      }
      acc_t += block_max(hmax, red);
    }
    acc = acc_t;
  }
  if (threadIdx.x == 0) acc_out[0] = acc;
}

// ----------------------------------------------------- multi probes (P6-P8)
// K4's lowering questions on x [G, R, L]: one 512-thread block of G groups
// of 512 / G threads, group g owning lane g with its own named barrier
// (bar.sync 1 + g), as K4 does.  The group's x tile sits in dynamic shared
// memory (RX rows: R, or R + 8 for the ring probes' padded input); the
// 3-slot rings [3, G, R + 8, L] are global memory.
enum MultiProbe {
  LANE_MASK,    // P6c lane_mask
  SHIFT3,       // P6d shift3
  RING4,        // P6e ring4, P7d multi2 f_d
  BND,          // P6f bnd
  SUB,          // P6g sub
  MIN_MASK,     // P7a multi2 f_a, P7c multi2 f_c
  MAX_OUT,      // P7b multi2 f_b
  RING_WRITE,   // P7e multi2 f_e
  ANY_MASK,     // P7f multi2 f_f
  MAX_MIN,      // P8a multi3 f_a
  STACK,        // P8b multi3 f_b
  WHILE_G11,    // P8c multi3 f_c
  ADD_SCALAR,   // P8d multi3 f_d
  REGISTRY,     // P8e multi3 f_e
  N_MULTI
};

constexpr int MULTI_THREADS = 512;
constexpr int SR = 8;  // multi3's sub-window rows

struct MultiParams {
  const int* x;    // [G, RX, L]
  const int* aux;  // BND: [8, L] bound plane; ADD_SCALAR: [G] scalars
  int* out;        // [G, R, L]
  int* s_out;      // LANE_MASK, MAX_OUT: [G]; MAX_MIN: [G + 1]
  int* ring;       // RING4, RING_WRITE: [3, G, R + 8, L]
  int G, R, L, RX;
};

__device__ __forceinline__ void group_sync(int g, int tpg) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(tpg) : "memory");
}

struct MinOp {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct MaxOp {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};
struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Reduce v over the group's threads; every thread of the group gets it.
template <class Op>
__device__ int group_reduce(int v, Op op, int* red, int g, int lt, int tpg) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((lt & 31) == 0) red[g * 16 + lt / 32] = v;
  group_sync(g, tpg);
  int r = red[g * 16];
  for (int w = 1; w < tpg / 32; ++w) r = op(r, red[g * 16 + w]);
  group_sync(g, tpg);  // red is reused by the next reduction
  return r;
}

template <int P>
__global__ void __launch_bounds__(MULTI_THREADS) multi_kernel(MultiParams p) {
  extern __shared__ int sm[];
  const int G = p.G, R = p.R, L = p.L, RX = p.RX;
  const int tpg = MULTI_THREADS / G;
  const int g = threadIdx.x / tpg, lt = threadIdx.x % tpg;
  int* xs = sm;                           // [G, RX, L]
  int* red = xs + G * RX * L;             // [8, 16] warp partials
  int* lane_val = red + 8 * 16;           // [8] one value per lane
  int* reg = lane_val + 8;                // REGISTRY: [3, 8, L]
  const int* xg = xs + g * RX * L;
  int* og = p.out + (long long)g * R * L;
  const int n = R * L;
  for (int e = lt; e < RX * L; e += tpg) xs[g * RX * L + e] = p.x[g * RX * L + e];
  group_sync(g, tpg);

  if (P == LANE_MASK || P == MIN_MASK || P == STACK || P == REGISTRY) {
    int lo = INT_MAX;
    for (int e = lt; e < n; e += tpg) lo = min(lo, xg[e]);
    lo = group_reduce(lo, MinOp(), red, g, lt, tpg);
    if (P == LANE_MASK || P == MIN_MASK) {
      int m = -(1 << 30);
      for (int e = lt; e < n; e += tpg) {
        const int v = xg[e];
        const bool keep = v >= lo + 5;
        og[e] = keep ? v : -1;
        m = max(m, keep ? v : -(1 << 30));
      }
      if (P == LANE_MASK) {
        m = group_reduce(m, MaxOp(), red, g, lt, tpg);
        if (lt == 0) p.s_out[g] = m;
      }
    } else if (P == STACK) {
      const int a = clampi(floor_mod(lo, R - SR), 0, R - SR);
      for (int e = lt; e < n; e += tpg) {
        const int r = e / L;
        og[e] = (r >= a && r < a + SR) ? xg[e] * 2 : xg[e];
      }
    } else {  // REGISTRY
      for (int j = 0; j < 5; ++j) {
        int* slot = reg + (j % 3) * 8 * L;
        for (int l = lt; l < L; l += tpg) {
          slot[g * L + l] = lo + j;
          if (g == 0)
            for (int r = G; r < 8; ++r) slot[r * L + l] = j;
        }
      }
      group_sync(g, tpg);
      const int got = reg[1 * 8 * L + g * L];
      for (int e = lt; e < n; e += tpg) og[e] = xg[e] + got;
    }
  } else if (P == MAX_OUT || P == MAX_MIN) {
    int m = INT_MIN;
    for (int e = lt; e < n; e += tpg) {
      m = max(m, xg[e]);
      og[e] = xg[e];
    }
    m = group_reduce(m, MaxOp(), red, g, lt, tpg);
    if (lt == 0) {
      p.s_out[g] = m;
      lane_val[g] = m;
    }
    if (P == MAX_MIN) {
      __syncthreads();
      if (threadIdx.x == 0) {
        int lo = lane_val[0];
        for (int k = 1; k < G; ++k) lo = min(lo, lane_val[k]);
        p.s_out[G] = lo;
      }
    }
  } else if (P == ANY_MASK) {
    int any = 0;
    for (int e = lt; e < n; e += tpg) any = max(any, xg[e] > 50 ? 1 : 0);
    any = group_reduce(any, MaxOp(), red, g, lt, tpg);
    for (int e = lt; e < n; e += tpg) og[e] = any > 0 ? xg[e] : 0;
  } else if (P == SHIFT3) {
    for (int e = lt; e < n; e += tpg) {
      const int r = e / L, l = e % L;
      og[e] = l > 0 ? xg[e - 1] : (r > 0 ? xg[(r - 1) * L + L - 1] : -9);
    }
  } else if (P == RING4 || P == RING_WRITE) {
    // RING4 writes the whole padded tile into slot j % 3; RING_WRITE rows
    // 0..R-1 of it at rows 8..8+R of the slot.  Both read slot 1's rows
    // 8..8+R after the fifth write.
    const long long slot_sz = (long long)G * RX * L;
    int* lane_ring = p.ring + (long long)g * RX * L;
    for (int j = 0; j < 5; ++j) {
      int* dst = lane_ring + (j % 3) * slot_sz;
      if (P == RING4) {
        for (int e = lt; e < RX * L; e += tpg) dst[e] = xg[e] + j;
      } else {
        for (int e = lt; e < n; e += tpg) dst[8 * L + e] = xg[e] + j;
      }
    }
    group_sync(g, tpg);
    for (int e = lt; e < n; e += tpg) og[e] = lane_ring[slot_sz + 8 * L + e];
  } else if (P == BND) {
    const int bl = p.aux[g * L];
    for (int e = lt; e < n; e += tpg) og[e] = xg[e] >= bl ? xg[e] : -3;
  } else if (P == SUB) {
    for (int e = lt; e < n; e += tpg) {
      const int r = e / L, l = e % L;
      og[e] = r < 8 ? xg[(16 + r) * L + l] * 2 : xg[e];
    }
  } else if (P == ADD_SCALAR) {
    const int s = p.aux[g];
    for (int e = lt; e < n; e += tpg) og[e] = xg[e] + s;
  } else if (P == WHILE_G11) {
    // while t < 16 and not every lane done: the condition spans the lanes,
    // so it takes two block barriers per round.
    int t = 0, done = 0, acc = 0;
    while (true) {
      if (lt == 0) lane_val[g] = done;
      __syncthreads();
      int all = lane_val[0];
      for (int k = 1; k < G; ++k) all = min(all, lane_val[k]);
      __syncthreads();
      if (!(t < 16 && all == 0)) break;
      int cnt = 0;
      for (int e = lt; e < n; e += tpg) cnt += floor_mod(xg[e] + t, 7) == 0;
      acc += group_reduce(cnt, SumOp(), red, g, lt, tpg);
      done = acc > 300 ? 1 : done;
      ++t;
    }
    for (int e = lt; e < n; e += tpg) og[e] = acc;
  }
}

template <int P>
int launch_multi(const MultiParams& p, int smem, cudaStream_t stream) {
  cudaError_t err = opt_in((const void*)multi_kernel<P>, smem);
  if (err != cudaSuccess) return (int)err;
  multi_kernel<P><<<1, MULTI_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_multi(int probe, const MultiParams& p, int smem,
                   cudaStream_t stream) {
  if constexpr (P < N_MULTI) {
    if (probe == P) return launch_multi<P>(p, smem, stream);
    return dispatch_multi<P + 1>(probe, p, smem, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ----------------------------------------------------------- entry points
// Each launches on `stream` and returns cudaGetLastError(); shapes the
// kernel does not take return cudaErrorInvalidValue before any launch.

extern "C" int mwf_probe_gather(const int* tab, int Rt, int Mt,
                                const int* idx, int Ri, int Mi, int* out,
                                int axis, int iters, int chain, int lim,
                                int zero, void* stream) {
  if (Rt < 1 || Mt < 1 || Ri < 1 || Mi < 1 || iters < 1 || lim < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis != 0 && axis != 1) return (int)cudaErrorInvalidValue;
  if ((axis == 1 && Ri != Rt) || (axis == 0 && Mi != Mt))
    return (int)cudaErrorInvalidValue;
  if (iters == 1) {
    const long long n = (long long)Ri * Mi;
    const int blocks = (int)((n + GATHER_THREADS - 1) / GATHER_THREADS);
    if (axis == 1)
      gather_once_kernel<1><<<blocks, GATHER_THREADS, 0, s>>>(
          tab, idx, out, Rt, Mt, Ri, Mi, chain, lim);
    else
      gather_once_kernel<0><<<blocks, GATHER_THREADS, 0, s>>>(
          tab, idx, out, Rt, Mt, Ri, Mi, chain, lim);
    return (int)cudaGetLastError();
  }
  if (axis == 1) {
    const int per = max(1, min(Rt, 8192 / Mt));
    const int smem = per * Mt * (int)sizeof(int);
    cudaError_t err = opt_in((const void*)gather_kernel<1>, smem);
    if (err != cudaSuccess) return (int)err;
    gather_kernel<1><<<(Rt + per - 1) / per, GATHER_THREADS, smem, s>>>(
        tab, idx, out, Rt, Mt, Ri, Mi, per, iters, chain, lim, zero);
  } else {
    const int per = max(1, min(Mt, min(128, 8192 / Rt)));
    const int smem = Rt * per * (int)sizeof(int);
    cudaError_t err = opt_in((const void*)gather_kernel<0>, smem);
    if (err != cudaSuccess) return (int)err;
    gather_kernel<0><<<(Mt + per - 1) / per, GATHER_THREADS, smem, s>>>(
        tab, idx, out, Rt, Mt, Ri, Mi, per, iters, chain, lim, zero);
  }
  return (int)cudaGetLastError();
}

extern "C" int mwf_probe_varshift(const int* x, const int* sh, int* out,
                                  int n, int iters, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  varshift_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      x, sh, out, n, iters);
  return (int)cudaGetLastError();
}

extern "C" int mwf_probe_popcount(const int* x, int* out, int n, int iters,
                                  void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  popcount_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      x, out, n, iters);
  return (int)cudaGetLastError();
}

extern "C" int mwf_probe_row_write(const int* x, unsigned char* out, int S,
                                   int W, int iters, void* stream) {
  if (S < 1 || W < 4 || W % 4) return (int)cudaErrorInvalidValue;
  row_write_kernel<<<1, 512, 0, (cudaStream_t)stream>>>(
      x, (unsigned*)out, S, W, iters);
  return (int)cudaGetLastError();
}

extern "C" int mwf_probe_while(const int* x, int* out, int n, int iters,
                               int sync, void* stream) {
  const int smem = n * (int)sizeof(int);
  const void* fn = sync ? (const void*)while_kernel<true>
                        : (const void*)while_kernel<false>;
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in(fn, smem);
  if (err != cudaSuccess) return (int)err;
  if (sync)
    while_kernel<true><<<1, 512, smem, (cudaStream_t)stream>>>(x, out, n, iters);
  else
    while_kernel<false><<<1, 512, smem, (cudaStream_t)stream>>>(x, out, n, iters);
  return (int)cudaGetLastError();
}

extern "C" int mwf_probe_roll(const int* x, int* out, int R, int M,
                              int iters, void* stream) {
  const int smem = 2 * R * M * (int)sizeof(int);
  if (R < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in((const void*)roll_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  roll_kernel<<<1, 256, smem, (cudaStream_t)stream>>>(x, out, R, M, iters);
  return (int)cudaGetLastError();
}

extern "C" int mwf_probe_lane_slice(const int* tab, int NW, const int* starts,
                                    int* out, int iters, void* stream) {
  const int smem = NW * (int)sizeof(int);
  if (NW < 128) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in((const void*)lane_slice_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lane_slice_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(tab, NW, starts,
                                                            out, iters);
  return (int)cudaGetLastError();
}

extern "C" int mwf_probe_sublane_slice(const int* tab, int NR,
                                       const int* rows, int* out, int iters,
                                       void* stream) {
  if (NR < 2) return (int)cudaErrorInvalidValue;
  sublane_slice_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(tab, NR, rows,
                                                            out, iters);
  return (int)cudaGetLastError();
}

extern "C" int mwf_probe_refill(const int* tab, int NW, const int* bases,
                                int* out, int WR, void* stream) {
  if (NW < 128 || WR < 1) return (int)cudaErrorInvalidValue;
  const int smem = WR * (int)sizeof(int);
  cudaError_t err = opt_in((const void*)refill_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  refill_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(tab, NW, bases, out,
                                                        WR);
  return (int)cudaGetLastError();
}

extern "C" int mwf_probe_chunk(int* acc, int* tb, int* planes, int WR, int CR,
                               int T, int NR, int chunked, void* stream) {
  if (WR < 4 || WR % 4 || T < 1 ||
      (chunked && (CR < 4 || CR % 4 || CR > WR || NR < 1)))
    return (int)cudaErrorInvalidValue;
  chunk_kernel<<<1, CHUNK_THREADS, 0, (cudaStream_t)stream>>>(
      acc, tb, planes, WR, CR, T, NR, chunked);
  return (int)cudaGetLastError();
}

extern "C" int mwf_probe_multi(int probe, const int* x, const int* aux,
                               int* out, int* s_out, int* ring, int G, int R,
                               int L, int RX, void* stream) {
  if (G < 1 || G > 8 || MULTI_THREADS % (32 * G) || R < 1 || L < 1 ||
      RX < R)
    return (int)cudaErrorInvalidValue;
  if ((probe == SUB && R < 24) || (probe == STACK && R <= SR) ||
      ((probe == RING4 || probe == RING_WRITE) && RX != R + 8))
    return (int)cudaErrorInvalidValue;
  MultiParams p{x, aux, out, s_out, ring, G, R, L, RX};
  const int smem =
      (G * RX * L + 8 * 16 + 8 + (probe == REGISTRY ? 3 * 8 * L : 0)) *
      (int)sizeof(int);
  return dispatch_multi<0>(probe, p, smem, (cudaStream_t)stream);
}
