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
//     read and written every round by volatile 16-byte shared-memory
//     accesses (inline PTX), so `acc += 1` is a load, an add and a store
//     per iteration, as the TPU's VMEM round trip is; the row write
//     builds and stores every iteration's row, rewritten ones included;
//   * tables a TPU tile keeps in VMEM sit in shared memory when they fit
//     (a gather loop's table rows or column strip, the multi probes' ring
//     slots and registry, with the kernel opted in past 48 KB once per
//     kernel, card and size); P5's 13 planes stay on chip across a
//     thread-block cluster, each CTA holding its lanes' rows; larger
//     tables stay in global memory (the [512, 128] sublane table);
//   * the loops that ran on one block use the whole card: a gather
//     loop's elements spread over >= 132 blocks where there are enough of
//     them, several chains a thread; P5's chunks side by side over the
//     cluster, one cluster barrier a round of chunks; the while loop's
//     state over 128 blocks of one warp (16 bytes a thread in each
//     block's shared memory); the row write's rows over 128 blocks, 16
//     bytes a thread a row by plain stores with no fence; the multi
//     probes' lanes over CTAs of their own, each holding its words in
//     registers, the lanes of a cross-lane probe in one cluster; the
//     dynamic slices' summed iterations over CTAs and warps, reduced once
//     inside the launch;
//   * a probe that is one dependent load deep (one gather, the refill)
//     keeps every element's chain in flight at once: an index or base
//     load, the table loads that depend on it, then the stores, spread
//     over the SMs; it is read against the dependent-load floor
//     (dep_floor_kernel), not the empty launch;
//   * dynamic slices clamp their start into range, as the reference's
//     interpret mode does (lax.dynamic_slice / dynamic_update_slice).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>

#include "bulk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_CAP = 232448;  // shared memory one block may use
constexpr int MAX_DEVICES = 64;

// Opt `fn` in to `bytes` of dynamic shared memory past 48 KB.  The call
// is made once per kernel, card and size: `cache` (one per kernel, a
// host-side flag per card) keeps the largest size set on each card, and a
// launch within it pays no cudaFuncSetAttribute.  Its error is returned.
inline cudaError_t opt_in(const void* fn, int bytes, int* cache) {
  if (bytes > SMEM_CAP) return cudaErrorInvalidValue;
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cache[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) cache[dev] = bytes;
  return err;
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
//
// A loop of gathers is latency-bound: each op is one shared-memory load
// and one or two ALU steps on a dependent chain.  So the work is spread
// over every SM, with as many chains in flight on each as the elements
// allow (the plan of ops/probes.py::gather_plan):
//   * a group is `per` whole table rows (AXIS 1) or a strip of `per`
//     columns of every row (AXIS 0), staged in shared memory;
//   * `splits` blocks share a group, each staging all of it and owning
//     one contiguous share, ceil(n / splits), of the group's n idx
//     elements (AXIS 1: row-major over the group's rows; AXIS 0:
//     row-major over the strip), so a [8, 16384] table runs on 256
//     blocks, not 8;
//   * each thread runs CH independent chains at once (CH = 1, 2, 4, 8).
// A loop of one gather takes gather_once_kernel instead.
constexpr int GATHER_THREADS = 256;

template <int AXIS, int CH>
__global__ void __launch_bounds__(GATHER_THREADS)
    gather_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                  int* __restrict__ out, int Rt, int Mt, int Ri, int Mi,
                  int per, int splits, int iters, int chain, int lim,
                  int zero) {
  extern __shared__ int s_tab[];
  const int tid = threadIdx.x;
  const int u0 = (blockIdx.x / splits) * per;  // the group's first row/col
  int n, w;  // the group's idx elements; the width they are laid out in
  if (AXIS == 1) {
    const int rows = min(per, Rt - u0);
    for (int k = tid; k < rows * Mt; k += GATHER_THREADS)
      s_tab[k] = tab[(long long)u0 * Mt + k];
    n = rows * Mi;
    w = Mi;
  } else {
    const int cols = min(per, Mt - u0);
    for (int k = tid; k < Rt * cols; k += GATHER_THREADS)
      s_tab[k] = tab[(long long)(k / cols) * Mt + u0 + k % cols];
    n = Ri * cols;
    w = cols;
  }
  const int share = (n + splits - 1) / splits;
  const int e0 = min(n, (blockIdx.x % splits) * share);
  const int e1 = min(n, e0 + share);
  const int hi = (AXIS == 1 ? Mt : Rt) - 1;
  const int stride = AXIS == 1 ? 1 : w;
  __syncthreads();
  for (int base = e0 + tid; base < e1; base += CH * GATHER_THREADS) {
    int cur[CH], i0[CH], off[CH], v[CH];
    long long at[CH];
    bool ok[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int e = base + u * GATHER_THREADS;
      ok[u] = e < e1;
      // a chain past the share runs on element e0 and stores nothing
      const int r = (ok[u] ? e : e0) / w, c = (ok[u] ? e : e0) % w;
      off[u] = AXIS == 1 ? r * Mt : c;
      at[u] = AXIS == 1 ? (long long)(u0 + r) * Mi + c
                        : (long long)r * Mi + u0 + c;
      // clamped into the table once, outside the loop: a memory-safety
      // guard the plain version's torch.gather has as a raise
      i0[u] = clampi(idx[at[u]], 0, hi);
      cur[u] = i0[u];
      v[u] = 0;
    }
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        v[u] = s_tab[off[u] + cur[u] * stride];
        cur[u] = chain ? floor_mod(v[u], lim) : i0[u] + (v[u] & zero);
      }
    }
#pragma unroll
    for (int u = 0; u < CH; ++u)
      if (ok[u]) out[at[u]] = chain ? cur[u] : v[u];
  }
}

// One gather (P3, P6a, P6b, and P2's or P4a's loop cut to one iteration):
// nothing to reuse, so no shared-memory staging; the table is read through
// L1/L2.  Each output costs an index load, a table load that depends on
// it and a store, so the launch is one dependent-load chain deep and the
// design keeps every element's chain in flight at once:
//   * a thread owns a unit of 4 consecutive outputs of a row (VEC: Mi % 4
//     == 0, idx and out 16-byte aligned): one 16-byte index load, its 4
//     table loads issued together, one 16-byte store; else one output;
//   * the units spread over the CTAs of ops/probes.py::once_plan (ctas,
//     threads), a grid-stride loop past ctas * threads units;
//   * the row and column of a unit by one 32-bit division (the index
//     load does not wait for it); idx holds fewer than 2^31 elements, as
//     the entry point checks.
template <int AXIS, bool VEC>
__global__ void gather_once_kernel(const int* __restrict__ tab,
                                   const int* __restrict__ idx,
                                   int* __restrict__ out, int Rt, int Mt,
                                   unsigned Mi, unsigned units, int chain,
                                   int lim) {
  constexpr int V = VEC ? 4 : 1;
  const int hi = (AXIS == 1 ? Mt : Rt) - 1;
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned u = blockIdx.x * blockDim.x + threadIdx.x; u < units;
       u += step) {
    int i[V], v[V];
    if constexpr (VEC) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(idx) + u);
      i[0] = q.x, i[1] = q.y, i[2] = q.z, i[3] = q.w;
    } else {
      i[0] = __ldg(idx + u);
    }
    const unsigned e = V * u, r = e / Mi, c = e - r * Mi;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = clampi(i[k], 0, hi);
      v[k] = __ldg(tab + (AXIS == 1 ? (long long)r * Mt + j
                                    : (long long)j * Mt + c + k));
    }
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = chain ? floor_mod(v[k], lim) : v[k];
    if constexpr (VEC)
      reinterpret_cast<int4*>(out)[u] = make_int4(v[0], v[1], v[2], v[3]);
    else
      out[u] = v[0];
  }
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
// out [S, W].  The rows are spread over every SM (the plan of
// ops/probes.py::row_write_plan), with every iteration's row written:
//   * a row is cut into segments of 16 bytes a thread; block b owns one
//     segment (b % segs) of the rows r with r % rb == b / segs, and runs
//     their iterations t = r, r + S, r + 2S, ... in increasing t, every
//     one of them (a row that a later t overwrites included);
//   * a thread packs the 16 bytes of x under its part of the segment into
//     registers once (x is the input, loop-invariant) and adds t to each
//     byte per iteration (__vadd4), then stores them with one coalesced
//     16-byte plain store (four 32-bit ones where the row is not 16-byte
//     aligned, W % 16 != 0);
//   * no fence and no barrier: a byte of a row is always written by the
//     same thread, so two writes to it land in program order, and nothing
//     else waits on a row.  The TPU's DMA start and wait per row thus
//     become stores that the card keeps in flight by the thousand.
// Why not the copy engine: a cp.async.bulk of each row from a ring of
// shared-memory segments ran 3.4x slower on an H100 (PERF.md section 6),
// since bulk copies are unordered among themselves and each had to
// complete before its row was rewritten, behind a block barrier a row.
__global__ void __launch_bounds__(1024)
    row_write_kernel(const int* __restrict__ x, unsigned char* __restrict__ out,
                     int S, int W, int iters, int rb) {
  const int segs = gridDim.x / rb;
  const int cls = blockIdx.x / segs;
  const int c0 = (blockIdx.x % segs) * 16 * blockDim.x;
  const int len = min(16 * (int)blockDim.x, W - c0);  // a row's bytes here
  const int q = 16 * threadIdx.x;  // this thread's first byte of them
  unsigned xw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    xw[j] = 0;
    if (q + 4 * j < len)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        xw[j] |= (unsigned)(x[c0 + q + 4 * j + b] & 0xFF) << (8 * b);
  }
  if (q >= len) return;
  for (long long base = 0; base < iters; base += S) {
    for (int r = cls; r < S && base + r < iters; r += rb) {
      const unsigned tt = (unsigned)((base + r) & 0xFF) * 0x01010101u;
      unsigned char* p = out + (long long)r * W + c0 + q;
      unsigned v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __vadd4(xw[j], tt);
      if (((unsigned long long)p & 15) == 0 && q + 16 <= len) {
        *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (q + 4 * j < len) *reinterpret_cast<unsigned*>(p + 4 * j) = v[j];
      }
    }
  }
}

// ------------------------------------------------------ while loop (P1f)
// bench_while_scalar: `iters` rounds of acc += 1 on the state [8, M], kept
// on chip as the TPU keeps it in VMEM scratch.  The state is spread over
// every SM (the plan of ops/probes.py::while_plan): each block holds a
// contiguous slice in its own shared memory, WHILE_PER (4) elements a
// thread, the last thread's and block's padded.  Every round each thread
// loads its 16 bytes of state, adds 1 to each element and stores them
// back, by ld/st.volatile.shared.v4 that nvcc can neither fold nor hoist:
// one dependent shared-memory round trip a round.  SYNC adds a block
// barrier a round among the threads that share the block's state (K1 pays
// one per phase), so the two instantiations price that barrier at the
// plan's block size.
constexpr int WHILE_PER = 4;

template <bool SYNC>
__global__ void __launch_bounds__(1024)
    while_kernel(const int* __restrict__ x, int* __restrict__ out, int n,
                 int iters) {
  extern __shared__ int4 st[];
  const long long e0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * WHILE_PER;
  int v[WHILE_PER];
#pragma unroll
  for (int j = 0; j < WHILE_PER; ++j) v[j] = e0 + j < n ? x[e0 + j] : 0;
  const unsigned a = mwf::smem_u32(st + threadIdx.x);
  asm volatile("st.volatile.shared.v4.s32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
  for (int c = 0; c < iters; ++c) {
    asm volatile("ld.volatile.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(a)
                 : "memory");
    asm volatile("st.volatile.shared.v4.s32 [%0], {%1, %2, %3, %4};" ::"r"(a),
                 "r"(v[0] + 1), "r"(v[1] + 1), "r"(v[2] + 1), "r"(v[3] + 1)
                 : "memory");
    if (SYNC) __syncthreads();
  }
  asm volatile("ld.volatile.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(a)
               : "memory");
#pragma unroll
  for (int j = 0; j < WHILE_PER; ++j)
    if (e0 + j < n) out[e0 + j] = v[j];
}

// ----------------------------------------------------- mosaic3 (P4b-e)
// P4b dynamic roll: acc = roll(acc, acc[0, 0] & 0xFF, axis 1) + 1, with
// out[i] = acc[(i - sh) mod M] (pltpu.roll's direction in the reference's
// interpret mode, the shift taken mod M).  One CTA: every element of a
// round depends on acc[0, 0] of the round before, so a grid or cluster
// barrier a round (~1 us) would cost more than the round.  Inside it, on
// the plan (threads, PER) of ops/probes.py::roll_plan:
//   * thread t owns elements e = t + k * threads (k < PER), so a warp's
//     loads and stores hit 32 consecutive words, conflict-free (a thread
//     owning 4 consecutive destinations would store them by one v4 store,
//     but its 4 loads would then fall 4-way on the same banks: shared
//     memory's 128 bytes a clock bound a round, 16 KB at [8, 256]);
//   * SAME_COL (threads a multiple of M, the plan's choice wherever M <=
//     1024): a thread's elements share one column, computed once before
//     the loop, so a round reads the shift once (a broadcast of acc[0, 0]),
//     reduces it mod M by a multiply-high (no division: sh < 256), turns
//     it into one source offset d = sh - (col < sh ? M : 0), and each
//     element is a shared load at e - d, an add and a store; otherwise
//     (M > 1024) each element's column steps on from the one before by
//     threads mod M, a compare and subtract, no division;
//   * a thread issues its loads of a round, up to ROLL_CHUNK (8) at a
//     time, before their first store (nvcc cannot tell the two halves of
//     the buffer apart, and would otherwise keep each load behind the
//     store before it: ~100 clocks an element at 8 a thread); the plan's
//     4 a thread at 512 threads measured fastest on an H100 (PERF.md);
//   * double buffer (offsets into one shared array, so every access is a
//     shared-memory one), one barrier a round.  Every round rolls the whole
//     tile: the loop is not folded into a shift sum and one gather.
constexpr int ROLL_CHUNK = 8;  // loads a thread issues before its stores

template <int PER, bool SAME_COL>
__global__ void __launch_bounds__(1024)
    roll_kernel(const int* __restrict__ x, int* __restrict__ out, int R,
                int M, int iters) {
  extern __shared__ int buf[];
  const int n = R * M, T = blockDim.x, tid = threadIdx.x;
  const int col0 = tid % M, step = T % M;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (tid + k * T < n) buf[tid + k * T] = x[tid + k * T];
  // ceil(2^32 / M): __umulhi(v, magic) is v / M for v < 256 and M < 2^24
  const unsigned magic = M > 1 ? (unsigned)(0xFFFFFFFFull / M + 1) : 0u;
  int src = 0;  // the round's source half of buf (0 or n)
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const unsigned v = (unsigned)buf[src] & 0xFFu;
    const int sh = M > 1 ? (int)(v - __umulhi(v, magic) * (unsigned)M) : 0;
    const int* a = buf + src;
    int* b = buf + (n - src);
    const int d = sh - (col0 < sh ? M : 0);  // SAME_COL's source offset
    int col = col0;
#pragma unroll
    for (int k0 = 0; k0 < PER; k0 += ROLL_CHUNK) {
      constexpr int CH = PER < ROLL_CHUNK ? PER : ROLL_CHUNK;
      int got[CH];  // a chunk's loads, all before its first store
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int e = tid + (k0 + k) * T;
        if (SAME_COL) {
          if (e < n) got[k] = a[e - d];
        } else {
          if (e < n) got[k] = a[e - sh + (col < sh ? M : 0)];
          col += step;
          if (col >= M) col -= M;
        }
      }
#pragma unroll
      for (int k = 0; k < CH; ++k)
        if (tid + (k0 + k) * T < n) b[tid + (k0 + k) * T] = got[k] + 1;
    }
    __syncthreads();
    src = n - src;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (tid + k * T < n) out[tid + k * T] = buf[src + tid + k * T];
}

// ---------------------------------------------- dynamic slices (P4c, P4d)
// P4c dynamic lane slice: acc[128] += tab[s[n] : s[n] + 128] from a [1, NW]
// table; P4d dynamic sublane slice: acc[2, 128] += tab[r[n] : r[n] + 2, :]
// from a [NR, 128] table (256 KB at the tool's NR: read through L1/L2).
// Both loops only sum int32 (mod 2^32: any order gives the same bits), so
// their iterations are cut over CTAs and warps and summed once, not run
// one after another on one block (the plan of ops/probes.py::slice_plan):
//   * CTA c takes the iterations [c * share, c * share + share), share =
//     ceil(iters / CTAs); its warps take `chunk` consecutive iterations at
//     a time (ceil(share / warps), at most 32), warp w the chunks w, w +
//     warps, ...;
//   * a warp loads a chunk's starts (rows) at once, one a lane, coalesced
//     (the next chunk's before this one's table loads, P4c's first before
//     its staging), and broadcasts each by __shfl_sync; the table loads of
//     SLICE_BATCH iterations are issued before their adds, so a thread
//     keeps 32 (P4c, shared memory) or 16 (P4d, 16-byte loads through
//     L1/L2) loads in flight instead of one dependent chain;
//   * P4c: each CTA stages the row in its shared memory once (16-byte
//     loads where the table is 16-byte aligned, SLICE_STAGE a thread
//     before their stores); a thread sums columns
//     lane + 32 k, k < 4 (32 consecutive words across a warp: one a bank
//     at any start).  P4d: a 512-byte table row is 32 lanes x 16 bytes, so
//     a thread sums columns 4 lane .. 4 lane + 3 of both rows;
//   * the warps' sums meet in shared memory (P4c's in the staged row's) as
//     the CTA's partial; with one CTA that is out, else every CTA adds its
//     partial into a scratch sum by atomics and the last CTA to take the
//     ticket copies that sum to out (slice_finish), all inside the one
//     launch.  That CTA puts the sum back to 0 and its atomicInc wraps the
//     ticket back to 0, so the next launch on the stream finds both so;
//     out needs no zeroing before a launch.
constexpr int SLICE_MAX_THREADS = 512;
constexpr int SLICE_MAX_CTAS = 1024;
constexpr int SLICE_BATCH = 8;  // iterations whose loads go out together
constexpr int SLICE_STAGE = 4;  // 16-byte loads a thread a staging round

struct SliceRange {
  int lo, hi, chunk;  // the CTA's iterations [lo, hi); a warp's at a time
};

__device__ __forceinline__ SliceRange slice_range(int iters) {
  const int share = (int)((iters + (long long)gridDim.x - 1) / gridDim.x);
  const int warps = blockDim.x / 32;
  SliceRange r;
  r.lo = (int)min((long long)iters, (long long)blockIdx.x * share);
  r.hi = (int)min((long long)iters, (long long)r.lo + share);
  r.chunk = min(32, max(1, (share + warps - 1) / warps));
  return r;
}

// A lane's start (row) of the warp's chunk at `base`, clamped to [0, top];
// 0 past the chunk or the CTA's range (a warp's loads of the next chunk go
// out before the current chunk's table loads).
__device__ __forceinline__ int slice_index(const int* __restrict__ idx,
                                           int base, const SliceRange& rg,
                                           int lane, int top) {
  return lane < rg.chunk && base + lane < rg.hi
             ? clampi(__ldg(idx + base + lane), 0, top)
             : 0;
}

// The end of a sliced sum: the CTA's partial (W words) is the sum of the
// `warps` rows of s_buf [warps][W].  With one CTA it is out; else each CTA
// adds its nonzero words into `total` [W] (zero between launches) by
// fire-and-forget atomics, and the last CTA to take the ticket copies
// total to out and puts it back to zero.  (No static shared memory: P4c's
// row may take all a block has.)
template <int W>
__device__ void slice_finish(const int* s_buf, int warps,
                             int* __restrict__ out, int* __restrict__ total,
                             unsigned* __restrict__ ticket) {
  const int T = blockDim.x, tid = threadIdx.x, ctas = gridDim.x;
  for (int k = tid; k < W; k += T) {
    int v = 0;
    for (int w = 0; w < warps; ++w) v += s_buf[w * W + k];
    if (ctas == 1)
      out[k] = v;
    else if (v != 0)
      atomicAdd(total + k, v);
  }
  if (ctas == 1) return;
  __syncthreads();  // the CTA's adds are issued: thread 0's ticket releases
  int last = 0;     // them (cumulative over the barrier) and acquires the
  if (tid == 0) {   // other CTAs' before the reads below
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(ticket), "r"((unsigned)(ctas - 1))
                 : "memory");
    last = old == (unsigned)(ctas - 1);
  }
  if (!__syncthreads_or(last)) return;
  for (int k = tid; k < W; k += T) {
    out[k] = __ldcg(total + k);
    __stcg(total + k, 0);
  }
}

__global__ void __launch_bounds__(SLICE_MAX_THREADS)
    lane_slice_kernel(const int* __restrict__ tab, int NW,
                      const int* __restrict__ starts, int* __restrict__ out,
                      int iters, int* __restrict__ total,
                      unsigned* __restrict__ ticket) {
  extern __shared__ __align__(16) int s_row[];  // the row, then the sums
  const int T = blockDim.x, tid = threadIdx.x;
  const int warps = T / 32, w = tid / 32, lane = tid % 32;
  const SliceRange rg = slice_range(iters);
  const int step = warps * rg.chunk;
  int base = rg.lo + w * rg.chunk;
  int mine = slice_index(starts, base, rg, lane, NW - 128);
  int k0 = 0;  // stage: a thread's loads of a round before its stores
  if ((reinterpret_cast<unsigned long long>(tab) & 15) == 0) {
    const int q = NW / 4;
    const int4* src = reinterpret_cast<const int4*>(tab);
    int4* dst = reinterpret_cast<int4*>(s_row);
    for (int k = tid; k < q; k += SLICE_STAGE * T) {
      int4 v[SLICE_STAGE];
#pragma unroll
      for (int u = 0; u < SLICE_STAGE; ++u)
        if (k + u * T < q) v[u] = __ldg(src + k + u * T);
#pragma unroll
      for (int u = 0; u < SLICE_STAGE; ++u)
        if (k + u * T < q) dst[k + u * T] = v[u];
    }
    k0 = 4 * q;
  }
  for (int k = k0 + tid; k < NW; k += T) s_row[k] = __ldg(tab + k);
  __syncthreads();
  int acc[4] = {0, 0, 0, 0};
  for (; base < rg.hi; base += step) {
    const int n = min(rg.chunk, rg.hi - base);
    const int next = slice_index(starts, base + step, rg, lane, NW - 128);
    for (int i0 = 0; i0 < n; i0 += SLICE_BATCH) {
      int got[SLICE_BATCH][4];
#pragma unroll
      for (int i = 0; i < SLICE_BATCH; ++i) {
        const int b = __shfl_sync(~0u, mine, (i0 + i) & 31) + lane;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          got[i][k] = i0 + i < n ? s_row[b + 32 * k] : 0;
      }
#pragma unroll
      for (int i = 0; i < SLICE_BATCH; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += got[i][k];
    }
    mine = next;
  }
  __syncthreads();  // the row is read: its words take the warps' sums
#pragma unroll
  for (int k = 0; k < 4; ++k) s_row[w * 128 + lane + 32 * k] = acc[k];
  __syncthreads();
  slice_finish<128>(s_row, warps, out, total, ticket);
}

__device__ __forceinline__ void add4(int4& a, const int4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// 4 words of a row; VEC: the table is 16-byte aligned, one 16-byte load
template <bool VEC>
__device__ __forceinline__ int4 row4(const int* __restrict__ p) {
  if (VEC) return __ldg(reinterpret_cast<const int4*>(p));
  return make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

template <bool VEC>
__global__ void __launch_bounds__(SLICE_MAX_THREADS)
    sublane_slice_kernel(const int* __restrict__ tab, int NR,
                         const int* __restrict__ rows, int* __restrict__ out,
                         int iters, int* __restrict__ total,
                         unsigned* __restrict__ ticket) {
  extern __shared__ __align__(16) int s_part[];  // [warps][2][128]
  const int T = blockDim.x, tid = threadIdx.x;
  const int warps = T / 32, w = tid / 32, lane = tid % 32;
  const SliceRange rg = slice_range(iters);
  const int step = warps * rg.chunk;
  int base = rg.lo + w * rg.chunk;
  int mine = slice_index(rows, base, rg, lane, NR - 2);
  int4 a0 = make_int4(0, 0, 0, 0), a1 = a0;
  for (; base < rg.hi; base += step) {
    const int n = min(rg.chunk, rg.hi - base);
    const int next = slice_index(rows, base + step, rg, lane, NR - 2);
    for (int i0 = 0; i0 < n; i0 += SLICE_BATCH) {
      int4 g0[SLICE_BATCH], g1[SLICE_BATCH];
#pragma unroll
      for (int i = 0; i < SLICE_BATCH; ++i) {
        const int r = __shfl_sync(~0u, mine, (i0 + i) & 31);
        const int* p = tab + (long long)r * 128 + 4 * lane;
        g0[i] = g1[i] = make_int4(0, 0, 0, 0);
        if (i0 + i < n) {
          g0[i] = row4<VEC>(p);
          g1[i] = row4<VEC>(p + 128);
        }
      }
#pragma unroll
      for (int i = 0; i < SLICE_BATCH; ++i) {
        add4(a0, g0[i]);
        add4(a1, g1[i]);
      }
    }
    mine = next;
  }
  reinterpret_cast<int4*>(s_part)[w * 64 + lane] = a0;
  reinterpret_cast<int4*>(s_part)[w * 64 + 32 + lane] = a1;
  __syncthreads();
  slice_finish<256>(s_part, warps, out, total, ticket);
}

// P4e refill: row r of out is tab[b : b + 128], b = bases[r] clamped into
// [0, NW - 128].  The TPU kernel stages the bases in SMEM scalars first;
// on the card that staging (a load, a barrier) only lengthens the one
// chain a row is: a base load, then 128 table loads that depend on it,
// then 128 stores.  So a row is a warp's: every lane reads the row's base
// itself (one broadcast load), issues its 4 coalesced loads of the row
// (words lane + 32k; b is unaligned, so they stay 4-byte loads) before
// any of its stores, then stores them.  Rows go to warps, warps to the
// CTAs of ops/probes.py::refill_plan (ctas, warps a CTA), row r on global
// warp r, r - W, ... of W warps.
constexpr int REFILL_MAX_WARPS = 32;
constexpr int REFILL_MAX_CTAS = 65535;

__global__ void __launch_bounds__(REFILL_MAX_WARPS * 32)
    refill_kernel(const int* __restrict__ tab, int NW,
                  const int* __restrict__ bases, int* __restrict__ out,
                  int WR) {
  const int lane = threadIdx.x & 31, per = blockDim.x >> 5;
  const int warps = gridDim.x * per;
  for (int r = blockIdx.x * per + (threadIdx.x >> 5); r < WR; r += warps) {
    const int* src = tab + clampi(__ldg(bases + r), 0, NW - 128) + lane;
    int v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldg(src + 32 * k);
    int* dst = out + (long long)r * 128 + lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[32 * k] = v[k];
  }
}

// ------------------------------------------------------- chunk sweep (P5)
// microbench_chunk.build: T cycles of K1's sweep skeleton on 13 planes of
// [WR + 8, 128] int32 (rA..rG read, tA..tE and vb written).  Full sweep:
// one chunk of WR rows a cycle; chunked: ceil(NR / CR) + (t & 1) chunks of
// CR rows.  Per row: 7 plane loads, the transition-sized ALU block, 5
// stores, the vb shift; 4 consecutive rows' bits are packed into one int32
// (row 4k + j in byte j) and stored to tb [64, WR / 4, 128] at row t % 64.
// Slice starts are clamped into their buffers (the reference overruns
// them at its own settings; its interpret mode clamps).  acc is the last
// cycle's sum over its chunks of max(h).
//
// The planes stay on chip, as the TPU kernel's VMEM scratch does: one
// thread-block cluster of C CTAs, CTA `rank` holding lanes [rank * L,
// rank * L + L) of all WR + 8 rows of the 13 planes in shared memory
// (L = 128 / C; ops/probes.py::chunk_plan).  A plane is [L][LS] with the
// rows of a lane contiguous, LS = (WR + 8) | 4 (an odd number of 16-byte
// groups), so a thread moves its 4 rows of a plane as one 16-byte access
// and the 8 lanes of a quarter-warp fall on distinct banks.  Thread item
// i of a CTA is (quad q = i / L of store rows 4q..4q+3, lane i % L), the
// same in every chunk and cycle, so the vb read-modify-write needs no
// barrier.  Every chunk's load and store rows lie inside the CTA.
//
// A cycle's chunks are independent but for acc, so they run side by side:
// each warp takes the chunks that cover its quads (a range computed from
// the clamped starts), reduces each chunk's max over its lanes in one warp
// instruction into the CTA's per-chunk maxima, and once per round of up to
// CHUNK_ROUND chunks (one round a cycle at the tool's settings) a thread
// per chunk sends the CTA's maximum into CTA 0's shared memory by st.async,
// which completes on an mbarrier of CTA 0 (the bytes are counted there),
// so no cluster-wide release fence is paid for them.  One cluster barrier
// a round, relaxed, split into arrive and wait around the next round's
// work, keeps the CTAs within a round of each other; CTA 0 waits for the
// round's bytes and sums max over CTAs of each chunk into acc.  The
// exchange slots and their mbarriers rotate over 3 rounds, so that no CTA
// overwrites a round CTA 0 has not read (CTA 0's sum, which consumes the
// slot's loads, precedes its arrive).  A release on the arrive would cost
// each round a cluster-wide fence; the tb rows and planes need none, as
// each is written by one CTA only.
constexpr int CHUNK_MAX_THREADS = 768;
constexpr int CHUNK_ROUND = 32;  // chunks one cluster exchange combines
constexpr int N_PLANES = 13;

// Shared-memory words of a CTA of the sweep at width WR, cluster size C
// (ops/probes.py::chunk_smem): the planes, 3 mbarriers (8 words), this
// CTA's chunk maxima of two rounds and CTA 0's exchange slots of three.
inline long long chunk_words(int WR, int C) {
  return (long long)N_PLANES * (128 / C) * ((WR + 8) | 4) + 8 +
         2 * CHUNK_ROUND + 3 * CHUNK_ROUND * C;
}

// The round barrier: every thread of the cluster, whole warps; no memory
// ordering (the exchange has its own, on mbarriers).  The multi probes use
// its wait too.
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The shared::cluster address of `p` (this CTA's shared memory) in CTA
// `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(mwf::smem_u32(p)), "r"(rank));
  return a;
}

// Store v at shared::cluster address `addr`; its 4 bytes complete on the
// mbarrier at shared::cluster address `bar` (both in one CTA).
__device__ __forceinline__ void store_async(unsigned addr, int v,
                                            unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

// CTA 0, warp 0: wait for round `round`'s maxima (n chunks from each of C
// CTAs, 4 bytes each, on mbarrier `bar`), then add the round's chunks (the
// max over the CTAs of each, exchange slots xs [CHUNK_ROUND][C]) to the
// cycle's sum; after the cycle's last round the sum is acc.
__device__ __forceinline__ void take_round(const int* xs,
                                           unsigned long long* bar,
                                           int round, int n, int C, int last,
                                           int& sum, int& acc) {
  if ((threadIdx.x & 31) == 0) mwf::bar_expect(bar, 4u * n * C);
  __syncwarp();
  mwf::bar_wait(bar, (round / 3) & 1);
  int part = 0;
  for (int c = threadIdx.x & 31; c < n; c += 32) {
    int m = xs[c * C];
    for (int q = 1; q < C; ++q) m = max(m, xs[c * C + q]);
    part += m;
  }
  sum += __reduce_add_sync(0xffffffffu, part);
  if (last) {
    acc = sum;
    sum = 0;
  }
}

__global__ void __launch_bounds__(CHUNK_MAX_THREADS)
    chunk_kernel(int* __restrict__ acc_out, int* __restrict__ tb, int WR,
                 int CR, int T, int NR, int chunked, int L) {
  extern __shared__ int4 sm4[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), C = (int)cl.num_blocks();
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;
  const int WRP = WR + 8, WR4 = WR / 4, LS = WRP | 4;
  const int PL = L * LS;      // words of one plane
  const int lg = __ffs(L) - 1;  // L = 128 / C, a power of two
  int* planes = (int*)sm4;
  // [3] CTA 0's: the bytes of a round's exchange slot
  unsigned long long* xbar = (unsigned long long*)(planes + N_PLANES * PL);
  int* lmax = planes + N_PLANES * PL + 8;  // [2][CHUNK_ROUND]
  int* xmax = lmax + 2 * CHUNK_ROUND;      // [3][CHUNK_ROUND][C], CTA 0's
  const unsigned xmax0 = cluster_addr(xmax, 0), xbar0 = cluster_addr(xbar, 0);
  for (int k = tid; k < N_PLANES * PL; k += nthr)
    planes[k] = k < 7 * PL ? 3 : 1;
  for (int k = tid; k < 2 * CHUNK_ROUND; k += nthr) lmax[k] = INT_MIN;
  if (rank == 0 && tid == 0) {
    for (int k = 0; k < 3; ++k) mwf::bar_init(xbar + k);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();  // planes filled, mbarriers set, every CTA running

  const int cr = chunked ? CR : WR, Q = cr / 4;
  // full sweep: loads from row 0 (r[:][:WR]); chunked: CR + 8 rows at ro
  const int ld_rows = chunked ? CR + 8 : WRP;
  const int s4max = (WRP - cr) / 4;  // the last store quad a chunk starts at
  const int items = (WRP / 4) * L;
  int acc = 0, acc_c = 0;  // CTA 0, warp 0: acc, and the cycle's sum
  int prev_n = 0, prev_last = 0, r = 0;
  for (int t = 0; t < T; ++t) {
    const int nc = chunked ? (NR + CR - 1) / CR + (t & 1) : 1;
    for (int cb = 0; cb < nc; cb += CHUNK_ROUND, ++r) {
      const int n = min(CHUNK_ROUND, nc - cb);
      int* lm = lmax + (r & 1) * CHUNK_ROUND;
      for (int w0 = tid - lane; w0 < items; w0 += nthr) {
        const int i = w0 + lane;
        const int qs = i >> lg, l = i & (L - 1);
        // chunks whose store quads [s4, s4 + Q) meet this warp's [qa, qb]:
        // s4 = min(ci * Q, s4max) grows with ci
        const int qa = w0 >> lg, qb = min(w0 + 31, items - 1) >> lg;
        if (s4max <= qa - Q) continue;
        const int lo = max(cb, qa / Q);
        const int hi = min(cb + n - 1, s4max <= qb ? INT_MAX : qb / Q);
        for (int ci = lo; ci <= hi; ++ci) {
          const int ro = ci * cr;
          const int ld = clampi(ro, 0, WRP - ld_rows) / 4;
          const int s4 = clampi(ro, 0, WRP - cr) / 4;
          const int tbs = clampi(ro / 4, 0, WR4 - Q);
          int hmax = INT_MIN;
          if (i < items && qs >= s4 && qs < s4 + Q) {
            const int k = qs - s4;
            int x[7][4];
#pragma unroll
            for (int p = 0; p < 7; ++p) {
              const int4 v =
                  *(const int4*)(planes + p * PL + l * LS + 4 * (ld + k));
              x[p][0] = v.x;
              x[p][1] = v.y;
              x[p][2] = v.z;
              x[p][3] = v.w;
            }
            int o[5][4];
            int packed = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int a = x[0][j], b = x[1][j], c = x[2][j], d = x[3][j];
              const int e = x[4][j], f = x[5][j], g = x[6][j];
              const int e1 = max(a, b) + t;
              const int e2 = max(c, d) + 1;
              const int f1 = max(e, f) + 1;
              const int f2 = max(g, a) + 1;
              int z = e1 >= e2 ? 1 : 3;
              const int h = max(max(e1, e2), max(f1, f2));
              z = a + 1 >= h ? 0 : z;
              const int bits = ((e1 < e2 ? 1 : 0) << 3) | z;
              o[0][j] = h;
              o[1][j] = e1;
              o[2][j] = f1;
              o[3][j] = e2;
              o[4][j] = f2;
              packed |= bits << (8 * j);
              hmax = max(hmax, h);
            }
            const int so = l * LS + 4 * qs;
#pragma unroll
            for (int p = 0; p < 5; ++p)
              *(int4*)(planes + (7 + p) * PL + so) =
                  make_int4(o[p][0], o[p][1], o[p][2], o[p][3]);
            int4* vb = (int4*)(planes + 12 * PL + so);
            int4 y = *vb;
            y.x = (y.x << 1) & 0xFFFF;
            y.y = (y.y << 1) & 0xFFFF;
            y.z = (y.z << 1) & 0xFFFF;
            y.w = (y.w << 1) & 0xFFFF;
            *vb = y;
            tb[((long long)(t % 64) * WR4 + tbs + k) * 128 + rank * L + l] =
                packed;
          }
          hmax = __reduce_max_sync(0xffffffffu, hmax);
          if (lane == 0) atomicMax(lm + ci - cb, hmax);
        }
      }
      __syncthreads();
      if (tid < n) {
        store_async(xmax0 + 4 * (((r % 3) * CHUNK_ROUND + tid) * C + rank),
                    lm[tid], xbar0 + 8 * (r % 3));
        lm[tid] = INT_MIN;
      }
      if (r > 0) {
        cluster_wait();
        if (rank == 0 && tid < 32)
          take_round(xmax + ((r - 1) % 3) * CHUNK_ROUND * C,
                     xbar + (r - 1) % 3, r - 1, prev_n, C, prev_last, acc_c,
                     acc);
      }
      cluster_arrive();
      prev_n = n;
      prev_last = cb + CHUNK_ROUND >= nc;
    }
  }
  cluster_wait();
  if (rank == 0 && tid < 32) {
    take_round(xmax + ((r - 1) % 3) * CHUNK_ROUND * C, xbar + (r - 1) % 3,
               r - 1, prev_n, C, prev_last, acc_c, acc);
    if (tid == 0) acc_out[0] = acc;
  }
}

// ----------------------------------------------------- multi probes (P6-P8)
// K4's lowering questions on x [G, RX, L] (RX = R + 8 for the ring probes'
// padded input), out [G, R, L].  What bounds them: each moves its tile in
// and out once (64 KB at the tools' [4, 64, 128]), 0.08 us at 3.35 TB/s,
// so a launch is its fixed cost, one round trip for the lane's tile, and
// the barriers its reductions need.  The design, on the plan (C, threads,
// nv) of ops/probes_multi.py::multi_plan:
//   * the lanes spread over CTAs: lane g is CTAs g * C .. g * C + C - 1,
//     CTA c holding words [c * span, c * span + span) of the lane's domain
//     (R * L words; the padded tile for RING4), span = C's share rounded up
//     to 4 words.  A probe with no lane reduction takes as many CTAs a lane
//     as the card's SMs allow (at least 1024 words each); one with a
//     reduction within its lane the fewest that hold the lane, on few full
//     warps (each warp costs its barrier); the two that span the lanes as
//     many as one cluster of 8 allows (measured on an H100, PERF.md);
//   * no staging: thread t holds vectors k < nv, words c0 + 4 (t + k
//     threads) .. + 3, in registers, loaded by 16-byte loads all issued
//     before the first use (4 scalar loads where the lane is not 16-byte
//     aligned or a vector runs past the CTA's words: L % 4 != 0 takes
//     that tail); SUB's rows 16..23 and SHIFT3's left neighbour at a warp's
//     edge (one word, read from global memory with the rest, where a
//     shared-memory step would cost a barrier) are loaded with them;
//   * a reduction within a lane is a warp `redux`, one shared-memory step
//     and one CTA barrier; where a lane spans C > 1 CTAs they are one
//     thread-block cluster and exchange their partials through distributed
//     shared memory, one cluster barrier each;
//   * MAX_MIN and WHILE_G11 span the lanes: all G * C CTAs are one cluster
//     (at most 8, a portable size), and every CTA reads every CTA's
//     partial after one cluster barrier a reduction (a round of the while
//     loop, its exit tested on every lane's flag each round);
//   * the rings stay on chip, as the TPU keeps them in VMEM: a CTA's share
//     of the [3, RX, L] ring in its shared memory, [3][span]; the five
//     writes stay writes (volatile 16-byte stores); each thread then reads
//     slot 1 back where it wrote it, so no barrier is needed (RING4's out
//     row r is padded row r + 8: the thread holding that word stores it);
//   * REGISTRY: each CTA writes its own [3, 8, L] registry copy (its lane's
//     row and rows G..7, five times), since only reg[1][g][0] is read.
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

constexpr int SR = 8;            // multi3's sub-window rows
constexpr int MULTI_VECS = 4;    // int4 vectors a thread holds, at most
constexpr int MULTI_CLUSTER = 8;  // CTAs a cluster, at most (portable)
constexpr int NEG30 = -(1 << 30);

constexpr bool multi_reduces(int P) {
  return P == LANE_MASK || P == MIN_MASK || P == MAX_OUT || P == ANY_MASK ||
         P == STACK || P == REGISTRY || P == MAX_MIN || P == WHILE_G11;
}
constexpr bool multi_cross(int P) { return P == MAX_MIN || P == WHILE_G11; }

struct MultiParams {
  const int* x;    // [G, RX, L]
  const int* aux;  // BND: [>= G, L] bound plane; ADD_SCALAR: [G] scalars
  int* out;        // [G, R, L]
  int* s_out;      // LANE_MASK, MAX_OUT: [G]; MAX_MIN: [G + 1]
  int G, R, L, RX;
  int C, span, nv, cl;  // CTAs a lane, words a CTA, vectors a thread,
                        // cluster size
};

// The shared memory a multi kernel declares itself (red, part)
constexpr int MULTI_STATIC_SMEM = (2 * 32 + 2) * (int)sizeof(int);

struct MinOp {
  static constexpr int id = INT_MAX;
  __device__ int operator()(int a, int b) const { return min(a, b); }
  __device__ int warp(int v) const { return __reduce_min_sync(~0u, v); }
};
struct MaxOp {
  static constexpr int id = INT_MIN;
  __device__ int operator()(int a, int b) const { return max(a, b); }
  __device__ int warp(int v) const { return __reduce_max_sync(~0u, v); }
};
struct SumOp {
  static constexpr int id = 0;
  __device__ int operator()(int a, int b) const { return a + b; }
  __device__ int warp(int v) const { return __reduce_add_sync(~0u, v); }
};

__device__ __forceinline__ int word(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ int4 add4(int4 v, int s) {
  return make_int4(v.x + s, v.y + s, v.z + s, v.w + s);
}

// Words w..w+3 of p, those at lim or past it 0: one 16-byte load where
// `vec` (p 16-byte aligned; w is a multiple of 4) and all four lie below
// lim, else scalar loads.
__device__ __forceinline__ int4 ld4(const int* p, int w, int lim, bool vec) {
  if (vec && w + 4 <= lim) return __ldg(reinterpret_cast<const int4*>(p + w));
  int4 r = make_int4(0, 0, 0, 0);
  if (w < lim) r.x = __ldg(p + w);
  if (w + 1 < lim) r.y = __ldg(p + w + 1);
  if (w + 2 < lim) r.z = __ldg(p + w + 2);
  if (w + 3 < lim) r.w = __ldg(p + w + 3);
  return r;
}

// Store the words of v below lim at p[w..w+3], as ld4 loads them.
__device__ __forceinline__ void st4(int* p, int w, int lim, bool vec,
                                    int4 v) {
  if (vec && w + 4 <= lim) {
    *reinterpret_cast<int4*>(p + w) = v;
    return;
  }
  if (w < lim) p[w] = v.x;
  if (w + 1 < lim) p[w + 1] = v.y;
  if (w + 2 < lim) p[w + 2] = v.z;
  if (w + 3 < lim) p[w + 3] = v.w;
}

__device__ __forceinline__ void st_volatile4(int* p, int4 v) {
  asm volatile("st.volatile.shared.v4.s32 [%0], {%1, %2, %3, %4};" ::"r"(
                   mwf::smem_u32(p)),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ int4 ld_volatile4(const int* p) {
  int4 v;
  asm volatile("ld.volatile.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(mwf::smem_u32(p))
               : "memory");
  return v;
}

// v over the CTA (whole warps), given to every thread: a warp redux, one
// shared-memory step (red: this reduction's 32 slots), one barrier.
template <class Op>
__device__ __forceinline__ int cta_reduce(int v, Op op, int* red) {
  v = op.warp(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return op.warp(lane < (int)(blockDim.x >> 5) ? red[lane] : Op::id);
}

// The cluster's CTAs' values of v (uniform in each CTA): after one cluster
// barrier, lane i of every warp holds CTA rank i's (i < cl; `id` past it),
// read from its shared memory.  part: this CTA's two exchange slots, used
// in turn (`slot`), so that no post overwrites one a slower CTA has still
// to read (the next exchange's barrier lies between).
__device__ __forceinline__ int cluster_values(int v, int* part, int slot,
                                              int cl, int id) {
  const int lane = threadIdx.x & 31;
  if (cl == 1) return lane == 0 ? v : id;
  if (threadIdx.x == 0) part[slot] = v;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  return lane < cl ? *cluster.map_shared_rank(part + slot, lane) : id;
}

// v reduced over the lane (its cl CTAs; cl == C), given to every thread.
template <class Op>
__device__ __forceinline__ int lane_reduce(int v, Op op, int* red, int* part,
                                           int slot, int cl) {
  v = cta_reduce(v, op, red + 32 * slot);
  if (cl == 1) return v;
  return op.warp(cluster_values(v, part, slot, cl, Op::id));
}

// After a CTA's last read of another's shared memory: arrive, so that no
// CTA of the cluster exits while one may still read it (the wait closes
// the kernel).
__device__ __forceinline__ void exit_arrive(int cl) {
  if (cl > 1) {
    __syncwarp();
    asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  }
}

template <int P>
__global__ void __launch_bounds__(1024) multi_kernel(MultiParams p) {
  extern __shared__ int4 dsm[];  // RING4/RING_WRITE: [3][span];
                                 // REGISTRY: [3][8][L]
  __shared__ int red[2 * 32];
  __shared__ int part[2];
  const int G = p.G, R = p.R, L = p.L, C = p.C, cl = p.cl, nv = p.nv;
  const int g = blockIdx.x / C, c = blockIdx.x % C;
  const int T = blockDim.x, lane = threadIdx.x & 31;
  const int n = P == RING4 ? p.RX * L : R * L;  // the lane's domain
  const int c0 = c * p.span, c1 = min(n, c0 + p.span);
  const int* xg = p.x + (long long)g * p.RX * L;
  int* og = p.out + (long long)g * R * L;
  const bool xv = ((size_t)xg & 15) == 0, ov = ((size_t)og & 15) == 0;
  auto first = [&](int k) { return c0 + 4 * ((int)threadIdx.x + k * T); };

  int4 v[MULTI_VECS], y[MULTI_VECS];  // y: SUB's rows 16..23; SHIFT3's
                                      // left neighbour (.x)
  int aux = 0;
  if (P == BND) aux = __ldg(p.aux + (long long)g * L);
  if (P == ADD_SCALAR) aux = __ldg(p.aux + g);
#pragma unroll
  for (int k = 0; k < MULTI_VECS; ++k) {
    v[k] = y[k] = make_int4(0, 0, 0, 0);
    if (k < nv) {
      const int w = first(k);
      v[k] = ld4(xg, w, c1, xv);
      if (P == SUB && w < 8 * L) y[k] = ld4(xg, w + 16 * L, c1 + 16 * L, xv);
      if (P == SHIFT3)
        y[k].x = w == 0 ? -9 : (lane == 0 && w < c1) ? __ldg(xg + w - 1) : 0;
    }
  }
  // fold f(value, word) over the CTA's words
  auto fold = [&](auto f) {
#pragma unroll
    for (int k = 0; k < MULTI_VECS; ++k) {
      if (k < nv) {
        const int w = first(k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (w + j < c1) f(word(v[k], j), w + j);
      }
    }
  };
  // out[w] = f(value, w) for the CTA's words
  auto map = [&](auto f) {
#pragma unroll
    for (int k = 0; k < MULTI_VECS; ++k) {
      const int w = first(k);
      if (k < nv && w < c1)
        st4(og, w, c1, ov,
            make_int4(f(v[k].x, w), f(v[k].y, w + 1), f(v[k].z, w + 2),
                      f(v[k].w, w + 3)));
    }
  };

  if constexpr (P == LANE_MASK || P == MIN_MASK || P == STACK ||
                P == REGISTRY) {
    int lo = INT_MAX;
    fold([&](int x, int) { lo = min(lo, x); });
    lo = lane_reduce(lo, MinOp(), red, part, 0, cl);
    if constexpr (P == LANE_MASK || P == MIN_MASK) {
      map([&](int x, int) { return x >= lo + 5 ? x : -1; });
      if constexpr (P == LANE_MASK) {
        int m = INT_MIN;
        fold([&](int x, int) { m = max(m, x >= lo + 5 ? x : NEG30); });
        m = lane_reduce(m, MaxOp(), red, part, 1, cl);
        if (c == 0 && threadIdx.x == 0) p.s_out[g] = m;
      }
    } else if constexpr (P == STACK) {
      const int a = clampi(floor_mod(lo, R - SR), 0, R - SR);
      map([&](int x, int w) {
        return w >= a * L && w < (a + SR) * L ? x * 2 : x;
      });
    } else {  // REGISTRY
      // its lane's row and rows G..7, a word a thread: five writes each
      int* reg = (int*)dsm;
      for (int i = threadIdx.x; i < (9 - G) * L; i += T) {
        const int rr = i / L, l = i - rr * L;
        const int at = (rr == 0 ? g : G + rr - 1) * L + l;
        const int base = rr == 0 ? lo : 0;
        for (int j = 0; j < 5; ++j)
          asm volatile("st.volatile.shared.s32 [%0], %1;" ::"r"(
                           mwf::smem_u32(reg + (j % 3) * 8 * L + at)),
                       "r"(base + j)
                       : "memory");
      }
      __syncthreads();
      int got;
      asm volatile("ld.volatile.shared.s32 %0, [%1];"
                   : "=r"(got)
                   : "r"(mwf::smem_u32(reg + 1 * 8 * L + g * L))
                   : "memory");
      map([&](int x, int) { return x + got; });
    }
    exit_arrive(cl);
  } else if constexpr (P == MAX_OUT || P == ANY_MASK) {
    int m = P == MAX_OUT ? INT_MIN : 0;
    fold([&](int x, int) { m = max(m, P == MAX_OUT ? x : (x > 50 ? 1 : 0)); });
    m = lane_reduce(m, MaxOp(), red, part, 0, cl);
    exit_arrive(cl);
    if constexpr (P == MAX_OUT) {
      if (c == 0 && threadIdx.x == 0) p.s_out[g] = m;
      map([&](int x, int) { return x; });
    } else {
      map([&](int x, int) { return m > 0 ? x : 0; });
    }
  } else if constexpr (P == MAX_MIN) {
    // every lane's max on CTA 0 of the cluster (the grid): lane j < G of
    // its warp 0 takes lane j's (the max over its C CTAs) and writes
    // s_out[j]; their min goes to s_out[G] from lane 0
    int m = INT_MIN;
    fold([&](int x, int) { m = max(m, x); });
    m = cta_reduce(m, MaxOp(), red);
    const int got = cluster_values(m, part, 0, cl, INT_MIN);
    exit_arrive(cl);
    if (blockIdx.x == 0 && threadIdx.x < 32) {
      int mj = INT_MIN;
      for (int k = 0; k < C; ++k)
        mj = max(mj, __shfl_sync(~0u, got, (lane * C + k) & 31));
      const int lo = __reduce_min_sync(~0u, lane < G ? mj : INT_MAX);
      if (lane < G) p.s_out[lane] = mj;
      if (lane == 0) p.s_out[G] = lo;
    }
    map([&](int x, int) { return x; });
  } else if constexpr (P == WHILE_G11) {
    // while t < 16 and not every lane done: lane j's acc is held by lane j
    // of every warp of every CTA (all compute it alike from the round's
    // partials), done = acc > 300 (acc never falls, so done stays done)
    int acc_j = 0, t = 0;
    while (t < 16 && !__all_sync(~0u, lane >= G || acc_j > 300)) {
      int cnt = 0;
      fold([&](int x, int) { cnt += floor_mod(x + t, 7) == 0; });
      cnt = cta_reduce(cnt, SumOp(), red + 32 * (t & 1));
      const int got = cluster_values(cnt, part, t & 1, cl, 0);
      int s = 0;
      for (int k = 0; k < C; ++k)
        s += __shfl_sync(~0u, got, (lane * C + k) & 31);
      acc_j += s;
      ++t;
    }
    exit_arrive(cl);
    const int acc = __shfl_sync(~0u, acc_j, g);
    map([&](int, int) { return acc; });
  } else if constexpr (P == SHIFT3) {
    // out[w] = x[w - 1] over the lane's flat words, -9 at w = 0
#pragma unroll
    for (int k = 0; k < MULTI_VECS; ++k) {
      if (k < nv) {
        const int w = first(k);
        const int up = __shfl_up_sync(~0u, v[k].w, 1);
        const int prev = lane == 0 || w == 0 ? y[k].x : up;
        if (w < c1)
          st4(og, w, c1, ov, make_int4(prev, v[k].x, v[k].y, v[k].z));
      }
    }
  } else if constexpr (P == SUB) {
#pragma unroll
    for (int k = 0; k < MULTI_VECS; ++k) {
      const int w = first(k);
      if (k < nv && w < c1) {
        const int4 o = w < 8 * L ? make_int4(2 * y[k].x, 2 * y[k].y,
                                             2 * y[k].z, 2 * y[k].w)
                                 : v[k];
        st4(og, w, c1, ov, o);
      }
    }
  } else if constexpr (P == BND) {
    map([&](int x, int) { return x >= aux ? x : -3; });
  } else if constexpr (P == ADD_SCALAR) {
    map([&](int x, int) { return x + aux; });
  } else if constexpr (P == RING4 || P == RING_WRITE) {
    // RING4 writes the padded tile into slot j % 3; RING_WRITE x's rows
    // 0..R-1 at rows 8..8+R of it: ring position 8 L + w for word w of x,
    // kept here at the word's own place in the CTA's share.  Both read slot
    // 1's rows 8..8+R after the fifth write.
    int* ring = (int*)dsm;
    for (int j = 0; j < 5; ++j) {
      int* slot = ring + (j % 3) * p.span;
#pragma unroll
      for (int k = 0; k < MULTI_VECS; ++k) {
        const int w = first(k);
        if (k < nv && w < c1) st_volatile4(slot + w - c0, add4(v[k], j));
      }
    }
#pragma unroll
    for (int k = 0; k < MULTI_VECS; ++k) {
      const int w = first(k);
      if (k < nv && w < c1) {
        const int4 r = ld_volatile4(ring + p.span + w - c0);
        if (P == RING_WRITE)
          st4(og, w, c1, ov, r);
        else if (w >= 8 * L)
          st4(og, w - 8 * L, c1 - 8 * L, ov, r);
      }
    }
  }
  if (cl > 1) cluster_wait();
}

// Dynamic shared memory of a multi launch: the CTA's ring share or the
// registry copy (ops/probes_multi.py::multi_smem).
inline long long multi_dyn_smem(int probe, int span, int L) {
  if (probe == RING4 || probe == RING_WRITE) return 3LL * span * 4;
  if (probe == REGISTRY) return 3LL * 8 * L * 4;
  return 0;
}

template <int P>
int launch_multi(const MultiParams& p, int threads, int smem,
                 cudaStream_t stream) {
  static int cache[MAX_DEVICES];
  const void* fn = (const void*)multi_kernel<P>;
  cudaError_t err = opt_in(fn, smem, cache);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(p.G * p.C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  MultiParams q = p;
  void* args[] = {&q};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_multi(int probe, const MultiParams& p, int threads, int smem,
                   cudaStream_t stream) {
  if constexpr (P < N_MULTI) {
    if (probe == P) return launch_multi<P>(p, threads, smem, stream);
    return dispatch_multi<P + 1>(probe, p, threads, smem, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}
template <int AXIS, int CH>
int launch_gather(const int* tab, const int* idx, int* out, int Rt, int Mt,
                  int Ri, int Mi, int blocks, int per, int splits, int smem,
                  int iters, int chain, int lim, int zero, cudaStream_t s) {
  static int cache[MAX_DEVICES];
  cudaError_t err = opt_in((const void*)gather_kernel<AXIS, CH>, smem, cache);
  if (err != cudaSuccess) return (int)err;
  gather_kernel<AXIS, CH><<<blocks, GATHER_THREADS, smem, s>>>(
      tab, idx, out, Rt, Mt, Ri, Mi, per, splits, iters, chain, lim, zero);
  return (int)cudaGetLastError();
}

template <int AXIS>
int launch_gather_ch(int chains, const int* tab, const int* idx, int* out,
                     int Rt, int Mt, int Ri, int Mi, int blocks, int per,
                     int splits, int smem, int iters, int chain, int lim,
                     int zero, cudaStream_t s) {
  switch (chains) {
    case 1:
      return launch_gather<AXIS, 1>(tab, idx, out, Rt, Mt, Ri, Mi, blocks,
                                    per, splits, smem, iters, chain, lim,
                                    zero, s);
    case 2:
      return launch_gather<AXIS, 2>(tab, idx, out, Rt, Mt, Ri, Mi, blocks,
                                    per, splits, smem, iters, chain, lim,
                                    zero, s);
    case 4:
      return launch_gather<AXIS, 4>(tab, idx, out, Rt, Mt, Ri, Mi, blocks,
                                    per, splits, smem, iters, chain, lim,
                                    zero, s);
    case 8:
      return launch_gather<AXIS, 8>(tab, idx, out, Rt, Mt, Ri, Mi, blocks,
                                    per, splits, smem, iters, chain, lim,
                                    zero, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The shapes both gather entries take: 2-D tab and idx that agree off
// `axis`, a chain's modulus lim >= 1.
inline bool gather_shape_ok(int Rt, int Mt, int Ri, int Mi, int axis,
                            int lim) {
  return Rt >= 1 && Mt >= 1 && Ri >= 1 && Mi >= 1 && lim >= 1 &&
         (axis == 0 || axis == 1) && (axis == 0 || Ri == Rt) &&
         (axis == 1 || Mi == Mt);
}

constexpr int ONCE_MAX_CTAS = 65535;

template <int AXIS>
int launch_once(const int* tab, const int* idx, int* out, int Rt, int Mt,
                int Mi, long long n, int chain, int lim, int ctas,
                int threads, cudaStream_t s) {
  const bool vec = Mi % 4 == 0 &&
                   ((reinterpret_cast<unsigned long long>(idx) |
                     reinterpret_cast<unsigned long long>(out)) & 15) == 0;
  if (vec)
    gather_once_kernel<AXIS, true><<<ctas, threads, 0, s>>>(
        tab, idx, out, Rt, Mt, Mi, (unsigned)(n / 4), chain, lim);
  else
    gather_once_kernel<AXIS, false><<<ctas, threads, 0, s>>>(
        tab, idx, out, Rt, Mt, Mi, (unsigned)n, chain, lim);
  return (int)cudaGetLastError();
}

}  // namespace

// ----------------------------------------------------------- entry points
// Each launches on `stream` and returns cudaGetLastError(); shapes the
// kernel does not take return cudaErrorInvalidValue before any launch.

// The loop runs on the plan (blocks, per, chains) of
// ops/probes.py::gather_plan: groups of `per` table rows (axis 1) or
// columns (axis 0), blocks / groups blocks a group, `chains` chains a
// thread (1, 2, 4 or 8).  One gather takes mwf_probe_gather_once.
extern "C" int mwf_probe_gather(const int* tab, int Rt, int Mt,
                                const int* idx, int Ri, int Mi, int* out,
                                int axis, int iters, int chain, int lim,
                                int zero, int blocks, int per, int chains,
                                void* stream) {
  if (!gather_shape_ok(Rt, Mt, Ri, Mi, axis, lim) || iters < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // units: what a group is cut from (table rows, or columns); unit: the
  // words of one of them
  const int units = axis == 1 ? Rt : Mt, unit = axis == 1 ? Mt : Rt;
  if (per < 1 || per > units || blocks < 1) return (int)cudaErrorInvalidValue;
  const int groups = (units + per - 1) / per;
  if (blocks % groups) return (int)cudaErrorInvalidValue;
  const long long smem = (long long)per * unit * (long long)sizeof(int);
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  if (axis == 1)
    return launch_gather_ch<1>(chains, tab, idx, out, Rt, Mt, Ri, Mi, blocks,
                               per, blocks / groups, (int)smem, iters, chain,
                               lim, zero, s);
  return launch_gather_ch<0>(chains, tab, idx, out, Rt, Mt, Ri, Mi, blocks,
                             per, blocks / groups, (int)smem, iters, chain,
                             lim, zero, s);
}

// One gather on the plan (ctas, threads) of ops/probes.py::once_plan: 1 to
// ONCE_MAX_CTAS CTAs of whole warps up to 1024 threads; idx below 2^31
// elements.  4 outputs a thread where Mi % 4 == 0 and idx and out are
// 16-byte aligned, else one.
extern "C" int mwf_probe_gather_once(const int* tab, int Rt, int Mt,
                                     const int* idx, int Ri, int Mi,
                                     int* out, int axis, int chain, int lim,
                                     int ctas, int threads, void* stream) {
  const long long n = (long long)Ri * Mi;
  if (!gather_shape_ok(Rt, Mt, Ri, Mi, axis, lim) || n > INT_MAX ||
      ctas < 1 || ctas > ONCE_MAX_CTAS || threads < 32 || threads > 1024 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis == 1)
    return launch_once<1>(tab, idx, out, Rt, Mt, Mi, n, chain, lim, ctas,
                          threads, s);
  return launch_once<0>(tab, idx, out, Rt, Mt, Mi, n, chain, lim, ctas,
                        threads, s);
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

// P1e on the plan (blocks, threads) of ops/probes.py::row_write_plan:
// segments of 16 * threads bytes, blocks a multiple of the segments a row
// and at most S row classes (rb = blocks / segs).
extern "C" int mwf_probe_row_write(const int* x, unsigned char* out, int S,
                                   int W, int iters, int blocks, int threads,
                                   void* stream) {
  if (S < 1 || W < 4 || W % 4) return (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > 1024 || threads % 32 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int segs = (W + 16 * threads - 1) / (16 * threads);
  if (blocks % segs || blocks / segs > S) return (int)cudaErrorInvalidValue;
  row_write_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x, out, S, W, iters, blocks / segs);
  return (int)cudaGetLastError();
}

// P1f on the plan (blocks, threads, per) of ops/probes.py::while_plan:
// per == WHILE_PER elements a thread, threads a multiple of 32 up to 1024,
// exactly the blocks that n needs.
extern "C" int mwf_probe_while(const int* x, int* out, int n, int iters,
                               int sync, int blocks, int threads, int per,
                               void* stream) {
  if (n < 1 || per != WHILE_PER || threads < 32 || threads > 1024 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  const long long slice = (long long)threads * per;
  if (blocks != (n + slice - 1) / slice) return (int)cudaErrorInvalidValue;
  const int smem = threads * WHILE_PER * (int)sizeof(int);
  if (sync)
    while_kernel<true><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        x, out, n, iters);
  else
    while_kernel<false><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        x, out, n, iters);
  return (int)cudaGetLastError();
}

template <int PER>
int launch_roll(const int* x, int* out, int R, int M, int iters, int threads,
                int smem, cudaStream_t s) {
  static int cache[2][MAX_DEVICES];
  const bool same = threads % M == 0;
  const void* fn = same ? (const void*)roll_kernel<PER, true>
                        : (const void*)roll_kernel<PER, false>;
  cudaError_t err = opt_in(fn, smem, cache[same]);
  if (err != cudaSuccess) return (int)err;
  if (same)
    roll_kernel<PER, true><<<1, threads, smem, s>>>(x, out, R, M, iters);
  else
    roll_kernel<PER, false><<<1, threads, smem, s>>>(x, out, R, M, iters);
  return (int)cudaGetLastError();
}

// P4b on the plan (threads, per) of ops/probes.py::roll_plan: per (1, 2,
// 4, ... 32) elements a thread, up to 1024 threads that cover the R * M
// elements; the double buffer must fit one block's shared memory.
extern "C" int mwf_probe_roll(const int* x, int* out, int R, int M,
                              int iters, int threads, int per,
                              void* stream) {
  if (R < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)R * M, smem = 2 * n * (long long)sizeof(int);
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  if (threads < 1 || threads > 1024 || (long long)threads * per < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (per) {
    case 1: return launch_roll<1>(x, out, R, M, iters, threads, (int)smem, s);
    case 2: return launch_roll<2>(x, out, R, M, iters, threads, (int)smem, s);
    case 4: return launch_roll<4>(x, out, R, M, iters, threads, (int)smem, s);
    case 8: return launch_roll<8>(x, out, R, M, iters, threads, (int)smem, s);
    case 16:
      return launch_roll<16>(x, out, R, M, iters, threads, (int)smem, s);
    case 32:
      return launch_roll<32>(x, out, R, M, iters, threads, (int)smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The dynamic slices on the plan (ctas, threads) of ops/probes.py::
// slice_plan: 1 to SLICE_MAX_CTAS CTAs of whole warps up to
// SLICE_MAX_THREADS.  `scratch`: the ticket at word 0 and the sum [W]
// from word 4, all 0 between launches.
inline bool slice_plan_ok(int iters, int ctas, int threads) {
  return iters >= 0 && ctas >= 1 && ctas <= SLICE_MAX_CTAS &&
         threads >= 32 && threads <= SLICE_MAX_THREADS && threads % 32 == 0;
}

// P4c: NW from 128 to the words one block's shared memory holds.
extern "C" int mwf_probe_lane_slice(const int* tab, int NW, const int* starts,
                                    int* out, int iters, int ctas,
                                    int threads, int* scratch,
                                    void* stream) {
  if (NW < 128 || !slice_plan_ok(iters, ctas, threads))
    return (int)cudaErrorInvalidValue;
  const long long words = max(NW, threads / 32 * 128);
  if (words * (long long)sizeof(int) > SMEM_CAP)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)words * (int)sizeof(int);
  static int cache[MAX_DEVICES];
  cudaError_t err = opt_in((const void*)lane_slice_kernel, smem, cache);
  if (err != cudaSuccess) return (int)err;
  lane_slice_kernel<<<ctas, threads, smem, (cudaStream_t)stream>>>(
      tab, NW, starts, out, iters, scratch + 4, (unsigned*)scratch);
  return (int)cudaGetLastError();
}

// P4d: any NR >= 2.
extern "C" int mwf_probe_sublane_slice(const int* tab, int NR,
                                       const int* rows, int* out, int iters,
                                       int ctas, int threads, int* scratch,
                                       void* stream) {
  if (NR < 2 || !slice_plan_ok(iters, ctas, threads))
    return (int)cudaErrorInvalidValue;
  const int smem = threads / 32 * 256 * (int)sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if ((reinterpret_cast<unsigned long long>(tab) & 15) == 0)
    sublane_slice_kernel<true><<<ctas, threads, smem, s>>>(
        tab, NR, rows, out, iters, scratch + 4, (unsigned*)scratch);
  else
    sublane_slice_kernel<false><<<ctas, threads, smem, s>>>(
        tab, NR, rows, out, iters, scratch + 4, (unsigned*)scratch);
  return (int)cudaGetLastError();
}

// P4e on the plan (ctas, warps) of ops/probes.py::refill_plan: 1 to
// REFILL_MAX_CTAS CTAs of 1 to REFILL_MAX_WARPS warps; NW >= 128, WR >= 1.
extern "C" int mwf_probe_refill(const int* tab, int NW, const int* bases,
                                int* out, int WR, int ctas, int warps,
                                void* stream) {
  if (NW < 128 || WR < 1 || ctas < 1 || ctas > REFILL_MAX_CTAS ||
      warps < 1 || warps > REFILL_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  refill_kernel<<<ctas, 32 * warps, 0, (cudaStream_t)stream>>>(tab, NW, bases,
                                                             out, WR);
  return (int)cudaGetLastError();
}

// The sweep on one cluster of C CTAs (1, 2, 4, 8 or 16; past 8 a
// non-portable size) of L = 128 / C lanes each, the plan of
// ops/probes.py::chunk_plan; a WR whose planes do not fit a CTA's shared
// memory at that C is refused.
extern "C" int mwf_probe_chunk(int* acc, int* tb, int WR, int CR, int T,
                               int NR, int chunked, int C, int L,
                               void* stream) {
  if (WR < 4 || WR % 4 || T < 1 ||
      (chunked && (CR < 4 || CR % 4 || CR > WR || NR < 1)))
    return (int)cudaErrorInvalidValue;
  if (C < 1 || C > 16 || (C & (C - 1)) || L != 128 / C)
    return (int)cudaErrorInvalidValue;
  const long long smem = chunk_words(WR, C) * (long long)sizeof(int);
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)chunk_kernel;
  static int cache[MAX_DEVICES];
  cudaError_t err = opt_in(fn, (int)smem, cache);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  const int items = (WR + 8) / 4 * L;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(min(CHUNK_MAX_THREADS, (items + 31) / 32 * 32));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {&acc, &tb, &WR, &CR, &T, &NR, &chunked, &L};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The multi probes on the plan (C, threads, nv) of
// ops/probes_multi.py::multi_plan.  The shapes are those the single-block
// kernel took before (G in 1, 2, 4, 8; its [G, RX, L] tile staged in one
// block's shared memory), refused with the same error; the plan: C CTAs a
// lane, each some words of it (span: its share rounded up to 4), nv <=
// MULTI_VECS vectors a thread of whole warps up to 1024 that cover them,
// no CTA empty, a cluster of at most MULTI_CLUSTER CTAs (a lane's C for a
// lane reduction, the G * C of all lanes for MAX_MIN and WHILE_G11), the
// ring's share within a block's shared memory.
extern "C" int mwf_probe_multi(int probe, const int* x, const int* aux,
                               int* out, int* s_out, int G, int R, int L,
                               int RX, int C, int threads, int nv,
                               void* stream) {
  if (probe < 0 || probe >= N_MULTI || G < 1 || G > 8 || (G & (G - 1)) ||
      R < 1 || L < 1 || RX < R)
    return (int)cudaErrorInvalidValue;
  if ((probe == SUB && R < 24) || (probe == STACK && R <= SR) ||
      ((probe == RING4 || probe == RING_WRITE) && RX != R + 8))
    return (int)cudaErrorInvalidValue;
  const long long reg = probe == REGISTRY ? 24LL * L : 0;
  const long long tile =
      ((long long)G * RX * L + 8 * 16 + 8 + reg) * (long long)sizeof(int);
  if (tile > SMEM_CAP) return (int)cudaErrorInvalidValue;
  const int n = probe == RING4 ? RX * L : R * L;
  if (C < 1 || nv < 1 || nv > MULTI_VECS || threads < 32 || threads > 1024 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  const int span = ((n + C - 1) / C + 3) / 4 * 4;
  if (4LL * threads * nv < span || (long long)(C - 1) * span >= n)
    return (int)cudaErrorInvalidValue;
  const int cl = !multi_reduces(probe) ? 1 : multi_cross(probe) ? G * C : C;
  if (cl > MULTI_CLUSTER) return (int)cudaErrorInvalidValue;
  const long long smem = multi_dyn_smem(probe, span, L);
  if (smem + MULTI_STATIC_SMEM > SMEM_CAP) return (int)cudaErrorInvalidValue;
  MultiParams p{x, aux, out, s_out, G, R, L, RX, C, span, nv, cl};
  return dispatch_multi<0>(probe, p, threads, (int)smem, (cudaStream_t)stream);
}

// The empty kernel: a probe launch's fixed cost (the floor every one-launch
// probe is read against, tools/microbench.py), timed as a probe is.
__global__ void empty_kernel() {}

extern "C" int mwf_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The dependent-load floor: the empty launch plus one chain of what a
// one-shot gather or the refill does at bottom.  One warp loads 32
// indices, one word of `tab` at each (the table stays in L2 between
// launches) and stores the 32 words; no probe's body, no JAX counterpart.
__global__ void dep_floor_kernel(const int* __restrict__ tab,
                                 const int* __restrict__ idx,
                                 int* __restrict__ out) {
  out[threadIdx.x] = __ldg(tab + __ldg(idx + threadIdx.x));
}

extern "C" int mwf_probe_dep_floor(const int* tab, const int* idx, int* out,
                                   void* stream) {
  dep_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(tab, idx, out);
  return (int)cudaGetLastError();
}
