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
//     (a gather loop's table rows or column strip, one [G, R, L] multi
//     tile of 128-144 KB, with the kernel opted in past 48 KB); P5's 13
//     planes stay on chip across a thread-block cluster, each CTA holding
//     its lanes' rows; larger tables stay in global memory (the [512, 128]
//     sublane table, the 3-slot multi rings);
//   * the loops that ran on one block use the whole card: a gather
//     loop's elements spread over >= 132 blocks where there are enough of
//     them, several chains a thread; P5's chunks side by side over the
//     cluster, one cluster barrier a round of chunks; the while loop's
//     state over 128 blocks of one warp (16 bytes a thread in each
//     block's shared memory); the row write's rows over 128 blocks, 16
//     bytes a thread a row by plain stores with no fence;
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
// ordering (the exchange has its own, on mbarriers)
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

template <int AXIS, int CH>
int launch_gather(const int* tab, const int* idx, int* out, int Rt, int Mt,
                  int Ri, int Mi, int blocks, int per, int splits, int smem,
                  int iters, int chain, int lim, int zero, cudaStream_t s) {
  cudaError_t err = opt_in((const void*)gather_kernel<AXIS, CH>, smem);
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

}  // namespace

// ----------------------------------------------------------- entry points
// Each launches on `stream` and returns cudaGetLastError(); shapes the
// kernel does not take return cudaErrorInvalidValue before any launch.

// A loop (iters > 1) runs on the plan (blocks, per, chains) of
// ops/probes.py::gather_plan: groups of `per` table rows (axis 1) or
// columns (axis 0), blocks / groups blocks a group, `chains` chains a
// thread (1, 2, 4 or 8).  One gather (iters == 1) takes no plan.
extern "C" int mwf_probe_gather(const int* tab, int Rt, int Mt,
                                const int* idx, int Ri, int Mi, int* out,
                                int axis, int iters, int chain, int lim,
                                int zero, int blocks, int per, int chains,
                                void* stream) {
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
  cudaError_t err = opt_in(fn, (int)smem);
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
