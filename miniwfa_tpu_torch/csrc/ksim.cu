// The k-mer similarity counts of a batch for Hopper (sm_90a): for each
// lane (target, query), the k-mer multiset intersection and each side's
// count of valid k-mers, from which the host takes
// max(shared / n1, shared / n2) (reference mwf_ksim, miniwfa.c:786-812).
//
// Replaces no TPU kernel: the JAX package computes the similarity on the
// host (miniwfa_tpu/ops/kmer.py::ksim, by sorting), and so did the port
// (ops/kmer.py::ksims) until the exact path's sizing (models/exact.py::
// _estimate_s) moved it here.  The card is idle while the host sizes a
// batch, and the work is integer counting.  The plain PyTorch twin is
// ops/kmer.py::ksim_counts_plain (a sort, as the host path).
//
// Input: every sequence of the launch's lanes joined into one byte buffer,
// and a [2L][2] int64 table of (offset, length), segment 2l the target and
// 2l + 1 the query of lane l.
//
// Design: one thread per position.  ksim_count_kernel's grid is (blocks
// over the longest segment, 2L segments); a block codes its 256 positions
// and the k - 1 before them into shared memory once (A/a 0, C/c 1, G/g 2,
// T/t/U/u 3, else 4), and each thread forms the k-mer that ends at its
// position, skipped if the window holds a code 4, as kmer.py::kmer_codes
// does.  The k-mer goes into an open-addressing hash table of full 64-bit
// keys, (lane << 2k | kmer) + 1 (0 marks an empty slot), with a uint32
// count per side: a slot is claimed by atomicCAS on its key and counted by
// atomicAdd, linear probing from a mixed hash.  The table holds a power of
// two of at least twice the launch's k-mers, so probes stay short, and
// keys never change once set, so a plain read that sees a key is exact and
// only a read of 0 goes to the atomic.  ksim_count_kernel is bound by
// those atomics' random accesses to the table (about 2 per k-mer, 16 bytes
// a slot).  ksim_reduce_kernel then sweeps the slots once (grid-stride):
// each occupied slot adds min(count_t, count_q), count_t and count_q to
// its lane's three sums in shared memory, and each block adds its nonzero
// sums into the [L][3] int64 output by one atomic each.  Integer counts:
// the result does not depend on the order of the atomics, nor on
// collisions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 15;
constexpr int MAX_L = 2048;   // [L][3] int64 sums: 48 KB of shared memory
constexpr int REDUCE_BLOCKS = 4 * 132;

__device__ __forceinline__ unsigned nt4(unsigned char c) {
  switch (c | 0x20) {   // sets only bit 5: exactly A/a, C/c, G/g, T/t, U/u
    case 'a': return 0;
    case 'c': return 1;
    case 'g': return 2;
    case 't':
    case 'u': return 3;
    default: return 4;
  }
}

__device__ __forceinline__ unsigned long long mix(unsigned long long h) {
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdull;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ull;
  h ^= h >> 33;
  return h;
}

__global__ void __launch_bounds__(THREADS)
ksim_count_kernel(const unsigned char* __restrict__ seq,
                  const long long* __restrict__ seg, int k,
                  unsigned long long* keys, unsigned* cnt,
                  unsigned long long mask) {
  __shared__ unsigned char code[THREADS + MAX_K];
  const int s = blockIdx.y;
  const long long off = seg[2 * s], len = seg[2 * s + 1];
  const long long base = (long long)blockIdx.x * THREADS;
  if (base >= len) return;   // uniform over the block
  for (int j = threadIdx.x; j < THREADS + k - 1; j += THREADS) {
    const long long p = base - (k - 1) + j;
    code[j] = p >= 0 && p < len ? nt4(seq[off + p]) : 4;
  }
  __syncthreads();
  const long long i = base + threadIdx.x;   // the window's last position
  if (i < k - 1 || i >= len) return;
  unsigned long long x = 0;
  unsigned bad = 0;
  for (int j = 0; j < k; ++j) {
    const unsigned c = code[threadIdx.x + j];
    bad |= c >> 2;
    x = (x << 2) | (c & 3);
  }
  if (bad) return;
  const unsigned long long key = ((unsigned long long)(s >> 1) << (2 * k) | x) + 1;
  unsigned* side = cnt + (s & 1) * (mask + 1);
  for (unsigned long long h = mix(key) & mask;; h = (h + 1) & mask) {
    unsigned long long cur = keys[h];
    if (cur == 0) cur = atomicCAS(keys + h, 0ull, key);
    if (cur == 0 || cur == key) {
      atomicAdd(side + h, 1u);
      return;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
ksim_reduce_kernel(const unsigned long long* __restrict__ keys,
                   const unsigned* __restrict__ cnt, long long size, int k,
                   int L, unsigned long long* out) {
  extern __shared__ unsigned long long acc[];   // [L][3]
  for (int j = threadIdx.x; j < 3 * L; j += THREADS) acc[j] = 0;
  __syncthreads();
  for (long long h = (long long)blockIdx.x * THREADS + threadIdx.x; h < size;
       h += (long long)gridDim.x * THREADS) {
    const unsigned long long key = keys[h];
    if (key == 0) continue;
    const unsigned lane = (unsigned)((key - 1) >> (2 * k));
    const unsigned a = cnt[h], b = cnt[size + h];
    if (a && b) atomicAdd(acc + 3 * lane, (unsigned long long)min(a, b));
    if (a) atomicAdd(acc + 3 * lane + 1, (unsigned long long)a);
    if (b) atomicAdd(acc + 3 * lane + 2, (unsigned long long)b);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * L; j += THREADS)
    if (acc[j]) atomicAdd(out + j, acc[j]);
}

}  // namespace

// seq: the joined bytes; seg int64 [2L][2] (offset, length) on the card;
// longest: the longest segment's length; keys uint64 [size] and cnt uint32
// [2][size], zeroed, size a power of two above the launch's k-mers; out
// int64 [L][3] (shared, n1, n2), zeroed.  1 <= k <= 15, 1 <= L <= 2048.
extern "C" int mwf_ksim(const unsigned char* seq, const long long* seg,
                        int L, long long longest, int k,
                        unsigned long long* keys, unsigned* cnt,
                        long long size, long long* out, void* stream) {
  if (k < 1 || k > MAX_K || L < 1 || L > MAX_L || size < 2 ||
      (size & (size - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (longest > 0) {
    const long long bx = (longest + THREADS - 1) / THREADS;
    if (bx > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    ksim_count_kernel<<<dim3((unsigned)bx, 2 * L), THREADS, 0, st>>>(
        seq, seg, k, keys, cnt, (unsigned long long)(size - 1));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long nb = (size + THREADS - 1) / THREADS;
  ksim_reduce_kernel<<<(unsigned)(nb < REDUCE_BLOCKS ? nb : REDUCE_BLOCKS),
                       THREADS, 3 * L * sizeof(unsigned long long), st>>>(
      keys, cnt, size, k, L, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
