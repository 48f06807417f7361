// W1 and W2: the traceback kernels for Hopper (sm_90a).
//
// W1, the CIGAR walker, replaces miniwfa_tpu/ops/traceback_device.py::
// _build_walk (both layouts), which the JAX package runs as a
// lax.while_loop under vmap.  The plain PyTorch twin is
// miniwfa_tpu_torch/ops/traceback_device.py::walk_plain; the semantic
// specification is the host walker miniwfa_tpu_torch/models/traceback.py::
// traceback_walk (reference wf_traceback, miniwfa.c:329-377).  Each lane
// walks its tb [S_CAP, W] bytes backwards (byte (t, d - anc) = transition
// into score t+1): match runs are consumed from the packed word streams
// (the characters ending at the cursor, XOR of the two sides, leading
// zeros = equal characters), a DP step decodes the tb byte exactly as the
// reference does (state / ext bits, per-state score decrement), runs are
// merged as they are pushed (wf_cigar_push1, miniwfa.c:51-62) and the
// leading overhang is pushed last (miniwfa.c:368-369).  Runs come out in
// input order (oldest first) from offset 0 of each lane's buffer.
//
// What bounds it: the walk is a chain of O(n/cpw + s) dependent steps, so
// it is latency-bound; its bytes (one tb byte a DP step, the two word
// streams) are a few hundred KB.  Two variants, picked from the shapes by
// ops/traceback_device.py::pick_variant:
//
// * walk_warp_kernel (long lanes: K1's tb, the main path and low-mem pass
//   2): one warp and one block per lane.  A DP step lowers the score row by
//   at least min(x, e1, e2) >= 1 and moves the diagonal by at most 1, so a
//   tile of TILE_R rows below the cursor by TILE_C columns around its
//   diagonal holds every byte the walk reads until it leaves the tile.
//   Each tile is one TMA 2-D tensor copy (cp.async.bulk.tensor over the
//   tb viewed as [B*S_CAP, W]) into shared memory, completing on an
//   mbarrier, double-buffered: past the middle of the current tile the one
//   below is issued, centred on the current diagonal; a step outside both
//   tiles (a long gap, or one gap step of more than TILE_R rows) waits for
//   a fresh one.  A DP step is then one shared-memory read instead of an
//   L2 miss.  Match runs are scanned by the whole warp: lane j takes the
//   word ending j*cpw characters below the cursor on both sides, a ballot
//   finds the first word that differs and __clz the character, so one
//   step covers 32*cpw characters.  The word streams are staged backwards
//   in double-buffered chunks by cp.async.bulk on mbarriers.  The newest
//   run is kept in registers (a merge reads nothing back); finished runs
//   are staged one per lane and written as whole 128-byte lines, and the
//   warp reverses them once at the end.  One warp per SM hides no
//   latency, so the walk state lives in registers and the common path is
//   kept short: a window check is two compares, a word fetch is
//   branch-free (with one bulk copy per tile row and the state in local
//   memory the main traceback took twice as long on an H100; PERF.md §6).
// * walk_thread_kernel (K3's many short gaps, walks of a few dozen steps,
//   where a warp and a tile per lane would cost more than the walk): one
//   thread per lane reading the tb and words from global memory, the
//   newest run kept in registers, runs reversed into input order at the
//   end.
//
// W2, mwf_chain_ptrs, replaces miniwfa_tpu/ops/traceback_device.py::
// _get_chain (a lax.scan; reference wf_traceback_seg, miniwfa.c:528-549):
// one thread per lane chases the low-mem snapshot rows from the newest to
// the oldest, each read depending on the one before, and writes the chain
// pointer at every row (-3 past the lane's count) and the final carry into
// one int64 [n_snap + 1, B] buffer that comes to the host in one copy.
// Bound: its dependent reads' latency, a few µs.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk.cuh"

namespace {

using namespace mwf;

enum { M_ANC, M_TL, M_QL, M_S, M_LS, M_N };
enum { OP_I = 1, OP_D = 2, OP_EQ = 7, OP_X = 8 };

constexpr int TILE_R = 64;    // tb rows of a tile, below the cursor
constexpr int TILE_C = 256;   // tb columns of a tile, around its diagonal
constexpr int N_BAR = 6;      // tb tiles 0-1, target halves 2-3, query 4-5
constexpr int SMEM_HEAD = 128;   // the barriers; tiles start 128-aligned
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const unsigned char* tb;  // [B, S_CAP, W]
  int S_CAP, W;
  const long long* meta;    // [B, M_N]
  const unsigned* tw;       // [B, nw] flat packed words
  const unsigned* qw;
  long long nw;
  int* runs;                // [B, cap] packed runs, input order
  int cap;
  int* counts;              // [B]; -1 = run-buffer overflow
  int B, cpw, x, o1, e1, o2, e2;
  int ch;                   // warp variant: words per chunk, a power of 2
};

// One DP step from the tb byte (7 bits) at the cursor; returns the op.
__device__ __forceinline__ int dp_step(int byte, int& i, int& k, int& srow,
                                       int& last, const Params& p) {
  const int state = last == 0 ? (byte & 7) : last;
  const int ext = state > 0 ? (byte >> (state + 2)) & 1 : 0;
  const bool is_x = state == 0, is_ins = state == 1 || state == 3;
  const bool pen1 = state == 1 || state == 2;
  if (is_x || is_ins) --i;
  if (is_x || !is_ins) --k;
  srow -= is_x ? p.x : (pen1 ? (ext ? p.e1 : p.o1 + p.e1)
                             : (ext ? p.e2 : p.o2 + p.e2));
  last = (state > 0 && ext) ? state : 0;
  return is_x ? OP_X : (is_ins ? OP_I : OP_D);
}

// The cpw characters ending at char `top` (>= 0), char `top` in the
// highest bits; characters below position 0 read as zeros.
__device__ __forceinline__ unsigned chars_before(const unsigned* w, int top,
                                                 int cpw, int logc,
                                                 int bits) {
  const int start = top - cpw + 1;
  if (start >= 0) {
    const int j = start >> logc;
    return __funnelshift_r(w[j], w[j + 1], (start & (cpw - 1)) * bits);
  }
  return w[0] << (-start * bits);
}

// ------------------------------------------------------------------ thread

// Runs of one thread's lane: buf[0, n-1) written newest first, run n-1
// kept in (op, len), so a merge reads nothing back.
struct ThreadRuns {
  int* buf;
  int cap, n, op, len;
  bool over;
  __device__ void push(int o, int l) {
    if (l <= 0) return;
    if (n > 0 && op == o) {
      len += l;
    } else if (n < cap) {
      if (n > 0) buf[n - 1] = (len << 4) | op;
      op = o;
      len = l;
      ++n;
    } else {
      over = true;
    }
  }
  // Write the last run, reverse buf[0, n) into input order; the count.
  __device__ int finish() {
    if (n > 0) buf[n - 1] = (len << 4) | op;
    for (int a = 0, z = n - 1; a < z; ++a, --z) {
      const int t = buf[a];
      buf[a] = buf[z];
      buf[z] = t;
    }
    return over ? -1 : n;
  }
};

__global__ void walk_thread_kernel(Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const long long* m = p.meta + (size_t)b * M_N;
  const int anc = (int)m[M_ANC], tl = (int)m[M_TL], ql = (int)m[M_QL];
  const unsigned char* tb = p.tb + (size_t)b * p.S_CAP * p.W;
  const unsigned* tw = p.tw + (size_t)b * p.nw;
  const unsigned* qw = p.qw + (size_t)b * p.nw;
  const int cpw = p.cpw, bits = 32 / cpw;
  const int logc = cpw == 16 ? 4 : 2, logb = cpw == 16 ? 1 : 3;
  ThreadRuns out{p.runs + (size_t)b * p.cap, p.cap, 0, 0, 0, false};

  int i = ql - 1, k = tl - 1, srow = (int)m[M_S] - 1, last = (int)m[M_LS];
  while (i >= 0 && k >= 0) {
    if (last == 0) {  // consume the match run ending at (k, i)
      int run = 0;
      while (i >= 0 && k >= 0) {
        const unsigned xr = chars_before(tw, k, cpw, logc, bits) ^
                            chars_before(qw, i, cpw, logc, bits);
        const int r = min(xr ? (__clz((int)xr) >> logb) : cpw, min(k, i) + 1);
        run += r;
        i -= r;
        k -= r;
        if (xr) break;
      }
      out.push(OP_EQ, run);
      if (i < 0 || k < 0) break;
    }
    const int col = min(max((i - k) - anc, 0), p.W - 1);
    const int sr = min(max(srow, 0), p.S_CAP - 1);
    const int byte = tb[(size_t)sr * p.W + col] & 0x7F;
    out.push(dp_step(byte, i, k, srow, last, p), 1);
  }
  out.push(OP_I, i + 1);  // leading overhang
  out.push(OP_D, k + 1);
  p.counts[b] = out.finish();
}

// -------------------------------------------------------------------- warp

// One box of the tensor map (the tb viewed as [B*S_CAP rows, W] bytes) at
// (col, row) into shared memory (128-byte aligned), completing on `bar`.
__device__ __forceinline__ void tile_copy(void* dst, const CUtensorMap* map,
                                          int col, int row,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// Before a bulk copy overwrites shared memory the warp read: order those
// generic-proxy reads before the async-proxy writes.
__device__ __forceinline__ void reuse_fence() {
  __syncwarp();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Two buffers filled by bulk copies, each with its barrier: bit h of
// `phase` is buffer h's phase parity, bit h of `busy` says a copy into it
// is in flight.  All lanes keep the same state, in registers (no array is
// indexed by a runtime value, so none goes to local memory).
struct Pair {
  unsigned long long* bar;
  unsigned phase, busy;
  __device__ void wait(int h) {
    if (!((busy >> h) & 1)) return;
    bar_wait(bar + h, (phase >> h) & 1);
    phase ^= 1u << h;
    busy &= ~(1u << h);
  }
};

// One side's packed words, staged backwards: chunk c (words [c*ch,
// (c+1)*ch)) lives in half c & 1 of 2*ch shared words, so word j sits at
// slot j & (2*ch - 1).
struct Stream {
  const unsigned* g;  // this lane's words; nw a multiple of 4
  unsigned* s;
  int nw, ch, logch;
  int chunk0, chunk1;  // the chunk each half holds, -1 for none
  Pair buf;
  // window() has nothing to do while wa >= fast_lo and wb >= fast_hi
  int fast_lo, fast_hi;

  __device__ int chunk(int h) const { return h ? chunk1 : chunk0; }
  __device__ void issue(int c, int lane) {
    const int h = c & 1, w0 = c * ch;
    const unsigned bytes = 4u * (unsigned)min(ch, nw - w0);
    reuse_fence();
    if (lane == 0) {
      bar_expect(buf.bar + h, bytes);
      bulk_copy(s + h * ch, g + w0, bytes, buf.bar + h);
    }
    if (h)
      chunk1 = c;
    else
      chunk0 = c;
    buf.busy |= 1u << h;
  }
  // Chunk c resident: its copy waited for, or issued and waited for.
  __device__ void ensure(int c, int lane) {
    const int h = c & 1;
    if (chunk(h) != c) {
      buf.wait(h);
      issue(c, lane);
    }
    buf.wait(h);
  }
  // Words [wa, wb] (wb - wa < ch) resident; once the window has left the
  // chunk above, the chunk below is issued into its half.  The window
  // only moves down, so nothing changes until it leaves chunk ca or, when
  // it straddles two chunks, until its top leaves chunk cb.
  __device__ void window(int wa, int wb, int lane) {
    if (wa >= fast_lo && wb >= fast_hi) return;
    const int ca = wa >> logch, cb = wb >> logch;
    ensure(cb, lane);
    if (ca != cb) {
      ensure(ca, lane);
    } else if (ca > 0 && chunk((ca - 1) & 1) != ca - 1) {
      buf.wait((ca - 1) & 1);
      issue(ca - 1, lane);
    }
    fast_lo = ca << logch;
    fast_hi = ca != cb ? cb << logch : -(1 << 30);
  }
  __device__ unsigned operator()(int j) const { return s[j & (2 * ch - 1)]; }
};

// The lane's tb in tiles of R rows by C columns (TILE_R by TILE_C, or the
// whole extent where it is smaller), double-buffered: the current tile in
// buffer `cur`, the other one in buffer cur ^ 1.
struct Tiles {
  const CUtensorMap* map;  // the tb as [B*S_CAP rows, W], boxes of R x C
  int base;                // this lane's first row there
  unsigned char* s;        // 2 buffers of TILE_R x TILE_C, rows C apart
  int S_CAP, W, R, C;
  int cur, lo, c0;  // the current tile: rows [lo, lo+R), cols [c0, c0+C)
  bool ok;          // ... once there is one
  int nlo, nc0;     // the other buffer's tile
  bool nok;
  Pair buf;

  // Rows [r0, r0 + R) around column `col` into buffer h; returns the
  // tile's first column.
  __device__ int issue(int h, int r0, int col, int lane) {
    const int c = min(max((col - C / 2) & ~15, 0), W - C);
    reuse_fence();
    if (lane == 0) {
      bar_expect(buf.bar + h, (unsigned)(R * C));
      tile_copy(s + h * TILE_R * TILE_C, map, c, base + r0, buf.bar + h);
    }
    buf.busy |= 1u << h;
    return c;
  }
  __device__ bool holds(bool v, int l, int c, int sr, int col) const {
    return v && sr >= l && sr < l + R && col >= c && col < c + C;
  }
  // The tb byte at (sr, col), both in range.
  __device__ int at(int sr, int col, int lane) {
    if (!holds(ok, lo, c0, sr, col)) {
      const int nx = cur ^ 1;
      if (!holds(nok, nlo, nc0, sr, col)) {  // outside both: a fresh tile
        buf.wait(nx);
        nlo = max(0, min(sr - R + 1, S_CAP - R));
        nc0 = issue(nx, nlo, col, lane);
        nok = true;
      }
      buf.wait(nx);
      const int l = lo, c = c0;
      const bool v = ok;
      lo = nlo;
      c0 = nc0;
      ok = nok;
      nlo = l;
      nc0 = c;
      nok = v;
      cur = nx;
    }
    const int v = s[cur * TILE_R * TILE_C + (sr - lo) * C + col - c0];
    // past the middle of the tile: issue the one below, centred here
    if (lo > 0 && sr < lo + R / 2 && !(nok && nlo < lo)) {
      buf.wait(cur ^ 1);
      nlo = max(0, lo - R);
      nc0 = issue(cur ^ 1, nlo, col, lane);
      nok = true;
    }
    return v;
  }
};

// chars_before for lane tops that may lie below 0 (0 there), without a
// branch that splits the warp: reads words max(top-cpw+1, 0) >> logc and
// the one after.
__device__ __forceinline__ unsigned chars_at(const Stream& w, int top,
                                             int cpw, int logc, int bits) {
  const int start = top - cpw + 1, pos = max(start, 0), j = pos >> logc;
  const unsigned v = __funnelshift_r(w(j), w(j + 1), (pos & (cpw - 1)) * bits)
                     << min(max(-start, 0) * bits, 31);
  return top >= 0 ? v : 0u;
}

// Runs of one warp's lane; every lane keeps the same (n, op, len), run
// n-1 in (op, len).  Finished run j is staged in lane j & 31's `line`;
// each full line is written as one 128-byte store, newest first.
struct WarpRuns {
  int* buf;
  int cap, n, op, len, line;
  bool over;
  __device__ void finish_run(int j, int lane) {
    line = lane == (j & 31) ? (len << 4) | op : line;
    if ((j & 31) == 31) buf[j - 31 + lane] = line;
  }
  __device__ void push(int o, int l, int lane) {
    if (l <= 0) return;
    if (n > 0 && op == o) {
      len += l;
    } else if (n < cap) {
      if (n > 0) finish_run(n - 1, lane);
      op = o;
      len = l;
      ++n;
    } else {
      over = true;
    }
  }
  // Write the last line, reverse buf[0, n) into input order; the count.
  __device__ int finish(int lane) {
    if (n > 0) finish_run(n - 1, lane);
    const int part = n & 31;
    if (lane < part) buf[n - part + lane] = line;
    __syncwarp();
    for (int a = lane; a < n / 2; a += 32) {
      const int z = n - 1 - a;
      const int t = buf[a];
      buf[a] = buf[z];
      buf[z] = t;
    }
    return over ? -1 : n;
  }
};

__global__ void __launch_bounds__(32)
    walk_warp_kernel(Params p, const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) unsigned char dyn[];
  // tensor copies land on 128-byte boundaries: align the base (the
  // launch asks for 128 bytes more)
  unsigned char* smem = dyn + ((128 - (smem_u32(dyn) & 127)) & 127);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* tiles = smem + SMEM_HEAD;
  unsigned* words =
      reinterpret_cast<unsigned*>(smem + SMEM_HEAD + 2 * TILE_R * TILE_C);
  const int lane = threadIdx.x, b = blockIdx.x;
  if (lane == 0) {
    for (int j = 0; j < N_BAR; ++j) bar_init(bar + j);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  const long long* m = p.meta + (size_t)b * M_N;
  const int anc = (int)m[M_ANC], tl = (int)m[M_TL], ql = (int)m[M_QL];
  const int cpw = p.cpw, bits = 32 / cpw;
  const int logc = cpw == 16 ? 4 : 2, logb = cpw == 16 ? 1 : 3;
  const int logch = 31 - __clz(p.ch);
  Tiles tb{&map, b * p.S_CAP, tiles, p.S_CAP, p.W, min(TILE_R, p.S_CAP),
           min(TILE_C, p.W), 0, 0, 0, false, 0, 0, false, {bar, 0u, 0u}};
  Stream tw{p.tw + (size_t)b * p.nw, words, (int)p.nw, p.ch, logch, -1, -1,
            {bar + 2, 0u, 0u}, 1 << 30, 0};
  Stream qw{p.qw + (size_t)b * p.nw, words + 2 * p.ch, (int)p.nw, p.ch,
            logch, -1, -1, {bar + 4, 0u, 0u}, 1 << 30, 0};
  WarpRuns out{p.runs + (size_t)b * p.cap, p.cap, 0, 0, 0, 0, false};

  int i = ql - 1, k = tl - 1, srow = (int)m[M_S] - 1, last = (int)m[M_LS];
  while (i >= 0 && k >= 0) {
    if (last == 0) {  // consume the match run ending at (k, i)
      int run = 0;
      while (true) {
        // words of the 32*cpw characters ending at each side's cursor
        tw.window(max(0, k - 32 * cpw + 1) >> logc,
                  (max(k - cpw + 1, 0) >> logc) + 1, lane);
        qw.window(max(0, i - 32 * cpw + 1) >> logc,
                  (max(i - cpw + 1, 0) >> logc) + 1, lane);
        const unsigned xr = chars_at(tw, k - lane * cpw, cpw, logc, bits) ^
                            chars_at(qw, i - lane * cpw, cpw, logc, bits);
        const unsigned diff = __ballot_sync(FULL, xr != 0);
        int r = 32 * cpw;
        if (diff) {
          const int f = __ffs((int)diff) - 1;
          r = f * cpw + (__clz((int)__shfl_sync(FULL, xr, f)) >> logb);
        }
        r = min(r, min(k, i) + 1);
        run += r;
        i -= r;
        k -= r;
        if (diff || i < 0 || k < 0) break;
      }
      out.push(OP_EQ, run, lane);
      if (i < 0 || k < 0) break;
    }
    const int col = min(max((i - k) - anc, 0), p.W - 1);
    const int sr = min(max(srow, 0), p.S_CAP - 1);
    const int byte = tb.at(sr, col, lane) & 0x7F;
    out.push(dp_step(byte, i, k, srow, last, p), 1, lane);
  }
  out.push(OP_I, i + 1, lane);  // leading overhang
  out.push(OP_D, k + 1, lane);
  const int n = out.finish(lane);
  if (lane == 0) p.counts[b] = n;
  // no copy may land in shared memory after the block has left
  for (int h = 0; h < 2; ++h) {
    tb.buf.wait(h);
    tw.buf.wait(h);
    qw.buf.wait(h);
  }
}

// ---------------------------------------------------------------- W2 chain

__global__ void chain_kernel(const int* snap, long long row, int cap,
                             const long long* lp_cnt, long long* out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long last = lp_cnt[b];
  const long long cnt = lp_cnt[B + b];
  const int* lane = snap + (size_t)b * cap * row;
  for (int i = 0; i < cap; ++i) {
    const int c = cap - 1 - i;
    const bool live = c < cnt;
    out[(size_t)(i + 1) * B + b] = live ? last : -3;
    if (live) last = lane[(size_t)c * row + min(max(last, 0LL), row - 1)];
  }
  out[b] = last;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The tb as a 2-D tensor of B*S_CAP rows of W bytes, in boxes of one
// tile (cuTensorMapEncodeTiled, from the driver through the runtime).
cudaError_t tile_map(CUtensorMap* map, const unsigned char* tb, int B,
                     int S_CAP, int W) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)B * S_CAP};
  const cuuint64_t stride[1] = {(cuuint64_t)W};
  const cuuint32_t box[2] = {(cuuint32_t)(W < TILE_C ? W : TILE_C),
                             (cuuint32_t)(S_CAP < TILE_R ? S_CAP : TILE_R)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (void*)tb, dims, stride, box,
      step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// variant 0: one thread per lane; 1: one warp per lane with chunks of `ch`
// words (a power of 2 >= 64; nw and W multiples of 4 and 16).
extern "C" int mwf_walk(const unsigned char* tb, int S_CAP, int W,
                        const long long* meta, const unsigned* tw,
                        const unsigned* qw, long long nw, int* runs, int cap,
                        int* counts, int B, int cpw, int x, int o1, int e1,
                        int o2, int e2, int variant, int ch, void* stream) {
  Params p{tb, S_CAP, W, meta, tw, qw, nw, runs, cap, counts,
           B, cpw, x, o1, e1, o2, e2, ch};
  if (variant == 0) {
    const int threads = 32;
    walk_thread_kernel<<<(B + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
  }
  CUtensorMap map;
  cudaError_t err = tile_map(&map, tb, B, S_CAP, W);
  if (err != cudaSuccess) return (int)err;
  const int smem = 128 + SMEM_HEAD + 2 * TILE_R * TILE_C + 2 * 2 * ch * 4;
  err = cudaFuncSetAttribute(
      walk_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  walk_warp_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(p, map);
  return (int)cudaGetLastError();
}

// W2: lp_cnt int64 [2, B] (last pointer, snapshot count); out int64
// [cap + 1, B]: the final carry, then the pointer at rows cap-1 .. 0.
extern "C" int mwf_chain_ptrs(const int* snap, long long row, int cap,
                              const long long* lp_cnt, long long* out, int B,
                              void* stream) {
  const int threads = 128;
  chain_kernel<<<(B + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(snap, row, cap, lp_cnt, out, B);
  return (int)cudaGetLastError();
}
