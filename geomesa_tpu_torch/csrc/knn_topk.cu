// knn_topk: the k rows nearest a query point by f32 haversine distance, in
// ascending (distance, row) order.
//
// Replaces the device work of the reference's
// geomesa_tpu/parallel/executor.py _knn_fn (non-spmd edition: `dists`, an
// XLA f32 haversine of every row, +inf for invalid rows, then lax.top_k of
// -d). Per row r, in f32 with one rounding per operation (built with
// -fmad=false, full-precision sinf / cosf / asinf / sqrtf):
//   rx = x[r] * RAD, ry = y[r] * RAD, qxr = qx * RAD, qyr = qy * RAD
//   sdy = sinf((ry - qyr) * 0.5), sdx = sinf((rx - qxr) * 0.5)
//   a = sdy * sdy + ((cosf(ry) * cosf(qyr)) * sdx) * sdx
//   d = asinf(sqrtf(clamp(a, 0, 1))), +inf where valid[r] is 0
// with RAD = (float)(pi / 180). Since d >= 0, its f32 bits order as an
// unsigned integer, so the key (bits(d) << 32) | r is unique and sorts in
// exactly the order wanted: by distance, equal distances by row (the order
// lax.top_k(-d) gives; torch.topk promises none). A NaN distance takes one
// canonical NaN's bits (after +inf, by row) and -0.0 those of +0.0.
//
// Output: int64[k] rows (k <= n), every k answered: k >= the valid rows
// included (their +inf keys come last, by row).
//
// Bound on Hopper: one pass must read 9 B a row (x, y, valid; 8M rows: 72
// MB, 0.021 ms at 3.35 TB/s) and evaluate two sinf, a cosf, a sqrtf and an
// asinf a row: 92 FP32 instructions a row in the SASS of pass A below (the
// same 92 as the earlier designs'; 8M rows: 0.022 ms at the FP32 rate), so the
// operations bound it by a little. No implementation needs to write a
// row's key. Pass A's whole fast path is about 170 instructions a row, so
// the issue rate (one warp instruction a clock and scheduler) holds it
// near 0.045 ms at 8M rows whatever the memory does.
//
// The design: a threshold (radix) selection over the distance bits, then a
// sort of the few keys at or below the threshold.
//   * pass A (knn_topk_dist_kernel) is the only pass that evaluates the
//     haversine: it writes each row's 32 distance bits to a u32 column (4 B
//     a row) and counts them in a histogram of their bits 30..19 (the sign
//     bit is 0: the exponent and 4 mantissa bits, 16 buckets an octave) in
//     shared memory, one atomic per row, flushed with one atomic per
//     non-empty bucket and block; the last block to finish (a ticket) scans
//     the 4,096 buckets for the one that holds the kk-th key. (Rows that
//     share a bucket contend for one shared-memory word: a table of
//     identical points or of invalid rows is slower, never wrong; a
//     warp-uniform bucket test to aggregate them cost 3-5% on spread
//     points, so it went);
//   * pass B (knn_topk_compact_kernel) reads the column again and appends
//     the key of every row at or below that bucket to a candidate list
//     (one atomic per warp and 32 rows with a candidate): the kk keys
//     wanted and the rest of the boundary bucket, some hundreds to a few
//     thousand keys for spread points;
//   * the tail (knn_topk_tail_kernel) is a tree of block-local selections
//     over the candidates: each block sorts a tile of up to 16,384 keys in
//     shared memory with a bitonic network (a power of two at least the
//     tile's keys, so a short list sorts only its own size) and keeps the
//     first kr; the level whose keys fit one tile writes the rows. The
//     candidate count is known only on the device, so the launcher
//     launches the levels that n candidates would need (every point at one
//     place, kk = n: each a key of the boundary bucket) and a level reads
//     its count from device memory: a level after the one that finished
//     finds 0 keys and exits at once, and no launch waits for the host.
//     Above kRoundK keys the tail runs in rounds of at most kRoundK, each
//     selecting the smallest candidates above the last key of the round
//     before (read from device memory).
// Passes a call: A, B and, a round, the tail's levels: one, and one more
// while n candidates would leave more than one tile (k = 26 over 8M rows:
// 4 passes in all; k = 1125: 6), plus a memset of the state.
// Measured by chip_smoke.py --ab on an NVIDIA H100 80GB HBM3 at 700 W,
// device time per call in turns on the same inputs (8M rows): k = 1125
// 0.0994 ms against 1.092 for the earlier design's tile tree over the rows
// (torch.topk of the same distances, the selection alone: 0.213); k = 17 /
// 26 0.081 against 0.193 for its warp path (a sorted 32-key register list
// a warp), which is therefore gone. Pass A 0.064, B 0.012, the tail 0.024 at k = 1125 and
// 0.0065 at k = 26.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "launch_grid.cuh"

namespace {

typedef unsigned long long u64;

constexpr u64 kSentinel = ~0ull;
constexpr unsigned kNaNBits = 0x7fc00000u;
constexpr unsigned kFull = 0xffffffffu;
// the histogram: distance bits 30..19
constexpr int kBinShift = 19;
constexpr int kBins = 1 << (31 - kBinShift);
// passes A and B: blocks of kThreads, a lane takes kRows rows a step
constexpr int kThreads = 256;
constexpr int kRows = 4;
// the tail: tiles of kTile keys (128 KB of shared memory), rounds of at
// most kRoundK keys (a level keeps kr <= kTile / 2 keys a tile)
constexpr int kTile = 16384;
constexpr int kTailThreads = 1024;
constexpr long long kRoundK = kTile / 2;

// The launch's device state at the head of the scratch. The launcher zeroes
// it up to `level`.
struct State {
  unsigned hist[kBins];
  unsigned ticket;  // blocks of pass A done
  unsigned bound;   // the bucket that holds the kk-th key
  u64 count;        // candidates
  u64 level[2];     // keys of the tail's ping-pong levels
};
constexpr long long kStateWords = (sizeof(State) + 7) / 8;

__device__ __forceinline__ unsigned dist_bits(const float* __restrict__ xf,
                                              const float* __restrict__ yf,
                                              const unsigned char* __restrict__ valid,
                                              float qxr, float qyr, float cq, long long r) {
  const float rad = (float)(3.14159265358979323846 / 180.0);
  float d;
  if (valid[r]) {
    const float rx = __fmul_rn(xf[r], rad);
    const float ry = __fmul_rn(yf[r], rad);
    const float sdy = sinf(__fmul_rn(__fsub_rn(ry, qyr), 0.5f));
    const float sdx = sinf(__fmul_rn(__fsub_rn(rx, qxr), 0.5f));
    float a = __fadd_rn(__fmul_rn(sdy, sdy),
                        __fmul_rn(__fmul_rn(__fmul_rn(cosf(ry), cq), sdx), sdx));
    // clip as jnp.clip / torch.clamp do: NaN passes through
    a = a < 0.f ? 0.f : (a > 1.f ? 1.f : a);
    d = asinf(sqrtf(a));
  } else {
    d = INFINITY;
  }
  unsigned bits = __float_as_uint(d);
  if (d != d) bits = kNaNBits;
  if (d == 0.f) bits = 0u;
  return bits;
}

// Pass A: every row's distance bits to dist[r] and the histogram of their
// buckets; the last block writes the bucket of the kk-th key to st->bound.
__global__ void __launch_bounds__(kThreads) knn_topk_dist_kernel(
    const float* __restrict__ xf, const float* __restrict__ yf,
    const unsigned char* __restrict__ valid, float qx, float qy, long long n, long long kk,
    unsigned* __restrict__ dist, State* __restrict__ st) {
  __shared__ unsigned h[kBins];
  __shared__ unsigned part[kThreads / 32];
  __shared__ bool s_last;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const float rad = (float)(3.14159265358979323846 / 180.0);
  const float qxr = __fmul_rn(qx, rad);
  const float qyr = __fmul_rn(qy, rad);
  const float cq = cosf(qyr);
  // a lane's kRows rows a step, 32 apart, so that each store is coalesced
  for (long long base = warp * 32 * kRows; base < n; base += nwarps * 32 * kRows) {
    unsigned bits[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long r = base + j * 32 + lane;
      bits[j] = r < n ? dist_bits(xf, yf, valid, qxr, qyr, cq, r) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long r = base + j * 32 + lane;
      if (r < n) {
        dist[r] = bits[j];
        atomicAdd(&h[bits[j] >> kBinShift], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    if (h[i]) atomicAdd(&st->hist[i], h[i]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&st->ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: thread t holds buckets [t * per, (t + 1) * per); the
  // one whose range crosses kk finds the bucket (the counts sum to n >= kk)
  constexpr int per = kBins / kThreads;
  unsigned c[per];
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < per; ++i) {
    c[i] = __ldcg(&st->hist[threadIdx.x * per + i]);
    sum += c[i];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) part[threadIdx.x >> 5] = incl;
  __syncthreads();
  long long cum = incl - sum;
  for (int w = 0; w < (int)(threadIdx.x >> 5); ++w) cum += part[w];
  if (cum < kk && kk <= cum + sum) {
#pragma unroll
    for (int i = 0; i < per; ++i) {
      if (cum < kk && kk <= cum + c[i]) st->bound = threadIdx.x * per + i;
      cum += c[i];
    }
  }
}

// Pass B: the key of every row in a bucket at or below st->bound, appended
// to cands (st->count of them).
__global__ void __launch_bounds__(kThreads) knn_topk_compact_kernel(
    const unsigned* __restrict__ dist, long long n, State* __restrict__ st,
    u64* __restrict__ cands) {
  const unsigned bound = st->bound;
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (long long base = warp * 32 * kRows; base < n; base += nwarps * 32 * kRows) {
    unsigned bits[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long r = base + j * 32 + lane;
      bits[j] = r < n ? __ldcs(dist + r) : kFull;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long r = base + j * 32 + lane;
      const bool take = r < n && (bits[j] >> kBinShift) <= bound;
      const unsigned m = __ballot_sync(kFull, take);
      if (!m) continue;
      u64 pos = 0;
      if (lane == 0) pos = atomicAdd(&st->count, (u64)__popc(m));
      pos = __shfl_sync(kFull, pos, 0);
      if (take) cands[pos + __popc(m & below)] = ((u64)bits[j] << 32) | (u64)(unsigned)r;
    }
  }
}

// Sorts s[0..S) ascending (S a power of two) with every thread of the block.
__device__ void bitonic_sort(u64* s, int S) {
  const int half = S >> 1;
  for (int k2 = 2; k2 <= S; k2 <<= 1) {
    for (int j = k2 >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < half; i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const u64 a = s[lo], b = s[hi];
        const bool up = (lo & k2) == 0;
        if ((a > b) == up) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// One tail level over the *count_in keys of `in`: tile t (kTile keys) ->
// its m smallest to out[t * m ..), and the keys written to *count_out;
// the level whose keys fit one tile writes the m smallest to keys_out and
// their rows to rows, and 0 to *count_out (the later levels find no keys).
// With lo_key (a round after the first), keys not above it are dropped.
__global__ void __launch_bounds__(kTailThreads) knn_topk_tail_kernel(
    const u64* __restrict__ in, const u64* __restrict__ count_in,
    const u64* __restrict__ lo_key, int m, u64* __restrict__ out, u64* __restrict__ count_out,
    u64* __restrict__ keys_out, long long* __restrict__ rows) {
  extern __shared__ u64 s[];
  const long long count = (long long)*count_in;
  const long long tiles = (count + kTile - 1) / kTile;
  if (blockIdx.x == 0 && threadIdx.x == 0) *count_out = tiles > 1 ? (u64)(tiles * m) : 0ull;
  const u64 lo = lo_key ? *lo_key : 0ull;
  // the loop is block-uniform
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * kTile;
    const int len = (int)(count - base < kTile ? count - base : kTile);
    int S = 64;
    while (S < len || S < m) S <<= 1;
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      u64 key = i < len ? in[base + i] : kSentinel;
      if (lo_key && key <= lo) key = kSentinel;
      s[i] = key;
    }
    __syncthreads();
    bitonic_sort(s, S);
    if (tiles == 1) {
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        keys_out[i] = s[i];
        rows[i] = (long long)(s[i] & 0xffffffffull);
      }
    } else {
      for (int i = threadIdx.x; i < m; i += blockDim.x) out[t * m + i] = s[i];
    }
    __syncthreads();  // the tile is read before the next one is loaded
  }
}

// Where each part of the scratch starts.
struct Layout {
  State* st;
  unsigned* dist;  // [n]
  u64* cands;      // [n]
  u64* buf[2];     // [cap] each: the tail's ping-pong levels
  u64* keys;       // [kk]: the rounds' keys
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// keys a tail level writes at most (the first level of a round, when n
// candidates do not fit one tile)
long long tail_cap(long long n, long long kk) {
  const long long tiles = ceil_div(n, kTile);
  return tiles > 1 ? tiles * (kk < kRoundK ? kk : kRoundK) : 0;
}

Layout layout(void* scratch, long long n, long long kk) {
  u64* w = (u64*)scratch;
  Layout l;
  l.st = (State*)w;
  w += kStateWords;
  l.dist = (unsigned*)w;
  w += (n + 1) / 2;
  l.cands = w;
  w += n;
  const long long cap = tail_cap(n, kk);
  l.buf[0] = w;
  l.buf[1] = w + cap;
  l.keys = w + 2 * cap;
  return l;
}

// blocks of a pass over n rows of kThreads * kRows a step: the resident
// ones, at most one step each
template <typename Kernel>
cudaError_t row_blocks(Kernel kern, long long n, long long* blocks) {
  const cudaError_t err = launch_grid::resident_blocks(kern, kThreads, 0, blocks);
  if (err != cudaSuccess) return err;
  const long long need = ceil_div(n, (long long)kThreads * kRows);
  if (*blocks > need) *blocks = need;
  if (*blocks < 1) *blocks = 1;
  return cudaSuccess;
}

}  // namespace

// Scratch the launcher needs, in 8-byte words: the state, the distance
// column, the candidate list, the tail's two ping-pong buffers and the
// rounds' kk keys.
extern "C" long long knn_topk_scratch(long long n, long long k) {
  const long long kk = k < n ? k : n;
  if (kk <= 0) return 0;
  return kStateWords + (n + 1) / 2 + n + 2 * tail_cap(n, kk) + kk;
}

// C interface for ctypes. Device pointers: xf, yf float32[n], valid
// bool[n]; scratch int64[knn_topk_scratch(n, k)]; out int64[min(k, n)],
// the rows in ascending (distance, row) order. qx, qy the query point in
// degrees (f32). n < 2^31. Launches on `stream`, sets the host's *passes to
// the kernel launches it made, and returns a CUDA error code.
extern "C" int knn_topk(const void* xf, const void* yf, const void* valid, float qx, float qy,
                        long long n, long long k, void* scratch, void* out, void* stream,
                        long long* passes) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long kk = k < n ? k : n;
  *passes = 0;
  if (kk <= 0) return (int)cudaSuccess;
  const Layout l = layout(scratch, n, kk);
  long long* rows = (long long*)out;
  cudaError_t err = cudaMemsetAsync(l.st, 0, offsetof(State, level), s);
  if (err != cudaSuccess) return (int)err;
  long long blocks = 0;
  err = row_blocks(knn_topk_dist_kernel, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  knn_topk_dist_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const float*)xf, (const float*)yf, (const unsigned char*)valid, qx, qy, n, kk, l.dist,
      l.st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*passes;
  err = row_blocks(knn_topk_compact_kernel, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  knn_topk_compact_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(l.dist, n, l.st, l.cands);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*passes;
  const size_t smem = sizeof(u64) * kTile;
  err = cudaFuncSetAttribute(knn_topk_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  long long resident = 0;
  err = launch_grid::resident_blocks(knn_topk_tail_kernel, kTailThreads, smem, &resident);
  if (err != cudaSuccess) return (int)err;
  for (long long done = 0; done < kk;) {
    const long long kr = kk - done < kRoundK ? kk - done : kRoundK;
    const u64* in = l.cands;
    const u64* count_in = &l.st->count;
    // the levels n candidates would need: each finds its count on the device
    for (long long level = 0, worst = n;; ++level) {
      const long long tiles = ceil_div(worst, kTile);
      u64* to = l.buf[level & 1];
      u64* count_out = &l.st->level[level & 1];
      const long long grid = tiles < resident ? tiles : resident;
      knn_topk_tail_kernel<<<(unsigned)(grid > 0 ? grid : 1), kTailThreads, smem, s>>>(
          in, count_in, level == 0 && done ? l.keys + done - 1 : nullptr, (int)kr, to,
          count_out, l.keys + done, rows + done);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      ++*passes;
      if (tiles <= 1) break;
      worst = tiles * kr;
      in = to;
      count_in = count_out;
    }
    done += kr;
  }
  return (int)cudaSuccess;
}
