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
// Output: int64[k] rows (k <= n). The launcher runs rounds of at most
// kRoundK keys; round j selects the kRoundK smallest keys above the last key
// of round j - 1 (read from device memory: no round waits for the host), so
// every k is answered, k >= the valid rows included (their +inf keys come
// last, by row).
//
// Bound on Hopper: one pass must read 9 B a row (x, y, valid; 8M rows: 72
// MB, 0.021 ms at 3.35 TB/s) and evaluate two sinf, a cosf, a sqrtf and an
// asinf a row: 92 FP32 instructions a row in this build's SASS (8M rows:
// 0.022 ms at the FP32 rate), so the operations bound it by a little. No
// implementation needs to write a row's key.
//
// The design. Up to kWarpK = 32 keys (the kNN's k plus its certificate's
// margin, for k up to 16) one pass reads the columns once: each warp walks
// its share of the rows 128 at a time (4 a lane) and keeps its 32 smallest
// keys so far in a register a lane, sorted across the lanes; a key is
// compared with the 32nd (one ballot for 32 rows) and only a smaller one
// is inserted (a ballot for its place and one shuffle), so after the first
// few steps nearly every row costs its distance and a compare. Each block
// merges its warps' lists in shared memory and writes its first k keys.
// Above 32 keys (and for the blocks' k keys), a
// round is a tree of block-local selections: each block takes a tile of S
// keys (the first pass computes them from the columns, rows past n and keys
// not above the last round's last key being the all-ones sentinel), sorts
// them in shared memory with a bitonic network and writes the first m =
// min(kr, S) of them; S is the power of two at least 4 kr (1024 to 16384),
// so each pass cuts the keys at least 4-fold up to kr = 4096 and 2-fold
// above; the pass whose keys fit one tile writes the round's rows. The
// sorting network's shared-memory traffic, not HBM, bounds that first pass
// (k = 1125 over 8M rows: 1.10 ms, 44x its bound): a faster one would
// select with a threshold (radix select) instead of sorting tiles.
// Measured by chip_smoke.py --ab on an H100 80GB HBM3 at 700 W, device time
// per call, in turns on the same inputs (k = 26 over 8M rows): the tile
// tree alone 0.55 ms, the warp path on the resident blocks with no block
// merge 0.210, with two blocks an SM 0.240, this design 0.190 (7.6x the
// bound chip_smoke.py counts: the pass is latency-bound, a warp inserting
// one key at a time).

#include <cuda_runtime.h>
#include <math.h>

#include "launch_grid.cuh"

namespace {

typedef unsigned long long u64;

constexpr u64 kSentinel = ~0ull;
constexpr long long kRoundK = 8192;  // keys selected per round
constexpr int kMinTile = 1024;
constexpr int kMaxTile = 16384;     // 128 KB of keys in shared memory
constexpr unsigned kNaNBits = 0x7fc00000u;
constexpr unsigned kFull = 0xffffffffu;
// the warp path: each warp keeps its 32 smallest keys, a lane takes
// kSelectRows rows a step, the grid is the resident blocks of 256 threads
constexpr int kWarpK = 32;
constexpr int kSelectThreads = 256;
constexpr int kSelectRows = 4;

__host__ __device__ inline int tile_of(long long kr) {
  long long s = kMinTile;
  while (s < 4 * kr && s < kMaxTile) s <<= 1;
  return (int)s;
}

__device__ __forceinline__ u64 row_key(const float* __restrict__ xf,
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
  return ((u64)bits << 32) | (u64)(unsigned)r;
}

__device__ void bitonic_sort(u64* s, int S);

// The warp path's pass: each block's kk smallest keys (kk <= kWarpK) to
// out[block * kk ..), sorted: its warps' 32 each, merged in shared memory.
__global__ void __launch_bounds__(kSelectThreads) knn_topk_warp_kernel(
    const float* __restrict__ xf, const float* __restrict__ yf,
    const unsigned char* __restrict__ valid, float qx, float qy, long long n, int kk,
    u64* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const float rad = (float)(3.14159265358979323846 / 180.0);
  const float qxr = __fmul_rn(qx, rad);
  const float qyr = __fmul_rn(qy, rad);
  const float cq = cosf(qyr);
  u64 best = kSentinel;  // lane i: the warp's i-th smallest key so far
  u64 thr = kSentinel;   // the 32nd smallest (lane 31's): warp-uniform
  const long long step = nwarps * 32 * kSelectRows;
  // the loop is warp-uniform: every ballot and shuffle below has all lanes
  for (long long base = warp * 32 * kSelectRows; base < n; base += step) {
    u64 key[kSelectRows];
#pragma unroll
    for (int j = 0; j < kSelectRows; ++j) {
      const long long r = base + j * 32 + lane;
      key[j] = r < n ? row_key(xf, yf, valid, qxr, qyr, cq, r) : kSentinel;
    }
#pragma unroll
    for (int j = 0; j < kSelectRows; ++j) {
      for (unsigned m = __ballot_sync(kFull, key[j] < thr); m; m &= m - 1) {
        const u64 v = __shfl_sync(kFull, key[j], __ffs(m) - 1);
        if (v >= thr) continue;  // an insertion before it raised the bar
        // keys are unique: the lanes above v are the first p.. 31
        const int p = __ffs(__ballot_sync(kFull, best > v)) - 1;
        const u64 prev = __shfl_up_sync(kFull, best, 1);
        best = lane > p ? prev : (lane == p ? v : best);
        thr = __shfl_sync(kFull, best, 31);
      }
    }
  }
  __shared__ u64 merged[kSelectThreads];
  merged[threadIdx.x] = best;
  __syncthreads();
  bitonic_sort(merged, kSelectThreads);
  if (threadIdx.x < kk) out[(long long)blockIdx.x * kk + threadIdx.x] = merged[threadIdx.x];
}

// Sorts s[0..S) ascending (S a power of two) with every thread of the block.
__device__ void bitonic_sort(u64* s, int S) {
  const int half = S >> 1;
  for (int k2 = 2; k2 <= S; k2 <<= 1) {
    for (int j = k2 >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < half; i += blockDim.x) {
        const int lo = 2 * j * (i / j) + (i % j);
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

// One block-local selection pass: tile t of S keys -> its m smallest, to
// out[t * m ..) (a middle pass) or, when `rows` is given (the last pass of
// a round, one tile), to keys_out[0..m) and their rows to rows[0..m).
template <bool FIRST>
__global__ void knn_topk_select_kernel(const float* __restrict__ xf, const float* __restrict__ yf,
                                  const unsigned char* __restrict__ valid, float qx, float qy,
                                  const u64* __restrict__ in, long long count,
                                  const u64* __restrict__ lo_key, int S, int m,
                                  u64* __restrict__ out, long long* __restrict__ rows) {
  extern __shared__ u64 s[];
  const long long base = (long long)blockIdx.x * S;
  if (FIRST) {
    const float rad = (float)(3.14159265358979323846 / 180.0);
    const float qxr = __fmul_rn(qx, rad);
    const float qyr = __fmul_rn(qy, rad);
    const float cq = cosf(qyr);
    const u64 lo = lo_key ? *lo_key : 0ull;
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      const long long r = base + i;
      u64 key = kSentinel;
      if (r < count) {
        key = row_key(xf, yf, valid, qxr, qyr, cq, r);
        if (lo_key && key <= lo) key = kSentinel;
      }
      s[i] = key;
    }
  } else {
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      const long long r = base + i;
      s[i] = r < count ? in[r] : kSentinel;
    }
  }
  __syncthreads();
  bitonic_sort(s, S);
  if (rows) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      out[i] = s[i];
      rows[i] = (long long)(s[i] & 0xffffffffull);
    }
  } else {
    for (int i = threadIdx.x; i < m; i += blockDim.x) out[(long long)blockIdx.x * m + i] = s[i];
  }
}

// keys a middle pass of a round of kr keys over `count` keys writes
long long pass_out(long long count, long long kr) {
  const int S = tile_of(kr);
  return (count + S - 1) / S * (kr < S ? kr : S);
}

template <bool FIRST>
cudaError_t launch_pass(long long tiles, int S, int m, const float* xf, const float* yf,
                        const unsigned char* valid, float qx, float qy, const u64* in,
                        long long count, const u64* lo_key, u64* out, long long* rows,
                        cudaStream_t s) {
  auto kern = knn_topk_select_kernel<FIRST>;
  const size_t smem = sizeof(u64) * (size_t)S;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = S / 2 < 1024 ? S / 2 : 1024;
  kern<<<(unsigned)tiles, threads, smem, s>>>(xf, yf, valid, qx, qy, in, count, lo_key, S, m, out,
                                              rows);
  return cudaGetLastError();
}

// Middle passes over the `count` keys of buf[cur] until one tile is left,
// whose pass writes the m keys to keys_out and their rows to rows_out; adds
// its launches to *passes.
cudaError_t reduce(u64* const buf[2], int cur, long long count, int S, int m, u64* keys_out,
                   long long* rows_out, cudaStream_t s, long long* passes) {
  for (;;) {
    const long long tiles = (count + S - 1) / S;
    const bool last = tiles == 1;
    const cudaError_t err =
        launch_pass<false>(tiles, S, m, nullptr, nullptr, nullptr, 0.f, 0.f, buf[cur], count,
                           nullptr, last ? keys_out : buf[1 - cur], last ? rows_out : nullptr, s);
    if (err == cudaSuccess) ++*passes;
    if (err != cudaSuccess || last) return err;
    count = tiles * m;
    cur = 1 - cur;
  }
}

// the blocks of the warp path's pass over n rows: the blocks the device
// holds at once (its latency, not the warps' insertions, bounds it: two
// blocks an SM ran k = 26 over 8M rows in 0.240 ms against 0.210 with all)
cudaError_t select_blocks(long long n, long long* blocks) {
  const cudaError_t err =
      launch_grid::resident_blocks(knn_topk_warp_kernel, kSelectThreads, 0, blocks);
  if (err != cudaSuccess) return err;
  const long long need = (n + kSelectThreads * kSelectRows - 1) / (kSelectThreads * kSelectRows);
  if (*blocks > need) *blocks = need;
  if (*blocks < 1) *blocks = 1;
  return cudaSuccess;
}

// the keys the first pass of any round writes: the full rounds' and the
// last round's (the warp path's: its warps' kk each)
long long pass_cap(long long n, long long kk) {
  if (kk <= 0) return 0;
  if (kk <= kWarpK) {
    long long blocks = 0;
    return select_blocks(n, &blocks) == cudaSuccess ? blocks * kk : -1;
  }
  const long long full = kk < kRoundK ? kk : kRoundK;
  const long long last = kk - (kk - 1) / kRoundK * kRoundK;
  const long long a = pass_out(n, full), b = pass_out(n, last);
  return a > b ? a : b;
}

}  // namespace

// Scratch the launcher needs, in 8-byte words: two ping-pong buffers for the
// middle passes and kk keys (the rounds' chaining).
extern "C" long long knn_topk_scratch(long long n, long long k) {
  const long long kk = k < n ? k : n;
  const long long cap = pass_cap(n, kk);
  return cap < 0 ? -1 : 2 * cap + (kk > 0 ? kk : 0);
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
  const long long cap = pass_cap(n, kk);
  if (cap < 0) return (int)cudaErrorInvalidDevice;
  u64* const buf[2] = {(u64*)scratch, (u64*)scratch + cap};
  u64* keys = (u64*)scratch + 2 * cap;
  long long* rows = (long long*)out;
  const float* x = (const float*)xf;
  const float* y = (const float*)yf;
  const unsigned char* v = (const unsigned char*)valid;
  if (kk <= kWarpK) {
    long long blocks = 0;
    cudaError_t err = select_blocks(n, &blocks);
    if (err != cudaSuccess) return (int)err;
    knn_topk_warp_kernel<<<(unsigned)blocks, kSelectThreads, 0, s>>>(x, y, v, qx, qy, n, (int)kk,
                                                                      buf[0]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*passes;
    return (int)reduce(buf, 0, blocks * kk, tile_of(kk), (int)kk, keys, rows, s, passes);
  }
  for (long long done = 0; done < kk;) {
    const long long kr = kk - done < kRoundK ? kk - done : kRoundK;
    const int S = tile_of(kr);
    const int m = (int)(kr < S ? kr : S);
    const u64* lo_key = done ? keys + done - 1 : nullptr;
    const long long tiles = (n + S - 1) / S;
    const bool last = tiles == 1;
    cudaError_t err = launch_pass<true>(tiles, S, m, x, y, v, qx, qy, nullptr, n, lo_key,
                                        last ? keys + done : buf[0], last ? rows + done : nullptr,
                                        s);
    if (err == cudaSuccess) ++*passes;
    if (err == cudaSuccess && !last) {
      err = reduce(buf, 0, tiles * m, S, m, keys + done, rows + done, s, passes);
    }
    if (err != cudaSuccess) return (int)err;
    done += kr;
  }
  return (int)cudaSuccess;
}
