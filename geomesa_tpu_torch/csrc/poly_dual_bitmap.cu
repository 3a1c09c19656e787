// poly_dual_bitmap<HAS_TIME, STREAM>: q banded point-in-polygon queries ->
// the packed HIT and DECIDED bitmaps and the hit plane's (cnt, lo, hi)
// headers in ONE sweep of the point columns.
//
// Replaces the reference's geomesa_tpu/parallel/executor.py
// _poly_bitmap_batch_fn (an XLA lax.scan over the q queries of
// _poly_mask_body + _dual_bitmap_row + jnp.packbits; _poly_runs_fn and
// _poly_packed_fn, its single-query editions, are this kernel at q = 1 plus
// run-length encoding or packing in torch). Per row r and query i:
//   env[i, r] = valid[r] & box[i].xmin <= xk[r] <= box[i].xmax
//                        & box[i].ymin <= yk[r] <= box[i].ymax
//                        (& win[i].lo <= tk[r] <= win[i].hi when HAS_TIME)
// (inclusive int64 sort-key compares; `valid` is the temporal-valid column
// when HAS_TIME), and over the query's edges (x1, y1, x2, y2), in f32 with
// one rounding per operation (-fmad=false; IEEE division):
//   straddle = (y1 > yf) != (y2 > yf), dy = y2 - y1 (1 when y2 == y1)
//   xint     = x1 + ((yf - y1) / dy) * (x2 - x1)
//   cross    = straddle & xf < xint
//   near     = |yf - y1| < eps | |yf - y2| < eps
//   nearx    = straddle & |xf - xint| < keps * (1 + |x2 - x1| / max(|dy|, eps))
//   band    |= near | nearx
// with eps = (float)1e-4 and keps = (float)(1e-4 * 16.0); degenerate edges
// (x1 == x2 and y1 == y2: the batch's pad edges) add nothing and are
// skipped. hit = env & (odd crossings | band), decided = hit & ~band.
// Where env is false both planes are 0, so the edge loop runs only for a
// 32-row chunk of a warp where some row's env holds: the same bits.
// Outputs: hit and decided bits u8[q, n/8], MSB-first like jnp.packbits
// (byte j = rows 8j..8j+7, row 8j in bit 7); hdr int32[q, 3] = (count,
// first row, last row) of the HIT plane, no hit giving (0, 0, n - 1).
//
// Bound on Hopper: HBM for the sweep (17 B a row: two int64 keys and
// valid; 25 B with the time key) and the two planes' stores (q/4 B a row);
// the ray cast adds per edge and row of an enveloped chunk about ten f32
// operations and an IEEE division, and its f32 coordinates (8 B a row),
// which chip_smoke.py counts from this run's envelopes.
//
// The design is xz_dual_bitmap.cu's with exact_bitmap.cu's chunk reject:
//   * each warp takes a chunk of kR = 4 consecutive 32-row words; lane l
//     holds rows 32 j + l of it (j < kR), so each ballot is one packbits
//     word; lanes 0..kR-1 store the chunk's hit words and lanes kR..2kR-1
//     its decided words in one store instruction;
//   * the chunk's envelope (the exact int64 min and max of xk, yk, tk over
//     its rows, invalid rows included) is formed once with warp reductions;
//     lane l tests query g + l against it and stores the zero words of a
//     query whose box or window the envelope misses (no row of the chunk
//     can be enveloped); the warp then runs the envelope test and the ray
//     cast only for the surviving queries. The z2 / z3 segments hold rows in
//     z-key order, so a chunk covers a small area and most (chunk, query)
//     pairs are rejected: the ray cast runs on about the polygons'
//     envelope rows only;
//   * the chunk's f32 coordinates are read the first time a query's
//     envelope holds a row of it (a warp vote);
//   * the edges sit in shared memory, read as 16-byte broadcasts: all q
//     queries' edges when they fit kTileEdges (STREAM = false: the warps
//     run independently), else (STREAM = true, up to 4096 edges a query at
//     q = 64: 4 MB) each query's edges stream through a tile of kTileEdges
//     edges, the block's warps stepping through the queries together;
//   * the header accumulates (count, n - first, last + 1) per warp in
//     shared memory, then one atomic per field, block and query; the
//     launcher zeroes it and the last block, found by a ticket, decodes it
//     in place with the empty rule;
//   * the grid is the blocks the device holds at once (launch_grid.cuh).
// Row counts are a multiple of 32 below 2^31.

#include <climits>
#include <cuda_runtime.h>

#include "launch_grid.cuh"

namespace {

constexpr int kR = 4;  // 32-row words per warp and chunk (rows per lane)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDesc = 6;  // (xmin, xmax, ymin, ymax, t_lo, t_hi) per query
constexpr int kMaxQ = 64;
constexpr int kTileEdges = 2048;  // 32 KB of float4 edges
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned int packbits_order(unsigned int ballot) {
  // lane j -> bit 31-j, then reverse the byte order: byte 0 of the stored
  // word holds lanes 0..7 with lane 0 in its bit 7
  return __byte_perm(__brev(ballot), 0, 0x0123);
}

__device__ __forceinline__ long long join64(int hi, unsigned lo) {
  return (long long)(((unsigned long long)(unsigned)hi << 32) | lo);
}

// Exact int64 min / max over the warp: the signed high words first, then
// the unsigned low words of the lanes that hold the extreme high word.
__device__ __forceinline__ long long warp_min(long long v) {
  const int hi = (int)(v >> 32);
  const int mh = __reduce_min_sync(kFull, hi);
  return join64(mh, __reduce_min_sync(kFull, hi == mh ? (unsigned)v : 0xffffffffu));
}

__device__ __forceinline__ long long warp_max(long long v) {
  const int hi = (int)(v >> 32);
  const int mh = __reduce_max_sync(kFull, hi);
  return join64(mh, __reduce_max_sync(kFull, hi == mh ? (unsigned)v : 0u));
}

// The edges' offset in the dynamic shared memory, in 8-byte words: after
// the descriptors and the warps' header slots, 16-byte aligned.
__host__ __device__ __forceinline__ long long edge_offset(int q) {
  const long long words = kDesc * (long long)q + (3LL * kWarps * q + 1) / 2;
  return (words + 1) & ~1LL;
}

// Crossing counts and band flags of a lane's kR rows over m edges.
__device__ __forceinline__ void ray_cast(const float4* __restrict__ e, int m, const float* fx,
                                         const float* fy, int* cr, bool* band) {
  const float eps = (float)1e-4;
  const float keps = (float)(1e-4 * 16.0);
  for (int k = 0; k < m; ++k) {
    const float4 ed = e[k];  // (x1, y1, x2, y2)
    if (ed.x == ed.z && ed.y == ed.w) continue;
    const float dy = ed.w == ed.y ? 1.f : __fsub_rn(ed.w, ed.y);
    const float dx = __fsub_rn(ed.z, ed.x);
    const float tol =
        __fmul_rn(keps, __fadd_rn(1.f, __fdiv_rn(fabsf(dx), fmaxf(fabsf(dy), eps))));
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const bool straddle = (ed.y > fy[j]) != (ed.w > fy[j]);
      const float xint = __fadd_rn(ed.x, __fmul_rn(__fdiv_rn(__fsub_rn(fy[j], ed.y), dy), dx));
      cr[j] += (int)(straddle & (fx[j] < xint));
      const bool near = (fabsf(__fsub_rn(fy[j], ed.y)) < eps) |
                        (fabsf(__fsub_rn(fy[j], ed.w)) < eps);
      const bool nearx = straddle & (fabsf(__fsub_rn(fx[j], xint)) < tol);
      band[j] = band[j] | near | nearx;
    }
  }
}

template <bool HAS_TIME, bool STREAM>
__global__ void __launch_bounds__(kThreads) poly_dual_bitmap_kernel(
    const long long* __restrict__ xk, const long long* __restrict__ yk,
    const long long* __restrict__ tk, const unsigned char* __restrict__ valid,
    const float* __restrict__ xf, const float* __restrict__ yf,
    const float4* __restrict__ edges, int q, int ecap, const long long* __restrict__ boxes,
    const long long* __restrict__ wins, unsigned int* __restrict__ hit_bits,
    unsigned int* __restrict__ dec_bits, int* __restrict__ hdr, long long n) {
  extern __shared__ __align__(16) long long smem[];
  long long* sdesc = smem;                          // [q, 6]
  int* acc = (int*)(smem + kDesc * q);              // [warps, q, 3]: cnt, n - first, last + 1
  float4* sedge = (float4*)(smem + edge_offset(q));
  __shared__ int s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < q; i += blockDim.x) {
    long long* d = sdesc + kDesc * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) d[c] = boxes[4 * i + c];
    d[4] = HAS_TIME ? wins[2 * i] : 0;
    d[5] = HAS_TIME ? wins[2 * i + 1] : 0;
  }
  for (int i = threadIdx.x; i < 3 * kWarps * q; i += blockDim.x) acc[i] = 0;
  if (!STREAM) {
    for (int i = threadIdx.x; i < q * ecap; i += blockDim.x) sedge[i] = edges[i];
  }
  __syncthreads();
  int* wacc = acc + 3 * warp * q;
  const int rows = (int)n;

  const long long nwords = n >> 5;
  const long long nchunks = (nwords + kR - 1) / kR;
  // every chunk is whole and every plane row starts 16-byte aligned: a
  // rejected query's kR zero words go out as one 16-byte store a plane
  const bool vec_store = (nwords % kR) == 0;
  // the block's warps take consecutive chunks; the loop is block-uniform
  for (long long c0 = (long long)blockIdx.x * kWarps; c0 < nchunks;
       c0 += (long long)gridDim.x * kWarps) {
    const long long c = c0 + warp;
    const bool in_chunk = c < nchunks;  // warp-uniform
    const long long word0 = c * kR;
    long long x[kR], y[kR], t[kR];
    float fx[kR], fy[kR];
    bool v[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      // a word past the end repeats word 0's keys (the envelope stays the
      // chunk's) and is invalid; it is never stored
      const bool in = in_chunk && word0 + j < nwords;
      const long long row = in_chunk ? (word0 + (in ? j : 0)) * 32 + lane : lane;
      x[j] = xk[row];
      y[j] = yk[row];
      t[j] = HAS_TIME ? tk[row] : 0;
      v[j] = in && valid[row] != 0;
      fx[j] = fy[j] = 0.f;
    }
    bool have_f = false;  // warp-uniform
    long long x0 = x[0], x1 = x[0], y0 = y[0], y1 = y[0], t0 = t[0], t1 = t[0];
#pragma unroll
    for (int j = 1; j < kR; ++j) {
      x0 = min(x0, x[j]);
      x1 = max(x1, x[j]);
      y0 = min(y0, y[j]);
      y1 = max(y1, y[j]);
      if (HAS_TIME) {
        t0 = min(t0, t[j]);
        t1 = max(t1, t[j]);
      }
    }
    x0 = warp_min(x0);
    x1 = warp_max(x1);
    y0 = warp_min(y0);
    y1 = warp_max(y1);
    if (HAS_TIME) {
      t0 = warp_min(t0);
      t1 = warp_max(t1);
    }
    // the reject, 32 queries at a time: lane l tests query g + l
    unsigned live[kMaxQ / 32];
#pragma unroll
    for (int g = 0; g < kMaxQ; g += 32) {
      const int i = g + lane;
      bool lv = false;
      if (g < q && i < q && in_chunk) {
        const longlong2* d = reinterpret_cast<const longlong2*>(sdesc + kDesc * i);
        const longlong2 bx = d[0], by = d[1];
        bool miss = (x1 < bx.x) | (x0 > bx.y) | (y1 < by.x) | (y0 > by.y);
        if (HAS_TIME) {
          const longlong2 tw = d[2];
          miss = miss | (t1 < tw.x) | (t0 > tw.y);
        }
        lv = !miss;
        if (miss) {
          unsigned int* oh = hit_bits + (long long)i * nwords + word0;
          unsigned int* od = dec_bits + (long long)i * nwords + word0;
          if (vec_store) {
            *reinterpret_cast<uint4*>(oh) = make_uint4(0u, 0u, 0u, 0u);
            *reinterpret_cast<uint4*>(od) = make_uint4(0u, 0u, 0u, 0u);
          } else {
            for (int j = 0; j < kR && word0 + j < nwords; ++j) oh[j] = od[j] = 0u;
          }
        }
      }
      live[g / 32] = __ballot_sync(kFull, lv);
    }
    for (int i = 0; i < q; ++i) {
      const bool lv = (live[i >> 5] >> (i & 31)) & 1u;  // warp-uniform
      if (!STREAM && !lv) continue;
      bool env[kR];
      bool any_row = false;
      const longlong2* d = reinterpret_cast<const longlong2*>(sdesc + kDesc * i);
      const longlong2 bx = d[0], by = d[1];
      const longlong2 tw = HAS_TIME ? d[2] : make_longlong2(0, 0);
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        env[j] = lv & v[j] & (x[j] >= bx.x) & (x[j] <= bx.y) & (y[j] >= by.x) & (y[j] <= by.y);
        if (HAS_TIME) env[j] = env[j] & (t[j] >= tw.x) & (t[j] <= tw.y);
        any_row |= env[j];
      }
      const bool cast = __any_sync(kFull, any_row);
      if (cast && !have_f) {
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const long long row = (word0 + (word0 + j < nwords ? j : 0)) * 32 + lane;
          fx[j] = xf[row];
          fy[j] = yf[row];
        }
        have_f = true;
      }
      int cr[kR];
      bool band[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        cr[j] = 0;
        band[j] = false;
      }
      if (STREAM) {
        if (__syncthreads_or(cast)) {
          for (int e0 = 0; e0 < ecap; e0 += kTileEdges) {
            const int m = min(kTileEdges, ecap - e0);
            __syncthreads();  // the previous tile is consumed
            for (int k = threadIdx.x; k < m; k += blockDim.x) {
              sedge[k] = edges[(long long)i * ecap + e0 + k];
            }
            __syncthreads();
            if (cast) ray_cast(sedge, m, fx, fy, cr, band);
          }
        }
        if (!lv) continue;
      } else if (cast) {
        ray_cast(sedge + (long long)i * ecap, ecap, fx, fy, cr, band);
      }
      unsigned hb[kR], db[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const bool hit = env[j] & (((cr[j] & 1) != 0) | band[j]);
        hb[j] = __ballot_sync(kFull, hit);
        db[j] = __ballot_sync(kFull, hit & !band[j]);
      }
      if (lane < 2 * kR) {
        const int j = lane & (kR - 1);
        unsigned word = 0;
#pragma unroll
        for (int jj = 0; jj < kR; ++jj) {
          if (j == jj) word = lane < kR ? hb[jj] : db[jj];
        }
        if (word0 + j < nwords) {
          unsigned int* plane = lane < kR ? hit_bits : dec_bits;
          plane[(long long)i * nwords + word0 + j] = packbits_order(word);
        }
      }
      unsigned any = 0;
#pragma unroll
      for (int j = 0; j < kR; ++j) any |= hb[j];
      if (any && lane == 0) {
        int cnt = 0, first = INT_MAX, last = -1;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          if (hb[j]) {
            const int base = (int)((word0 + j) * 32);
            cnt += __popc(hb[j]);
            first = min(first, base + __ffs(hb[j]) - 1);
            last = max(last, base + 31 - __clz(hb[j]));
          }
        }
        int* a = wacc + 3 * i;
        a[0] += cnt;
        a[1] = max(a[1], rows - first);
        a[2] = max(a[2], last + 1);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < q; i += blockDim.x) {
    int cnt = 0, lo = 0, hi = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int* a = acc + 3 * (w * q + i);
      cnt += a[0];
      lo = max(lo, a[1]);
      hi = max(hi, a[2]);
    }
    if (cnt) {
      atomicAdd(hdr + 3 * i, cnt);
      atomicMax(hdr + 3 * i + 1, lo);
      atomicMax(hdr + 3 * i + 2, hi);
    }
  }
  // the last block to finish decodes the header: (cnt, first, last), and
  // (0, 0, n - 1) for a query with no hit
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd((unsigned int*)(hdr + 3 * q), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < q; i += blockDim.x) {
    const int cnt = atomicOr(hdr + 3 * i, 0);
    const int lo = atomicOr(hdr + 3 * i + 1, 0);
    const int hi = atomicOr(hdr + 3 * i + 2, 0);
    hdr[3 * i + 1] = cnt ? rows - lo : 0;
    hdr[3 * i + 2] = cnt ? hi - 1 : rows - 1;
  }
}

template <bool HAS_TIME, bool STREAM>
int launch(const void* xk, const void* yk, const void* tk, const void* valid, const void* xf,
           const void* yf, const void* edges, int q, int ecap, const void* boxes,
           const void* wins, void* hit_bits, void* dec_bits, void* hdr, long long n,
           cudaStream_t s) {
  auto kern = poly_dual_bitmap_kernel<HAS_TIME, STREAM>;
  const size_t edge_slots = STREAM ? (size_t)kTileEdges : (size_t)q * ecap;
  const size_t smem = sizeof(long long) * (size_t)edge_offset(q) + sizeof(float4) * edge_slots;
  cudaError_t err = cudaMemsetAsync(hdr, 0, sizeof(int) * (3 * (size_t)q + 1), s);
  if (err != cudaSuccess) return (int)err;
  long long blocks = 0;
  err = launch_grid::resident_blocks(kern, kThreads, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)kThreads * kR;
  const long long need = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;
  kern<<<(unsigned)blocks, kThreads, smem, s>>>(
      (const long long*)xk, (const long long*)yk, (const long long*)tk,
      (const unsigned char*)valid, (const float*)xf, (const float*)yf, (const float4*)edges, q,
      ecap, (const long long*)boxes, (const long long*)wins, (unsigned int*)hit_bits,
      (unsigned int*)dec_bits, (int*)hdr, n);
  return (int)cudaGetLastError();
}

template <bool HAS_TIME>
int launch_mode(const void* xk, const void* yk, const void* tk, const void* valid,
                const void* xf, const void* yf, const void* edges, int q, int ecap,
                const void* boxes, const void* wins, void* hit_bits, void* dec_bits, void* hdr,
                long long n, cudaStream_t s) {
  if ((long long)q * ecap <= kTileEdges) {
    return launch<HAS_TIME, false>(xk, yk, tk, valid, xf, yf, edges, q, ecap, boxes, wins,
                                   hit_bits, dec_bits, hdr, n, s);
  }
  return launch<HAS_TIME, true>(xk, yk, tk, valid, xf, yf, edges, q, ecap, boxes, wins, hit_bits,
                                dec_bits, hdr, n, s);
}

}  // namespace

// C interface for ctypes. Device pointers: xk, yk, tk int64[n] sort keys (tk
// and wins ignored when has_time is 0), valid bool[n], xf, yf float32[n];
// edges float32[q, ecap, 4] as (x1, y1, x2, y2); boxes int64[q, 4] as
// (xmin, xmax, ymin, ymax) keys, wins int64[q, 2]; outputs hit_bits,
// dec_bits u8[q, n/8] (16-byte aligned) and hdr int32[3 q + 1], whose first
// 3 q words become the [q, 3] header (the last is the launch's block
// ticket); the launcher initialises it. 1 <= q <= 64; n is a multiple of 32
// below 2^31. Launches on `stream` and returns a CUDA error code.
extern "C" int poly_dual_bitmap(int has_time, const void* xk, const void* yk, const void* tk,
                                const void* valid, const void* xf, const void* yf,
                                const void* edges, int q, int ecap, const void* boxes,
                                const void* wins, void* hit_bits, void* dec_bits, void* hdr,
                                long long n, void* stream) {
  if (q < 1 || q > kMaxQ || ecap < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (has_time) {
    return launch_mode<true>(xk, yk, tk, valid, xf, yf, edges, q, ecap, boxes, wins, hit_bits,
                             dec_bits, hdr, n, s);
  }
  return launch_mode<false>(xk, yk, nullptr, valid, xf, yf, edges, q, ecap, boxes, nullptr,
                            hit_bits, dec_bits, hdr, n, s);
}
