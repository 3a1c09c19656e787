// poly_dual_bitmap: q banded point-in-polygon queries -> the packed HIT and
// DECIDED bitmaps and the hit plane's (cnt, lo, hi) headers in one sweep of
// the point columns and one pass over the (chunk, query) pairs it finds.
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
// (chunk, query) pair where some row's env holds: the same bits. With ATTR
// (attr_plane.cuh: member, range, notmember, vocabmask over the rows' int32
// codes and one vector a query) the attribute test ANDs into env in the
// sweep, so into hit before decided derives from it, as the reference's
// _poly_mask_body(attr=...) combines it (hit & ~band): the band ring
// carries only rows that pass it, and a pair whose rows all fail it is not
// live. The sweep runs it only for a pair whose envelope test holds some
// row (an AND can only narrow the hits), and reads the chunk's codes the
// first time a query needs them (4 B a row of such chunks).
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
// The design: a sweep that finds the work, then a pass that spreads it over
// the grid. A chunk is kR = 4 consecutive 32-row words; lane l of a warp
// holds rows 32 j + l of it (j < kR), so each ballot is one packbits word.
//   * the sweep (poly_dual_bitmap_sweep_kernel<HAS_TIME>) gives a block's
//     warps kWarps consecutive chunks a step. A warp forms its chunk's
//     envelope (the exact int64 min and max of xk, yk, tk over its rows,
//     invalid rows included) with warp reductions; lane l tests query g + l
//     against it. For each surviving query it runs the envelope test of
//     every row: a pair whose envelope holds a row is live. The warp stages
//     its chunk's words of every query in shared memory: zeros for a
//     rejected or envelope-empty pair, and for a live pair its envelope
//     ballots in the hit words and a marker in the first decided word,
//     which are that pair's work item. The block then stores the step's
//     32 words of each query and plane as one 128-byte line (the earlier
//     design stored 16 bytes a query and chunk, and at q = 24 those scattered
//     stores took more time than the sweep's reads). The z2 / z3 segments
//     hold rows in z-key order, so a chunk covers a small area and most
//     pairs are rejected;
//   * the cast (poly_dual_bitmap_cast_kernel<STREAM>) deals the pairs out
//     over every warp of the resident grid: warp w of W reads the marker of
//     pairs p = (32 r + lane) W + w (p = chunk * q + query; a pair's marker
//     is read once, by the warp that owns it; kBatch rounds of loads go out
//     together) and runs the ray cast of each live one: its envelope words,
//     the chunk's f32 coordinates, the query's edges, then both planes'
//     words and the header. The jittered stars of a stream envelope the
//     same few hundred chunks, so in the earlier design the sweep warp of a chunk
//     held all of its queries' casts in turn (a few warps an SM busy, the
//     rest idle); dealt out by pair, the casts fill the grid. The list needs
//     no memory of its own: a live pair's output words hold it until the
//     cast overwrites them, so it holds every pair (q x chunks at most) and
//     none is dropped;
//   * the ray cast skips an edge whose y span misses the y range of the
//     pair's enveloped rows by more than 4 eps (it can neither straddle nor
//     band them), and the division and crossing test of an edge that no row
//     of the warp straddles (xint counts only where a row straddles); the
//     arithmetic of every value used is unchanged;
//   * the edges sit in shared memory, read as 16-byte broadcasts, when all
//     q queries' edges fit kTileEdges (STREAM = false); else (up to 4096
//     edges a query at q = 64: 4 MB) each warp reads its pair's query's
//     edges from L2 through L1, the same 16 bytes in every lane;
//   * the header accumulates (count, n - first, last + 1) per warp in
//     shared memory, then one atomic per field, block and query; the
//     launcher zeroes it and the last block of the cast, found by a
//     ticket, decodes it in place with the empty rule;
//   * each grid is the blocks the device holds at once (launch_grid.cuh).
// Measured by chip_smoke.py --ab on an NVIDIA H100 80GB HBM3 at 700 W,
// device time per call in turns on the same inputs (8M rows): z2 q=24
// E=16 0.115 ms against 0.296 for the earlier design (the sweep 0.061, the cast
// 0.055; bound 0.055 by bytes); z3 q=8 E=32 0.115 against 0.152 (the
// sweep 0.072, the cast 0.042; bound 0.065).
// Row counts are a multiple of 32 below 2^31.

#include <climits>
#include <cuda_runtime.h>

#include "attr_plane.cuh"
#include "launch_grid.cuh"

namespace {

constexpr int kR = 4;  // 32-row words per warp and chunk (rows per lane)
constexpr int kBatch = 4;  // check rounds of the cast whose loads go out together
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDesc = 6;  // (xmin, xmax, ymin, ymax, t_lo, t_hi) per query
constexpr int kMaxQ = 64;
constexpr int kTileEdges = 2048;  // 32 KB of float4 edges
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kLive = 0xffffffffu;  // a live pair's first decided word after the sweep

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

// Lane `lane` of the warp stores a chunk's words: lanes 0..kR-1 hit word
// j = lane, lanes kR..2kR-1 decided word j = lane - kR, words past the end
// skipped.
__device__ __forceinline__ void store_words(unsigned* __restrict__ hit_bits,
                                            unsigned* __restrict__ dec_bits, long long at,
                                            long long word0, long long nwords, int lane,
                                            unsigned hit_word, unsigned dec_word) {
  const int j = lane & (kR - 1);
  if (lane < 2 * kR && word0 + j < nwords) {
    (lane < kR ? hit_bits : dec_bits)[at + j] = lane < kR ? hit_word : dec_word;
  }
}

// The sweep: the block's warps take kWarps consecutive chunks a step (a
// block-uniform loop); each warp stages its chunk's words of every query in
// shared memory: zero for a rejected or envelope-empty pair, and for a live
// pair its envelope ballots (hit words) and kLive (first decided word). The
// block then stores the step's kWarps * kR consecutive words of each query
// and plane, a 128-byte line, with consecutive threads on consecutive words.
template <bool HAS_TIME, int ATTR>
__global__ void __launch_bounds__(kThreads) poly_dual_bitmap_sweep_kernel(
    const long long* __restrict__ xk, const long long* __restrict__ yk,
    const long long* __restrict__ tk, const unsigned char* __restrict__ valid, int q,
    const long long* __restrict__ boxes, const long long* __restrict__ wins,
    unsigned int* __restrict__ hit_bits, unsigned int* __restrict__ dec_bits, long long n,
    const int* __restrict__ codes, const void* __restrict__ qcodes, int kq) {
  constexpr int kStep = kWarps * kR;  // words a block step covers: a lane each
  static_assert(kStep == 32, "a block step stores one word a lane and line");
  __shared__ __align__(16) long long sdesc[kDesc * kMaxQ];
  __shared__ __align__(16) unsigned stage[2][kMaxQ][kStep];  // [plane][query][word]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < q; i += blockDim.x) {
    long long* d = sdesc + kDesc * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) d[c] = boxes[4 * i + c];
    d[4] = HAS_TIME ? wins[2 * i] : 0;
    d[5] = HAS_TIME ? wins[2 * i + 1] : 0;
  }
  __syncthreads();
  const long long nwords = n >> 5;
  const long long nchunks = (nwords + kR - 1) / kR;
  for (long long c0 = (long long)blockIdx.x * kWarps; c0 < nchunks;
       c0 += (long long)gridDim.x * kWarps) {
    const long long c = c0 + warp;
    if (c < nchunks) {  // warp-uniform
      const long long word0 = c * kR;
      long long x[kR], y[kR], t[kR];
      bool v[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        // a word past the end repeats word 0's keys (the envelope stays the
        // chunk's) and is invalid; it is never stored
        const bool in = word0 + j < nwords;
        const long long row = (word0 + (in ? j : 0)) * 32 + lane;
        x[j] = xk[row];
        y[j] = yk[row];
        t[j] = HAS_TIME ? tk[row] : 0;
        v[j] = in && valid[row] != 0;
      }
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
      // the reject, 32 queries at a time: lane l tests query g + l and
      // stages its zero words
      unsigned live[kMaxQ / 32];
#pragma unroll
      for (int g = 0; g < kMaxQ; g += 32) {
        const int i = g + lane;
        bool lv = false;
        if (i < q) {
          const longlong2* d = reinterpret_cast<const longlong2*>(sdesc + kDesc * i);
          const longlong2 bx = d[0], by = d[1];
          bool miss = (x1 < bx.x) | (x0 > bx.y) | (y1 < by.x) | (y0 > by.y);
          if (HAS_TIME) {
            const longlong2 tw = d[2];
            miss = miss | (t1 < tw.x) | (t0 > tw.y);
          }
          lv = !miss;
          *reinterpret_cast<uint4*>(&stage[0][i][warp * kR]) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(&stage[1][i][warp * kR]) = make_uint4(0u, 0u, 0u, 0u);
        }
        live[g / 32] = __ballot_sync(kFull, lv);
      }
      __syncwarp();  // the zero words are staged before a live pair's
      // the chunk's codes, read the first time a query's envelope test holds
      // a row of the chunk (warp-uniform)
      int cd[kR];
      bool have_codes = false;
      // the surviving queries, in turn (warp-uniform)
#pragma unroll
      for (int g = 0; g < kMaxQ / 32; ++g) {
        for (unsigned m = live[g]; m; m &= m - 1) {
          const int i = g * 32 + __ffs(m) - 1;
          const longlong2* d = reinterpret_cast<const longlong2*>(sdesc + kDesc * i);
          const longlong2 bx = d[0], by = d[1];
          const longlong2 tw = HAS_TIME ? d[2] : make_longlong2(0, 0);
          bool e[kR];
          bool any_row = false;
#pragma unroll
          for (int j = 0; j < kR; ++j) {
            e[j] = v[j] & (x[j] >= bx.x) & (x[j] <= bx.y) & (y[j] >= by.x) & (y[j] <= by.y);
            if (HAS_TIME) e[j] = e[j] & (t[j] >= tw.x) & (t[j] <= tw.y);
            any_row |= e[j];
          }
          if (ATTR != attr_plane::kNone && __any_sync(kFull, any_row)) {
            if (!have_codes) {
#pragma unroll
              for (int j = 0; j < kR; ++j) {
                cd[j] = codes[(word0 + (word0 + j < nwords ? j : 0)) * 32 + lane];
              }
              have_codes = true;
            }
            attr_plane::and_test<ATTR, kR>(e, cd, qcodes, i, kq);
          }
          unsigned env[kR];
          unsigned any = 0;
#pragma unroll
          for (int j = 0; j < kR; ++j) {
            env[j] = __ballot_sync(kFull, e[j]);
            any |= env[j];
          }
          if (any && lane < kR) {
            unsigned hw = 0;
#pragma unroll
            for (int j = 0; j < kR; ++j) {
              if (lane == j) hw = env[j];
            }
            stage[0][i][warp * kR + lane] = hw;
            if (lane == 0) stage[1][i][warp * kR] = kLive;
          }
        }
      }
    }
    __syncthreads();
    // the step's words: a warp stores one (plane, query) line at a time,
    // lane l its word l
    const long long word = c0 * kR + lane;
    for (int r = warp; r < 2 * q; r += kWarps) {
      const int plane = r >= q;
      const int i = r - plane * q;
      if (word < nwords) {
        (plane ? dec_bits : hit_bits)[(long long)i * nwords + word] = stage[plane][i][lane];
      }
    }
    __syncthreads();  // the stage is stored before the next step's
  }
}

// Crossing counts and band flags of a lane's kR rows over m edges. Every
// lane of the warp calls it with the same edges, and with [ylo, yhi] the
// range of the y of the rows that count (NaN left out).
__device__ __forceinline__ void ray_cast(const float4* __restrict__ e, int m, const float* fx,
                                         const float* fy, float ylo, float yhi, int* cr,
                                         bool* band) {
  const float eps = (float)1e-4;
  const float keps = (float)(1e-4 * 16.0);
  // An edge whose y span, widened by kReach, misses [ylo, yhi] neither
  // straddles a row (that takes y1 > y >= y2 or y2 > y >= y1) nor puts it
  // in the vertex band (|y - y1| < eps needs |y - y1| below 4 eps before
  // rounding; the rounded bound misses by at most one ulp of y1, and a gap
  // of one ulp or more is exact), so it adds nothing and is skipped.
  const float kReach = 4.f * eps;
  for (int k = 0; k < m; ++k) {
    const float4 ed = e[k];  // (x1, y1, x2, y2)
    if (ed.x == ed.z && ed.y == ed.w) continue;
    if (yhi < __fsub_rn(fminf(ed.y, ed.w), kReach) ||
        ylo > __fadd_rn(fmaxf(ed.y, ed.w), kReach)) {
      continue;
    }
    bool straddle[kR];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      straddle[j] = (ed.y > fy[j]) != (ed.w > fy[j]);
      any |= straddle[j];
      const bool near = (fabsf(__fsub_rn(fy[j], ed.y)) < eps) |
                        (fabsf(__fsub_rn(fy[j], ed.w)) < eps);
      band[j] = band[j] | near;
    }
    // crossing and nearx hold only where the row straddles the edge
    if (!__any_sync(kFull, any)) continue;
    const float dy = ed.w == ed.y ? 1.f : __fsub_rn(ed.w, ed.y);
    const float dx = __fsub_rn(ed.z, ed.x);
    const float tol =
        __fmul_rn(keps, __fadd_rn(1.f, __fdiv_rn(fabsf(dx), fmaxf(fabsf(dy), eps))));
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const float xint = __fadd_rn(ed.x, __fmul_rn(__fdiv_rn(__fsub_rn(fy[j], ed.y), dy), dx));
      cr[j] += (int)(straddle[j] & (fx[j] < xint));
      const bool nearx = straddle[j] & (fabsf(__fsub_rn(fx[j], xint)) < tol);
      band[j] = band[j] | nearx;
    }
  }
}

// The header's shared partials: [warps, q, 3] ints, then the edges.
__host__ __device__ __forceinline__ size_t edge_offset(int q) {
  return ((size_t)3 * kWarps * q * sizeof(int) + 15) & ~(size_t)15;
}

// The cast: every live pair's ray cast, both planes' words and the header.
// Four blocks an SM (at most 64 registers) ran 1-2% faster than the three
// that 75 registers allow.
template <bool STREAM>
__global__ void __launch_bounds__(kThreads, 4) poly_dual_bitmap_cast_kernel(
    const float* __restrict__ xf, const float* __restrict__ yf,
    const float4* __restrict__ edges, int q, int ecap, unsigned int* __restrict__ hit_bits,
    unsigned int* __restrict__ dec_bits, int* __restrict__ hdr, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* acc = (int*)smem;  // [warps, q, 3]: cnt, n - first, last + 1
  float4* sedge = (float4*)(smem + edge_offset(q));
  __shared__ int s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 3 * kWarps * q; i += blockDim.x) acc[i] = 0;
  if (!STREAM) {
    for (int i = threadIdx.x; i < q * ecap; i += blockDim.x) sedge[i] = edges[i];
  }
  __syncthreads();
  int* wacc = acc + 3 * warp * q;
  const int rows = (int)n;
  const long long nwords = n >> 5;
  const long long nchunks = (nwords + kR - 1) / kR;
  const long long pairs = nchunks * q;
  const long long w = (long long)blockIdx.x * kWarps + warp;
  const long long nw = (long long)gridDim.x * kWarps;
  // the loop is warp-uniform: lane 0 holds the first pair of the batch's
  // first round; a batch's kBatch rounds issue their loads together
  for (long long r0 = 0; r0 * nw + w < pairs; r0 += 32 * kBatch) {
    long long pb[kBatch];
    unsigned mark[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      pb[b] = (r0 + 32 * b + lane) * nw + w;
      mark[b] = 0u;
      if (pb[b] < pairs) {  // pairs < 2^30: 32-bit division
        const unsigned c = (unsigned)pb[b] / (unsigned)q;
        mark[b] = dec_bits[((long long)pb[b] - (long long)c * q) * nwords + (long long)c * kR];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      for (unsigned m = __ballot_sync(kFull, mark[b] == kLive); m; m &= m - 1) {
        const long long pp = __shfl_sync(kFull, pb[b], __ffs(m) - 1);
        const long long c = (unsigned)pp / (unsigned)q;
        const int i = (int)(pp - c * q);
        const long long word0 = c * kR;
        const long long at = (long long)i * nwords + word0;
        bool env[kR];
        float fx[kR], fy[kR];
        float ylo = INFINITY, yhi = -INFINITY;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const bool in = word0 + j < nwords;
          env[j] = in && ((hit_bits[at + j] >> lane) & 1u);
          const long long row = (word0 + (in ? j : 0)) * 32 + lane;
          fx[j] = xf[row];
          fy[j] = yf[row];
          if (env[j]) {
            ylo = fminf(ylo, fy[j]);
            yhi = fmaxf(yhi, fy[j]);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          ylo = fminf(ylo, __shfl_xor_sync(kFull, ylo, o));
          yhi = fmaxf(yhi, __shfl_xor_sync(kFull, yhi, o));
        }
        int cr[kR];
        bool band[kR];
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          cr[j] = 0;
          band[j] = false;
        }
        ray_cast(STREAM ? edges + (long long)i * ecap : sedge + (long long)i * ecap, ecap, fx, fy,
                 ylo, yhi, cr, band);
        unsigned hb[kR], db[kR];
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const bool hit = env[j] & (((cr[j] & 1) != 0) | band[j]);
          hb[j] = __ballot_sync(kFull, hit);
          db[j] = __ballot_sync(kFull, hit & !band[j]);
        }
        unsigned hw = 0, dw = 0;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          if ((lane & (kR - 1)) == j) {
            hw = hb[j];
            dw = db[j];
          }
        }
        store_words(hit_bits, dec_bits, at, word0, nwords, lane, packbits_order(hw),
                    packbits_order(dw));
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
  }
  __syncthreads();
  for (int i = threadIdx.x; i < q; i += blockDim.x) {
    int cnt = 0, lo = 0, hi = 0;
    for (int wi = 0; wi < kWarps; ++wi) {
      const int* a = acc + 3 * (wi * q + i);
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

// blocks of the resident grid, at most `need`
template <typename Kernel>
cudaError_t grid_of(Kernel kern, size_t smem, long long need, long long* blocks) {
  const cudaError_t err = launch_grid::resident_blocks(kern, kThreads, smem, blocks);
  if (err != cudaSuccess) return err;
  if (*blocks > need) *blocks = need;
  if (*blocks < 1) *blocks = 1;
  return cudaSuccess;
}

template <bool HAS_TIME, int ATTR>
int launch(const void* xk, const void* yk, const void* tk, const void* valid, const void* xf,
           const void* yf, const void* edges, int q, int ecap, const void* boxes,
           const void* wins, void* hit_bits, void* dec_bits, void* hdr, long long n,
           const void* codes, const void* qcodes, int kq, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(hdr, 0, sizeof(int) * (3 * (size_t)q + 1), s);
  if (err != cudaSuccess) return (int)err;
  const long long nchunks = ((n >> 5) + kR - 1) / kR;
  auto sweep = poly_dual_bitmap_sweep_kernel<HAS_TIME, ATTR>;
  long long blocks = 0;
  err = grid_of(sweep, 0, (nchunks + kWarps - 1) / kWarps, &blocks);
  if (err != cudaSuccess) return (int)err;
  sweep<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const long long*)xk, (const long long*)yk, (const long long*)tk,
      (const unsigned char*)valid, q, (const long long*)boxes, (const long long*)wins,
      (unsigned int*)hit_bits, (unsigned int*)dec_bits, n, (const int*)codes, qcodes, kq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool stream = (long long)q * ecap > kTileEdges;
  auto cast = poly_dual_bitmap_cast_kernel<false>;
  if (stream) cast = poly_dual_bitmap_cast_kernel<true>;
  const size_t smem = edge_offset(q) + (stream ? 0 : sizeof(float4) * (size_t)q * ecap);
  err = grid_of(cast, smem, (nchunks * q + kWarps - 1) / kWarps, &blocks);
  if (err != cudaSuccess) return (int)err;
  cast<<<(unsigned)blocks, kThreads, smem, s>>>(
      (const float*)xf, (const float*)yf, (const float4*)edges, q, ecap,
      (unsigned int*)hit_bits, (unsigned int*)dec_bits, (int*)hdr, n);
  return (int)cudaGetLastError();
}

template <bool HAS_TIME>
int launch_attr(int attr, const void* xk, const void* yk, const void* tk, const void* valid,
                const void* xf, const void* yf, const void* edges, int q, int ecap,
                const void* boxes, const void* wins, void* hit_bits, void* dec_bits, void* hdr,
                long long n, const void* codes, const void* qcodes, int kq, cudaStream_t s) {
  switch (attr) {
    case attr_plane::kNone:
      return launch<HAS_TIME, attr_plane::kNone>(xk, yk, tk, valid, xf, yf, edges, q, ecap,
                                                 boxes, wins, hit_bits, dec_bits, hdr, n, codes,
                                                 qcodes, kq, s);
    case attr_plane::kMember:
      return launch<HAS_TIME, attr_plane::kMember>(xk, yk, tk, valid, xf, yf, edges, q, ecap,
                                                   boxes, wins, hit_bits, dec_bits, hdr, n,
                                                   codes, qcodes, kq, s);
    case attr_plane::kRange:
      return launch<HAS_TIME, attr_plane::kRange>(xk, yk, tk, valid, xf, yf, edges, q, ecap,
                                                  boxes, wins, hit_bits, dec_bits, hdr, n, codes,
                                                  qcodes, kq, s);
    case attr_plane::kNotMember:
      return launch<HAS_TIME, attr_plane::kNotMember>(xk, yk, tk, valid, xf, yf, edges, q, ecap,
                                                      boxes, wins, hit_bits, dec_bits, hdr, n,
                                                      codes, qcodes, kq, s);
    case attr_plane::kVocabMask:
      return launch<HAS_TIME, attr_plane::kVocabMask>(xk, yk, tk, valid, xf, yf, edges, q, ecap,
                                                      boxes, wins, hit_bits, dec_bits, hdr, n,
                                                      codes, qcodes, kq, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface for ctypes. Device pointers: xk, yk, tk int64[n] sort keys (tk
// and wins ignored when has_time is 0), valid bool[n], xf, yf float32[n];
// edges float32[q, ecap, 4] as (x1, y1, x2, y2); boxes int64[q, 4] as
// (xmin, xmax, ymin, ymax) keys, wins int64[q, 2]; outputs hit_bits,
// dec_bits u8[q, n/8] (16-byte aligned) and hdr int32[3 q + 1], whose first
// 3 q words become the [q, 3] header (the last is the launch's block
// ticket); the launcher initialises it; attr 0 (none: codes and qcodes
// ignored), 1 member or 3 notmember (qcodes int32[q, kq], kq <= 32), 2
// range (int32[q, 2]) or 4 vocabmask (u8[q, kq], kq <= 65536), with codes
// int32[n] (the attribute arguments come last, so a design without them
// takes the same call). 1 <= q <= 64; n is a multiple of 32 below 2^31.
// Launches on `stream` and returns a CUDA error code.
extern "C" int poly_dual_bitmap(int has_time, const void* xk, const void* yk, const void* tk,
                                const void* valid, const void* xf, const void* yf,
                                const void* edges, int q, int ecap, const void* boxes,
                                const void* wins, void* hit_bits, void* dec_bits, void* hdr,
                                long long n, void* stream, int attr, const void* codes,
                                const void* qcodes, int kq) {
  if (q < 1 || q > kMaxQ || ecap < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (has_time) {
    return launch_attr<true>(attr, xk, yk, tk, valid, xf, yf, edges, q, ecap, boxes, wins,
                             hit_bits, dec_bits, hdr, n, codes, qcodes, kq, s);
  }
  return launch_attr<false>(attr, xk, yk, nullptr, valid, xf, yf, edges, q, ecap, boxes, nullptr,
                            hit_bits, dec_bits, hdr, n, codes, qcodes, kq, s);
}
