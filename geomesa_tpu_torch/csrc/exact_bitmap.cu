// exact_bitmap<HAS_TIME, REJECT, ATTR, MODE>: q exact bbox(+window)
// predicates, each with an optional attribute-code test, -> packed bitmaps
// and (cnt, lo, hi) headers in ONE sweep of the key columns; or, for one
// predicate, its hit count (exact_count) or its hit count and the per-code
// histogram of its hits (exact_stat_hist).
//
// Replaces the batched exact predicate of the reference's
// geomesa_tpu/parallel/executor.py _exact_bitmap_batch_fn (an XLA lax.scan
// over the q descriptors of ops/filters.py exact_st_mask + _span_bounds +
// _bitmap_frame_step + jnp.packbits), with its attribute plane
// (_exact_mask_body's `attr`, the combine of _attr_combine) fused in. The
// reference sweeps the key columns once per query; this kernel reads each
// row once for all q.
//
// Per row r and descriptor i (inclusive int64 sort-key compares):
//   m[i, r] = valid[r] & box[i].xmin <= xk[r] <= box[i].xmax
//                      & box[i].ymin <= yk[r] <= box[i].ymax
//                      (& win[i].lo <= tk[r] <= win[i].hi when HAS_TIME)
//                      (& attr(codes[r], qcodes[i]) when ATTR)
// where `valid` is the segment's temporal-valid column when HAS_TIME and
// the attribute editions (codes: int32 ranks into the segment's sorted
// value space, -1 for null, NaN and pad rows) are
//   kMember     codes[r] is one of qcodes[i, 0..K) (pads are -2);
//   kRange      qcodes[i, 0] <= codes[r] <= qcodes[i, 1] (no codes >= 0
//               guard: IS NULL is the interval [-1, -1]);
//   kNotMember  codes[r] >= 0 and none of qcodes[i, 0..K);
//   kVocabMask  codes[r] >= 0 and lut[i, min(codes[r], U_pad - 1)] != 0,
//               the u8 lookup table of the query in device memory (up to
//               64 KiB a query: it stays out of shared memory).
// The header is the combined mask's: the span window and every refetch
// follow it.
// Outputs: bits u8[q, n/8], MSB-first like jnp.packbits (byte j = rows
// 8j..8j+7, row 8j in bit 7); hdr int32[q, 3] = (count, first row, last
// row), with the reference's empty rule: no hit gives (0, 0, n - 1).
//
// Bound on Hopper: HBM at every q the paths launch. The sweep reads 25 B
// per row (three int64 keys and one bool; 17 B without the window; the
// attribute editions add the 4 B code of each row of a chunk whose box
// test holds a row of some query) and writes q/8 B per row. No exact implementation can skip a word's store,
// nor the compare chain of a 32-row word that holds a hit; chip_smoke.py
// exact_case counts that much work from the plain edition's bits.
//
// The first design (one row a thread per grid-stride step, one 8-byte load
// per column and thread in flight; per row and query the descriptor's 4-6
// int64 fields read again from shared memory; lane 0 alone storing the
// word and updating the warp's header slot while 31 lanes waited; every
// row tested against every query; a grid of 132 x 8 blocks) took 0.7124
// ms at z3 q = 20 against a 0.3348 ms operations bound, and 0.2748 ms at
// z2 q = 8 against a 0.1075 ms bytes bound, on an H100 80GB HBM3 at 700 W.
// This design:
//   * each warp takes a chunk of kR = 8 consecutive 32-row words; lane l
//     holds rows 32 j + l of it (j < kR), so each ballot is one packbits
//     word and a lane has kR rows of loads in flight per column (8 words
//     ran z3 q = 20 11% faster than 4, the other shapes within 1%);
//   * each descriptor is read from shared memory into registers once per
//     chunk (once more where it survives the reject below), as 16-byte
//     broadcasts;
//   * lanes 0..kR-1 store the chunk's kR words in one store instruction;
//     the warp's header slot in shared memory is touched only when the
//     chunk hits; at the end the block folds its warps' slots and issues
//     one atomic per header field and query;
//   * from kRejectMinQ queries up, the chunk's envelope (the exact int64
//     min and max of xk, yk and tk over its rows, invalid rows included)
//     is formed once per chunk with warp reductions; a query whose box or
//     window the envelope misses cannot hit any row of the chunk (the same
//     inclusive compares, so NaN keys, +-0.0, pads and invalid rows keep
//     their answer), and stores zero words without the row compares. The
//     z3 and z2 segments hold rows in z-key order, so a chunk covers a
//     tiny x/y/t envelope and most (chunk, query) pairs are rejected. The
//     lanes test 32 queries at once (lane l takes query g + l and stores
//     its zero words), and the warp scans only the survivors of a ballot,
//     so a rejected pair costs a lane's share of one pass, not a warp
//     step of its own;
//   * the launcher zeroes the header (one memset: count, n - first and
//     last + 1 accumulate with atomicAdd / atomicMax from 0) and the last
//     block to finish, found by a ticket, decodes it in place with the
//     empty rule, so the wrapper adds no launch of its own;
//   * the grid is the blocks the device holds at once, from its own SM
//     count and the instantiation's occupancy (launch_grid.cuh);
//   * the attribute test runs after the box test, only where the warp's
//     box test holds some row of the chunk (one vote): an AND can only
//     narrow the hits, so the chunk reject stays on the keys alone, and a
//     chunk's codes (128 B a word) are read the first time a query needs
//     them. The query's codes, interval or lookup entries are read through
//     the read-only cache (one broadcast address a warp for the codes and
//     the interval; a lookup entry per row that passes the box test).
// Its device times against the first design's, in turns on the same inputs
// (chip_smoke.py --ab), are in PERF.md. Row counts are a multiple of 32.
//
// The output modes (MODE) share the row loads and the test of one query
// (q = 1, so no chunk reject):
//   kBits        the bitmaps and headers above;
//   kCount       replaces the reference's _exact_count_fn (jnp.sum of the
//                exact(+attr) mask, "exact_count"): every edition of ATTR,
//                no bits stored, no header; each lane counts its rows, the
//                warp sums them (__reduce_add_sync), the block in shared
//                memory, and one atomicAdd a block goes into a zeroed
//                int32 that the caller reads after all its launches;
//   kHistShared, kHistGlobal
//                replace the reference's _exact_stat_hist_fn
//                ("exact_stat_hist"): ATTR = kNone, and for each hit row
//                its code (codes: the stats target's ranks, -1 for null)
//                counts in bin code of an int32[1 + u_pad] output after the
//                total in word 0; a null row counts in the total only. The
//                reference sorts the codes and searchsorts the bin bounds;
//                counts do not depend on order, so a histogram gives the
//                same integers. Up to kHistSmemCodes bins (32 KiB) each
//                block keeps a private histogram in shared memory, adds a
//                row step's equal codes of a warp as one shared atomic
//                (__match_any_sync: a low-cardinality column sends most of
//                a warp's rows to a few bins) and flushes its nonzero bins
//                with one global atomicAdd each; from there up to 65,536
//                bins (256 KiB, more than an SM holds) every hit row adds
//                into global memory directly.
// Both read each row's code only in a chunk where the box test holds some
// row (12 B a row more for nothing); bound: the key columns and valid once
// (25 B a row with the window, 17 B without) plus the 4 B code of the rows
// of such chunks.

#include <climits>
#include <cuda_runtime.h>

#include "attr_plane.cuh"
#include "launch_grid.cuh"

namespace {

using attr_plane::kMember;
using attr_plane::kNone;
using attr_plane::kNotMember;
using attr_plane::kRange;
using attr_plane::kVocabMask;

constexpr int kR = 8;  // 32-row words per warp and chunk (rows per lane)
static_assert(kR % 4 == 0, "a chunk's words are stored as 16-byte vectors");
constexpr int kThreads = 256;
constexpr int kDesc = 6;  // (xmin, xmax, ymin, ymax, t_lo, t_hi) per query
constexpr unsigned kFull = 0xffffffffu;
// The chunk reject runs from this many queries up: at q = 1 its envelope
// (six warp reductions a chunk) saved nothing (z3 1% slower, z2 equal).
constexpr int kRejectMinQ = 2;
// the output modes (the MODE template parameter)
constexpr int kBits = 0, kCount = 1, kHistShared = 2, kHistGlobal = 3;
// the shared-memory histogram's bins (32 KiB, in the 48 KiB a block gets
// without opting in)
constexpr int kHistSmemCodes = 8192;
constexpr int kHistMaxCodes = 1 << 16;

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

template <bool HAS_TIME, bool REJECT, int ATTR, int MODE>
__global__ void __launch_bounds__(kThreads) exact_bitmap_kernel(
    const long long* __restrict__ xk, const long long* __restrict__ yk,
    const long long* __restrict__ tk, const unsigned char* __restrict__ valid,
    const long long* __restrict__ boxes, const long long* __restrict__ wins, int q,
    const int* __restrict__ codes, const void* __restrict__ qcodes, int kq,
    unsigned int* __restrict__ bits, int* __restrict__ hdr, long long n) {
  constexpr bool kHist = MODE == kHistShared || MODE == kHistGlobal;
  extern __shared__ __align__(16) long long smem[];
  long long* sdesc = smem;              // [q, 6]
  // kBits: [warps, q, 3] = cnt, n - first, last + 1; kHistShared: [kq] bins
  int* acc = (int*)(smem + kDesc * q);
  __shared__ int s_last;
  __shared__ int s_count;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < q; i += blockDim.x) {
    long long* d = sdesc + kDesc * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) d[c] = boxes[4 * i + c];
    d[4] = HAS_TIME ? wins[2 * i] : 0;
    d[5] = HAS_TIME ? wins[2 * i + 1] : 0;
  }
  if constexpr (MODE == kBits) {
    for (int i = threadIdx.x; i < 3 * nwarps * q; i += blockDim.x) acc[i] = 0;
  } else if constexpr (MODE == kHistShared) {
    for (int i = threadIdx.x; i < kq; i += blockDim.x) acc[i] = 0;
  }
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  int* wacc = acc + 3 * warp * q;
  const int rows = (int)n;
  int lane_count = 0;  // kCount and kHist: the lane's hit rows

  const long long nwords = n >> 5;
  const long long nchunks = (nwords + kR - 1) / kR;
  // every chunk is whole and every query's words start 16-byte aligned:
  // a rejected chunk's kR zero words go out as 16-byte stores
  const bool vec_store = (nwords % kR) == 0;
  const long long gwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  // one warp per chunk: the loop, the reject and every ballot are warp-uniform
  for (long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; c < nchunks;
       c += gwarps) {
    const long long word0 = c * kR;
    long long x[kR], y[kR], t[kR];
    bool v[kR];
    // the chunk's codes, read the first time a query's box test holds a
    // row of the chunk (have_codes is warp-uniform)
    int cd[kR];
    bool have_codes = false;
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
    auto load_codes = [&]() {
      if (have_codes) return;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const long long row = (word0 + (word0 + j < nwords ? j : 0)) * 32 + lane;
        cd[j] = codes[row];
      }
      have_codes = true;
    };
    long long x0 = x[0], x1 = x[0], y0 = y[0], y1 = y[0], t0 = t[0], t1 = t[0];
    if (REJECT) {
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
    }
    const bool store_lane = lane < kR && word0 + lane < nwords;
    // query i against the chunk's rows: kR ballots, the words stored by
    // lanes 0..kR-1, the warp's header slot when a row hits (kBits); the
    // lane's count (kCount); the count and the histogram (kHist*)
    auto scan = [&](int i) {
      // (xmin, xmax), (ymin, ymax), (t_lo, t_hi)
      const longlong2* d = reinterpret_cast<const longlong2*>(sdesc + kDesc * i);
      const longlong2 bx = d[0], by = d[1];
      const longlong2 tw = HAS_TIME ? d[2] : make_longlong2(0, 0);
      bool m[kR];
      bool any_row = false;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        m[j] = v[j] & (x[j] >= bx.x) & (x[j] <= bx.y) & (y[j] >= by.x) & (y[j] <= by.y);
        if (HAS_TIME) m[j] = m[j] & (t[j] >= tw.x) & (t[j] <= tw.y);
        any_row |= m[j];
      }
      if (ATTR != kNone && __any_sync(kFull, any_row)) {
        load_codes();
        attr_plane::and_test<ATTR, kR>(m, cd, qcodes, i, kq);
      }
      if constexpr (MODE == kCount) {
#pragma unroll
        for (int j = 0; j < kR; ++j) lane_count += (int)m[j];
        return;
      }
      if constexpr (kHist) {
        if (!__any_sync(kFull, any_row)) return;
        load_codes();
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          lane_count += (int)m[j];
          // codes past the bins (none, from the executor) count nowhere
          const int key = m[j] && cd[j] >= 0 && cd[j] < kq ? cd[j] : -1;
          if constexpr (MODE == kHistShared) {
            const unsigned peers = __match_any_sync(kFull, key);
            if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(acc + key, __popc(peers));
          } else {
            if (key >= 0) atomicAdd(hdr + 1 + key, 1);
          }
        }
        return;
      }
      unsigned hb[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) hb[j] = __ballot_sync(kFull, m[j]);
      unsigned word = 0, any = 0;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        if (lane == j) word = hb[j];
        any |= hb[j];
      }
      if (store_lane) bits[(long long)i * nwords + word0 + lane] = packbits_order(word);
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
    };
    if (!REJECT) {
      for (int i = 0; i < q; ++i) scan(i);
      continue;
    }
    // the reject, 32 queries at a time: lane l tests query g + l against
    // the envelope and stores the zero words of a query it rejects; the
    // warp then scans only the queries that survive
    for (int g = 0; g < q; g += 32) {
      const int i = g + lane;
      bool live = false;
      if (i < q) {
        const longlong2* d = reinterpret_cast<const longlong2*>(sdesc + kDesc * i);
        const longlong2 bx = d[0], by = d[1];
        bool miss = (x1 < bx.x) | (x0 > bx.y) | (y1 < by.x) | (y0 > by.y);
        if (HAS_TIME) {
          const longlong2 tw = d[2];
          miss = miss | (t1 < tw.x) | (t0 > tw.y);
        }
        live = !miss;
        if (miss) {
          unsigned int* out = bits + (long long)i * nwords + word0;
          if (vec_store) {
#pragma unroll
            for (int j = 0; j < kR; j += 4) {
              *reinterpret_cast<uint4*>(out + j) = make_uint4(0u, 0u, 0u, 0u);
            }
          } else {
            for (int j = 0; j < kR && word0 + j < nwords; ++j) out[j] = 0u;
          }
        }
      }
      for (unsigned live_q = __ballot_sync(kFull, live); live_q; live_q &= live_q - 1) {
        scan(g + __ffs(live_q) - 1);
      }
    }
  }
  if constexpr (MODE != kBits) {
    // the count: warp, then block, then one atomic a block; the shared
    // histogram's nonzero bins, one atomic each
    const int wsum = __reduce_add_sync(kFull, lane_count);
    if (lane == 0 && wsum) atomicAdd(&s_count, wsum);
    __syncthreads();
    if (threadIdx.x == 0 && s_count) atomicAdd(hdr, s_count);
    if constexpr (MODE == kHistShared) {
      for (int b = threadIdx.x; b < kq; b += blockDim.x) {
        const int cnt = acc[b];
        if (cnt) atomicAdd(hdr + 1 + b, cnt);
      }
    }
    return;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < q; i += blockDim.x) {
    int cnt = 0, lo = 0, hi = 0;
    for (int w = 0; w < nwarps; ++w) {
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

// One launch of an instantiation. kBits: hdr is the int32[3 q + 1] header
// and ticket; the other modes: hdr is the int32 output (1 word for kCount,
// 1 + kq for the histograms). The launcher zeroes it.
template <bool HAS_TIME, bool REJECT, int ATTR, int MODE>
int launch(const void* xk, const void* yk, const void* tk, const void* valid,
           const void* boxes, const void* wins, int q, const void* codes,
           const void* qcodes, int kq, void* bits, void* hdr, long long n, cudaStream_t s) {
  auto kern = exact_bitmap_kernel<HAS_TIME, REJECT, ATTR, MODE>;
  size_t smem = sizeof(long long) * kDesc * (size_t)q;
  size_t out_words = 1;
  if (MODE == kBits) {
    smem += sizeof(int) * 3 * (size_t)(kThreads / 32) * (size_t)q;
    out_words = 3 * (size_t)q + 1;
  } else if (MODE != kCount) {
    if (MODE == kHistShared) smem += sizeof(int) * (size_t)kq;
    out_words = 1 + (size_t)kq;
  }
  cudaError_t err = cudaMemsetAsync(hdr, 0, sizeof(int) * out_words, s);
  if (err != cudaSuccess) return (int)err;
  // the grid fills the device once (at least one block: it decodes the
  // header even when there are no rows)
  long long blocks = 0;
  err = launch_grid::resident_blocks(kern, kThreads, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)kThreads * kR;
  const long long need = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;
  kern<<<(unsigned)blocks, kThreads, smem, s>>>(
      (const long long*)xk, (const long long*)yk, (const long long*)tk,
      (const unsigned char*)valid, (const long long*)boxes, (const long long*)wins, q,
      (const int*)codes, qcodes, kq, (unsigned int*)bits, (int*)hdr, n);
  return (int)cudaGetLastError();
}

template <bool HAS_TIME, bool REJECT, int MODE>
int launch_attr(int attr, const void* xk, const void* yk, const void* tk, const void* valid,
                const void* boxes, const void* wins, int q, const void* codes,
                const void* qcodes, int kq, void* bits, void* hdr, long long n,
                cudaStream_t s) {
  switch (attr) {
    case kNone:
      return launch<HAS_TIME, REJECT, kNone, MODE>(xk, yk, tk, valid, boxes, wins, q, codes,
                                                   qcodes, kq, bits, hdr, n, s);
    case kMember:
      return launch<HAS_TIME, REJECT, kMember, MODE>(xk, yk, tk, valid, boxes, wins, q, codes,
                                                     qcodes, kq, bits, hdr, n, s);
    case kRange:
      return launch<HAS_TIME, REJECT, kRange, MODE>(xk, yk, tk, valid, boxes, wins, q, codes,
                                                    qcodes, kq, bits, hdr, n, s);
    case kNotMember:
      return launch<HAS_TIME, REJECT, kNotMember, MODE>(xk, yk, tk, valid, boxes, wins, q,
                                                        codes, qcodes, kq, bits, hdr, n, s);
    case kVocabMask:
      return launch<HAS_TIME, REJECT, kVocabMask, MODE>(xk, yk, tk, valid, boxes, wins, q,
                                                        codes, qcodes, kq, bits, hdr, n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface for ctypes. Device pointers: xk, yk, tk int64[n] (tk and wins
// ignored when has_time is 0), valid bool[n], boxes int64[q, 4] as (xmin,
// xmax, ymin, ymax) keys, wins int64[q, 2]; attr 0 (none: codes and qcodes
// ignored), 1 member or 3 notmember (qcodes int32[q, kq], kq <= 32), 2
// range (int32[q, 2]) or 4 vocabmask (u8[q, kq], kq <= 65536), with codes
// int32[n]; outputs bits u8[q, n/8] and hdr int32[3 q + 1], whose first 3 q
// words become the [q, 3] header (the last is the launch's block ticket);
// the launcher initialises it. bits is 16-byte aligned; n is a multiple of
// 32 below 2^31. Launches on `stream` and returns a CUDA error code.
extern "C" int exact_bitmap(int has_time, const void* xk, const void* yk,
                            const void* tk, const void* valid,
                            const void* boxes, const void* wins, int q, int attr,
                            const void* codes, const void* qcodes, int kq,
                            void* bits, void* hdr, long long n, void* stream) {
  if (q == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const bool reject = q >= kRejectMinQ;
  if (has_time) {
    return reject ? launch_attr<true, true, kBits>(attr, xk, yk, tk, valid, boxes, wins, q,
                                                   codes, qcodes, kq, bits, hdr, n, s)
                  : launch_attr<true, false, kBits>(attr, xk, yk, tk, valid, boxes, wins, q,
                                                    codes, qcodes, kq, bits, hdr, n, s);
  }
  return reject ? launch_attr<false, true, kBits>(attr, xk, yk, nullptr, valid, boxes, nullptr,
                                                  q, codes, qcodes, kq, bits, hdr, n, s)
                : launch_attr<false, false, kBits>(attr, xk, yk, nullptr, valid, boxes, nullptr,
                                                   q, codes, qcodes, kq, bits, hdr, n, s);
}

// The hit count of ONE exact predicate (the arguments of exact_bitmap at
// q = 1, box int64[4] and win int64[2]) into out int32[1], which the
// launcher zeroes. Launches on `stream` and returns a CUDA error code.
extern "C" int exact_count(int has_time, const void* xk, const void* yk, const void* tk,
                           const void* valid, const void* box, const void* win, int attr,
                           const void* codes, const void* qcodes, int kq, void* out,
                           long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (has_time) {
    return launch_attr<true, false, kCount>(attr, xk, yk, tk, valid, box, win, 1, codes,
                                            qcodes, kq, nullptr, out, n, s);
  }
  return launch_attr<false, false, kCount>(attr, xk, yk, nullptr, valid, box, nullptr, 1, codes,
                                           qcodes, kq, nullptr, out, n, s);
}

// The hit count of ONE exact predicate and the per-code histogram of its
// hits: codes int32[n] (ranks below u_pad, -1 for null and pad rows),
// 1 <= u_pad <= 65536; out int32[1 + u_pad] = (total hits, then the hits of
// each code), zeroed by the launcher. Launches on `stream` and returns a
// CUDA error code.
extern "C" int exact_stat_hist(int has_time, const void* xk, const void* yk, const void* tk,
                               const void* valid, const void* box, const void* win,
                               const void* codes, int u_pad, void* out, long long n,
                               void* stream) {
  if (u_pad < 1 || u_pad > kHistMaxCodes) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool shared = u_pad <= kHistSmemCodes;
  if (has_time) {
    return shared ? launch<true, false, kNone, kHistShared>(xk, yk, tk, valid, box, win, 1,
                                                            codes, nullptr, u_pad, nullptr, out,
                                                            n, s)
                  : launch<true, false, kNone, kHistGlobal>(xk, yk, tk, valid, box, win, 1,
                                                            codes, nullptr, u_pad, nullptr, out,
                                                            n, s);
  }
  return shared ? launch<false, false, kNone, kHistShared>(xk, yk, nullptr, valid, box, nullptr,
                                                           1, codes, nullptr, u_pad, nullptr,
                                                           out, n, s)
                : launch<false, false, kNone, kHistGlobal>(xk, yk, nullptr, valid, box, nullptr,
                                                           1, codes, nullptr, u_pad, nullptr,
                                                           out, n, s);
}
