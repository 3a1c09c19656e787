// xz_dual_bitmap<HAS_TIME, ATTR>: q exact extent predicates, each with an
// optional attribute-code test, -> the packed HIT and DECIDED bitmaps and
// the hit plane's (cnt, lo, hi) headers in ONE sweep of the envelope key
// columns.
//
// Replaces the batched extent predicate of the reference's
// geomesa_tpu/parallel/executor.py _xz_bitmap_batch_fn (an XLA lax.scan
// over the q descriptors of _xz_exact_mask_body + _dual_bitmap_row +
// jnp.packbits). The reference sweeps the columns once per query; this
// kernel reads each row once for all q.
//
// Per row r and descriptor d = (xmin, ymin, xmax, ymax, zero, rect, t_lo,
// t_hi) (inclusive int64 sort-key compares):
//   hit[d, r]     = valid[r] & d.xmin <= bxmax[r] & bxmin[r] <= d.xmax
//                            & d.ymin <= bymax[r] & bymin[r] <= d.ymax
//                            (& d.t_lo <= tk[r] <= d.t_hi when HAS_TIME)
//   decided[d, r] = hit[d, r] & d.rect & ~placeholder[r]
//                   & (inside[d, r] | isrect[r])
// where inside is the stored envelope lying within the query envelope and
// placeholder is the null-geometry envelope (all four keys equal to the key
// of 0.0). `valid` is the segment's temporal-valid column when HAS_TIME.
// placeholder and isrect depend on the row alone and are formed once per
// row, with the placeholder key of the first descriptor (the executor gives
// every descriptor the same one). With ATTR (attr_plane.cuh: member, range,
// notmember, vocabmask over the rows' int32 codes and one vector a query)
// the attribute test ANDs into hit BEFORE decided derives from it, as the
// reference's _xz_exact_mask_body(attr=...) combines it: decided rows are
// final for the spatial AND attribute predicate, and the ring carries only
// rows that pass the attribute test. It runs only where the chunk's hit
// test holds some row of the query (an AND can only narrow the hits); the
// chunk's codes (128 B a word) are read the first time a query needs them.
// Outputs: hit and decided bits u8[q, n/8], MSB-first like jnp.packbits
// (byte j = rows 8j..8j+7, row 8j in bit 7); hdr int32[q, 3] = (count,
// first row, last row) of the HIT plane, accumulated with integer atomics
// (exact in any order) into a header the caller initialises to (0, n, -1).
// The span framing (one window per query keyed on the hit span) is done by
// the caller with a gather.
//
// Bound on Hopper: instruction issue from q of about 9 up, HBM below. The
// sweep reads 34 B per row (four int64 keys, isrect, valid; 42 B with the
// int64 time) and writes q/4 B per row; each row and query costs at least
// 20 integer instructions (two per int64 compare: eight compares for
// overlap and inside, two more for the window, 24 in all; plus a ballot
// and a store per plane and 32-row word). Row counts are a multiple of 32.
//
// The first design (one row a thread per grid-stride step; per row and
// query the descriptor's 8 int64 fields read again from shared memory, and
// lane 0 alone storing both words and updating the warp's header slot
// while 31 lanes waited; at q = 1 one 8-byte load per column and thread in
// flight) ran at 1.3x its bound at q = 1 and 2.2x at q = 24. This design:
//   * each warp takes a chunk of kR = 4 consecutive 32-row words; lane l
//     holds rows 32 j + l of it (j < kR), so each ballot is still one
//     packbits word, and a lane has kR rows of loads in flight;
//   * each descriptor is read from shared memory once per chunk (four
//     16-byte broadcasts), not once per row;
//   * the decided plane's compares and ballots run only when a row of the
//     chunk hits and the query is a rectangle (a box's hits are few and
//     clustered, so most chunks skip them; the decided words are then 0);
//   * after the ballots, lanes 0..kR-1 store the chunk's hit words and
//     lanes kR..2kR-1 its decided words in one store instruction; the
//     warp's (count, first, last) slot in shared memory is updated once per
//     chunk and query, and only when the chunk hits; at the end the block
//     folds its warps' slots and issues one atomic per header field and
//     query;
//   * the grid is the resident blocks of the card, from the occupancy of
//     the instantiation and its shared memory.
// Measured by chip_smoke.py --ab on an H100 80GB HBM3 at 700 W, device time
// per launch, the first design's in turns on the same inputs (8M rows):
// xz2 q = 1 0.0947 ms (was 0.1065), q = 4 0.1020 (was 0.1318), q = 24
// 0.2581 (was 0.5082); xz3 q = 1 0.1156 (was 0.1204), q = 24 0.3016 (was
// 0.5777); 1.2x, 1.2x, 2.0x, 1.1x and 1.7x the bound chip_smoke.py counts
// from the run's hits. 80 registers (90 with time), no spills. The
// attribute editions add the 4 B code of each row of a chunk where some
// query's hit test holds a row.

#include <climits>
#include <cuda_runtime.h>

#include "attr_plane.cuh"
#include "launch_grid.cuh"

namespace {

constexpr int kDesc = 8;

__device__ __forceinline__ unsigned int packbits_order(unsigned int ballot) {
  // lane j -> bit 31-j, then reverse the byte order: byte 0 of the stored
  // word holds lanes 0..7 with lane 0 in its bit 7
  return __byte_perm(__brev(ballot), 0, 0x0123);
}

constexpr int kR = 4;  // 32-row words per warp and chunk (rows per lane)
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <bool HAS_TIME, int ATTR>
__global__ void __launch_bounds__(kThreads) xz_dual_bitmap_kernel(
    const long long* __restrict__ bxmin, const long long* __restrict__ bymin,
    const long long* __restrict__ bxmax, const long long* __restrict__ bymax,
    const unsigned char* __restrict__ isrect,
    const unsigned char* __restrict__ valid, const long long* __restrict__ tk,
    const long long* __restrict__ descs, int q,
    unsigned int* __restrict__ hit_bits, unsigned int* __restrict__ dec_bits,
    int* __restrict__ hdr, long long n, const int* __restrict__ codes,
    const void* __restrict__ qcodes, int kq) {
  extern __shared__ long long smem[];
  long long* sdesc = smem;              // [q, 8]
  int* acc = (int*)(smem + kDesc * q);  // [warps, q, 3]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < kDesc * q; i += blockDim.x) sdesc[i] = descs[i];
  for (int i = threadIdx.x; i < nwarps * q; i += blockDim.x) {
    acc[3 * i] = 0;
    acc[3 * i + 1] = INT_MAX;
    acc[3 * i + 2] = -1;
  }
  __syncthreads();
  const long long zero = sdesc[4];
  int* wacc = acc + 3 * warp * q;

  const long long nwords = n >> 5;
  const long long nchunks = (nwords + kR - 1) / kR;
  const long long gwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  // one warp per chunk: the loop and every ballot below are warp-uniform
  for (long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; c < nchunks;
       c += gwarps) {
    const long long word0 = c * kR;
    long long x0[kR], y0[kR], x1[kR], y1[kR], t[kR];
    bool v[kR], rect_row[kR], real[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const bool in = word0 + j < nwords;
      const long long row = (word0 + j) * 32 + lane;
      x0[j] = in ? bxmin[row] : 0;
      y0[j] = in ? bymin[row] : 0;
      x1[j] = in ? bxmax[row] : 0;
      y1[j] = in ? bymax[row] : 0;
      t[j] = HAS_TIME && in ? tk[row] : 0;
      v[j] = in && valid[row] != 0;
      rect_row[j] = in && isrect[row] != 0;
      real[j] = !((x0[j] == zero) & (y0[j] == zero) & (x1[j] == zero) & (y1[j] == zero));
    }
    // the chunk's codes, read the first time a query's hit test holds a row
    // of the chunk (warp-uniform)
    int cd[kR];
    bool have_codes = false;
    for (int i = 0; i < q; ++i) {
      // (xmin, ymin), (xmax, ymax), (zero, rect), (t_lo, t_hi)
      const longlong2* d = reinterpret_cast<const longlong2*>(sdesc + kDesc * i);
      const longlong2 lo = d[0], hi = d[1], rect = d[2], win = d[3];
      bool hit[kR];
      unsigned hb[kR], db[kR];
      bool any_row = false;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        hit[j] = v[j] & (lo.x <= x1[j]) & (x0[j] <= hi.x) & (lo.y <= y1[j]) & (y0[j] <= hi.y);
        if (HAS_TIME) hit[j] = hit[j] & (t[j] >= win.x) & (t[j] <= win.y);
        any_row |= hit[j];
      }
      if (ATTR != attr_plane::kNone && __any_sync(kFull, any_row)) {
        if (!have_codes) {
#pragma unroll
          for (int j = 0; j < kR; ++j) {
            cd[j] = word0 + j < nwords ? codes[(word0 + j) * 32 + lane] : -1;
          }
          have_codes = true;
        }
        attr_plane::and_test<ATTR, kR>(hit, cd, qcodes, i, kq);
      }
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        hb[j] = __ballot_sync(kFull, hit[j]);
        db[j] = 0;
      }
      unsigned any = 0;
#pragma unroll
      for (int j = 0; j < kR; ++j) any |= hb[j];
      if (any && rect.y != 0) {
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const bool inside =
              (lo.x <= x0[j]) & (x1[j] <= hi.x) & (lo.y <= y0[j]) & (y1[j] <= hi.y);
          db[j] = __ballot_sync(kFull, hit[j] & real[j] & (inside | rect_row[j]));
        }
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
        a[1] = min(a[1], first);
        a[2] = max(a[2], last);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < q; i += blockDim.x) {
    int cnt = 0, lo = INT_MAX, hi = -1;
    for (int w = 0; w < nwarps; ++w) {
      const int* a = acc + 3 * (w * q + i);
      cnt += a[0];
      lo = min(lo, a[1]);
      hi = max(hi, a[2]);
    }
    if (cnt) {
      atomicAdd(hdr + 3 * i, cnt);
      atomicMin(hdr + 3 * i + 1, lo);
      atomicMax(hdr + 3 * i + 2, hi);
    }
  }
}

template <bool HAS_TIME, int ATTR>
int launch(const void* bxmin, const void* bymin, const void* bxmax, const void* bymax,
           const void* isrect, const void* valid, const void* tk, const void* descs, int q,
           void* hit_bits, void* dec_bits, void* hdr, long long n, const void* codes,
           const void* qcodes, int kq, cudaStream_t s) {
  auto kern = xz_dual_bitmap_kernel<HAS_TIME, ATTR>;
  const size_t smem = sizeof(long long) * kDesc * (size_t)q +
                      sizeof(int) * 3 * (size_t)(kThreads / 32) * (size_t)q;
  // the grid fills the device once
  long long blocks = 0;
  const cudaError_t err = launch_grid::resident_blocks(kern, kThreads, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)kThreads * kR;
  const long long need = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;
  kern<<<(unsigned)blocks, kThreads, smem, s>>>(
      (const long long*)bxmin, (const long long*)bymin, (const long long*)bxmax,
      (const long long*)bymax, (const unsigned char*)isrect, (const unsigned char*)valid,
      (const long long*)tk, (const long long*)descs, q, (unsigned int*)hit_bits,
      (unsigned int*)dec_bits, (int*)hdr, n, (const int*)codes, qcodes, kq);
  return (int)cudaGetLastError();
}

template <bool HAS_TIME>
int launch_attr(int attr, const void* bxmin, const void* bymin, const void* bxmax,
                const void* bymax, const void* isrect, const void* valid, const void* tk,
                const void* descs, int q, void* hit_bits, void* dec_bits, void* hdr, long long n,
                const void* codes, const void* qcodes, int kq, cudaStream_t s) {
  switch (attr) {
    case attr_plane::kNone:
      return launch<HAS_TIME, attr_plane::kNone>(bxmin, bymin, bxmax, bymax, isrect, valid, tk,
                                                 descs, q, hit_bits, dec_bits, hdr, n, codes,
                                                 qcodes, kq, s);
    case attr_plane::kMember:
      return launch<HAS_TIME, attr_plane::kMember>(bxmin, bymin, bxmax, bymax, isrect, valid,
                                                   tk, descs, q, hit_bits, dec_bits, hdr, n,
                                                   codes, qcodes, kq, s);
    case attr_plane::kRange:
      return launch<HAS_TIME, attr_plane::kRange>(bxmin, bymin, bxmax, bymax, isrect, valid, tk,
                                                  descs, q, hit_bits, dec_bits, hdr, n, codes,
                                                  qcodes, kq, s);
    case attr_plane::kNotMember:
      return launch<HAS_TIME, attr_plane::kNotMember>(bxmin, bymin, bxmax, bymax, isrect, valid,
                                                      tk, descs, q, hit_bits, dec_bits, hdr, n,
                                                      codes, qcodes, kq, s);
    case attr_plane::kVocabMask:
      return launch<HAS_TIME, attr_plane::kVocabMask>(bxmin, bymin, bxmax, bymax, isrect, valid,
                                                      tk, descs, q, hit_bits, dec_bits, hdr, n,
                                                      codes, qcodes, kq, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface for ctypes. Device pointers: bxmin, bymin, bxmax, bymax
// int64[n] envelope sort keys; isrect, valid bool[n]; tk int64[n] (ignored
// when has_time is 0); descs int64[q, 8]; outputs hit_bits, dec_bits
// u8[q, n/8] and hdr int32[q, 3] (pre-set to (0, n, -1)); attr 0 (none:
// codes and qcodes ignored), 1 member or 3 notmember (qcodes int32[q, kq],
// kq <= 32), 2 range (int32[q, 2]) or 4 vocabmask (u8[q, kq], kq <= 65536),
// with codes int32[n] (the attribute arguments come last, so a design
// without them takes the same call). n is a multiple of 32 below 2^31.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int xz_dual_bitmap(int has_time, const void* bxmin,
                              const void* bymin, const void* bxmax,
                              const void* bymax, const void* isrect,
                              const void* valid, const void* tk,
                              const void* descs, int q, void* hit_bits,
                              void* dec_bits, void* hdr, long long n,
                              void* stream, int attr, const void* codes,
                              const void* qcodes, int kq) {
  if (n == 0 || q == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (has_time) {
    return launch_attr<true>(attr, bxmin, bymin, bxmax, bymax, isrect, valid, tk, descs, q,
                             hit_bits, dec_bits, hdr, n, codes, qcodes, kq, s);
  }
  return launch_attr<false>(attr, bxmin, bymin, bxmax, bymax, isrect, valid, nullptr, descs, q,
                            hit_bits, dec_bits, hdr, n, codes, qcodes, kq, s);
}
