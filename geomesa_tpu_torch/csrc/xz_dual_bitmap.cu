// xz_dual_bitmap<HAS_TIME>: q exact extent predicates -> the packed HIT and
// DECIDED bitmaps and the hit plane's (cnt, lo, hi) headers in ONE sweep of
// the envelope key columns.
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
// every descriptor the same one).
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
// and a store per plane and 32-row word). Design (as exact_bitmap.cu): each thread
// loads its row once and loops over the q descriptors, which sit in shared
// memory and are read as broadcasts. __ballot_sync forms each 32-row word
// of both planes; __brev + __byte_perm put it into packbits byte and bit
// order, so one lane stores 4 bytes per plane, warp and query. __popc and
// the first and last set lanes of the hit word give warp partials, which
// each warp folds into its own shared-memory slot per query (no atomics in
// the loop); at the end the block reduces its warps' slots and issues one
// atomic per header field and query. The grid is bounded and loops over
// rows. Row counts are a multiple of 32.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kDesc = 8;

__device__ __forceinline__ unsigned int packbits_order(unsigned int ballot) {
  // lane j -> bit 31-j, then reverse the byte order: byte 0 of the stored
  // word holds lanes 0..7 with lane 0 in its bit 7
  return __byte_perm(__brev(ballot), 0, 0x0123);
}

template <bool HAS_TIME>
__global__ void xz_dual_bitmap_kernel(
    const long long* __restrict__ bxmin, const long long* __restrict__ bymin,
    const long long* __restrict__ bxmax, const long long* __restrict__ bymax,
    const unsigned char* __restrict__ isrect,
    const unsigned char* __restrict__ valid, const long long* __restrict__ tk,
    const long long* __restrict__ descs, int q,
    unsigned int* __restrict__ hit_bits, unsigned int* __restrict__ dec_bits,
    int* __restrict__ hdr, long long n) {
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

  const long long nwords = n >> 5;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // n % 32 == 0 and blockDim % 32 == 0: whole warps enter or leave together
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const long long x0 = bxmin[row];
    const long long y0 = bymin[row];
    const long long x1 = bxmax[row];
    const long long y1 = bymax[row];
    const long long t = HAS_TIME ? tk[row] : 0;
    const bool v = valid[row] != 0;
    const bool rect_row = isrect[row] != 0;
    const bool real =
        !((x0 == zero) & (y0 == zero) & (x1 == zero) & (y1 == zero));
    const long long word = row >> 5;
    const int base = (int)(row - lane);
    int* wacc = acc + 3 * warp * q;
    for (int i = 0; i < q; ++i) {
      const long long* d = sdesc + kDesc * i;
      bool hit = v & (d[0] <= x1) & (x0 <= d[2]) & (d[1] <= y1) & (y0 <= d[3]);
      if (HAS_TIME) hit = hit & (t >= d[6]) & (t <= d[7]);
      const bool inside =
          (d[0] <= x0) & (x1 <= d[2]) & (d[1] <= y0) & (y1 <= d[3]);
      const bool dec = hit & (d[5] != 0) & real & (inside | rect_row);
      const unsigned int hb = __ballot_sync(0xffffffffu, hit);
      const unsigned int db = __ballot_sync(0xffffffffu, dec);
      if (lane == 0) {
        const long long at = (long long)i * nwords + word;
        hit_bits[at] = packbits_order(hb);
        dec_bits[at] = packbits_order(db);
        if (hb) {
          int* a = wacc + 3 * i;
          a[0] += __popc(hb);
          a[1] = min(a[1], base + __ffs(hb) - 1);
          a[2] = max(a[2], base + 31 - __clz(hb));
        }
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

}  // namespace

// C interface for ctypes. Device pointers: bxmin, bymin, bxmax, bymax
// int64[n] envelope sort keys; isrect, valid bool[n]; tk int64[n] (ignored
// when has_time is 0); descs int64[q, 8]; outputs hit_bits, dec_bits
// u8[q, n/8] and hdr int32[q, 3] (pre-set to (0, n, -1)). n is a multiple
// of 32 below 2^31. Launches on `stream` and returns cudaGetLastError().
extern "C" int xz_dual_bitmap(int has_time, const void* bxmin,
                              const void* bymin, const void* bxmax,
                              const void* bymax, const void* isrect,
                              const void* valid, const void* tk,
                              const void* descs, int q, void* hit_bits,
                              void* dec_bits, void* hdr, long long n,
                              void* stream) {
  if (n == 0 || q == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  const size_t smem = sizeof(long long) * kDesc * (size_t)q +
                      sizeof(int) * 3 * (size_t)(threads / 32) * (size_t)q;
  cudaStream_t s = (cudaStream_t)stream;
  if (has_time) {
    xz_dual_bitmap_kernel<true><<<(unsigned)blocks, threads, smem, s>>>(
        (const long long*)bxmin, (const long long*)bymin,
        (const long long*)bxmax, (const long long*)bymax,
        (const unsigned char*)isrect, (const unsigned char*)valid,
        (const long long*)tk, (const long long*)descs, q,
        (unsigned int*)hit_bits, (unsigned int*)dec_bits, (int*)hdr, n);
  } else {
    xz_dual_bitmap_kernel<false><<<(unsigned)blocks, threads, smem, s>>>(
        (const long long*)bxmin, (const long long*)bymin,
        (const long long*)bxmax, (const long long*)bymax,
        (const unsigned char*)isrect, (const unsigned char*)valid, nullptr,
        (const long long*)descs, q, (unsigned int*)hit_bits,
        (unsigned int*)dec_bits, (int*)hdr, n);
  }
  return (int)cudaGetLastError();
}
