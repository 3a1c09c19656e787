// exact_bitmap<HAS_TIME>: q exact bbox(+window) predicates -> packed bitmaps
// and (cnt, lo, hi) headers in ONE sweep of the key columns.
//
// Replaces the batched exact predicate of the reference's
// geomesa_tpu/parallel/executor.py _exact_bitmap_batch_fn (an XLA lax.scan
// over the q descriptors of ops/filters.py exact_st_mask + _span_bounds +
// _bitmap_frame_step + jnp.packbits). The reference sweeps the key
// columns once per query; this kernel reads each row once for all q.
//
// Per row r and descriptor i (inclusive int64 sort-key compares):
//   m[i, r] = valid[r] & box[i].xmin <= xk[r] <= box[i].xmax
//                      & box[i].ymin <= yk[r] <= box[i].ymax
//                      (& win[i].lo <= tk[r] <= win[i].hi when HAS_TIME)
// where `valid` is the segment's temporal-valid column when HAS_TIME.
// Outputs: bits u8[q, n/8], MSB-first like jnp.packbits (byte j = rows
// 8j..8j+7, row 8j in bit 7); hdr int32[q, 3] = (count, first row, last
// row), accumulated with integer atomics (exact in any order) into a
// header the caller initialises to (0, n, -1).
//
// Bound on Hopper: instruction issue from q of about 9 up, HBM below. The
// sweep reads 25 B per row (three int64 keys and one bool) and writes q/8 B
// per row; each row and query costs at least 14 integer instructions (two
// per int64 compare, plus the ballot and the store per 32-row word), 10
// without the window.
// Design: each thread loads its row once and loops over the q
// descriptors, which sit in shared memory and are read as broadcasts.
// __ballot_sync forms each 32-row word of a query's mask; __brev +
// __byte_perm put it into packbits byte and bit order, so one lane stores
// 4 bytes per warp and query. __popc and the first and last set lanes give
// warp partials, which each warp folds into its own shared-memory slot per
// query (no atomics in the loop); at the end the block reduces its warps'
// slots and issues one atomic per header field and query. The grid is
// bounded and loops over rows, so the number of global atomics stays
// small. Row counts are a multiple of 32.

#include <climits>
#include <cuda_runtime.h>

namespace {

template <bool HAS_TIME>
__global__ void exact_bitmap_kernel(const long long* __restrict__ xk,
                                    const long long* __restrict__ yk,
                                    const long long* __restrict__ tk,
                                    const unsigned char* __restrict__ valid,
                                    const long long* __restrict__ boxes,
                                    const long long* __restrict__ wins, int q,
                                    unsigned int* __restrict__ bits,
                                    int* __restrict__ hdr, long long n) {
  extern __shared__ long long smem[];
  long long* sbox = smem;            // [q, 4]
  long long* swin = smem + 4 * q;    // [q, 2]
  int* acc = (int*)(smem + 6 * q);   // [warps, q, 3]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < 4 * q; i += blockDim.x) sbox[i] = boxes[i];
  if (HAS_TIME) {
    for (int i = threadIdx.x; i < 2 * q; i += blockDim.x) swin[i] = wins[i];
  }
  for (int i = threadIdx.x; i < nwarps * q; i += blockDim.x) {
    acc[3 * i] = 0;
    acc[3 * i + 1] = INT_MAX;
    acc[3 * i + 2] = -1;
  }
  __syncthreads();

  const long long nwords = n >> 5;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // n % 32 == 0 and blockDim % 32 == 0: whole warps enter or leave together
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const long long x = xk[row];
    const long long y = yk[row];
    const long long t = HAS_TIME ? tk[row] : 0;
    const bool v = valid[row] != 0;
    const long long word = row >> 5;
    const int base = (int)(row - lane);
    int* wacc = acc + 3 * warp * q;
    for (int i = 0; i < q; ++i) {
      const long long* b = sbox + 4 * i;
      bool m = v & (x >= b[0]) & (x <= b[1]) & (y >= b[2]) & (y <= b[3]);
      if (HAS_TIME) {
        const long long* tw = swin + 2 * i;
        m = m & (t >= tw[0]) & (t <= tw[1]);
      }
      const unsigned int ballot = __ballot_sync(0xffffffffu, m);
      if (lane == 0) {
        // lane j -> bit 31-j, then reverse the byte order: byte 0 of the
        // stored word holds lanes 0..7 with lane 0 in its bit 7
        bits[(long long)i * nwords + word] =
            __byte_perm(__brev(ballot), 0, 0x0123);
        if (ballot) {
          int* a = wacc + 3 * i;
          a[0] += __popc(ballot);
          a[1] = min(a[1], base + __ffs(ballot) - 1);
          a[2] = max(a[2], base + 31 - __clz(ballot));
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

// C interface for ctypes. Device pointers: xk, yk, tk int64[n] (tk and wins
// ignored when has_time is 0), valid bool[n], boxes int64[q, 4] as (xmin,
// xmax, ymin, ymax) keys, wins int64[q, 2]; outputs bits u8[q, n/8] and hdr
// int32[q, 3] (pre-set to (0, n, -1)). n is a multiple of 32 below 2^31.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int exact_bitmap(int has_time, const void* xk, const void* yk,
                            const void* tk, const void* valid,
                            const void* boxes, const void* wins, int q,
                            void* bits, void* hdr, long long n, void* stream) {
  if (n == 0 || q == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  const size_t smem = sizeof(long long) * 6 * (size_t)q +
                      sizeof(int) * 3 * (size_t)(threads / 32) * (size_t)q;
  cudaStream_t s = (cudaStream_t)stream;
  if (has_time) {
    exact_bitmap_kernel<true><<<(unsigned)blocks, threads, smem, s>>>(
        (const long long*)xk, (const long long*)yk, (const long long*)tk,
        (const unsigned char*)valid, (const long long*)boxes,
        (const long long*)wins, q, (unsigned int*)bits, (int*)hdr, n);
  } else {
    exact_bitmap_kernel<false><<<(unsigned)blocks, threads, smem, s>>>(
        (const long long*)xk, (const long long*)yk, nullptr,
        (const unsigned char*)valid, (const long long*)boxes, nullptr, q,
        (unsigned int*)bits, (int*)hdr, n);
  }
  return (int)cudaGetLastError();
}
