// devseek: the device-assisted seek's exact test over a query's candidate
// rows, for point tables (devseek) and extent tables (devseek_xz).
//
// Replaces the device work of the reference's
// geomesa_tpu/parallel/executor.py _devseek_fn (:4162, "devseek") and
// _devseek_xz_fn (:4268, "devseek_xz"). The host seeks the plan's ranges
// into the sorted blocks and ships only the candidate INTERVALS of a
// segment: `starts` int32[n_iv] (segment rows) and `ends` int32[n_iv], the
// inclusive prefix sums of their lengths (zero-length pad intervals at the
// end). Candidate j < ends[n_iv - 1] lies in the interval `seg` = the
// number of ends <= j (jnp.searchsorted(seg_end, j, side="right"), so a
// zero-length interval is never chosen), at segment row starts[seg] + j -
// (ends[seg] - len[seg]); a binary search over `ends` finds it. Candidates
// from `ends[n_iv - 1]` up to cand_cap are false.
//
// devseek gathers the candidate's int64 sort keys (x, y and, with a time
// window, t) and its valid flag (the temporal-valid column with a window)
// and applies the query's exact test, exact_st_mask: inclusive box
// (xmin <= xk <= xmax, ymin <= yk <= ymax) over box = keys of (xmin, xmax,
// ymin, ymax), and t_lo <= tk <= t_hi over win. Output: the packed bitmap
// over the candidate space, u8[cand_cap / 8], MSB first (jnp.packbits): a
// warp's 32 candidates are one ballot, whose bits are reversed and whose
// bytes are put back in order (__brev, __byte_perm) before lane 0 stores
// the 4-byte word.
//
// devseek_xz gathers the four int64 envelope keys (xmin, ymin, xmax,
// ymax), isrect and valid (and tk with a window) and writes two planes,
// `hit` then `decided`, u8[2 * cand_cap / 8]:
//   hit     = envelope overlaps the query box & valid (& t in the window)
//   decided = hit & rect & ~placeholder & (inside | isrect)
// with desc = int64[8] (xmin, ymin, xmax, ymax, zero, rect, t_lo, t_hi) as
// the executor's _xz_desc encodes it; `placeholder` is the all-zero
// envelope of a null geometry (every key equal to the key of 0.0).
//
// Bound on Hopper: bytes, the candidate keys gathered (17 B a candidate for
// a point seek without time, 25 with; 34 or 42 for extents) plus the bits
// written, cand_cap / 8 a plane; the intervals (8 B each) are read from L2
// by the binary search. The gathers follow the sorted intervals, so a
// warp's 32 candidates are mostly consecutive rows and their 8-byte loads
// coalesce into full sectors; only interval edges split a warp.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

// (segment row, in range) of candidate j.
__device__ __forceinline__ bool candidate_row(const int* __restrict__ starts,
                                              const int* __restrict__ ends, int n_iv, int total,
                                              int j, long long* row) {
  if (j >= total) return false;
  int lo = 0, hi = n_iv;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] <= j) lo = mid + 1;
    else hi = mid;
  }
  const int seg = lo < n_iv ? lo : n_iv - 1;
  const int prev = seg > 0 ? ends[seg - 1] : 0;
  *row = (long long)starts[seg] + (j - prev);
  return true;
}

// The warp's 32 predicates as 4 packed bytes, MSB first, stored by lane 0.
__device__ __forceinline__ void store_bits(bool m, int j, unsigned char* __restrict__ out) {
  const unsigned bits = __ballot_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) {
    reinterpret_cast<unsigned*>(out)[j >> 5] = __byte_perm(__brev(bits), 0, 0x0123);
  }
}

template <bool kTime>
__global__ void __launch_bounds__(kThreads) devseek_kernel(
    const long long* __restrict__ xk, const long long* __restrict__ yk,
    const long long* __restrict__ tk, const unsigned char* __restrict__ valid,
    const int* __restrict__ starts, const int* __restrict__ ends, int n_iv,
    const long long* __restrict__ box, const long long* __restrict__ win,
    unsigned char* __restrict__ out, int cand_cap) {
  const int total = ends[n_iv - 1];
  const long long bx0 = box[0], bx1 = box[1], by0 = box[2], by1 = box[3];
  long long t0 = 0, t1 = 0;
  if (kTime) {
    t0 = win[0];
    t1 = win[1];
  }
  // cand_cap is a multiple of the block: every warp runs whole iterations
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < cand_cap; j += gridDim.x * kThreads) {
    long long row = 0;
    bool m = candidate_row(starts, ends, n_iv, total, j, &row) && valid[row];
    if (m) {
      const long long x = xk[row], y = yk[row];
      m = x >= bx0 && x <= bx1 && y >= by0 && y <= by1;
      if (kTime && m) {
        const long long t = tk[row];
        m = t >= t0 && t <= t1;
      }
    }
    store_bits(m, j, out);
  }
}

template <bool kTime>
__global__ void __launch_bounds__(kThreads) devseek_xz_kernel(
    const long long* __restrict__ bxmin, const long long* __restrict__ bymin,
    const long long* __restrict__ bxmax, const long long* __restrict__ bymax,
    const unsigned char* __restrict__ isrect, const unsigned char* __restrict__ valid,
    const long long* __restrict__ tk, const int* __restrict__ starts,
    const int* __restrict__ ends, int n_iv, const long long* __restrict__ desc,
    unsigned char* __restrict__ out, int cand_cap) {
  const int total = ends[n_iv - 1];
  const long long qx0 = desc[0], qy0 = desc[1], qx1 = desc[2], qy1 = desc[3];
  const long long zero = desc[4];
  const bool rect = desc[5] != 0;
  const long long t0 = desc[6], t1 = desc[7];
  unsigned char* hit_out = out;
  unsigned char* dec_out = out + cand_cap / 8;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < cand_cap; j += gridDim.x * kThreads) {
    long long row = 0;
    bool hit = candidate_row(starts, ends, n_iv, total, j, &row) && valid[row];
    bool dec = false;
    if (hit) {
      const long long x0 = bxmin[row], y0 = bymin[row], x1 = bxmax[row], y1 = bymax[row];
      hit = qx0 <= x1 && x0 <= qx1 && qy0 <= y1 && y0 <= qy1;
      if (kTime && hit) {
        const long long t = tk[row];
        hit = t >= t0 && t <= t1;
      }
      if (hit && rect) {
        const bool placeholder = x0 == zero && y0 == zero && x1 == zero && y1 == zero;
        const bool inside = qx0 <= x0 && x1 <= qx1 && qy0 <= y0 && y1 <= qy1;
        dec = !placeholder && (inside || isrect[row]);
      }
    }
    store_bits(hit, j, hit_out);
    store_bits(dec, j, dec_out);
  }
}

long long grid_for(int cand_cap) {
  const long long blocks = cand_cap / kThreads;
  return blocks < 65536 ? blocks : 65536;
}

}  // namespace

extern "C" {

// xk, yk (tk) int64[n], valid u8[n]; starts, ends int32[n_iv]; box int64[4],
// win int64[2] (has_time); out u8[cand_cap / 8]; cand_cap a multiple of 256.
int devseek(int has_time, const long long* xk, const long long* yk, const long long* tk,
            const unsigned char* valid, const int* starts, const int* ends, int n_iv,
            const long long* box, const long long* win, unsigned char* out, int cand_cap,
            void* stream) {
  if (n_iv <= 0 || cand_cap <= 0 || cand_cap % kThreads) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)grid_for(cand_cap);
  cudaStream_t s = (cudaStream_t)stream;
  if (has_time) {
    devseek_kernel<true><<<blocks, kThreads, 0, s>>>(xk, yk, tk, valid, starts, ends, n_iv, box,
                                                     win, out, cand_cap);
  } else {
    devseek_kernel<false><<<blocks, kThreads, 0, s>>>(xk, yk, tk, valid, starts, ends, n_iv, box,
                                                      win, out, cand_cap);
  }
  return (int)cudaGetLastError();
}

// bxmin .. bymax int64[n], isrect, valid u8[n] (tk int64[n] with has_time);
// desc int64[8]; out u8[2 * cand_cap / 8]: hit, then decided.
int devseek_xz(int has_time, const long long* bxmin, const long long* bymin,
               const long long* bxmax, const long long* bymax, const unsigned char* isrect,
               const unsigned char* valid, const long long* tk, const int* starts,
               const int* ends, int n_iv, const long long* desc, unsigned char* out,
               int cand_cap, void* stream) {
  if (n_iv <= 0 || cand_cap <= 0 || cand_cap % kThreads) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)grid_for(cand_cap);
  cudaStream_t s = (cudaStream_t)stream;
  if (has_time) {
    devseek_xz_kernel<true><<<blocks, kThreads, 0, s>>>(bxmin, bymin, bxmax, bymax, isrect, valid,
                                                        tk, starts, ends, n_iv, desc, out,
                                                        cand_cap);
  } else {
    devseek_xz_kernel<false><<<blocks, kThreads, 0, s>>>(bxmin, bymin, bxmax, bymax, isrect,
                                                         valid, tk, starts, ends, n_iv, desc, out,
                                                         cand_cap);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
