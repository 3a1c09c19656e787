// candidate_mask<HAS_TIME>: the conservative z3 / z2 candidate mask.
//
// Replaces the Pallas kernels _z3_mask_kernel (HAS_TIME = true) and
// _z2_mask_kernel (HAS_TIME = false) of geomesa_tpu/ops/pallas_kernels.py
// (entry points z3_query_mask_pallas / z2_query_mask_pallas):
//
//   out[r] = valid[r] & any_k(box_k contains (xi[r], yi[r]))
//                     & any_w(bins[r] == w.bin & w.lo <= offs[r] <= w.hi)
//
// Bound on Hopper: bytes. Each row reads 17 B (z3: four int32 columns and
// one bool) or 9 B (z2) and writes 1 B, against a handful of integer
// compares per box and window, far below the card's compute rate. Design:
// every thread handles four rows with one 16-byte load per int32 column
// and one 4-byte load of the bool column, and writes its four results as
// one 4-byte store, so a warp moves whole 128-byte lines. The boxes
// ([K, 4] int32) and windows ([W, 3] int32) are staged in shared memory
// once per block and read as broadcasts. A grid-stride loop lets a bounded
// grid cover any row count. Row counts are a multiple of 4 (the segment
// pads rows to a 1024-row granule).

#include <cuda_runtime.h>

#include "launch_grid.cuh"

namespace {

template <bool HAS_TIME>
__global__ void candidate_mask_kernel(const int4* __restrict__ xi,
                                      const int4* __restrict__ yi,
                                      const int4* __restrict__ bins,
                                      const int4* __restrict__ offs,
                                      const uchar4* __restrict__ valid,
                                      const int* __restrict__ boxes, int k,
                                      const int* __restrict__ windows, int w,
                                      uchar4* __restrict__ out, long long n4) {
  extern __shared__ int smem[];
  int* sbox = smem;
  int* swin = smem + 4 * k;
  for (int i = threadIdx.x; i < 4 * k; i += blockDim.x) sbox[i] = boxes[i];
  if (HAS_TIME) {
    for (int i = threadIdx.x; i < 3 * w; i += blockDim.x) swin[i] = windows[i];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const int4 x4 = xi[i];
    const int4 y4 = yi[i];
    const uchar4 v4 = valid[i];
    const int xs[4] = {x4.x, x4.y, x4.z, x4.w};
    const int ys[4] = {y4.x, y4.y, y4.z, y4.w};
    const unsigned char vs[4] = {v4.x, v4.y, v4.z, v4.w};
    int bs[4] = {0, 0, 0, 0};
    int os[4] = {0, 0, 0, 0};
    if (HAS_TIME) {
      const int4 b4 = bins[i];
      const int4 o4 = offs[i];
      bs[0] = b4.x; bs[1] = b4.y; bs[2] = b4.z; bs[3] = b4.w;
      os[0] = o4.x; os[1] = o4.y; os[2] = o4.z; os[3] = o4.w;
    }
    unsigned char r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bool spatial = false;
      for (int b = 0; b < k; ++b) {
        const int* bx = sbox + 4 * b;
        spatial |= (xs[j] >= bx[0]) & (xs[j] <= bx[2]) & (ys[j] >= bx[1]) &
                   (ys[j] <= bx[3]);
      }
      bool temporal = true;
      if (HAS_TIME) {
        temporal = false;
        for (int c = 0; c < w; ++c) {
          const int* wn = swin + 3 * c;
          temporal |= (bs[j] == wn[0]) & (os[j] >= wn[1]) & (os[j] <= wn[2]);
        }
      }
      r[j] = (unsigned char)((vs[j] != 0) & spatial & temporal);
    }
    out[i] = make_uchar4(r[0], r[1], r[2], r[3]);
  }
}

}  // namespace

// C interface for ctypes. Pointers are device pointers; n rows (a multiple
// of 4); boxes int32[k, 4]; windows int32[w, 3] (ignored when has_time is
// 0). Launches on `stream` and returns cudaGetLastError().
extern "C" int candidate_mask(int has_time, const void* xi, const void* yi,
                              const void* bins, const void* offs,
                              const void* valid, const void* boxes, int k,
                              const void* windows, int w, void* out,
                              long long n, void* stream) {
  const long long n4 = n / 4;
  if (n4 == 0) return (int)cudaSuccess;
  const int threads = 256;
  // at most 16 blocks per SM of the device (the grid-stride loop takes the rest)
  int sms = 0;
  const cudaError_t err = launch_grid::device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n4 + threads - 1) / threads;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  const size_t smem = sizeof(int) * (4 * (size_t)k + (has_time ? 3 * (size_t)w : 0));
  cudaStream_t s = (cudaStream_t)stream;
  if (has_time) {
    candidate_mask_kernel<true><<<(unsigned)blocks, threads, smem, s>>>(
        (const int4*)xi, (const int4*)yi, (const int4*)bins, (const int4*)offs,
        (const uchar4*)valid, (const int*)boxes, k, (const int*)windows, w,
        (uchar4*)out, n4);
  } else {
    candidate_mask_kernel<false><<<(unsigned)blocks, threads, smem, s>>>(
        (const int4*)xi, (const int4*)yi, nullptr, nullptr,
        (const uchar4*)valid, (const int*)boxes, k, nullptr, 0, (uchar4*)out,
        n4);
  }
  return (int)cudaGetLastError();
}
