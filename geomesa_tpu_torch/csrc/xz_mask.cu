// xz_mask<HAS_TIME>: the conservative xz3 / xz2 extent candidate mask.
//
// Replaces the Pallas kernels _xz3_mask_kernel (HAS_TIME = true) and
// _xz2_mask_kernel (HAS_TIME = false) of geomesa_tpu/ops/pallas_kernels.py
// (entry points xz3_overlap_mask_pallas / xz2_overlap_mask_pallas):
//
//   out[r] = valid[r] & any_k(bxmin[r] <= box_k.xhi & bxmax[r] >= box_k.xlo
//                             & bymin[r] <= box_k.yhi & bymax[r] >= box_k.ylo)
//                     & any_w(bins[r] == w.bin & w.lo <= offs[r] <= w.hi)
//
// The envelope compares are float32 and ordered, so a NaN fails every
// compare and -0.0 equals 0.0, as in the Pallas kernel; the segment's pad
// rows carry inverted envelopes (min 1, max 0) and valid = false.
//
// Bound on Hopper: bytes. Each row reads 17 B (four float32 envelope
// columns and one bool; xz3 adds 8 B of int32 bins and offsets) and writes
// 1 B, against four float compares per box and three integer compares per
// window, far below the card's compute rate. Design (as candidate_mask.cu):
// every thread handles four rows with one 16-byte load per 4-byte column
// and one 4-byte load of the bool column, and writes its four results as
// one 4-byte store, so a warp moves whole 128-byte lines. The boxes
// ([K, 4] float32) and windows ([W, 3] int32) are staged in shared memory
// once per block and read as broadcasts. A grid-stride loop lets a bounded
// grid cover any row count. Row counts are a multiple of 4 (the segment
// pads rows to a 1024-row granule).

#include <cuda_runtime.h>

#include "launch_grid.cuh"

namespace {

template <bool HAS_TIME>
__global__ void xz_mask_kernel(const float4* __restrict__ bxmin,
                               const float4* __restrict__ bymin,
                               const float4* __restrict__ bxmax,
                               const float4* __restrict__ bymax,
                               const int4* __restrict__ bins,
                               const int4* __restrict__ offs,
                               const uchar4* __restrict__ valid,
                               const float* __restrict__ boxes, int k,
                               const int* __restrict__ windows, int w,
                               uchar4* __restrict__ out, long long n4) {
  extern __shared__ float smem[];
  float* sbox = smem;
  int* swin = (int*)(smem + 4 * k);
  for (int i = threadIdx.x; i < 4 * k; i += blockDim.x) sbox[i] = boxes[i];
  if (HAS_TIME) {
    for (int i = threadIdx.x; i < 3 * w; i += blockDim.x) swin[i] = windows[i];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 a4 = bxmin[i];
    const float4 b4 = bymin[i];
    const float4 c4 = bxmax[i];
    const float4 d4 = bymax[i];
    const uchar4 v4 = valid[i];
    const float x0s[4] = {a4.x, a4.y, a4.z, a4.w};
    const float y0s[4] = {b4.x, b4.y, b4.z, b4.w};
    const float x1s[4] = {c4.x, c4.y, c4.z, c4.w};
    const float y1s[4] = {d4.x, d4.y, d4.z, d4.w};
    const unsigned char vs[4] = {v4.x, v4.y, v4.z, v4.w};
    int bs[4] = {0, 0, 0, 0};
    int os[4] = {0, 0, 0, 0};
    if (HAS_TIME) {
      const int4 g4 = bins[i];
      const int4 o4 = offs[i];
      bs[0] = g4.x; bs[1] = g4.y; bs[2] = g4.z; bs[3] = g4.w;
      os[0] = o4.x; os[1] = o4.y; os[2] = o4.z; os[3] = o4.w;
    }
    unsigned char r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bool overlap = false;
      for (int b = 0; b < k; ++b) {
        const float* bx = sbox + 4 * b;  // (xlo, ylo, xhi, yhi)
        overlap |= (x0s[j] <= bx[2]) & (x1s[j] >= bx[0]) & (y0s[j] <= bx[3]) &
                   (y1s[j] >= bx[1]);
      }
      bool temporal = true;
      if (HAS_TIME) {
        temporal = false;
        for (int c = 0; c < w; ++c) {
          const int* wn = swin + 3 * c;
          temporal |= (bs[j] == wn[0]) & (os[j] >= wn[1]) & (os[j] <= wn[2]);
        }
      }
      r[j] = (unsigned char)((vs[j] != 0) & overlap & temporal);
    }
    out[i] = make_uchar4(r[0], r[1], r[2], r[3]);
  }
}

}  // namespace

// C interface for ctypes. Device pointers: bxmin, bymin, bxmax, bymax
// float32[n]; bins, offs int32[n] and windows int32[w, 3] (ignored when
// has_time is 0); valid bool[n]; boxes float32[k, 4]; out bool[n]. n is a
// multiple of 4 and every 4-byte column is 16-byte aligned. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int xz_mask(int has_time, const void* bxmin, const void* bymin,
                       const void* bxmax, const void* bymax, const void* bins,
                       const void* offs, const void* valid, const void* boxes,
                       int k, const void* windows, int w, void* out,
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
  const size_t smem =
      sizeof(float) * 4 * (size_t)k + (has_time ? sizeof(int) * 3 * (size_t)w : 0);
  cudaStream_t s = (cudaStream_t)stream;
  if (has_time) {
    xz_mask_kernel<true><<<(unsigned)blocks, threads, smem, s>>>(
        (const float4*)bxmin, (const float4*)bymin, (const float4*)bxmax,
        (const float4*)bymax, (const int4*)bins, (const int4*)offs,
        (const uchar4*)valid, (const float*)boxes, k, (const int*)windows, w,
        (uchar4*)out, n4);
  } else {
    xz_mask_kernel<false><<<(unsigned)blocks, threads, smem, s>>>(
        (const float4*)bxmin, (const float4*)bymin, (const float4*)bxmax,
        (const float4*)bymax, nullptr, nullptr, (const uchar4*)valid,
        (const float*)boxes, k, nullptr, 0, (uchar4*)out, n4);
  }
  return (int)cudaGetLastError();
}
