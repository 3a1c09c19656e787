// density_grid<HAS_TIME>: the exact density grid of one segment.
//
// Replaces the Pallas kernel _density_kernel of
// geomesa_tpu/ops/pallas_kernels.py (entry point density_grid_pallas) and
// fuses what geomesa_tpu/ops/aggregations.py make_sharded_density_dual
// runs around it on one shard: density_band, the f32 box mask, the time
// windows, GridSnap and the band's bounded nonzero. Per row r:
//
//   certain = valid & any_k(box_k contains (x, y)) & window & ~band & in_env
//     -> grid[row(y), col(x)] += 1
//   near & valid & window
//     -> band_idx[atomicAdd(band_count, 1)] = r   (while below band_cap)
//
// The plain edition is geomesa_tpu_torch/ops/aggregations.py density_dual;
// kernel and plain edition must agree bitwise in the grid, and as a set in
// the band indices (the atomic counter fills the buffer in any order; the
// count is the true one, so the host sees a truncated band).
//
// Float semantics: every operation of the band is the reference's f32
// operation, written with the _rn intrinsics and built with -fmad=false so
// that nothing contracts into an FMA; dx = (xmax - xmin) * f32(1 / width)
// (the reciprocal the host passes in, as XLA lowers a divide by a static
// width); (x - xmin) / dx is an IEEE divide; rintf rounds half to even;
// the cell is floorf, then NaN -> 0 and a clip in float (a saturating
// convert). The max is NaN-propagating like jnp.maximum / torch.maximum.
// NaN coordinates (null geometries) fail every compare.
//
// Bound on Hopper: bytes. Every row's valid flag is read; with time, the
// bins and t_ms of the valid rows (8 B); x and y (8 B) only of the rows
// that pass valid and the window; the grid (H * W * 4 B) and the band (4 B
// per band row) are written once. The f32 work is the box tests of each
// such row (22 operations per real box), and for the rows inside a
// widened box the band (about 40 operations and 4 divides). Design: one row
// per thread per step of a grid-stride loop; boxes, their per-box margins
// and the windows are staged in shared memory; every certain row adds one
// to its cell with a global int32 atomic (exact in any order). A
// block-private shared-memory histogram, flushed once per block, was no
// faster on an H100 80GB HBM3 at 700 W: 0.2365 ms against 0.1660 at
// 256 x 128 (z2, 8M rows), 0.2586 against 0.2585 at 64 x 32 (z3, 20M
// rows), so there is none.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1.9073486328125e-06f;  // 16 * 2^-23

__device__ __forceinline__ float maxp(float a, float b) {
  // jnp.maximum: NaN if either side is NaN
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ int snap(float t, int n) {
  float f = floorf(t);
  if (f != f) f = 0.0f;
  f = fminf(fmaxf(f, 0.0f), (float)(n - 1));
  return (int)f;
}

constexpr int kThreads = 512;

template <bool HAS_TIME>
__global__ void __launch_bounds__(kThreads)
    density_grid_kernel(const float* __restrict__ x, const float* __restrict__ y,
                        const int* __restrict__ bins, const int* __restrict__ offs,
                        const unsigned char* __restrict__ valid,
                        const float* __restrict__ boxes, int k,
                        const int* __restrict__ windows, int w,
                        const float* __restrict__ env, float rw, float rh,
                        int width, int height, int* __restrict__ grid,
                        int* __restrict__ band_idx, int* __restrict__ band_count,
                        int band_cap, long long n) {
  extern __shared__ float smem[];
  float* sbox = smem;            // [k, 4] (x0, y0, x1, y1)
  float* smarg = smem + 4 * k;   // [k, 2] eps * max(|x0|, |x1|), eps * max(|y0|, |y1|)
  int* swin = (int*)(smem + 6 * k);  // [w, 3]
  for (int i = threadIdx.x; i < 4 * k; i += blockDim.x) sbox[i] = boxes[i];
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float* b = boxes + 4 * i;
    smarg[2 * i] = __fmul_rn(kEps, maxp(fabsf(b[0]), fabsf(b[2])));
    smarg[2 * i + 1] = __fmul_rn(kEps, maxp(fabsf(b[1]), fabsf(b[3])));
  }
  if (HAS_TIME) {
    for (int i = threadIdx.x; i < 3 * w; i += blockDim.x) swin[i] = windows[i];
  }
  __syncthreads();

  const float xmin = env[0], ymin = env[1], xmax = env[2], ymax = env[3];
  const float dx = __fmul_rn(__fsub_rn(xmax, xmin), rw);
  const float dy = __fmul_rn(__fsub_rn(ymax, ymin), rh);
  const float adx = fabsf(dx), ady = fabsf(dy);
  const float envx = maxp(fabsf(xmin), fabsf(xmax));
  const float envy = maxp(fabsf(ymin), fabsf(ymax));

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!valid[r]) continue;
    if (HAS_TIME) {
      const int b = bins[r], o = offs[r];
      bool tm = false;
      for (int c = 0; c < w; ++c) {
        const int* wn = swin + 3 * c;
        tm |= (b == wn[0]) & (o >= wn[1]) & (o <= wn[2]);
      }
      if (!tm) continue;
    }
    const float xv = x[r], yv = y[r];
    const float ex = __fmul_rn(kEps, maxp(envx, fabsf(xv)));
    const float ey = __fmul_rn(kEps, maxp(envy, fabsf(yv)));
    bool inbox = false, any_wide = false, any_strict = false, any_ring = false;
    for (int b = 0; b < k; ++b) {
      const float* bx = sbox + 4 * b;
      const float exk = maxp(ex, smarg[2 * b]);
      const float eyk = maxp(ey, smarg[2 * b + 1]);
      const bool wide = (xv >= __fsub_rn(bx[0], exk)) & (xv <= __fadd_rn(bx[2], exk)) &
                        (yv >= __fsub_rn(bx[1], eyk)) & (yv <= __fadd_rn(bx[3], eyk));
      const bool strict = (xv >= __fadd_rn(bx[0], exk)) & (xv <= __fsub_rn(bx[2], exk)) &
                          (yv >= __fadd_rn(bx[1], eyk)) & (yv <= __fsub_rn(bx[3], eyk));
      inbox |= (xv >= bx[0]) & (xv <= bx[2]) & (yv >= bx[1]) & (yv <= bx[3]);
      any_wide |= wide;
      any_strict |= strict;
      any_ring |= wide & !strict;
    }
    // a row in no widened box is neither counted (a box holding it holds
    // it widened) nor near
    if (!any_wide) continue;
    const float tx = __fdiv_rn(__fsub_rn(xv, xmin), dx);
    const float ty = __fdiv_rn(__fsub_rn(yv, ymin), dy);
    const float ttx = __fadd_rn(__fdiv_rn(ex, adx), __fmul_rn(kEps, fabsf(tx)));
    const float tty = __fadd_rn(__fdiv_rn(ey, ady), __fmul_rn(kEps, fabsf(ty)));
    const bool cell_band = (fabsf(__fsub_rn(tx, rintf(tx))) <= ttx) |
                           (fabsf(__fsub_rn(ty, rintf(ty))) <= tty);
    const bool band = cell_band | (any_ring & !any_strict);
    const bool in_env = (xv >= xmin) & (xv <= xmax) & (yv >= ymin) & (yv <= ymax);
    if (inbox & in_env & !band) {
      atomicAdd(grid + snap(ty, height) * width + snap(tx, width), 1);
    }
    const bool near = band & (tx >= -ttx) & (tx <= __fadd_rn((float)width, ttx)) &
                      (ty >= -tty) & (ty <= __fadd_rn((float)height, tty));
    if (near) {
      const int pos = atomicAdd(band_count, 1);
      if (pos < band_cap) band_idx[pos] = (int)r;
    }
  }
}

template <bool HAS_TIME>
int launch(const void* x, const void* y, const void* bins, const void* offs,
           const void* valid, const void* boxes, int k, const void* windows,
           int w, const void* env, float rw, float rh, int width, int height,
           void* grid, void* band_idx, void* band_count, int band_cap,
           long long n, cudaStream_t s) {
  auto kern = density_grid_kernel<HAS_TIME>;
  // the boxes, margins and windows (the wrapper keeps them within 48 KB)
  const size_t smem = sizeof(float) * (6 * (size_t)k + 3 * (size_t)w);
  const int threads = kThreads;
  // per instantiation: the resident blocks per SM of the last size asked
  // for (the grid is sized to fill the card once)
  static size_t last_smem = (size_t)-1;
  static int sms = 0, per_sm = 0;
  if (smem != last_smem) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    last_smem = smem;
  }
  long long blocks = (long long)sms * per_sm;
  const long long need = (n + threads - 1) / threads;
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;
  kern<<<(unsigned)blocks, threads, smem, s>>>(
      (const float*)x, (const float*)y, (const int*)bins, (const int*)offs,
      (const unsigned char*)valid, (const float*)boxes, k, (const int*)windows,
      w, (const float*)env, rw, rh, width, height, (int*)grid, (int*)band_idx,
      (int*)band_count, band_cap, n);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes. Device pointers: x, y float32[n]; bins, offs
// int32[n] (ignored unless has_time); valid bool[n]; boxes float32[k, 4];
// windows int32[w, 3]; env float32[4]; grid int32[height * width] zeroed;
// band_idx int32[band_cap]; band_count int32[1] zeroed. rw, rh = f32(1 /
// width), f32(1 / height). Launches on `stream`; returns a CUDA error code.
extern "C" int density_grid(int has_time, const void* x,
                            const void* y, const void* bins, const void* offs,
                            const void* valid, const void* boxes, int k,
                            const void* windows, int w, const void* env,
                            float rw, float rh, int width, int height,
                            void* grid, void* band_idx, void* band_count,
                            int band_cap, long long n, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (has_time) {
    return launch<true>(x, y, bins, offs, valid, boxes, k, windows, w, env, rw, rh, width,
                        height, grid, band_idx, band_count, band_cap, n, s);
  }
  return launch<false>(x, y, nullptr, nullptr, valid, boxes, k, nullptr, 0, env, rw, rh, width,
                       height, grid, band_idx, band_count, band_cap, n, s);
}
