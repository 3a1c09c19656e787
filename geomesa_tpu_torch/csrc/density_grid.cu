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
// widened box the band (about 40 operations and 4 divides).
//
// The first design (one row a thread per grid-stride step: a 1-byte valid
// load, a branch, then bins/offs, then x/y, so two or three dependent
// round trips with 1-9 bytes in flight per thread; the full band test of
// every live row over all K boxes, of which K - 1 were inverted pads; one
// global atomic per certain row) took 0.106 ms at 8M z2 rows and 0.194 ms
// at 20M z3 rows on an H100 80GB HBM3 at 700 W, 4.9x and 2.8x its bound.
// This design:
//   * each thread takes kV = 4 consecutive rows per step: valid as one
//     4-byte load, bins and offs as one 16-byte load each, issued
//     together; x and y as one 16-byte load each, issued with them when
//     there is no time, and with time only by lanes with a row in the
//     window (a z3 table is sorted by bin, so a DURING window leaves whole
//     runs of lanes that skip their 32-byte sectors); 64 registers, so 32
//     warps an SM keep the loads in flight (8 rows a thread held 95-103
//     registers and 16 warps, and was slower than the first design);
//   * a row far from every box (a finite coordinate beyond the box's
//     widest possible margin, two compares a side) skips the exact band
//     test, which only rows near a box then run;
//   * each block stages only the boxes that can hold or band a row: the
//     inverted pads (1, 1, 0, 0) of pad_boxes are dropped when the
//     envelope's margins are below 0.25 and a finite box is left, where a
//     pad widens to nothing (a row with x and y both infinite is wide in
//     every finite box already), so the grid, band and count are unchanged;
//     windows with lo > hi (pad_windows' pads) are dropped too;
//   * a lane's consecutive certain rows in one cell (rows sorted by z
//     share cells in runs) add with one atomic; grouping the lanes of a
//     warp by cell (__match_any_sync, __reduce_add_sync) was slower on the
//     card than these per-lane runs; the band takes a ballot, one
//     atomicAdd per warp on the counter and a prefix slot per lane.
// Measured by chip_smoke.py --ab on an H100 80GB HBM3 at 700 W, device time
// per launch, the first design's in turns on the same inputs: z2, 8M rows,
// 0.0461 ms at 256 x 128 (was 0.1066) and 0.0475 at 512 x 512 (was 0.1061),
// 2.1x and 2.2x the 0.0215 / 0.0218 ms bound; z3, 20M rows, 0.1197 ms at
// 64 x 32 (was 0.1951) and 0.1149 at 256 x 256 (was 0.1942), 1.7x and 1.6x
// the 0.0704 / 0.0705 ms bound.

#include <cuda_runtime.h>

#include "launch_grid.cuh"

namespace {

constexpr float kEps = 1.9073486328125e-06f;  // 16 * 2^-23
constexpr int kV = 4;  // consecutive rows per thread per step (one 16-byte load)
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;  // 64 registers a thread: 32 warps per SM
constexpr unsigned kFull = 0xffffffffu;

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

struct Env {
  float xmin, ymin, xmax, ymax, dx, dy, adx, ady, envx, envy;
};

// The cell of a certain row (else -1) and whether the row is near, for a
// row that passed valid and the window.
__device__ __forceinline__ void classify(float xv, float yv, const float* sbox,
                                         const float* smarg, int k, const Env& e,
                                         int width, int height, int& cell, bool& near) {
  cell = -1;
  near = false;
  const float ex = __fmul_rn(kEps, maxp(e.envx, fabsf(xv)));
  const float ey = __fmul_rn(kEps, maxp(e.envy, fabsf(yv)));
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
  if (!any_wide) return;
  const float tx = __fdiv_rn(__fsub_rn(xv, e.xmin), e.dx);
  const float ty = __fdiv_rn(__fsub_rn(yv, e.ymin), e.dy);
  const float ttx = __fadd_rn(__fdiv_rn(ex, e.adx), __fmul_rn(kEps, fabsf(tx)));
  const float tty = __fadd_rn(__fdiv_rn(ey, e.ady), __fmul_rn(kEps, fabsf(ty)));
  const bool cell_band = (fabsf(__fsub_rn(tx, rintf(tx))) <= ttx) |
                         (fabsf(__fsub_rn(ty, rintf(ty))) <= tty);
  const bool band = cell_band | (any_ring & !any_strict);
  const bool in_env = (xv >= e.xmin) & (xv <= e.xmax) & (yv >= e.ymin) & (yv <= e.ymax);
  if (inbox & in_env & !band) cell = snap(ty, height) * width + snap(tx, width);
  near = band & (tx >= -ttx) & (tx <= __fadd_rn((float)width, ttx)) & (ty >= -tty) &
         (ty <= __fadd_rn((float)height, tty));
}

// True when no kept box, widened by any margin the row can get, holds the
// row: then it is neither counted nor near (classify's any_wide is false).
// Only a finite coordinate can reject (an infinite one has an infinite
// margin; a NaN one fails classify's compares anyway).
__device__ __forceinline__ bool far_from_boxes(float xv, float yv, const float* sfar, int k) {
  const bool fx = isfinite(xv), fy = isfinite(yv);
  bool far = true;
  for (int b = 0; b < k; ++b) {
    const float* q = sfar + 4 * b;
    far &= (fx & ((xv < q[0]) | (xv > q[1]))) | (fy & ((yv < q[2]) | (yv > q[3])));
  }
  return far;
}

// a lane's kV = 4 consecutive 4-byte values as one 16-byte load
template <typename T, typename T4>
__device__ __forceinline__ void load_rows(const T* p, T* v) {
  const T4 a = *reinterpret_cast<const T4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// bit j: the valid byte of row j of the lane (one 4-byte load)
__device__ __forceinline__ unsigned load_valid(const unsigned char* p) {
  const unsigned word = *reinterpret_cast<const unsigned*>(p);
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kV; ++j) bits |= (unsigned)(((word >> (8 * j)) & 0xffu) != 0) << j;
  return bits;
}

template <bool HAS_TIME>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
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
  float* sbox = smem;            // [kept, 4] (x0, y0, x1, y1)
  float* smarg = smem + 4 * k;   // [kept, 2] eps * max(|x0|, |x1|), eps * max(|y0|, |y1|)
  float* sfar = smem + 6 * k;    // [kept, 4] the quick reject bounds (qx0, qx1, qy0, qy1)
  int* swin = (int*)(smem + 10 * k);  // [w, 3]
  __shared__ int s_kept, s_wins;
  if (threadIdx.x == 0) {
    // a window with lo > hi (pad_windows' pads) holds no row
    int nw = 0;
    for (int i = 0; HAS_TIME && i < w; ++i) {
      const int* wn = windows + 3 * i;
      if (wn[1] > wn[2]) continue;
      for (int c = 0; c < 3; ++c) swin[3 * nw + c] = wn[c];
      ++nw;
    }
    s_wins = nw;
    // a pad (1, 1, 0, 0) widens to a box only with margins of 0.5 or more:
    // with the envelope's below 0.25 that takes an infinite x and y, a row
    // every finite box holds widened already
    const float mx0 = maxp(fabsf(env[0]), fabsf(env[2]));
    const float my0 = maxp(fabsf(env[1]), fabsf(env[3]));
    const float mx = __fmul_rn(kEps, mx0);
    const float my = __fmul_rn(kEps, my0);
    bool finite_box = false;
    for (int b = 0; b < k; ++b) {
      const float* bx = boxes + 4 * b;
      finite_box |= isfinite(bx[0]) && isfinite(bx[1]) && isfinite(bx[2]) &&
                    isfinite(bx[3]) && bx[0] <= bx[2] && bx[1] <= bx[3];
    }
    const bool drop_pads = finite_box && mx < 0.25f && my < 0.25f;
    int m = 0;
    for (int b = 0; b < k; ++b) {
      const float* bx = boxes + 4 * b;
      const bool pad = bx[0] == 1.0f && bx[1] == 1.0f && bx[2] == 0.0f && bx[3] == 0.0f;
      if (pad && drop_pads) continue;
      for (int c = 0; c < 4; ++c) sbox[4 * m + c] = bx[c];
      smarg[2 * m] = __fmul_rn(kEps, maxp(fabsf(bx[0]), fabsf(bx[2])));
      smarg[2 * m + 1] = __fmul_rn(kEps, maxp(fabsf(bx[1]), fabsf(bx[3])));
      // a finite x below qx0 or above qx1 is outside this box widened by
      // any margin the row can get: for |x| <= bx = max(env, box) its
      // margin is at most ex = eps * bx; beyond bx it is eps * |x|, which
      // cannot reach back over the 2 ex slack (likewise y)
      const float ex = __fmul_rn(kEps, maxp(mx0, maxp(fabsf(bx[0]), fabsf(bx[2]))));
      const float ey = __fmul_rn(kEps, maxp(my0, maxp(fabsf(bx[1]), fabsf(bx[3]))));
      sfar[4 * m] = __fsub_rn(bx[0], __fmul_rn(2.0f, ex));
      sfar[4 * m + 1] = __fadd_rn(bx[2], __fmul_rn(2.0f, ex));
      sfar[4 * m + 2] = __fsub_rn(bx[1], __fmul_rn(2.0f, ey));
      sfar[4 * m + 3] = __fadd_rn(bx[3], __fmul_rn(2.0f, ey));
      ++m;
    }
    s_kept = m;
  }
  __syncthreads();
  const int kept = s_kept, wins = s_wins;

  Env e;
  e.xmin = env[0];
  e.ymin = env[1];
  e.xmax = env[2];
  e.ymax = env[3];
  e.dx = __fmul_rn(__fsub_rn(e.xmax, e.xmin), rw);
  e.dy = __fmul_rn(__fsub_rn(e.ymax, e.ymin), rh);
  e.adx = fabsf(e.dx);
  e.ady = fabsf(e.dy);
  e.envx = maxp(fabsf(e.xmin), fabsf(e.xmax));
  e.envy = maxp(fabsf(e.ymin), fabsf(e.ymax));

  const int lane = threadIdx.x & 31;
  const long long chunk_rows = 32LL * kV;
  const long long nchunks = (n + chunk_rows - 1) / chunk_rows;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  // one warp per chunk of 32 * kV rows: the loop and every vote below are
  // warp-uniform
  for (long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; c < nchunks;
       c += nwarps) {
    const long long base = c * chunk_rows + (long long)lane * kV;
    unsigned live = 0;  // bit j: row base + j is valid (and in a window)
    float xs[kV], ys[kV];
    if (base < n) {  // n % kV == 0: a lane's rows are all in or all out
      live = load_valid(valid + base);
      if (HAS_TIME) {
        int bs[kV], os[kV];
        load_rows<int, int4>(bins + base, bs);
        load_rows<int, int4>(offs + base, os);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          bool tm = false;
          for (int q = 0; q < wins; ++q) {
            const int* wn = swin + 3 * q;
            tm |= (bs[j] == wn[0]) & (os[j] >= wn[1]) & (os[j] <= wn[2]);
          }
          live &= ~((unsigned)!tm << j);
        }
        if (live) {
          load_rows<float, float4>(x + base, xs);
          load_rows<float, float4>(y + base, ys);
        }
      } else {
        load_rows<float, float4>(x + base, xs);
        load_rows<float, float4>(y + base, ys);
      }
    }
    int cells[kV];
    unsigned near = 0;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      cells[j] = -1;
      if ((live >> j & 1u) && !far_from_boxes(xs[j], ys[j], sfar, kept)) {
        bool nr;
        classify(xs[j], ys[j], sbox, smarg, kept, e, width, height, cells[j], nr);
        near |= (unsigned)nr << j;
      }
    }
    // band: per row slot, one counter atomic per warp, each near lane
    // writing at its prefix (the count stays the true one past the cap)
    if (__any_sync(kFull, near)) {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const bool nr = near >> j & 1u;
        const unsigned bal = __ballot_sync(kFull, nr);
        if (bal) {
          const int leader = __ffs(bal) - 1;
          int pos = 0;
          if (lane == leader) pos = atomicAdd(band_count, __popc(bal));
          pos = __shfl_sync(kFull, pos, leader) + __popc(bal & ((1u << lane) - 1u));
          if (nr && pos < band_cap) band_idx[pos] = (int)(base + j);
        }
      }
    }
    // grid: a lane's consecutive rows in one cell (rows sorted by z share
    // cells in runs) add with one atomic
    int run = -1, cnt = 0;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      if (cells[j] >= 0) {
        if (cells[j] != run) {
          if (cnt) atomicAdd(grid + run, cnt);
          run = cells[j];
          cnt = 0;
        }
        ++cnt;
      }
    }
    if (cnt) atomicAdd(grid + run, cnt);
  }
}

template <bool HAS_TIME>
int launch(const void* x, const void* y, const void* bins, const void* offs,
           const void* valid, const void* boxes, int k, const void* windows,
           int w, const void* env, float rw, float rh, int width, int height,
           void* grid, void* band_idx, void* band_count, int band_cap,
           long long n, cudaStream_t s) {
  auto kern = density_grid_kernel<HAS_TIME>;
  // the boxes, margins, reject bounds and windows (the wrapper keeps them
  // within 48 KB)
  const size_t smem = sizeof(float) * (10 * (size_t)k + 3 * (size_t)w);
  // the grid fills the device once
  long long blocks = 0;
  const cudaError_t err = launch_grid::resident_blocks(kern, kThreads, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)kThreads * kV;
  const long long need = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;
  kern<<<(unsigned)blocks, kThreads, smem, s>>>(
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
// width), f32(1 / height). n is a multiple of 4 (kV); x, y, bins and offs
// are 16-byte aligned, valid 4-byte aligned. Launches on `stream`; returns a
// CUDA error code.
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
