// pyramid_counts.cu: the aggregate pyramid's count grid of one z2 segment.
//
// Replaces the reference's XLA function make_pyramid_counts
// (geomesa_tpu/ops/aggregations.py, span "agg.pyramid"), which sorts the
// rows' flat cell ids and searchsorts the cell bounds (a psum across
// shards; one device is one shard here).
//
// Per row r with mask[r] (valid and finite geometry), its cell
//   cell = (yi[r] >> shift) << bits | (xi[r] >> shift),  shift = 31 - bits,
// adds one to grid[cell] of an int32 [2^bits, 2^bits] grid, which the
// launcher zeroes first. xi, yi are the z2 key's 31-bit grid coordinates
// (0 .. 2^31 - 1), bits is in [2, 12].
//
// Exactness: integer atomics give the same grid in any order, so the grid
// equals the sort-and-search of the reference and the host build exactly.
//
// Bound on Hopper: HBM. Each row is read once (9 B: xi, yi and the mask
// byte) and the grid written once (4 * 4^bits B, 64 MiB at bits = 12).
//
// Design (simple first): pyramid_counts_zero_kernel zeroes the grid with
// 16-byte stores (4^bits is a multiple of 4 cells), then
// pyramid_counts_kernel takes a grid-stride loop, one row a thread. The lanes
// of a warp whose rows are in the mask group by cell with
// __match_any_sync, and the lowest lane of each group adds the group's
// size with one atomicAdd. A z2 segment is sorted by key within each
// block and a cell is a prefix of the z2 key, so a warp's rows mostly
// share one cell and the atomics number about n / 32; any order is still
// counted right.

#include <cuda_runtime.h>

#include "launch_grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void pyramid_counts_zero_kernel(int4* __restrict__ grid, long long quads) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < quads; i += stride) {
    grid[i] = make_int4(0, 0, 0, 0);
  }
}

__global__ void pyramid_counts_kernel(const int* __restrict__ xi, const int* __restrict__ yi,
                                      const unsigned char* __restrict__ mask, int bits,
                                      int* __restrict__ grid, long long n) {
  const int shift = 31 - bits;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop bound is the same for every lane of a block: each warp takes
  // the ballot and the match together
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += stride) {
    const long long r = base + threadIdx.x;
    const bool in = r < n && mask[r] != 0;
    const unsigned active = __ballot_sync(kFull, in);
    if (in) {
      const int cell = ((yi[r] >> shift) << bits) | (xi[r] >> shift);
      const unsigned peers = __match_any_sync(active, cell);
      if (lane == __ffs(peers) - 1) atomicAdd(&grid[cell], __popc(peers));
    }
  }
}

}  // namespace

extern "C" int pyramid_counts(const void* xi, const void* yi, const void* mask, int bits,
                              void* out, long long n, void* stream) {
  if (bits < 2 || bits > 12 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long quads = (1ll << (2 * bits)) / 4;
  long long resident = 0;
  cudaError_t err = launch_grid::resident_blocks(pyramid_counts_zero_kernel, kThreads, 0,
                                                 &resident);
  if (err != cudaSuccess) return (int)err;
  long long need = (quads + kThreads - 1) / kThreads;
  pyramid_counts_zero_kernel<<<(int)(need < resident ? need : resident), kThreads, 0, s>>>(
      (int4*)out, quads);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;
  err = launch_grid::resident_blocks(pyramid_counts_kernel, kThreads, 0, &resident);
  if (err != cudaSuccess) return (int)err;
  need = (n + kThreads - 1) / kThreads;
  pyramid_counts_kernel<<<(int)(need < resident ? need : resident), kThreads, 0, s>>>(
      (const int*)xi, (const int*)yi, (const unsigned char*)mask, bits, (int*)out, n);
  return (int)cudaGetLastError();
}
