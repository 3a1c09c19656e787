// pyramid_counts.cu: the aggregate pyramid's count grid of one z2 segment.
//
// Replaces the reference's XLA function make_pyramid_counts
// (geomesa_tpu/ops/aggregations.py, span "agg.pyramid"), which sorts the
// rows' flat cell ids and searchsorts the cell bounds (a psum across
// shards; one device is one shard here).
//
// Per row r with mask[r] (valid and finite geometry), its cell
//   cell = (yi[r] >> shift) << bits | (xi[r] >> shift),  shift = 31 - bits,
// counts one in an int32 [2^bits, 2^bits] row-major grid. xi, yi are the z2
// key's 31-bit grid coordinates (a masked row's lie in 0 .. 2^31 - 1), bits
// is in [2, 12]. The result is exact in any row order.
//
// Bound on Hopper: HBM. Each row is read once (9 B: xi, yi and the mask
// byte) and the grid written once (4 * 4^bits B, 64 MiB at bits = 12,
// more than the 50 MB L2).
//
// Design: count the key-sorted runs, and for a grid larger than L2 write
// each cell once. A cell is a prefix of the z2 key, z = interleave(cx, cy)
// (x in the even bits), so in a key-sorted block the rows' cells come in
// nondecreasing z order, in runs.
//
// * Tiles and loads. Rows are cut into tiles of kTile = 4096 rows at
//   multiples of kTile; a thread takes 16 consecutive rows (four 16-byte
//   loads of xi and of yi and one of the mask), one tile a CTA, four CTAs
//   an SM. On the H100 this reads the rows about as fast as a plain read
//   of them, and the per-row integer work beside it is hidden; layouts
//   with warp-contiguous loads, fewer instructions or persistent CTAs that
//   copied the next tile with cp.async all ran slower once counting was
//   added (more barriers, fewer CTAs an SM).
// * Small grids (bits <= kAtomicBits, at most 4 MB, which L2 holds): the
//   zero pass costs ~1 us, so the gap kernel zeroes the grid and the atomic
//   kernel adds every row, each thread's 16 rows as runs and a warp's runs
//   of one cell as one atomic (__match_any_sync): a hot cell costs one
//   atomic a warp's 512 rows, not one a 32.
// * Large grids (bits > kAtomicBits; at 12 bits 64 MiB, more than the 50
//   MB L2): ownership. There the small-grid path ran 1.9-2.8x slower on an
//   H100 (a 0.02 ms zero pass whose lines L2 evicts, then atomics that read
//   them back). The launcher names one key-sorted block [own_lo, own_hi)
//   (the wrapper's `starts`: the segment's longest block; without them all
//   n rows, taken as one block, so that rows out of order cost the
//   fallbacks below their time but stay exact). Tile k of that block owns
//   the z range (lo, hi], lo the z of the block's row just before the tile
//   (-1 for the block's first tile), hi the z of the tile's last row (the
//   grid's last cell for the block's last tile). These ranges partition the grid exactly when
//   the boundary rows are in z order, which each tile checks for its pair;
//   a pair out of order sets the fallback flag (below).
// * Runs and windows. A tile whose rows are in z order (each row's z at
//   least its predecessor's, lo first) counts its rows of z > lo in a
//   shared-memory window of 64 x 64 cells (an aligned square of the grid:
//   a z range of 4^6 cells), one shared atomic a thread-local run, and
//   stores the window's part of (lo, hi] into the row-major grid: every
//   owned cell once, its count or 0, in whole-sector int4 stores. It does
//   so for each window its rows touch, up to kMaxWindows (two windows
//   taken in turn, to drop a barrier a window, ran no faster). Its rows of
//   z == lo (a run shared with the tile before, or a hot cell that spans
//   tiles) form one head entry: one atomic a tile, not one a warp.
// * Long gaps. Windows of (lo, hi] that no row of the tile touches (the
//   ocean between clusters at 12 bits) go to a gap list, one entry a
//   window piece, that pyramid_counts_gap_kernel zeroes grid-stride: no
//   CTA writes megabytes alone.
// * Hazards. The shared runs are added by a later launch on the same stream
//   (pyramid_counts_atomic_kernel, after the tile and gap kernels), never
//   racing a store. A tile out of z order, or with more than kMaxWindows
//   windows, stores nothing: its range goes to the gap list and its rows to
//   the atomic kernel (the redo list). Masked rows outside the block (other
//   blocks of the segment) go to the atomic kernel too: the tiles wholly
//   outside it, and, through the redo list, a tile that straddles its
//   bounds when the tile kernel finds such a row there (a segment's pad
//   rows, masked, cost nothing). A boundary pair out of order, or a full
//   gap list, sets the fallback flag: the gap kernel then zeroes the whole
//   grid and the atomic kernel counts every row, so shuffled rows still
//   give the exact grid, more slowly.
// * Alignment. The 16-byte loads take 16 rows at a multiple of 16 from
//   16-byte aligned columns; the launcher picks the row-by-row loads when
//   any column's pointer is not 16-byte aligned (a slice such as xi[1:]),
//   and the last 16 rows of a column load row by row when n is not a
//   multiple of 16.
//
// Launches: small grids, the gap kernel (zeroing) and the atomic kernel;
// large grids, a 16-byte memset of the scratch header (device work that no
// pyramid_counts_* kernel name covers, so a profile of those leaves it
// out), then the tile, gap and atomic kernels. The caller sizes the
// scratch with pyramid_counts_scratch.

#include <cuda_runtime.h>

#include "launch_grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;                      // consecutive rows a thread
constexpr long long kTile = kThreads * kRows;  // rows a tile
constexpr int kMaxWinLog = 6;                  // windows of up to 64 x 64 cells
constexpr int kWinCells = 1 << (2 * kMaxWinLog);
constexpr int kMaxWindows = 16;                // windows a tile stores before it gives up
constexpr int kAtomicBits = 10;                // grids up to 4 MB: zeroed, then atomics
constexpr unsigned kFull = 0xffffffffu;

// scratch: four header words, then the gap, head and redo lists
constexpr int kFallback = 0, kGaps = 1, kHeads = 2, kRedo = 3, kHeader = 4;

struct Layout {
  long long tiles, gap_cap;
  __host__ __device__ Layout(long long n, int bits) {
    tiles = (n + kTile - 1) / kTile;
    const int wl = bits < kMaxWinLog ? bits : kMaxWinLog;
    // the owned ranges partition the grid, so their pieces number at most
    // the windows plus one a tile boundary
    gap_cap = (1ll << (2 * (bits - wl))) + tiles + 1;
  }
  __host__ __device__ long long words() const { return kHeader + 2 * gap_cap + 3 * tiles; }
  __device__ int2* gaps(int* s) const { return reinterpret_cast<int2*>(s + kHeader); }
  __device__ int2* heads(int* s) const {
    return reinterpret_cast<int2*>(s + kHeader + 2 * gap_cap);
  }
  __device__ int* redo(int* s) const { return s + kHeader + 2 * gap_cap + 2 * tiles; }
};

__device__ __forceinline__ int win_log(int bits) { return bits < kMaxWinLog ? bits : kMaxWinLog; }

// the low 16 bits of v to the even bits
__device__ __forceinline__ unsigned spread(unsigned v) {
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

// the even bits of v to the low 16
__device__ __forceinline__ unsigned compact(unsigned v) {
  v &= 0x55555555u;
  v = (v | (v >> 1)) & 0x33333333u;
  v = (v | (v >> 2)) & 0x0F0F0F0Fu;
  v = (v | (v >> 4)) & 0x00FF00FFu;
  v = (v | (v >> 8)) & 0x0000FFFFu;
  return v;
}

// a z cell's row-major index
__device__ __forceinline__ int row_major(int z, int bits) {
  return (int)((compact((unsigned)z >> 1) << bits) | compact((unsigned)z));
}

// bit j set where mask byte j of the four in w is not 0
__device__ __forceinline__ unsigned nonzero4(unsigned w) {
  unsigned t = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) >> 7 & 0x01010101u;
  return (t * 0x00204081u) >> 21 & 0xFu;
}

// rows base .. base + 15 (those below n) and their mask bits
template <bool VEC>
__device__ __forceinline__ void load_rows(const int* __restrict__ xi, const int* __restrict__ yi,
                                          const unsigned char* __restrict__ mask, long long base,
                                          long long n, int (&x)[kRows], int (&y)[kRows],
                                          unsigned& m) {
  if (VEC && base + kRows <= n) {
    const int4* x4 = reinterpret_cast<const int4*>(xi + base);
    const int4* y4 = reinterpret_cast<const int4*>(yi + base);
    const uint4 mk = *reinterpret_cast<const uint4*>(mask + base);
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const int4 a = x4[q], b = y4[q];
      x[4 * q] = a.x, x[4 * q + 1] = a.y, x[4 * q + 2] = a.z, x[4 * q + 3] = a.w;
      y[4 * q] = b.x, y[4 * q + 1] = b.y, y[4 * q + 2] = b.z, y[4 * q + 3] = b.w;
    }
    m = nonzero4(mk.x) | nonzero4(mk.y) << 4 | nonzero4(mk.z) << 8 | nonzero4(mk.w) << 12;
    return;
  }
  m = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const long long r = base + j;
    x[j] = y[j] = 0;
    if (r < n) {
      x[j] = xi[r], y[j] = yi[r];
      m |= (unsigned)(mask[r] != 0) << j;
    }
  }
}

// bits j of rows base + j in [a, b)
__device__ __forceinline__ unsigned rows_in(long long base, long long a, long long b) {
  long long j0 = a - base, j1 = b - base;
  j0 = j0 < 0 ? 0 : j0;
  j1 = j1 > kRows ? kRows : j1;
  if (j0 >= j1) return 0;
  return ((1u << (j1 - j0)) - 1) << j0;
}

// Stores the cells of window w whose z lies in [za, zb] into the row-major
// grid, each from the window's row-major counts `win` (zeroed as read) or
// 0 without one. It walks the least aligned square that holds [za, zb]
// (at least 4 x 4 cells), cells outside the range masked; a run of four
// cells wholly inside goes as one int4 store.
__device__ void store_piece(int* __restrict__ grid, int bits, int w, int za, int zb, int* win) {
  const int wl = win_log(bits), wsh = 2 * wl, wbase = w << wsh;
  const int a = za - wbase, b = zb - wbase;  // z inside the window
  int h = (32 - __clz(a ^ b) + 1) >> 1;
  h = h < 2 ? 2 : h;
  const int sq = a & ~((1 << (2 * h)) - 1);
  const bool whole = a == sq && b == sq + (1 << (2 * h)) - 1;
  const int sx = (int)compact(sq), sy = (int)compact(sq >> 1);
  const int x0 = (int)compact(wbase), y0 = (int)compact(wbase >> 1);
  const int cols = 1 << (h - 2);
  for (int q = threadIdx.x; q < (1 << (2 * h - 2)); q += kThreads) {
    const int ly = sy + (q >> (h - 2)), lx = sx + ((q & (cols - 1)) << 2);
    int4 v = make_int4(0, 0, 0, 0);
    if (win) {
      int4* p = reinterpret_cast<int4*>(win + (ly << wl) + lx);
      v = *p;
      *p = make_int4(0, 0, 0, 0);
    }
    int* dst = grid + ((long long)(y0 + ly) << bits) + x0 + lx;
    if (whole) {
      *reinterpret_cast<int4*>(dst) = v;
      continue;
    }
    const int z0 = (int)(spread(lx) | (spread(ly) << 1));  // cells lx .. lx + 3: z0 + 0, 1, 4, 5
    const bool i0 = z0 >= a && z0 <= b, i1 = z0 + 1 >= a && z0 + 1 <= b;
    const bool i2 = z0 + 4 >= a && z0 + 4 <= b, i3 = z0 + 5 >= a && z0 + 5 <= b;
    if (i0 && i1 && i2 && i3) {
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      if (i0) dst[0] = v.x;
      if (i1) dst[1] = v.y;
      if (i2) dst[2] = v.z;
      if (i3) dst[3] = v.w;
    }
  }
}

__device__ __forceinline__ int zcell(int x, int y, int shift) {
  return (int)(spread((unsigned)x >> shift) | (spread((unsigned)y >> shift) << 1));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
    pyramid_counts_tile_kernel(const int* __restrict__ xi, const int* __restrict__ yi,
                               const unsigned char* __restrict__ mask, int bits,
                               int* __restrict__ grid, long long n, long long own_lo,
                               long long own_hi, long long tile0, int* __restrict__ scratch) {
  __shared__ __align__(16) int counts[kWinCells];
  __shared__ int zlast[kThreads];
  __shared__ int windows[kMaxWindows];
  __shared__ int s_changes, s_heads, s_unsorted, s_foreign, s_gap_base;

  const Layout lay(n, bits);
  const int tid = threadIdx.x;
  const int shift = 31 - bits, wl = win_log(bits), wsh = 2 * wl;
  const int top = (1 << (2 * bits)) - 1;
  const long long k = tile0 + blockIdx.x, t0 = k * kTile;
  const long long r0 = t0 > own_lo ? t0 : own_lo;
  const long long r1 = t0 + kTile < own_hi ? t0 + kTile : own_hi;
  const bool last = t0 + kTile >= own_hi;
  int lo = -1;
  if (r0 > own_lo) lo = min(zcell(xi[r0 - 1], yi[r0 - 1], shift), top);

  for (int i = tid; i < kWinCells / 4; i += kThreads) {
    reinterpret_cast<int4*>(counts)[i] = make_int4(0, 0, 0, 0);
  }
  if (tid == 0) s_changes = s_heads = s_unsorted = s_foreign = 0;

  const long long base = t0 + (long long)tid * kRows;
  int x[kRows], y[kRows], z[kRows], v[kRows];
  unsigned m;
  load_rows<VEC>(xi, yi, mask, base, n, x, y, m);
  const unsigned in = rows_in(base, r0, r1);
  // masked rows of the tile outside the block (another block's, a pad's)
  const bool foreign = (m & ~in) != 0;
  m &= in;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const unsigned cx = (unsigned)x[j] >> shift, cy = (unsigned)y[j] >> shift;
    z[j] = (int)(spread(cx) | (spread(cy) << 1));
    // the window (z >> wsh) above the cell's row-major place inside it
    v[j] = (z[j] >> wsh) << (2 * kMaxWinLog) |
           (int)(((cy & ((1u << wl) - 1)) << wl) | (cx & ((1u << wl) - 1)));
  }
  zlast[tid] = z[kRows - 1];
  __syncthreads();

  // z order, head rows (z == lo), owned rows (z > lo) and the windows
  // where the rows' z leaves the previous row's window
  const int j0 = (int)(r0 - base);  // the block's first row of the tile, if this thread's
  int zp = tid ? zlast[tid - 1] : lo;
  bool unsorted = false;
  int heads = 0;
  unsigned own = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (!(in >> j & 1)) continue;
    if (j == j0) zp = lo;
    unsorted |= z[j] < zp;
    if (!unsorted && (j == j0 || ((z[j] ^ zp) >> wsh) != 0)) {
      const int at = atomicAdd(&s_changes, 1);
      if (at < kMaxWindows) windows[at] = z[j] >> wsh;
    }
    zp = z[j];
    if (m >> j & 1) {
      if (z[j] == lo) {
        ++heads;
      } else {
        own |= 1u << j;
      }
    }
  }
  heads = __reduce_add_sync(kFull, heads);
  unsorted = __any_sync(kFull, unsorted);
  const bool any_foreign = __any_sync(kFull, foreign);
  if ((tid & 31) == 0) {
    if (heads) atomicAdd(&s_heads, heads);
    if (unsorted) s_unsorted = 1;
    if (any_foreign) s_foreign = 1;
  }
  __syncthreads();

  const int hi = last ? top : min(zlast[kThreads - 1], top);
  if (hi < lo) {
    // the boundary rows are out of z order: the ranges overlap
    if (tid == 0) atomicExch(&scratch[kFallback], 1);
    return;
  }
  const bool give_up = s_unsorted || s_changes > kMaxWindows;
  const int nwin = give_up ? 0 : s_changes;
  const int wlo = (lo + 1) >> wsh, whi = hi >> wsh;
  int listed = 0;
  if (hi > lo) {
    for (int i = 0; i < nwin; ++i) {
      const int w = windows[i];
      if (w < wlo || w > whi) continue;
      ++listed;
      int cur = -1, cnt = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (!(own >> j & 1) || (v[j] >> (2 * kMaxWinLog)) != w) continue;
        const int c = v[j] & (kWinCells - 1);
        if (c != cur) {
          if (cnt) atomicAdd(&counts[cur], cnt);
          cur = c, cnt = 0;
        }
        ++cnt;
      }
      if (cnt) atomicAdd(&counts[cur], cnt);
      __syncthreads();
      store_piece(grid, bits, w, max(lo + 1, w << wsh), min(hi, ((w + 1) << wsh) - 1), counts);
      __syncthreads();
    }
  }

  // the windows of (lo, hi] left unstored go to the gap list
  const int span = hi > lo ? whi - wlo + 1 : 0;
  const int gaps = span - listed;
  if (gaps > 0) {
    if (tid == 0) {
      const unsigned at = atomicAdd(reinterpret_cast<unsigned*>(&scratch[kGaps]), (unsigned)gaps);
      const bool fits = (long long)at + gaps <= lay.gap_cap;
      if (!fits) atomicExch(&scratch[kFallback], 1);
      s_gap_base = fits ? (int)at : -1;
    }
    __syncthreads();
    const int at = s_gap_base;
    if (at >= 0) {
      int2* out = lay.gaps(scratch);
      for (int i = tid; i < span; i += kThreads) {
        const int w = wlo + i;
        int before = 0;
        bool stored = false;
        for (int q = 0; q < nwin; ++q) {
          const int s = windows[q];
          stored |= s == w;
          before += s >= wlo && s < w;
        }
        if (!stored) out[at + i - before] = make_int2(max(lo + 1, w << wsh), min(hi, ((w + 1) << wsh) - 1));
      }
    }
  }
  if (tid == 0) {
    // a redo entry: the tile's rows left to the atomic kernel, all of them
    // (low bit 1) or those outside the block
    if (give_up || s_foreign) {
      lay.redo(scratch)[atomicAdd(&scratch[kRedo], 1)] = (int)(k << 1 | give_up);
    }
    if (!give_up && s_heads) {
      lay.heads(scratch)[atomicAdd(&scratch[kHeads], 1)] = make_int2(lo, s_heads);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    pyramid_counts_gap_kernel(int bits, int* __restrict__ grid, long long n,
                              int* __restrict__ scratch, int zero_all) {
  if (zero_all || scratch[kFallback]) {
    const long long quads = (1ll << (2 * bits)) / 4;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < quads; i += stride) {
      reinterpret_cast<int4*>(grid)[i] = make_int4(0, 0, 0, 0);
    }
    return;
  }
  const Layout lay(n, bits);
  const int wsh = 2 * win_log(bits);
  const long long gaps = (unsigned)scratch[kGaps];
  const int2* list = lay.gaps(scratch);
  for (long long i = blockIdx.x; i < gaps; i += gridDim.x) {
    const int2 e = list[i];
    store_piece(grid, bits, e.x >> wsh, e.x, e.y, nullptr);
  }
}

// Adds the masked rows of tile k in [a, b) but not in [ex_lo, ex_hi) to
// the grid: each thread's consecutive rows of one cell are one run, a
// warp's runs of one cell one atomic.
template <bool VEC>
__device__ void add_rows(const int* __restrict__ xi, const int* __restrict__ yi,
                         const unsigned char* __restrict__ mask, int bits, int* __restrict__ grid,
                         long long n, long long k, long long a, long long b, long long ex_lo,
                         long long ex_hi) {
  const int shift = 31 - bits, lane = threadIdx.x & 31;
  const long long base = k * kTile + (long long)threadIdx.x * kRows;
  int x[kRows], y[kRows];
  unsigned m;
  load_rows<VEC>(xi, yi, mask, base, n, x, y, m);
  m &= rows_in(base, a, b) & ~rows_in(base, ex_lo, ex_hi);
  int cur = 0, cnt = 0;
#pragma unroll
  for (int j = 0; j <= kRows; ++j) {
    const bool row = j < kRows && (m >> j & 1);
    const int cell = j < kRows ? ((y[j] >> shift) << bits) | (x[j] >> shift) : 0;
    const bool flush = cnt > 0 && (j == kRows || (row && cell != cur));
    const unsigned act = __ballot_sync(kFull, flush);
    if (flush) {
      const unsigned peers = __match_any_sync(act, cur);
      const int total = __reduce_add_sync(peers, cnt);
      if (lane == __ffs(peers) - 1) atomicAdd(&grid[cur], total);
      cnt = 0;
    }
    if (row) {
      cur = cell;
      ++cnt;
    }
  }
}

// After the tile and gap kernels: with `all_rows` (a grid that L2 holds,
// zeroed by the gap kernel) or the fallback flag, every masked row; else
// the head entries, the redo entries' rows and the rows of the tiles
// wholly outside the block.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    pyramid_counts_atomic_kernel(const int* __restrict__ xi, const int* __restrict__ yi,
                                 const unsigned char* __restrict__ mask, int bits,
                                 int* __restrict__ grid, long long n, long long own_lo,
                                 long long own_hi, int* __restrict__ scratch, int all_rows) {
  const Layout lay(n, bits);
  if (all_rows || scratch[kFallback]) {
    for (long long k = blockIdx.x; k < lay.tiles; k += gridDim.x) {
      add_rows<VEC>(xi, yi, mask, bits, grid, n, k, k * kTile, min((k + 1) * kTile, n), 0, 0);
    }
    return;
  }
  const long long heads = scratch[kHeads];
  const int2* hl = lay.heads(scratch);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < heads;
       i += (long long)gridDim.x * blockDim.x) {
    const int2 h = hl[i];
    atomicAdd(&grid[row_major(h.x, bits)], h.y);
  }
  // the redo tiles, then the tiles before and after the block's tiles
  const long long redo = scratch[kRedo];
  const int* rl = lay.redo(scratch);
  const bool block = own_lo < own_hi;
  const long long before = block ? own_lo / kTile : lay.tiles;
  const long long after0 = block ? (own_hi - 1) / kTile + 1 : lay.tiles;
  const long long after = lay.tiles - after0;
  for (long long it = blockIdx.x; it < redo + before + after; it += gridDim.x) {
    if (it < redo) {
      const long long k = rl[it] >> 1;
      add_rows<VEC>(xi, yi, mask, bits, grid, n, k, k * kTile, min((k + 1) * kTile, n),
                    rl[it] & 1 ? 0 : own_lo, rl[it] & 1 ? 0 : own_hi);
    } else {
      const long long k = it < redo + before ? it - redo : after0 + (it - redo - before);
      add_rows<VEC>(xi, yi, mask, bits, grid, n, k, k * kTile, min((k + 1) * kTile, n), 0, 0);
    }
  }
}

template <typename Kernel>
cudaError_t grid_of(Kernel kern, int* blocks) {
  long long resident = 0;
  cudaError_t err = launch_grid::resident_blocks(kern, kThreads, 0, &resident);
  *blocks = (int)resident;
  return err;
}

template <bool VEC>
cudaError_t launch(const int* xi, const int* yi, const unsigned char* mask, int bits, int* out,
                   long long n, long long own_lo, long long own_hi, int* scratch,
                   cudaStream_t s) {
  // a grid that L2 holds: zeroed, then every row's runs added
  const bool small = bits <= kAtomicBits;
  cudaError_t err = cudaSuccess;
  if (!small) {
    err = cudaMemsetAsync(scratch, 0, kHeader * sizeof(int), s);
    if (err != cudaSuccess) return err;
  }
  if (!small && own_lo < own_hi) {
    const long long k0 = own_lo / kTile, k1 = (own_hi - 1) / kTile;
    pyramid_counts_tile_kernel<VEC><<<(unsigned)(k1 - k0 + 1), kThreads, 0, s>>>(
        xi, yi, mask, bits, out, n, own_lo, own_hi, k0, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  int blocks = 0;
  err = grid_of(pyramid_counts_gap_kernel, &blocks);
  if (err != cudaSuccess) return err;
  pyramid_counts_gap_kernel<<<blocks, kThreads, 0, s>>>(bits, out, n, scratch,
                                                        (int)(small || own_lo == own_hi));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = grid_of(pyramid_counts_atomic_kernel<VEC>, &blocks);
  if (err != cudaSuccess) return err;
  pyramid_counts_atomic_kernel<VEC><<<blocks, kThreads, 0, s>>>(xi, yi, mask, bits, out, n,
                                                                own_lo, own_hi, scratch,
                                                                (int)small);
  return cudaGetLastError();
}

}  // namespace

// int32 words of scratch pyramid_counts needs for n rows at bits
extern "C" long long pyramid_counts_scratch(long long n, int bits) {
  if (bits < 2 || bits > 12 || n < 0) return -1;
  return Layout(n, bits).words();
}

// The grid `out` of rows [0, n); rows [own_lo, own_hi) are one key-sorted
// block (any order is still counted right). `scratch` holds
// pyramid_counts_scratch(n, bits) int32 words, `scratch_words` of them.
extern "C" int pyramid_counts(const void* xi, const void* yi, const void* mask, int bits,
                              void* out, long long n, void* stream, long long own_lo,
                              long long own_hi, void* scratch, long long scratch_words) {
  if (bits < 2 || bits > 12 || n < 0 || n > (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (own_lo < 0 || own_lo > own_hi || own_hi > n) return (int)cudaErrorInvalidValue;
  if (!scratch || scratch_words < Layout(n, bits).words()) return (int)cudaErrorInvalidValue;
  const bool vec = (((size_t)xi | (size_t)yi | (size_t)mask) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* x = (const int*)xi;
  const int* y = (const int*)yi;
  const unsigned char* m = (const unsigned char*)mask;
  return (int)(vec ? launch<true>(x, y, m, bits, (int*)out, n, own_lo, own_hi, (int*)scratch, s)
                   : launch<false>(x, y, m, bits, (int*)out, n, own_lo, own_hi, (int*)scratch, s));
}
