// join: the dual masks of a spatial join's probe chunk, for `contains`
// (join_pip) and `dwithin` (join_dwithin).
//
// Replaces the device work of the reference's geomesa_tpu/ops/join.py
// _pip_fn (:548, "join_pip") and _dwithin_fn (:592, "join_dwithin"). The
// reference launches once per bucket group of a probe chunk, each group's
// rows NaN-padded to a power of two; here one launch answers a whole chunk:
// the chunk's routed rows arrive sorted by group with CSR offsets `goff`
// (group g holds rows goff[g] .. goff[g + 1]) and each group's row `grow[g]`
// in the resident candidate matrix `cand` int32[B, C] (-1 pads).
//
// Output: u8 flags [C, R], slot-major: bit 0 accept, bit 1 check, 0 for a
// -1 slot or a geometry with no edges.
//
// join_pip, per (row, candidate) in f32 with one rounding per operation
// (built with -fmad=false, IEEE division), as the reference's arithmetic:
//   straddles = (y0 > py) != (y1 > py)                       a live edge
//   xint = x0 + ((py - y0) * (x1 - x0)) / (y1 - y0)          (straddling)
//   inside = odd count of straddling edges with xint > px
//   abx = x1 - x0, aby = y1 - y0, den = abx*abx + aby*aby (1 when 0)
//   t = clip(((px - x0) * abx + (py - y0) * aby) / den, 0, 1)
//   dx = px - (x0 + t * abx), dy = py - (y0 + t * aby)
//   near = some live edge with dx*dx + dy*dy <= eps * eps
// accept = inside & ~near, check = near. The reference takes min(d2) over
// the edges; "some edge within eps" is the same for finite rows and, like
// jnp.min's NaN, false for a NaN row (every compare fails).
//
// join_dwithin, per (row, candidate), the f32 haversine of the reference's
// geometry.py haversine_m_f32 (:87):
//   rad = (float)(pi / 180), lon/lat = deg * rad
//   s1 = sinf((lat2 - lat1) / 2), s2 = sinf((lon2 - lon1) / 2)
//   a = s1*s1 + (cosf(lat1) * cosf(lat2)) * (s2*s2)
//   d = (2 * 6371008.8f) * asinf(min(1, sqrtf(a)))      (NaN passes min)
// accept = d <= lo, check = lo < d <= hi, lo = r - eps and hi = r + eps
// in f32 (the launcher takes them), both false for a NaN d. CUDA's sinf /
// cosf / asinf differ from XLA's by a few ulps, so a pair whose distance
// lies within a few ulps of lo or hi may move between accept and check;
// the band is at least 16 m wide and the host decides every check pair in
// f64, so the pairs do not change.
//
// Bound on Hopper: FP32 operations. In the SASS of join_pip's edge loop
// (sm_90a, -fmad=false) a (row, candidate, live edge) costs 34 FP32-pipe
// instructions (the straddle test, den, t with its IEEE division, the
// clamp, dx, dy, d2 and its compare) and a straddling edge 10 more (xint's
// division, multiply, add and compare), the same counts in this design as
// in the earlier one; the loop runs 45-62 instructions an edge in all
// (loads, branches, the divisions' range checks, a straddle's block).
// join_dwithin's pair costs 103 FP32-pipe instructions on the path every
// finite row takes (two sinf, a cosf, the two halvings, sqrtf and asinf;
// the large-argument reductions never run for coordinates in degrees);
// this design adds the build point's cosf to every pair (~114 in its
// SASS), which the bound does not count (an earlier design took it once a
// block). chip_smoke.py's JOIN_PIP_EDGE_FOPS, JOIN_PIP_STRADDLE_FOPS and
// JOIN_DWITHIN_FOPS hold the bound's counts. A chunk's reads (8 B a row, the candidate's edges or
// point) and writes (1 B a pair) are small beside that.
//
// The grid: threads a (row, candidate slot) pair, not a block a (group,
// slot) whose threads walk the group's rows. blockIdx.x takes a tile of
// rows, blockIdx.y a slot (striding over slots past gridDim.y). join_pip
// gives a pair kLanes = 2 threads, each taking every other edge of the
// candidate (the crossing parities XOR and the bands OR across the two by
// a shuffle), in blocks of 256 threads over 128 rows: a 2,048-row chunk at
// 128 slots is 16 x 128 blocks. So no thread walks a group's rows one after
// another, and the longest thread walks half of one candidate's edges.
// join_dwithin takes a thread a pair, 128 rows a block. Two threads of a
// block search goff for the groups of its first and last rows (the last g
// with goff[g] <= r: searchsorted's side="right", as the plain edition's
// _group_candidates); a thread's group lies between them, which needs no
// search for a tile inside one group. A dead pair (a -1 slot or an
// edgeless geometry) stores its 0 and exits; a warp stores neighbouring
// rows of one slot, contiguous bytes of the slot-major output.
//
// Measured against the alternatives, H100 (PERF.md): one thread a pair
// ran ~9% slower on config #1's first probe chunk and four lanes no
// faster, with a dearer floor; 64-row tiles were no faster, and two rows a
// thread and an inline, branch-free fast path of the division (more
// instructions an edge) slower. The loop is bound by the instructions it
// runs more than by the latency of a thread's chain of divisions.
//
// Edges: rows are sorted by group, so most tiles lie inside one group and
// every thread of the block shares one candidate. Such a block stages the
// candidate's edges through shared memory in tiles of kTile edges (any
// count: rings with holes, polygons past one tile) and each edge is a
// broadcast read. A tile that straddles groups reads each thread's edges
// through the read-only path (__ldg), where the threads of a warp that
// share a candidate read one address.
//
// Parity: each (row, candidate, edge)'s arithmetic, operation for
// operation and in the same order, is the one the plain edition and the
// reference do; only which thread does it moved. The crossing count's
// parity is the XOR of its lanes' parities and "some edge within eps" the
// OR of theirs, so the flags are the same bits whatever the grid.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

// join_pip: threads a (row, slot) pair, each taking every kLanes-th edge of
// the candidate, and threads a block; rows a block follow
constexpr int kLanes = 2;
constexpr int kPipThreads = 256;
constexpr int kPipRows = kPipThreads / kLanes;
static_assert(32 % kLanes == 0, "a pair's lanes lie in one warp");
// join_dwithin: rows a block (one a thread)
constexpr int kRows = 128;
// edges a shared-memory tile (8 KB)
constexpr int kTile = 512;
// the grid's y extent (slots past it are taken by striding)
constexpr int kMaxGridY = 65535;

// The last group g in [lo, hi] with goff[g] <= r.
__device__ __forceinline__ int group_of(const int* __restrict__ goff, int lo, int hi, int r) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(goff + mid) <= r) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The groups of a tile's first and last rows (r0, last) into s[0], s[1]:
// two threads search goff, once a block. Groups ascend with the row, so a
// thread's group lies between them, which needs no search at all for a
// tile inside one group.
__device__ __forceinline__ void tile_groups(const int* __restrict__ goff, int groups, int r0,
                                            int last, int* s) {
  if (threadIdx.x < 2) s[threadIdx.x] = group_of(goff, 0, groups - 1, threadIdx.x ? last : r0);
  __syncthreads();
}

// One row against one edge: flips the crossing parity, sets near.
__device__ __forceinline__ void pip_edge(float4 q, float x, float y, float eps2, int* cross,
                                         bool* near) {
  const float x0 = q.x, y0 = q.y, x1 = q.z, y1 = q.w;
  const float abx = __fsub_rn(x1, x0);
  const float aby = __fsub_rn(y1, y0);
  const float dpy = __fsub_rn(y, y0);
  if ((y0 > y) != (y1 > y)) {
    // a straddling edge has y1 != y0: the reference's denominator guard
    // (1 when 0) never applies here
    const float xint = __fadd_rn(x0, __fdiv_rn(__fmul_rn(dpy, abx), aby));
    if (xint > x) *cross ^= 1;
  }
  float den = __fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby));
  if (den == 0.f) den = 1.f;
  float t = __fdiv_rn(__fadd_rn(__fmul_rn(__fsub_rn(x, x0), abx), __fmul_rn(dpy, aby)), den);
  // clip as jnp.clip does: NaN passes through
  t = t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
  const float dx = __fsub_rn(x, __fadd_rn(x0, __fmul_rn(t, abx)));
  const float dy = __fsub_rn(y, __fadd_rn(y0, __fmul_rn(t, aby)));
  if (__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= eps2) *near = true;
}

// One row against edges lane, lane + kLanes, ... below m. LDG reads the
// edges through the read-only path (global memory), else they lie in
// shared memory.
template <bool LDG>
__device__ __forceinline__ void pip_edges(const float4* __restrict__ e, int lane, int m, float x,
                                          float y, float eps2, int* cross, bool* near) {
  for (int i = lane; i < m; i += kLanes) {
    pip_edge(LDG ? __ldg(e + i) : e[i], x, y, eps2, cross, near);
  }
}

__global__ void __launch_bounds__(kPipThreads) join_pip_kernel(
    const float* __restrict__ px, const float* __restrict__ py, const int* __restrict__ goff,
    int groups, const int* __restrict__ grow, const int* __restrict__ cand, int c_cap,
    const float4* __restrict__ edges, int e_cap, const int* __restrict__ ecnt, float eps,
    unsigned char* __restrict__ out, int rows) {
  __shared__ float4 tile[kTile];
  __shared__ int tile_group[2];
  const int lane = (int)threadIdx.x % kLanes;
  // the lanes of one pair, for combining their parities and bands
  const unsigned pair_mask = ((1u << kLanes) - 1) << ((int)threadIdx.x % 32 & ~(kLanes - 1));
  const int r0 = blockIdx.x * kPipRows;
  const int last = r0 + min(rows - r0, kPipRows) - 1;
  const int r = r0 + (int)threadIdx.x / kLanes;
  const bool live = r < rows;
  tile_groups(goff, groups, r0, last, tile_group);
  const int g = group_of(goff, tile_group[0], tile_group[1], min(r, last));
  const bool one_group = tile_group[0] == tile_group[1];
  const float x = live ? px[r] : 0.f;
  const float y = live ? py[r] : 0.f;
  const float eps2 = __fmul_rn(eps, eps);
  const long long cand_row = (long long)grow[g] * c_cap;
  for (int slot = blockIdx.y; slot < c_cap; slot += gridDim.y) {
    unsigned char* col = out + (long long)slot * rows;
    const int gi = cand[cand_row + slot];
    const int cnt = gi >= 0 ? ecnt[gi] : 0;
    // the same for the lanes of a pair, and for the block in one group
    if (cnt <= 0) {
      if (live && lane == 0) col[r] = 0;
      continue;
    }
    const float4* ge = edges + (long long)gi * e_cap;
    int cross = 0;
    bool near = false;
    if (one_group) {
      // every thread of the block holds this candidate: its edges pass
      // through shared memory, a tile at a time
      for (int t0 = 0; t0 < cnt; t0 += kTile) {
        const int m = min(kTile, cnt - t0);
        __syncthreads();  // the block is done with the last tile (or slot)
        for (int i = threadIdx.x; i < m; i += kPipThreads) tile[i] = ge[t0 + i];
        __syncthreads();
        if (live) pip_edges<false>(tile, lane, m, x, y, eps2, &cross, &near);
      }
    } else if (live) {
      pip_edges<true>(ge, lane, cnt, x, y, eps2, &cross, &near);
    }
    if (!live) continue;
    // parity is a XOR and the band an OR over the lanes' edges
    int nr = near;
    for (int o = 1; o < kLanes; o <<= 1) {
      cross ^= __shfl_xor_sync(pair_mask, cross, o, kLanes);
      nr |= __shfl_xor_sync(pair_mask, nr, o, kLanes);
    }
    if (lane == 0) col[r] = (unsigned char)(((cross & 1) && !nr ? 1 : 0) | (nr ? 2 : 0));
  }
}

__global__ void __launch_bounds__(kRows) join_dwithin_kernel(
    const float* __restrict__ px, const float* __restrict__ py, const int* __restrict__ goff,
    int groups, const int* __restrict__ grow, const int* __restrict__ cand, int c_cap,
    const float* __restrict__ bx, const float* __restrict__ by, float lo, float hi,
    unsigned char* __restrict__ out, int rows) {
  __shared__ int tile_group[2];
  const int r0 = blockIdx.x * kRows;
  const int last = r0 + min(rows - r0, kRows) - 1;
  tile_groups(goff, groups, r0, last, tile_group);
  const int r = r0 + (int)threadIdx.x;
  if (r > last) return;
  const int g = group_of(goff, tile_group[0], tile_group[1], r);
  const long long cand_row = (long long)grow[g] * c_cap;
  const float rad = (float)(3.14159265358979323846 / 180.0);
  const float two_r = 2.f * 6371008.8f;
  const float lon1 = __fmul_rn(px[r], rad);
  const float lat1 = __fmul_rn(py[r], rad);
  for (int slot = blockIdx.y; slot < c_cap; slot += gridDim.y) {
    unsigned char* col = out + (long long)slot * rows;
    const int gi = cand[cand_row + slot];
    if (gi < 0) {
      col[r] = 0;
      continue;
    }
    // the build point: one address for the threads of a warp that share it
    const float lon2 = __fmul_rn(__ldg(bx + gi), rad);
    const float lat2 = __fmul_rn(__ldg(by + gi), rad);
    const float s1 = sinf(__fdiv_rn(__fsub_rn(lat2, lat1), 2.f));
    const float s2 = sinf(__fdiv_rn(__fsub_rn(lon2, lon1), 2.f));
    const float a = __fadd_rn(__fmul_rn(s1, s1),
                              __fmul_rn(__fmul_rn(cosf(lat1), cosf(lat2)), __fmul_rn(s2, s2)));
    float s = sqrtf(a);
    s = s > 1.f ? 1.f : s;  // NaN passes, as jnp.minimum's
    const float d = __fmul_rn(two_r, asinf(s));
    unsigned char f = 0;
    if (d == d) f = d <= lo ? 1 : (d <= hi ? 2 : 0);
    col[r] = f;
  }
}

dim3 pair_grid(long long rows, int tile_rows, int c_cap) {
  return dim3((unsigned)((rows + tile_rows - 1) / tile_rows), (unsigned)min(c_cap, kMaxGridY));
}

}  // namespace

extern "C" {

// px, py f32[rows] (the chunk's routed rows, sorted by group), goff
// int32[groups + 1], grow int32[groups], cand int32[B, c_cap], edges
// f32[G, e_cap, 4], ecnt int32[G]; out u8[c_cap, rows].
int join_pip(const float* px, const float* py, const int* goff, const int* grow, int groups,
             const int* cand, int c_cap, const float* edges, int e_cap, const int* ecnt,
             float eps, unsigned char* out, long long rows, void* stream) {
  if (groups <= 0 || c_cap <= 0 || rows <= 0) return 0;
  if (rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  join_pip_kernel<<<pair_grid(rows, kPipRows, c_cap), kPipThreads, 0, (cudaStream_t)stream>>>(
      px, py, goff, groups, grow, cand, c_cap, reinterpret_cast<const float4*>(edges), e_cap,
      ecnt, eps, out, (int)rows);
  return (int)cudaGetLastError();
}

// bx, by f32[G] the build points; lo = r - eps and hi = r + eps in f32.
int join_dwithin(const float* px, const float* py, const int* goff, const int* grow, int groups,
                 const int* cand, int c_cap, const float* bx, const float* by, float lo, float hi,
                 unsigned char* out, long long rows, void* stream) {
  if (groups <= 0 || c_cap <= 0 || rows <= 0) return 0;
  if (rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  join_dwithin_kernel<<<pair_grid(rows, kRows, c_cap), kRows, 0, (cudaStream_t)stream>>>(
      px, py, goff, groups, grow, cand, c_cap, bx, by, lo, hi, out, (int)rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
