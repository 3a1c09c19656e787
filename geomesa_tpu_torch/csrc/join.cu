// join: the dual masks of a spatial join's probe chunk, for `contains`
// (join_pip) and `dwithin` (join_dwithin).
//
// Replaces the device work of the reference's geomesa_tpu/ops/join.py
// _pip_fn (:548, "join_pip") and _dwithin_fn (:592, "join_dwithin"). The
// reference launches once per bucket group of a probe chunk, each group's
// rows NaN-padded to a power of two; here one launch answers a whole chunk:
// the chunk's routed rows arrive sorted by group with CSR offsets `goff`
// (group g holds rows goff[g] .. goff[g + 1]) and each group's row `grow[g]`
// in the resident candidate matrix `cand` int32[B, C] (-1 pads). One block
// takes one (group, candidate slot) and its threads stride over the group's
// rows, so a group pays for its own rows only, no pad rows, and the
// candidate's geometry is read once a block.
//
// Output: u8 flags [C, R], slot-major so a block's writes coalesce: bit 0
// accept, bit 1 check, 0 for a -1 slot.
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
// jnp.min's NaN, false for a NaN row (every compare fails). The candidate's
// edges (any count: rings with holes, hundreds of edges) pass through
// shared memory in tiles of kTile edges; a candidate with one tile loads it
// once a block.
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
// division, multiply, add and compare); join_dwithin's loop costs 103 FP32-
// pipe instructions a (row, candidate) on the path every finite row takes
// (two sinf, a cosf, the two halvings, sqrtf and asinf; the large-argument
// reductions never run for coordinates in degrees). chip_smoke.py's
// JOIN_PIP_EDGE_FOPS, JOIN_PIP_STRADDLE_FOPS and JOIN_DWITHIN_FOPS hold
// these counts for the bound. A chunk's reads (8 B a row, the candidate's
// edges or point once a block) and writes (1 B a pair) are small beside
// that. The design keeps each thread on one row at a time, so the FP32
// pipes stay fed with no state shared between threads; a tile of edges in
// shared memory is read by every thread of the block.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
// edges a shared-memory tile (8 KB)
constexpr int kTile = 512;

// One row against m edges of a tile: flips the crossing parity, sets near.
__device__ __forceinline__ void pip_tile(const float4* __restrict__ tile, int m, float x, float y,
                                         float eps2, int* cross, bool* near) {
  for (int i = 0; i < m; ++i) {
    const float4 e = tile[i];
    const float x0 = e.x, y0 = e.y, x1 = e.z, y1 = e.w;
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
}

// One block per (group, slot): b = g * c_cap + slot.
__global__ void __launch_bounds__(kThreads) join_pip_kernel(
    const float* __restrict__ px, const float* __restrict__ py, const int* __restrict__ goff,
    const int* __restrict__ grow, const int* __restrict__ cand, int c_cap,
    const float4* __restrict__ edges, int e_cap, const int* __restrict__ ecnt, float eps,
    unsigned char* __restrict__ out, long long rows) {
  __shared__ float4 tile[kTile];
  const long long b = blockIdx.x;
  const int g = (int)(b / c_cap);
  const int slot = (int)(b % c_cap);
  const int r0 = goff[g], r1 = goff[g + 1];
  unsigned char* col = out + (long long)slot * rows;
  const int gi = cand[(long long)grow[g] * c_cap + slot];
  const int cnt = gi >= 0 ? ecnt[gi] : 0;
  if (cnt <= 0) {
    for (int r = r0 + threadIdx.x; r < r1; r += kThreads) col[r] = 0;
    return;
  }
  const float eps2 = __fmul_rn(eps, eps);
  const float4* ge = edges + (long long)gi * e_cap;
  const bool one_tile = cnt <= kTile;
  if (one_tile) {
    for (int i = threadIdx.x; i < cnt; i += kThreads) tile[i] = ge[i];
    __syncthreads();
  }
  for (int base = r0; base < r1; base += kThreads) {
    const int r = base + threadIdx.x;
    const bool live = r < r1;
    const float x = live ? px[r] : 0.f;
    const float y = live ? py[r] : 0.f;
    int cross = 0;
    bool near = false;
    for (int t0 = 0; t0 < cnt; t0 += kTile) {
      const int m = min(kTile, cnt - t0);
      if (!one_tile) {
        __syncthreads();
        for (int i = threadIdx.x; i < m; i += kThreads) tile[i] = ge[t0 + i];
        __syncthreads();
      }
      if (live) pip_tile(tile, m, x, y, eps2, &cross, &near);
    }
    if (live) col[r] = (unsigned char)(((cross & 1) && !near ? 1 : 0) | (near ? 2 : 0));
  }
}

__global__ void __launch_bounds__(kThreads) join_dwithin_kernel(
    const float* __restrict__ px, const float* __restrict__ py, const int* __restrict__ goff,
    const int* __restrict__ grow, const int* __restrict__ cand, int c_cap,
    const float* __restrict__ bx, const float* __restrict__ by, float lo, float hi,
    unsigned char* __restrict__ out, long long rows) {
  const long long b = blockIdx.x;
  const int g = (int)(b / c_cap);
  const int slot = (int)(b % c_cap);
  const int r0 = goff[g], r1 = goff[g + 1];
  unsigned char* col = out + (long long)slot * rows;
  const int gi = cand[(long long)grow[g] * c_cap + slot];
  if (gi < 0) {
    for (int r = r0 + threadIdx.x; r < r1; r += kThreads) col[r] = 0;
    return;
  }
  const float rad = (float)(3.14159265358979323846 / 180.0);
  const float two_r = 2.f * 6371008.8f;
  const float lon2 = __fmul_rn(bx[gi], rad);
  const float lat2 = __fmul_rn(by[gi], rad);
  const float c2 = cosf(lat2);
  for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const float lon1 = __fmul_rn(px[r], rad);
    const float lat1 = __fmul_rn(py[r], rad);
    const float s1 = sinf(__fdiv_rn(__fsub_rn(lat2, lat1), 2.f));
    const float s2 = sinf(__fdiv_rn(__fsub_rn(lon2, lon1), 2.f));
    const float a = __fadd_rn(__fmul_rn(s1, s1),
                              __fmul_rn(__fmul_rn(cosf(lat1), c2), __fmul_rn(s2, s2)));
    float s = sqrtf(a);
    s = s > 1.f ? 1.f : s;  // NaN passes, as jnp.minimum's
    const float d = __fmul_rn(two_r, asinf(s));
    unsigned char f = 0;
    if (d == d) f = d <= lo ? 1 : (d <= hi ? 2 : 0);
    col[r] = f;
  }
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
  const long long blocks = (long long)groups * c_cap;
  join_pip_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      px, py, goff, grow, cand, c_cap, reinterpret_cast<const float4*>(edges), e_cap, ecnt, eps,
      out, rows);
  return (int)cudaGetLastError();
}

// bx, by f32[G] the build points; lo = r - eps and hi = r + eps in f32.
int join_dwithin(const float* px, const float* py, const int* goff, const int* grow, int groups,
                 const int* cand, int c_cap, const float* bx, const float* by, float lo, float hi,
                 unsigned char* out, long long rows, void* stream) {
  if (groups <= 0 || c_cap <= 0 || rows <= 0) return 0;
  const long long blocks = (long long)groups * c_cap;
  join_dwithin_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      px, py, goff, grow, cand, c_cap, bx, by, lo, hi, out, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
