// attr_plane.cuh: the attribute-code test of the exact, extent and polygon
// kernels (the ATTR template parameter of exact_bitmap, xz_dual_bitmap and
// poly_dual_bitmap's sweep).
//
// The device edition of the reference's geomesa_tpu/parallel/executor.py
// _attr_combine, the one combine all its mask bodies share. codes are int32
// ranks into a segment's sorted value space, -1 for null, NaN and pad rows;
// a query's vector is
//   kMember     int32[kq] codes (pads are -2): the row's code is one of them;
//   kRange      int32[2] the inclusive interval [lo, hi], with no codes >= 0
//               guard: IS NULL is the interval [-1, -1] (pad rows are out
//               through the kernels' valid column);
//   kNotMember  int32[kq]: a code >= 0 and none of them;
//   kVocabMask  u8[kq] a 0/1 lookup over the code space: a code >= 0 whose
//               entry (index clipped to the table) is set.
// Each kernel ANDs the test into its hit rows, only where its box test holds
// some row of the warp's chunk (an AND can only narrow the hits), and reads
// the query's vector through the read-only cache: one broadcast address a
// warp for the codes and the interval, a lookup entry per row that still
// holds for vocabmask.

#pragma once

namespace attr_plane {

constexpr int kNone = 0, kMember = 1, kRange = 2, kNotMember = 3, kVocabMask = 4;

// m[j] &= the test of query i on the lane's codes cd[j].
template <int ATTR, int KR>
__device__ __forceinline__ void and_test(bool (&m)[KR], const int (&cd)[KR],
                                         const void* __restrict__ qcodes, int i, int kq) {
  if (ATTR == kMember || ATTR == kNotMember) {
    const int* qc = static_cast<const int*>(qcodes) + (long long)i * kq;
    bool hit[KR];
#pragma unroll
    for (int j = 0; j < KR; ++j) hit[j] = false;
    for (int k = 0; k < kq; ++k) {
      const int code = __ldg(qc + k);
#pragma unroll
      for (int j = 0; j < KR; ++j) hit[j] |= cd[j] == code;
    }
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      m[j] = m[j] & (ATTR == kMember ? hit[j] : (cd[j] >= 0) & !hit[j]);
    }
  } else if (ATTR == kRange) {
    const int* qc = static_cast<const int*>(qcodes) + 2LL * i;
    const int lo = __ldg(qc), hi = __ldg(qc + 1);
#pragma unroll
    for (int j = 0; j < KR; ++j) m[j] = m[j] & (cd[j] >= lo) & (cd[j] <= hi);
  } else if (ATTR == kVocabMask) {
    const unsigned char* lut = static_cast<const unsigned char*>(qcodes) + (long long)i * kq;
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      if (m[j]) m[j] = cd[j] >= 0 && __ldg(lut + min(cd[j], kq - 1)) != 0;
    }
  }
}

}  // namespace attr_plane
