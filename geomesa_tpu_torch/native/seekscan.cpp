// Native seek-scan: candidate row intervals -> final filtered row indices.
//
// The host-side analog of the reference's tablet-server hot loop
// (Z3Iterator.seek/next + Z3Filter.inBounds, accumulo/iterators/
// Z3Iterator.scala:42-65): given the searchsorted candidate intervals of a
// selective plan and the raw f64/i64 columns, emit exactly the rows that
// satisfy the query's own bbox(+interval) predicate — one pass, no
// intermediate gathers. Rows in `covered` intervals (strict-interior
// z-ranges, see zranges.cpp skip boxes) are emitted without any test.
//
// Build: g++ -O2 -shared -fPIC -o _seekscan.so seekscan.cpp

#include <cstdint>

extern "C" {

// Returns rows written to out_rows, or -1 if cap was insufficient (caller
// retries with cap >= total candidate count).
//   x/y:      f64 coordinate columns (full block arrays, indexed by row)
//   t:        i64 epoch-ms column, or null when the predicate has no
//             temporal part
//   starts/ends: [nruns] candidate [start, end) row intervals
//   covered:  [nruns] flags — rows of covered intervals skip the test
//   box:      xmin, xmax, ymin, ymax inclusive f64 bounds
//   tlo/thi:  inclusive i64 ms bounds (caller folds exclusivity into +-1)
long long geomesa_seek_scan(
    const double* x, const double* y, const int64_t* t,
    const int64_t* starts, const int64_t* ends, const uint8_t* covered,
    long long nruns,
    double xmin, double xmax, double ymin, double ymax,
    int64_t tlo, int64_t thi,
    int64_t* out_rows, long long cap) {
    long long n = 0;
    for (long long r = 0; r < nruns; ++r) {
        int64_t s = starts[r];
        int64_t e = ends[r];
        if (e <= s) continue;
        if (covered[r]) {
            if (n + (e - s) > cap) return -1;
            for (int64_t i = s; i < e; ++i) out_rows[n++] = i;
            continue;
        }
        if (n + (e - s) > cap) return -1;  // worst case for this run
        if (t != nullptr) {
            for (int64_t i = s; i < e; ++i) {
                bool ok = x[i] >= xmin && x[i] <= xmax &&
                          y[i] >= ymin && y[i] <= ymax &&
                          t[i] >= tlo && t[i] <= thi;
                out_rows[n] = i;
                n += ok ? 1 : 0;  // branchless-ish compaction
            }
        } else {
            for (int64_t i = s; i < e; ++i) {
                bool ok = x[i] >= xmin && x[i] <= xmax &&
                          y[i] >= ymin && y[i] <= ymax;
                out_rows[n] = i;
                n += ok ? 1 : 0;
            }
        }
    }
    return n;
}

// Extent-feature (XZ) variant: candidate intervals + per-row ENVELOPE
// columns -> rows whose envelope overlaps the query box, with a parallel
// flag marking rows DECIDED by envelope math alone. For a rectangle query
// geometry, a feature envelope strictly inside the box implies intersects
// (decided=1); the all-zero placeholder envelope (null geometry) and
// boundary-straddling envelopes stay decided=0 — the caller runs the exact
// per-row geometry test only on those. Mirrors the vectorized prescreen in
// filter/evaluate.py::_eval_spatial, one pass, no intermediate gathers.
//
// Returns rows written, or -1 if cap insufficient (caller sizes exactly).
// isrect: optional (nullable) per-row flag marking features whose geometry
// IS its axis-aligned envelope rectangle — for a RECTANGLE query their
// envelope-overlap test is exact, so straddling rows skip the host's
// per-geometry ring test entirely.
long long geomesa_env_seek_scan(
    const double* bxmin, const double* bymin,
    const double* bxmax, const double* bymax,
    const uint8_t* isrect,
    const int64_t* starts, const int64_t* ends, long long nruns,
    double qxmin, double qymin, double qxmax, double qymax,
    int rect_query,
    int64_t* out_rows, uint8_t* out_decided, long long cap) {
    long long n = 0;
    for (long long r = 0; r < nruns; ++r) {
        int64_t s = starts[r];
        int64_t e = ends[r];
        if (e <= s) continue;
        if (n + (e - s) > cap) return -1;
        for (int64_t i = s; i < e; ++i) {
            bool overlap = bxmax[i] >= qxmin && bxmin[i] <= qxmax &&
                           bymax[i] >= qymin && bymin[i] <= qymax;
            if (!overlap) continue;
            bool placeholder = bxmin[i] == 0.0 && bymin[i] == 0.0 &&
                               bxmax[i] == 0.0 && bymax[i] == 0.0;
            bool decided = rect_query && !placeholder &&
                           ((bxmin[i] >= qxmin && bxmax[i] <= qxmax &&
                             bymin[i] >= qymin && bymax[i] <= qymax) ||
                            (isrect && isrect[i]));
            out_rows[n] = i;
            out_decided[n] = decided ? 1 : 0;
            ++n;
        }
    }
    return n;
}

}  // extern "C"
