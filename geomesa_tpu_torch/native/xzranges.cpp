// Native XZ range decomposition: BFS over the XZ quad/oct tree.
//
// C++ port of geomesa_tpu/curve/xz.py::_XZSFC.ranges_boxes (itself the
// rebuild of the reference's XZ2SFC.scala:146-252 sequence-interval BFS
// from the Boehm/Klump/Kriegel XZ-ordering paper). Planning for extent
// queries is latency-critical and the walk is data-dependent — host C++,
// like zranges.cpp. The Python implementation remains the tested oracle
// and the fallback; semantics (level-terminator queue, extended-element
// contains/overlap, lemma-3 intervals, budget flush, flag-aware merge)
// mirror it exactly.
//
// Build: g++ -O2 -shared -fPIC -o _xzranges.so xzranges.cpp

#include <cstdint>
#include <deque>
#include <vector>
#include <algorithm>

namespace {

struct Elem {
    double lo[3];
    double hi[3];
    double length;
};

struct Range {
    int64_t lo;
    int64_t hi;
    uint8_t contained;
};

// (base^(g-i) - 1) / (base - 1), precomputed per level
static void subtree_steps(int g, int base, int64_t* steps) {
    for (int i = 0; i <= g; ++i) {
        int64_t p = 1;
        for (int k = 0; k < g - i; ++k) p *= base;
        steps[i] = (p - 1) / (base - 1);
    }
}

// sequence code of the cell with lower-left `corner` at `level`
// (xz.py::_code_scalar / XZ2SFC.scala:264-286)
static int64_t code_scalar(const double* corner, int level, int dims, int g,
                           int base, const int64_t* steps) {
    double lo[3], hi[3];
    for (int d = 0; d < dims; ++d) {
        lo[d] = 0.0;
        hi[d] = 1.0;
    }
    int64_t cs = 0;
    for (int i = 0; i < level; ++i) {
        int q = 0;
        for (int d = 0; d < dims; ++d) {
            double center = (lo[d] + hi[d]) * 0.5;
            if (corner[d] >= center) q |= 1 << d;
        }
        cs += 1 + (int64_t)q * steps[i];
        for (int d = 0; d < dims; ++d) {
            double center = (lo[d] + hi[d]) * 0.5;
            if ((q >> d) & 1) lo[d] = center;
            else hi[d] = center;
        }
    }
    return cs;
}

}  // namespace

extern "C" {

// Decompose normalized [0,1]^dims query windows into XZ sequence-code
// ranges. Returns ranges written, or -needed when cap is insufficient.
//   qmins/qmaxs: [nqueries * dims] normalized window bounds
//   max_ranges: <0 = unbounded budget
long long geomesa_xzranges(
    const double* qmins, const double* qmaxs, int nqueries, int dims,
    int g, long long max_ranges,
    int64_t* out_lo, int64_t* out_hi, uint8_t* out_contained,
    long long cap) {
    if (nqueries <= 0 || dims < 2 || dims > 3 || g < 1 || g > 20) return 0;
    const int base = 1 << dims;
    int64_t steps[32];
    subtree_steps(g, base, steps);
    const long long stop =
        max_ranges >= 0 ? max_ranges : (long long)1 << 62;

    std::vector<Range> ranges;
    std::deque<Elem> queue;
    // children of the unit cube seed the queue at level 1
    {
        Elem root;
        for (int d = 0; d < dims; ++d) {
            root.lo[d] = 0.0;
            root.hi[d] = 1.0;
        }
        root.length = 1.0;
        for (int corner = 0; corner < base; ++corner) {
            Elem c;
            c.length = 0.5;
            for (int d = 0; d < dims; ++d) {
                double center = (root.lo[d] + root.hi[d]) * 0.5;
                if ((corner >> d) & 1) {
                    c.lo[d] = center;
                    c.hi[d] = root.hi[d];
                } else {
                    c.lo[d] = root.lo[d];
                    c.hi[d] = center;
                }
            }
            queue.push_back(c);
        }
    }
    const Elem TERMINATOR{{-1, -1, -1}, {-1, -1, -1}, -1.0};
    queue.push_back(TERMINATOR);
    int level = 1;
    while (level < g && !queue.empty() && (long long)ranges.size() < stop) {
        Elem e = queue.front();
        queue.pop_front();
        if (e.length < 0) {  // terminator
            if (!queue.empty()) {
                ++level;
                queue.push_back(TERMINATOR);
            }
            continue;
        }
        bool contained = false, over = false;
        for (int q = 0; q < nqueries && !contained; ++q) {
            bool c = true;
            for (int d = 0; d < dims; ++d) {
                if (!(qmins[q * dims + d] <= e.lo[d] &&
                      qmaxs[q * dims + d] >= e.hi[d] + e.length)) {
                    c = false;
                    break;
                }
            }
            if (c) contained = true;
        }
        if (!contained) {
            for (int q = 0; q < nqueries && !over; ++q) {
                bool o = true;
                for (int d = 0; d < dims; ++d) {
                    if (!(qmaxs[q * dims + d] >= e.lo[d] &&
                          qmins[q * dims + d] <= e.hi[d] + e.length)) {
                        o = false;
                        break;
                    }
                }
                if (o) over = true;
            }
        }
        if (contained) {
            int64_t mn = code_scalar(e.lo, level, dims, g, base, steps);
            ranges.push_back({mn, mn + steps[level - 1], 1});
        } else if (over) {
            int64_t mn = code_scalar(e.lo, level, dims, g, base, steps);
            ranges.push_back({mn, mn, 0});
            for (int corner = 0; corner < base; ++corner) {
                Elem c;
                c.length = e.length * 0.5;
                for (int d = 0; d < dims; ++d) {
                    double center = (e.lo[d] + e.hi[d]) * 0.5;
                    if ((corner >> d) & 1) {
                        c.lo[d] = center;
                        c.hi[d] = e.hi[d];
                    } else {
                        c.lo[d] = e.lo[d];
                        c.hi[d] = center;
                    }
                }
                queue.push_back(c);
            }
        }
    }
    // budget hit / max depth: flush remaining as loose subtree intervals
    while (!queue.empty()) {
        Elem e = queue.front();
        queue.pop_front();
        if (e.length < 0) {
            ++level;
            continue;
        }
        int64_t mn = code_scalar(e.lo, level, dims, g, base, steps);
        ranges.push_back({mn, mn + steps[level - 1], 0});
    }

    if (ranges.empty()) return 0;
    std::sort(ranges.begin(), ranges.end(), [](const Range& a, const Range& b) {
        return a.lo != b.lo ? a.lo < b.lo : a.hi < b.hi;
    });
    std::vector<Range> merged;
    merged.push_back(ranges[0]);
    for (size_t i = 1; i < ranges.size(); ++i) {
        Range& cur = merged.back();
        const Range& r = ranges[i];
        // mirror curve/zorder.py::merge_ranges: true overlaps always
        // coalesce (flag AND); adjacency only with equal flags
        if (r.lo <= cur.hi || (r.lo == cur.hi + 1 && r.contained == cur.contained)) {
            cur.hi = std::max(cur.hi, r.hi);
            cur.contained = cur.contained && r.contained;
        } else {
            merged.push_back(r);
        }
    }
    long long n = (long long)merged.size();
    if (n > cap) return -n;
    for (long long i = 0; i < n; ++i) {
        out_lo[i] = merged[i].lo;
        out_hi[i] = merged[i].hi;
        out_contained[i] = merged[i].contained;
    }
    return n;
}

}  // extern "C"
