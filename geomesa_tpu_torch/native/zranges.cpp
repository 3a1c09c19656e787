// Native z-range decomposition: quad/oct-tree BFS over Morton space.
//
// The C++ analog of the JVM sfcurve-zorder range decomposition the reference
// delegates to (called from Z2SFC.scala:52-53 / Z3SFC.scala:62). Planning is
// latency-critical and irregular (data-dependent BFS) — a poor fit for XLA —
// so it runs as native host code; semantics mirror
// geomesa_tpu/curve/zorder.py::zranges exactly (that Python version is the
// tested oracle and the fallback when no compiler is available).
//
// Build: g++ -O2 -shared -fPIC -o _zranges.so zranges.cpp

#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>
#include <algorithm>

namespace {

struct Cell {
    uint32_t cmin[3];
    int level;
};

struct Range {
    uint64_t lo;
    uint64_t hi;
    uint8_t contained;
};

inline uint64_t interleave(const uint32_t* coords, int dims) {
    uint64_t z = 0;
    for (int d = 0; d < dims; ++d) {
        uint64_t c = coords[d];
        int k = 0;
        while (c) {
            if (c & 1) z |= 1ULL << (k * dims + d);
            c >>= 1;
            ++k;
        }
    }
    return z;
}

}  // namespace

extern "C" {

// Decompose boxes into z-ranges. Returns number of ranges written, or
// -needed if the output capacity was insufficient (caller retries).
//   mins/maxs: [nboxes * dims] per-dim inclusive bounds
//   max_ranges: <0 means unbounded
//   skip_mins/skip_maxs: [nskip * dims] optional INTERIOR boxes — when
//     nskip >= 0 (with non-null pointers) the output `contained` flag
//     means "cell inside some skip box" (every raw-domain value in the
//     cell provably satisfies the query's own predicate, so scans skip
//     the post-filter for these ranges); recursion still classifies
//     against the regular boxes. nskip == 0 therefore forces every flag
//     false (no interior). Pass nskip < 0 (null pointers) for the legacy
//     meaning (cell inside a regular box).
long long geomesa_zranges(
    const uint32_t* mins, const uint32_t* maxs, int nboxes,
    int bits, int dims, long long max_ranges, int precision,
    const uint32_t* skip_mins, const uint32_t* skip_maxs, int nskip,
    uint64_t* out_lo, uint64_t* out_hi, uint8_t* out_contained,
    long long cap) {
    if (nboxes <= 0 || dims < 1 || dims > 3) return 0;
    int max_level = std::min((long long)bits, std::max(1LL, (long long)(precision / dims)));

    std::vector<Range> ranges;
    std::deque<Cell> queue;
    Cell root;
    std::memset(root.cmin, 0, sizeof(root.cmin));
    root.level = 0;
    queue.push_back(root);

    while (!queue.empty()) {
        Cell cell = queue.front();
        queue.pop_front();
        uint64_t size = 1ULL << (bits - cell.level);
        bool contained = false, overlaps = false;
        for (int b = 0; b < nboxes && !contained; ++b) {
            bool cont = true, over = true;
            for (int d = 0; d < dims; ++d) {
                uint64_t c0 = cell.cmin[d];
                uint64_t c1 = c0 + size - 1;
                uint64_t lo = mins[b * dims + d];
                uint64_t hi = maxs[b * dims + d];
                if (!(lo <= c0 && c1 <= hi)) cont = false;
                if (!(lo <= c1 && c0 <= hi)) { over = false; break; }
            }
            if (over) overlaps = true;
            if (cont && over) contained = true;
        }
        if (!overlaps) continue;
        if (contained) {
            uint8_t flag = 1;
            if (nskip >= 0 && skip_mins != nullptr) {
                flag = 0;
                for (int b = 0; b < nskip && !flag; ++b) {
                    bool cont = true;
                    for (int d = 0; d < dims; ++d) {
                        uint64_t c0 = cell.cmin[d];
                        uint64_t c1 = c0 + size - 1;
                        if (!(skip_mins[b * dims + d] <= c0 &&
                              c1 <= skip_maxs[b * dims + d])) {
                            cont = false;
                            break;
                        }
                    }
                    if (cont) flag = 1;
                }
            }
            uint64_t zmin = interleave(cell.cmin, dims);
            uint64_t span = 1ULL << (dims * (bits - cell.level));
            ranges.push_back({zmin, zmin + span - 1, flag});
        } else if (cell.level >= max_level ||
                   (max_ranges >= 0 &&
                    (long long)(ranges.size() + queue.size()) >= max_ranges)) {
            uint64_t zmin = interleave(cell.cmin, dims);
            uint64_t span = 1ULL << (dims * (bits - cell.level));
            ranges.push_back({zmin, zmin + span - 1, 0});
        } else {
            uint32_t half = 1u << (bits - cell.level - 1);
            for (int corner = 0; corner < (1 << dims); ++corner) {
                Cell child;
                for (int d = 0; d < dims; ++d)
                    child.cmin[d] = cell.cmin[d] + (((corner >> d) & 1) ? half : 0);
                child.level = cell.level + 1;
                queue.push_back(child);
            }
        }
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
        // truly overlapping ranges always coalesce (flag = AND); merely
        // adjacent ones only when flags match — a skip-eligible interior
        // run must not lose its flag to a neighboring boundary cell
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
