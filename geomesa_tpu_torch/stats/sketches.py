"""Mergeable summary sketches over columnar batches.

Port of ``geomesa_tpu/stats/sketches.py``. Each sketch mirrors a reference
Stat implementation (geomesa-utils .../stats/): ``observe()`` takes a numpy
column (plus an optional null mask), ``observe_counts()`` takes
pre-aggregated (distinct value, count) pairs and gives the state a per-row
``observe`` of the expanded column would (dictionary columns and the
device stats push-down feed them so), ``+`` merges two sketches of the same
shape, and ``to_json`` / ``from_json`` round-trip the state (the reference's
JSON, so the states of the two packages compare as text). The write-time
sketches of the strategy choice (``CountStat``, ``Histogram``, ``MinMax``,
``TopK``, ``Frequency``) are these; the stats hint parses into any of them
(``stats/parser.py``).
"""

from __future__ import annotations

import hashlib
import heapq
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.curve import TimePeriod, time_to_binned
from geomesa_tpu_torch.curve.sfc import Z3SFC


class Stat:
    """Base sketch (stats/Stat.scala)."""

    kind = "stat"

    def observe(self, values: np.ndarray, nulls: Optional[np.ndarray] = None) -> None:
        raise NotImplementedError

    def __add__(self, other: "Stat") -> "Stat":
        out = self.copy()
        out.merge(other)
        return out

    def merge(self, other: "Stat") -> None:
        raise NotImplementedError

    def copy(self) -> "Stat":
        return from_json(self.to_json())

    def to_json(self) -> str:
        return json.dumps({"kind": self.kind, **self.state()})

    def state(self) -> Dict[str, Any]:
        raise NotImplementedError

    @property
    def is_empty(self) -> bool:
        raise NotImplementedError


def _hash64(values: np.ndarray) -> np.ndarray:
    """Seed-stable 64-bit hashes: strings via blake2b (Python hash() is
    per-process randomized, which would corrupt persisted sketches on
    reload), numerics via splitmix64 of the float bits."""
    if values.dtype.kind in "OUS":
        return np.array(
            [
                int.from_bytes(
                    hashlib.blake2b(str(v).encode(), digest_size=8).digest(), "little"
                )
                for v in values
            ],
            dtype=np.uint64,
        )
    # + 0.0 collapses -0.0 onto +0.0 BEFORE taking bits: hashing must
    # follow VALUE equality (-0.0 == 0.0 ranks as one code in the device
    # planes and matches the same CQL literals), not bit identity —
    # otherwise HLL/CMS state depends on which representation a row
    # happened to carry
    return _mix64((np.asarray(values, dtype=np.float64) + 0.0).view(np.uint64))


def _clean(values: np.ndarray, nulls: Optional[np.ndarray]) -> np.ndarray:
    if nulls is not None:
        values = values[~nulls]
    if values.dtype.kind == "f":
        values = values[~np.isnan(values)]
    elif values.dtype.kind == "O":
        values = values[np.array([v is not None for v in values], dtype=bool)]
    return values


class CountStat(Stat):
    """Total observed count (stats/CountStat.scala)."""

    kind = "count"

    def __init__(self, count: int = 0):
        self.count = int(count)

    def observe(self, values, nulls=None):
        self.count += int(len(values))

    def merge(self, other):
        self.count += other.count

    def state(self):
        return {"count": self.count}

    @property
    def is_empty(self):
        return self.count == 0


class MinMax(Stat):
    """Attribute bounds + HLL-style cardinality estimate (stats/MinMax.scala).

    Cardinality uses a fixed 2^12-register hyperloglog over a 64-bit hash,
    matching the role (not the bits) of the reference's HyperLogLog field.
    """

    kind = "minmax"
    _P = 12  # registers = 4096

    def __init__(self, attribute: str, dtype: str = "f8", track_cardinality: bool = True):
        self.attribute = attribute
        self.dtype = dtype
        self.min: Optional[Any] = None
        self.max: Optional[Any] = None
        # bounds-only mode skips the per-row hash+HLL update — used for the
        # lon/lat/dtg role stats, whose cardinality nothing consumes
        # (spatial/temporal selectivity comes from histograms); ingest-time
        # hashing of every coordinate was ~10% of a 20M-row batch
        self.track_cardinality = track_cardinality
        self.registers = np.zeros(1 << self._P, dtype=np.int8)

    def observe(self, values, nulls=None):
        values = _clean(np.asarray(values), nulls)
        if not len(values):
            return
        if values.dtype.kind in "OUS":
            vmin, vmax = min(values), max(values)
        else:
            vmin, vmax = values.min(), values.max()
        self.min = vmin if self.min is None else min(self.min, vmin)
        self.max = vmax if self.max is None else max(self.max, vmax)
        self._observe_hll(values)

    def observe_counts(self, values, counts):
        """Pre-aggregated observation (see EnumerationStat.observe_counts).
        MinMax state is multiplicity-INSENSITIVE — bounds depend on the
        value set and the HLL registers are per-value maxima — so one
        observation of each distinct value reproduces the exact state a
        per-row observe over the expanded column would."""
        del counts
        self.observe(values)

    def _observe_hll(self, values):
        if not self.track_cardinality:
            return
        h = _hash64(values)
        idx = (h >> np.uint64(64 - self._P)).astype(np.int64)
        rho = (
            np.clip(_leading_zeros_53(h << np.uint64(self._P)), 0, 64 - self._P) + 1
        ).astype(np.int8)
        np.maximum.at(self.registers, idx, rho)

    @property
    def cardinality(self) -> float:
        m = float(len(self.registers))
        if not self.registers.any():
            return 0.0
        alpha = 0.7213 / (1 + 1.079 / m)
        est = alpha * m * m / np.sum(np.exp2(-self.registers.astype(np.float64)))
        zeros = int(np.sum(self.registers == 0))
        if est <= 2.5 * m and zeros:
            est = m * math.log(m / zeros)
        return float(est)

    def merge(self, other):
        if other.min is not None:
            self.min = other.min if self.min is None else min(self.min, other.min)
            self.max = other.max if self.max is None else max(self.max, other.max)
        np.maximum(self.registers, other.registers, out=self.registers)

    def state(self):
        mn, mx = self.min, self.max
        if isinstance(mn, np.generic):
            mn = mn.item()
        if isinstance(mx, np.generic):
            mx = mx.item()
        return {
            "attribute": self.attribute,
            "dtype": self.dtype,
            "min": mn,
            "max": mx,
            "track_cardinality": self.track_cardinality,
            "registers": self.registers.tolist(),
        }

    @property
    def is_empty(self):
        return self.min is None


def _mix64(h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized."""
    h = h.astype(np.uint64)
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return h ^ (h >> np.uint64(31))


def _leading_zeros_53(h: np.ndarray) -> np.ndarray:
    """Approximate 64-bit leading-zero count via float exponent (exact for
    the top 53 bits, which is all HLL rank estimation needs)."""
    out = np.full(h.shape, 64, dtype=np.int64)
    nz = h != 0
    f = h[nz].astype(np.float64)
    out[nz] = 63 - np.floor(np.log2(f)).astype(np.int64)
    return out


class EnumerationStat(Stat):
    """Exact value -> count map (stats/EnumerationStat.scala)."""

    kind = "enumeration"

    def __init__(self, attribute: str):
        self.attribute = attribute
        self.counts: Dict[Any, int] = {}

    def observe(self, values, nulls=None):
        values = _clean(np.asarray(values), nulls)
        uniq, cnt = np.unique(values, return_counts=True)
        self.observe_counts(uniq, cnt)

    def observe_counts(self, values, counts):
        """Pre-aggregated (unique value, count) observation — dictionary
        columns feed sketches via vocab + bincount instead of decoding
        every row."""
        for v, c in zip(values, counts):
            v = v.item() if isinstance(v, np.generic) else v
            self.counts[v] = self.counts.get(v, 0) + int(c)

    def merge(self, other):
        for v, c in other.counts.items():
            self.counts[v] = self.counts.get(v, 0) + c

    def state(self):
        return {"attribute": self.attribute, "counts": list(self.counts.items())}

    @property
    def is_empty(self):
        return not self.counts


class TopK(Stat):
    """Space-saving top-k (stats/TopK.scala, StreamSummary analog)."""

    kind = "topk"

    def __init__(self, attribute: str, capacity: int = 1000):
        self.attribute = attribute
        self.capacity = capacity
        self.counts: Dict[Any, int] = {}

    def observe(self, values, nulls=None):
        """Batched space-saving: newcomers enter at (evicted-min + count)
        like the per-value StreamSummary substitution, but the min scan and
        truncation run ONCE per batch — O(batch + capacity) instead of the
        per-value min() that made unique-id columns quadratic. The
        overestimate-only guarantee (a true heavy hitter can't be displaced
        by a stream of one-off values) is preserved."""
        values = _clean(np.asarray(values), nulls)
        uniq, cnt = np.unique(values, return_counts=True)
        self.observe_counts(uniq, cnt)

    def observe_counts(self, uniq, cnt):
        """Pre-aggregated observation (see EnumerationStat.observe_counts)."""
        newcomers = {}
        for v, c in zip(uniq, cnt):
            v = v.item() if isinstance(v, np.generic) else v
            if v in self.counts:
                self.counts[v] += int(c)
            else:
                newcomers[v] = int(c)
        if not newcomers:
            return
        if len(self.counts) + len(newcomers) <= self.capacity:
            self.counts.update(newcomers)
            return
        baseline = min(self.counts.values()) if self.counts else 0
        for v, c in newcomers.items():
            self.counts[v] = c + baseline
        self.counts = dict(
            heapq.nlargest(self.capacity, self.counts.items(), key=lambda kv: kv[1])
        )

    def topk(self, k: int = 10) -> List[Tuple[Any, int]]:
        return sorted(self.counts.items(), key=lambda kv: -kv[1])[:k]

    def merge(self, other):
        for v, c in other.counts.items():
            self.counts[v] = self.counts.get(v, 0) + c
        while len(self.counts) > self.capacity:
            self.counts.pop(min(self.counts, key=self.counts.get))

    def state(self):
        return {
            "attribute": self.attribute,
            "capacity": self.capacity,
            "counts": list(self.counts.items()),
        }

    @property
    def is_empty(self):
        return not self.counts


class Histogram(Stat):
    """Fixed-width binned counts over [lo, hi] (stats/Histogram.scala:1-273,
    BinnedArray semantics: clamp out-of-range values into the end bins)."""

    kind = "histogram"

    def __init__(self, attribute: str, bins: int, lo=None, hi=None):
        self.attribute = attribute
        self.bins = int(bins)
        # lo/hi None = auto-ranging: bounds initialize from the first batch
        # and EXPAND by re-binning when later data falls outside — the
        # reference's BinnedArray.expand behavior (Histogram.scala:1-273)
        self.lo = None if lo is None else float(lo)
        self.hi = None if hi is None else float(hi)
        self._fixed = lo is not None
        self.counts = np.zeros(self.bins, dtype=np.int64)

    def _expand(self, lo: float, hi: float) -> None:
        """Grow [lo, hi] and re-bin existing counts by old-bin centers
        (approximate, like the reference's value re-binning)."""
        old_lo, old_hi, old_counts = self.lo, self.hi, self.counts
        self.lo, self.hi = lo, hi
        self.counts = np.zeros(self.bins, dtype=np.int64)
        if old_counts.any():
            w = (old_hi - old_lo) / self.bins
            centers = old_lo + (np.arange(self.bins) + 0.5) * w
            idx = np.floor((centers - lo) * self.bins / (hi - lo)).astype(np.int64)
            np.add.at(self.counts, np.clip(idx, 0, self.bins - 1), old_counts)

    def _auto_range(self, values: np.ndarray) -> np.ndarray:
        """Shared ranging + binning for observe/observe_counts: initialize
        or expand [lo, hi] from the batch's min/max (the observe_counts
        parity contract requires BOTH paths to use this one formula),
        then return each value's clipped bin index."""
        vlo, vhi = float(values.min()), float(values.max())
        if self.lo is None:
            pad = (vhi - vlo) * 0.1 or max(1.0, abs(vlo) * 0.01)
            self.lo, self.hi = vlo - pad, vhi + pad
        elif not self._fixed and (vlo < self.lo or vhi > self.hi):
            span = max(vhi, self.hi) - min(vlo, self.lo)
            self._expand(min(vlo, self.lo) - span * 0.1, max(vhi, self.hi) + span * 0.1)
        idx = np.floor((values - self.lo) * self.bins / (self.hi - self.lo)).astype(np.int64)
        return np.clip(idx, 0, self.bins - 1)

    def observe(self, values, nulls=None):
        values = _clean(np.asarray(values, dtype=np.float64), nulls)
        values = values[np.isfinite(values)]
        if not len(values):
            return
        idx = self._auto_range(values)
        # bincount is ~10x add.at for large batches (write-time stats are
        # on the ingest hot path, StatsCombiner analog)
        self.counts += np.bincount(idx, minlength=self.bins)

    def observe_counts(self, values, counts):
        """Pre-aggregated observation (see EnumerationStat.observe_counts):
        identical state to a per-row observe of the expanded column —
        auto-ranging keys off min/max of the distinct values (same
        bounds), then each value's bin gains its full count."""
        values = np.asarray(values, dtype=np.float64)
        counts = np.asarray(counts, dtype=np.int64)
        finite = np.isfinite(values)
        values, counts = values[finite], counts[finite]
        if not len(values):
            return
        np.add.at(self.counts, self._auto_range(values), counts)

    def bin_bounds(self, i: int) -> Tuple[float, float]:
        w = (self.hi - self.lo) / self.bins
        return self.lo + i * w, self.lo + (i + 1) * w

    def count_between(self, lo: float, hi: float) -> float:
        """Estimated count in [lo, hi] with partial-bin interpolation
        (the StatsBasedEstimator selectivity primitive). Vectorized over the
        overlapping bin slice — this runs on the per-query planning path."""
        if self.lo is None or hi < self.lo or lo > self.hi:
            return 0.0
        if hi == lo:
            # zero-width (inclusive equality): point mass = containing bin,
            # indexed with observe()'s exact formula
            i = int(np.floor((lo - self.lo) * self.bins / (self.hi - self.lo)))
            return float(self.counts[int(np.clip(i, 0, self.bins - 1))])
        w = (self.hi - self.lo) / self.bins
        first = max(0, int((lo - self.lo) / w))
        last = min(self.bins - 1, int((hi - self.lo) / w))
        idx = np.arange(first, last + 1)
        blo = self.lo + idx * w
        overlap = np.minimum(hi, blo + w) - np.maximum(lo, blo)
        frac = np.clip(overlap / w, 0.0, 1.0)
        return float(np.dot(self.counts[first : last + 1], frac))

    def merge(self, other):
        if other.bins != self.bins:
            raise ValueError("histogram bin counts differ")
        if other.lo is None or not other.counts.any():
            return
        if self.lo is None:
            self.lo, self.hi = other.lo, other.hi
            self.counts = other.counts.copy()
            return
        if (other.lo, other.hi) != (self.lo, self.hi):
            if self._fixed or other._fixed:
                # fixed-range histograms (lon/lat/dtg) only merge with their
                # own kind: a bounds mismatch means mismatched sketches, and
                # silently re-binning would corrupt them
                raise ValueError("histogram bounds differ")
            # auto-ranged shard partials rarely share bounds: expand to the
            # union and re-bin by centers (Histogram.scala merge-with-expansion)
            lo, hi = min(self.lo, other.lo), max(self.hi, other.hi)
            self._expand(lo, hi)
            w = (other.hi - other.lo) / self.bins
            centers = other.lo + (np.arange(self.bins) + 0.5) * w
            idx = np.floor((centers - lo) * self.bins / (hi - lo)).astype(np.int64)
            np.add.at(self.counts, np.clip(idx, 0, self.bins - 1), other.counts)
            return
        self.counts += other.counts

    def state(self):
        return {
            "attribute": self.attribute,
            "bins": self.bins,
            "lo": self.lo,
            "hi": self.hi,
            "fixed": self._fixed,
            "counts": self.counts.tolist(),
        }

    @property
    def is_empty(self):
        return not self.counts.any()


class Frequency(Stat):
    """Count-min sketch (stats/Frequency.scala)."""

    kind = "frequency"
    _DEPTH = 4

    def __init__(self, attribute: str, width: int = 1024):
        self.attribute = attribute
        self.width = int(width)
        self.table = np.zeros((self._DEPTH, self.width), dtype=np.int64)

    def _hashes(self, values: np.ndarray) -> np.ndarray:
        return _cms_rows(_hash64(values), self.width, self._DEPTH)

    def observe(self, values, nulls=None):
        values = _clean(np.asarray(values), nulls)
        if not len(values):
            return
        # hash the uniques only: string hashing is per-value Python, so a
        # low-cardinality column costs its cardinality, not its length
        uniq, cnt = np.unique(values, return_counts=True)
        self.observe_counts(uniq, cnt)

    def observe_counts(self, uniq, cnt):
        """Pre-aggregated observation (see EnumerationStat.observe_counts)."""
        if not len(uniq):
            return
        idx = self._hashes(np.asarray(uniq))
        for d in range(self._DEPTH):
            np.add.at(self.table[d], idx[d], cnt)

    def count(self, value) -> int:
        idx = self._hashes(np.asarray([value]))
        return int(min(self.table[d, idx[d, 0]] for d in range(self._DEPTH)))

    def merge(self, other):
        if other.width != self.width:
            raise ValueError("frequency widths differ")
        self.table += other.table

    def state(self):
        return {
            "attribute": self.attribute,
            "width": self.width,
            "table": self.table.tolist(),
        }

    @property
    def is_empty(self):
        return not self.table.any()


class DescriptiveStats(Stat):
    """Running mean/variance (Welford-merged; stats/DescriptiveStats.scala)."""

    kind = "descriptive"

    def __init__(self, attribute: str):
        self.attribute = attribute
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def observe(self, values, nulls=None):
        values = _clean(np.asarray(values, dtype=np.float64), nulls)
        if not len(values):
            return
        other = DescriptiveStats(self.attribute)
        other.n = len(values)
        other.mean = float(values.mean())
        other.m2 = float(((values - other.mean) ** 2).sum())
        self.merge(other)

    @property
    def variance(self) -> float:
        return self.m2 / (self.n - 1) if self.n > 1 else 0.0

    def merge(self, other):
        if other.n == 0:
            return
        if self.n == 0:
            self.n, self.mean, self.m2 = other.n, other.mean, other.m2
            return
        n = self.n + other.n
        delta = other.mean - self.mean
        self.m2 = self.m2 + other.m2 + delta * delta * self.n * other.n / n
        self.mean = self.mean + delta * other.n / n
        self.n = n

    def state(self):
        return {"attribute": self.attribute, "n": self.n, "mean": self.mean, "m2": self.m2}

    @property
    def is_empty(self):
        return self.n == 0


class EnvelopeStat(Stat):
    """2D bounds over a point geometry attribute — what MinMax(geom) means in
    the reference (MinMax.scala over Geometry unions envelopes)."""

    kind = "envelope"

    def __init__(self, attribute: str):
        self.attribute = attribute
        self.xmin = self.ymin = self.xmax = self.ymax = None

    def observe_xy(self, x: np.ndarray, y: np.ndarray) -> None:
        ok = ~(np.isnan(x) | np.isnan(y))
        if not ok.any():
            return
        x, y = x[ok], y[ok]
        lo_x, hi_x, lo_y, hi_y = x.min(), x.max(), y.min(), y.max()
        if self.xmin is None:
            self.xmin, self.xmax = float(lo_x), float(hi_x)
            self.ymin, self.ymax = float(lo_y), float(hi_y)
        else:
            self.xmin = min(self.xmin, float(lo_x))
            self.xmax = max(self.xmax, float(hi_x))
            self.ymin = min(self.ymin, float(lo_y))
            self.ymax = max(self.ymax, float(hi_y))

    def observe(self, values, nulls=None):
        raise TypeError("EnvelopeStat.observe_xy(x, y) required")

    @property
    def bounds(self):
        if self.xmin is None:
            return None
        return (self.xmin, self.ymin, self.xmax, self.ymax)

    def merge(self, other):
        if other.xmin is None:
            return
        if self.xmin is None:
            self.xmin, self.ymin = other.xmin, other.ymin
            self.xmax, self.ymax = other.xmax, other.ymax
        else:
            self.xmin = min(self.xmin, other.xmin)
            self.ymin = min(self.ymin, other.ymin)
            self.xmax = max(self.xmax, other.xmax)
            self.ymax = max(self.ymax, other.ymax)

    def state(self):
        return {
            "attribute": self.attribute,
            "xmin": self.xmin,
            "ymin": self.ymin,
            "xmax": self.xmax,
            "ymax": self.ymax,
        }

    @property
    def is_empty(self):
        return self.xmin is None


class Z3HistogramStat(Stat):
    """Spatio-temporal density histogram keyed by coarse z3 (stats/Z3Histogram.scala:1-176):
    counts per (time bin, z3 prefix at ``length`` bits of the full key)."""

    kind = "z3histogram"

    def __init__(self, geom: str, dtg: str, period: str = "week", length: int = 1024):
        self.geom = geom
        self.dtg = dtg
        self.period = TimePeriod.parse(period)
        self.length = int(length)
        self.counts: Dict[int, np.ndarray] = {}

    def observe_xyt(self, x: np.ndarray, y: np.ndarray, t_ms: np.ndarray) -> None:
        ok = ~(np.isnan(x) | np.isnan(y))
        x, y, t_ms = x[ok], y[ok], np.asarray(t_ms)[ok]
        if not len(x):
            return
        bins, offsets = time_to_binned(t_ms, self.period, lenient=True)
        sfc = Z3SFC.for_period(self.period)
        z = sfc.index(x, y, offsets, lenient=True)
        self.observe_keys(z, bins)  # cell = top bits of the 63-bit key

    def observe_keys(self, keys: np.ndarray, bins: np.ndarray) -> None:
        """Same counts as observe_xyt, derived from PRECOMPUTED full z3
        keys + time bins (a sealed z3 block's key columns): the histogram
        cell is exactly the top bits of the 63-bit key, so ingest reuses
        the keys it already computed instead of re-encoding every row."""
        z = np.asarray(keys).astype(np.uint64)
        shift = np.uint64(63 - int(self.length - 1).bit_length())
        idx = np.clip((z >> shift).astype(np.int64), 0, self.length - 1)
        self._accumulate(idx, bins)

    def _accumulate(self, idx: np.ndarray, bins: np.ndarray) -> None:
        for b in np.unique(bins):
            sel = bins == b
            arr = self.counts.setdefault(int(b), np.zeros(self.length, dtype=np.int64))
            arr += np.bincount(idx[sel], minlength=self.length)

    def observe(self, values, nulls=None):  # columnar entry used by service
        raise TypeError("Z3HistogramStat.observe_xyt(x, y, t) required")

    def merge(self, other):
        for b, arr in other.counts.items():
            mine = self.counts.setdefault(b, np.zeros(self.length, dtype=np.int64))
            mine += arr

    def state(self):
        return {
            "geom": self.geom,
            "dtg": self.dtg,
            "period": self.period.value,
            "length": self.length,
            "counts": {str(b): arr.tolist() for b, arr in self.counts.items()},
        }

    @property
    def is_empty(self):
        return not self.counts


def _cms_rows(base: np.ndarray, width: int, depth: int) -> np.ndarray:
    """Count-min row indices from 64-bit base hashes (shared by the
    attribute Frequency and the Z3Frequency editions)."""
    rows = []
    for d in range(depth):
        h = _mix64(base + np.uint64((0x9E3779B97F4A7C15 * (d + 1)) & 0xFFFFFFFFFFFFFFFF))
        rows.append((h % np.uint64(width)).astype(np.int64))
    return np.stack(rows)


class Z3FrequencyStat(Stat):
    """Spatio-temporal frequency: one count-min sketch PER TIME BIN over
    z3 values masked to ``precision`` bits (stats/Z3Frequency.scala —
    geometry+date tracked as a single z value; estimates within eps*N).
    Bins that never observed anything answer 0 exactly."""

    kind = "z3frequency"
    _DEPTH = 4

    def __init__(self, geom: str, dtg: str, period: str = "week",
                 precision: int = 25, width: int = 1024):
        self.geom = geom
        self.dtg = dtg
        self.period = TimePeriod.parse(period)
        self.precision = int(precision)
        self.width = int(width)
        self.sketches: Dict[int, np.ndarray] = {}  # bin -> (DEPTH, width)

    def _masked(self, z: np.ndarray) -> np.ndarray:
        # keep the TOP precision bits of the 63-bit key: nearby points
        # (same coarse z cell) collide into one counted value
        mask = np.uint64((~((1 << (63 - self.precision)) - 1)) & (2**64 - 1))
        return np.asarray(z).astype(np.uint64) & mask

    def observe_xyt(self, x: np.ndarray, y: np.ndarray, t_ms: np.ndarray) -> None:
        ok = ~(np.isnan(x) | np.isnan(y))
        x, y, t_ms = x[ok], y[ok], np.asarray(t_ms)[ok]
        if not len(x):
            return
        bins, offsets = time_to_binned(t_ms, self.period, lenient=True)
        sfc = Z3SFC.for_period(self.period)
        self.observe_keys(sfc.index(x, y, offsets, lenient=True), bins)

    def observe_keys(self, keys: np.ndarray, bins: np.ndarray) -> None:
        """Precomputed-key edition (a sealed z3 block's key columns)."""
        z = self._masked(keys)
        bins = np.asarray(bins)
        for b in np.unique(bins):
            sel = bins == b
            uniq, cnt = np.unique(z[sel], return_counts=True)
            idx = _cms_rows(_mix64(uniq), self.width, self._DEPTH)
            table = self.sketches.setdefault(
                int(b), np.zeros((self._DEPTH, self.width), dtype=np.int64)
            )
            for d in range(self._DEPTH):
                np.add.at(table[d], idx[d], cnt)

    def count(self, x: float, y: float, t_ms: int) -> int:
        bins, offsets = time_to_binned(
            np.asarray([t_ms]), self.period, lenient=True
        )
        sfc = Z3SFC.for_period(self.period)
        z = sfc.index(np.asarray([x]), np.asarray([y]), offsets, lenient=True)
        return self.count_direct(int(bins[0]), int(z[0]))

    def count_direct(self, time_bin: int, z: int) -> int:
        table = self.sketches.get(int(time_bin))
        if table is None:
            return 0
        zu = self._masked(np.asarray([z], dtype=np.uint64))
        idx = _cms_rows(_mix64(zu), self.width, self._DEPTH)
        return int(min(table[d, idx[d, 0]] for d in range(self._DEPTH)))

    def observe(self, values, nulls=None):
        raise TypeError("Z3FrequencyStat.observe_xyt(x, y, t) required")

    def merge(self, other):
        if (
            other.width != self.width
            or other.precision != self.precision
            or other.period != self.period
        ):
            # periods key the integer time bins: summing week-binned and
            # day-binned tables would silently corrupt counts
            raise ValueError("z3frequency shapes differ")
        for b, table in other.sketches.items():
            mine = self.sketches.setdefault(
                b, np.zeros((self._DEPTH, self.width), dtype=np.int64)
            )
            mine += table

    def state(self):
        return {
            "geom": self.geom,
            "dtg": self.dtg,
            "period": self.period.value,
            "precision": self.precision,
            "width": self.width,
            "sketches": {str(b): t.tolist() for b, t in self.sketches.items()},
        }

    @property
    def is_empty(self):
        return not self.sketches


def _json_key(k):
    """Group keys serialize as [typecode, value] so ints/floats/strings/
    bools round-trip distinguishably through JSON object-less arrays."""
    if isinstance(k, np.generic):
        k = k.item()
    if isinstance(k, bool):
        return ["b", k]
    if isinstance(k, int):
        return ["i", k]
    if isinstance(k, float):
        return ["f", k]
    return ["s", str(k)]


def _unjson_key(tk):
    t, v = tk
    return {"b": bool, "i": int, "f": float, "s": str}[t](v)


class GroupByStat(Stat):
    """Per-group sub-sketches keyed by an attribute's value
    (stats/GroupBy.scala: groupedStats map + an example stat re-parsed
    per new key). ``example`` is the EMPTY sub-stat's JSON — each new
    group clones it, merges combine per key."""

    kind = "groupby"

    def __init__(self, attribute: str, example):
        self.attribute = attribute
        self.example = example.to_json() if isinstance(example, Stat) else str(example)
        self.groups: Dict[Any, Stat] = {}

    def _new(self) -> Stat:
        return from_json(self.example)

    def size(self) -> int:
        return len(self.groups)

    def get(self, key) -> Optional[Stat]:
        return self.groups.get(key)

    def observe_grouped(
        self, keys: np.ndarray, values: np.ndarray,
        nulls: Optional[np.ndarray] = None,
    ) -> None:
        """Group rows by key and feed each group's slice of ``values`` to
        that group's sub-stat (null keys are skipped, like the reference
        skipping features whose grouping attribute is missing). Grouping
        is O(n log n) — factorize + one stable sort — not a full-column
        scan per distinct key, so high-cardinality attributes stay
        linear-ish."""
        keys = np.asarray(keys)
        values = np.asarray(values)
        kvalid = _object_ok(keys)
        idx = np.flatnonzero(kvalid)
        if not len(idx):
            return
        if keys.dtype.kind == "O":
            # object keys may be mixed-type (unsortable): dict factorize
            codes_of: Dict[Any, int] = {}
            uniq: List[Any] = []
            inv = np.empty(len(idx), dtype=np.int64)
            for j, i in enumerate(idx):
                k = keys[i]
                c = codes_of.get(k)
                if c is None:
                    c = codes_of[k] = len(uniq)
                    uniq.append(k)
                inv[j] = c
        else:
            u, inv = np.unique(keys[idx], return_inverse=True)
            uniq = [k.item() for k in u]
        order = np.argsort(inv, kind="stable")
        bounds = np.searchsorted(inv[order], np.arange(len(uniq) + 1))
        rows = idx[order]
        for c, k in enumerate(uniq):
            sel = rows[bounds[c] : bounds[c + 1]]
            sub = self.groups.get(k)
            if sub is None:
                sub = self.groups[k] = self._new()
            sub.observe(values[sel], None if nulls is None else nulls[sel])

    def observe(self, values, nulls=None):
        # grouping attribute observed by its own sub-stat (GroupBy(a, Count()))
        self.observe_grouped(values, values, nulls)

    def merge(self, other):
        for k, stat in other.groups.items():
            mine = self.groups.get(k)
            if mine is None:
                self.groups[k] = from_json(stat.to_json())
            else:
                mine.merge(stat)

    def state(self):
        try:
            items = sorted(self.groups.items(), key=lambda kv: kv[0])
        except TypeError:
            items = sorted(self.groups.items(), key=lambda kv: str(kv[0]))
        return {
            "attribute": self.attribute,
            "example": json.loads(self.example),
            "groups": [
                [_json_key(k), json.loads(v.to_json())] for k, v in items
            ],
        }

    @property
    def is_empty(self):
        return all(s.is_empty for s in self.groups.values())


def _object_ok(keys: np.ndarray) -> np.ndarray:
    if keys.dtype.kind == "O":
        return np.not_equal(keys, None)
    if keys.dtype.kind == "f":
        return ~np.isnan(keys)
    return np.ones(len(keys), dtype=bool)


class SeqStat(Stat):
    """Multiple sketches observed together (Stat.scala SeqStat)."""

    kind = "seq"

    def __init__(self, stats: Sequence[Stat]):
        self.stats = list(stats)

    def observe(self, values, nulls=None):
        for s in self.stats:
            s.observe(values, nulls)

    def merge(self, other):
        for a, b in zip(self.stats, other.stats):
            a.merge(b)

    def state(self):
        return {"stats": [json.loads(s.to_json()) for s in self.stats]}

    @property
    def is_empty(self):
        return all(s.is_empty for s in self.stats)


_KINDS = {}


def _register(cls):
    _KINDS[cls.kind] = cls
    return cls


for _cls in (
    CountStat,
    MinMax,
    EnumerationStat,
    TopK,
    Histogram,
    Frequency,
    DescriptiveStats,
    EnvelopeStat,
    Z3HistogramStat,
    Z3FrequencyStat,
    GroupByStat,
    SeqStat,
):
    _register(_cls)


def from_json(text: str) -> Stat:
    d = json.loads(text)
    return _from_state(d)


def _from_state(d: Dict[str, Any]) -> Stat:
    kind = d.pop("kind")
    if kind == "count":
        return CountStat(d["count"])
    if kind == "minmax":
        s = MinMax(
            d["attribute"],
            d.get("dtype", "f8"),
            track_cardinality=d.get("track_cardinality", True),
        )
        s.min, s.max = d["min"], d["max"]
        s.registers = np.asarray(d["registers"], dtype=np.int8)
        return s
    if kind == "enumeration":
        s = EnumerationStat(d["attribute"])
        s.counts = {k: v for k, v in (tuple(p) for p in d["counts"])}
        return s
    if kind == "topk":
        s = TopK(d["attribute"], d["capacity"])
        s.counts = {k: v for k, v in (tuple(p) for p in d["counts"])}
        return s
    if kind == "histogram":
        s = Histogram(d["attribute"], d["bins"], d["lo"], d["hi"])
        s._fixed = d.get("fixed", True)  # legacy payloads were fixed-range
        s.counts = np.asarray(d["counts"], dtype=np.int64)
        return s
    if kind == "frequency":
        s = Frequency(d["attribute"], d["width"])
        s.table = np.asarray(d["table"], dtype=np.int64)
        return s
    if kind == "descriptive":
        s = DescriptiveStats(d["attribute"])
        s.n, s.mean, s.m2 = d["n"], d["mean"], d["m2"]
        return s
    if kind == "envelope":
        s = EnvelopeStat(d["attribute"])
        s.xmin, s.ymin = d["xmin"], d["ymin"]
        s.xmax, s.ymax = d["xmax"], d["ymax"]
        return s
    if kind == "z3histogram":
        s = Z3HistogramStat(d["geom"], d["dtg"], d["period"], d["length"])
        s.counts = {int(b): np.asarray(a, dtype=np.int64) for b, a in d["counts"].items()}
        return s
    if kind == "z3frequency":
        s = Z3FrequencyStat(
            d["geom"], d["dtg"], d["period"], d["precision"], d["width"]
        )
        s.sketches = {
            int(b): np.asarray(t, dtype=np.int64)
            for b, t in d["sketches"].items()
        }
        return s
    if kind == "groupby":
        s = GroupByStat(d["attribute"], json.dumps(d["example"]))
        s.groups = {
            _unjson_key(tk): _from_state(dict(v)) for tk, v in d["groups"]
        }
        return s
    if kind == "seq":
        return SeqStat([_from_state(x) for x in d["stats"]])
    raise ValueError(f"unknown stat kind: {kind}")
