"""Sketches: the count, histograms and the attribute value sketches.

Port of ``geomesa_tpu/stats/sketches.py`` limited to what the strategy
choice reads: ``CountStat``, ``Histogram`` (fixed or auto-ranging),
``MinMax`` (bounds + a hyperloglog cardinality), ``TopK`` (space-saving)
and ``Frequency`` (count-min) (stats/CountStat.scala, Histogram.scala,
MinMax.scala, TopK.scala, Frequency.scala). Merging and persistence are not
ported. ``observe_counts`` takes pre-aggregated (distinct value, count)
pairs, as dictionary columns feed them, and gives the state a per-row
``observe`` of the expanded column would.
"""

from __future__ import annotations

import hashlib
import heapq
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _hash64(values: np.ndarray) -> np.ndarray:
    """Seed-stable 64-bit hashes: strings via blake2b (Python's hash() is
    randomized per process), numerics via splitmix64 of the float bits,
    -0.0 folded onto +0.0 first (hashes follow value equality)."""
    if values.dtype.kind in "OUS":
        return np.array(
            [
                int.from_bytes(hashlib.blake2b(str(v).encode(), digest_size=8).digest(), "little")
                for v in values
            ],
            dtype=np.uint64,
        )
    return _mix64((np.asarray(values, dtype=np.float64) + 0.0).view(np.uint64))


def _mix64(h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized."""
    h = h.astype(np.uint64)
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return h ^ (h >> np.uint64(31))


def _leading_zeros_53(h: np.ndarray) -> np.ndarray:
    """64-bit leading-zero count via the float exponent (exact for the top
    53 bits, all that hyperloglog rank estimation needs)."""
    out = np.full(h.shape, 64, dtype=np.int64)
    nz = h != 0
    f = h[nz].astype(np.float64)
    out[nz] = 63 - np.floor(np.log2(f)).astype(np.int64)
    return out


def _cms_rows(base: np.ndarray, width: int, depth: int) -> np.ndarray:
    """Count-min row indices [depth, n] from 64-bit base hashes."""
    rows = []
    for d in range(depth):
        h = _mix64(base + np.uint64((0x9E3779B97F4A7C15 * (d + 1)) & 0xFFFFFFFFFFFFFFFF))
        rows.append((h % np.uint64(width)).astype(np.int64))
    return np.stack(rows)


def _clean(values: np.ndarray, nulls: Optional[np.ndarray]) -> np.ndarray:
    if nulls is not None:
        values = values[~nulls]
    if values.dtype.kind == "f":
        values = values[~np.isnan(values)]
    elif values.dtype.kind == "O":
        values = values[np.array([v is not None for v in values], dtype=bool)]
    return values


class CountStat:
    """Total observed count (stats/CountStat.scala)."""

    def __init__(self, count: int = 0):
        self.count = int(count)


class Histogram:
    """Fixed-width binned counts over [lo, hi] (stats/Histogram.scala,
    BinnedArray semantics: out-of-range values clamp into the end bins).
    With ``lo``/``hi`` None the range starts from the first batch and
    expands by re-binning when later data falls outside it."""

    def __init__(self, attribute: str, bins: int, lo=None, hi=None):
        self.attribute = attribute
        self.bins = int(bins)
        self.lo = None if lo is None else float(lo)
        self.hi = None if hi is None else float(hi)
        self._fixed = lo is not None
        self.counts = np.zeros(self.bins, dtype=np.int64)

    @property
    def is_empty(self) -> bool:
        return not self.counts.any()

    def _expand(self, lo: float, hi: float) -> None:
        """Grow [lo, hi] and re-bin the counts by old-bin centers."""
        old_lo, old_hi, old_counts = self.lo, self.hi, self.counts
        self.lo, self.hi = lo, hi
        self.counts = np.zeros(self.bins, dtype=np.int64)
        if old_counts.any():
            w = (old_hi - old_lo) / self.bins
            centers = old_lo + (np.arange(self.bins) + 0.5) * w
            idx = np.floor((centers - lo) * self.bins / (hi - lo)).astype(np.int64)
            np.add.at(self.counts, np.clip(idx, 0, self.bins - 1), old_counts)

    def _auto_range(self, values: np.ndarray) -> np.ndarray:
        """Initialise or expand [lo, hi] from the batch's min and max, then
        each value's clipped bin (one formula for observe and
        observe_counts)."""
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
        idx = self._auto_range(values)  # may re-bin self.counts: read it after
        self.counts += np.bincount(idx, minlength=self.bins)

    def observe_counts(self, values, counts):
        values = np.asarray(values, dtype=np.float64)
        counts = np.asarray(counts, dtype=np.int64)
        finite = np.isfinite(values)
        values, counts = values[finite], counts[finite]
        if not len(values):
            return
        np.add.at(self.counts, self._auto_range(values), counts)

    def count_between(self, lo: float, hi: float) -> float:
        """Estimated count in [lo, hi] with partial-bin interpolation
        (the StatsBasedEstimator selectivity primitive)."""
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


class MinMax:
    """Attribute bounds + a hyperloglog cardinality estimate
    (stats/MinMax.scala): 2^12 registers over a 64-bit hash. Bounds-only
    (``track_cardinality=False``) skips the hashing."""

    _P = 12

    def __init__(self, attribute: str, track_cardinality: bool = True):
        self.attribute = attribute
        self.min: Optional[Any] = None
        self.max: Optional[Any] = None
        self.track_cardinality = track_cardinality
        self.registers = np.zeros(1 << self._P, dtype=np.int8)

    @property
    def is_empty(self) -> bool:
        return self.min is None

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
        if self.track_cardinality:
            h = _hash64(values)
            idx = (h >> np.uint64(64 - self._P)).astype(np.int64)
            rho = (np.clip(_leading_zeros_53(h << np.uint64(self._P)), 0, 64 - self._P)
                   + 1).astype(np.int8)
            np.maximum.at(self.registers, idx, rho)

    def observe_counts(self, values, counts):
        """Bounds and registers depend on the value set only."""
        del counts
        self.observe(values)

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


class TopK:
    """Space-saving top-k (stats/TopK.scala): newcomers past the capacity
    enter at the evicted minimum plus their count, once per batch."""

    def __init__(self, attribute: str, capacity: int = 1000):
        self.attribute = attribute
        self.capacity = capacity
        self.counts: Dict[Any, int] = {}

    @property
    def is_empty(self) -> bool:
        return not self.counts

    def observe(self, values, nulls=None):
        values = _clean(np.asarray(values), nulls)
        uniq, cnt = np.unique(values, return_counts=True)
        self.observe_counts(uniq, cnt)

    def observe_counts(self, uniq, cnt):
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


class Frequency:
    """Count-min sketch, 4 rows (stats/Frequency.scala)."""

    _DEPTH = 4

    def __init__(self, attribute: str, width: int = 1024):
        self.attribute = attribute
        self.width = int(width)
        self.table = np.zeros((self._DEPTH, self.width), dtype=np.int64)

    @property
    def is_empty(self) -> bool:
        return not self.table.any()

    def _hashes(self, values: np.ndarray) -> np.ndarray:
        return _cms_rows(_hash64(values), self.width, self._DEPTH)

    def observe(self, values, nulls=None):
        values = _clean(np.asarray(values), nulls)
        if not len(values):
            return
        uniq, cnt = np.unique(values, return_counts=True)
        self.observe_counts(uniq, cnt)

    def observe_counts(self, uniq, cnt):
        if not len(uniq):
            return
        idx = self._hashes(np.asarray(uniq))
        for d in range(self._DEPTH):
            np.add.at(self.table[d], idx[d], cnt)

    def count(self, value) -> int:
        idx = self._hashes(np.asarray([value]))
        return int(min(self.table[d, idx[d, 0]] for d in range(self._DEPTH)))
