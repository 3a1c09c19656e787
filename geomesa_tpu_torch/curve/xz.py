"""XZ-ordering curves for geometries with extent (polygons/lines).

Port of ``geomesa_tpu/curve/xz.py``. ``ranges_boxes`` runs the C++ BFS
(``geomesa_tpu_torch/native`` ``xzranges.cpp``) first, and the pure-Python
BFS, its plain edition, when the library is unavailable or the curve is
outside its domain (g > 20). Callers pass a ``max_ranges`` budget: an
unbounded XZ3 walk in Python takes minutes.

Rebuild of the reference's XZ2SFC/XZ3SFC (geomesa-z3 .../curve/XZ2SFC.scala,
XZ3SFC.scala), implementing 'XZ-Ordering: A Space-Filling Curve for Objects
with Spatial Extension' (Boehm, Klump, Kriegel). An object is indexed by an
*enlarged* quad/oct-tree cell chosen from its bounding box: the sequence-code
length is derived from the box's max extent (paper section 4.1), and the code
itself walks the tree accumulating subtree sizes (paper definition 2).

``index`` is vectorized over arrays of bounding boxes (ingest hot path);
``ranges`` is a host-side BFS over the tree with contained/overlap tests on
*extended* elements (each element's upper bounds stretched by its own width),
emitting lemma-3 sequence intervals for contained cells.
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.curve import binnedtime
from geomesa_tpu_torch.curve.binnedtime import TimePeriod
from geomesa_tpu_torch.curve.zorder import IndexRange, merge_ranges

# XZSFC.scala:11-16
XZ_DEFAULT_G = 12
_LOG_POINT_FIVE = math.log(0.5)


def _sequence_length(norm_mins, norm_maxs, g: int) -> np.ndarray:
    """Vectorized sequence-code length from normalized per-dim extents.

    Reference: XZ2SFC.scala:54-77 -- l1 = floor(log(maxDim)/log(0.5)); use
    l1+1 when the box fits in an enlarged cell at that finer resolution in
    every dimension, else l1; degenerate (zero-extent) boxes get g.
    """
    dims = len(norm_mins)
    max_dim = norm_maxs[0] - norm_mins[0]
    for d in range(1, dims):
        max_dim = np.maximum(max_dim, norm_maxs[d] - norm_mins[d])
    with np.errstate(divide="ignore"):
        l1 = np.floor(np.log(max_dim) / _LOG_POINT_FIVE)
    # maxDim == 0 -> log -> -inf -> l1 = +inf -> clamps to g
    l1 = np.where(np.isfinite(l1), l1, float(2**31 - 1))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        w2 = np.power(0.5, l1 + 1)
        fits = np.ones(max_dim.shape, dtype=bool)
        for d in range(dims):
            fits &= norm_maxs[d] <= (np.floor(norm_mins[d] / w2) * w2) + 2 * w2
    length = np.where(l1 >= g, g, np.where(fits, l1 + 1, l1))
    return length.astype(np.int64)


def _sequence_code(norm_mins, lengths: np.ndarray, g: int, base: int) -> np.ndarray:
    """Vectorized sequence code: walk ``length`` levels of the 2^dims-tree.

    Reference: XZ2SFC.scala:264-286 / XZ3SFC.scala:275-303. ``base`` is 4 for
    quads, 8 for octs; at step i the chosen child q adds
    1 + q*(base^(g-i)-1)/(base-1).
    """
    dims = len(norm_mins)
    n = norm_mins[0].shape[0]
    lo = [np.zeros(n, dtype=np.float64) for _ in range(dims)]
    hi = [np.ones(n, dtype=np.float64) for _ in range(dims)]
    cs = np.zeros(n, dtype=np.int64)
    for i in range(g):
        active = i < lengths
        if not active.any():
            break
        centers = [(lo[d] + hi[d]) / 2.0 for d in range(dims)]
        q = np.zeros(n, dtype=np.int64)
        for d in range(dims):
            q |= (norm_mins[d] >= centers[d]).astype(np.int64) << d
        step = (base ** (g - i) - 1) // (base - 1)
        cs = np.where(active, cs + 1 + q * step, cs)
        for d in range(dims):
            upper = (q >> d) & 1
            lo[d] = np.where(active & (upper == 1), centers[d], lo[d])
            hi[d] = np.where(active & (upper == 0), centers[d], hi[d])
    return cs


class _XZSFC:
    """Shared XZ logic over ``dims`` dimensions (base = 2^dims tree)."""

    def __init__(self, g: int, bounds: Sequence[Tuple[float, float]]):
        self.g = int(g)
        self.dims = len(bounds)
        self.base = 1 << self.dims
        self.bounds = [(float(lo), float(hi)) for lo, hi in bounds]
        self._sizes = [hi - lo for lo, hi in self.bounds]

    def _normalize(self, mins, maxs, lenient: bool):
        """Normalize user-space box corners to [0,1] (XZ2SFC.scala:330-369)."""
        nmins, nmaxs = [], []
        for d in range(self.dims):
            lo_b, hi_b = self.bounds[d]
            mn = np.atleast_1d(np.asarray(mins[d], dtype=np.float64))
            mx = np.atleast_1d(np.asarray(maxs[d], dtype=np.float64))
            # require() phrasing so NaN fails ordering/bounds (XZ2SFC.scala:335-341)
            if not np.all(mn <= mx):
                raise ValueError("Bounds must be ordered")
            if lenient:
                mn = np.clip(mn, lo_b, hi_b)
                mx = np.clip(mx, lo_b, hi_b)
            elif not np.all((mn >= lo_b) & (mx <= hi_b)):
                raise ValueError(
                    f"Values out of bounds [{lo_b} {hi_b}] in dim {d}"
                )
            nmins.append((mn - lo_b) / self._sizes[d])
            nmaxs.append((mx - lo_b) / self._sizes[d])
        return nmins, nmaxs

    def index_boxes(self, mins, maxs, lenient: bool = False) -> np.ndarray:
        """Vectorized sequence codes for arrays of bounding boxes."""
        nmins, nmaxs = self._normalize(mins, maxs, lenient)
        lengths = _sequence_length(nmins, nmaxs, self.g)
        return _sequence_code(nmins, lengths, self.g, self.base)

    def _code_scalar(self, corner: Tuple[float, ...], length: int) -> int:
        """Sequence code of the cell with lower-left ``corner`` (delegates to
        the vectorized walk so ingest and planning share one implementation)."""
        code = _sequence_code(
            [np.asarray([c], dtype=np.float64) for c in corner],
            np.asarray([length], dtype=np.int64),
            self.g,
            self.base,
        )
        return int(code[0])

    def ranges_boxes(
        self,
        windows: Sequence[Tuple[Tuple[float, ...], Tuple[float, ...]]],
        max_ranges: Optional[int] = None,
    ) -> List[IndexRange]:
        """BFS decomposition of OR'd query windows into sequence-code ranges.

        Reference: XZ2SFC.scala:146-252. Elements are *extended* (upper bounds
        + own width) for the contains/overlaps tests; a contained element
        emits the lemma-3 interval covering its whole subtree, a partial one
        emits its single code and recurses; when the budget is hit, remaining
        elements emit their full (loose) subtree intervals.
        """
        stop = max_ranges if max_ranges is not None else (1 << 31)
        queries = []
        for mins, maxs in windows:
            nmins, nmaxs = self._normalize(
                [np.asarray([m]) for m in mins], [np.asarray([m]) for m in maxs], False
            )
            queries.append(
                (
                    tuple(float(v[0]) for v in nmins),
                    tuple(float(v[0]) for v in nmaxs),
                )
            )

        # latency-critical planning path: the C++ BFS (same semantics,
        # tested against the Python walk below) unless it is unavailable
        from geomesa_tpu_torch.native import xzranges_native

        native = xzranges_native(
            [q[0] for q in queries], [q[1] for q in queries], self.dims, self.g, max_ranges
        )
        if native is not None:
            return [IndexRange(lo, hi, c) for lo, hi, c in native]

        dims, base, g = self.dims, self.base, self.g
        ranges: List[IndexRange] = []

        def is_contained(lo, hi, length):
            for qlo, qhi in queries:
                if all(
                    qlo[d] <= lo[d] and qhi[d] >= hi[d] + length for d in range(dims)
                ):
                    return True
            return False

        def overlaps(lo, hi, length):
            for qlo, qhi in queries:
                if all(
                    qhi[d] >= lo[d] and qlo[d] <= hi[d] + length for d in range(dims)
                ):
                    return True
            return False

        def interval(lo, level, partial):
            mn = self._code_scalar(lo, level)
            if partial:
                return mn, mn
            return mn, mn + (base ** (g - level + 1) - 1) // (base - 1)

        def children(lo, hi, length):
            centers = [(lo[d] + hi[d]) / 2.0 for d in range(dims)]
            half = length / 2.0
            out = []
            for corner in range(base):
                clo = tuple(
                    centers[d] if (corner >> d) & 1 else lo[d] for d in range(dims)
                )
                chi = tuple(
                    hi[d] if (corner >> d) & 1 else centers[d] for d in range(dims)
                )
                out.append((clo, chi, half))
            return out

        TERMINATOR = None
        queue: deque = deque(
            children(tuple([0.0] * dims), tuple([1.0] * dims), 1.0)
        )
        queue.append(TERMINATOR)
        level = 1
        while level < g and queue and len(ranges) < stop:
            elem = queue.popleft()
            if elem is TERMINATOR:
                if queue:
                    level += 1
                    queue.append(TERMINATOR)
                continue
            lo, hi, length = elem
            if is_contained(lo, hi, length):
                mn, mx = interval(lo, level, partial=False)
                ranges.append(IndexRange(mn, mx, True))
            elif overlaps(lo, hi, length):
                mn, mx = interval(lo, level, partial=True)
                ranges.append(IndexRange(mn, mx, False))
                queue.extend(children(lo, hi, length))
        # flush whatever remains as loose full-subtree intervals
        while queue:
            elem = queue.popleft()
            if elem is TERMINATOR:
                level += 1
                continue
            lo, hi, length = elem
            mn, mx = interval(lo, level, partial=False)
            ranges.append(IndexRange(mn, mx, False))

        return merge_ranges(ranges)


class XZ2SFC(_XZSFC):
    """2D XZ curve over lon/lat (XZ2SFC.scala:25; default g=12)."""

    _cache = {}

    def __init__(
        self,
        g: int = XZ_DEFAULT_G,
        x_bounds: Tuple[float, float] = (-180.0, 180.0),
        y_bounds: Tuple[float, float] = (-90.0, 90.0),
    ):
        super().__init__(g, [x_bounds, y_bounds])

    @classmethod
    def for_g(cls, g: int = XZ_DEFAULT_G) -> "XZ2SFC":
        if g not in cls._cache:
            cls._cache[g] = cls(g)
        return cls._cache[g]

    def index(self, xmin, ymin, xmax, ymax, lenient: bool = False) -> np.ndarray:
        return self.index_boxes([xmin, ymin], [xmax, ymax], lenient)

    def ranges(
        self,
        queries: Sequence[Tuple[float, float, float, float]],
        max_ranges: Optional[int] = None,
    ) -> List[IndexRange]:
        windows = [((q[0], q[1]), (q[2], q[3])) for q in queries]
        return self.ranges_boxes(windows, max_ranges)


class XZ3SFC(_XZSFC):
    """3D XZ curve over lon/lat/time-offset, one instance per (g, period)
    (XZ3SFC.scala:26, 382-400)."""

    _cache = {}

    def __init__(
        self,
        g: int = XZ_DEFAULT_G,
        period: TimePeriod = TimePeriod.WEEK,
        x_bounds: Tuple[float, float] = (-180.0, 180.0),
        y_bounds: Tuple[float, float] = (-90.0, 90.0),
    ):
        self.period = TimePeriod.parse(period)
        z_max = float(binnedtime.max_offset(self.period))
        super().__init__(g, [x_bounds, y_bounds, (0.0, z_max)])

    @classmethod
    def for_period(cls, g: int, period: TimePeriod) -> "XZ3SFC":
        key = (g, TimePeriod.parse(period))
        if key not in cls._cache:
            cls._cache[key] = cls(g, period)
        return cls._cache[key]

    def index(
        self, xmin, ymin, tmin, xmax, ymax, tmax, lenient: bool = False
    ) -> np.ndarray:
        return self.index_boxes([xmin, ymin, tmin], [xmax, ymax, tmax], lenient)

    def ranges(
        self,
        queries: Sequence[Tuple[float, float, float, float, float, float]],
        max_ranges: Optional[int] = None,
    ) -> List[IndexRange]:
        windows = [((q[0], q[1], q[2]), (q[3], q[4], q[5])) for q in queries]
        return self.ranges_boxes(windows, max_ranges)
