"""Point space-filling curves: Z2 (lon/lat) and Z3 (lon/lat/time-offset).

Port of ``geomesa_tpu/curve/sfc.py``. ``ranges_arrays``, the planner's
entry, runs the C++ range BFS (``geomesa_tpu_torch/native`` ``zranges.cpp``),
or the Python walk when that library is unavailable; ``ranges`` is the
Python walk (``zorder.zranges``), the plain edition.

Vectorized rebuilds of the reference's Z2SFC/Z3SFC (geomesa-z3
.../curve/Z2SFC.scala:15-54, Z3SFC.scala:23-77): ``index`` normalizes doubles
into bit space and interleaves; ``invert`` decodes to bin centers; ``ranges``
decomposes query boxes into key ranges via the quad/oct-tree walk in
:mod:`geomesa_tpu_torch.curve.zorder`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.curve import binnedtime
from geomesa_tpu_torch.curve.binnedtime import TimePeriod
from geomesa_tpu_torch.curve.normalized import NormalizedLat, NormalizedLon, NormalizedTime
from geomesa_tpu_torch.curve.zorder import (
    IndexRange,
    z2_decode,
    z2_encode,
    z3_decode,
    z3_encode,
    zranges,
    zranges_arrays,
)


class Z2SFC:
    """2D point curve, 31 bits per dimension by default (Z2SFC.scala:15)."""

    def __init__(self, precision: int = 31):
        self.precision = precision
        self.lon = NormalizedLon(precision)
        self.lat = NormalizedLat(precision)

    def index(self, x, y, lenient: bool = False) -> np.ndarray:
        """Encode lon/lat arrays to 62-bit z values (Z2SFC.scala:28-43)."""
        x = np.atleast_1d(np.asarray(x, dtype=np.float64))
        y = np.atleast_1d(np.asarray(y, dtype=np.float64))
        if lenient:
            x = np.clip(x, self.lon.min, self.lon.max)
            y = np.clip(y, self.lat.min, self.lat.max)
        else:
            self._check_bounds(x, y)
        return z2_encode(self.lon.normalize(x), self.lat.normalize(y))

    def _check_bounds(self, x: np.ndarray, y: np.ndarray) -> None:
        # phrased as require(all in bounds) so NaN fails, matching the
        # reference's require() semantics (Z2SFC.scala:30-31)
        ok = (
            (x >= self.lon.min)
            & (x <= self.lon.max)
            & (y >= self.lat.min)
            & (y <= self.lat.max)
        )
        if not ok.all():
            raise ValueError(
                f"Value(s) out of bounds ([{self.lon.min},{self.lon.max}], "
                f"[{self.lat.min},{self.lat.max}])"
            )

    def invert(self, z) -> Tuple[np.ndarray, np.ndarray]:
        xi, yi = z2_decode(z)
        return self.lon.denormalize(xi), self.lat.denormalize(yi)

    def ranges(
        self,
        xy: Sequence[Tuple[float, float, float, float]],
        precision: int = 64,
        max_ranges: Optional[int] = None,
        exact_skip: bool = False,
    ) -> List[IndexRange]:
        """Decompose (xmin, ymin, xmax, ymax) boxes into z ranges (Z2SFC.scala:50-54).

        With ``exact_skip`` the ``contained`` flag of the returned ranges is
        computed against the strict INTERIOR of each box (normalized bounds
        shrunk one unit per side): because ``normalize`` is monotone, a row
        whose cell lies inside the interior provably satisfies the raw f64
        bbox predicate, so scans may skip the post-filter for those ranges.
        """
        args = self._range_inputs(xy, exact_skip)
        return zranges(*args[:2], self.precision, 2, max_ranges, precision,
                       skip_mins=args[2], skip_maxs=args[3])

    def ranges_arrays(
        self,
        xy: Sequence[Tuple[float, float, float, float]],
        precision: int = 64,
        max_ranges: Optional[int] = None,
        exact_skip: bool = False,
    ):
        """:meth:`ranges` as (lower[], upper[], contained[]) arrays
        (``zorder.zranges_arrays``: the C++ BFS first)."""
        args = self._range_inputs(xy, exact_skip)
        return zranges_arrays(*args[:2], self.precision, 2, max_ranges, precision,
                              skip_mins=args[2], skip_maxs=args[3])

    def _range_inputs(self, xy, exact_skip: bool):
        mins, maxs = [], []
        skip_mins: List[List[int]] = []
        skip_maxs: List[List[int]] = []
        for xmin, ymin, xmax, ymax in xy:
            self._check_bounds(
                np.asarray([xmin, xmax], dtype=np.float64),
                np.asarray([ymin, ymax], dtype=np.float64),
            )
            nx0, ny0 = int(self.lon.normalize(xmin)[()]), int(self.lat.normalize(ymin)[()])
            nx1, ny1 = int(self.lon.normalize(xmax)[()]), int(self.lat.normalize(ymax)[()])
            mins.append([nx0, ny0])
            maxs.append([nx1, ny1])
            if exact_skip and nx0 + 1 <= nx1 - 1 and ny0 + 1 <= ny1 - 1:
                skip_mins.append([nx0 + 1, ny0 + 1])
                skip_maxs.append([nx1 - 1, ny1 - 1])
        return (
            mins,
            maxs,
            skip_mins if exact_skip else None,
            skip_maxs if exact_skip else None,
        )


class Z3SFC:
    """3D point+time curve, 21 bits per dimension (Z3SFC.scala:23-66).

    The time dimension normalizes the offset *within* a time bin; callers pair
    each z value with its 2-byte bin (see Z3IndexKeySpace).
    """

    _cache = {}

    def __init__(self, period: TimePeriod, precision: int = 21):
        if not (0 < precision < 22):
            raise ValueError("Precision (bits) per dimension must be in [1,21]")
        self.period = TimePeriod.parse(period)
        self.precision = precision
        self.lon = NormalizedLon(precision)
        self.lat = NormalizedLat(precision)
        self.time = NormalizedTime(precision, float(binnedtime.max_offset(self.period)))

    @classmethod
    def for_period(cls, period: TimePeriod) -> "Z3SFC":
        """Cached instance per period (Z3SFC.scala:69-77)."""
        period = TimePeriod.parse(period)
        if period not in cls._cache:
            cls._cache[period] = cls(period)
        return cls._cache[period]

    @property
    def whole_period(self) -> Tuple[int, int]:
        return (int(self.time.min), int(self.time.max))

    def index(self, x, y, t, lenient: bool = False) -> np.ndarray:
        """Encode lon/lat/time-offset arrays to 63-bit z values (Z3SFC.scala:33-48)."""
        x = np.atleast_1d(np.asarray(x, dtype=np.float64))
        y = np.atleast_1d(np.asarray(y, dtype=np.float64))
        t = np.atleast_1d(np.asarray(t, dtype=np.int64))
        if lenient:
            x = np.clip(x, self.lon.min, self.lon.max)
            y = np.clip(y, self.lat.min, self.lat.max)
            t = np.clip(t, int(self.time.min), int(self.time.max))
        else:
            self._check_bounds(x, y, t)
        return z3_encode(
            self.lon.normalize(x), self.lat.normalize(y), self.time.normalize(t)
        )

    def _check_bounds(self, x: np.ndarray, y: np.ndarray, t: np.ndarray) -> None:
        ok = (
            (x >= self.lon.min)
            & (x <= self.lon.max)
            & (y >= self.lat.min)
            & (y <= self.lat.max)
            & (t >= self.time.min)
            & (t <= self.time.max)
        )
        if not ok.all():
            raise ValueError(
                f"Value(s) out of bounds ([{self.lon.min},{self.lon.max}], "
                f"[{self.lat.min},{self.lat.max}], [{self.time.min},{self.time.max}])"
            )

    def invert(self, z) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        xi, yi, ti = z3_decode(z)
        return (
            self.lon.denormalize(xi),
            self.lat.denormalize(yi),
            self.time.denormalize(ti).astype(np.int64),
        )

    def ranges(
        self,
        xy: Sequence[Tuple[float, float, float, float]],
        t: Sequence[Tuple[int, int]],
        precision: int = 64,
        max_ranges: Optional[int] = None,
        exact_skip: bool = False,
    ) -> List[IndexRange]:
        """Decompose spatial boxes x time-offset windows into z ranges
        (Z3SFC.scala:56-65: the cross product of boxes and windows).

        ``exact_skip``: compute the ``contained`` flag against the strict
        interior of each (box, window) so flagged ranges provably satisfy
        the raw predicate (see Z2SFC.ranges). The time dimension shrinks by
        an extra ``ceil(bins/extent)`` units per side to absorb the
        offset-unit floor rounding between raw ms and stored offsets."""
        # one normalized unit per side guards the normalize() floor; the
        # extra margin guards the ms -> offset-unit floor when normalized
        # units are finer than offset units (e.g. week: 2^21 bins / 604800s)
        args = self._range_inputs(xy, t, exact_skip)
        return zranges(*args[:2], self.precision, 3, max_ranges, precision,
                       skip_mins=args[2], skip_maxs=args[3])

    def ranges_arrays(
        self,
        xy: Sequence[Tuple[float, float, float, float]],
        t: Sequence[Tuple[int, int]],
        precision: int = 64,
        max_ranges: Optional[int] = None,
        exact_skip: bool = False,
    ):
        """:meth:`ranges` as (lower[], upper[], contained[]) arrays
        (``zorder.zranges_arrays``: the C++ BFS first)."""
        args = self._range_inputs(xy, t, exact_skip)
        return zranges_arrays(*args[:2], self.precision, 3, max_ranges, precision,
                              skip_mins=args[2], skip_maxs=args[3])

    def _range_inputs(self, xy, t, exact_skip: bool):
        # one normalized unit per side guards the normalize() floor; the
        # extra margin guards the ms -> offset-unit floor when normalized
        # units are finer than offset units (e.g. week: 2^21 bins / 604800s)
        t_margin = 1 + int(np.ceil(self.time.bins / (self.time.max - self.time.min)))
        mins, maxs = [], []
        skip_mins: List[List[int]] = []
        skip_maxs: List[List[int]] = []
        for xmin, ymin, xmax, ymax in xy:
            for tmin, tmax in t:
                self._check_bounds(
                    np.asarray([xmin, xmax], dtype=np.float64),
                    np.asarray([ymin, ymax], dtype=np.float64),
                    np.asarray([tmin, tmax], dtype=np.int64),
                )
                nx0 = int(self.lon.normalize(xmin)[()])
                ny0 = int(self.lat.normalize(ymin)[()])
                nt0 = int(self.time.normalize(tmin)[()])
                nx1 = int(self.lon.normalize(xmax)[()])
                ny1 = int(self.lat.normalize(ymax)[()])
                nt1 = int(self.time.normalize(tmax)[()])
                mins.append([nx0, ny0, nt0])
                maxs.append([nx1, ny1, nt1])
                if (
                    exact_skip
                    and nx0 + 1 <= nx1 - 1
                    and ny0 + 1 <= ny1 - 1
                    and nt0 + t_margin <= nt1 - t_margin
                ):
                    skip_mins.append([nx0 + 1, ny0 + 1, nt0 + t_margin])
                    skip_maxs.append([nx1 - 1, ny1 - 1, nt1 - t_margin])
        return (
            mins,
            maxs,
            skip_mins if exact_skip else None,
            skip_maxs if exact_skip else None,
        )
