"""Legacy semi-normalized SFC variants for reading pre-1.3 index data.

Port of ``geomesa_tpu/curve/legacy.py``. Reference:
curve/LegacyZ2SFC.scala:14-25 / LegacyZ3SFC.scala: the same bit
interleave with ceil-based SemiNormalized dimensions
(NormalizedDimension.scala:87-97), kept so that old persisted keys decode.
New keys never use these.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from geomesa_tpu_torch.curve import binnedtime
from geomesa_tpu_torch.curve.binnedtime import TimePeriod
from geomesa_tpu_torch.curve.normalized import (
    SemiNormalizedLat,
    SemiNormalizedLon,
    SemiNormalizedTime,
)
from geomesa_tpu_torch.curve.zorder import z2_decode, z2_encode, z3_decode, z3_encode


class LegacyZ2SFC:
    """31-bit semi-normalized 2D curve (LegacyZ2SFC.scala:14-25)."""

    def __init__(self):
        prec = (1 << 31) - 1
        self.lon = SemiNormalizedLon(prec)
        self.lat = SemiNormalizedLat(prec)

    def index(self, x, y) -> np.ndarray:
        return z2_encode(self.lon.normalize(x), self.lat.normalize(y))

    def invert(self, z) -> Tuple[np.ndarray, np.ndarray]:
        xi, yi = z2_decode(z)
        return self.lon.denormalize(xi), self.lat.denormalize(yi)


class LegacyZ3SFC:
    """21-bit semi-normalized 3D curve (LegacyZ3SFC.scala)."""

    _cache: Dict[TimePeriod, "LegacyZ3SFC"] = {}

    def __init__(self, period):
        prec = (1 << 21) - 1
        self.period = TimePeriod.parse(period)
        self.lon = SemiNormalizedLon(prec)
        self.lat = SemiNormalizedLat(prec)
        self.time = SemiNormalizedTime(prec, float(binnedtime.max_offset(self.period)))

    @classmethod
    def for_period(cls, period) -> "LegacyZ3SFC":
        period = TimePeriod.parse(period)
        if period not in cls._cache:
            cls._cache[period] = cls(period)
        return cls._cache[period]

    def index(self, x, y, t) -> np.ndarray:
        return z3_encode(self.lon.normalize(x), self.lat.normalize(y), self.time.normalize(t))

    def invert(self, z) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        xi, yi, ti = z3_decode(z)
        return self.lon.denormalize(xi), self.lat.denormalize(yi), self.time.denormalize(ti)
