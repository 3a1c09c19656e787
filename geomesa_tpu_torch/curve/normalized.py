"""Dimension normalization: map doubles in a known range to ints in [0, 2^bits).

Port of ``geomesa_tpu/curve/normalized.py``.

Semantics match the reference exactly (geomesa-z3 .../curve/NormalizedDimension.scala:57-97):

  * ``normalize(x) = maxIndex          if x >= max
                     floor((x - min) * bins / (max - min))  otherwise``
  * ``denormalize(i) = min + (min(i, maxIndex) + 0.5) * (max - min) / bins``  (bin centers)

All operations are vectorized over numpy arrays (float64 in, int64 out) so that
ingest-time key encoding is a single fused pass; IEEE-754 double math reproduces
the JVM's results bit-for-bit.
"""

from __future__ import annotations

import numpy as np


class BitNormalizedDimension:
    """Maps doubles in [min, max] to ints in [0, 2^precision).

    Reference: NormalizedDimension.scala:57-76 (BitNormalizedDimension).
    """

    def __init__(self, lo: float, hi: float, precision: int):
        if not (0 < precision < 32):
            raise ValueError("Precision (bits) must be in [1,31]")
        self.min = float(lo)
        self.max = float(hi)
        self.precision = precision
        self.bins = 1 << precision
        self._normalizer = self.bins / (self.max - self.min)
        self._denormalizer = (self.max - self.min) / self.bins
        self.max_index = self.bins - 1

    def normalize(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        scaled = np.floor((x - self.min) * self._normalizer)
        out = np.where(x >= self.max, float(self.max_index), scaled)
        # Non-finite / out-of-range inputs must cast DETERMINISTICALLY:
        # float->int64 casting of NaN/inf/overflow is implementation-
        # defined (INT64_MIN on x86, 0 on ARM), and covered-range
        # exact-skip soundness requires garbage rows to never land inside
        # a strict-interior skip box. NaN (null geometries under lenient
        # encoding) and -inf map to cell 0 (domain edge, always excluded
        # from skip boxes); +inf is already clamped by x >= max; huge
        # finite out-of-domain values saturate like the JVM's d.toLong.
        out = np.where(np.isnan(out), 0.0, out)
        out = np.clip(out, float(-(2**63)), float(2**63 - 2**10))
        return out.astype(np.int64)

    def denormalize(self, i) -> np.ndarray:
        i = np.asarray(i, dtype=np.int64)
        clamped = np.minimum(i, self.max_index).astype(np.float64)
        return self.min + (clamped + 0.5) * self._denormalizer

    def __eq__(self, other):
        return (
            isinstance(other, BitNormalizedDimension)
            and (self.min, self.max, self.precision) == (other.min, other.max, other.precision)
        )

    def __hash__(self):
        return hash((self.min, self.max, self.precision))

    def __repr__(self):
        return f"{type(self).__name__}({self.min}, {self.max}, bits={self.precision})"


class NormalizedLat(BitNormalizedDimension):
    """Latitude in [-90, 90] (NormalizedDimension.scala:78)."""

    def __init__(self, precision: int):
        super().__init__(-90.0, 90.0, precision)


class NormalizedLon(BitNormalizedDimension):
    """Longitude in [-180, 180] (NormalizedDimension.scala:80)."""

    def __init__(self, precision: int):
        super().__init__(-180.0, 180.0, precision)


class NormalizedTime(BitNormalizedDimension):
    """Time offset in [0, max] (NormalizedDimension.scala:82)."""

    def __init__(self, precision: int, hi: float):
        super().__init__(0.0, hi, precision)


class SemiNormalizedDimension:
    """Legacy ceil-based normalization, kept to read pre-1.3 index data.

    Reference: NormalizedDimension.scala:87-97 (SemiNormalizedDimension);
    it does not bin the lower bound correctly, as in the reference.
    """

    def __init__(self, lo: float, hi: float, precision: int):
        self.min = float(lo)
        self.max = float(hi)
        self.precision = precision
        self.max_index = precision

    def normalize(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        return np.ceil((x - self.min) / (self.max - self.min) * self.precision).astype(np.int64)

    def denormalize(self, i) -> np.ndarray:
        i = np.asarray(i, dtype=np.int64)
        out = (i.astype(np.float64) - 0.5) * (self.max - self.min) / self.precision + self.min
        return np.where(i == 0, self.min, out)


class SemiNormalizedLat(SemiNormalizedDimension):
    def __init__(self, precision: int):
        super().__init__(-90.0, 90.0, precision)


class SemiNormalizedLon(SemiNormalizedDimension):
    def __init__(self, precision: int):
        super().__init__(-180.0, 180.0, precision)


class SemiNormalizedTime(SemiNormalizedDimension):
    def __init__(self, precision: int, hi: float):
        super().__init__(0.0, hi, precision)
