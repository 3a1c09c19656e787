"""Curve math: z2/z3 and xz2/xz3 space-filling curves and time binning.

Port of ``geomesa_tpu/curve``.
"""

from geomesa_tpu_torch.curve.binnedtime import (
    BinnedTime,
    EPOCH_MS,
    TimePeriod,
    binned_to_time,
    bounds_to_indexable_ms,
    max_date_ms,
    max_offset,
    time_to_binned,
)
from geomesa_tpu_torch.curve.normalized import (
    NormalizedLat,
    NormalizedLon,
    NormalizedTime,
)
from geomesa_tpu_torch.curve.sfc import Z2SFC, Z3SFC
from geomesa_tpu_torch.curve.xz import XZ2SFC, XZ3SFC, XZ_DEFAULT_G
from geomesa_tpu_torch.curve.zorder import (
    IndexRange,
    z2_decode,
    z2_encode,
    z3_decode,
    z3_encode,
    zranges,
)

__all__ = [
    "BinnedTime",
    "EPOCH_MS",
    "IndexRange",
    "NormalizedLat",
    "NormalizedLon",
    "NormalizedTime",
    "TimePeriod",
    "XZ2SFC",
    "XZ3SFC",
    "XZ_DEFAULT_G",
    "Z2SFC",
    "Z3SFC",
    "binned_to_time",
    "bounds_to_indexable_ms",
    "max_date_ms",
    "max_offset",
    "time_to_binned",
    "z2_decode",
    "z2_encode",
    "z3_decode",
    "z3_encode",
    "zranges",
]
