"""Z-order (Morton) bit interleaving and range decomposition.

Port of ``geomesa_tpu/curve/zorder.py``: the numpy encode/decode and the
range walk. ``zranges_arrays``, the planner's entry, runs the C++ BFS
(``geomesa_tpu_torch/native`` ``zranges.cpp``) and, when that library is
unavailable, the pure-Python walk ``zranges``, its plain edition.

The reference module replaces the external ``org.locationtech.sfcurve:sfcurve-zorder`` library
the reference delegates to (imported at Z2SFC.scala:13 / Z3SFC.scala:14; range
decomposition called as ``Z2.zranges`` / ``Z3.zranges``). The reference keeps
this in tight JVM bit-twiddling code; here the encode/decode paths are
vectorized numpy uint64 magic-mask passes, and range
decomposition is an explicit quad/oct-tree BFS with a range budget.

Layouts:
  * Z2: 2 dims x <=31 bits, x in even bit positions, y odd -> 62-bit key.
  * Z3: 3 dims x <=21 bits, x at bit 3k, y at 3k+1, t at 3k+2 -> 63-bit key.
"""

from __future__ import annotations

from collections import deque
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

_U = np.uint64


class IndexRange(NamedTuple):
    """A contiguous inclusive range of key values.

    ``contained`` is True when every key in the range satisfies the query
    (no post-filter needed), mirroring sfcurve's IndexRange flag used by the
    reference's loose-bbox decisions.
    """

    lower: int
    upper: int
    contained: bool


# ---------------------------------------------------------------------------
# 2D interleave: 31 bits/dim -> 62-bit keys
# ---------------------------------------------------------------------------

def _split2(x: np.ndarray) -> np.ndarray:
    """Spread the low 31 bits of x to even bit positions (uint64)."""
    x = x.astype(np.uint64) & _U(0x7FFFFFFF)
    x = (x ^ (x << _U(16))) & _U(0x0000FFFF0000FFFF)
    x = (x ^ (x << _U(8))) & _U(0x00FF00FF00FF00FF)
    x = (x ^ (x << _U(4))) & _U(0x0F0F0F0F0F0F0F0F)
    x = (x ^ (x << _U(2))) & _U(0x3333333333333333)
    x = (x ^ (x << _U(1))) & _U(0x5555555555555555)
    return x


def _combine2(z: np.ndarray) -> np.ndarray:
    """Gather even bit positions of z into the low 31 bits."""
    z = z.astype(np.uint64) & _U(0x5555555555555555)
    z = (z ^ (z >> _U(1))) & _U(0x3333333333333333)
    z = (z ^ (z >> _U(2))) & _U(0x0F0F0F0F0F0F0F0F)
    z = (z ^ (z >> _U(4))) & _U(0x00FF00FF00FF00FF)
    z = (z ^ (z >> _U(8))) & _U(0x0000FFFF0000FFFF)
    z = (z ^ (z >> _U(16))) & _U(0x00000000FFFFFFFF)
    return z


def z2_encode(xi, yi) -> np.ndarray:
    """Interleave two <=31-bit int arrays into a 62-bit Morton key (int64)."""
    xi = np.atleast_1d(np.asarray(xi, dtype=np.int64))
    yi = np.atleast_1d(np.asarray(yi, dtype=np.int64))
    return (_split2(xi) | (_split2(yi) << _U(1))).astype(np.int64)


def z2_decode(z) -> Tuple[np.ndarray, np.ndarray]:
    z = np.atleast_1d(np.asarray(z, dtype=np.int64)).astype(np.uint64)
    return _combine2(z).astype(np.int64), _combine2(z >> _U(1)).astype(np.int64)


# ---------------------------------------------------------------------------
# 3D interleave: 21 bits/dim -> 63-bit keys
# ---------------------------------------------------------------------------

def _split3(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x to every 3rd bit position (uint64)."""
    x = x.astype(np.uint64) & _U(0x1FFFFF)
    x = (x | (x << _U(32))) & _U(0x00001F00000000FFFF)
    x = (x | (x << _U(16))) & _U(0x001F0000FF0000FF)
    x = (x | (x << _U(8))) & _U(0x100F00F00F00F00F)
    x = (x | (x << _U(4))) & _U(0x10C30C30C30C30C3)
    x = (x | (x << _U(2))) & _U(0x1249249249249249)
    return x


def _combine3(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint64) & _U(0x1249249249249249)
    z = (z ^ (z >> _U(2))) & _U(0x10C30C30C30C30C3)
    z = (z ^ (z >> _U(4))) & _U(0x100F00F00F00F00F)
    z = (z ^ (z >> _U(8))) & _U(0x001F0000FF0000FF)
    z = (z ^ (z >> _U(16))) & _U(0x00001F00000000FFFF)
    z = (z ^ (z >> _U(32))) & _U(0x1FFFFF)
    return z


def z3_encode(xi, yi, ti) -> np.ndarray:
    """Interleave three <=21-bit int arrays into a 63-bit Morton key (int64)."""
    xi = np.atleast_1d(np.asarray(xi, dtype=np.int64))
    yi = np.atleast_1d(np.asarray(yi, dtype=np.int64))
    ti = np.atleast_1d(np.asarray(ti, dtype=np.int64))
    return (_split3(xi) | (_split3(yi) << _U(1)) | (_split3(ti) << _U(2))).astype(np.int64)


def z3_decode(z) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    z = np.atleast_1d(np.asarray(z, dtype=np.int64)).astype(np.uint64)
    return (
        _combine3(z).astype(np.int64),
        _combine3(z >> _U(1)).astype(np.int64),
        _combine3(z >> _U(2)).astype(np.int64),
    )


# ---------------------------------------------------------------------------
# Range decomposition (quad/oct-tree BFS; the sfcurve ``zranges`` analog)
# ---------------------------------------------------------------------------

def _interleave_scalar(coords: Sequence[int], dims: int) -> int:
    """Scalar interleave of per-dim ints (bit k of dim d -> z bit k*dims+d)."""
    z = 0
    for d, c in enumerate(coords):
        c = int(c)
        k = 0
        while c:
            if c & 1:
                z |= 1 << (k * dims + d)
            c >>= 1
            k += 1
    return z


def merge_ranges(ranges: List[IndexRange]) -> List[IndexRange]:
    """Sort and merge ranges. Truly overlapping ranges always coalesce
    (flag = AND); merely adjacent ones only when flags match — a contained
    (skip-eligible) run must not lose its flag to a boundary neighbor."""
    if not ranges:
        return []
    ranges = sorted(ranges, key=lambda r: (r.lower, r.upper))
    merged: List[IndexRange] = []
    cur = ranges[0]
    for r in ranges[1:]:
        if r.lower <= cur.upper or (
            r.lower == cur.upper + 1 and r.contained == cur.contained
        ):
            cur = IndexRange(
                cur.lower, max(cur.upper, r.upper), cur.contained and r.contained
            )
        else:
            merged.append(cur)
            cur = r
    merged.append(cur)
    return merged


def zranges_arrays(
    mins,
    maxs,
    bits: int,
    dims: int,
    max_ranges: Optional[int] = None,
    precision: int = 64,
    skip_mins=None,
    skip_maxs=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`zranges` as arrays (lower[] u64, upper[] u64, contained[]
    bool): the C++ BFS, or the Python walk when its library is
    unavailable."""
    from geomesa_tpu_torch.native import zranges_native

    arrays = zranges_native(
        mins, maxs, bits, dims, max_ranges, precision, skip_mins, skip_maxs
    )
    if arrays is not None:
        return arrays
    rs = zranges(mins, maxs, bits, dims, max_ranges, precision, skip_mins, skip_maxs)
    return (
        np.array([r.lower for r in rs], dtype=np.uint64),
        np.array([r.upper for r in rs], dtype=np.uint64),
        np.array([r.contained for r in rs], dtype=bool),
    )


def zranges(
    mins: Sequence[Sequence[int]],
    maxs: Sequence[Sequence[int]],
    bits: int,
    dims: int,
    max_ranges: Optional[int] = None,
    precision: int = 64,
    skip_mins: Optional[Sequence[Sequence[int]]] = None,
    skip_maxs: Optional[Sequence[Sequence[int]]] = None,
) -> List[IndexRange]:
    """Decompose axis-aligned boxes (in normalized int space) into z-ranges.

    The analog of ``Z2.zranges`` / ``Z3.zranges`` in the sfcurve library the
    reference calls from Z2SFC.scala:52-53 and Z3SFC.scala:62. Performs a
    breadth-first quad/oct-tree walk: a tree cell fully contained in some box
    emits a "contained" range covering its whole z-extent; a partially
    overlapping cell subdivides; once the range budget is met, unresolved
    cells emit loose (not-contained) ranges. Adjacent/overlapping ranges are
    merged in a final sort pass.

    Args:
      mins/maxs: per-box arrays of per-dim inclusive int bounds, shape (B, dims)
      bits: bits per dimension of the curve
      dims: 2 or 3
      max_ranges: rough budget on emitted ranges (None = unbounded, matching
        sfcurve's getOrElse(Int.MaxValue); the planner passes its
        SCAN_RANGES_TARGET of 2000, QueryProperties.scala:18)
      precision: total z bits of resolution to recurse to (64 = full depth)
      skip_mins/skip_maxs: optional INTERIOR boxes. When given, the output
        ``contained`` flag means "cell inside some skip box": every raw
        value in the cell provably satisfies the query's own (f64/ms)
        predicate, so scans skip the post-filter for that range. Recursion
        still classifies against the regular boxes. Without skip boxes the
        flag keeps the legacy cell-in-box meaning.
    """
    boxes = [
        (tuple(int(v) for v in lo), tuple(int(v) for v in hi))
        for lo, hi in zip(mins, maxs)
    ]
    if not boxes:
        return []
    skips = (
        None
        if skip_mins is None
        else [
            (tuple(int(v) for v in lo), tuple(int(v) for v in hi))
            for lo, hi in zip(skip_mins, skip_maxs)
        ]
    )

    max_level = min(bits, max(1, precision // dims))

    ranges: List[IndexRange] = []
    # queue entries: per-dim cell minimum (ints at full resolution) + level
    queue: deque = deque()
    queue.append((tuple([0] * dims), 0))

    def cell_bounds(cmin: Tuple[int, ...], level: int):
        size = 1 << (bits - level)
        return [(c, c + size - 1) for c in cmin]

    def emit(cmin: Tuple[int, ...], level: int, contained: bool):
        if contained and skips is not None:
            size = 1 << (bits - level)
            contained = any(
                all(
                    lo[d] <= cmin[d] and cmin[d] + size - 1 <= hi[d]
                    for d in range(dims)
                )
                for lo, hi in skips
            )
        zmin = _interleave_scalar(cmin, dims)
        span = 1 << (dims * (bits - level))
        ranges.append(IndexRange(zmin, zmin + span - 1, contained))

    while queue:
        cmin, level = queue.popleft()
        bounds = cell_bounds(cmin, level)
        # classify the cell against the union of boxes
        contained = False
        overlaps = False
        for lo, hi in boxes:
            if all(lo[d] <= bounds[d][0] and bounds[d][1] <= hi[d] for d in range(dims)):
                contained = True
                overlaps = True
                break
            if all(lo[d] <= bounds[d][1] and bounds[d][0] <= hi[d] for d in range(dims)):
                overlaps = True
        if not overlaps:
            continue
        if contained:
            emit(cmin, level, True)
        elif level >= max_level or (
            max_ranges is not None and len(ranges) + len(queue) >= max_ranges
        ):
            emit(cmin, level, False)
        else:
            half = 1 << (bits - level - 1)
            for corner in range(1 << dims):
                child = tuple(
                    cmin[d] + (half if (corner >> d) & 1 else 0) for d in range(dims)
                )
                queue.append((child, level + 1))

    return merge_ranges(ranges)
