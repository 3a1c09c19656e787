"""Index key spaces: pure key logic per index family.

Port of ``geomesa_tpu/index/keyspace.py``: the z3, z2, xz3, xz2, id and
attribute key spaces.

Rebuild of the reference's IndexKeySpace hierarchy (geomesa-index-api
.../index/IndexKeySpace.scala:18-62 and the z2/z3/xz2/xz3/attribute/id
implementations). Each key space knows how to (a) encode a *batch* of
features into sortable key columns (the vectorized analog of ``toIndexKey``),
(b) decompose a filter into index values (``getIndexValues``) and
(c) turn those into scan ranges (``getRanges``).

Key columns convention (consumed by geomesa_tpu_torch.store.blocks):
  * ``__bin__``  int16 time bin (z3/xz3 only)
  * ``__key__``  int64 z value / xz sequence code, or object for attr/id
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np

from geomesa_tpu_torch.curve import (
    TimePeriod,
    XZ2SFC,
    XZ3SFC,
    Z2SFC,
    Z3SFC,
    bounds_to_indexable_ms,
    max_offset,
    time_to_binned,
)
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.bounds import Bounds, FilterValues
from geomesa_tpu_torch.filter.extract import extract_geometries, extract_intervals
from geomesa_tpu_torch.geom.base import Envelope, WHOLE_WORLD
from geomesa_tpu_torch.schema.featuretype import FeatureType

# the reference's scan-range budget (QueryProperties.scala:18)
def _ranges_target(requested=None) -> int:
    """Resolve a max-ranges argument: an explicit value wins, else the
    tiered knob (QueryProperties.scala:18 'geomesa.scan.ranges.target' —
    utils.config.set_property or GEOMESA_SCAN_RANGES_TARGET), default 2000."""
    if requested is not None:
        return requested
    from geomesa_tpu_torch.utils.config import SCAN_RANGES_TARGET as prop

    return prop.to_int()


class ScanRange(NamedTuple):
    """One key range to scan. ``bin`` partitions binned indices (z3/xz3);
    non-binned indices use bin 0. ``lower``/``upper`` of None mean unbounded
    (attribute ranges); inclusivity defaults to closed ranges.

    ``tiebreak_ranges`` carries secondary z2 ranges for attribute-equality
    scans (the z-curve tiebreak of the reference's attribute keys,
    AttributeIndex.scala:43-46): rows within one attribute value are sorted
    by z2, so a spatial predicate prunes to matching z sub-spans."""

    bin: int
    lower: Any
    upper: Any
    contained: bool
    lower_inclusive: bool = True
    upper_inclusive: bool = True
    tiebreak_ranges: Optional[List[Tuple[int, int]]] = None


class RangeSet(Sequence):
    """Array-backed scan ranges for z2/z3 plans (closed-inclusive numeric
    keys, no tiebreaks): the planning/seek hot path carries four arrays
    instead of thousands of ScanRange tuples. ``__getitem__`` materializes
    a ScanRange for code that inspects ranges individually (explain,
    planner coverage checks, tests)."""

    __slots__ = ("bins", "lower", "upper", "contained")

    def __init__(self, bins, lower, upper, contained):
        self.bins = np.asarray(bins, dtype=np.int64)
        self.lower = np.asarray(lower)
        self.upper = np.asarray(upper)
        self.contained = np.asarray(contained, dtype=bool)

    def __len__(self):
        return len(self.lower)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return ScanRange(
            int(self.bins[i]),
            int(self.lower[i]),
            int(self.upper[i]),
            bool(self.contained[i]),
        )


@dataclass
class IndexValues:
    """Decomposed filter carried from planning into scans (the reference's
    Z3IndexValues / Z2IndexValues case classes)."""

    geometries: FilterValues
    intervals: Optional[FilterValues] = None
    # bin -> (offset_lo, offset_hi) inclusive windows (z3/xz3)
    bins: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    # equality/range values for attribute index; attr_precise=False means
    # the bounds over-cover (e.g. LIKE 'a%b' scans the 'a' prefix) and the
    # full filter must post-filter candidates
    attr_bounds: Optional[List[Bounds]] = None
    attr_precise: bool = True
    ids: Optional[List[str]] = None
    disjoint: bool = False

    @property
    def spatial_envelopes(self) -> List[Envelope]:
        return [g.envelope for g in self.geometries.values]


def _exact_skip_ok(values: IndexValues) -> bool:
    """Whether z-range ``contained`` flags may be computed with exact-skip
    semantics (strict-interior boxes): requires precisely-extracted
    rectangle geometries and precise intervals, so that "cell inside the
    interior" implies "row satisfies the query's own f64/ms primary
    predicate". Non-rectangles (polygon intersects) or lossy extraction
    disable the skip — flags are then forced False and every candidate is
    post-filtered, the previous behavior."""
    gv = values.geometries
    if not gv.values or not gv.precise:
        return False
    if not all(g.is_rectangle() for g in gv.values):
        return False
    iv = values.intervals
    if iv is not None and iv.values and not iv.precise:
        return False
    return True


class IndexKeySpace:
    name: str = "base"

    def supports(self, ft: FeatureType) -> bool:
        raise NotImplementedError

    def key_columns(self, ft: FeatureType, columns) -> Dict[str, np.ndarray]:
        """Encode a batch of features into key columns (vectorized
        ``toIndexKey``)."""
        raise NotImplementedError

    def get_index_values(self, ft: FeatureType, f: ast.Filter) -> IndexValues:
        raise NotImplementedError

    def get_ranges(
        self, ft: FeatureType, values: IndexValues, max_ranges: Optional[int] = None
    ) -> List[ScanRange]:
        raise NotImplementedError


def _geom_prop(ft: FeatureType) -> str:
    geom = ft.default_geometry
    if geom is None:
        raise ValueError(f"Feature type {ft.name} has no geometry")
    return geom.name


def _boxes(values: IndexValues) -> List[Tuple[float, float, float, float]]:
    """Query envelopes clipped to the world, defaulting to whole world."""
    if not values.geometries.values:
        return [WHOLE_WORLD.as_tuple()]
    out = []
    for g in values.geometries.values:
        inter = WHOLE_WORLD.intersection(g.envelope)
        if inter is not None:
            out.append(inter.as_tuple())
    return out or [WHOLE_WORLD.as_tuple()]


def _envelope_columns(geom: str, columns) -> Dict[str, np.ndarray]:
    """Per-row geometry envelope companion columns (``geom__bxmin`` ... +
    ``geom__isrect``).

    Computed once at ingest for XZ keys and STORED in the blocks: the
    vectorized bbox prescreen in filter evaluation (evaluate._eval_spatial)
    and the device executor both read them instead of re-walking the
    object geometry column. Null geometries get an empty (0,0,0,0) box.
    ``isrect`` marks features whose geometry IS its envelope rectangle —
    for rectangle queries the envelope test is then exact and the per-row
    geometry predicate is skipped (the extent-query hot path)."""
    existing = columns.get(geom + "__bxmin")
    if existing is not None:
        out = {
            geom + "__bxmin": existing,
            geom + "__bymin": columns[geom + "__bymin"],
            geom + "__bxmax": columns[geom + "__bxmax"],
            geom + "__bymax": columns[geom + "__bymax"],
        }
        isrect = columns.get(geom + "__isrect")
        if isrect is not None:
            out[geom + "__isrect"] = isrect.astype(np.uint8, copy=False)
        return out
    col = columns[geom]
    n = len(col)
    envs = np.zeros((n, 4), dtype=np.float64)
    isrect = np.zeros(n, dtype=np.uint8)
    for i, g in enumerate(col):
        if g is None:
            continue
        envs[i] = g.envelope.as_tuple()
        rect = getattr(g, "is_rectangle", None)
        if rect is not None and rect():
            isrect[i] = 1
    return {
        geom + "__bxmin": envs[:, 0],
        geom + "__bymin": envs[:, 1],
        geom + "__bxmax": envs[:, 2],
        geom + "__bymax": envs[:, 3],
        geom + "__isrect": isrect,
    }


def times_by_bin(
    intervals: FilterValues, period: TimePeriod
) -> Dict[int, Tuple[int, int]]:
    """Per-bin inclusive offset windows from ms interval bounds.

    The analog of Z3IndexKeySpace.getIndexValues' timesByBin computation
    (Z3IndexKeySpace.scala:63-119): each interval is clamped to the indexable
    domain, split at bin boundaries, with whole-period bins short-circuited
    to the full window.
    """
    mo = max_offset(period)
    out: Dict[int, Tuple[int, int]] = {}

    def add(b: int, lo: int, hi: int):
        if b in out:
            clo, chi = out[b]
            out[b] = (min(clo, lo), max(chi, hi))
        else:
            out[b] = (lo, hi)

    for bounds in intervals.values:
        lo_ms = bounds.lower.value
        hi_ms = bounds.upper.value
        # make endpoints inclusive in ms space
        if lo_ms is not None and not bounds.lower.inclusive:
            lo_ms += 1
        if hi_ms is not None and not bounds.upper.inclusive:
            hi_ms -= 1
        lo_ms, hi_ms = bounds_to_indexable_ms(lo_ms, hi_ms, period)
        if lo_ms > hi_ms:
            continue
        (blo,), (olo,) = time_to_binned(lo_ms, period)
        (bhi,), (ohi,) = time_to_binned(hi_ms, period)
        blo, bhi = int(blo), int(bhi)
        if blo == bhi:
            add(blo, int(olo), int(ohi))
        else:
            add(blo, int(olo), mo)
            for b in range(blo + 1, bhi):
                add(b, 0, mo)
            add(bhi, 0, int(ohi))
    return out


def _group_arrays(sfc, boxes, window, per_group, skip):
    """(lower[], upper[], contained[]) for one decomposition group (the
    C++ BFS when its library is available). ``window`` None = 2D (Z2)."""
    targs = () if window is None else ([window],)
    return sfc.ranges_arrays(boxes, *targs, max_ranges=per_group, exact_skip=skip)


class Z3KeySpace(IndexKeySpace):
    """Point + time index: key = (2-byte bin, 63-bit z3)
    (Z3IndexKeySpace.scala, indexKeyLength=10)."""

    name = "z3"

    def supports(self, ft: FeatureType) -> bool:
        return ft.is_points and ft.default_date is not None

    def sfc(self, ft: FeatureType) -> Z3SFC:
        return Z3SFC.for_period(ft.z3_interval)

    def key_columns(self, ft: FeatureType, columns) -> Dict[str, np.ndarray]:
        geom = _geom_prop(ft)
        dtg = ft.default_date.name
        x = columns[geom + "__x"]
        y = columns[geom + "__y"]
        t = columns[dtg]
        bins, offsets = time_to_binned(t, ft.z3_interval, lenient=True)
        z = self.sfc(ft).index(x, y, offsets, lenient=True)
        return {"__bin__": bins, "__key__": z}

    def get_index_values(self, ft: FeatureType, f: ast.Filter) -> IndexValues:
        geom = _geom_prop(ft)
        dtg = ft.default_date.name
        geoms = extract_geometries(f, geom)
        intervals = extract_intervals(f, dtg, handle_exclusive_bounds=True)
        if geoms.disjoint or intervals.disjoint:
            return IndexValues(geoms, intervals, disjoint=True)
        bins = times_by_bin(intervals, ft.z3_interval) if intervals.values else {}
        if not intervals.values:
            # unbounded time: every bin through the max date (the reference
            # requires an interval for z3 to be chosen; guard anyway)
            bins = {}
        return IndexValues(geoms, intervals, bins=bins)

    def get_ranges(
        self, ft: FeatureType, values: IndexValues, max_ranges: Optional[int] = None
    ) -> "Union[RangeSet, List[ScanRange]]":
        if values.disjoint:
            return []
        sfc = self.sfc(ft)
        boxes = _boxes(values)
        mo = max_offset(ft.z3_interval)
        # whole-period bins share one decomposition (Z3IndexKeySpace.scala:129-135)
        whole = [b for b, w in values.bins.items() if w == (0, mo)]
        partial = {b: w for b, w in values.bins.items() if w != (0, mo)}
        n_groups = (1 if whole else 0) + len(partial)
        per_group = max(1, _ranges_target(max_ranges) // max(1, n_groups))
        skip = _exact_skip_ok(values)
        # one decomposition per group -> a single RangeSet
        parts = []
        if whole:
            lo_a, hi_a, cont_a = _group_arrays(sfc, boxes, (0, mo), per_group, skip)
            for b in sorted(whole):
                parts.append((np.full(len(lo_a), b, dtype=np.int64), lo_a, hi_a, cont_a))
        for b, (lo, hi) in sorted(partial.items()):
            lo_a, hi_a, cont_a = _group_arrays(sfc, boxes, (lo, hi), per_group, skip)
            parts.append((np.full(len(lo_a), b, dtype=np.int64), lo_a, hi_a, cont_a))
        if not parts:
            return []
        bins_c = np.concatenate([p[0] for p in parts])
        lo_c = np.concatenate([p[1] for p in parts])
        hi_c = np.concatenate([p[2] for p in parts])
        cont_c = np.concatenate([p[3] for p in parts])
        return RangeSet(
            bins_c, lo_c, hi_c, cont_c if skip else np.zeros(len(lo_c), bool)
        )


class Z2KeySpace(IndexKeySpace):
    """Point spatial index: key = 62-bit z2 (Z2IndexKeySpace.scala:28-104)."""

    name = "z2"

    def __init__(self):
        self._sfc = Z2SFC()

    def sfc(self, ft: FeatureType) -> Z2SFC:
        return self._sfc

    def supports(self, ft: FeatureType) -> bool:
        return ft.is_points

    def key_columns(self, ft: FeatureType, columns) -> Dict[str, np.ndarray]:
        geom = _geom_prop(ft)
        z = self._sfc.index(columns[geom + "__x"], columns[geom + "__y"], lenient=True)
        return {"__key__": z}

    def get_index_values(self, ft: FeatureType, f: ast.Filter) -> IndexValues:
        geoms = extract_geometries(f, _geom_prop(ft))
        return IndexValues(geoms, disjoint=geoms.disjoint)

    def get_ranges(
        self, ft: FeatureType, values: IndexValues, max_ranges: Optional[int] = None
    ) -> "Union[RangeSet, List[ScanRange]]":
        if values.disjoint:
            return []
        skip = _exact_skip_ok(values)
        lo_a, hi_a, cont_a = _group_arrays(
            self._sfc, _boxes(values), None, _ranges_target(max_ranges), skip
        )
        return RangeSet(
            np.zeros(len(lo_a), dtype=np.int64),
            lo_a,
            hi_a,
            cont_a if skip else np.zeros(len(lo_a), bool),
        )


class XZ2KeySpace(IndexKeySpace):
    """Extent spatial index: key = XZ2 sequence code
    (XZ2IndexKeySpace.scala:26+). Always requires a geometry post-filter."""

    name = "xz2"

    def supports(self, ft: FeatureType) -> bool:
        geom = ft.default_geometry
        return geom is not None and not ft.is_points

    def sfc(self, ft: FeatureType) -> XZ2SFC:
        return XZ2SFC.for_g(ft.xz_precision)

    def key_columns(self, ft: FeatureType, columns) -> Dict[str, np.ndarray]:
        geom = _geom_prop(ft)
        envs = _envelope_columns(geom, columns)
        keys = self.sfc(ft).index(
            envs[geom + "__bxmin"],
            envs[geom + "__bymin"],
            envs[geom + "__bxmax"],
            envs[geom + "__bymax"],
            lenient=True,
        )
        return {"__key__": keys, **envs}

    def get_index_values(self, ft: FeatureType, f: ast.Filter) -> IndexValues:
        geoms = extract_geometries(f, _geom_prop(ft))
        return IndexValues(geoms, disjoint=geoms.disjoint)

    def get_ranges(
        self, ft: FeatureType, values: IndexValues, max_ranges: Optional[int] = None
    ) -> List[ScanRange]:
        if values.disjoint:
            return []
        ranges = self.sfc(ft).ranges(_boxes(values), max_ranges=_ranges_target(max_ranges))
        # contained forced False: XZ rows are extent features, whose geometry
        # predicate can never be skipped from key containment alone
        return [ScanRange(0, r.lower, r.upper, False) for r in ranges]


class XZ3KeySpace(IndexKeySpace):
    """Extent + time index (XZ3IndexKeySpace.scala:29+): key = (bin, xz3)."""

    name = "xz3"

    def supports(self, ft: FeatureType) -> bool:
        geom = ft.default_geometry
        return geom is not None and not ft.is_points and ft.default_date is not None

    def sfc(self, ft: FeatureType) -> XZ3SFC:
        return XZ3SFC.for_period(ft.xz_precision, ft.xz3_interval)

    def key_columns(self, ft: FeatureType, columns) -> Dict[str, np.ndarray]:
        geom = _geom_prop(ft)
        dtg = ft.default_date.name
        envs = _envelope_columns(geom, columns)
        bins, offsets = time_to_binned(columns[dtg], ft.xz3_interval, lenient=True)
        off = offsets.astype(np.float64)
        keys = self.sfc(ft).index(
            envs[geom + "__bxmin"],
            envs[geom + "__bymin"],
            off,
            envs[geom + "__bxmax"],
            envs[geom + "__bymax"],
            off,
            lenient=True,
        )
        return {"__bin__": bins, "__key__": keys, **envs}

    def get_index_values(self, ft: FeatureType, f: ast.Filter) -> IndexValues:
        geom = _geom_prop(ft)
        dtg = ft.default_date.name
        geoms = extract_geometries(f, geom)
        intervals = extract_intervals(f, dtg, handle_exclusive_bounds=True)
        if geoms.disjoint or intervals.disjoint:
            return IndexValues(geoms, intervals, disjoint=True)
        bins = times_by_bin(intervals, ft.xz3_interval) if intervals.values else {}
        return IndexValues(geoms, intervals, bins=bins)

    def get_ranges(
        self, ft: FeatureType, values: IndexValues, max_ranges: Optional[int] = None
    ) -> List[ScanRange]:
        if values.disjoint:
            return []
        sfc = self.sfc(ft)
        boxes = _boxes(values)
        mo = max_offset(ft.xz3_interval)
        out: List[ScanRange] = []
        whole = [b for b, w in values.bins.items() if w == (0, mo)]
        partial = {b: w for b, w in values.bins.items() if w != (0, mo)}
        n_groups = (1 if whole else 0) + len(partial)
        per_group = max(1, _ranges_target(max_ranges) // max(1, n_groups))
        # contained is forced False: XZ rows are extent features, whose
        # geometry predicate can never be skipped from key containment alone
        if whole:
            queries = [(x0, y0, 0.0, x1, y1, float(mo)) for x0, y0, x1, y1 in boxes]
            ranges = sfc.ranges(queries, max_ranges=per_group)
            for b in sorted(whole):
                out.extend(ScanRange(b, r.lower, r.upper, False) for r in ranges)
        for b, (lo, hi) in sorted(partial.items()):
            queries = [
                (x0, y0, float(lo), x1, y1, float(hi)) for x0, y0, x1, y1 in boxes
            ]
            ranges = sfc.ranges(queries, max_ranges=per_group)
            out.extend(ScanRange(b, r.lower, r.upper, False) for r in ranges)
        return out


class IdKeySpace(IndexKeySpace):
    """Feature-id index (IdIndex, index/IdIndex.scala:24).

    Keys are the fids as ASCII BYTES (numpy 'S' via the C-speed U->S
    astype, which is ASCII-only): byte value equals code point, so
    lexicographic scans are unchanged, while sorting moves 4x less data
    than UCS-4 unicode and compares with memcmp — the id table is pure
    (key, rowid) so this is its whole cost. Batches with any non-ASCII
    fid keep unicode keys (the scan handles both; a block's key dtype
    says which). Scan-range bounds encode the same way at seek time
    (FeatureBlock._slice_intervals)."""

    name = "id"

    def supports(self, ft: FeatureType) -> bool:
        return True

    def key_columns(self, ft: FeatureType, columns) -> Dict[str, np.ndarray]:
        fid = columns["__fid__"]
        if fid.dtype.kind == "U":
            try:
                return {"__key__": fid.astype("S")}
            except UnicodeEncodeError:
                pass  # non-latin-1 fids: unicode keys
        return {"__key__": fid}

    def get_index_values(self, ft: FeatureType, f: ast.Filter) -> IndexValues:
        ids: List[str] = []
        found = _extract_ids(f, ids)
        return IndexValues(
            FilterValues.empty(), ids=sorted(set(ids)) if found else None
        )

    def get_ranges(
        self, ft: FeatureType, values: IndexValues, max_ranges: Optional[int] = None
    ) -> List[ScanRange]:
        if values.ids is None:
            return []
        return [ScanRange(0, i, i, True) for i in values.ids]


def _extract_ids(f: ast.Filter, out: List[str]) -> bool:
    """Collect ids when the filter is satisfiable only by listed ids."""
    if isinstance(f, ast.IdFilter):
        out.extend(f.ids)
        return True
    if isinstance(f, ast.And):
        return any(_extract_ids(c, out) for c in f.children())
    if isinstance(f, ast.Or):
        return all(_extract_ids(c, out) for c in f.children())
    return False


class AttributeKeySpace(IndexKeySpace):
    """Attribute value index with lexicographic ordering
    (AttributeIndex.scala:43-46; value lexicoding via Mango LexiTypeEncoders
    in the reference -- here native value ordering on sorted columns)."""

    name = "attr"

    def __init__(self, attribute: str):
        self.attribute = attribute
        self.name = f"attr:{attribute}"

    def supports(self, ft: FeatureType) -> bool:
        return ft.has(self.attribute) and ft.attr(self.attribute).indexed

    # z2 tiebreak decomposition budget: each range costs one searchsorted
    # pair per equality span at scan time
    TIEBREAK_MAX_RANGES = 32

    def key_columns(self, ft: FeatureType, columns) -> Dict[str, np.ndarray]:
        col = columns[self.attribute]
        # null attribute values are not indexed (the reference skips writing
        # attribute-index rows for null values)
        vocab = columns.get(self.attribute + "__vocab")
        if vocab is not None:
            valid = col >= 0  # dictionary codes: -1 is the null sentinel
        elif col.dtype == object:
            valid = np.array([v is not None for v in col], dtype=bool)
        elif col.dtype.kind == "f":
            valid = ~np.isnan(col)
        else:
            nulls = columns.get(self.attribute + "__null")
            valid = ~nulls if nulls is not None else np.ones(len(col), dtype=bool)
        out = {"__key__": col, "__valid__": valid}
        if vocab is not None:
            # sorted per-batch vocab rides with the block (NOT row-aligned):
            # scan ranges arrive with VALUE bounds and map to code space
            # per block (FeatureBlock._to_code_ranges)
            out["__key_vocab__"] = vocab
        geom = ft.default_geometry
        if geom is not None and ft.is_points:
            # secondary sort by z2 within each attribute value
            # (AttributeIndex.scala:43-46 z-curve tiebreak)
            x = columns[geom.name + "__x"]
            y = columns[geom.name + "__y"]
            ok = ~(np.isnan(x) | np.isnan(y))
            tb = np.full(len(col), -1, dtype=np.int64)
            if ok.any():
                tb[ok] = Z2SFC().index(x[ok], y[ok], lenient=True)
            out["__tiebreak__"] = tb
        return out

    def get_index_values(self, ft: FeatureType, f: ast.Filter) -> IndexValues:
        bounds = _extract_attr_bounds(f, self.attribute, ft)
        geoms = FilterValues.empty()
        if ft.default_geometry is not None and ft.is_points:
            geoms = extract_geometries(f, ft.default_geometry.name)
        return IndexValues(
            geoms,
            attr_bounds=bounds.values if bounds.values else None,
            attr_precise=bounds.precise,
            disjoint=bounds.disjoint or geoms.disjoint,
        )

    def get_ranges(
        self, ft: FeatureType, values: IndexValues, max_ranges: Optional[int] = None
    ) -> List[ScanRange]:
        if values.disjoint or not values.attr_bounds:
            return []
        # one z2 decomposition shared by every equality span: prune within
        # a value's rows to z sub-spans when the query is ALSO spatial.
        # Only equality spans are z-sorted, so skip the decomposition when
        # no bound can use it.
        tiebreaks: Optional[List[Tuple[int, int]]] = None
        any_equality = any(
            b.lower.value is not None and b.lower.value == b.upper.value
            for b in values.attr_bounds
        )
        if values.geometries.values and any_equality:
            zr = Z2SFC().ranges(
                _boxes(values), max_ranges=self.TIEBREAK_MAX_RANGES
            )
            tiebreaks = [(int(r.lower), int(r.upper)) for r in zr]
        out = []
        for b in values.attr_bounds:
            equality = b.lower.value is not None and b.lower.value == b.upper.value
            out.append(
                ScanRange(
                    0,
                    b.lower.value,
                    b.upper.value,
                    # exact in value space only when the bounds are precise
                    # (LIKE-prefix ranges over-cover and must post-filter)
                    values.attr_precise,
                    b.lower.inclusive,
                    b.upper.inclusive,
                    tiebreaks if equality else None,
                )
            )
        return out


def _extract_attr_bounds(f: ast.Filter, attribute: str, ft: FeatureType) -> FilterValues:
    """Value bounds for the attribute index: equality, ranges, IN lists,
    LIKE prefixes (AttributeFilterStrategy semantics)."""
    from geomesa_tpu_torch.filter.bounds import Bound
    from geomesa_tpu_torch.filter.evaluate import _coerce

    if isinstance(f, ast.And):
        current: Optional[List[Bounds]] = None
        precise = True
        for c in f.children():
            child = _extract_attr_bounds(c, attribute, ft)
            if child.disjoint:
                return FilterValues.disjoint_values()
            if child.is_empty:
                continue
            precise = precise and child.precise
            if current is None:
                current = child.values
            else:
                nxt = []
                for a in current:
                    for b in child.values:
                        inter = a.intersection(b)
                        if inter is not None:
                            nxt.append(inter)
                if not nxt:
                    return FilterValues.disjoint_values()
                current = nxt
        return FilterValues(current or [], precise=precise)
    if isinstance(f, ast.Or):
        out: List[Bounds] = []
        precise = True
        for c in f.children():
            child = _extract_attr_bounds(c, attribute, ft)
            if child.is_empty and not child.disjoint:
                return FilterValues.empty()
            precise = precise and child.precise
            out.extend(child.values)
        return FilterValues(out, precise=precise) if out else FilterValues.empty()
    if isinstance(f, ast.Cmp) and f.prop == attribute:
        v = _coerce(ft, attribute, f.literal)
        if f.op == "=":
            return FilterValues([Bounds(Bound(v, True), Bound(v, True))])
        if f.op == "<":
            return FilterValues([Bounds(Bound(None, True), Bound(v, False))])
        if f.op == "<=":
            return FilterValues([Bounds(Bound(None, True), Bound(v, True))])
        if f.op == ">":
            return FilterValues([Bounds(Bound(v, False), Bound(None, True))])
        if f.op == ">=":
            return FilterValues([Bounds(Bound(v, True), Bound(None, True))])
        return FilterValues.empty()
    if isinstance(f, ast.Between) and f.prop == attribute:
        from geomesa_tpu_torch.filter.bounds import Bound

        lo = _coerce(ft, attribute, f.lo)
        hi = _coerce(ft, attribute, f.hi)
        return FilterValues([Bounds(Bound(lo, True), Bound(hi, True))])
    if isinstance(f, ast.InList) and f.prop == attribute:
        from geomesa_tpu_torch.filter.bounds import Bound

        out = []
        for v in f.values:
            cv = _coerce(ft, attribute, v)
            out.append(Bounds(Bound(cv, True), Bound(cv, True)))
        return FilterValues(out)
    if isinstance(f, ast.Like) and f.prop == attribute and not f.case_insensitive:
        from geomesa_tpu_torch.filter.bounds import Bound

        # prefix scans: 'abc%' -> [abc, abd)
        pat = f.pattern
        prefix = pat.split("%")[0].split("_")[0]
        if prefix and pat.startswith(prefix):
            hi = prefix[:-1] + chr(ord(prefix[-1]) + 1)
            return FilterValues(
                [Bounds(Bound(prefix, True), Bound(hi, False))], precise=False
            )
        return FilterValues.empty()
    return FilterValues.empty()


ALL_INDICES = ("z3", "z2", "xz3", "xz2", "id", "attr")


def default_indices(ft: FeatureType) -> List[IndexKeySpace]:
    """The indices enabled for a schema: explicit ``geomesa.indices`` user
    data, else defaults per geometry/date availability (the reference's
    GeoMesaIndexManager.setIndices)."""
    enabled = ft.enabled_indices
    out: List[IndexKeySpace] = []
    candidates: List[IndexKeySpace] = [
        Z3KeySpace(),
        XZ3KeySpace(),
        Z2KeySpace(),
        XZ2KeySpace(),
        IdKeySpace(),
    ]
    for a in ft.attributes:
        if a.indexed and not a.type.is_geometry:
            candidates.append(AttributeKeySpace(a.name))
    for ks in candidates:
        base = ks.name.split(":")[0]
        if enabled is not None and base not in enabled:
            continue
        if ks.supports(ft):
            out.append(ks)
    return out
