"""Filter strategies: which index can answer a filter, and at what cost.

Port of ``geomesa_tpu/index/strategy.py``: the z3, xz3, z2, xz2, id and
attribute strategies.

Rebuild of the reference's strategy extraction + cost model
(geomesa-index-api .../index/strategies/SpatioTemporalFilterStrategy.scala,
SpatialFilterStrategy.scala, AttributeFilterStrategy.scala,
IdFilterStrategy.scala and planning/StrategyDecider.scala:47-62). A
``FilterStrategy`` pairs an index with the primary (index-answerable) part of
the filter and the residual secondary filter; costs come from maintained
stats when available, else index-based heuristics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.ast import and_option
from geomesa_tpu_torch.filter.bounds import FilterValues
from geomesa_tpu_torch.index.keyspace import (
    AttributeKeySpace,
    IdKeySpace,
    IndexKeySpace,
    IndexValues,
    XZ2KeySpace,
    XZ3KeySpace,
    Z2KeySpace,
    Z3KeySpace,
)
from geomesa_tpu_torch.schema.featuretype import FeatureType

# index-based cost constants, mirroring the reference's heuristic ordering
# (id cheapest, then attribute equality, then st indices, then full scan)
_COST_ID = 1.0
_COST_ATTR_EQ = 10.0
_COST_ATTR_RANGE = 5000.0
_COST_Z3 = 200.0
_COST_XZ3 = 250.0
_COST_Z2 = 400.0
_COST_XZ2 = 450.0
_COST_FULL_SCAN = 1e9


@dataclass
class FilterStrategy:
    index: IndexKeySpace
    primary: Optional[ast.Filter]  # what the index ranges cover (None = full scan)
    secondary: Optional[ast.Filter]  # residual to post-filter
    values: IndexValues
    cost: float

    def __repr__(self):
        return (
            f"FilterStrategy({self.index.name}, primary={self.primary!r}, "
            f"secondary={self.secondary!r}, cost={self.cost})"
        )


def _all_leaves(f: ast.Filter, pred) -> bool:
    """True when every leaf under an and/or tree satisfies ``pred``."""
    if isinstance(f, (ast.And, ast.Or)):
        kids = f.children()
        return bool(kids) and all(_all_leaves(c, pred) for c in kids)
    return pred(f)


def _split_nodes(f: ast.Filter, pred) -> tuple:
    """Split a top-level AND into (matching, rest) by ``pred``.

    A child counts as matching when ALL its leaves match — so a spatial OR
    like ``bbox(a) OR bbox(b)`` is index-answerable as a whole and gets a
    primary (hence a stats estimate), matching the reference where
    extractGeometries unions OR'd spatial predicates (FilterHelper.scala:36).
    """
    if isinstance(f, ast.And):
        hits, rest = [], []
        for c in f.children():
            if _all_leaves(c, pred):
                hits.append(c)
            else:
                rest.append(c)
        return hits, rest
    if _all_leaves(f, pred):
        return [f], []
    return [], [f]


def _is_spatial(ft: FeatureType, node: ast.Filter) -> bool:
    geom = ft.default_geometry
    return (
        geom is not None
        and isinstance(node, ast.SpatialFilter)
        and node.prop == geom.name
        and not isinstance(node, ast.Disjoint)
    )


def _is_temporal(ft: FeatureType, node: ast.Filter) -> bool:
    dtg = ft.default_date
    if dtg is None:
        return False
    if isinstance(node, (ast.During, ast.Before, ast.After, ast.TEquals)):
        return node.prop == dtg.name
    if isinstance(node, (ast.Cmp, ast.Between)):
        return node.prop == dtg.name
    return False


def _is_attr(attribute: str, node: ast.Filter) -> bool:
    if isinstance(node, (ast.Cmp, ast.Between, ast.InList, ast.Like)):
        return node.prop == attribute
    return False


def get_filter_strategies(
    ft: FeatureType, indices: List[IndexKeySpace], f: ast.Filter, stats=None
) -> List[FilterStrategy]:
    """All viable (index, primary, secondary) splits for a filter.

    Mirrors GeoMesaFeatureIndex.getFilterStrategy for each index family. The
    decider picks the min-cost one: stats-estimated counts when a stats
    service is provided (CostBasedStrategyDecider, StrategyDecider.scala:
    47-62), else the index-ordering heuristics above.
    """
    out: List[FilterStrategy] = []
    for index in indices:
        fs = _strategy_for(ft, index, f)
        if fs is not None:
            out.append(fs)
    if stats is not None:
        total = stats.get_count(ft)
        for fs in out:
            if fs.primary is None or isinstance(fs.primary, ast.Exclude):
                continue
            est = stats.get_count(ft, fs.primary)
            if est is None and total is not None:
                # no estimate -> pessimistic full-scan rows, so estimated and
                # unestimated strategies stay on the same (row-count) scale
                est = total
            if est is not None:
                # + tiny index-type tiebreak so equal estimates keep the
                # heuristic preference order
                fs.cost = float(est) + fs.cost * 1e-6
    # full-scan fallback on the preferred index (reference scans the record
    # index; we scan the first available one)
    if not out and indices:
        index = indices[0]
        out.append(
            FilterStrategy(
                index=index,
                primary=None,
                secondary=None if isinstance(f, ast.Include) else f,
                values=IndexValues(geometries=FilterValues.empty()),
                cost=_COST_FULL_SCAN,
            )
        )
    return out


def _strategy_for(
    ft: FeatureType, index: IndexKeySpace, f: ast.Filter
) -> Optional[FilterStrategy]:
    values = index.get_index_values(ft, f)
    if values.disjoint:
        # provably-empty: cost 0, empty ranges -> EXCLUDE plan
        return FilterStrategy(index, ast.EXCLUDE, None, values, 0.0)

    if isinstance(index, IdKeySpace):
        if values.ids is None:
            return None
        hits, rest = _split_nodes(f, lambda n: isinstance(n, ast.IdFilter))
        return FilterStrategy(
            index,
            and_option(hits) if hits else None,
            and_option(rest) if rest else None,
            values,
            _COST_ID * max(1, len(values.ids)),
        )

    if isinstance(index, AttributeKeySpace):
        if not values.attr_bounds:
            return None
        hits, rest = _split_nodes(f, lambda n: _is_attr(index.attribute, n))
        equality = all(
            b.lower.value is not None and b.lower.value == b.upper.value
            for b in values.attr_bounds
        )
        if equality:
            cost = _COST_ATTR_EQ * max(1, len(values.attr_bounds))
        else:
            # open ranges have unknown selectivity: assume expensive until
            # stats say otherwise (AttributeFilterStrategy index-based cost)
            cost = _COST_ATTR_RANGE
        return FilterStrategy(
            index,
            and_option(hits) if hits else None,
            and_option(rest) if rest else None,
            values,
            cost,
        )

    if isinstance(index, (Z3KeySpace, XZ3KeySpace)):
        # requires a bounded interval (SpatioTemporalFilterStrategy.scala:26)
        if not values.bins:
            return None
        has_bounded = any(b.is_bounded_both for b in values.intervals.values)
        if not has_bounded:
            return None
        pred = lambda n: _is_spatial(ft, n) or _is_temporal(ft, n)
        hits, rest = _split_nodes(f, pred)
        base = _COST_Z3 if isinstance(index, Z3KeySpace) else _COST_XZ3
        cost = base * max(1, len(values.bins))
        if not values.geometries.values:
            cost *= 4  # time-only scan covers the whole world
        return FilterStrategy(
            index,
            and_option(hits) if hits else None,
            and_option(rest) if rest else None,
            values,
            cost,
        )

    if isinstance(index, (Z2KeySpace, XZ2KeySpace)):
        if not values.geometries.values:
            return None
        hits, rest = _split_nodes(f, lambda n: _is_spatial(ft, n))
        area = sum(g.envelope.area for g in values.geometries.values)
        base = _COST_Z2 if isinstance(index, Z2KeySpace) else _COST_XZ2
        cost = base * max(0.01, min(1.0, area / (360.0 * 180.0))) * 100
        return FilterStrategy(
            index,
            and_option(hits) if hits else None,
            and_option(rest) if rest else None,
            values,
            cost,
        )

    return None
