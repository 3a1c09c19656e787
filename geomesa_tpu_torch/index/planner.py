"""Query planning: hints, strategy choice, plan assembly, explain traces.

Port of ``geomesa_tpu/index/planner.py``.

Rebuild of the reference's QueryPlanner/QueryRunner/StrategyDecider
(geomesa-index-api .../planning/QueryPlanner.scala:43-286,
StrategyDecider.scala:47-144) with the Explainer's indented trace
(.../utils/Explainer.scala:16).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.parser import parse_cql, to_cql
from geomesa_tpu_torch.filter.rewrite import simplify
from geomesa_tpu_torch.index.keyspace import (
    IndexKeySpace,
    IndexValues,
    ScanRange,
)
from geomesa_tpu_torch.index.strategy import get_filter_strategies
from geomesa_tpu_torch.schema.featuretype import FeatureType


class Explainer:
    """Indented plan trace (Explainer.scala:16-40)."""

    def __init__(self, sink: Optional[Callable[[str], None]] = None):
        self._lines: List[str] = []
        self._depth = 0
        self._sink = sink

    def __call__(self, msg: str) -> "Explainer":
        line = "  " * self._depth + msg
        self._lines.append(line)
        if self._sink:
            self._sink(line)
        return self

    def push(self, msg: Optional[str] = None) -> "Explainer":
        if msg:
            self(msg)
        self._depth += 1
        return self

    def pop(self) -> "Explainer":
        self._depth = max(0, self._depth - 1)
        return self

    @property
    def output(self) -> str:
        return "\n".join(self._lines)


@dataclass
class Query:
    """A query: CQL filter + hints (the reference's GeoTools Query + Hints).

    Supported hints mirror conf/QueryHints.scala: projection/transforms,
    sort, max_features, sampling, loose_bbox, plus aggregation hints
    (density/stats/bin/arrow) consumed by the datastore executors.
    """

    filter: ast.Filter = field(default_factory=lambda: ast.INCLUDE)
    properties: Optional[List[str]] = None  # projection; None = all
    sort_by: Optional[List[tuple]] = None  # [(attr, ascending)]
    max_features: Optional[int] = None
    hints: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def cql(cls, text: str, **kwargs) -> "Query":
        return cls(filter=parse_cql(text), **kwargs)


@dataclass
class QueryPlan:
    """An executable plan (the reference's QueryPlan.scala:27)."""

    ft: FeatureType
    index: IndexKeySpace
    ranges: List[ScanRange]
    values: IndexValues
    # the filter the scan ranges already guarantee (loose cover)
    primary: Optional[ast.Filter]
    # residual filter that must run post-scan
    secondary: Optional[ast.Filter]
    # the exact full filter (for result parity the executor may choose to
    # evaluate this instead of primary/secondary split)
    full_filter: Optional[ast.Filter]
    cost: float
    explain: str = ""
    # cross-index OR split (FilterSplitter.scala:64-110): when set, the
    # executor scans each arm plan independently and unions by fid; the
    # top-level index/ranges fields are informational only
    union: Optional[List["QueryPlan"]] = None

    @property
    def is_empty(self) -> bool:
        return isinstance(self.primary, ast.Exclude)

    @property
    def post_filter(self) -> Optional[ast.Filter]:
        """What the executor must still evaluate. Contained-only range sets
        with a precise extraction could skip the primary; we stay exact by
        keeping the full filter unless ranges are fully covering."""
        return self.full_filter


def spatial_only_shape(plan: QueryPlan, ft: FeatureType):
    """The query's geometry list when ``plan`` can be answered from the z2
    aggregate pyramid (``ops/pyramid.py``), else None.

    The interior/boundary fusion is sound exactly when the plan is one z2
    arm (no cross-index union) with no residual, the filter reads the
    default geometry alone (a date or attribute predicate would make an
    interior row's truth depend on a column the pyramid never summed), the
    geometry extraction is precise, and every spatial leaf is
    containment-shaped (BBOX, INTERSECTS, WITHIN: true for every point row
    of a strictly interior cell). CONTAINS inverts the operands, DISJOINT
    negates and DWITHIN reaches past the literal's shape: their covers
    describe candidate ranges, not the predicate, so they decline."""
    if plan.union is not None or plan.is_empty:
        return None
    if plan.index.name != "z2" or plan.secondary is not None:
        return None
    geom = ft.default_geometry
    if geom is None:
        return None
    gv = plan.values.geometries
    if gv is None or not gv.values or not gv.precise:
        return None
    if plan.full_filter is None:
        return None
    if set(ast.properties(plan.full_filter)) != {geom.name}:
        return None
    for node in ast.walk(plan.full_filter):
        if isinstance(node, (ast.And, ast.Or)):
            continue
        if not isinstance(node, (ast.BBox, ast.Intersects, ast.Within)):
            return None
    return list(gv.values)


def pyramid_worthwhile(interior_rows: int, boundary_rows: int) -> bool:
    """The pyramid's cost model: answer from it only when the interior sums
    carry weight. The boundary ring is scanned either way, so a query whose
    candidates are mostly boundary gains nothing over the ordinary paths;
    a ring of at most 256 rows is a trivial seek whatever the ratio."""
    if interior_rows <= 0:
        return False
    return boundary_rows <= 4 * interior_rows or boundary_rows <= 256


class QueryPlanner:
    """Plans queries for one feature type over its enabled indices."""

    def __init__(self, ft: FeatureType, indices: Sequence[IndexKeySpace], stats=None):
        self.ft = ft
        self.indices = list(indices)
        self.stats = stats

    def plan(
        self,
        query: Query,
        explain: Optional[Explainer] = None,
        max_ranges: Optional[int] = None,
    ) -> QueryPlan:
        from geomesa_tpu_torch.index.keyspace import _ranges_target

        # tiered knob: geomesa.scan.ranges.target (QueryProperties.scala:18)
        max_ranges = _ranges_target(max_ranges)
        explain = explain or Explainer()
        f = simplify(query.filter)
        return self._plan_or(f, explain, max_ranges)

    def _plan_or(
        self,
        f: ast.Filter,
        explain: Explainer,
        max_ranges: Optional[int] = None,
    ) -> QueryPlan:
        single = self._plan_single(f, explain, max_ranges)
        if not isinstance(f, ast.Or):
            return single
        # Cross-index OR split (planning/FilterSplitter.scala:64-110): plan
        # each top-level OR arm on its own best index; if the summed cost
        # beats the single-strategy plan, scan the arms independently and
        # union by fid (the reference instead rewrites arms disjoint,
        # makeDisjoint :303 — fid dedup is exact and cheaper host-side).
        # fixed per-arm scan overhead: each arm is a full extra scan setup
        # (+ fid dedup), so a union must win by a real margin — otherwise a
        # homogeneous OR (e.g. two bboxes) stays on the cheaper multi-box
        # single-index plan the extractors already produce
        ARM_OVERHEAD = 100.0
        children = [simplify(c) for c in f.children()]
        # cost the arms from strategies alone first; range decomposition
        # only runs for arms of a union that actually wins
        total = 0.0
        for child in children:
            opts = get_filter_strategies(self.ft, self.indices, child, self.stats)
            total += min(s.cost for s in opts) + ARM_OVERHEAD if opts else 2e9
        if total >= single.cost:
            return single
        arms: List[QueryPlan] = [
            self._plan_single(child, Explainer(), max_ranges) for child in children
        ]
        total = sum(a.cost + ARM_OVERHEAD for a in arms)
        explain.push(f"Union plan: {len(arms)} per-index scans (cost {total:g})")
        for child, arm in zip(children, arms):
            covered = " (ranges fully cover)" if arm.full_filter is None else ""
            explain(
                f"arm[{arm.index.name}]: {to_cql(child)}{covered} "
                f"ranges={len(arm.ranges)} cost={arm.cost:g}"
            )
        explain.pop()
        return QueryPlan(
            ft=self.ft,
            index=arms[0].index,
            ranges=[],
            values=arms[0].values,
            primary=None,
            secondary=None,
            full_filter=f,
            cost=total,
            explain=explain.output,
            union=arms,
        )

    def _plan_single(
        self,
        f: ast.Filter,
        explain: Explainer,
        max_ranges: Optional[int] = None,
    ) -> QueryPlan:
        explain.push(f"Planning query for type '{self.ft.name}'")
        explain(f"Filter: {to_cql(f)}")
        explain(f"Indices available: {[i.name for i in self.indices]}")

        strategies = get_filter_strategies(self.ft, self.indices, f, self.stats)
        explain.push(f"Strategy options: {len(strategies)}")
        for s in strategies:
            explain(
                f"{s.index.name}: primary={to_cql(s.primary) if s.primary else 'None'} "
                f"secondary={to_cql(s.secondary) if s.secondary else 'None'} "
                f"cost={s.cost:g}"
            )
        explain.pop()

        best = min(strategies, key=lambda s: s.cost)
        explain(f"Chosen strategy: {best.index.name} (cost {best.cost:g})")

        if isinstance(best.primary, ast.Exclude):
            explain("Filter is provably empty -> empty plan")
            explain.pop()
            return QueryPlan(
                ft=self.ft,
                index=best.index,
                ranges=[],
                values=best.values,
                primary=ast.EXCLUDE,
                secondary=None,
                full_filter=None,
                cost=0.0,
                explain=explain.output,
            )

        if best.primary is None and best.cost >= 1e9:
            explain("Full table scan (no index applies)")
            ranges: List[ScanRange] = []
        else:
            ranges = best.index.get_ranges(self.ft, best.values, max_ranges)
        explain(f"Ranges: {len(ranges)}")

        full = None if isinstance(f, ast.Include) else f
        # attr/id equality ranges are exact in value space, so contained
        # ranges with no residual answer the query outright. Z/XZ ranges are
        # exact only in *normalized* space -- curve cells at box edges can
        # admit raw doubles just outside the query box -- so those always
        # keep the filter unless the user opts into loose-bbox semantics
        # (Z2Index.scala:26-40 loose-bbox decision).
        cont_arr = getattr(ranges, "contained", None)  # RangeSet fast path
        all_contained = bool(len(ranges)) and (
            bool(cont_arr.all()) if cont_arr is not None
            else all(r.contained for r in ranges)
        )
        exact_value_space = best.index.name == "id" or best.index.name.startswith(
            "attr"
        )
        precise = (
            (
                best.values.geometries.precise
                if best.values.geometries is not None
                else True
            )
            and (best.values.intervals.precise if best.values.intervals else True)
            and best.values.attr_precise  # LIKE-prefix ranges over-cover
        )
        if all_contained and precise and best.secondary is None and exact_value_space:
            full = None
            explain("Ranges are fully covering -> no post-filter")
        explain.pop()

        return QueryPlan(
            ft=self.ft,
            index=best.index,
            ranges=ranges,
            values=best.values,
            primary=best.primary,
            secondary=best.secondary,
            full_filter=full,
            cost=best.cost,
            explain=explain.output,
        )
