"""TorchDataStore: a lean datastore facade over the scan executor.

Port of ``geomesa_tpu/store/datastore.py`` (``TpuDataStore``) limited to
schema creation, writers and bulk column ingest, ``query``, the pipelined
``query_many`` and ``count``. The executor seam and the host-scan fallback are
the reference's: an executor returns a device scan or None, and None scans
the host blocks over the plan's ranges. Execution per query: PLAN
(cached) -> ROUTE (union arms) -> SCAN (the executor's host seek or device
scan, or host candidates, then the host post-filter unless the scan
evaluated the exact predicate) -> MERGE (``LazyColumns``: a result holds
(block, rows) parts and gathers a column only when something reads it; fid
dedupe across union arms, sort/limit/projection and the host reducer
materialize the columns first).

The density aggregation hint (``hints={"density": {"envelope": (xmin,
ymin, xmax, ymax), "width": W, "height": H}}``) is pushed down to the
executor's ``density_scan`` (the reference's KryoLazyDensityIterator
analog: the grid comes back, the rows do not); when the executor declines,
the host reducer ``run_aggregation`` answers over the scanned rows. The
result's grid is ``QueryResult.aggregate["density"]``. The stats hint
(``hints={"stats": "Count();MinMax(a);TopK(b)"}``) is pushed down to the
executor's ``stats_scan`` the same way (the per-value counts come back, the
rows do not; ``plan.scan_path`` = ``device-stats``), its sketch in
``QueryResult.aggregate["stats"]``. ``count`` asks the executor's
``count_scan`` for the exact count of a filter (one int32 a segment), else
counts the query's rows.

Admission, deadlines, tenants, workload capture, audit, plan telemetry,
visibility labels, age-off, deletes, the bin / arrow aggregations, the
aggregate cache, pyramids, joins, sampling, transforms and streaming are
not in this slice of the port. A device scan, count or stats push-down that
fails raises (after ``executor.degrade`` evicts the mirror) instead of being
answered from the host.
"""

from __future__ import annotations

import uuid
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
from torch.profiler import record_function

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.index.aggregators import (
    AGGREGATION_HINTS,
    has_aggregation,
    run_aggregation,
)
from geomesa_tpu_torch.index.keyspace import IndexKeySpace, default_indices
from geomesa_tpu_torch.index.planner import Query, QueryPlan, QueryPlanner
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.parallel.mesh import Device
from geomesa_tpu_torch.schema.feature import Feature
from geomesa_tpu_torch.schema.featuretype import AttributeType, FeatureType
from geomesa_tpu_torch.stats.service import SketchStats
from geomesa_tpu_torch.store.blocks import (
    ColumnBuffer,
    Columns,
    IndexTable,
    RecordBlock,
    dict_decode,
    intern_fids,
    intern_string_columns,
    take_rows,
)

DEFAULT_FLUSH_SIZE = 100_000


class LazyColumns(Mapping):
    """Deferred column materialization over scanned (block, rows) parts
    (the reference's ``LazyColumns``, the KryoBufferSimpleFeature lazy-read
    analog): a query result holds row indices into the immutable sealed
    blocks and gathers a column only when something reads it, once. A
    fid-only stream or ``len(result)`` never pays for a gather.

    Parts hold index-block rows; a column resolves the block's own
    (key-sorted) column first and falls through to the shared record block
    via the block's rowid mapping, computed at most once per part.
    Read-only; ``materialize()`` returns a plain dict for the code that
    re-orders or mutates columns (dedupe, sort, limit, aggregation)."""

    __slots__ = ("_parts", "_keys", "_cache", "_rmap", "num_rows")

    def __init__(self, parts, keys):
        self._parts = parts  # [(FeatureBlock, row-index array)]
        self._keys = frozenset(keys)
        self._cache: Dict[str, np.ndarray] = {}
        self._rmap: Dict[int, np.ndarray] = {}  # part index -> record rows
        self.num_rows = int(sum(len(r) for _, r in parts))

    def _part_col(self, i: int, block, rows, k: str) -> np.ndarray:
        if k not in block.columns and block.record is not None:
            rr = self._rmap.get(i)
            if rr is None:
                rr = self._rmap[i] = block.rowid[rows]
            got = block.gather(k, rows, record_rows=rr)
        else:
            got = block.gather(k, rows)
        vocab = self._vocab_for(block, k)
        return got if vocab is None else dict_decode(got, vocab)

    @staticmethod
    def _vocab_for(block, k: str):
        if k.startswith("__") or k.endswith("__null"):
            return None
        cols = block.record.columns if block.record is not None else block.columns
        return cols.get(k + "__vocab")

    def __getitem__(self, k: str) -> np.ndarray:
        if k not in self._keys:
            raise KeyError(k)
        got = self._cache.get(k)
        if got is None:
            pieces = [self._part_col(i, b, rows, k) for i, (b, rows) in enumerate(self._parts)]
            got = np.concatenate(pieces) if pieces else np.empty(0, dtype=object)
            self._cache[k] = got
        return got

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def __contains__(self, k):
        return k in self._keys

    def materialize(self) -> Columns:
        return {k: self[k] for k in self._keys}


class QueryResult:
    """Columnar query result; ``columns`` is a plain dict or a
    ``LazyColumns``; ``aggregate`` holds the density grid when the query's
    hints asked for one."""

    def __init__(self, ft: FeatureType, columns: Columns, plan: Optional[QueryPlan] = None,
                 aggregate: Optional[Dict[str, Any]] = None):
        self.ft = ft
        self.columns = columns
        self.plan = plan
        self.aggregate = aggregate or {}

    def __len__(self):
        n = getattr(self.columns, "num_rows", None)
        if n is not None:
            return n
        for v in self.columns.values():
            return len(v)
        return 0

    @property
    def fids(self) -> np.ndarray:
        return self.columns.get("__fid__", np.empty(0, dtype=object))


class FeatureWriter:
    """Buffered appender; flush seals one block per index (GeoMesaFeatureWriter
    analog; fids default to random UUIDs)."""

    def __init__(self, store: "TorchDataStore", ft: FeatureType, flush_size: int):
        self.store = store
        self.ft = ft
        self.buffer = ColumnBuffer(ft)
        self.flush_size = flush_size

    def write(self, values: Sequence[Any], fid: Optional[str] = None) -> str:
        fid = fid if fid is not None else str(uuid.uuid4())
        self.buffer.append(Feature(self.ft, fid, values))
        if len(self.buffer) >= self.flush_size:
            self.flush()
        return fid

    def flush(self):
        if len(self.buffer):
            self.store._insert_columns(self.ft, self.buffer.to_columns())
            self.buffer.clear()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is None or isinstance(exc, Exception):
            self.flush()
        return False


class TorchDataStore:
    """The datastore facade: create_schema / writer / query / query_many.

    With no ``executor``, scans run on a ``TorchScanExecutor`` for
    ``device`` (the first CUDA device unless the caller names one; raises
    when there is none)."""

    def __init__(self, executor=None, flush_size: int = DEFAULT_FLUSH_SIZE,
                 device: Optional[Device] = None):
        self.executor = executor if executor is not None else TorchScanExecutor(device)
        self.flush_size = flush_size
        # write-time sketches feeding the cost-based strategy choice
        self.stats = SketchStats()
        self._schemas: Dict[str, FeatureType] = {}
        self._indices: Dict[str, List[IndexKeySpace]] = {}
        self._tables: Dict[str, Dict[str, IndexTable]] = {}
        self._plan_cache: Dict[Any, QueryPlan] = {}

    # -- schema ---------------------------------------------------------------

    def create_schema(self, ft: FeatureType) -> None:
        if ft.name in self._schemas:
            if self._schemas[ft.name] != ft:
                raise ValueError(f"Schema {ft.name} already exists with different spec")
            return
        if ft.default_geometry is None:
            raise ValueError("Schema requires a geometry attribute")
        indices = default_indices(ft)
        if not indices:
            raise ValueError(f"No indices support schema {ft.name}")
        self._schemas[ft.name] = ft
        self._indices[ft.name] = indices
        self._tables[ft.name] = {i.name: IndexTable(i, ft) for i in indices}

    def get_schema(self, name: str) -> FeatureType:
        if name not in self._schemas:
            raise KeyError(f"Unknown feature type: {name}")
        return self._schemas[name]

    # -- writes ---------------------------------------------------------------

    def writer(self, name: str, flush_size: Optional[int] = None) -> FeatureWriter:
        return FeatureWriter(self, self.get_schema(name), flush_size or self.flush_size)

    def _insert_columns(self, ft: FeatureType, columns: Columns):
        # once per batch, not per index table
        columns = intern_string_columns(ft, intern_fids(columns))
        # ONE shared record block per batch: index tables sort only their
        # key + scan-hot columns and reference the rest by rowid
        record = RecordBlock(columns)
        for table in self._tables[ft.name].values():
            table.insert_record(record)
        self.stats.observe_columns(ft, columns)

    # -- queries --------------------------------------------------------------

    def planner(self, name: str) -> QueryPlanner:
        return QueryPlanner(self.get_schema(name), self._indices[name], self.stats)

    def _as_query(self, query: Union[str, Query]) -> Query:
        return query if isinstance(query, Query) else Query.cql(query)

    def _plan_cached(self, name: str, query: Query) -> QueryPlan:
        """Plan cache keyed on (type, filter text, table state)."""
        from geomesa_tpu_torch.filter.parser import to_cql

        versions = tuple(t.version for t in self._tables[name].values())
        key = (name, to_cql(query.filter), versions)
        plan = self._plan_cache.pop(key, None)
        if plan is None:
            plan = self.planner(name).plan(query)
            if len(self._plan_cache) >= 256:
                self._plan_cache.pop(next(iter(self._plan_cache)))
        self._plan_cache[key] = plan
        return plan

    def query(self, name: str, query: Union[str, Query] = "INCLUDE") -> QueryResult:
        ft = self.get_schema(name)
        query = self._as_query(query)
        return self._execute(name, ft, query, self._plan_cached(name, query))

    def count(self, name: str, query: Union[str, Query, None] = None, exact: bool = True) -> int:
        """The feature count (the reference's ``count``): without a query the
        rows written; with one, ``exact=False`` answers from the write-time
        sketches (the EXACT_COUNT hint / GeoMesaStats.getCount split) where
        they can estimate, and an exact count asks the executor's device
        count (``_count_device``), else counts the query's rows. The port
        has no deletes, age-off or visibility labels yet, and no aggregate
        pyramid: the reference tries its pyramid before the device count."""
        tables = self._tables[name]
        if query is None:
            return int(next(iter(tables.values())).num_rows)
        q = self._as_query(query)
        if not exact:
            est = self.stats.get_count(self.get_schema(name), q.filter)
            if est is not None:
                return int(est)
        else:
            got = self._count_device(name, q)
            if got is not None:
                return got
        return len(self.query(name, q))

    def _count_device(self, name: str, q: Query) -> Optional[int]:
        """The executor's ``count_scan`` of the query's plan, when its
        semantics are ``len`` of the query's rows (no limit, no hints, no
        union: the host dedupes overlapping arms); None -> the caller
        counts the rows. A failed device count raises after the mirror is
        evicted."""
        count_scan = getattr(self.executor, "count_scan", None)
        if count_scan is None or q.max_features is not None or q.hints:
            return None
        plan = self._plan_cached(name, q)
        if plan.union:
            return None
        table = self._tables[name].get(plan.index.name)
        if table is None:
            return None
        try:
            return count_scan(table, plan)
        except Exception as e:
            self.executor.degrade(table, e)
            raise

    def query_many(self, name: str, queries: Sequence[Union[str, Query]]) -> List[QueryResult]:
        """Execute many queries with PIPELINED device dispatch: phase 1 plans
        every query and starts its device work (exact-shape plans on one
        table fuse into one batched launch); phase 2 resolves and
        post-filters in order. Results are positionally identical to
        ``[query(name, q) for q in queries]``. Density and stats queries are
        left out of the dispatch: their push-downs launch their own kernels
        (and one that declines scans alone)."""
        ft = self.get_schema(name)
        qs = [self._as_query(q) for q in queries]
        with record_function("geomesa.plan"):
            plans = [self._plan_cached(name, q) for q in qs]
        pending: Dict[int, object] = {}
        dispatch_many = getattr(self.executor, "dispatch_many", None)
        if dispatch_many is not None:
            items = []
            for q, plan in zip(qs, plans):
                if "density" in q.hints or "stats" in q.hints:
                    continue
                for arm in plan.union if plan.union is not None else [plan]:
                    if arm.is_empty or id(arm) in pending:
                        continue
                    pending[id(arm)] = None
                    items.append((self._tables[name][arm.index.name], arm))
            if items:
                try:
                    with record_function("geomesa.dispatch"):
                        pending.update(dispatch_many(items))
                except Exception as e:
                    self.executor.degrade(None, e)
                    raise
        return [self._execute(name, ft, q, p, pending) for q, p in zip(qs, plans)]

    def _execute(self, name, ft, query: Query, plan: QueryPlan, pending=None) -> QueryResult:
        """route -> scan -> merge; a density or stats query of one plan first
        tries the device push-down."""
        aggregating = has_aggregation(query.hints)
        if aggregating and (query.hints.get("sampling") or not _untransformed(query)):
            raise NotImplementedError(
                "sampling and transforms are not ported (ROADMAP Queue 1 item 17)"
            )
        if plan.is_empty:
            empty = _empty_columns(ft)
            agg = run_aggregation(ft, query.hints, empty) if aggregating else None
            return QueryResult(ft, empty, plan, agg)
        if plan.union is None and set(query.hints) & set(AGGREGATION_HINTS) == {"density"}:
            density_scan = getattr(self.executor, "density_scan", None)
            grid = None
            if density_scan is not None:
                grid = density_scan(
                    self._tables[name][plan.index.name], plan, query.hints["density"]
                )
            if grid is not None:
                plan.scan_path = "device-density"
                return QueryResult(ft, _empty_columns(ft), plan, {"density": grid})
        if plan.union is None and set(query.hints) & set(AGGREGATION_HINTS) == {"stats"}:
            stats_scan = getattr(self.executor, "stats_scan", None)
            stat = None
            if stats_scan is not None:
                table = self._tables[name][plan.index.name]
                try:
                    stat = stats_scan(table, plan, query.hints["stats"])
                except Exception as e:
                    self.executor.degrade(table, e)
                    raise
            if stat is not None:
                plan.scan_path = "device-stats"
                return QueryResult(ft, _empty_columns(ft), plan, {"stats": stat})
        parts: List[tuple] = []
        for arm in self._route(plan):
            parts.extend(self._scan_parts(name, ft, arm, pending))
        with record_function("geomesa.assemble"):
            columns = _columns_from_parts(ft, query, parts)
            if plan.union is not None:
                columns = _dedupe_by_fid(_materialize(columns))
            return _finish(ft, query, plan, columns)

    def _route(self, plan: QueryPlan) -> List[QueryPlan]:
        """Decompose a plan into independently scannable units: the
        cross-index union arms, or the plan itself."""
        if plan.union is not None:
            return [arm for arm in plan.union if not arm.is_empty]
        return [plan]

    def _scan_parts(self, name, ft, plan: QueryPlan, pending=None) -> List[tuple]:
        """Scan one plan into (block, final rows) parts."""
        table = self._tables[name][plan.index.name]
        if pending is not None and id(plan) in pending:
            scan = pending[id(plan)]  # pre-dispatched (query_many pipeline)
        else:
            scan = self.executor.scan_candidates(table, plan)
        plan.scan_path = _scan_label(scan)
        if scan is None:
            rows = table.scan(plan.ranges) if plan.ranges else table.scan_all()
            return self._consume(ft, plan, rows, False)
        try:
            return self._consume(ft, plan, scan, scan.exact)
        except Exception as e:
            self.executor.degrade(table, e)
            raise

    def _consume(self, ft, plan: QueryPlan, scan, exact: bool) -> List[tuple]:
        """Post-filter each (block, rows) candidate set with the full
        filter, unless the scan evaluated the query's own predicate. A host
        seek's (block, rows, covered) triples take the covered split."""
        pf_props = (
            set(ast.properties(plan.post_filter))
            if plan.post_filter is not None and not exact
            else None
        )
        parts = []
        for item in scan:
            block, rows = item[0], item[1]
            covered = item[2] if len(item) == 3 else None
            if covered is not None and pf_props is not None and covered.any():
                rows = self._filter_block_covered(ft, plan, block, rows, covered, pf_props)
            elif pf_props is not None and len(rows):
                with record_function("geomesa.post_filter"):
                    fcols = _gather_filter_cols(block, rows, pf_props)
                    mask = self.executor.post_filter(ft, plan, fcols)
                if not mask.all():
                    rows = rows[mask]
            if len(rows):
                parts.append((block, rows))
        return parts

    def _filter_block_covered(self, ft, plan: QueryPlan, block, rows, covered,
                              pf_props) -> np.ndarray:
        """Covered-split filtering of one block (the reference's
        ``_filter_block_covered``): rows of ``contained`` ranges satisfy the
        plan's primary predicate, so the full post-filter runs only on the
        uncovered rest and covered rows take just the residual secondary."""
        from geomesa_tpu_torch.filter.evaluate import evaluate

        keep = covered.copy()
        with record_function("geomesa.post_filter"):
            uncov = np.flatnonzero(~covered)
            if len(uncov):
                fcols = _gather_filter_cols(block, rows[uncov], pf_props)
                keep[uncov] = self.executor.post_filter(ft, plan, fcols)
            if plan.secondary is not None:
                cov = np.flatnonzero(covered)
                scols = _gather_filter_cols(
                    block, rows[cov], set(ast.properties(plan.secondary)))
                keep[cov] = evaluate(plan.secondary, ft, scols)
        return rows if keep.all() else rows[keep]


# derived scan-internal companion suffixes (dictionary vocabs, envelope
# prescreen columns, rect flags): never exposed in query results, whether
# they were computed at ingest or supplied precomputed by a columnar writer
_INTERNAL_SUFFIXES = (
    "__vocab", "__bxmin", "__bymin", "__bxmax", "__bymax", "__isrect"
)


def _untransformed(query: Query) -> bool:
    """No computed property (``name=expression``) among the projected ones:
    aggregations run over stored columns only."""
    return not query.properties or not any("=" in p for p in query.properties)


def _scan_label(scan) -> str:
    """Execution-path label of a scan (the reference's ``_scan_label``;
    None = the executor declined and the host table scan ran). Device
    scans carry a ``/bitmap`` or ``/runs`` suffix for the wire format."""
    if scan is None:
        return "host-table"
    name = type(scan).__name__
    if name == "_HostSeekScan":
        return "host-seek"
    base = (
        "device-batch-dual" if name == "_XZBatchScan"
        else "device-exact" if scan.exact
        else "device-mask"
    )
    if not scan.pending:
        return base
    pname = type(scan.pending[0][1]).__name__
    return f"{base}/{'bitmap' if 'Bitmap' in pname else 'runs'}"


def _column_base(k: str) -> str:
    """geom__x / dtg__null -> attribute base name (dunder-internal keys
    like __fid__ pass through unchanged)."""
    if k.startswith("__"):
        return k
    return k.split("__", 1)[0]


def _gather_filter_cols(block, rows, props) -> Columns:
    """Gather exactly the columns a filter reads (incl. "__fid__" when an
    IdFilter is present); property-free filters get a length-carrier
    column so evaluate() can infer the row count."""
    wanted = [
        k
        for k in block.all_keys()
        if k != "__vis__"
        and (k != "__fid__" or "__fid__" in props)
        and _column_base(k) in props
    ]
    rr = None
    if any(k not in block.columns for k in wanted) and block.record is not None:
        rr = block.rowid[rows]
    fcols = {}
    for k in wanted:
        if k.endswith("__vocab"):
            # dictionary vocab: whole sorted array, NOT row-aligned — the
            # evaluator maps literals through it in code space
            fcols[k] = block.columns[k] if k in block.columns else block.record.columns[k]
        else:
            fcols[k] = block.gather(k, rows, record_rows=rr)
    if not fcols:
        fcols["__rows__"] = rows
    return fcols


def _output_columns(query: Query) -> Optional[set]:
    """Base names the query result must carry; None = everything. A
    superset of the projection: sort reads the result's columns (the
    reference's ``_output_columns``, which adds sampling's)."""
    props = query.properties
    if props is None or has_aggregation(query.hints):
        return None
    if any("=" in p for p in props):
        return None  # derived transforms read arbitrary source columns
    out = set(props)
    if query.sort_by:
        out.update(a for a, _ in query.sort_by)
    return out


def _columns_from_parts(ft: FeatureType, query: Query, parts: List[tuple]):
    """(index block, rows) parts -> ``LazyColumns`` over the query's
    observable keys: the record columns present in every part (a missing
    ``__null`` companion means "no nulls"), less scan internals, restricted
    to ``_output_columns``; ``__fid__`` always."""
    if not parts:
        return _empty_columns(ft)
    out_needed = _output_columns(query)
    keysets = [
        set(b.record.columns) if b.record is not None else set(b.columns) for b, _ in parts
    ]
    common = set.intersection(*keysets)
    keys = {"__fid__"}
    keys.update(
        k
        for k in set.union(*keysets)
        if k != "__vis__"
        and not k.endswith(_INTERNAL_SUFFIXES)  # scan internals never leak
        and (k in common or k.endswith("__null"))
        and (out_needed is None or _column_base(k) in out_needed)
    )
    return LazyColumns(parts, keys)


def _materialize(columns) -> Columns:
    """LazyColumns -> plain dict (for code that re-orders or mutates);
    plain dicts pass through."""
    if isinstance(columns, LazyColumns):
        return columns.materialize()
    return columns


def _finish(ft: FeatureType, query: Query, plan: QueryPlan, columns) -> QueryResult:
    """The host reducer over materialized columns when the query
    aggregates; a plain stream (no sort, limit or transform) keeps the
    lazy mapping, already restricted to its keys; anything else
    materializes and takes sort, limit and projection."""
    if has_aggregation(query.hints):
        return QueryResult(ft, _empty_columns(ft), plan,
                           run_aggregation(ft, query.hints, _materialize(columns)))
    if (
        isinstance(columns, LazyColumns)
        and not query.sort_by
        and query.max_features is None
        and _untransformed(query)
    ):
        return QueryResult(ft, columns, plan)
    return QueryResult(ft, _apply_query_options(query, _materialize(columns)), plan)


def _empty_columns(ft: FeatureType) -> Columns:
    cols: Columns = {"__fid__": np.empty(0, dtype=object)}
    for a in ft.attributes:
        if a.type == AttributeType.POINT:
            cols[a.name + "__x"] = np.empty(0)
            cols[a.name + "__y"] = np.empty(0)
        elif a.type.is_geometry:
            cols[a.name] = np.empty(0, dtype=object)
        else:
            dtype = a.type.numpy_dtype
            cols[a.name] = np.empty(0, dtype=dtype if dtype is not None else object)
    return cols


def _dedupe_by_fid(columns: Columns) -> Columns:
    fids = columns.get("__fid__")
    if fids is None or len(fids) == 0:
        return columns
    _, first_idx = np.unique(fids.astype(str), return_index=True)
    if len(first_idx) == len(fids):
        return columns
    return take_rows(columns, np.sort(first_idx))


def _apply_query_options(query: Query, columns: Columns) -> Columns:
    """Sort, limit and projection (the reference's _apply_query_options;
    sampling and derived-attribute transforms are not in this slice)."""
    n = len(next(iter(columns.values()), []))
    if query.sort_by and n:
        keys = []
        for attr, ascending in reversed(query.sort_by):
            col = columns[attr] if attr in columns else columns[attr + "__x"]
            keys.append(col if ascending else _invert_order(col))
        columns = take_rows(columns, np.lexsort(keys))
    if query.max_features is not None and n > query.max_features:
        columns = {k: v[: query.max_features] for k, v in columns.items()}
    if query.properties is not None:
        keep = {"__fid__"}
        for p in query.properties:
            keep.update((p, p + "__x", p + "__y", p + "__null"))
        columns = {k: v for k, v in columns.items() if k in keep}
    return columns


def _invert_order(col: np.ndarray) -> np.ndarray:
    if col.dtype == object or col.dtype.kind in "US":
        # rank-invert for objects and strings (numpy has no 'negative' loop)
        order = np.argsort(col, kind="stable")
        ranks = np.empty(len(col), dtype=np.int64)
        ranks[order] = np.arange(len(col))
        return -ranks
    return -col
