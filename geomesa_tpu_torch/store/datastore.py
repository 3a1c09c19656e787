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
``QueryResult.aggregate["stats"]``. An exact ``count`` of a filter
tries the aggregate pyramid first (``_count_pyramid``), then asks the
executor's ``count_scan`` (one int32 a segment), else counts the query's
rows.

The aggregate pyramid cache (``ops/pyramid.py``, the reference's GeoBlocks
cache; ``geomesa.agg.*`` knobs, ``geomesa.agg.enabled=false`` the escape
hatch): a spatial-only z2 filter's ``count``, a ``Count()``-only stats
query (``plan.scan_path`` = ``agg-pyramid-stats``) and ``aggregate()``
(exact count and per-column sum / min / max / non-null count) answer from
the type's pyramid, built once a write generation on the device
(``TorchScanExecutor.pyramid_counts``): interior cells from their partial
sums, boundary cells by an exact scan of their z2 key ranges with the
plan's own filter. A repeated density query answers from its memo
(``agg-cache-density``). An injected ``agg.build`` fault, or a device
build that fails (``DeviceBuildFailed``: a failed link copy, after
``executor.degrade`` evicts the mirror), degrades to the uncached paths
with identical answers (``decision.pyramid.build_degraded``); a fault of a
hand kernel raises. The reference's four telemetry hooks around the
pyramid are here: the declines ``sub_cell_region`` and
``boundary_dominates``, ``build_degraded``, and the brownout ladder's
deferral of a cold build (``brownout_deferred``).

Projection (the reference's ``_finish`` / ``apply_projection``): a query's
``properties`` may hold derived attributes ``name=EXPR`` in the transform
language (``index/transforms.py``, ``tools/convert.py``), and the
``sampling`` hint (a fraction, with an optional ``sample_by`` attribute)
keeps every n-th row (of each value). Under an aggregation, sampling runs
first and a transform is applied before the reducer, so a stats query over
a computed property aggregates the derived values; the push-downs and the
cache decline such queries.

Serving (the reference's ``query``): each query runs under its budget
(``query_timeout_s``, ``geomesa.query.timeout``; ``utils/deadline.py``)
from admission on, holds a slot of ``self.admission``
(``utils/admission.py``: ``max_inflight`` / ``max_queue``, the
``geomesa.query.max.inflight`` / ``.queue.depth`` knobs; overflow sheds
with ``ShedLoad``) and, strictly after admission, may ride the
cross-query coalescer (``parallel/batch.py``) when another query is in
flight: queries of one feature type in flight together share one stacked
mask sweep per segment. ``query_many`` admits its batch as one unit. Every
result carries ``receipt``, the bytes its query moved each way and the
kernel builds it triggered (``utils/devstats.py``), and ``scan_path``, its
route.

The write lifecycle (the reference's): ``delete_features`` tombstones fids
in every index table (host scans strip them, the device mirrors clear
their valid bits), ``compact`` rewrites a type's tables from one merged
record without them, and age-off (``geomesa.feature.expiry`` in the type's
user data or the knob of that name) masks expired rows at scan time, while
``age_off()`` tombstones them. Visibility labels: a feature's ``__vis__``
expression (the writer's ``visibility=``, or a ``__vis__`` column of
``write_columns``) is checked against the store's ``auths`` on every row a
scan returns (``security/visibility.py``); a labelled or aging type takes
none of the count shortcuts, the pyramid or the density memo, and the
executor declines its count, stats, density and kNN push-downs.

Parity under faults: a device scan, count, stats, density or pyramid
push-down that fails degrades (``executor.degrade``: the mirror evicted,
a breaker strike, ``degrade.device_to_host``) and the query answers from
the host table scan, ``scan_path`` = ``host-table-degraded``; while the
executor's circuit is open, ``host-table-breaker``. A ``QueryTimeout`` or
a fault of a hand kernel (``kernels.KernelError``: a failed build, a bad
argument, a failed launch) raises.

Telemetry (the reference's): every query runs under a span tree whose
stages are ``query`` -> ``query.plan`` (``plan``,
``plan.range_decomposition``) -> ``scan`` -> ``scan.block`` (``rows_in``,
``rows_out``) -> ``scan.post_filter``, then ``query.assemble``; the tree
records when a trace is open, an exporter is installed
(``utils/trace.py``) or a slow-query budget is set (``slow_query_s``,
``geomesa.query.slow.threshold``), else each span is the shared no-op.
``explain_analyze`` runs a query under a forced trace and returns its
stages, decisions, receipt, estimate against actual and the share of its
wall the named stages explain. Every query, ``query_many`` member and
aggregate is audited: an ``audit_writer`` gets one ``QueryEvent``,
``metrics`` counts and times it, and (on by default) its plan fingerprint
(``utils/plans.py``, ``_plans_obj``) and its tenant (``utils/tenants.py``,
``_tenants_obj``) fold it in. The brownout ladder (``utils/brownout.py``)
sits on the admission gate and the pyramid's cold build; a timeline
sampler (``utils/timeline.py``) ticks it. Workload capture, the durable
telemetry spool, the arrow aggregation, joins and streaming are not in
the port yet.
"""

from __future__ import annotations

import logging
import math
import threading
import time
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
from geomesa_tpu_torch.ops.kernels import KernelError
from geomesa_tpu_torch.parallel.executor import HostRoute, TorchScanExecutor
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
from geomesa_tpu_torch.utils import admission as admission_mod
from geomesa_tpu_torch.utils import audit as audit_mod
from geomesa_tpu_torch.utils import deadline as deadline_mod
from geomesa_tpu_torch.utils import devstats, trace
from geomesa_tpu_torch.utils import plans as plans_mod
from geomesa_tpu_torch.utils import tenants as tenants_mod
from geomesa_tpu_torch.utils.audit import QueryTimeout, ShedLoad, robustness_metrics

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
    hints asked for one. ``scan_path`` is the route that answered (the
    arms' routes joined by "+" for a union), ``receipt`` the query's device
    costs (``recompiles``, ``h2d_bytes``, ``d2h_bytes``, ``pad_ratio``;
    None until the store fills it) and ``coalesced`` the size of the group
    it rode (0: solo)."""

    def __init__(self, ft: FeatureType, columns: Columns, plan: Optional[QueryPlan] = None,
                 aggregate: Optional[Dict[str, Any]] = None, scan_path: str = ""):
        self.ft = ft
        self.columns = columns
        self.plan = plan
        self.aggregate = aggregate or {}
        self.scan_path = scan_path
        self.receipt: Optional[Dict[str, Any]] = None
        self.coalesced = 0

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
    analog; fids default to random UUIDs). A feature's ``visibility`` is its
    label expression (``security/visibility.py``), stored in ``__vis__``."""

    def __init__(self, store: "TorchDataStore", ft: FeatureType, flush_size: int):
        self.store = store
        self.ft = ft
        self.buffer = ColumnBuffer(ft)
        self.flush_size = flush_size

    def write(self, values: Sequence[Any], fid: Optional[str] = None,
              visibility: Optional[str] = None) -> str:
        fid = fid if fid is not None else str(uuid.uuid4())
        user_data = {"visibility": visibility} if visibility else None
        self.buffer.append(Feature(self.ft, fid, values, user_data))
        if len(self.buffer) >= self.flush_size:
            self.flush()
        return fid

    def write_feature(self, feature: Feature) -> str:
        if feature.fid is None:
            feature = Feature(self.ft, str(uuid.uuid4()), feature.values, feature.user_data)
        self.buffer.append(feature)
        if len(self.buffer) >= self.flush_size:
            self.flush()
        return feature.fid

    def write_columns(self, columns: Columns) -> None:
        """Bulk columnar ingest (no row objects): the buffered rows first,
        then ``columns`` as one batch (a ``__vis__`` object column carries
        the labels)."""
        self.flush()
        self.store._insert_columns(self.ft, columns)

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
    when there is none). ``query_timeout_s`` (None: the
    ``geomesa.query.timeout`` knob, unbounded by default), ``max_inflight``
    and ``max_queue`` (None: ``geomesa.query.max.inflight`` 64 and
    ``.queue.depth`` 256) set the serving bounds. ``auths`` is an
    ``AuthorizationsProvider``, a list of authorizations or None (no
    authorizations: only unlabelled features are readable).
    ``audit_writer`` (``utils.audit.AuditWriter``) receives one
    ``QueryEvent`` a query and ``metrics`` (``MetricsRegistry``) its
    counters and timers; ``user`` names the caller in the events;
    ``slow_query_s`` (None: ``geomesa.query.slow.threshold``, unset by
    default) forces every query's span tree and logs the queries slower
    than it."""

    # cross-query coalescing at the admission point (parallel/batch.py)
    COALESCE_QUERIES = True

    def __init__(self, executor=None, flush_size: int = DEFAULT_FLUSH_SIZE,
                 device: Optional[Device] = None, query_timeout_s: Optional[float] = None,
                 max_inflight: Optional[int] = None, max_queue: Optional[int] = None,
                 auths: Optional[Any] = None, audit_writer: Optional[Any] = None,
                 metrics: Optional[Any] = None, slow_query_s: Optional[float] = None,
                 user: str = "unknown"):
        from geomesa_tpu_torch.utils.brownout import BrownoutController
        from geomesa_tpu_torch.utils.config import (
            QUERY_MAX_INFLIGHT,
            QUERY_QUEUE_DEPTH,
            QUERY_TIMEOUT,
            SLOW_QUERY_THRESHOLD,
        )

        self.executor = executor if executor is not None else TorchScanExecutor(device)
        self.flush_size = flush_size
        self.auths = auths
        self.query_timeout_s = (QUERY_TIMEOUT.to_duration_s() if query_timeout_s is None
                                else query_timeout_s)
        self.audit_writer = audit_writer
        self.metrics = metrics
        self.slow_query_s = (SLOW_QUERY_THRESHOLD.to_duration_s() if slow_query_s is None
                             else slow_query_s)
        self.user = user
        if max_inflight is None:
            max_inflight = QUERY_MAX_INFLIGHT.to_int() or 64
        if max_queue is None:
            mq = QUERY_QUEUE_DEPTH.to_int()
            max_queue = 256 if mq is None else mq
        self.admission = admission_mod.AdmissionController(max_inflight, max_queue)
        # the brownout ladder: ticked by a timeline sampler, consulted by
        # the admission gate and the pyramid's cold build (one attribute
        # read a query while it sits at level 0)
        self._brownout = BrownoutController()
        self.admission.brownout = self._brownout
        # write-time sketches feeding the cost-based strategy choice
        self.stats = SketchStats()
        self._schemas: Dict[str, FeatureType] = {}
        self._indices: Dict[str, List[IndexKeySpace]] = {}
        self._tables: Dict[str, Dict[str, IndexTable]] = {}
        self._plan_cache: Dict[Any, QueryPlan] = {}
        self._plan_lock = threading.Lock()
        # per-type write generation (``_note_write``): cache keys derive
        # from it through ``schema_generation``
        self._write_gen: Dict[str, int] = {}
        if self.metrics is not None and hasattr(self.metrics, "gauge_fn"):
            # one plan-cache gauge a registry, summed over the live stores
            # that share it (a registry never pins a store)
            import weakref

            stores = getattr(self.metrics, "_plan_cache_stores", None)
            if stores is None:
                stores = weakref.WeakSet()
                self.metrics._plan_cache_stores = stores
                self.metrics.gauge_fn("plan_cache.size",
                                      lambda: sum(len(s._plan_cache) for s in stores))
            stores.add(self)

    @property
    def authorizations(self) -> List[str]:
        if self.auths is None:
            return []
        if hasattr(self.auths, "get_authorizations"):
            return list(self.auths.get_authorizations())
        return list(self.auths)

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

    @property
    def type_names(self) -> List[str]:
        return sorted(self._schemas.keys())

    def delete_schema(self, name: str) -> None:
        """Drop a type and its tables. The write generation survives (a
        delete and recreate never reproduces an old ``schema_generation``)
        and moves, which drops the type's pyramid entries; the type's cached
        plans go too."""
        self.get_schema(name)
        del self._schemas[name], self._indices[name], self._tables[name]
        with self._plan_lock:
            for key in [k for k in self._plan_cache if k[0] == name]:
                del self._plan_cache[key]
        self._note_write(name)

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
        self._note_write(ft.name)

    def _note_write(self, name: str) -> None:
        """Advance the type's write generation; every write calls this. The
        aggregate cache drops the type's entries here too: the generation
        in its keys already re-keys them, but dropping them now releases
        their device copies at once."""
        self._write_gen[name] = self._write_gen.get(name, 0) + 1
        cache = self.__dict__.get("_agg_cache")
        if cache is not None:
            cache.invalidate(name)

    def schema_generation(self, name: str) -> tuple:
        """A value that changes whenever the type's rows may have changed:
        the index tables' versions and the write counter."""
        return (
            tuple(t.version for t in self._tables[name].values()),
            self._write_gen.get(name, 0),
        )

    # -- the write lifecycle -------------------------------------------------

    def delete_features(self, name: str, fids: Sequence[str]) -> None:
        """Tombstone ``fids`` in every index table of the type: host scans
        strip them and the device mirrors clear their valid bits at the
        next query (no row uploads again)."""
        for table in self._tables[name].values():
            table.delete(fids)
        self._note_write(name)

    def compact(self, name: str) -> None:
        """Rewrite every index table of the type from ONE merged record
        block of its live rows (tombstones dropped); the device mirrors
        rebuild at the next query. The reference also spills the merged
        record (``geomesa.spill.dir``); the port keeps it in memory."""
        tables = self._tables[name]
        first = next(iter(tables.values()))
        if len(first.blocks) <= 1 and not first.tombstones:
            return
        # deletes are store-wide: the fullest table (no __valid__ row
        # filter) holds every live row
        full = next(
            (t for t in tables.values() if t.index.name in ("id", "z2", "z3", "xz2", "xz3")),
            first,
        )
        record = full.merged_record()
        for table in tables.values():
            table.compact(record)
        self._note_write(name)

    def _age_off_cutoff(self, ft: FeatureType) -> Optional[int]:
        """Epoch ms below which a row has expired, or None: the retention of
        the type's ``geomesa.feature.expiry`` user data, else of the knob of
        that name (e.g. ``7 days``); a type without a date never expires."""
        if ft.default_date is None:
            return None
        import time

        from geomesa_tpu_torch.utils.config import FEATURE_EXPIRY, SystemProperty

        spec = (ft.user_data or {}).get("geomesa.feature.expiry")
        ms = SystemProperty("", str(spec)).to_duration_ms() if spec is not None else None
        if ms is None:
            ms = FEATURE_EXPIRY.to_duration_ms()
        if ms is None:
            return None
        return int(time.time() * 1000) - ms

    def _age_off_keep(self, ft, block, rows, age_cutoff) -> Optional[np.ndarray]:
        """Keep-mask of the rows within the retention window, or None when
        all are (null dates never expire)."""
        if age_cutoff is None or not len(rows):
            return None
        dtg = ft.default_date.name
        alive = block.gather(dtg, rows) >= age_cutoff
        alive |= block.gather(dtg + "__null", rows)
        return None if alive.all() else alive

    def age_off(self, name: str) -> int:
        """Tombstone the expired features (the maintenance sweep of the
        reference's ``age_off``); returns how many."""
        ft = self.get_schema(name)
        cutoff = self._age_off_cutoff(ft)
        if cutoff is None:
            return 0
        dtg = ft.default_date.name
        victims: List[np.ndarray] = []
        table = next(iter(self._tables[name].values()))
        for b, rows in table.scan_all():
            dead = (b.gather(dtg, rows) < cutoff) & ~b.gather(dtg + "__null", rows)
            if dead.any():
                victims.append(b.gather("__fid__", rows[dead]))
        fids = np.concatenate(victims) if victims else np.empty(0)
        if len(fids):
            self.delete_features(name, fids.tolist())
        return int(len(fids))

    def _has_vis(self, name: str) -> bool:
        """Whether a row of the type carries a visibility label."""
        first = next(iter(self._tables[name].values()))
        return any(b.has_col("__vis__") for b in first.blocks)

    def _shortcuts_ok(self, name: str, ft: FeatureType) -> bool:
        """The gate of every answer that does not scan rows through the
        auth and age-off checks (the row-count shortcuts, the pyramid, the
        density memo): no labelled row and no retention window."""
        return not self._has_vis(name) and self._age_off_cutoff(ft) is None

    def _visibility_keep(self, block, rows) -> Optional[np.ndarray]:
        """Keep-mask of the rows the store's authorizations may read, or
        None when all are readable."""
        if not len(rows) or not block.has_col("__vis__"):
            return None
        from geomesa_tpu_torch.security import visibility_mask

        vmask = visibility_mask(block.gather("__vis__", rows), self.authorizations)
        return None if vmask.all() else vmask

    # -- queries --------------------------------------------------------------

    def planner(self, name: str) -> QueryPlanner:
        return QueryPlanner(self.get_schema(name), self._indices[name], self.stats)

    def _as_query(self, query: Union[str, Query]) -> Query:
        return query if isinstance(query, Query) else Query.cql(query)

    def _plan_cached(self, name: str, query: Query) -> QueryPlan:
        """Plan cache keyed on (type, filter text, table state), LRU, under
        a ``query.plan`` span (``cache`` = hit | miss; a hit carries the
        cached plan's provenance itself)."""
        from geomesa_tpu_torch.filter.parser import to_cql

        with trace.span("query.plan") as sp:
            versions = tuple(t.version for t in self._tables[name].values())
            key = (name, to_cql(query.filter), versions)
            with self._plan_lock:
                plan = self._plan_cache.pop(key, None)
            if plan is None:
                sp.set_attr("cache", "miss")
                plan = self.planner(name).plan(query)
            elif sp.recording:
                sp.set_attr("cache", "hit")
                sp.set_attr("index", plan.index.name)
                sp.set_attr("explain", plan.explain)
            with self._plan_lock:
                if key not in self._plan_cache and len(self._plan_cache) >= 256:
                    self._plan_cache.pop(next(iter(self._plan_cache)))
                # a concurrent first plan of the key wins: one plan object a key
                plan = self._plan_cache.setdefault(key, plan)
        return plan

    def explain(self, name: str, query: Union[str, Query]) -> str:
        """The planner's Explainer trace of a query (a fresh plan)."""
        return self.planner(name).plan(self._as_query(query)).explain

    def explain_analyze(self, name: str, query: Union[str, Query] = "INCLUDE") -> Dict[str, Any]:
        """EXPLAIN ANALYZE (the reference's): run the query for real under a
        forced trace and return its plan annotated with what happened: the
        stages (``stages``, wall and self ms, rows in and out per block),
        the receipt, the reason-coded decisions, the plan-time estimate
        against the scanned rows (``misestimate_log2``), the fingerprint,
        and ``attribution``: the share of the query's wall that the named
        stages below its root explain. The query runs through the ordinary
        envelope (budget, admission, audit, fingerprint)."""
        q = self._as_query(query)
        # the forced wrapper makes query()'s whole tree record with no
        # exporter; the child is read directly, so concurrent queries stay
        # out of it
        with trace.span("explain.analyze", force=True, type=name) as wrap:
            result = self.query(name, q)
        root = next((c for c in wrap.children if c.name == "query"), wrap)
        plan = result.plan
        blocks = root.find("scan.block")
        rows_in = sum(int(b.attributes.get("rows_in", 0)) for b in blocks)
        rows_out = sum(int(b.attributes.get("rows_out", 0)) for b in blocks)
        decisions = [
            {"point": ev["name"][len("decision."):],
             **{k: v for k, v in ev.items() if k not in ("name", "t_ms")}}
            for sp in root.walk() for ev in sp.events if ev["name"].startswith("decision.")
        ]
        est_cost = float(getattr(plan, "cost", 0.0) or 0.0)
        scan_path = _audit_path(result)
        key = plans_mod.fingerprint_key("query", name, plan=plan, query=q, scan_path=scan_path)
        return {
            "type": name,
            "trace_id": root.trace_id,
            "fingerprint": plans_mod.fingerprint_id(key),
            "plan": {
                "index": getattr(plan.index, "name", ""),
                "scan_path": scan_path,
                "union_arms": len(plan.union) if plan.union else 0,
                "explain": plan.explain,
            },
            "estimate": {"cost": est_cost, "ranges": len(plan.ranges)},
            "actual": {
                "hits": len(result),
                "rows_scanned": rows_in,
                "rows_out": rows_out,
                "blocks": len(blocks),
                "duration_ms": round(root.duration_ms, 3),
            },
            # signed log2: +k = the cost model under-estimated by ~2^k
            "misestimate_log2": round(math.log2((rows_in + 1.0) / (est_cost + 1.0)), 3),
            "receipt": root.attributes.get("device", {}),
            "attribution": attribution(root),
            "decisions": decisions,
            "stages": _stage_tree(root),
        }

    def query(self, name: str, query: Union[str, Query] = "INCLUDE") -> QueryResult:
        """One query under its budget and an admission slot (the
        reference's ``query``): it sheds with ``ShedLoad`` when the gate and
        its queue are full and raises ``QueryTimeout`` when its budget dies,
        never a truncated result. Admitted, it rides the coalescer when
        another query is in flight (``_coalesced``), else runs alone; the
        result carries its receipt either way. The query is audited
        (``_audit``), a timed-out or shed one too (``_audit_failure``), and
        logged when slower than ``slow_query_s``."""
        ft = self.get_schema(name)
        query = self._as_query(query)
        root = trace.NOOP
        plan = None
        # the plan-telemetry scope: decisions and per-block rows collect
        # here until ``_audit`` folds them into the fingerprint
        ptok = plans_mod.begin()
        try:
            with trace.span("query", force=self.slow_query_s is not None, type=name) as root:
                t_admit = time.perf_counter()
                try:
                    with deadline_mod.budget(self.query_timeout_s):
                        with self.admission.admit(
                                priority=admission_mod.classify(query.hints)):
                            out = self._coalesced(name, ft, query)
                            if out is not None:
                                plan = out.plan
                                result, receipt = out.result, out.receipt
                                result.coalesced = out.group_n
                                plans_mod.note("coalesce",
                                               "joined" if out.group_n > 1 else "solo")
                                t_start, t_planned = t_admit, t_admit + out.plan_s
                            else:
                                with devstats.collecting() as own:
                                    t_start = time.perf_counter()
                                    plan = self._plan_cached(name, query)
                                    t_planned = time.perf_counter()
                                    result = self._execute(name, ft, query, plan)
                                receipt = devstats.receipt_of(own)
                            result.receipt = receipt
                            if root.recording:
                                root.set_attr("hits", len(result))
                                root.set_attr("scan_path", _audit_path(result))
                                root.set_attr("device", receipt)
                                root.set_attr("coalesced", result.coalesced)
                            if self._auditing():
                                self._audit(name, query, plan, result, t_start, t_planned,
                                            receipt)
                            return result
                except (QueryTimeout, ShedLoad) as e:
                    outcome = "timeout" if isinstance(e, QueryTimeout) else "shed"
                    if root.recording:
                        root.set_attr("outcome", outcome)
                    if self._auditing():
                        self._audit_failure(name, query, plan, t_admit, outcome)
                    raise
        finally:
            plans_mod.end(ptok)
            self._log_slow_query(name, plan, root)

    def _coalescer_obj(self):
        """The store's coalescer, made at first use (one instance however
        many threads ask: ``dict.setdefault`` is atomic)."""
        co = getattr(self, "_coalescer", None)
        if co is None:
            from geomesa_tpu_torch.parallel.batch import QueryCoalescer

            co = self.__dict__.setdefault("_coalescer", QueryCoalescer(self))
        return co

    def _coalesced(self, name: str, ft, query: Query):
        """Hand one ADMITTED query to the coalescer when it can help: a
        ``batch.MemberOutcome``, or None for the solo path. Gates, cheapest
        first: the class opt-out, an executor without
        ``dispatch_coalesced``, concurrency (another query in flight or a
        group gathering: a query alone on the store never pays the window)
        and the geomesa.batch.* knobs."""
        if not self.COALESCE_QUERIES:
            return None
        if getattr(self.executor, "dispatch_coalesced", None) is None:
            return None
        co = self._coalescer_obj()
        if self.admission.inflight < 2 and not co.gathering(name):
            return None
        from geomesa_tpu_torch.parallel.batch import batch_knobs

        if not batch_knobs()[0]:
            return None
        return co.submit(name, ft, query)

    # -- audit, plan telemetry and metering --------------------------------------

    def _auditing(self) -> bool:
        """Whether the audit step runs at all: an audit writer, a metrics
        registry, plan telemetry or the tenant meter is listening (each
        sink is checked again in ``_audit``)."""
        return (self.audit_writer is not None or self.metrics is not None
                or plans_mod.enabled() or tenants_mod.enabled())

    @staticmethod
    def _collect_scan_path(plan) -> str:
        """The plan's route as the reference audits it: a union joins its
        arms' labels."""
        if plan.union is not None:
            arms = [getattr(a, "scan_path", "") for a in plan.union]
            return "+".join(sorted({a for a in arms if a}))
        return getattr(plan, "scan_path", "")

    def _audit(self, name, query, plan, result, t_start, t_planned, receipt) -> None:
        """One finished query into every sink: the ``queries`` counter and
        the ``query.plan`` / ``query.scan`` timers, one ``QueryEvent``, its
        plan fingerprint (estimates against the pending scope's actuals)
        and its tenant."""
        from geomesa_tpu_torch.filter.parser import to_cql
        from geomesa_tpu_torch.utils.audit import QueryEvent

        now = time.perf_counter()
        hits = len(result)
        scan_path = _audit_path(result)
        if self.metrics is not None:
            self.metrics.inc("queries")
            self.metrics.update_timer("query.plan", t_planned - t_start)
            self.metrics.update_timer("query.scan", now - t_planned)
        if self.audit_writer is not None:
            self.audit_writer.write_event(QueryEvent(
                store=type(self).__name__,
                type_name=name,
                user=self.user,
                filter=to_cql(query.filter),
                hints=dict(query.hints),
                date_ms=int(time.time() * 1000),
                planning_ms=1000 * (t_planned - t_start),
                scanning_ms=1000 * (now - t_planned),
                hits=hits,
                scan_path=scan_path,
                # inside the query's root span: the event and the tree
                # join on this id
                trace_id=trace.current_trace_id() or "",
                recompiles=receipt["recompiles"],
                h2d_bytes=receipt["h2d_bytes"],
                d2h_bytes=receipt["d2h_bytes"],
                pad_ratio=receipt["pad_ratio"],
            ))
        if plans_mod.enabled():
            self._plans_obj().observe(
                "query", name, plan=plan, query=query, scan_path=scan_path, outcome="ok",
                hits=hits, duration_s=now - t_start, receipt=receipt, est_cost=plan.cost,
                est_ranges=len(plan.ranges))
        self._observe_workload("query", name, query=query, outcome="ok",
                               duration_s=now - t_start, rows=hits, receipt=receipt)

    def _audit_failure(self, name, query, plan, t_admit, outcome: str) -> None:
        """The audit of a query that failed crisply (timeout or shed): no
        hits, the elapsed wall (admission wait included) as its scan time."""
        from geomesa_tpu_torch.filter.parser import to_cql
        from geomesa_tpu_torch.utils.audit import QueryEvent

        elapsed_ms = 1000 * (time.perf_counter() - t_admit)
        scan_path = self._collect_scan_path(plan) if plan is not None else ""
        if self.metrics is not None:
            self.metrics.inc("queries")
            self.metrics.inc(f"queries.{outcome}")
        if self.audit_writer is not None:
            self.audit_writer.write_event(QueryEvent(
                store=type(self).__name__,
                type_name=name,
                user=self.user,
                filter=to_cql(query.filter),
                hints=dict(query.hints),
                date_ms=int(time.time() * 1000),
                planning_ms=0.0,
                scanning_ms=elapsed_ms,
                hits=0,
                scan_path=scan_path,
                trace_id=trace.current_trace_id() or "",
                outcome=outcome,
            ))
        if plans_mod.enabled():
            self._plans_obj().observe(
                "query", name, plan=plan, query=query, scan_path=scan_path, outcome=outcome,
                hits=0, duration_s=elapsed_ms / 1000.0,
                est_cost=plan.cost if plan is not None else None,
                est_ranges=len(plan.ranges) if plan is not None else None)
        self._observe_workload("query", name, query=query, outcome=outcome,
                               duration_s=elapsed_ms / 1000.0)

    def _plans_obj(self):
        """The store's plan-fingerprint registry, made at first use (one
        however many threads ask)."""
        reg = getattr(self, "_plans", None)
        if reg is None:
            reg = self.__dict__.setdefault("_plans", plans_mod.PlanRegistry())
        return reg

    def _tenants_obj(self):
        """The store's tenant registry, made at first use."""
        reg = getattr(self, "_tenants", None)
        if reg is None:
            reg = self.__dict__.setdefault("_tenants", tenants_mod.TenantRegistry())
        return reg

    def _observe_workload(self, cls, type_name, *, query=None, outcome="ok", duration_s=0.0,
                          rows=0, receipt=None) -> None:
        """The tenant meter of one finished request (the reference's seam
        also captures the workload, which waits for the durable spool). A
        pure observer, after the result is final."""
        if tenants_mod.enabled():
            self._tenants_obj().observe(tenants_mod.tenant_of(query), cls, outcome=outcome,
                                        duration_s=duration_s, rows=rows, receipt=receipt)

    def _log_slow_query(self, name: str, plan, root) -> None:
        """A query slower than ``slow_query_s`` logs its span tree and its
        plan (``geomesa_tpu_torch.slowquery``), within the storm guard's
        budget (``utils.audit.slow_query_note``); every slow query files a
        summary in the tail."""
        from geomesa_tpu_torch.utils.audit import slow_query_note

        if self.slow_query_s is None or not root.recording:
            return
        if root.duration_ms < self.slow_query_s * 1000.0:
            return
        if not slow_query_note({
            "kind": "query",
            "type": name,
            "trace_id": root.trace_id,
            "duration_ms": round(root.duration_ms, 1),
            "budget_ms": round(self.slow_query_s * 1000.0, 1),
        }):
            return
        logging.getLogger("geomesa_tpu_torch.slowquery").warning(
            "slow query type=%s trace=%s took %.1fms (budget %.0fms)\n%s\nexplain:\n%s",
            name, root.trace_id, root.duration_ms, self.slow_query_s * 1000.0, root.render(),
            plan.explain if plan is not None else "<planning failed>")

    def _log_slow_batch(self, name: str, batch) -> None:
        """``query_many``'s slow log: the batch's own overhead (planning and
        the pipelined dispatch, outside its queries' spans) over the budget
        logs the batch tree, each member's wall net of the shares of shared
        fetches (``device.fetch.shared``) that belong to its batchmates."""
        from geomesa_tpu_torch.utils.audit import slow_query_note

        if self.slow_query_s is None or not batch.recording:
            return
        own_ms = batch.duration_ms - sum(c.duration_ms for c in batch.children
                                         if c.name == "query")
        if own_ms < self.slow_query_s * 1000.0:
            return
        if not slow_query_note({
            "kind": "batch",
            "type": name,
            "trace_id": batch.trace_id,
            "duration_ms": round(batch.duration_ms, 1),
            "overhead_ms": round(own_ms, 1),
            "budget_ms": round(self.slow_query_s * 1000.0, 1),
        }):
            return
        members = []
        for i, c in enumerate(c for c in batch.children if c.name == "query"):
            shared_ms = sum(
                s.duration_ms * (s.attributes.get("shared_q", 1) - 1)
                / max(s.attributes.get("shared_q", 1), 1)
                for s in c.find("device.fetch.shared"))
            members.append(f"  member {i}: {c.duration_ms - shared_ms:.1f}ms attributed"
                           f" (raw {c.duration_ms:.1f}ms)")
        logging.getLogger("geomesa_tpu_torch.slowquery").warning(
            "slow query batch type=%s trace=%s overhead %.1fms of %.1fms total "
            "(budget %.0fms)\n%s\n%s", name, batch.trace_id, own_ms, batch.duration_ms,
            self.slow_query_s * 1000.0, "\n".join(members), batch.render())

    @staticmethod
    def _pushes_down(query: Query) -> bool:
        """A density or stats query: its push-down launches its own kernels
        (or it scans alone), so batched dispatch leaves it out."""
        return "density" in query.hints or "stats" in query.hints

    def count(self, name: str, query: Union[str, Query, None] = None, exact: bool = True) -> int:
        """The feature count (the reference's ``count``): without a query the
        rows written; with one, ``exact=False`` answers from the write-time
        sketches (the EXACT_COUNT hint / GeoMesaStats.getCount split) where
        they can estimate, and an exact count tries the aggregate pyramid
        (``_count_pyramid``), then the executor's device count
        (``_count_device``), else counts the query's rows. A labelled or
        aging type counts through the query (auths and age-off apply per
        row; the write-time sketches saw every row)."""
        ft = self.get_schema(name)
        first = next(iter(self._tables[name].values()))
        shortcuts = self._shortcuts_ok(name, ft)
        if query is None:
            if not shortcuts:
                return len(self.query(name))
            if not first.tombstones:
                return int(first.num_rows)
            return sum(len(rows) for _b, rows in first.scan_all())
        q = self._as_query(query)
        if not exact:
            est = self.stats.get_count(ft, q.filter) if shortcuts else None
            if est is not None:
                return int(est)
        elif shortcuts:
            if q.max_features is None and not q.hints:
                plan = self._plan_cached(name, q)
                got = self._count_pyramid(name, ft, q, plan)
                if got is not None:
                    return got
            got = self._count_device(name, q)
            if got is not None:
                return got
        return len(self.query(name, q))

    def _count_device(self, name: str, q: Query) -> Optional[int]:
        """The executor's ``count_scan`` of the query's plan, when its
        semantics are ``len`` of the query's rows (no limit, no hints, no
        union: the host dedupes overlapping arms); None -> the caller
        counts the rows, as it does after a failed device count (degraded)
        or while the circuit is open."""
        count_scan = getattr(self.executor, "count_scan", None)
        if count_scan is None or q.max_features is not None or q.hints:
            return None
        plan = self._plan_cached(name, q)
        if plan.union:
            return None
        table = self._tables[name].get(plan.index.name)
        if table is None:
            return None
        got = self.executor.push_down(table, count_scan, table, plan)
        if isinstance(got, HostRoute):
            _push_down_declined(got, "count_to_host")
            return None
        return got

    # -- the aggregate pyramid cache (ops/pyramid.py) ---------------------------

    def _agg_cache_obj(self):
        """The store's aggregate cache, made at first use (one however many
        threads ask: ``dict.setdefault`` is atomic)."""
        cache = getattr(self, "_agg_cache", None)
        if cache is None:
            from geomesa_tpu_torch.ops.pyramid import AggCache

            cache = self.__dict__.setdefault("_agg_cache", AggCache())
        return cache

    def _pyramid_for(self, name: str, ft) -> Optional[Any]:
        """The type's cached pyramid, built at first use under the
        ``agg.build`` envelope; None when the type has no z2 table or the
        build degraded (an injected fault, or a failed device count that
        degraded the executor): the caller answers from the uncached scan,
        identically. A budget that dies raises, as does a kernel that fails
        to build."""
        from geomesa_tpu_torch.ops.pyramid import BUILD_FAULTS, agg_knobs, build_pyramid

        table = self._tables[name].get("z2")
        if table is None:
            return None
        bits, levels, ttl, _cap = agg_knobs()
        cache = self._agg_cache_obj()
        key = ("pyramid", name, self.schema_generation(name), bits, levels)
        pyr = cache.get(key, ttl)
        if pyr is not None:
            return pyr
        # a cold build is optional work (the exact scan answers the same):
        # at the brownout ladder's speculation-off level it defers, and a
        # warm pyramid above keeps answering
        bo = self._brownout
        if not bo.speculation_allowed():
            from geomesa_tpu_torch.utils import brownout as brownout_mod

            if brownout_mod.enabled():
                devstats.devstats_metrics().inc("agg.cache.declined")
                audit_mod.decision("pyramid", "brownout_deferred", level=bo.level)
                return None
        try:
            pyr = build_pyramid(table, ft, self.executor)
        except BUILD_FAULTS as e:
            _degrade_agg(e)
            return None
        cache.put(key, pyr)
        return pyr

    def _agg_eligible(self, name: str) -> bool:
        """The store-state gates of every pyramid consumer: the cache is on,
        the type has a z2 table, and no row carries a label and no retention
        window applies (the pyramid counted every row)."""
        from geomesa_tpu_torch.ops.pyramid import agg_enabled

        return (agg_enabled() and "z2" in self._tables.get(name, {})
                and self._shortcuts_ok(name, self.get_schema(name)))

    def _pyramid_classify(self, name, ft, query: Query, plan):
        """The gate -> build -> classify pipeline under every pyramid
        consumer: eligibility, the spatial-only shape, the declines before
        the build (no interior cell possible) and after the classification
        (the boundary dominates), and the (possibly degraded) build.
        Returns ``(pyr, interior_rows, boundary_cells, interior_mask)`` or
        None (the caller answers uncached)."""
        from geomesa_tpu_torch.filter.parser import to_cql
        from geomesa_tpu_torch.index.planner import pyramid_worthwhile, spatial_only_shape
        from geomesa_tpu_torch.ops.pyramid import agg_knobs, could_have_interior

        if not self._agg_eligible(name):
            return None
        geoms = spatial_only_shape(plan, ft)
        if geoms is None:
            return None
        if not could_have_interior(geoms, agg_knobs()[0]):
            # a sub-cell region: declined before paying for the build
            devstats.devstats_metrics().inc("agg.cache.declined")
            audit_mod.decision("pyramid", "sub_cell_region", type=name)
            return None
        pyr = self._pyramid_for(name, ft)
        if pyr is None:
            return None
        interior, boundary_rows, _cand, cells, imask = pyr.classify(
            geoms, memo_key=to_cql(query.filter))
        if not pyramid_worthwhile(interior, boundary_rows):
            devstats.devstats_metrics().inc("agg.cache.declined")
            audit_mod.decision("pyramid", "boundary_dominates", interior=int(interior),
                               boundary_rows=int(boundary_rows))
            return None
        return pyr, interior, cells, imask

    def _count_pyramid(self, name, ft, query: Query, plan) -> Optional[int]:
        """The exact count from the pyramid: interior partial sums plus the
        exact boundary-ring scan; None -> the ordinary paths count."""
        got = self._pyramid_classify(name, ft, query, plan)
        if got is None:
            return None
        pyr, interior, cells, _imask = got
        n = interior
        if len(cells):
            parts = self._agg_boundary_parts(name, ft, plan, pyr.cell_ranges(cells))
            n += sum(len(r) for _b, r in parts)
        return n

    def _agg_boundary_parts(self, name, ft, plan, ranges) -> List[tuple]:
        """Seek only the boundary cells' z2 key ranges and keep the rows the
        plan's own filter passes: the uncached scan's per-row semantics."""
        table = self._tables[name]["z2"]
        pf = plan.post_filter
        pf_props = set(ast.properties(pf)) if pf is not None else None
        parts: List[tuple] = []
        for block, rows in table.scan(ranges):
            deadline_mod.check("agg.boundary")
            if pf_props is not None and len(rows):
                fcols = _gather_filter_cols(block, rows, pf_props)
                mask = self.executor.post_filter(ft, plan, fcols)
                if not mask.all():
                    rows = rows[mask]
            if len(rows):
                parts.append((block, rows))
        return parts

    def _density_key(self, name: str, query: Query) -> Optional[tuple]:
        """The memo key of one density query: everything that decides the
        grid (filter, grid spec, weight, projection) and the schema
        generation."""
        from geomesa_tpu_torch.filter.parser import to_cql

        spec = query.hints.get("density") or {}
        try:
            env = tuple(float(v) for v in spec["envelope"])
            w, h = int(spec["width"]), int(spec["height"])
        except (KeyError, TypeError, ValueError):
            return None
        return (
            "density", name, self.schema_generation(name), to_cql(query.filter), env, w, h,
            spec.get("weight"),
            tuple(query.properties) if query.properties is not None else None,
        )

    @staticmethod
    def _memoizable(query: Query) -> bool:
        """The cache's hint whitelist: aggregation hints only (sampling
        changes the rows and loose_bbox the filter's contract, so their
        grids must never share a memo entry with an exact query's) and no
        transform."""
        return not (set(query.hints) - set(AGGREGATION_HINTS)) and _untransformed(query)

    def _agg_shortcut(self, name, ft, query: Query, plan) -> Optional[QueryResult]:
        """The cache's answers ahead of the push-downs: a memoized density
        grid, or a ``Count()``-only stats query from the pyramid."""
        from geomesa_tpu_torch.ops.pyramid import agg_enabled, agg_knobs

        if not agg_enabled() or not self._memoizable(query) or not self._shortcuts_ok(name, ft):
            return None
        hints = set(query.hints) & set(AGGREGATION_HINTS)
        if hints == {"density"}:
            key = self._density_key(name, query)
            if key is None:
                return None
            entry = self._agg_cache_obj().get(key, agg_knobs()[2])
            if entry is None:
                return None
            plan.scan_path = "agg-cache-density"
            trace.set_attr("agg.cache", "hit")
            plans_mod.note("pyramid", "hit")
            return QueryResult(ft, _empty_columns(ft), plan, {"density": entry.grid.copy()},
                               scan_path=plan.scan_path)
        if hints == {"stats"}:
            stat = _count_only_stats(query.hints["stats"])
            if stat is None:
                return None
            n = self._count_pyramid(name, ft, query, plan)
            if n is None:
                return None
            for st in stat.stats if hasattr(stat, "stats") else [stat]:
                st.count = n
            plan.scan_path = "agg-pyramid-stats"
            trace.set_attr("agg.cache", "hit")
            plans_mod.note("pyramid", "hit")
            return QueryResult(ft, _empty_columns(ft), plan, {"stats": stat},
                               scan_path=plan.scan_path)
        return None

    def _agg_density_fill(self, name, query: Query, result: QueryResult) -> None:
        """Memoize a density grid just computed (device or host reducer) so
        the next identical query answers with no dispatch."""
        from geomesa_tpu_torch.ops.pyramid import DensityMemo, agg_enabled

        if not agg_enabled() or not self._memoizable(query):
            return
        if not self._shortcuts_ok(name, self.get_schema(name)):
            return  # a grid under labels or age-off is the caller's alone
        if set(query.hints) & set(AGGREGATION_HINTS) != {"density"}:
            return
        grid = (result.aggregate or {}).get("density")
        key = self._density_key(name, query)
        if grid is None or key is None:
            return
        self._agg_cache_obj().put(key, DensityMemo(np.asarray(grid)))

    def aggregate(self, name: str, query: Union[str, Query] = "INCLUDE",
                  columns: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        """The exact matching-row count and, per numeric column of
        ``columns``, its non-null count, sum, min and max (the reference's
        ``aggregate``): ``{"count": n, "columns": {c: {"count", "sum",
        "min", "max"}}}``. A spatial-only z2 filter answers from the
        aggregate pyramid (interior partial sums and the exact boundary
        ring), anything else from the ordinary exact query. Counts, integer
        sums, min and max are the same either way; float sums may differ
        in the last place (summation order). Runs under the query's budget
        and one admission slot."""
        from geomesa_tpu_torch.ops.pyramid import AggError

        ft = self.get_schema(name)
        q = self._as_query(query)
        cols = list(columns or [])
        for c in cols:
            a = next((a for a in ft.attributes if a.name == c), None)
            if a is None:
                raise AggError(f"unknown column {c!r}")
            dt = a.type.numpy_dtype
            if dt is None or np.dtype(dt).kind not in "iufb":
                raise AggError(f"column {c!r} is not numeric")
        t0 = time.perf_counter()
        root = trace.NOOP
        ptok = plans_mod.begin()
        try:
            with trace.span("query.aggregate", force=self.slow_query_s is not None,
                            type=name) as root:
                try:
                    with deadline_mod.budget(self.query_timeout_s):
                        with self.admission.admit(priority=admission_mod.classify(q.hints)):
                            got = self._aggregate_pyramid(name, ft, q, cols)
                            if got is None:
                                # the exact fallback (the slot and the budget
                                # are reentrant); its inner query audits
                                # itself as a query
                                res = self.query(name, q)
                                got = _aggregate_columns(ft, res.columns, cols)
                                path = "agg-exact-fallback"
                            else:
                                path = "agg-pyramid"
                                plans_mod.note("pyramid", "hit")
                                if root.recording:
                                    root.set_attr("agg.cache", "hit")
                            if root.recording:
                                root.set_attr("scan_path", path)
                            # the aggregate class of the SLO engine: one
                            # counter and timer a call
                            if self.metrics is not None:
                                self.metrics.inc("queries.aggregate")
                                self.metrics.update_timer("query.aggregate",
                                                          time.perf_counter() - t0)
                            if plans_mod.enabled():
                                self._plans_obj().observe(
                                    "aggregate", name, query=q, scan_path=path, outcome="ok",
                                    hits=int(got.get("count", 0)),
                                    duration_s=time.perf_counter() - t0)
                            self._observe_workload("aggregate", name, query=q, outcome="ok",
                                                   duration_s=time.perf_counter() - t0,
                                                   rows=int(got.get("count", 0)))
                            return got
                except (QueryTimeout, ShedLoad) as e:
                    outcome = "timeout" if isinstance(e, QueryTimeout) else "shed"
                    if root.recording:
                        root.set_attr("outcome", outcome)
                    if self.metrics is not None:
                        self.metrics.inc("queries.aggregate")
                        self.metrics.inc(f"queries.aggregate.{outcome}")
                    if plans_mod.enabled():
                        self._plans_obj().observe("aggregate", name, query=q, outcome=outcome,
                                                  duration_s=time.perf_counter() - t0)
                    self._observe_workload("aggregate", name, query=q, outcome=outcome,
                                           duration_s=time.perf_counter() - t0)
                    raise
        finally:
            plans_mod.end(ptok)
            self._log_slow_query(name, None, root)

    def _aggregate_pyramid(self, name, ft, q: Query, cols: List[str]) -> Optional[Dict[str, Any]]:
        from geomesa_tpu_torch.ops.pyramid import BUILD_FAULTS

        if q.max_features is not None or q.hints:
            return None
        plan = self._plan_cached(name, q)
        got = self._pyramid_classify(name, ft, q, plan)
        if got is None:
            return None
        pyr, interior, cells, imask = got
        try:
            pyr.ensure_columns(self._tables[name]["z2"], ft, cols)
        except BUILD_FAULTS as e:
            _degrade_agg(e)
            return None
        parts = (self._agg_boundary_parts(name, ft, plan, pyr.cell_ranges(cells))
                 if len(cells) else [])
        out: Dict[str, Any] = {"count": interior + sum(len(r) for _b, r in parts), "columns": {}}
        for c in cols:
            g = pyr.col_grids[c]
            occupied = imask & (g["count"] > 0)
            cnt = int(g["count"][imask].sum())
            total = g["sum"][imask].sum()
            mn = g["min"][occupied].min() if occupied.any() else np.inf
            mx = g["max"][occupied].max() if occupied.any() else -np.inf
            for block, rows in parts:
                v = block.gather(c, rows)
                nulls = np.asarray(block.gather(c + "__null", rows), dtype=bool)
                vv = np.asarray(v)[~nulls]
                if len(vv):
                    cnt += len(vv)
                    total = total + vv.sum()
                    mn = min(mn, float(vv.min()))
                    mx = max(mx, float(vv.max()))
            out["columns"][c] = _column_summary(ft, c, cnt, total, mn, mx)
        return out

    def query_many(self, name: str, queries: Sequence[Union[str, Query]]) -> List[QueryResult]:
        """Execute many queries with PIPELINED device dispatch: phase 1 plans
        every query and starts its device work (exact-shape plans on one
        table fuse into one batched launch); phase 2 resolves and
        post-filters in order. Results are positionally identical to
        ``[query(name, q) for q in queries]``. Density and stats queries are
        left out of the dispatch: their push-downs launch their own kernels
        (and one that declines scans alone). The batch runs under one
        ``query.batch`` root; each query resolves under a ``query`` span of
        its own and is audited like a solo query."""
        ft = self.get_schema(name)
        qs = [self._as_query(q) for q in queries]
        batch = trace.NOOP
        try:
            with trace.span("query.batch", force=self.slow_query_s is not None, type=name,
                            n=len(qs)) as batch:
                # one admission slot for the batch (its queries share one
                # pipeline and must not wait on their own batchmates),
                # classed as its most important query; the queue wait is
                # bounded by one budget
                batch_pri = min((admission_mod.classify(q.hints) for q in qs),
                                key=admission_mod.PRIORITIES.index, default=None)
                with self.admission.admit(self.query_timeout_s, batch_pri):
                    with devstats.collecting() as shared:
                        results = self._query_many_planned(name, ft, qs)
                    if batch.recording:
                        batch.set_attr("device", devstats.receipt_of(shared))
                    return results
        finally:
            self._log_slow_batch(name, batch)

    def _query_many_planned(self, name, ft, qs: List[Query]) -> List[QueryResult]:
        plan_s: List[float] = []
        plans: List[QueryPlan] = []
        # the shared phase (planning and the batched dispatch) runs under
        # one budget, each query's resolve under its own
        with deadline_mod.budget(self.query_timeout_s):
            with record_function("geomesa.plan"):
                for q in qs:
                    t0 = time.perf_counter()
                    plans.append(self._plan_cached(name, q))
                    plan_s.append(time.perf_counter() - t0)
            pending: Dict[int, object] = {}
            dispatch_many = getattr(self.executor, "dispatch_many", None)
            if dispatch_many is not None:
                items = []
                for q, plan in zip(qs, plans):
                    if self._pushes_down(q):
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
                    except (QueryTimeout, KernelError):
                        raise
                    except Exception as e:
                        # the batched dispatch died mid-stream: every
                        # mirror goes and each query of the batch answers
                        # from the host table scan
                        self.executor.degrade(None, e)
                        from geomesa_tpu_torch.parallel.executor import HOST_DEGRADED

                        pending = dict.fromkeys(pending, HOST_DEGRADED)
        results = []
        for q, plan, dt in zip(qs, plans, plan_s):
            t_resolve = time.perf_counter()
            root = trace.NOOP
            ptok = plans_mod.begin()
            try:
                with trace.span("query", force=self.slow_query_s is not None, type=name,
                                batched=True) as root:
                    with deadline_mod.budget(self.query_timeout_s):
                        with devstats.collecting() as own:
                            result = self._execute(name, ft, q, plan, pending)
                        receipt = result.receipt = devstats.receipt_of(own)
                        if root.recording:
                            root.set_attr("hits", len(result))
                            root.set_attr("scan_path", _audit_path(result))
                            root.set_attr("device", receipt)
                        if self._auditing():
                            self._audit(name, q, plan, result, t_resolve - dt, t_resolve,
                                        receipt)
            finally:
                plans_mod.end(ptok)
                self._log_slow_query(name, plan, root)
            results.append(result)
        return results

    def _execute(self, name, ft, query: Query, plan: QueryPlan, pending=None) -> QueryResult:
        """route -> scan -> merge. The aggregate cache answers first where it
        can (a memoized density grid, a ``Count()`` stats query from the
        pyramid); a density or stats query of one plan, unsampled and
        untransformed, then tries the device push-down; every density grid
        computed is memoized."""
        if plan.is_empty:
            empty = _empty_columns(ft)
            agg = run_aggregation(ft, query.hints, empty) if has_aggregation(query.hints) else None
            return QueryResult(ft, empty, plan, agg, scan_path="empty")
        got = self._agg_shortcut(name, ft, query, plan)
        if got is not None:
            return got
        aggs = set(query.hints) & set(AGGREGATION_HINTS)
        # an aging type's push-downs would count expired rows: the host
        # reducer answers (labelled tables: the executor declines)
        pushable = (plan.union is None and not query.hints.get("sampling")
                    and _untransformed(query) and self._age_off_cutoff(ft) is None)
        # a push-down that degraded or met an open circuit: the host table
        # scan answers, under its label
        host: Optional[HostRoute] = None
        if pushable and aggs == {"density"}:
            density_scan = getattr(self.executor, "density_scan", None)
            grid = None
            if density_scan is not None:
                table = self._tables[name][plan.index.name]
                grid = self.executor.push_down(table, density_scan, table, plan,
                                               query.hints["density"])
            if isinstance(grid, HostRoute):
                host = grid
                _push_down_declined(grid, "density_to_host")
            elif grid is not None:
                plan.scan_path = "device-density"
                result = QueryResult(ft, _empty_columns(ft), plan, {"density": grid},
                                     scan_path=plan.scan_path)
                self._agg_density_fill(name, query, result)
                return result
        if pushable and aggs == {"stats"}:
            stats_scan = getattr(self.executor, "stats_scan", None)
            stat = None
            if stats_scan is not None:
                table = self._tables[name][plan.index.name]
                stat = self.executor.push_down(table, stats_scan, table, plan, query.hints["stats"])
            if isinstance(stat, HostRoute):
                host = stat
                _push_down_declined(stat, "stats_to_host")
            elif stat is not None:
                plan.scan_path = "device-stats"
                return QueryResult(ft, _empty_columns(ft), plan, {"stats": stat},
                                   scan_path=plan.scan_path)
        parts: List[tuple] = []
        labels: List[str] = []
        for arm in self._route(plan):
            parts.extend(self._scan_parts(name, ft, arm, pending, labels, host))
        with trace.span("query.assemble"), record_function("geomesa.assemble"):
            columns = _columns_from_parts(ft, query, parts)
            if plan.union is not None:
                columns = _dedupe_by_fid(_materialize(columns))
            result = _finish(ft, query, plan, columns)
        # this query's own routes: a cached plan object is shared by the
        # concurrent queries of one filter, whose routes may differ
        result.scan_path = "+".join(sorted(set(labels)))
        self._agg_density_fill(name, query, result)
        return result

    def _route(self, plan: QueryPlan) -> List[QueryPlan]:
        """Decompose a plan into independently scannable units: the
        cross-index union arms, or the plan itself."""
        if plan.union is not None:
            return [arm for arm in plan.union if not arm.is_empty]
        return [plan]

    def _scan_parts(self, name, ft, plan: QueryPlan, pending=None,
                    labels: Optional[List[str]] = None,
                    host: Optional[HostRoute] = None) -> List[tuple]:
        """Scan one plan into (block, final rows) parts; its route goes to
        ``plan.scan_path`` and ``labels``. ``host`` (a push-down that
        degraded or met an open circuit) sends the plan to the host table
        scan under that route. A scan that fails while it resolves degrades
        the query to the host table scan (``host-table-degraded``, the
        reference's ``_scan_parts``): identical rows, since the host path
        evaluates the full filter; a device scan resolved end to end closes
        a half-open circuit. The work runs under a ``scan`` span."""
        table = self._tables[name][plan.index.name]
        with trace.span("scan", index=plan.index.name) as sp:
            if host is not None:
                scan = host
            elif pending is not None and id(plan) in pending:
                scan = pending[id(plan)]  # pre-dispatched (query_many, the coalescer)
            else:
                scan = self.executor.scan_candidates(table, plan)
            label = _scan_label(scan)
            try:
                if scan is None or isinstance(scan, HostRoute):
                    return self._host_parts(ft, plan, table)
                try:
                    parts = self._consume(ft, plan, scan, scan.exact)
                except (QueryTimeout, KernelError):
                    raise
                except Exception as e:
                    self.executor.degrade(table, e)
                    label = "host-table-degraded"
                    return self._host_parts(ft, plan, table)
                if label.startswith("device"):
                    self.executor.record_device_success()
                return parts
            finally:
                plan.scan_path = label
                sp.set_attr("scan_path", label)
                if labels is not None:
                    labels.append(label)

    def _host_parts(self, ft, plan: QueryPlan, table) -> List[tuple]:
        """The host table scan of one plan: its ranges (or every row), the
        full filter."""
        rows = table.scan(plan.ranges) if plan.ranges else table.scan_all()
        return self._consume(ft, plan, rows, False)

    def _consume(self, ft, plan: QueryPlan, scan, exact: bool) -> List[tuple]:
        """Post-filter each (block, rows) candidate set with the full
        filter, unless the scan evaluated the query's own predicate; the
        age-off window and the visibility check apply to every scan. A host
        seek's (block, rows, covered) triples take the covered split. Each
        block runs under a ``scan.block`` span (``rows_in``, ``rows_out``:
        a device route's candidates or hits, then the rows kept) and folds
        its counts into the plan-telemetry scope."""
        pf_props = (
            set(ast.properties(plan.post_filter))
            if plan.post_filter is not None and not exact
            else None
        )
        age_cutoff = self._age_off_cutoff(ft)
        parts = []
        for item in scan:
            block, rows = item[0], item[1]
            covered = item[2] if len(item) == 3 else None
            rows_in = len(rows)
            with trace.span("scan.block", rows_in=rows_in) as bsp:
                if covered is not None and pf_props is not None and covered.any():
                    rows = self._filter_block_covered(ft, plan, block, rows, covered,
                                                      age_cutoff, pf_props)
                else:
                    alive = self._age_off_keep(ft, block, rows, age_cutoff)
                    if alive is not None:
                        rows = rows[alive]
                    if pf_props is not None and len(rows):
                        with record_function("geomesa.post_filter"):
                            fcols = _gather_filter_cols(block, rows, pf_props)
                            with trace.span("scan.post_filter", rows=len(rows)):
                                mask = self.executor.post_filter(ft, plan, fcols)
                        if not mask.all():
                            rows = rows[mask]
                    vmask = self._visibility_keep(block, rows)
                    if vmask is not None:
                        rows = rows[vmask]
                bsp.set_attr("rows_out", len(rows))
            plans_mod.note_scan(rows_in, len(rows))
            if len(rows):
                parts.append((block, rows))
        return parts

    def _filter_block_covered(self, ft, plan: QueryPlan, block, rows, covered, age_cutoff,
                              pf_props) -> np.ndarray:
        """Covered-split filtering of one block (the reference's
        ``_filter_block_covered``): rows of ``contained`` ranges satisfy the
        plan's primary predicate, so the full post-filter runs only on the
        uncovered rest and covered rows take just the residual secondary;
        the age-off window first, the visibility check last."""
        from geomesa_tpu_torch.filter.evaluate import evaluate

        alive = self._age_off_keep(ft, block, rows, age_cutoff)
        if alive is not None:
            rows = rows[alive]
            covered = covered[alive]
        keep = covered.copy()
        with record_function("geomesa.post_filter"):
            uncov = np.flatnonzero(~covered)
            if len(uncov):
                fcols = _gather_filter_cols(block, rows[uncov], pf_props)
                with trace.span("scan.post_filter", rows=len(uncov)):
                    keep[uncov] = self.executor.post_filter(ft, plan, fcols)
            if plan.secondary is not None:
                cov = np.flatnonzero(covered)
                scols = _gather_filter_cols(
                    block, rows[cov], set(ast.properties(plan.secondary)))
                keep[cov] = evaluate(plan.secondary, ft, scols)
        if not keep.all():
            rows = rows[keep]
        vmask = self._visibility_keep(block, rows)
        return rows if vmask is None else rows[vmask]


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
    None = the executor declined and the host table scan ran; a
    ``HostRoute`` names why the host answers). Device scans carry a suffix
    for the wire format: ``/mask`` (the coalescer's full-table planes),
    ``/bitmap`` (span-framed bitmaps) or ``/runs``."""
    if scan is None:
        return "host-table"
    if isinstance(scan, HostRoute):
        return scan.label
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
    fmt = "mask" if "Mask" in pname else "bitmap" if "Bitmap" in pname else "runs"
    return f"{base}/{fmt}"


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
    superset of the projection: sort and sampling read the result's
    columns (the reference's ``_output_columns``)."""
    props = query.properties
    if props is None or has_aggregation(query.hints):
        return None
    if any("=" in p for p in props):
        return None  # derived transforms read arbitrary source columns
    out = set(props)
    if query.sort_by:
        out.update(a for a, _ in query.sort_by)
    sample_by = query.hints.get("sample_by")
    if sample_by:
        out.add(sample_by)
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
    """The reference's ``_finish``. An aggregating query samples its rows,
    applies its transform (the reducer sees the derived schema) and runs
    the host reducer; a plain stream (no sort, limit, sampling or
    transform) keeps the lazy mapping, already restricted to its keys,
    under the projection's narrowed type; anything else materializes and
    takes ``apply_projection``."""
    from geomesa_tpu_torch.index.transforms import QueryTransforms

    if has_aggregation(query.hints):
        columns = _apply_sampling(query, _materialize(columns))
        tf = QueryTransforms.parse(ft, query.properties)
        if tf is not None:
            ft, columns = tf.apply(columns)
        return QueryResult(ft, _empty_columns(ft), plan, run_aggregation(ft, query.hints, columns))
    if (
        isinstance(columns, LazyColumns)
        and not query.sort_by
        and query.max_features is None
        and not query.hints.get("sampling")
        and _untransformed(query)
    ):
        if query.properties is not None:
            ft = _narrow_ft(ft, query.properties)
        return QueryResult(ft, columns, plan)
    ft, columns = apply_projection(ft, query, _materialize(columns))
    return QueryResult(ft, columns, plan)


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


def _degrade_agg(e: BaseException) -> None:
    """A pyramid build that degraded (an injected ``agg.build`` fault or a
    failed device build): the aggregation answers from the uncached exact
    scan (the reference's ``degrade.agg_to_scan`` and its
    ``build_degraded`` decision)."""
    robustness_metrics().inc("degrade.agg_to_scan")
    trace.event("degrade.agg_to_scan", reason=f"{type(e).__name__}: {e}")
    audit_mod.decision("pyramid", "build_degraded", error=type(e).__name__)


def _push_down_declined(route: HostRoute, reason: str) -> None:
    """A count, stats or density push-down whose device call failed (the
    host answers): the reference's ``degrade`` decision of that push-down.
    An open circuit (``host-table-breaker``) crossed no device boundary
    and records none."""
    if route.label == "host-table-degraded":
        audit_mod.decision("degrade", reason, route=route.label)


def _audit_path(result: "QueryResult") -> str:
    """The route a query's audit, fingerprint and root span carry: its own
    ``scan_path``, "" for an empty plan (which the reference leaves
    unlabelled)."""
    return "" if result.scan_path == "empty" else result.scan_path


# span attributes an EXPLAIN ANALYZE stage row carries: provenance and row
# counts, not free-form payloads
_STAGE_ATTRS = ("index", "scan_path", "type", "cost", "n_ranges", "union_arms", "rows_in",
                "rows_out", "rows", "hits", "coalesced", "n", "shards")


def _stage_tree(sp) -> Dict[str, Any]:
    """One span subtree as an EXPLAIN ANALYZE stage row: wall and self
    times, the provenance attributes, decision / degrade / fault events and
    the nested stages."""
    out: Dict[str, Any] = {
        "stage": sp.name,
        "duration_ms": round(sp.duration_ms, 3),
        "self_ms": round(sp.self_time_ms, 3),
    }
    attrs = {k: sp.attributes[k] for k in _STAGE_ATTRS if k in sp.attributes}
    if attrs:
        out["attrs"] = attrs
    events = [{k: v for k, v in ev.items() if k != "t_ms"} for ev in sp.events
              if ev["name"].startswith(("decision.", "degrade.", "fault."))]
    if events:
        out["events"] = events
    if sp.children:
        out["stages"] = [_stage_tree(c) for c in sp.children]
    return out


def attribution(root) -> Dict[str, Any]:
    """How much of a root span's wall its named stages explain: the sum of
    the self times of every span below the root over the root's duration
    (clamped at 1.0: concurrent stages can sum past the wall)."""
    attributed = sum(s.self_time_ms for s in root.walk() if s is not root)
    return {
        "attributed_ms": round(attributed, 3),
        "total_ms": round(root.duration_ms, 3),
        "fraction": (round(min(attributed / root.duration_ms, 1.0), 4)
                     if root.duration_ms > 0 else 1.0),
    }


def _count_only_stats(spec):
    """The parsed stat when ``spec`` holds ``Count()`` stats alone (the
    pyramid answers those exactly), else None: per-value sketches cannot
    be rebuilt from per-cell scalars."""
    from geomesa_tpu_torch.stats.parser import parse_stat
    from geomesa_tpu_torch.stats.sketches import CountStat

    try:
        stat = parse_stat(spec)
    except Exception:  # noqa: BLE001 - a malformed spec: run_stats raises it
        return None
    stats = stat.stats if hasattr(stat, "stats") else [stat]
    if not stats or not all(isinstance(st, CountStat) for st in stats):
        return None
    return stat


def _column_summary(ft, col, cnt, total, mn, mx):
    """One column's aggregate, the same from the pyramid and the fallback:
    integer-backed columns report integer sums, floats float sums, an
    all-null column None bounds."""
    a = next((a for a in ft.attributes if a.name == col), None)
    int_backed = (
        a is not None
        and a.type.numpy_dtype is not None
        and np.dtype(a.type.numpy_dtype).kind in "iub"
    )
    return {
        "count": int(cnt),
        "sum": int(total) if int_backed else float(total),
        "min": float(mn) if cnt else None,
        "max": float(mx) if cnt else None,
    }


def _aggregate_columns(ft, columns, cols) -> Dict[str, Any]:
    """The exact aggregate of already-filtered result columns: the uncached
    answer the pyramid's must equal."""
    n = getattr(columns, "num_rows", None)
    if n is None:
        n = len(next(iter(columns.values()), []))
    out: Dict[str, Any] = {"count": int(n), "columns": {}}
    for c in cols:
        v = np.asarray(columns[c])
        nulls = columns.get(c + "__null")
        if nulls is not None:
            v = v[~np.asarray(nulls, dtype=bool)]
        cnt = len(v)
        total = v.sum() if cnt else 0
        mn = float(v.min()) if cnt else np.inf
        mx = float(v.max()) if cnt else -np.inf
        out["columns"][c] = _column_summary(ft, c, cnt, total, mn, mx)
    return out


def _narrow_ft(ft: FeatureType, props: Sequence[str]) -> FeatureType:
    """The result type narrowed to a projection, like the reference's
    transform schema: consumers of ``result.ft`` see only the present
    attributes (and no date binding to a projected-away one)."""
    keep = set(props)
    user_data = dict(ft.user_data)
    if user_data.get("geomesa.index.dtg") not in keep:
        user_data.pop("geomesa.index.dtg", None)
    return FeatureType(ft.name, [a for a in ft.attributes if a.name in keep], user_data)


def _apply_sampling(query: Query, columns: Columns) -> Columns:
    """``hints["sampling"]`` = a fraction in (0, 1]: every n-th row, n =
    round(1 / fraction); with ``hints["sample_by"]`` every n-th row of each
    of that attribute's values (the SamplingIterator / FeatureSampler
    analog)."""
    frac = query.hints.get("sampling")
    if not frac or frac >= 1.0:
        return columns
    n = len(next(iter(columns.values()), []))
    if n == 0:
        return columns
    nth = max(1, int(round(1.0 / float(frac))))
    by = query.hints.get("sample_by")
    keep = np.zeros(n, dtype=bool)
    if by and by in columns:
        col = columns[by]
        for v in np.unique(col):
            keep[np.flatnonzero(col == v)[::nth]] = True
    else:
        keep[::nth] = True
    return {k: v[keep] for k, v in columns.items()}


def apply_projection(ft: FeatureType, query: Query, columns: Columns):
    """Sampling, sort, limit and projection, derived attributes included
    (``out=EXPR`` properties, QueryPlanner.scala:192-284) -> (the result
    type, the projected columns)."""
    from dataclasses import replace

    from geomesa_tpu_torch.index.transforms import QueryTransforms

    tf = QueryTransforms.parse(ft, query.properties)
    if tf is None:
        columns = _apply_query_options(query, columns)
        if query.properties is not None:
            keep = set(query.properties)
            ft = _narrow_ft(ft, query.properties)
            columns = {k: v for k, v in columns.items()
                       if k.startswith("__") or _column_base(k) in keep}
        return ft, columns
    # sampling, sort and limit read the stored attributes; the projection
    # must not run first (the expressions read their source columns)
    columns = _apply_query_options(replace(query, properties=None), columns)
    return tf.apply(columns)


def _apply_query_options(query: Query, columns: Columns) -> Columns:
    """Sampling, sort, limit and projection (the reference's
    ``_apply_query_options``)."""
    columns = _apply_sampling(query, columns)
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
