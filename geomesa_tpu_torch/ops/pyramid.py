"""The aggregate pyramid cache: counts and column aggregates of hot regions
from interior partial sums plus the exact boundary ring.

Port of ``geomesa_tpu/ops/pyramid.py`` (the GeoBlocks idea, PAPERS.md):
repeated dashboard aggregations (count, Count() stats, ``aggregate()``
column summaries, density grids) stop sweeping every candidate segment and
answer from pre-aggregated blocks, scanning only the query's boundary ring.

Structure: an ``AggPyramid`` per feature type is a stack of z2-gridded
count levels. The finest is a ``2^bits x 2^bits`` grid over the world
(``geomesa.agg.cell.bits``, clamped to [2, 12]); each level above halves
it (``geomesa.agg.levels``). A row's cell is its z2 key's integer grid
coordinate shifted down: exact integer arithmetic shared by the device
build (``TorchScanExecutor.pyramid_counts``, the ``pyramid_counts`` kernel
over the z2 segment mirrors), the host build (``host_counts``, z2_decode
of the same keys) and the classification, so all three agree bit for bit.
Per consumed column the pyramid adds, lazily, finest-level sum / min / max
/ non-null count grids (``ensure_columns``, numpy on the host).

Exactness: ``classify`` splits a query's geometries into INTERIOR cells
(every row binned there satisfies the exact f64 predicate), BOUNDARY cells
and outside cells, conservatively only:

  * rectangles by monotonicity: ``normalize`` is monotone, so cells
    strictly between the cells of the box's own normalized bounds hold
    only rows strictly inside the box;
  * polygons by a hierarchical descent over widened cell rectangles
    (``_EPS_DEG`` dominates every f64 rounding of the bin arithmetic): a
    cell no edge touches is wholly inside or outside by one center test,
    a touched cell recurses and bottoms out as boundary.

Interior cells answer from the partial sums; each boundary cell is one
contiguous z2 key range (``cell_ranges``), which the store seeks and
post-filters with the plan's own filter.

Caching: pyramids and density memos live in a per-store ``AggCache``, a
TTL'd LRU keyed by (kind, type, schema generation, knobs) and bounded in
bytes (``geomesa.agg.cache.bytes``); an entry's device copies go with it.
A write moves the type's generation and drops its entries.

Failure envelope: ``agg.build`` is a fault point (``utils/faults.py``)
paired with a span and a deadline check; an injected fault there degrades
the aggregation to the uncached exact scan with identical answers. The
device count runs under the executor's breaker (``push_down``): while the
circuit is open the build counts on the host (``host_counts``, bit for
bit the same), and a failed device count degrades the executor (its
mirror evicted) and raises ``DeviceBuildFailed``, which the store degrades
to the uncached scan as it does an injected fault. The reference's
``/debug/device`` web endpoint is not ported; ``agg_debug`` returns its
block.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.curve.zorder import z2_decode, z2_encode
from geomesa_tpu_torch.geom.base import Geometry, MultiPolygon, Polygon
from geomesa_tpu_torch.utils import deadline, faults, trace
from geomesa_tpu_torch.utils.devstats import devstats_metrics

# the z2 curve's bits per dimension; pyramid cells are its grid
# coordinates shifted down
Z2_BITS = 31

# widening (degrees) of the polygon cell-rectangle tests: the f64 bin
# arithmetic is exact to ~1e-12 deg at world scale; 1e-9 dominates it and
# only ever moves borderline cells from interior to boundary
_EPS_DEG = 1e-9

# cell classes (uint8 grid)
OUTSIDE, INTERIOR, BOUNDARY = 0, 1, 2

# classifications kept per pyramid (LRU): a repeated region reuses its
# interior sums and boundary ring
CLASSIFY_MEMO_CAP = 64

# cells per [cells x edges] overlap test, to bound its memory
_CLASSIFY_CHUNK = 1024

# the live caches, for agg_debug's entry and byte sums
_CACHES: "weakref.WeakSet" = weakref.WeakSet()
_CACHES_LOCK = threading.Lock()
_LAST_BUILD: Dict[str, Any] = {}
_LAST_BUILD_LOCK = threading.Lock()

class DeviceBuildFailed(RuntimeError):
    """The build's device count failed (the executor degraded already)."""


# what the agg.build fault point and a failed device count raise; the store
# degrades these (and only these) to the uncached scan
BUILD_FAULTS = (faults.InjectedFault, faults.InjectedDrop, DeviceBuildFailed)


class AggError(ValueError):
    """Bad aggregate request (unknown column, non-numeric column)."""


def agg_enabled() -> bool:
    """The cache's escape hatch (``geomesa.agg.enabled``): off, every
    aggregation takes the ordinary uncached paths (identical answers)."""
    from geomesa_tpu_torch.utils.config import AGG_ENABLED

    got = AGG_ENABLED.to_bool()
    return True if got is None else got


def agg_knobs() -> Tuple[int, int, float, int]:
    """(cell_bits, levels, ttl_s, cache_cap_bytes), read at each call."""
    from geomesa_tpu_torch.utils.config import (
        AGG_CACHE_BYTES,
        AGG_CACHE_TTL,
        AGG_CELL_BITS,
        AGG_LEVELS,
    )

    def val(prop, default):
        got = prop.to_int()
        return default if got is None else got

    bits = min(12, max(2, val(AGG_CELL_BITS, 8)))
    levels = min(bits - 1, max(1, val(AGG_LEVELS, 3)))
    ttl = AGG_CACHE_TTL.to_duration_s(600.0)
    cap = AGG_CACHE_BYTES.to_bytes()
    if cap is None:
        cap = 64 << 20
    return bits, levels, ttl, cap


def could_have_interior(geoms: List[Geometry], bits: int) -> bool:
    """The gate before a build: whether some geometry's envelope spans at
    least 3 finest cells in both axes. Below that no cell can be interior,
    so the cost model would decline after paying the whole build."""
    n = 1 << bits
    cw, ch = 360.0 / n, 180.0 / n
    for g in geoms:
        env = g.envelope
        if (env.xmax - env.xmin) >= 3.0 * cw and (env.ymax - env.ymin) >= 3.0 * ch:
            return True
    return False


# -- build --------------------------------------------------------------------


def host_counts(table, ft, bits: int) -> np.ndarray:
    """[H, W] int64 per-cell row counts from the host index table: the same
    key decode and shifts as the device build, null geometries excluded
    (their lenient keys are clipped into a cell)."""
    n = 1 << bits
    shift = Z2_BITS - bits
    geom = ft.default_geometry.name
    grid = np.zeros(n * n, dtype=np.int64)
    for b, rows in table.scan_all():
        if not len(rows):
            continue
        xi, yi = z2_decode(b.key[rows])
        x = np.asarray(b.gather(geom + "__x", rows), dtype=np.float64)
        y = np.asarray(b.gather(geom + "__y", rows), dtype=np.float64)
        ok = np.isfinite(x) & np.isfinite(y)
        flat = ((yi >> shift) * n + (xi >> shift))[ok]
        grid += np.bincount(flat, minlength=n * n)
    return grid.reshape(n, n)


def build_pyramid(table, ft, executor=None) -> "AggPyramid":
    """One type's pyramid, under the ``agg.build`` span, deadline check and
    fault point. The counts come from the executor's ``pyramid_counts``
    (the device kernel over the z2 mirrors, under the executor's
    ``push_down`` breaker envelope) where it answers, else from
    ``host_counts`` (no executor, or an open circuit). An
    injected fault or a failed device count raises one of
    ``BUILD_FAULTS``."""
    from geomesa_tpu_torch.parallel.executor import HOST_DEGRADED, HostRoute

    bits, levels, _ttl, _cap = agg_knobs()
    reg = devstats_metrics()
    t0 = time.perf_counter()
    with trace.span("agg.build", type=ft.name, bits=bits, levels=levels):
        deadline.check("agg.build")
        faults.fault_point("agg.build")
        counts0 = None
        if executor is not None:
            counts0 = executor.push_down(table, executor.pyramid_counts, table, bits)
            if counts0 is HOST_DEGRADED:
                raise DeviceBuildFailed("the device count of the pyramid failed")
            if isinstance(counts0, HostRoute):
                counts0 = None  # an open circuit: the host counts
        if counts0 is None:
            counts0 = host_counts(table, ft, bits)
        counts = [np.asarray(counts0, dtype=np.int64)]
        for _ in range(1, levels):
            g = counts[-1]
            if g.shape[0] < 2:
                break
            counts.append(g.reshape(g.shape[0] // 2, 2, g.shape[1] // 2, 2).sum(axis=(1, 3)))
        pyr = AggPyramid(table.index.sfc(ft), ft, counts)
        if executor is not None:
            got = executor.push_down(table, pyr.ensure_device, executor.device)
            if got is HOST_DEGRADED:
                raise DeviceBuildFailed("the pyramid's device copies failed")
    reg.inc("agg.cache.builds")
    reg.update_timer("agg.build", time.perf_counter() - t0)
    with _LAST_BUILD_LOCK:
        _LAST_BUILD.clear()
        _LAST_BUILD.update(pyr.stats)
    return pyr


class AggPyramid:
    """One type's pyramid: the count grids (``counts[0]`` finest), the
    lazily built per-column grids, the classification memo and the device
    copies of the count levels."""

    def __init__(self, sfc, ft, counts: List[np.ndarray]):
        self.sfc = sfc
        self.geom = ft.default_geometry.name
        self.counts = counts
        self.bits = int(counts[0].shape[0]).bit_length() - 1
        self.levels = len(counts)
        self.total_rows = int(counts[0].sum())
        self.built_at = time.time()
        self.last_used = self.built_at
        # column -> {"sum", "min", "max", "count"} finest-level grids
        self.col_grids: Dict[str, Dict[str, np.ndarray]] = {}
        self._queries: Dict[Any, tuple] = {}  # classification memo (LRU)
        self._lock = threading.Lock()
        self._dev: Optional[list] = None
        self._dev_lock = threading.Lock()
        self.stats = {
            "type": ft.name,
            "bits": self.bits,
            "levels": self.levels,
            "rows": self.total_rows,
            "cells": int(counts[0].size),
            "occupied": int((counts[0] > 0).sum()),
        }
        reg = devstats_metrics()
        reg.set_gauge("agg.pyramid.cells", int(counts[0].size))
        reg.set_gauge("agg.pyramid.rows", self.total_rows)

    @property
    def nbytes(self) -> int:
        n = sum(g.nbytes for g in self.counts)
        # a snapshot: ensure_columns inserts concurrently
        with self._lock:
            grids_list = list(self.col_grids.values())
        for grids in grids_list:
            n += sum(g.nbytes for g in grids.values())
        return n

    # -- device residency --------------------------------------------------

    def ensure_device(self, device):
        """The count levels as int32 tensors on ``device`` (uploaded once,
        through ``mesh.upload``, so receipts count them); evicted with the
        cache entry. Answers reduce the host grids; the device copies are
        the resident structure later device consumers read."""
        with self._dev_lock:
            if self._dev is None:
                from geomesa_tpu_torch.parallel.mesh import upload

                self._dev = [upload(g.astype(np.int32), device) for g in self.counts]
            return self._dev

    def evict_device(self) -> None:
        with self._dev_lock:
            self._dev = None

    # -- classification ----------------------------------------------------

    def _norm_cell(self, v: float, axis: str, bits: int) -> int:
        """The cell of one query-bound coordinate at ``bits``, through the
        index keys' own (monotone) normalize."""
        dim = self.sfc.lon if axis == "x" else self.sfc.lat
        n = int(dim.normalize(np.asarray([v], dtype=np.float64))[0])
        n = min(max(n, 0), dim.max_index)
        return n >> (Z2_BITS - bits)

    def _cell_rects(self, bits: int, cells: np.ndarray) -> np.ndarray:
        """[K, 4] widened degree rectangles of ``cells`` at ``bits``."""
        s = Z2_BITS - bits
        lon, lat = self.sfc.lon, self.sfc.lat
        sx = (lon.max - lon.min) / lon.bins
        sy = (lat.max - lat.min) / lat.bins
        cx = cells[:, 0].astype(np.int64)
        cy = cells[:, 1].astype(np.int64)
        out = np.empty((len(cells), 4), dtype=np.float64)
        out[:, 0] = lon.min + (cx << s) * sx - _EPS_DEG
        out[:, 1] = lat.min + (cy << s) * sy - _EPS_DEG
        out[:, 2] = lon.min + ((cx + 1) << s) * sx + _EPS_DEG
        out[:, 3] = lat.min + ((cy + 1) << s) * sy + _EPS_DEG
        return out

    def classify(self, geoms: List[Geometry], memo_key=None) -> tuple:
        """(interior_rows, boundary_rows, candidate_rows, boundary_cells,
        interior_mask) of a query's geometries: ``boundary_cells`` [K, 2]
        (cx, cy) of the occupied finest boundary cells, ``interior_mask``
        the finest bool grid the column aggregates reduce under. Memoized
        per ``memo_key`` (the filter's CQL)."""
        if memo_key is not None:
            with self._lock:
                got = self._queries.pop(memo_key, None)
                if got is not None:
                    self._queries[memo_key] = got  # LRU refresh
                    return got
        n0 = 1 << self.bits
        cls = np.zeros((n0, n0), dtype=np.uint8)
        for g in self._flatten(geoms):
            if g.is_rectangle():
                self._paint_rect(cls, g.envelope)
            elif isinstance(g, Polygon):
                self._paint_polygon(cls, g)
            else:
                # lines and points hold no area: no cell is interior
                self._paint_cover_boundary(cls, g.envelope)
        c0 = self.counts[0]
        interior_mask = cls == INTERIOR
        interior_rows = int(c0[interior_mask].sum())
        boundary_rows = int(c0[cls == BOUNDARY].sum())
        by, bx = np.nonzero(cls == BOUNDARY)
        boundary_cells = np.stack([bx, by], axis=1).astype(np.int64)
        # empty boundary cells need no scan range
        boundary_cells = boundary_cells[c0[by, bx] > 0]
        got = (interior_rows, boundary_rows, interior_rows + boundary_rows, boundary_cells,
               interior_mask)
        if memo_key is not None:
            with self._lock:
                self._queries[memo_key] = got
                while len(self._queries) > CLASSIFY_MEMO_CAP:
                    self._queries.pop(next(iter(self._queries)))
        return got

    @staticmethod
    def _flatten(geoms: List[Geometry]) -> List[Geometry]:
        out: List[Geometry] = []
        for g in geoms:
            if isinstance(g, MultiPolygon):
                out.extend(g.geoms)
            else:
                out.append(g)
        return out

    def _cover(self, env, bits: int) -> Tuple[int, int, int, int]:
        return (self._norm_cell(env.xmin, "x", bits), self._norm_cell(env.xmax, "x", bits),
                self._norm_cell(env.ymin, "y", bits), self._norm_cell(env.ymax, "y", bits))

    def _paint_rect(self, cls: np.ndarray, env) -> None:
        """The box's rim cells are boundary (never over another geometry's
        interior), the cells strictly inside interior."""
        c0, c1, r0, r1 = self._cover(env, self.bits)
        sub = cls[r0:r1 + 1, c0:c1 + 1]
        sub[sub == OUTSIDE] = BOUNDARY
        if r1 - r0 >= 2 and c1 - c0 >= 2:
            cls[r0 + 1:r1, c0 + 1:c1] = INTERIOR

    def _paint_cover_boundary(self, cls: np.ndarray, env) -> None:
        c0, c1, r0, r1 = self._cover(env, self.bits)
        sub = cls[r0:r1 + 1, c0:c1 + 1]
        sub[sub == OUTSIDE] = BOUNDARY

    def _paint_polygon(self, cls: np.ndarray, poly: Polygon) -> None:
        """Hierarchical descent from the coarsest level over the envelope's
        cover: cells no edge touches resolve by one center test, touched
        cells recurse and end as finest boundary cells."""
        from geomesa_tpu_torch.geom.predicates import points_in_polygon

        rings = [np.asarray(poly.shell, dtype=np.float64)] + [
            np.asarray(h, dtype=np.float64) for h in (poly.holes or [])
        ]
        edges = np.concatenate(
            [np.concatenate([r[:-1], r[1:]], axis=1) for r in rings if len(r) >= 2]
        )  # [E, 4] (x0, y0, x1, y1)
        bits_l = self.bits - (self.levels - 1)
        c0, c1, r0, r1 = self._cover(poly.envelope, bits_l)
        gx, gy = np.meshgrid(np.arange(c0, c1 + 1, dtype=np.int64),
                             np.arange(r0, r1 + 1, dtype=np.int64))
        cells = np.stack([gx.ravel(), gy.ravel()], axis=1)
        while len(cells):
            rects = self._cell_rects(bits_l, cells)
            amb = np.zeros(len(cells), dtype=bool)
            for s0 in range(0, len(cells), _CLASSIFY_CHUNK):
                sl = slice(s0, s0 + _CLASSIFY_CHUNK)
                amb[sl] = _edges_overlap_rects(edges, rects[sl])
            clear = ~amb
            if clear.any():
                cx_mid = (rects[clear, 0] + rects[clear, 2]) * 0.5
                cy_mid = (rects[clear, 1] + rects[clear, 3]) * 0.5
                inside = points_in_polygon(cx_mid, cy_mid, poly)
                shift = self.bits - bits_l
                for (cx, cy) in cells[clear][inside]:
                    cls[cy << shift:(cy + 1) << shift, cx << shift:(cx + 1) << shift] = INTERIOR
            cells = cells[amb]
            if bits_l == self.bits:
                keep = cls[cells[:, 1], cells[:, 0]] != INTERIOR
                cls[cells[keep, 1], cells[keep, 0]] = BOUNDARY
                break
            # four children per ambiguous cell at the next level
            cx = cells[:, 0] * 2
            cy = cells[:, 1] * 2
            cells = np.stack(
                [np.stack([cx + dx, cy + dy], axis=1) for dx in (0, 1) for dy in (0, 1)], axis=0
            ).reshape(-1, 2)
            bits_l += 1

    # -- boundary ring -> scan ranges --------------------------------------

    def cell_ranges(self, cells: np.ndarray):
        """Boundary cells -> z2 key ranges (a cell is one contiguous z2
        span; z-adjacent cells merge), a ``RangeSet`` for
        ``IndexTable.scan``."""
        from geomesa_tpu_torch.index.keyspace import RangeSet

        if not len(cells):
            return RangeSet(np.empty(0, np.int64), np.empty(0, np.int64),
                            np.empty(0, np.int64), np.empty(0, bool))
        s = Z2_BITS - self.bits
        z = np.sort(z2_encode(cells[:, 0] << s, cells[:, 1] << s).astype(np.int64))
        span = np.int64(1) << np.int64(2 * s)
        gaps = np.flatnonzero(np.diff(z) != span)
        starts = np.concatenate([[0], gaps + 1])
        ends = np.concatenate([gaps, [len(z) - 1]])
        lower = z[starts]
        upper = z[ends] + span - 1
        return RangeSet(np.zeros(len(lower), dtype=np.int64), lower, upper,
                        np.zeros(len(lower), dtype=bool))

    # -- per-column aggregate grids ----------------------------------------

    def ensure_columns(self, table, ft, cols: List[str]) -> None:
        """Build the sum / min / max / count grids of the ``cols`` not yet
        built, in one table pass, under the same ``agg.build`` envelope as
        the count build. Integer-backed columns sum in int64 (exact),
        floats in f64."""
        with self._lock:
            missing = [c for c in cols if c not in self.col_grids]
        if not missing:
            return
        with trace.span("agg.build", type=ft.name, columns=len(missing)):
            deadline.check("agg.build")
            faults.fault_point("agg.build")
            self._build_columns(table, ft, missing)

    def _build_columns(self, table, ft, missing: List[str]) -> None:
        n = 1 << self.bits
        shift = Z2_BITS - self.bits
        geom = self.geom
        dtypes = {c: _sum_dtype(ft, c) for c in missing}
        acc = {
            c: {
                "sum": np.zeros(n * n, dtype=dtypes[c]),
                "min": np.full(n * n, np.inf),
                "max": np.full(n * n, -np.inf),
                "count": np.zeros(n * n, dtype=np.int64),
            }
            for c in missing
        }
        for b, rows in table.scan_all():
            deadline.check("agg.build")
            if not len(rows):
                continue
            xi, yi = z2_decode(b.key[rows])
            x = np.asarray(b.gather(geom + "__x", rows), dtype=np.float64)
            y = np.asarray(b.gather(geom + "__y", rows), dtype=np.float64)
            ok = np.isfinite(x) & np.isfinite(y)
            flat = (yi >> shift) * n + (xi >> shift)
            for c in missing:
                v = b.gather(c, rows)
                # a block without a __null companion gathers zeros
                nulls = b.gather(c + "__null", rows)
                m = ok & ~np.asarray(nulls, dtype=bool)
                if not m.any():
                    continue
                fl = flat[m]
                vv = np.asarray(v)[m]
                np.add.at(acc[c]["sum"], fl, vv.astype(dtypes[c], copy=False))
                vf = vv.astype(np.float64, copy=False)
                np.minimum.at(acc[c]["min"], fl, vf)
                np.maximum.at(acc[c]["max"], fl, vf)
                acc[c]["count"] += np.bincount(fl, minlength=n * n)
        with self._lock:
            for c in missing:
                self.col_grids[c] = {k: g.reshape(n, n) for k, g in acc[c].items()}


def _sum_dtype(ft, col: str):
    for a in ft.attributes:
        if a.name == col:
            dt = a.type.numpy_dtype
            if dt is not None and np.dtype(dt).kind in "iub":
                return np.int64
            return np.float64
    return np.float64


def _edges_overlap_rects(edges: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """[K] bool: whether some edge may cross each rectangle. Conservative:
    bounding boxes overlap and the rectangle's four corners are not all
    strictly on one side of the edge's line."""
    ax, ay, bx, by = edges[:, 0], edges[:, 1], edges[:, 2], edges[:, 3]
    rx0, ry0, rx1, ry1 = rects[:, 0], rects[:, 1], rects[:, 2], rects[:, 3]
    exmin = np.minimum(ax, bx)[None, :]
    exmax = np.maximum(ax, bx)[None, :]
    eymin = np.minimum(ay, by)[None, :]
    eymax = np.maximum(ay, by)[None, :]
    bbox = (
        (exmax >= rx0[:, None]) & (exmin <= rx1[:, None])
        & (eymax >= ry0[:, None]) & (eymin <= ry1[:, None])
    )
    dx = (bx - ax)[None, :]
    dy = (by - ay)[None, :]
    pos = neg = None
    for cx, cy in ((rx0, ry0), (rx0, ry1), (rx1, ry0), (rx1, ry1)):
        cross = dx * (cy[:, None] - ay[None, :]) - dy * (cx[:, None] - ax[None, :])
        if pos is None:
            pos, neg = cross > 0, cross < 0
        else:
            pos &= cross > 0
            neg &= cross < 0
    return (bbox & ~(pos | neg)).any(axis=1)


# -- density-grid memo --------------------------------------------------------


class DensityMemo:
    """One cached density grid (host f64): a repeated tile answers with no
    dispatch and the same grid, copied."""

    __slots__ = ("grid", "last_used", "built_at")

    def __init__(self, grid: np.ndarray):
        self.grid = np.array(grid, dtype=np.float64, copy=True)
        self.built_at = time.time()
        self.last_used = self.built_at

    @property
    def nbytes(self) -> int:
        return int(self.grid.nbytes)

    def evict_device(self) -> None:  # a host-only entry
        pass


# -- cache --------------------------------------------------------------------


class AggCache:
    """Per-store TTL'd LRU of pyramids and density memos, bounded in bytes.
    A generation move re-keys (a stale entry never answers); ``invalidate``
    also drops a type's entries at once, releasing their device copies."""

    def __init__(self):
        self._entries: Dict[tuple, Any] = {}
        self._lock = threading.Lock()
        with _CACHES_LOCK:
            _CACHES.add(self)

    def get(self, key: tuple, ttl_s: float):
        reg = devstats_metrics()
        with self._lock:
            self._sweep(ttl_s)
            e = self._entries.pop(key, None)
            if e is not None:
                self._entries[key] = e  # LRU refresh
                e.last_used = time.time()
                reg.inc("agg.cache.hits")
                reg.inc(f"agg.cache.{key[0]}.hits")
                return e
        reg.inc("agg.cache.misses")
        return None

    def put(self, key: tuple, entry) -> None:
        _bits, _levels, _ttl, cap = agg_knobs()
        reg = devstats_metrics()
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None and old is not entry:
                old.evict_device()
            self._entries[key] = entry
            while len(self._entries) > 1 and self._total_bytes() > cap:
                k = next(iter(self._entries))
                self._entries.pop(k).evict_device()
                reg.inc("agg.cache.evicted")

    def invalidate(self, type_name: str) -> int:
        """Drop every entry of ``type_name`` (keys are (kind, type, ...))."""
        dropped = 0
        with self._lock:
            for k in [k for k in self._entries if k[1] == type_name]:
                self._entries.pop(k).evict_device()
                dropped += 1
        if dropped:
            devstats_metrics().inc("agg.cache.invalidated", dropped)
        return dropped

    def _sweep(self, ttl_s: float) -> None:
        """Drop every expired entry (idle pyramids release device memory at
        their TTL). Called under the lock."""
        now = time.time()
        expired = [k for k, e in self._entries.items() if now - e.last_used > ttl_s]
        for k in expired:
            self._entries.pop(k).evict_device()
        if expired:
            devstats_metrics().inc("agg.cache.expired", len(expired))

    def _total_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def _cache_totals() -> Tuple[int, int]:
    with _CACHES_LOCK:
        caches = list(_CACHES)
    return sum(len(c) for c in caches), sum(c.total_bytes() for c in caches)


def agg_debug() -> Dict[str, Any]:
    """The reference's ``agg`` block of GET /debug/device: cache entries and
    bytes, hit / miss / build / eviction counters and the last build's
    shape."""
    counters, _g, _t, totals = devstats_metrics().snapshot()
    entries, nbytes = _cache_totals()
    with _LAST_BUILD_LOCK:
        last = dict(_LAST_BUILD)
    build_count, build_sum_s = totals.get("agg.build", (0, 0.0))
    return {
        "cache": {
            "entries": entries,
            "bytes": nbytes,
            "hits": counters.get("agg.cache.hits", 0),
            "misses": counters.get("agg.cache.misses", 0),
            "builds": counters.get("agg.cache.builds", 0),
            "expired": counters.get("agg.cache.expired", 0),
            "evicted": counters.get("agg.cache.evicted", 0),
            "invalidated": counters.get("agg.cache.invalidated", 0),
        },
        "build": {"count": build_count, "wall_s": round(build_sum_s, 4)},
        "pyramid": last,
    }
