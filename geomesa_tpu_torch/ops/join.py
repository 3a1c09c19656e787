"""Device-side spatial joins: point-in-polygon and distance joins.

Port of ``geomesa_tpu/ops/join.py``: the enrichment query class ("which
events fall inside which geofences"). A grid-bucketed BUILD side resident
on the device, a streamed PROBE side, and adaptive repartitioning when
skew blows a bucket past the threshold.

Layout
------
The build side (polygons for ``contains``, points for ``dwithin``) buckets
into a low-resolution z2 grid (``geomesa.join.bucket.bits`` per
dimension). Each geometry lands in every cell its radius-and-band expanded
envelope overlaps (wrapping at the antimeridian; a cap over a pole covers
every column); a bucket holding more than ``geomesa.join.skew.threshold``
geometries quad-splits into finer cells, at most
``geomesa.join.split.depth`` levels. The edge lists (``[G, E_pad, 4]``),
build points and the candidate matrix (``[B, C_pad]``, -1 pads) upload
once a schema generation through ``mesh.upload`` and stay resident in a
TTL'd per-store cache (``geomesa.join.cache.ttl``, at most ``CACHE_CAP``
builds, least recently used first out). The build state equals the
reference's field for field (buckets, splits, bucket rows, the candidate
matrix and cap, the expanded envelopes, the stats, the route).

Kernels and exactness
---------------------
Probe points stream ``geomesa.join.probe.chunk`` rows at a time: every
probe row's leaf bucket is found once (a vectorized descent through the
splits), and a chunk's routed rows are sorted by group and uploaded once
(``executor.join_upload``); ONE kernel launch answers the chunk
(``kernels.join_pip``: the f32 even-odd ray cast; ``kernels.join_dwithin``:
the f32 haversine) with a dual flag per (row, candidate slot): ``accept``
(decidably matching, away from any boundary) and ``check`` (within the
boundary band: the GridSnap epsilon of ``ops/geometry.py`` plus the f32
slack), fetched once (``executor.join_fetch``) and decoded vectorized.
The reference launches once per bucket group instead; the pairs are the
same. Accepted pairs are final; band pairs take the exact f64 host
predicate, grouped by build geometry after the last chunk. The host
reference join routes probes through the same buckets and applies the
same exact predicates, so the device path and the host degradation path
return identical pairs in the same canonical (build-major) order.

Failure envelope
----------------
``join.build`` (the upload of the build side) and ``join.probe`` (each
chunk) are fault points paired with spans and deadline checks. The device
part runs under the executor's circuit breaker (``push_down``): an open
circuit answers from the host reference join (``host-join-breaker``); a
failure of the link (an upload, a fetch, an injected fault) degrades the
whole join to the host reference join (``host-join-degraded``): the
executor's ``degrade.device_to_host`` (a breaker strike; no index mirror
is evicted), the reference's ``degrade.join_to_host``, the session's
sticky ``GEOMESA_JOIN_DEVICE`` trip and the build's device arrays evicted.
A ``QueryTimeout`` or a fault of a hand kernel (``kernels.KernelError``)
raises. ``GEOMESA_JOIN_DEVICE``: auto | 0 (host) | 1 (always retry the
device).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.geom.base import Geometry, MultiPolygon, Polygon
from geomesa_tpu_torch.ops.geometry import polygon_edges, snap_epsilon_deg, snap_epsilon_m
from geomesa_tpu_torch.utils import audit as audit_mod
from geomesa_tpu_torch.utils import deadline, faults, trace
from geomesa_tpu_torch.utils import plans as plans_mod
from geomesa_tpu_torch.utils.devstats import devstats_metrics

# the point-in-polygon boundary band, degrees. Pairs whose probe point
# sits within this distance of ANY build edge are host-verified in f64;
# the f32 ray cast is trusted only beyond it. 1e-3 deg (~110 m) safely
# dominates worst-case f32 coordinate arithmetic error at world scale
# (ulp(360) ~ 3e-5 deg, amplified a few x by the edge-intersection
# division) while keeping the exact-check band a sliver of any real
# geofence. The curve layer's snap epsilon folds in for index-derived
# coordinates.
PIP_BAND_DEG = 1e-3

# the reference's pow2 floor of a probe group's pad (its shape buckets); the
# port's chunk layout pads no probe row (PyTorch compiles no per-shape
# program), so it is kept for the reference's record only
GROUP_FLOOR = 64
# build-cache entries kept per store (LRU beyond this)
CACHE_CAP = 8

# live per-store build caches (entry counting for the debug block) and the
# most recent build's bucket-occupancy summary
_CACHES: "weakref.WeakSet" = weakref.WeakSet()
_CACHES_LOCK = threading.Lock()
_LAST_BUILD: Dict[str, Any] = {}
_LAST_BUILD_LOCK = threading.Lock()

# conservative meters-per-degree FLOOR for bucket-envelope expansion:
# deliberately BELOW the true spherical scale (~111195 m/deg; contrast
# geometry.METERS_PER_DEGREE = 111320, which rounds the other way for
# epsilon widening), so dlat/dlon only ever OVER-cover. Never raise it
# past the true scale — an under-covered envelope drops boundary dwithin
# pairs on device AND host alike, since both share the bucket routing.
M_PER_DEG_FLOOR = 111000.0

# dwithin radii past this (10,000 km) decline the device kernel: near the
# antipodal distance (~20,015 km) the haversine's asin amplifies a few
# ulps of f32 error past any fixed epsilon band, so the f32 mask stops
# being a guaranteed superset of the f64 predicate. The host path answers
# such joins exactly.
DWITHIN_DEVICE_MAX_R_M = 1.0e7

# the widest level (bits) the vectorized route descent encodes in one
# int64 cell code; deeper splits take the per-point descent
_CODE_BITS = 28


class JoinError(ValueError):
    """Bad join request (unknown predicate, missing radius, non-point
    probe side)."""


@dataclass(frozen=True)
class JoinSpec:
    """Parsed join predicate: ``contains`` (probe point in build polygon,
    boundary inclusive — ``geom.predicates.points_in_geometry``) or
    ``dwithin`` (haversine meters between probe and build points)."""

    kind: str
    radius_m: float = 0.0

    @classmethod
    def parse(cls, predicate, radius_m: Optional[float] = None) -> "JoinSpec":
        if isinstance(predicate, JoinSpec):
            return predicate
        p = str(predicate).strip().lower()
        if p == "dwithin" or p.startswith("dwithin("):
            inner = p[len("dwithin"):].strip()
            if inner:
                # anything after "dwithin" must be a complete (...): a typo
                # like "dwithin500" fails crisply
                if not inner.endswith(")"):
                    raise JoinError(f"malformed dwithin predicate: {predicate!r}")
                radius_m = inner[1:-1]
            if radius_m is None:
                raise JoinError("dwithin join needs a radius: dwithin(<meters>)")
            try:
                radius_m = float(radius_m)
            except (TypeError, ValueError):
                raise JoinError(f"dwithin radius must be a number, got {radius_m!r}") from None
            if radius_m < 0:
                raise JoinError("dwithin radius must be >= 0")
            return cls("dwithin", radius_m)
        if p == "contains":
            return cls("contains")
        raise JoinError(f"unknown join predicate {predicate!r} (contains | dwithin(r))")


def _pow2_at_least(n: int, floor: int) -> int:
    """The executor's pad-bucket rule (the candidate cap's bucket)."""
    from geomesa_tpu_torch.parallel.executor import _pow2_at_least as impl

    return impl(n, floor)


def _knobs() -> Tuple[int, int, int, float, int]:
    """(bucket bits, skew threshold, split depth, cache ttl s, probe chunk),
    None-checked: an explicit 0 is honored (split.depth=0 disables the
    adaptive splits)."""
    from geomesa_tpu_torch.utils.config import (
        JOIN_BUCKET_BITS,
        JOIN_CACHE_TTL,
        JOIN_PROBE_CHUNK,
        JOIN_SKEW_THRESHOLD,
        JOIN_SPLIT_DEPTH,
    )

    def val(prop, default):
        got = prop.to_int()
        return default if got is None else got

    bits = max(1, val(JOIN_BUCKET_BITS, 3))
    threshold = max(1, val(JOIN_SKEW_THRESHOLD, 128))
    depth = max(0, val(JOIN_SPLIT_DEPTH, 6))
    ttl = JOIN_CACHE_TTL.to_duration_s(600.0)
    chunk = max(1, val(JOIN_PROBE_CHUNK, 2048))
    return bits, threshold, depth, ttl, chunk


# -- grid cells ---------------------------------------------------------------


def _cell_of(x: float, y: float, bits: int) -> Tuple[int, int]:
    n = 1 << bits
    cx = min(n - 1, max(0, int((x + 180.0) / 360.0 * n)))
    cy = min(n - 1, max(0, int((y + 90.0) / 180.0 * n)))
    return cx, cy


def _cell_bounds(bits: int, cx: int, cy: int) -> Tuple[float, float, float, float]:
    w = 360.0 / (1 << bits)
    h = 180.0 / (1 << bits)
    return (-180.0 + cx * w, -90.0 + cy * h, -180.0 + (cx + 1) * w, -90.0 + (cy + 1) * h)


def _cover_cells(bits: int, env: np.ndarray) -> List[Tuple[int, int]]:
    """All (cx, cy) cells at ``bits`` overlapped by one [4] envelope. A
    radius-expanded envelope past +-180 WRAPS to the far columns (a
    geofence at lon 179.9 must be routable from a probe at -179.9);
    latitude only clamps."""
    n = 1 << bits
    cy0 = min(n - 1, max(0, int((env[1] + 90.0) / 180.0 * n)))
    cy1 = min(n - 1, max(0, int((env[3] + 90.0) / 180.0 * n)))
    xmin, xmax = float(env[0]), float(env[2])
    if xmax - xmin >= 360.0:
        segs = [(-180.0, 180.0)]
    elif xmin < -180.0:
        segs = [(-180.0, xmax), (xmin + 360.0, 180.0)]
    elif xmax > 180.0:
        segs = [(xmin, 180.0), (-180.0, xmax - 360.0)]
    else:
        segs = [(xmin, xmax)]
    cols = set()
    for sx0, sx1 in segs:
        cx0 = min(n - 1, max(0, int((sx0 + 180.0) / 360.0 * n)))
        cx1 = min(n - 1, max(0, int((sx1 + 180.0) / 360.0 * n)))
        cols.update(range(cx0, cx1 + 1))
    return [(cx, cy) for cx in sorted(cols) for cy in range(cy0, cy1 + 1)]


def _lon_overlaps(exmin: float, exmax: float, cxmin: float, cxmax: float) -> bool:
    """Longitude-interval overlap with antimeridian wrap."""
    if exmax - exmin >= 360.0:
        return True
    if exmin < -180.0:
        segs = ((-180.0, exmax), (exmin + 360.0, 180.0))
    elif exmax > 180.0:
        segs = ((exmin, 180.0), (-180.0, exmax - 360.0))
    else:
        segs = ((exmin, exmax),)
    return any(s0 <= cxmax and s1 >= cxmin for s0, s1 in segs)


def _expand_envs(envs: np.ndarray, spec: JoinSpec) -> np.ndarray:
    """Bucket-insertion envelopes of the build geometries, vectorized over
    [N, 4]: widened by the radius (latitude-aware for longitude; a cap
    reaching a pole covers every column) plus the boundary band and the
    snap epsilon, so a matching probe point ALWAYS routes to a bucket
    holding the geometry."""
    envs = np.asarray(envs, dtype=np.float64)
    band = max(snap_epsilon_deg(), PIP_BAND_DEG)
    if spec.kind == "dwithin":
        r_m = spec.radius_m + snap_epsilon_m(spec.radius_m)
        dlat = r_m / M_PER_DEG_FLOOR + band
        lat_reach = np.minimum(90.0, np.maximum(np.abs(envs[:, 1]), np.abs(envs[:, 3])) + dlat)
        safe = lat_reach < 90.0 - 1e-9
        dlon = np.where(
            safe,
            r_m / (M_PER_DEG_FLOOR * np.cos(np.radians(np.where(safe, lat_reach, 0.0)))) + band,
            360.0,
        )
    else:
        dlat = band
        dlon = band
    out = np.empty_like(envs)
    out[:, 0] = envs[:, 0] - dlon
    out[:, 1] = envs[:, 1] - dlat
    out[:, 2] = envs[:, 2] + dlon
    out[:, 3] = envs[:, 3] + dlat
    return out


# -- build side ---------------------------------------------------------------


def _geometry_edges(g: Geometry) -> Optional[np.ndarray]:
    """[E, 4] f32 edge list for the even-odd ray cast, or None when the
    geometry cannot ride the kernel. Multi-member MultiPolygons decline:
    the parity of concatenated rings equals the UNION only for disjoint
    members, which nothing validates (single-member ones unwrap)."""
    if isinstance(g, Polygon):
        return polygon_edges(g)
    if isinstance(g, MultiPolygon) and len(g.geoms) == 1:
        return polygon_edges(g.geoms[0])
    return None


def _cell_code(b, cx, cy):
    """int64 code of cells (b, cx, cy) with b, cx, cy below 2^_CODE_BITS."""
    return (np.asarray(b, np.int64) << (2 * _CODE_BITS)) | (np.asarray(cx, np.int64)
                                                            << _CODE_BITS) | np.asarray(cy, np.int64)


def _sorted_member(values: np.ndarray, sorted_set: np.ndarray) -> np.ndarray:
    """bool[n]: ``values`` found in the sorted, non-empty ``sorted_set``."""
    pos = np.minimum(np.searchsorted(sorted_set, values), len(sorted_set) - 1)
    return sorted_set[pos] == values


def group_rows(buckets: np.ndarray):
    """(rows int64, goff int32[groups + 1], grow int32[groups]) of per-row
    bucket rows (``JoinBuild.leaf_buckets``, -1: none): the routed rows
    sorted by bucket (each bucket's rows ascending), the groups' CSR offsets
    and each group's row of the candidate matrix: a probe chunk's launch
    layout."""
    rows = np.flatnonzero(buckets >= 0)
    b = buckets[rows]
    order = np.argsort(b, kind="stable")
    rows, b = rows[order], b[order]
    heads = np.flatnonzero(np.concatenate(([True], b[1:] != b[:-1]))) if len(b) else \
        np.zeros(0, dtype=np.int64)
    goff = np.append(heads, len(rows)).astype(np.int32)
    return rows, goff, b[heads].astype(np.int32)


class JoinBuild:
    """One build side, bucketed and (lazily) resident on the device.

    Host state: the exact f64 geometries / coordinates (the final word on
    boundary pairs and the degradation path), the bucket map and the build
    columns the join result re-exposes. Device state: edge / coordinate
    arrays and the candidate matrix, uploaded once by ``ensure_device``
    and reused until the schema generation moves or the TTL expires."""

    def __init__(self, spec: JoinSpec, ft, columns: Dict[str, np.ndarray], fids: np.ndarray,
                 geoms: Optional[List[Optional[Geometry]]], bx: Optional[np.ndarray],
                 by: Optional[np.ndarray]):
        bits, threshold, depth, _ttl, _chunk = _knobs()
        self.spec = spec
        self.ft = ft
        self.columns = columns
        self.fids = fids
        self.geoms = geoms  # contains: Geometry | None per row
        self.bx = bx        # dwithin: f64 coordinates per row (NaN = null geometry)
        self.by = by
        self.base_bits = bits
        self.built_at = time.time()
        # refreshed by every cache hit: the TTL evicts IDLE builds
        self.last_used = self.built_at
        self.device_eligible = True
        self.stats: Dict[str, Any] = {}
        self._dev = None  # (edges | bx, ecnt | by, cand) device tensors
        self._dev_lock = threading.Lock()

        n = len(fids)
        envs = np.zeros((n, 4), dtype=np.float64)
        self.active = np.zeros(n, dtype=bool)
        if spec.kind == "contains":
            self.edge_lists: List[Optional[np.ndarray]] = []
            for i, g in enumerate(geoms):
                if g is None:
                    self.edge_lists.append(None)
                    continue
                e = _geometry_edges(g)
                self.edge_lists.append(e)
                if e is None:
                    # a non-polygonal member: the whole join takes the host
                    # path (no silent drop)
                    self.device_eligible = False
                envs[i] = g.envelope.as_tuple()
                self.active[i] = True
        else:
            ok = ~(np.isnan(bx) | np.isnan(by))
            self.active = ok
            envs[:, 0] = np.where(ok, bx, 0.0)
            envs[:, 1] = np.where(ok, by, 0.0)
            envs[:, 2] = envs[:, 0]
            envs[:, 3] = envs[:, 1]
        self.envs = _expand_envs(envs, spec) if n else np.zeros((0, 4))

        # -- bucket + adaptive skew split -------------------------------
        buckets: Dict[Tuple[int, int, int], List[int]] = {}
        splits: set = set()
        n_splits = 0
        for i in np.flatnonzero(self.active):
            for cx, cy in _cover_cells(bits, self.envs[i]):
                buckets.setdefault((bits, cx, cy), []).append(int(i))
        work = [c for c, v in buckets.items() if len(v) > threshold]
        while work:
            cell = work.pop()
            b, cx, cy = cell
            if b - bits >= depth or cell not in buckets:
                continue
            entries = buckets.pop(cell)
            if len(entries) <= threshold:
                buckets[cell] = entries
                continue
            splits.add(cell)
            n_splits += 1
            for ccx in (cx * 2, cx * 2 + 1):
                for ccy in (cy * 2, cy * 2 + 1):
                    cb = _cell_bounds(b + 1, ccx, ccy)
                    child = [
                        i for i in entries
                        if _lon_overlaps(self.envs[i][0], self.envs[i][2], cb[0], cb[2])
                        and self.envs[i][1] <= cb[3] and self.envs[i][3] >= cb[1]
                    ]
                    if child:
                        key = (b + 1, ccx, ccy)
                        buckets[key] = child
                        if len(child) > threshold and (b + 1 - bits) < depth:
                            work.append(key)
        self.buckets = {c: np.asarray(v, dtype=np.int32) for c, v in buckets.items()}
        self.splits = splits
        sizes = [len(v) for v in buckets.values()]
        self.cand_cap = _pow2_at_least(max(sizes, default=1), 8)
        self.n_splits = n_splits
        reg = devstats_metrics()
        if n_splits:
            reg.inc("join.bucket.splits", n_splits)
        reg.set_gauge("join.buckets", len(buckets))
        reg.set_gauge("join.bucket.max_entries", max(sizes, default=0))
        reg.set_gauge("join.bucket.mean_entries", float(np.mean(sizes)) if sizes else 0.0)
        hist: Dict[str, int] = {}
        for s in sizes:
            p = 1
            while p < s:
                p *= 2
            hist[f"<={p}"] = hist.get(f"<={p}", 0) + 1
        self.stats = {
            "geometries": int(self.active.sum()),
            "buckets": len(buckets),
            "splits": n_splits,
            "max_bucket": max(sizes, default=0),
            "candidate_cap": self.cand_cap,
            "histogram": dict(sorted(hist.items(), key=lambda kv: int(kv[0][2:]))),
        }
        with _LAST_BUILD_LOCK:
            _LAST_BUILD.clear()
            _LAST_BUILD.update(self.stats)
        # candidate matrix: bucket row -> padded geometry indices
        self._cells = sorted(self.buckets)
        self.bucket_rows = {c: r for r, c in enumerate(self._cells)}
        cand = np.full((max(len(self.buckets), 1), self.cand_cap), -1, dtype=np.int32)
        for c, idxs in self.buckets.items():
            cand[self.bucket_rows[c], : len(idxs)] = idxs
        self.cand = cand
        # the route's lookups: the split cells and the bucket cells as sorted
        # int64 codes (a bucket code's position is its bucket row)
        deepest = max([c[0] for c in self._cells] + [c[0] for c in splits] + [bits])
        self._vector_route = deepest < _CODE_BITS
        if self._vector_route:
            self._split_codes = np.sort(np.asarray(
                [_cell_code(*c) for c in splits], dtype=np.int64))
            self._bucket_codes = np.asarray([_cell_code(*c) for c in self._cells],
                                            dtype=np.int64)

    def leaf_cell(self, x: float, y: float) -> Tuple[int, int, int]:
        b = self.base_bits
        while True:
            cx, cy = _cell_of(x, y, b)
            if (b, cx, cy) in self.splits:
                b += 1
                continue
            return (b, cx, cy)

    def leaf_buckets(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """int64[n]: each probe row's leaf bucket as its row of the
        candidate matrix (``bucket_rows``), -1 for rows with NaN coordinates
        or in a cell with no bucket (both match nothing by construction).
        The descent through split cells is vectorized: every row of a split
        cell steps one level at a time until its cell is not split (the
        reference's ``leaf_cell`` per point, with the same float
        arithmetic); splits deeper than one int64 code holds take the
        per-point descent."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        out = np.full(len(x), -1, dtype=np.int64)
        if not self._vector_route:
            for cell, rows in self._route_per_point(x, y).items():
                out[rows] = self.bucket_rows[cell]
            return out
        idx = np.flatnonzero(~(np.isnan(x) | np.isnan(y)))
        if not len(idx) or not len(self._bucket_codes):
            return out
        xs, ys = x[idx], y[idx]
        b = self.base_bits
        level = np.full(len(idx), b, dtype=np.int64)
        n = 1 << b
        cx = np.clip(((xs + 180.0) / 360.0 * n).astype(np.int64), 0, n - 1)
        cy = np.clip(((ys + 90.0) / 180.0 * n).astype(np.int64), 0, n - 1)
        codes = _cell_code(level, cx, cy)
        if len(self._split_codes):
            down = _sorted_member(codes, self._split_codes)
            while down.any():
                sel = np.flatnonzero(down)
                lv = level[sel] + 1
                m = np.int64(1) << lv
                ccx = np.minimum(m - 1, np.maximum(0, ((xs[sel] + 180.0) / 360.0 * m).astype(
                    np.int64)))
                ccy = np.minimum(m - 1, np.maximum(0, ((ys[sel] + 90.0) / 180.0 * m).astype(
                    np.int64)))
                level[sel] = lv
                codes[sel] = _cell_code(lv, ccx, ccy)
                down[sel] = _sorted_member(codes[sel], self._split_codes)
        # the codes sort as the (b, cx, cy) cells do: a code's position among
        # the bucket codes is its bucket's row of the candidate matrix
        pos = np.minimum(np.searchsorted(self._bucket_codes, codes), len(self._bucket_codes) - 1)
        out[idx] = np.where(self._bucket_codes[pos] == codes, pos, -1)
        return out

    def route(self, x: np.ndarray, y: np.ndarray) -> Dict[Tuple[int, int, int], np.ndarray]:
        """Group probe rows by leaf bucket (``leaf_buckets``); rows that
        route nowhere drop out. Each group's rows ascend."""
        rows, goff, grow = group_rows(self.leaf_buckets(x, y))
        return {self._cells[int(g)]: rows[goff[i]:goff[i + 1]] for i, g in enumerate(grow)}

    def _route_per_point(self, x: np.ndarray, y: np.ndarray):
        """The reference's route (base cells vectorized, the split cells'
        rows descended per point): for splits deeper than the vectorized
        descent encodes."""
        idx = np.flatnonzero(~(np.isnan(x) | np.isnan(y)))
        if not len(idx):
            return {}
        n = 1 << self.base_bits
        cx = np.clip(((x[idx] + 180.0) / 360.0 * n).astype(np.int64), 0, n - 1)
        cy = np.clip(((y[idx] + 90.0) / 180.0 * n).astype(np.int64), 0, n - 1)
        key = cx * n + cy
        order = np.argsort(key, kind="stable")
        sidx, skey = idx[order], key[order]
        skx, sky = cx[order], cy[order]
        groups: Dict[Tuple[int, int, int], np.ndarray] = {}
        refined: Dict[Tuple[int, int, int], List[int]] = {}
        bounds = np.flatnonzero(np.diff(skey)) + 1
        for grp, g0 in zip(np.split(sidx, bounds), np.concatenate([[0], bounds])):
            cell = (self.base_bits, int(skx[g0]), int(sky[g0]))
            if cell in self.splits:
                for i in grp:
                    leaf = self.leaf_cell(float(x[i]), float(y[i]))
                    if leaf in self.buckets:
                        refined.setdefault(leaf, []).append(int(i))
            elif cell in self.buckets:
                groups[cell] = grp.astype(np.int64)
        for c, v in refined.items():
            groups[c] = np.asarray(v, dtype=np.int64)
        return groups

    # -- device residency -------------------------------------------------

    def ensure_device(self, device):
        """Upload the build arrays once (edge lists / coordinates and the
        candidate matrix) through ``mesh.upload``; later joins reuse them.
        Raises on a link fault: the caller's degradation path answers from
        the host state."""
        with self._dev_lock:
            if self._dev is not None:
                return self._dev
            from geomesa_tpu_torch.parallel.mesh import upload

            if self.spec.kind == "contains":
                g = len(self.edge_lists)
                e_max = max((len(e) for e in self.edge_lists if e is not None), default=1)
                e_pad = _pow2_at_least(max(e_max, 1), 8)
                edges = np.zeros((max(g, 1), e_pad, 4), dtype=np.float32)
                ecnt = np.zeros(max(g, 1), dtype=np.int32)
                for i, e in enumerate(self.edge_lists):
                    if e is None or not len(e):
                        continue
                    edges[i, : len(e)] = e
                    ecnt[i] = len(e)
                dev = (upload(edges, device), upload(ecnt, device), upload(self.cand, device))
            else:
                bx = np.where(self.active, self.bx, np.nan).astype(np.float32)
                by = np.where(self.active, self.by, np.nan).astype(np.float32)
                if not len(bx):
                    bx = by = np.full(1, np.nan, dtype=np.float32)
                dev = (upload(bx, device), upload(by, device), upload(self.cand, device))
            self._dev = dev
            return dev

    def evict_device(self) -> None:
        with self._dev_lock:
            self._dev = None


# -- exact host predicates ----------------------------------------------------


def _exact_pairs(build: JoinBuild, gi: int, px: np.ndarray, py: np.ndarray,
                 rows: np.ndarray) -> np.ndarray:
    """Row subset of ``rows`` exactly matching build geometry ``gi`` (f64;
    the final word on every boundary pair and the whole host path)."""
    if not len(rows):
        return rows
    x = px[rows]
    y = py[rows]
    if build.spec.kind == "contains":
        from geomesa_tpu_torch.geom.predicates import points_in_geometry

        m = points_in_geometry(x, y, build.geoms[gi])
    else:
        from geomesa_tpu_torch.process.geodesy import haversine_m

        m = haversine_m(x, y, build.bx[gi], build.by[gi]) <= build.spec.radius_m
    return rows[m]


def host_join(build: JoinBuild, px: np.ndarray, py: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The exact host reference join: the device path's bucket routing, the
    exact f64 predicate per (bucket, candidate). Returns (build_idx,
    probe_idx) in canonical (build-major) order."""
    out_b: List[np.ndarray] = []
    out_p: List[np.ndarray] = []
    for cell, rows in build.route(px, py).items():
        deadline.check("join.probe")
        for gi in build.buckets[cell]:
            hit = _exact_pairs(build, int(gi), px, py, rows)
            if len(hit):
                out_b.append(np.full(len(hit), int(gi), dtype=np.int64))
                out_p.append(hit)
    return _canonical_pairs(out_b, out_p)


def _canonical_pairs(out_b: List[np.ndarray], out_p: List[np.ndarray]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    if not out_b:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy()
    bi = np.concatenate(out_b)
    pi = np.concatenate(out_p)
    order = np.lexsort((pi, bi))
    return bi[order], pi[order]


# -- device probe -------------------------------------------------------------


def _flag_pairs(fl: np.ndarray):
    """(slot, row) of every set flag of u8 [C, R] flags: the nonzero 8-byte
    words first (pairs are sparse), then their bytes."""
    flat = fl.reshape(-1)
    if len(flat) % 8:
        idx = np.flatnonzero(flat)
    else:
        words = np.flatnonzero(flat.view(np.uint64))
        sub = flat.reshape(-1, 8)[words]
        w, j = np.nonzero(sub)
        idx = words[w] * 8 + j
    return idx // fl.shape[1], idx % fl.shape[1]


def device_join(build: JoinBuild, device, px: np.ndarray, py: np.ndarray,
                stats: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
    """Stream the probe side through the device a chunk at a time: one
    upload (``join_upload``), one ``join_pip`` / ``join_dwithin`` launch and
    one fetch (``join_fetch``) a chunk, the flags decoded vectorized.
    Accepted pairs are final; boundary-band pairs take the exact f64 host
    predicate, grouped by build geometry after the last chunk. The result
    equals ``host_join``'s."""
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.parallel.executor import join_fetch, join_upload

    _bits, _thr, _depth, _ttl, chunk = _knobs()
    dev = build.ensure_device(device)
    contains = build.spec.kind == "contains"
    if contains:
        eps = np.float32(max(snap_epsilon_deg(), PIP_BAND_DEG))
    else:
        eps = np.float32(snap_epsilon_m(build.spec.radius_m))
        r_m = np.float32(build.spec.radius_m)
    cand = build.cand
    out_b: List[np.ndarray] = []
    out_p: List[np.ndarray] = []
    band_b: List[np.ndarray] = []
    band_p: List[np.ndarray] = []
    chunks = 0
    # every probe row's leaf bucket at once; each chunk takes its slice (the
    # same groups a per-chunk route gives)
    buckets = build.leaf_buckets(px, py)
    for start in range(0, len(px), chunk):
        # per-chunk boundary: injectable, span-wrapped, deadline-paired
        with trace.span("join.probe", chunk=chunks, rows=min(chunk, len(px) - start)):
            deadline.check("join.probe")
            faults.fault_point("join.probe")
            rows, goff, grow = group_rows(buckets[start:start + chunk])
            if len(rows):
                gx, gy, goff_d, grow_d = join_upload(
                    device, px[start + rows], py[start + rows], goff, grow)
                if contains:
                    flags = kernels.join_pip(gx, gy, goff_d, grow_d, dev[2], dev[0], dev[1], eps)
                else:
                    flags = kernels.join_dwithin(gx, gy, goff_d, grow_d, dev[2], dev[0], dev[1],
                                                 r_m, eps)
                fl = join_fetch(flags)
                slot, r = _flag_pairs(fl)
                if len(r):
                    # flag -> (group, slot) -> build geometry; -> probe row
                    g = np.searchsorted(goff, r, side="right") - 1
                    gi = cand[grow[g], slot].astype(np.int64)
                    pr = rows[r] + start
                    acc = (fl[slot, r] & 1) != 0
                    out_b.append(gi[acc])
                    out_p.append(pr[acc])
                    band_b.append(gi[~acc])
                    band_p.append(pr[~acc])
        chunks += 1
    bb = np.concatenate(band_b) if band_b else np.empty(0, dtype=np.int64)
    bp = np.concatenate(band_p) if band_p else bb
    verified = int(len(bb))
    if verified:
        order = np.lexsort((bp, bb))
        bb, bp = bb[order], bp[order]
        heads = np.flatnonzero(np.concatenate(([True], bb[1:] != bb[:-1])))
        for h, grp in zip(heads, np.split(bp, heads[1:])):
            gi = int(bb[h])
            hit = _exact_pairs(build, gi, px, py, grp)
            if len(hit):
                out_b.append(np.full(len(hit), gi, dtype=np.int64))
                out_p.append(hit)
    stats["chunks"] = chunks
    stats["band_verified"] = verified
    devstats_metrics().inc("join.probe.chunks", chunks)
    return _canonical_pairs(out_b, out_p)


# -- build cache --------------------------------------------------------------


class JoinBuildCache:
    """Per-store TTL'd LRU of JoinBuild structures, keyed by (type name,
    build query identity, schema generation, spec, knobs). A generation
    move (any write, delete or compaction) changes the key, so a stale
    build never answers; the TTL bounds the device residency of idle
    builds."""

    def __init__(self):
        self._entries: Dict[tuple, JoinBuild] = {}
        self._lock = threading.Lock()
        with _CACHES_LOCK:
            _CACHES.add(self)

    def get(self, key: tuple, ttl_s: float) -> Optional[JoinBuild]:
        reg = devstats_metrics()
        with self._lock:
            self._sweep(ttl_s)
            b = self._entries.pop(key, None)
            if b is not None:
                self._entries[key] = b  # LRU refresh
                b.last_used = time.time()
                reg.inc("join.build.hits")
                return b
        reg.inc("join.build.misses")
        return None

    def _sweep(self, ttl_s: float) -> None:
        """Drop EVERY expired entry (idle builds release their device
        arrays at the TTL). Called under the lock."""
        now = time.time()
        for k in [k for k, b in self._entries.items() if now - b.last_used > ttl_s]:
            self._entries.pop(k).evict_device()

    def put(self, key: tuple, build: JoinBuild) -> None:
        with self._lock:
            # two concurrent misses on one key both build: the displaced
            # loser releases its device arrays
            old = self._entries.pop(key, None)
            if old is not None and old is not build:
                old.evict_device()
            self._entries[key] = build
            while len(self._entries) > CACHE_CAP:
                self._entries.pop(next(iter(self._entries))).evict_device()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# -- planner ------------------------------------------------------------------


class JoinResult:
    """Joined pairs and both sides' materialized state.

    ``build_idx`` / ``probe_idx`` are parallel row-index arrays in
    canonical (build-major) order; ``pairs()`` gives fid tuples and
    ``raw_columns()`` the joined column dict (matched probe rows + build
    columns, suffixed on collision)."""

    def __init__(self, probe, build: JoinBuild, build_idx: np.ndarray, probe_idx: np.ndarray,
                 stats: Dict[str, Any], plan=None):
        self.probe = probe
        self.build = build
        self.build_idx = build_idx
        self.probe_idx = probe_idx
        self.stats = stats
        self.plan = plan

    def __len__(self) -> int:
        return len(self.build_idx)

    @property
    def build_fids(self) -> np.ndarray:
        return self.build.fids[self.build_idx]

    @property
    def probe_fids(self) -> np.ndarray:
        fids = self.probe.columns["__fid__"]
        return np.asarray(fids, dtype=object)[self.probe_idx]

    def pairs(self, limit: Optional[int] = None) -> List[Tuple[str, str]]:
        """Fid pairs in canonical order; ``limit`` slices the index arrays
        before any fid is gathered."""
        bi = self.build_idx[:limit] if limit is not None else self.build_idx
        pi = self.probe_idx[:limit] if limit is not None else self.probe_idx
        pfids = np.asarray(self.probe.columns["__fid__"], dtype=object)
        return [(str(b), str(p)) for b, p in zip(self.build.fids[bi], pfids[pi])]

    def raw_columns(self, suffix: str = "_r") -> Dict[str, np.ndarray]:
        pcols = self.probe.columns
        if hasattr(pcols, "materialize"):
            pcols = pcols.materialize()
        cols = {k: v[self.probe_idx] for k, v in pcols.items()}
        for k, v in self.build.columns.items():
            key = (k + suffix) if k in pcols else k
            cols[key] = v[self.build_idx]
        return cols


class JoinPlanner:
    """Build-once / probe-streamed join execution over a datastore.

    The build side queries once per schema generation (the per-store
    ``JoinBuildCache``) and stays resident on the device; the probe side is
    an ordinary store query whose coordinates stream through the device
    kernels, with the host reference join as the degradation target."""

    def __init__(self, store):
        self.store = store

    def join(self, build_name: str, build_query, probe_name: str, probe_query,
             spec: JoinSpec) -> JoinResult:
        from geomesa_tpu_torch.filter.parser import to_cql

        store = self.store
        bits, threshold, depth, ttl, _chunk = _knobs()
        cache = getattr(store, "_join_cache", None)
        if cache is None:
            # dict.setdefault is atomic: two concurrent first joins agree on
            # ONE cache
            cache = store.__dict__.setdefault("_join_cache", JoinBuildCache())
        # a lazy store's partition loads settle BEFORE the key is taken (the
        # build query runs the hook again as a no-op), and the key is
        # captured ONCE, before the build query: a write landing mid-build
        # moves the generation past this key, so a build that read pre-write
        # rows never answers a post-write join. The full build query
        # identity keys too (limit, projection, sort, hints).
        store._prepare_query(build_name, build_query)
        key = (
            build_name, to_cql(build_query.filter), build_query.max_features,
            tuple(build_query.properties) if build_query.properties is not None else None,
            tuple(build_query.sort_by) if build_query.sort_by else None,
            repr(sorted(build_query.hints.items(), key=repr)) if build_query.hints else None,
            store.schema_generation(build_name), spec.kind, round(spec.radius_m, 3), bits,
            threshold, depth,
        )
        build = cache.get(key, ttl)
        rebuilt = build is None
        if rebuilt:
            res_b = store.query(build_name, build_query)
            build = self._make_build(res_b, spec)
            cache.put(key, build)

        probe_res = store.query(probe_name, probe_query)
        gname = (probe_res.ft.default_geometry.name
                 if probe_res.ft.default_geometry is not None else None)
        pcols = probe_res.columns
        if gname is None or (gname + "__x") not in pcols:
            raise JoinError(f"probe side {probe_name!r} must be a point schema")
        px = np.asarray(pcols[gname + "__x"], dtype=np.float64)
        py = np.asarray(pcols[gname + "__y"], dtype=np.float64)

        stats: Dict[str, Any] = {"build": "rebuild" if rebuilt else "hit"}
        stats.update(build.stats)
        plans_mod.note("join.build", "rebuild" if rebuilt else "hit")
        bi, pi, path = self._device_join(build_name, build, spec, px, py, stats)
        if bi is None:
            bi, pi = host_join(build, px, py)
        stats["path"] = path
        stats["pairs"] = int(len(bi))
        stats["probed"] = int(len(px))
        devstats_metrics().inc("join.pairs", int(len(bi)))
        return JoinResult(probe_res, build, bi, pi, stats, probe_res.plan)

    def _device_join(self, build_name: str, build: JoinBuild, spec: JoinSpec, px, py, stats):
        """(build_idx, probe_idx, path) of the device join, or (None, None,
        path) when the host reference join answers: each decline is
        reason-coded (``audit.decision("join.kernel", ...)``), an open
        circuit answers ``host-join-breaker``, a failed link
        ``host-join-degraded``."""
        from geomesa_tpu_torch.parallel.executor import HOST_BREAKER, HOST_DEGRADED
        from geomesa_tpu_torch.parallel.mesh import device_tripped, trip_device

        store = self.store
        executor = store.executor
        device = getattr(executor, "device", None)
        env = os.environ.get("GEOMESA_JOIN_DEVICE", "auto")
        if device is None or getattr(executor, "push_down", None) is None:
            return None, None, "host-join"
        if not build.device_eligible:
            # e.g. a multi-member MultiPolygon build (see _geometry_edges)
            audit_mod.decision("join.kernel", "build_ineligible", build=build_name)
            return None, None, "host-join"
        if spec.kind == "dwithin" and spec.radius_m > DWITHIN_DEVICE_MAX_R_M:
            audit_mod.decision("join.kernel", "antipodal_radius", radius_m=float(spec.radius_m))
            return None, None, "host-join"
        if env == "0":
            audit_mod.decision("join.kernel", "env_disabled")
            return None, None, "host-join"
        if device_tripped(executor, "GEOMESA_JOIN_DEVICE"):
            audit_mod.decision("join.kernel", "device_tripped")
            return None, None, "host-join"
        bo = getattr(store, "_brownout", None)
        if bo is not None and not bo.speculation_allowed():
            # the brownout ladder's hedge-off level: fresh device work is
            # capacity the queue needs more; the host join answers the same
            from geomesa_tpu_torch.utils import brownout as brownout_mod

            if brownout_mod.enabled():
                audit_mod.decision("join.kernel", "brownout", level=bo.level)
                return None, None, "host-join"
        failed: List[BaseException] = []

        def run():
            try:
                # the device boundary of the build side: upload (or reuse)
                # the resident structure
                with trace.span("join.build", type=build_name, cached=build._dev is not None):
                    deadline.check("join.build")
                    faults.fault_point("join.build")
                    build.ensure_device(device)
                return device_join(build, device, px, py, stats)
            except Exception as e:
                failed.append(e)
                raise

        # the executor's breaker envelope; the join's device state is the
        # build's own, so a failure evicts no index mirror
        got = executor.push_down(None, run, evict=False)
        if got is HOST_BREAKER:
            return None, None, "host-join-breaker"
        if got is HOST_DEGRADED:
            from geomesa_tpu_torch.utils.audit import robustness_metrics

            e = failed[-1] if failed else RuntimeError("the device join failed")
            robustness_metrics().inc("degrade.join_to_host")
            trace.event("degrade.join_to_host", reason=f"{type(e).__name__}: {e}")
            trip_device(executor, "GEOMESA_JOIN_DEVICE", "join", e)
            build.evict_device()
            return None, None, "host-join-degraded"
        bi, pi = got
        return bi, pi, "device-join"

    @staticmethod
    def _make_build(res_b, spec: JoinSpec) -> JoinBuild:
        cols = res_b.columns
        if hasattr(cols, "materialize"):
            cols = cols.materialize()
        ft = res_b.ft
        geom = ft.default_geometry
        if geom is None:
            raise JoinError(f"build side {ft.name!r} has no geometry")
        fids = np.asarray(cols.get("__fid__", np.empty(0, object)), object)
        if spec.kind == "contains":
            if geom.name not in cols:
                raise JoinError("contains join needs a polygonal build side "
                                f"({ft.name!r} stores points)")
            geoms = list(cols[geom.name])
            return JoinBuild(spec, ft, cols, fids, geoms, None, None)
        if (geom.name + "__x") not in cols:
            raise JoinError(f"dwithin join needs a point build side ({ft.name!r})")
        bx = np.asarray(cols[geom.name + "__x"], dtype=np.float64)
        by = np.asarray(cols[geom.name + "__y"], dtype=np.float64)
        return JoinBuild(spec, ft, cols, fids, None, bx, by)


def _cache_entries_total() -> int:
    with _CACHES_LOCK:
        return sum(len(c) for c in _CACHES)


def join_debug() -> Dict[str, Any]:
    """The ``join`` block of the device debug payload: build-cache
    occupancy and hit / miss counters, the latest build's bucket skew
    histogram, and the split / pair counters."""
    reg = devstats_metrics()
    counters, gauges, _t, _tt = reg.snapshot()
    with _LAST_BUILD_LOCK:
        last = dict(_LAST_BUILD)
    return {
        "build_cache": {
            "entries": _cache_entries_total(),
            "hits": counters.get("join.build.hits", 0),
            "misses": counters.get("join.build.misses", 0),
        },
        "buckets": {
            "count": gauges.get("join.buckets", 0),
            "max_entries": gauges.get("join.bucket.max_entries", 0),
            "mean_entries": gauges.get("join.bucket.mean_entries", 0.0),
            "splits_total": counters.get("join.bucket.splits", 0),
            "histogram": last.get("histogram", {}),
        },
        "probe": {
            "chunks": counters.get("join.probe.chunks", 0),
            "pairs": counters.get("join.pairs", 0),
        },
    }
