"""Vectorized spatial predicates over coordinate arrays.

Port of ``geomesa_tpu/geom/predicates.py``.

The host-side (numpy) versions of the post-filter kernels. These evaluate a
*query geometry* against columnar batches of feature points -- the analog of
the reference's CQL geometry predicates evaluated per-feature in server-side
iterators (e.g. KryoLazyFilterTransformIterator). The reference's device
edition, ``geomesa_tpu/ops/geometry.py``, is ``geomesa_tpu_torch/ops/
geometry.py``. The ring tests run over blocks of [points, edges] at once
(the reference loops over the edges); each element's arithmetic is the
reference's, so the answers are its.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.geom.base import (
    Envelope,
    Geometry,
    GeometryCollection,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
)


def points_in_envelope(x: np.ndarray, y: np.ndarray, env: Envelope) -> np.ndarray:
    """Inclusive bbox containment for point arrays."""
    return (x >= env.xmin) & (x <= env.xmax) & (y >= env.ymin) & (y <= env.ymax)


# elements of one [points, edges] block of the ring tests
_RING_BLOCK = 1 << 20


def _edge_blocks(x: np.ndarray, n_edges: int):
    """Slices of ``x`` whose [points, edges] block holds at most
    ``_RING_BLOCK`` elements."""
    step = max(1, _RING_BLOCK // max(1, n_edges))
    return (slice(i, i + step) for i in range(0, len(x), step))


def _points_in_ring(x: np.ndarray, y: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Even-odd ray cast: True where (x, y) is strictly inside or on an edge
    crossing. Boundary points are handled separately by the on-segment test."""
    inside = np.zeros(x.shape, dtype=bool)
    ax, ay = ring[:-1, 0], ring[:-1, 1]
    bx, by = ring[1:, 0], ring[1:, 1]
    dxe = bx - ax
    dye = np.where(by != ay, by - ay, 1.0)
    for sl in _edge_blocks(x, len(ax)):
        px, py = x[sl, None], y[sl, None]
        crosses = ((ay > py) != (by > py)) & (px < dxe * (py - ay) / dye + ax)
        inside[sl] = crosses.sum(axis=1) % 2 == 1
    return inside


def _points_on_segments(x: np.ndarray, y: np.ndarray, ring: np.ndarray, eps=1e-12):
    """True where a point lies on any segment of the ring (inclusive ends)."""
    on = np.zeros(x.shape, dtype=bool)
    ax, ay = ring[:-1, 0], ring[:-1, 1]
    bx, by = ring[1:, 0], ring[1:, 1]
    dxe, dye = bx - ax, by - ay
    tol = eps * np.maximum(1.0, np.abs(dxe) + np.abs(dye))
    lox, hix = np.minimum(ax, bx) - eps, np.maximum(ax, bx) + eps
    loy, hiy = np.minimum(ay, by) - eps, np.maximum(ay, by) + eps
    for sl in _edge_blocks(x, len(ax)):
        px, py = x[sl, None], y[sl, None]
        cross = dxe * (py - ay) - dye * (px - ax)
        within = (lox <= px) & (px <= hix) & (loy <= py) & (py <= hiy)
        on[sl] = ((np.abs(cross) <= tol) & within).any(axis=1)
    return on


def points_in_polygon(
    x: np.ndarray, y: np.ndarray, poly: Polygon, boundary: bool = True
) -> np.ndarray:
    """Point-in-polygon. ``boundary=True`` includes shell *and* hole rings
    (JTS intersects semantics); ``boundary=False`` is the strict interior
    (JTS within semantics for points)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    env = poly.envelope
    candidates = points_in_envelope(x, y, env)
    result = np.zeros(x.shape, dtype=bool)
    if not candidates.any():
        return result
    xi, yi = x[candidates], y[candidates]
    inside = _points_in_ring(xi, yi, poly.shell)
    for hole in poly.holes:
        inside &= ~_points_in_ring(xi, yi, hole)
    on_boundary = _points_on_segments(xi, yi, poly.shell)
    for hole in poly.holes:
        on_boundary |= _points_on_segments(xi, yi, hole)
    if boundary:
        inside |= on_boundary
    else:
        inside &= ~on_boundary
    result[candidates] = inside
    return result


def points_in_geometry(x: np.ndarray, y: np.ndarray, geom: Geometry) -> np.ndarray:
    """Does each point intersect ``geom``? Dispatch over geometry type."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if isinstance(geom, Polygon):
        if geom.is_rectangle():
            return points_in_envelope(x, y, geom.envelope)
        return points_in_polygon(x, y, geom)
    if isinstance(geom, Point):
        return (x == geom.x) & (y == geom.y)
    if isinstance(geom, LineString):
        return _points_on_segments(x, y, geom.coords)
    if isinstance(geom, (MultiPolygon, MultiPoint, MultiLineString, GeometryCollection)):
        out = np.zeros(x.shape, dtype=bool)
        for g in geom.geoms:
            out |= points_in_geometry(x, y, g)
        return out
    raise ValueError(f"Unsupported geometry for point test: {type(geom)}")


def _segs_cross(p, q, a, b) -> bool:
    d1 = _orient(a, b, p)
    d2 = _orient(a, b, q)
    d3 = _orient(p, q, a)
    d4 = _orient(p, q, b)
    if ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0)):
        return True
    for pt, (u, v) in [(p, (a, b)), (q, (a, b)), (a, (p, q)), (b, (p, q))]:
        if _orient(u, v, pt) == 0 and _on_segment(u, v, pt):
            return True
    return False


def _orient(a, b, c) -> float:
    return (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])


def _on_segment(a, b, c) -> bool:
    return (
        min(a[0], b[0]) <= c[0] <= max(a[0], b[0])
        and min(a[1], b[1]) <= c[1] <= max(a[1], b[1])
    )


# ---------------------------------------------------------------------------
# exact geometry-geometry intersects / distance (the JTS relate subset)
# ---------------------------------------------------------------------------


def _rings(geom: Geometry):
    """All coordinate rings/paths of a geometry."""
    if isinstance(geom, Point):
        yield geom.coords
    elif isinstance(geom, LineString):
        yield geom.coords
    elif isinstance(geom, Polygon):
        yield geom.shell
        yield from geom.holes
    else:
        for g in geom.geoms:
            yield from _rings(g)


def _paths_cross(a: np.ndarray, b: np.ndarray) -> bool:
    for i in range(len(a) - 1):
        for j in range(len(b) - 1):
            if _segs_cross(a[i], a[i + 1], b[j], b[j + 1]):
                return True
    return False


def _paths_properly_cross(a: np.ndarray, b: np.ndarray) -> bool:
    """Proper (transversal) crossings only -- touching endpoints or running
    along a boundary does not count. Used by within-tests where boundary
    contact is allowed."""
    for i in range(len(a) - 1):
        p, q = a[i], a[i + 1]
        for j in range(len(b) - 1):
            u, v = b[j], b[j + 1]
            d1 = _orient(u, v, p)
            d2 = _orient(u, v, q)
            d3 = _orient(p, q, u)
            d4 = _orient(p, q, v)
            if ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0)) and 0 not in (d1, d2, d3, d4):
                return True
    return False


def geometries_intersect(g1: Geometry, g2: Geometry) -> bool:
    """Exact intersects for the supported types (boundary inclusive).

    Covers the combinations the post-filter needs: point/line/polygon and
    their multis. Envelope-rejects first, then tests containment of
    representative vertices plus pairwise edge crossings.
    """
    if not g1.envelope.intersects(g2.envelope):
        return False
    # axis-aligned rectangles ARE their envelopes: overlap decides exactly
    # (the dominant case in bbox post-filter rings)
    if g1.is_rectangle() and g2.is_rectangle():
        return True
    if isinstance(g1, (MultiPoint, MultiLineString, MultiPolygon, GeometryCollection)):
        return any(geometries_intersect(g, g2) for g in g1.geoms)
    if isinstance(g2, (MultiPoint, MultiLineString, MultiPolygon, GeometryCollection)):
        return any(geometries_intersect(g1, g) for g in g2.geoms)
    if isinstance(g1, Point):
        return bool(points_in_geometry(np.array([g1.x]), np.array([g1.y]), g2)[0])
    if isinstance(g2, Point):
        return bool(points_in_geometry(np.array([g2.x]), np.array([g2.y]), g1)[0])
    # line/polygon vs line/polygon: vertex containment either way, or edge cross
    p1 = next(iter(_rings(g1)))
    p2 = next(iter(_rings(g2)))
    if bool(points_in_geometry(p1[:1, 0], p1[:1, 1], g2)[0]):
        return True
    if bool(points_in_geometry(p2[:1, 0], p2[:1, 1], g1)[0]):
        return True
    for a in _rings(g1):
        for b in _rings(g2):
            if _paths_cross(a, b):
                return True
    return False


def points_within_geometry(x: np.ndarray, y: np.ndarray, geom: Geometry) -> np.ndarray:
    """JTS within for point arrays: interior containment, so points on a
    polygon boundary are excluded (unlike :func:`points_in_geometry`)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if isinstance(geom, Polygon):
        return points_in_polygon(x, y, geom, boundary=False)
    if isinstance(geom, (MultiPolygon, GeometryCollection, MultiPoint, MultiLineString)):
        out = np.zeros(x.shape, dtype=bool)
        for g in geom.geoms:
            out |= points_within_geometry(x, y, g)
        return out
    return points_in_geometry(x, y, geom)


def points_distance_to_geometry(
    x: np.ndarray, y: np.ndarray, geom: Geometry
) -> np.ndarray:
    """Exact degree-space distance from each point to ``geom`` (0 inside)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if isinstance(geom, Point):
        return np.sqrt((x - geom.x) ** 2 + (y - geom.y) ** 2)
    if isinstance(geom, (MultiPolygon, MultiPoint, MultiLineString, GeometryCollection)):
        out = np.full(x.shape, np.inf)
        for g in geom.geoms:
            out = np.minimum(out, points_distance_to_geometry(x, y, g))
        return out
    d2 = np.full(x.shape, np.inf)
    for ring in _rings(geom):
        if len(ring) == 1:
            d2 = np.minimum(d2, (x - ring[0, 0]) ** 2 + (y - ring[0, 1]) ** 2)
        for i in range(len(ring) - 1):
            a, b = ring[i], ring[i + 1]
            abx, aby = b[0] - a[0], b[1] - a[1]
            denom = abx * abx + aby * aby
            t = np.clip(
                ((x - a[0]) * abx + (y - a[1]) * aby) / (denom if denom else 1.0),
                0.0,
                1.0,
            )
            dx = x - (a[0] + t * abx)
            dy = y - (a[1] + t * aby)
            d2 = np.minimum(d2, dx * dx + dy * dy)
    dist = np.sqrt(d2)
    if isinstance(geom, Polygon):
        inside = points_in_polygon(x, y, geom)
        dist = np.where(inside, 0.0, dist)
    return dist


def geometry_within(g1: Geometry, g2: Geometry) -> bool:
    """g1 within g2 (g1 entirely contained; point-on-boundary excluded for
    point g1, matching JTS where within requires interior intersection)."""
    if not g2.envelope.contains_env(g1.envelope):
        return False
    if isinstance(g1, Point):
        if isinstance(g2, Polygon):
            return bool(
                points_in_polygon(np.array([g1.x]), np.array([g1.y]), g2, boundary=False)[0]
            )
        if isinstance(g2, (MultiPolygon, GeometryCollection)):
            return any(geometry_within(g1, g) for g in g2.geoms)
        return bool(points_in_geometry(np.array([g1.x]), np.array([g1.y]), g2)[0])
    if isinstance(g1, (MultiPoint, MultiLineString, MultiPolygon, GeometryCollection)):
        return all(geometry_within(g, g2) for g in g1.geoms)
    # every vertex and edge midpoint inside (hole-aware), and no edge
    # properly crossing any ring of g2 (boundary contact allowed)
    for path in _rings(g1):
        mask = points_in_geometry(path[:, 0], path[:, 1], g2)
        if not mask.all():
            return False
        if len(path) > 1:
            mx = (path[:-1, 0] + path[1:, 0]) / 2.0
            my = (path[:-1, 1] + path[1:, 1]) / 2.0
            if not points_in_geometry(mx, my, g2).all():
                return False
    for a in _rings(g1):
        for b in _rings(g2):
            if _paths_properly_cross(a, b):
                return False
    return True


def _seg_seg_dist2(p, q, a, b) -> float:
    """Squared distance between segments pq and ab."""
    if _segs_cross(p, q, a, b):
        return 0.0
    return min(
        _pt_seg_dist2(p, a, b),
        _pt_seg_dist2(q, a, b),
        _pt_seg_dist2(a, p, q),
        _pt_seg_dist2(b, p, q),
    )


def _pt_seg_dist2(c, a, b) -> float:
    abx, aby = b[0] - a[0], b[1] - a[1]
    denom = abx * abx + aby * aby
    if denom == 0:
        dx, dy = c[0] - a[0], c[1] - a[1]
        return dx * dx + dy * dy
    t = max(0.0, min(1.0, ((c[0] - a[0]) * abx + (c[1] - a[1]) * aby) / denom))
    dx = c[0] - (a[0] + t * abx)
    dy = c[1] - (a[1] + t * aby)
    return dx * dx + dy * dy


def geometry_distance(g1: Geometry, g2: Geometry) -> float:
    """Min euclidean (degree-space) distance; 0 when intersecting."""
    if geometries_intersect(g1, g2):
        return 0.0
    best = np.inf
    for a in _rings(g1):
        for b in _rings(g2):
            if len(a) == 1 and len(b) == 1:
                d2 = (a[0, 0] - b[0, 0]) ** 2 + (a[0, 1] - b[0, 1]) ** 2
            elif len(a) == 1:
                d2 = min(
                    _pt_seg_dist2(a[0], b[j], b[j + 1]) for j in range(len(b) - 1)
                )
            elif len(b) == 1:
                d2 = min(
                    _pt_seg_dist2(b[0], a[i], a[i + 1]) for i in range(len(a) - 1)
                )
            else:
                d2 = min(
                    _seg_seg_dist2(a[i], a[i + 1], b[j], b[j + 1])
                    for i in range(len(a) - 1)
                    for j in range(len(b) - 1)
                )
            best = min(best, d2)
    return float(np.sqrt(best))
