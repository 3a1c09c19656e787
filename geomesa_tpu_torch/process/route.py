"""Route search: features along a route, heading-matched.

Port of ``geomesa_tpu/process/route.py``. The RouteSearchProcess analog
(geomesa-process-vector query/RouteSearchProcess.scala): finds features
within a buffer (meters) of a route LineString whose headings align with
the route's local direction: following the route, not just crossing it.

The per-feature JTS distance/projection loop becomes one vectorized (N
points x S segments) matrix pass: point-to-segment distance in a local
equirectangular frame and per-segment forward azimuths computed once for
the whole batch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from geomesa_tpu_torch.geom.base import LineString

_R = 6_371_008.8  # mean earth radius, meters


def _segment_bearings(coords: np.ndarray) -> np.ndarray:
    """Forward azimuth (degrees from north, clockwise) per segment."""
    lon1, lat1 = np.radians(coords[:-1, 0]), np.radians(coords[:-1, 1])
    lon2, lat2 = np.radians(coords[1:, 0]), np.radians(coords[1:, 1])
    dlon = lon2 - lon1
    x = np.sin(dlon) * np.cos(lat2)
    y = np.cos(lat1) * np.sin(lat2) - np.sin(lat1) * np.cos(lat2) * np.cos(dlon)
    return (np.degrees(np.arctan2(x, y)) + 360.0) % 360.0


def _point_segment_distances_m(
    px: np.ndarray, py: np.ndarray, coords: np.ndarray
) -> np.ndarray:
    """(N, S) meters from each point to each route segment, equirectangular
    local frame (exact enough inside realistic buffer sizes)."""
    lat0 = np.radians(np.mean(coords[:, 1]))
    kx = np.cos(lat0) * np.pi / 180.0 * _R
    ky = np.pi / 180.0 * _R
    ax, ay = coords[:-1, 0] * kx, coords[:-1, 1] * ky  # (S,)
    bx, by = coords[1:, 0] * kx, coords[1:, 1] * ky
    qx, qy = (px * kx)[:, None], (py * ky)[:, None]  # (N,1)
    dx, dy = (bx - ax)[None, :], (by - ay)[None, :]  # (1,S)
    len2 = dx * dx + dy * dy
    t = ((qx - ax[None, :]) * dx + (qy - ay[None, :]) * dy) / np.where(len2 == 0, 1, len2)
    t = np.clip(t, 0.0, 1.0)
    cx = ax[None, :] + t * dx
    cy = ay[None, :] + t * dy
    return np.hypot(qx - cx, qy - cy)


def match_route(
    px: np.ndarray,
    py: np.ndarray,
    headings: Optional[np.ndarray],
    route: LineString,
    buffer_m: float,
    heading_threshold: float,
    bidirectional: bool = False,
) -> np.ndarray:
    """Boolean mask of points within ``buffer_m`` of the route whose heading
    is within ``heading_threshold`` degrees of the nearest segment's azimuth
    (mod 180 when bidirectional)."""
    coords = np.asarray(route.coords, dtype=np.float64)
    if len(coords) < 2 or not len(px):
        return np.zeros(len(px), dtype=bool)
    d = _point_segment_distances_m(np.asarray(px, float), np.asarray(py, float), coords)
    nearest = np.argmin(d, axis=1)
    in_buffer = d[np.arange(len(px)), nearest] <= buffer_m
    if headings is None:
        return in_buffer
    bearings = _segment_bearings(coords)[nearest]
    diff = np.abs((np.asarray(headings, float) - bearings + 180.0) % 360.0 - 180.0)
    if bidirectional:
        diff = np.minimum(diff, 180.0 - diff)
    return in_buffer & (diff <= heading_threshold)


def route_search(
    store,
    name: str,
    routes: Sequence[LineString],
    buffer_m: float,
    heading_threshold: float,
    heading_attr: Optional[str] = None,
    cql: str = "INCLUDE",
    bidirectional: bool = False,
) -> List[str]:
    """Feature ids along any of the routes (store-level entry point)."""
    ft = store.get_schema(name)
    geom = ft.default_geometry.name
    res = store.query(name, cql)
    if len(res) == 0:
        return []
    px = res.columns[geom + "__x"]
    py = res.columns[geom + "__y"]
    headings = None
    if heading_attr is not None:
        headings = np.asarray(res.columns[heading_attr], dtype=np.float64)
        nulls = res.columns.get(heading_attr + "__null")
        if nulls is not None:
            # a feature without a heading cannot be route-following
            # (NaN fails every threshold compare)
            headings = np.where(nulls, np.nan, headings)
    mask = np.zeros(len(px), dtype=bool)
    for route in routes:
        mask |= match_route(
            px, py, headings, route, buffer_m, heading_threshold, bidirectional
        )
    return [str(f) for f in np.asarray(res.fids)[mask]]
