"""Shared geodesic helpers for the process layer (port of
``geomesa_tpu/process/geodesy.py``, numpy, copied).

Haversine distance on the WGS84 mean sphere — the role the reference's
GeoHashUtils/VincentyModel math plays for KNN and proximity searches.
"""

from __future__ import annotations

import numpy as np

EARTH_RADIUS_M = 6371008.8


def haversine_m(lon1, lat1, lon2, lat2) -> np.ndarray:
    """Great-circle distance in meters; broadcasts over numpy inputs."""
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(v, dtype=np.float64)) for v in (lon1, lat1, lon2, lat2))
    dlon = lon2 - lon1
    dlat = lat2 - lat1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.minimum(1.0, np.sqrt(a)))


def degrees_boxes(x: float, y: float, radius_m: float):
    """Wrap-aware cap cover: one lon/lat box, or TWO when the cap crosses
    the antimeridian (the single-box form clamps at +-180 and silently
    drops the wrapped lune — fatal for kNN near the dateline)."""
    c = radius_m / EARTH_RADIUS_M
    dlat = float(np.degrees(c))
    lat_lo = max(-90.0, float(y) - dlat)
    lat_hi = min(90.0, float(y) + dlat)
    sin_ratio = float(np.sin(min(c, np.pi / 2)) / max(1e-9, np.cos(np.radians(y))))
    if lat_hi >= 90.0 or lat_lo <= -90.0 or sin_ratio >= 1.0:
        return [(-180.0, lat_lo, 180.0, lat_hi)]
    dlon = float(np.degrees(np.arcsin(sin_ratio)))
    lo, hi = float(x) - dlon, float(x) + dlon
    if lo >= -180.0 and hi <= 180.0:
        return [(lo, lat_lo, hi, lat_hi)]
    boxes = [(max(-180.0, lo), lat_lo, min(180.0, hi), lat_hi)]
    if lo < -180.0:
        boxes.append((lo + 360.0, lat_lo, 180.0, lat_hi))
    if hi > 180.0:
        boxes.append((-180.0, lat_lo, hi - 360.0, lat_hi))
    return boxes


def degrees_box(x: float, y: float, radius_m: float):
    """Conservative lon/lat bbox containing the radius_m circle around (x, y).

    The max longitudinal half-width of a spherical cap is
    asin(sin(c) / cos(lat)) with c the angular radius — NOT c / cos(lat),
    which under-covers at high latitude. If the cap reaches a pole every
    longitude is included.
    """
    c = radius_m / EARTH_RADIUS_M  # angular radius
    dlat = float(np.degrees(c))
    lat_lo = max(-90.0, float(y) - dlat)
    lat_hi = min(90.0, float(y) + dlat)
    sin_ratio = float(np.sin(min(c, np.pi / 2)) / max(1e-9, np.cos(np.radians(y))))
    if lat_hi >= 90.0 or lat_lo <= -90.0 or sin_ratio >= 1.0:
        return (-180.0, lat_lo, 180.0, lat_hi)
    dlon = float(np.degrees(np.arcsin(sin_ratio)))
    return (
        max(-180.0, float(x) - dlon),
        lat_lo,
        min(180.0, float(x) + dlon),
        lat_hi,
    )
