"""Tube select: spatio-temporal corridor search along a track.

Port of ``geomesa_tpu/process/tube.py``: one ``store.query`` (bbox AND
``dtg BETWEEN``) gives the candidates through the port's own routes, the
corridor test runs on the host, and the result is built with the port's
``take_rows`` / ``QueryResult``.

Reference: TubeSelectProcess / tube/TubeBuilder.scala — an input track
(points + times) is buffered in space and time and features inside the
moving corridor are returned. The track is resampled to a max gap, each
sample contributes an index bbox + time window, and the exact test keeps a
feature when it is within the buffer of a sample whose time is within the
time buffer (the reference's "interpolated gap" builder).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.process.geodesy import degrees_boxes, haversine_m


def _resample(track, max_gap_m: float):
    """Insert interpolated samples so adjacent samples are <= max_gap_m apart."""
    out = [track[0]]
    for (x0, y0, t0), (x1, y1, t1) in zip(track, track[1:]):
        d = float(haversine_m(x0, y0, x1, y1))
        steps = max(1, int(np.ceil(d / max_gap_m)))
        for s in range(1, steps + 1):
            f = s / steps
            out.append((x0 + (x1 - x0) * f, y0 + (y1 - y0) * f, t0 + (t1 - t0) * f))
    return out


def tube_select(
    store,
    name: str,
    track: Sequence[Tuple[float, float, int]],
    buffer_m: float = 1000.0,
    time_buffer_ms: int = 600_000,
    cql: Optional[str] = None,
    max_gap_m: Optional[float] = None,
):
    """QueryResult of features inside the corridor around ``track``
    ([(lon, lat, t_ms)] ordered by time)."""
    from geomesa_tpu_torch.store.blocks import take_rows
    from geomesa_tpu_torch.store.datastore import QueryResult

    if not track:
        raise ValueError("empty track")
    ft = store.get_schema(name)
    geom = ft.default_geometry.name
    dtg = ft.default_date.name if ft.default_date else None
    samples = _resample(list(track), max_gap_m or max(buffer_m * 2, 1.0))

    # one covering query: union bbox + overall time window (the planner
    # decomposes it; per-sample precision comes from the exact pass below)
    xs = [s[0] for s in samples]
    ys = [s[1] for s in samples]
    boxes = [b for x, y in zip(xs, ys) for b in degrees_boxes(x, y, buffer_m)]
    xmin = min(b[0] for b in boxes)
    ymin = min(b[1] for b in boxes)
    xmax = max(b[2] for b in boxes)
    ymax = max(b[3] for b in boxes)
    q = f"bbox({geom}, {xmin!r}, {ymin!r}, {xmax!r}, {ymax!r})"
    if dtg is not None:
        t_lo = int(min(s[2] for s in samples)) - time_buffer_ms
        t_hi = int(max(s[2] for s in samples)) + time_buffer_ms
        lo = np.datetime64(t_lo, "ms").astype("datetime64[ms]").item().isoformat() + "Z"
        hi = np.datetime64(t_hi, "ms").astype("datetime64[ms]").item().isoformat() + "Z"
        q = f"{q} AND {dtg} BETWEEN '{lo}' AND '{hi}'"
    if cql:
        q = f"({q}) AND ({cql})"
    result = store.query(name, q)
    if len(result) == 0:
        return result

    fx = np.asarray(result.columns[geom + "__x"], dtype=np.float64)
    fy = np.asarray(result.columns[geom + "__y"], dtype=np.float64)
    keep = np.zeros(len(result), dtype=bool)
    st = np.asarray([s[2] for s in samples], dtype=np.float64)
    ft_ms = (
        np.asarray(result.columns[dtg], dtype=np.float64) if dtg is not None else None
    )
    # [N, M] distance against samples, chunked to bound memory
    chunk = max(1, 4_000_000 // max(len(samples), 1))
    for s0 in range(0, len(result), chunk):
        s1 = min(s0 + chunk, len(result))
        d = haversine_m(
            fx[s0:s1, None], fy[s0:s1, None], np.asarray(xs)[None, :], np.asarray(ys)[None, :]
        )
        ok = d <= buffer_m
        if ft_ms is not None:
            ok &= np.abs(ft_ms[s0:s1, None] - st[None, :]) <= time_buffer_ms
        keep[s0:s1] = ok.any(axis=1)
    return QueryResult(ft, take_rows(result.columns, np.flatnonzero(keep)), result.plan)
