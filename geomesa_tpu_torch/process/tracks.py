"""Track processes: Point2Point, TrackLabel, HashAttribute, Join.

Port of ``geomesa_tpu/process/tracks.py``. Reference: geomesa-process
Point2PointProcess (consecutive points of a track -> line segments),
TrackLabelProcess (the latest point of each track), HashAttributeProcess
(a stable hash column for styling) and JoinProcess (an attribute join of
two types).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List

import numpy as np


def point2point(
    store,
    name: str,
    track_attr: str,
    cql: str = "INCLUDE",
    break_on_day: bool = False,
) -> List[Dict[str, Any]]:
    """Consecutive point pairs of each track as segments
    ``[{track, coords [[x0, y0], [x1, y1]], t0, t1}]``, in time order;
    ``break_on_day`` drops the pairs that cross a UTC day."""
    ft = store.get_schema(name)
    geom = ft.default_geometry.name
    dtg = ft.default_date.name if ft.default_date else None
    res = store.query(name, cql)
    if len(res) == 0:
        return []
    tracks = res.columns[track_attr]
    x = res.columns[geom + "__x"]
    y = res.columns[geom + "__y"]
    t = res.columns[dtg] if dtg else np.zeros(len(res), dtype=np.int64)
    out: List[Dict[str, Any]] = []
    for v in np.unique(tracks):
        idx = np.flatnonzero(tracks == v)
        idx = idx[np.argsort(t[idx], kind="stable")]
        for a, b in zip(idx, idx[1:]):
            if break_on_day and (t[a] // 86400000) != (t[b] // 86400000):
                continue
            out.append({
                "track": v,
                "coords": [[float(x[a]), float(y[a])], [float(x[b]), float(y[b])]],
                "t0": int(t[a]),
                "t1": int(t[b]),
            })
    return out


def track_labels(store, name: str, track_attr: str, cql: str = "INCLUDE") -> List[Dict[str, Any]]:
    """The latest feature of each track (TrackLabelProcess)."""
    ft = store.get_schema(name)
    geom = ft.default_geometry.name
    dtg = ft.default_date.name if ft.default_date else None
    res = store.query(name, cql)
    if len(res) == 0:
        return []
    tracks = res.columns[track_attr]
    t = res.columns[dtg] if dtg else np.zeros(len(res), dtype=np.int64)
    out = []
    for v in np.unique(tracks):
        idx = np.flatnonzero(tracks == v)
        last = idx[np.argmax(t[idx])]
        out.append({
            "track": v,
            "fid": str(res.fids[last]),
            "x": float(res.columns[geom + "__x"][last]),
            "y": float(res.columns[geom + "__y"][last]),
            "t": int(t[last]),
        })
    return out


def hash_attribute(values: np.ndarray, modulo: int) -> np.ndarray:
    """A stable hash of each value in [0, modulo) (HashAttributeProcess:
    blake2b of the value's text, so it is the same in every process)."""
    out = np.empty(len(values), dtype=np.int32)
    cache: Dict[Any, int] = {}
    for i, v in enumerate(values):
        h = cache.get(v)
        if h is None:
            h = int.from_bytes(
                hashlib.blake2b(str(v).encode(), digest_size=4).digest(), "little") % modulo
            cache[v] = h
        out[i] = h
    return out


def join(
    store,
    left: str,
    right: str,
    left_attr: str,
    right_attr: str,
    left_cql: str = "INCLUDE",
    right_cql: str = "INCLUDE",
) -> Dict[str, np.ndarray]:
    """Inner attribute join of two types (JoinProcess): the left result's
    columns, extended with the right's prefixed ``<right>.``; the first
    right row of a key wins."""
    lres = store.query(left, left_cql)
    rres = store.query(right, right_cql)
    lkey = lres.columns[left_attr]
    rkey = rres.columns[right_attr]
    rindex: Dict[Any, int] = {}
    for i, v in enumerate(rkey):
        rindex.setdefault(v, i)
    keep, rrows = [], []
    for i, v in enumerate(lkey):
        j = rindex.get(v)
        if j is not None:
            keep.append(i)
            rrows.append(j)
    keep_a = np.asarray(keep, dtype=np.int64)
    rrows_a = np.asarray(rrows, dtype=np.int64)
    out = {k: v[keep_a] for k, v in lres.columns.items()}
    for k, v in rres.columns.items():
        out[f"{right}.{k}"] = v[rrows_a]
    return out
