"""Aggregation hints: the host reducers of the density, stats and bin hints.

Port of ``geomesa_tpu/index/aggregators.py`` without ``arrow``: the host
reducers (DensityScan.scala:30-59 with GridSnap semantics; StatsScan;
BinaryOutputEncoder's BIN records) that answer an aggregating query
whenever the device push-down declines, and that certify the device's
density band rows (``TorchScanExecutor._certify_density_band``).

Hint shapes (conf/QueryHints.scala analogs):
  hints["density"] = {"envelope": (xmin, ymin, xmax, ymax),
                      "width": int, "height": int, "weight": attr | None}
  hints["stats"]   = "MinMax(a);Count()"  (a stat spec, ``stats/parser.py``)
  hints["bin"]     = {"track": attr | "id", "geom": attr | None,
                      "dtg": attr | None, "label": attr | None,
                      "sort": bool}

The ``arrow`` reducer needs ``geomesa_tpu/arrow/``, which is not ported
(ROADMAP Queue 1 item 19): ``run_aggregation`` raises for it.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional

import numpy as np

from geomesa_tpu_torch.schema.featuretype import FeatureType
from geomesa_tpu_torch.stats.parser import parse_stat
from geomesa_tpu_torch.stats.sketches import (
    EnvelopeStat,
    GroupByStat,
    MinMax,
    Stat,
    Z3FrequencyStat,
    Z3HistogramStat,
)

AGGREGATION_HINTS = ("density", "stats", "bin", "arrow")


def has_aggregation(hints: Dict[str, Any]) -> bool:
    return any(k in hints for k in AGGREGATION_HINTS)


def density_grid_numpy(
    x: np.ndarray,
    y: np.ndarray,
    weight: Optional[np.ndarray],
    env,
    width: int,
    height: int,
) -> np.ndarray:
    """Host density grid with GridSnap semantics (GridSnap.scala:1-120):
    f64 cell = floor((v - min) / ((max - min) / n)), clipped into the grid;
    rows outside the envelope count nowhere."""
    xmin, ymin, xmax, ymax = env
    dx = (xmax - xmin) / width
    dy = (ymax - ymin) / height
    in_env = (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
    col = np.clip(np.floor((x[in_env] - xmin) / dx).astype(np.int64), 0, width - 1)
    row = np.clip(np.floor((y[in_env] - ymin) / dy).astype(np.int64), 0, height - 1)
    w = weight[in_env] if weight is not None else np.ones(int(in_env.sum()))
    grid = np.zeros((height, width), dtype=np.float64)
    np.add.at(grid, (row, col), w)
    return grid


def run_density(ft: FeatureType, spec: Dict[str, Any], columns) -> np.ndarray:
    geom = ft.default_geometry.name
    x = columns.get(geom + "__x")
    y = columns.get(geom + "__y")
    if x is None:
        raise ValueError("density requires a point geometry")
    weight = None
    if spec.get("weight"):
        weight = np.asarray(columns[spec["weight"]], dtype=np.float64)
    return density_grid_numpy(
        x, y, weight, tuple(spec["envelope"]), int(spec["width"]), int(spec["height"])
    )


def run_stats(ft: FeatureType, spec: str, columns) -> Stat:
    """The stat ``spec`` observed over the filtered columns (StatsScan's
    reduce): a MinMax of the default geometry becomes its 2D envelope
    (``EnvelopeStat``), the z3 sketches take the geometry's coordinates and
    the date, GroupBy groups by its attribute's decoded values."""
    stat = parse_stat(spec)
    stats = stat.stats if hasattr(stat, "stats") else [stat]
    geom = ft.default_geometry
    n = len(next(iter(columns.values()), []))
    for i, s in enumerate(stats):
        if isinstance(s, (Z3HistogramStat, Z3FrequencyStat)):
            s.observe_xyt(columns[s.geom + "__x"], columns[s.geom + "__y"], columns[s.dtg])
            continue
        if isinstance(s, GroupByStat):
            _observe_groupby(s, columns)
            continue
        attr = getattr(s, "attribute", None)
        if attr is None:  # CountStat
            s.count += n
            continue
        if geom is not None and attr == geom.name and isinstance(s, MinMax):
            env = EnvelopeStat(attr)
            env.observe_xy(
                np.asarray(columns[attr + "__x"], dtype=np.float64),
                np.asarray(columns[attr + "__y"], dtype=np.float64),
            )
            stats[i] = env
            if stats is not getattr(stat, "stats", None):
                stat = env
            continue
        s.observe(columns[attr], columns.get(attr + "__null"))
    return stat


def _observe_groupby(s: GroupByStat, columns) -> None:
    """GroupBy over the filtered columns: keys from the grouping attribute,
    values from the sub-stat's own attribute (a Count() sub-stat needs the
    group sizes only). Dictionary columns decode to their values, and null
    keys form no group."""

    def col_values(name):
        col = np.asarray(columns[name])
        vocab = columns.get(name + "__vocab")
        if vocab is not None:
            v = np.asarray(vocab, dtype=object)
            out = np.empty(len(col), dtype=object)
            ok = col >= 0
            out[ok] = v[col[ok].astype(np.int64)]
            return out
        nulls = columns.get(name + "__null")
        if nulls is not None:
            # decoded columns carry nulls as fill values ("" / 0)
            out = np.asarray(col, dtype=object).copy()
            out[np.asarray(nulls, dtype=bool)] = None
            return out
        return col

    keys = col_values(s.attribute)
    sub_attr = json.loads(s.example).get("attribute")
    if sub_attr is None:
        values = keys  # Count(): only group sizes matter
    elif sub_attr in columns:
        values = col_values(sub_attr)
    else:
        raise KeyError(f"GroupBy sub-stat attribute {sub_attr!r} not gathered")
    nulls = columns.get((sub_attr or s.attribute) + "__null")
    s.observe_grouped(keys, values, nulls)


# 16-byte BIN record: trackId hash (i32) | dtg seconds (i32) | lat f32 | lon f32;
# the 24-byte record adds the label (8 bytes). BinaryOutputEncoder.scala:28-360.
BIN_DTYPE = np.dtype(
    [("track", "<i4"), ("dtg", "<i4"), ("lat", "<f4"), ("lon", "<f4")]
)
BIN_DTYPE_LABEL = np.dtype(
    [("track", "<i4"), ("dtg", "<i4"), ("lat", "<f4"), ("lon", "<f4"), ("label", "<i8")]
)


def _track_ids(values: np.ndarray) -> np.ndarray:
    """Stable 32-bit ids of track values: numbers cast, anything else the
    little-endian signed 4-byte blake2b of its string (the reference's
    hashCode analog)."""
    if values.dtype.kind in "iuf":
        return values.astype(np.int32)
    out = np.empty(len(values), dtype=np.int32)
    cache: Dict[Any, int] = {}
    for i, v in enumerate(values):
        h = cache.get(v)
        if h is None:
            h = int.from_bytes(hashlib.blake2b(str(v).encode(), digest_size=4).digest(),
                               "little", signed=True)
            cache[v] = h
        out[i] = h
    return out


def run_bin(ft: FeatureType, spec: Dict[str, Any], columns) -> np.ndarray:
    """The BIN records of the filtered rows (``BIN_DTYPE``, or
    ``BIN_DTYPE_LABEL`` with a label): track id, date in seconds, lat, lon;
    ``sort`` orders them by date (stable)."""
    geom = spec.get("geom") or ft.default_geometry.name
    dtg = spec.get("dtg") or (ft.default_date.name if ft.default_date else None)
    track = spec["track"]
    n = len(next(iter(columns.values()), []))
    dtype = BIN_DTYPE_LABEL if spec.get("label") else BIN_DTYPE
    out = np.zeros(n, dtype=dtype)
    track_col = columns.get(track)
    if track_col is None and track == "id":
        track_col = columns["__fid__"]
    out["track"] = _track_ids(np.asarray(track_col))
    if dtg is not None:
        out["dtg"] = (np.asarray(columns[dtg], dtype=np.int64) // 1000).astype(np.int32)
    out["lat"] = np.asarray(columns[geom + "__y"], dtype=np.float32)
    out["lon"] = np.asarray(columns[geom + "__x"], dtype=np.float32)
    if spec.get("label"):
        out["label"] = _track_ids(np.asarray(columns[spec["label"]])).astype(np.int64)
    if spec.get("sort") and dtg is not None:
        out = out[np.argsort(out["dtg"], kind="stable")]
    return out


def run_aggregation(ft: FeatureType, hints: Dict[str, Any], columns) -> Dict[str, Any]:
    """Dispatch the requested aggregations over the filtered columns."""
    if "arrow" in hints:
        raise NotImplementedError(
            "the arrow aggregation is not ported yet: it needs geomesa_tpu/arrow/ "
            "(ROADMAP Queue 1 item 19)"
        )
    out: Dict[str, Any] = {}
    if "density" in hints:
        out["density"] = run_density(ft, hints["density"], columns)
    if "stats" in hints:
        out["stats"] = run_stats(ft, hints["stats"], columns)
    if "bin" in hints:
        out["bin"] = run_bin(ft, hints["bin"], columns)
    return out
