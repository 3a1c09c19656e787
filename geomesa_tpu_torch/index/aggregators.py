"""Aggregation hints: the host reducer of the density push-down.

Port of ``geomesa_tpu/index/aggregators.py`` limited to density: the host
reducer (DensityScan.scala:30-59 with GridSnap semantics) that answers a
density query whenever the device push-down declines, and that certifies
the device's band rows (``TorchScanExecutor._certify_density_band``).

Hint shape (conf/QueryHints.scala analog):
  hints["density"] = {"envelope": (xmin, ymin, xmax, ymax),
                      "width": int, "height": int, "weight": attr | None}

The ``stats``, ``bin`` and ``arrow`` reducers are not in this slice of the
port (ROADMAP Queue 1 item 9 and the aggregation items after it):
``run_aggregation`` raises for them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from geomesa_tpu_torch.schema.featuretype import FeatureType

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


def run_aggregation(ft: FeatureType, hints: Dict[str, Any], columns) -> Dict[str, Any]:
    """Dispatch the requested aggregations over the filtered columns."""
    missing = [k for k in ("stats", "bin", "arrow") if k in hints]
    if missing:
        raise NotImplementedError(
            f"aggregation hints {missing} are not ported yet "
            "(ROADMAP Queue 1 item 9: count and stats; bin and arrow follow it)"
        )
    out: Dict[str, Any] = {}
    if "density" in hints:
        out["density"] = run_density(ft, hints["density"], columns)
    return out
