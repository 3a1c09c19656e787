"""Proximity search: features within a distance of any input point.

Port of ``geomesa_tpu/process/proximity.py``. Reference:
ProximitySearchProcess (geomesa-process) buffers the input features and
runs a DWITHIN; here each input point contributes conservative bboxes
(``degrees_boxes``) to ONE query, an OR of bboxes that the port answers
through its residual-OR route, and an exact haversine test keeps the
candidates within the distance.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.process.geodesy import degrees_boxes, haversine_m


def proximity_search(
    store,
    name: str,
    points: Sequence[Tuple[float, float]],
    distance_m: float,
    cql: Optional[str] = None,
):
    """QueryResult of the features within ``distance_m`` of ANY input
    point; its ``scan_path`` is the candidate query's route."""
    from geomesa_tpu_torch.store.blocks import take_rows
    from geomesa_tpu_torch.store.datastore import QueryResult

    ft = store.get_schema(name)
    geom = ft.default_geometry.name
    boxes = [b for x, y in points for b in degrees_boxes(x, y, distance_m)]
    parts = " OR ".join(f"bbox({geom}, {b[0]!r}, {b[1]!r}, {b[2]!r}, {b[3]!r})" for b in boxes)
    q = f"({parts})" if parts else "EXCLUDE"
    if cql:
        q = f"{q} AND ({cql})"
    result = store.query(name, q)
    if len(result) == 0:
        return result
    xs = result.columns[geom + "__x"]
    ys = result.columns[geom + "__y"]
    keep = np.zeros(len(result), dtype=bool)
    for x, y in points:
        keep |= haversine_m(xs, ys, x, y) <= distance_m
    return QueryResult(ft, take_rows(result.columns, np.flatnonzero(keep)), result.plan,
                       scan_path=result.scan_path)
