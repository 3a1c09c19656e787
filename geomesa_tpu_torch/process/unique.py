"""Unique attribute values over a query (the UniqueProcess analog).

Port of ``geomesa_tpu/process/unique.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def unique_values(
    store, name: str, attribute: str, cql: str = "INCLUDE", sort_by_count: bool = True
) -> List[Tuple[object, int]]:
    """[(value, count)] of ``attribute`` over the query's rows, nulls left
    out; by count (descending, ties by the value's text) unless
    ``sort_by_count`` is False (then by value)."""
    result = store.query(name, cql)
    if len(result) == 0:
        return []
    col = result.columns[attribute]
    nulls = result.columns.get(attribute + "__null")
    if nulls is not None:
        col = col[~nulls]
    if col.dtype.kind == "O":
        col = col[np.array([v is not None for v in col], dtype=bool)]
    uniq, counts = np.unique(col, return_counts=True)
    pairs = [(v.item() if isinstance(v, np.generic) else v, int(c)) for v, c in zip(uniq, counts)]
    if sort_by_count:
        pairs.sort(key=lambda vc: (-vc[1], str(vc[0])))
    return pairs
