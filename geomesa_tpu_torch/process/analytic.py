"""Analytic WPS-process analogs that delegate to the query engine.

Port of ``geomesa_tpu/process/analytic.py``: the remaining
geomesa-process-vector entries (GeoMesaProcessFactory SPI), each a
one-call name for a capability the store exposes through query hints or
the stats layer.

  MinMaxProcess        -> min_max           (the MinMax sketch, else a scan)
  StatsProcess         -> stats_process     (the stats hint)
  SamplingProcess      -> sampling_process  (the sampling hint)
  QueryProcess         -> query_process     (a plain CQL query)
  DensityProcess       -> density_process   (the density hint: the
                                             ``density_grid`` push-down)
  ArrowConversionProcess -> arrow_conversion (raises: the arrow reducer
                                             is Queue 1 item 19)
  BinConversionProcess -> bin_conversion    (the bin hint)
"""

from __future__ import annotations

from typing import Any

import numpy as np

from geomesa_tpu_torch.index.planner import Query


def query_process(store, name: str, cql: str = "INCLUDE"):
    """QueryProcess.scala: run a CQL query, return the result."""
    return store.query(name, cql)


def min_max(store, name: str, attribute: str, cql: str = "INCLUDE", exact: bool = False):
    """MinMaxProcess.scala: (min, max) of an attribute, from the write-time
    MinMax sketch where it can answer (``exact=False``, no filter), else by
    scanning. The sketches saw every row, so a labelled or aging type
    always scans (the gates of ``count``). A file store's blocks may not
    be loaded: its durable ``geomesa.vis`` marker stands in for them
    (absent on a legacy store: scan)."""
    ft = store.get_schema(name)
    if hasattr(store, "_files"):
        has_vis = store.metadata.read(name, "geomesa.vis") != "false"
    else:
        has_vis = store._has_vis(name)
    expiring = store._age_off_cutoff(ft) is not None
    if not exact and cql == "INCLUDE" and store.stats is not None and not has_vis \
            and not expiring:
        sk = store.stats.stats_for(ft).get(f"minmax:{attribute}")
        if sk is not None and not sk.is_empty:
            return sk.min, sk.max
    res = store.query(name, cql)
    col = res.columns[attribute]
    nulls = res.columns.get(attribute + "__null")
    if nulls is not None:
        col = col[~nulls]
    if not len(col):
        return None, None
    return col.min(), col.max()


def stats_process(store, name: str, stat_spec: str, cql: str = "INCLUDE") -> Any:
    """StatsProcess.scala: a stat-spec string over the query's rows."""
    q = Query.cql(cql)
    q.hints["stats"] = stat_spec
    return store.query(name, q).aggregate["stats"]


def sampling_process(store, name: str, n: int, cql: str = "INCLUDE"):
    """SamplingProcess.scala: thin the features to about ``n`` with the
    sampling hint (a rate from the estimated count, as SamplingIterator)."""
    total = max(1, store.count(name, cql, exact=False))
    q = Query.cql(cql)
    q.hints["sampling"] = min(1.0, n / total)
    return store.query(name, q)


def density_process(store, name: str, envelope, width: int, height: int,
                    cql: str = "INCLUDE") -> np.ndarray:
    """DensityProcess.scala: the heat-map grid of the density push-down."""
    q = Query.cql(cql)
    q.hints["density"] = {"envelope": envelope, "width": int(width), "height": int(height)}
    return store.query(name, q).aggregate["density"]


def arrow_conversion(store, name: str, cql: str = "INCLUDE", **spec) -> bytes:
    """ArrowConversionProcess.scala: not ported. The arrow reducer and
    ``arrow/`` are Queue 1 item 19 (``index/aggregators.py`` raises for the
    ``arrow`` hint the same way)."""
    raise NotImplementedError(
        "arrow_conversion is not ported: the arrow reducer is Queue 1 item 19")


def bin_conversion(store, name: str, cql: str = "INCLUDE", track: str = "id") -> bytes:
    """BinConversionProcess.scala: the results as packed BIN records."""
    q = Query.cql(cql)
    q.hints["bin"] = {"track": track}
    recs = store.query(name, q).aggregate["bin"]
    return recs.tobytes() if hasattr(recs, "tobytes") else recs
