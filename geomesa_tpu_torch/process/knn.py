"""k-nearest-neighbour search via the device top-k or expanding index queries.

Port of ``geomesa_tpu/process/knn.py``. Reference: KNearestNeighborSearchProcess
(knn/KNNQuery.scala, knn/GeoHashSpiral.scala) spirals outward over geohash
cells until k features are in hand and the k-th distance bounds the search.
Two paths answer here:

  * ``device-topk``: one ``knn_topk`` launch per segment of the point index
    ranks every resident row by its f32 haversine distance and returns a
    few candidates (``TorchScanExecutor.knn_candidates``); the host re-ranks
    them by the f64 distance;
  * ``host-bbox``: an expanding bbox over the Z2/Z3 index (doubling radius),
    with the same termination: once >= k candidates are found, one final
    query at the k-th distance guarantees no closer feature was missed.

``GEOMESA_KNN_DEVICE`` = ``auto`` (default) | ``1`` | ``0`` picks the path:
under auto the device answers when the store's executor runs on a CUDA
device whose measured round trip (``link_latency_ms``) is at most 10 ms. A
``cql`` filter always takes the host path, as does a type under age-off
(expired rows are masked by the query path only) or with visibility labels
(the executor declines). The device top-k runs under the executor's
breaker (``push_down``): while the circuit is open the host path answers,
and a device failure degrades the executor and trips the session's
device-kNN flag (``mesh.trip_device``): later calls take the host path
unless ``GEOMESA_KNN_DEVICE=1``. A ``QueryTimeout`` or a kernel that fails
to build raises. The device path skips ``store.query``, so it audits
itself, as the reference's does: the store's ``queries`` counter and
``query.scan`` timer and one ``QueryEvent`` (``scan_path`` =
``device-topk``, its receipt); the host path is audited by each bbox query
it issues. The reference's lazy partitions have no branch here.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
from torch.profiler import record_function

from geomesa_tpu_torch.process.geodesy import degrees_boxes, haversine_m

# auto device paths decline when one round trip costs more than this
_LINK_BUDGET_MS = 10.0

_PATH_LOCAL = threading.local()


def _bbox_cql(ft, boxes, extra: Optional[str]) -> str:
    geom = ft.default_geometry.name
    parts = [f"bbox({geom}, {b[0]!r}, {b[1]!r}, {b[2]!r}, {b[3]!r})" for b in boxes]
    cql = parts[0] if len(parts) == 1 else "(" + " OR ".join(parts) + ")"
    if extra:
        cql = f"({cql}) AND ({extra})"
    return cql


def _distances(ft, result, x: float, y: float) -> np.ndarray:
    geom = ft.default_geometry.name
    return haversine_m(result.columns[geom + "__x"], result.columns[geom + "__y"], x, y)


def knn_search(
    store,
    name: str,
    x: float,
    y: float,
    k: int = 10,
    initial_radius_m: float = 1000.0,
    max_radius_m: float = 2_000_000.0,
    cql: Optional[str] = None,
) -> List[Tuple[str, float]]:
    """[(fid, distance_m)] of the k nearest features to (x, y), ascending.
    Features beyond ``max_radius_m`` are never returned, on either path.

    ``last_knn_path()`` reports which path answered this thread's most
    recent call ("device-topk" | "host-bbox")."""
    from geomesa_tpu_torch.parallel.mesh import device_tripped

    _PATH_LOCAL.path = "host-bbox"
    ft = store.get_schema(name)
    if (cql is None and _device_knn_wanted(store)
            and not device_tripped(store.executor, "GEOMESA_KNN_DEVICE")):
        direct = _device_knn(store, name, ft, x, y, k, max_radius_m)
        if direct is not None:
            _PATH_LOCAL.path = "device-topk"
            return direct
    radius = float(initial_radius_m)
    while True:
        result = store.query(name, _bbox_cql(ft, degrees_boxes(x, y, radius), cql))
        if len(result) >= k or radius >= max_radius_m:
            break
        radius *= 2.0
    if len(result) == 0:
        return []
    d = _distances(ft, result, x, y)
    order = np.argsort(d, kind="stable")[:k]
    kth = float(d[order[-1]])
    # the bbox is not a circle: if the k-th distance exceeds the scanned
    # radius, a closer feature may sit in the circle's corners: requery at
    # the k-th distance to close the search (KNNQuery's final window)
    if kth > radius and radius < max_radius_m:
        result = store.query(name, _bbox_cql(ft, degrees_boxes(x, y, kth), cql))
        d = _distances(ft, result, x, y)
        order = np.argsort(d, kind="stable")[:k]
    fids = result.fids
    return [(str(fids[i]), float(d[i])) for i in order if d[i] <= max_radius_m]


def _device_knn_wanted(store) -> bool:
    """The path choice: ``GEOMESA_KNN_DEVICE`` = 1 (device) | 0 (host) |
    auto: the device when the store's executor runs on a CUDA device and
    one round trip to it costs at most ``_LINK_BUDGET_MS`` (the one-pass
    top-k ranks every resident row, a bargain on a local card, a full scan
    on the host where the expanding bbox touches only candidate cells)."""
    env = os.environ.get("GEOMESA_KNN_DEVICE", "auto")
    if env == "0":
        return False
    if env == "1":
        return True
    device = getattr(store.executor, "device", None)
    if device is None or device.type != "cuda":
        return False
    from geomesa_tpu_torch.parallel.mesh import link_latency_ms

    return link_latency_ms(device) <= _LINK_BUDGET_MS


def last_knn_path() -> str:
    """Which path answered this thread's most recent knn_search call
    ("device-topk" | "host-bbox"; "?" before any call)."""
    return getattr(_PATH_LOCAL, "path", "?")


def _device_knn(store, name: str, ft, x: float, y: float, k: int,
                max_radius_m: float = np.inf):
    """The device top-k (``executor.knn_candidates``): every segment ranks
    its rows and returns its candidates; the exact f64 re-rank is here
    (``geomesa.rerank`` in a profiler trace).
    None when the store's executor has no device top-k, the type no point
    index or a retention window, the circuit is open or the device call
    failed (degraded; the session's device-kNN flag trips)."""
    from geomesa_tpu_torch.utils import devstats

    t0 = time.perf_counter()
    with devstats.collecting() as own:
        out = _device_knn_rows(store, name, ft, x, y, k, max_radius_m)
    if out is not None:
        _audit_knn(store, name, x, y, k, len(out), t0, devstats.receipt_of(own))
    return out


def _audit_knn(store, name: str, x: float, y: float, k: int, hits: int, t0: float,
               receipt) -> None:
    """The device path's own audit (it skips ``store.query``)."""
    if store.metrics is not None:
        store.metrics.inc("queries")
        store.metrics.update_timer("query.scan", time.perf_counter() - t0)
    if store.audit_writer is not None:
        from geomesa_tpu_torch.utils.audit import QueryEvent

        store.audit_writer.write_event(QueryEvent(
            store=type(store).__name__,
            type_name=name,
            user=store.user,
            filter=f"KNN({x}, {y}, k={k})",
            hints={"knn": k},
            date_ms=int(time.time() * 1000),
            planning_ms=0.0,
            scanning_ms=1000 * (time.perf_counter() - t0),
            hits=hits,
            scan_path="device-topk",
            recompiles=int(receipt["recompiles"]),
            h2d_bytes=int(receipt["h2d_bytes"]),
            d2h_bytes=int(receipt["d2h_bytes"]),
            pad_ratio=float(receipt["pad_ratio"]),
        ))


def _device_knn_rows(store, name: str, ft, x: float, y: float, k: int,
                     max_radius_m: float):
    from geomesa_tpu_torch.parallel.executor import HOST_DEGRADED, HostRoute
    from geomesa_tpu_torch.parallel.mesh import trip_device

    knn = getattr(store.executor, "knn_candidates", None)
    if knn is None:
        return None
    if store._age_off_cutoff(ft) is not None:
        return None  # expired rows are masked by the query path only
    tables = store._tables.get(name, {})
    table = tables.get("z3") or tables.get("z2")
    if table is None or table.num_rows == 0:
        return None
    parts = store.executor.push_down(table, knn, table, x, y, k)
    if parts is HOST_DEGRADED:
        trip_device(store.executor, "GEOMESA_KNN_DEVICE", "knn",
                    RuntimeError("the device top-k failed"))
        return None
    if parts is None or isinstance(parts, HostRoute):
        return None
    geom = ft.default_geometry.name
    fids: List[str] = []
    dists: List[np.ndarray] = []
    seen = set()
    with record_function("geomesa.rerank"):
        for block, rows in parts:
            px = block.gather(geom + "__x", rows)
            py = block.gather(geom + "__y", rows)
            bf = block.gather("__fid__", rows)
            keep = [i for i, f in enumerate(bf) if f not in seen]
            seen.update(bf[keep])
            fids.extend(bf[keep])
            dists.append(haversine_m(px[keep], py[keep], x, y))
        if not fids:
            return []
        d = np.concatenate(dists)
        order = np.argsort(d, kind="stable")[:k]
        return [(str(fids[i]), float(d[i])) for i in order if d[i] <= max_radius_m]
