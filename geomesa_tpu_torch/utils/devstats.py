"""Device telemetry: link bytes, kernel builds, padding and HBM gauges,
and the per-query cost receipt.

The port's analog of ``geomesa_tpu/utils/devstats.py``. One process-wide
``MetricsRegistry`` (``devstats_metrics()``) holds:

    device.h2d.bytes          host -> device bytes (counter), fed by the one
                              counted upload, ``parallel/mesh.py`` ``upload``
    device.d2h.bytes          device -> host bytes (counter), fed by the one
                              counted fetch, ``parallel/mesh.py`` ``fetch``
                              (the executor's ``_np_local``)
    device.pad.*              a segment's real rows against the rows it pads
                              to (``record_pad``): the latest upload's
                              ``rows_used`` / ``rows_capacity`` / ``ratio``
                              gauges, the ``events`` and ``rows_*_total``
                              counters
    kernel.build.<name>       kernel library builds (``nvcc``) by source,
    kernel.build.total        where the reference counts XLA recompiles
                              (``xla.compile.*``); ``kernel.build`` times them
    kernel.launch.total       kernel launches (counter)
    device.hbm.*              ``torch.cuda`` memory gauges (0 on the CPU)
    batch.coalesce.*          the coalescer's groups, members, group-size
                              histogram and stacked / rest plans

A query's receipt (``receipt_snapshot`` / ``receipt_since`` around it, or
``collecting`` for costs exact under concurrency) holds ``recompiles`` (the
reference's key: here the kernel builds the query triggered),
``h2d_bytes``, ``d2h_bytes`` and ``pad_ratio``, so receipts compare across
the two packages.
"""

from __future__ import annotations

import contextvars
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

import torch

from geomesa_tpu_torch.utils import trace
from geomesa_tpu_torch.utils.audit import MetricsRegistry

_DEVSTATS: Optional[MetricsRegistry] = None
_DEVSTATS_LOCK = threading.Lock()


def _cuda_gauge(read) -> float:
    """A ``torch.cuda`` memory reading of the current device, 0 without
    CUDA (the CPU)."""
    if not torch.cuda.is_initialized():
        return 0
    return float(read())


def devstats_metrics() -> MetricsRegistry:
    """The process-wide device telemetry registry (see the module)."""
    global _DEVSTATS
    with _DEVSTATS_LOCK:
        if _DEVSTATS is None:
            reg = MetricsRegistry()
            reg.gauge_fn("device.hbm.bytes_in_use",
                         lambda: _cuda_gauge(torch.cuda.memory_allocated))
            reg.gauge_fn("device.hbm.peak_bytes_in_use",
                         lambda: _cuda_gauge(torch.cuda.max_memory_allocated))
            reg.gauge_fn("device.hbm.free_bytes",
                         lambda: _cuda_gauge(lambda: torch.cuda.mem_get_info()[0]))
            reg.gauge_fn("device.hbm.total_bytes",
                         lambda: _cuda_gauge(lambda: torch.cuda.mem_get_info()[1]))
            _DEVSTATS = reg
        return _DEVSTATS


# the context's receipt collectors: every transfer and build counted in
# this context also folds into each (exact under concurrency, unlike the
# process-wide counters)
_COLLECTORS: contextvars.ContextVar[Tuple[Dict[str, int], ...]] = contextvars.ContextVar(
    "geomesa_tpu_torch_receipt_collectors", default=())
_COLLECT_LOCK = threading.Lock()


@contextmanager
def collecting(out: Optional[Dict[str, int]] = None):
    """Collect this context's device costs into ``out`` (keys
    ``h2d_bytes``, ``d2h_bytes``, ``recompiles``, ``pad_events``) beside the
    process-wide counters. Nests: every active collector sees every cost.
    Yields the dict."""
    out = {} if out is None else out
    token = _COLLECTORS.set(_COLLECTORS.get() + (out,))
    try:
        yield out
    finally:
        _COLLECTORS.reset(token)


def _collect(key: str, n: int) -> None:
    outs = _COLLECTORS.get()
    if not outs:
        return
    with _COLLECT_LOCK:
        for out in outs:
            out[key] = out.get(key, 0) + n


def count_h2d(nbytes: int) -> None:
    """One host -> device transfer (the upload boundary)."""
    if nbytes:
        devstats_metrics().inc("device.h2d.bytes", int(nbytes))
        _collect("h2d_bytes", int(nbytes))


def count_d2h(nbytes: int) -> None:
    """One device -> host transfer (the fetch boundary)."""
    if nbytes:
        devstats_metrics().inc("device.d2h.bytes", int(nbytes))
        _collect("d2h_bytes", int(nbytes))


def count_build(name: str, seconds: float) -> None:
    """One kernel library build (``ops/kernels.py`` ``_compile``)."""
    reg = devstats_metrics()
    reg.inc(f"kernel.build.{name}")
    reg.inc("kernel.build.total")
    reg.update_timer("kernel.build", seconds)
    _collect("recompiles", 1)


def count_launch() -> None:
    """One kernel launch (``ops/kernels.py`` ``_count``)."""
    devstats_metrics().inc("kernel.launch.total")


def record_pad(rows_used: int, rows_capacity: int, kind: str = "") -> None:
    """Padding of one segment upload: its real rows against the rows it
    pads to. The gauges show the latest upload; the totals accumulate."""
    reg = devstats_metrics()
    reg.set_gauge("device.pad.rows_used", rows_used)
    reg.set_gauge("device.pad.rows_capacity", rows_capacity)
    if rows_capacity > 0:
        reg.set_gauge("device.pad.ratio", rows_used / rows_capacity)
    reg.inc("device.pad.events")
    reg.inc("device.pad.rows_used_total", int(rows_used))
    reg.inc("device.pad.rows_padded_total", max(0, int(rows_capacity) - int(rows_used)))
    _collect("pad_events", 1)
    if kind:
        trace.event("device.pad", kind=kind, used=int(rows_used), capacity=int(rows_capacity))


_RECEIPT_COUNTERS = (
    ("recompiles", "kernel.build.total"),
    ("h2d_bytes", "device.h2d.bytes"),
    ("d2h_bytes", "device.d2h.bytes"),
    ("pad_events", "device.pad.events"),
)
RECEIPT_KEYS = ("recompiles", "h2d_bytes", "d2h_bytes")


def receipt_snapshot() -> Dict[str, int]:
    """A point read of the receipt counters."""
    reg = devstats_metrics()
    return {k: reg.counter(c) for k, c in _RECEIPT_COUNTERS}


def receipt_since(before: Dict[str, int]) -> Dict[str, Any]:
    """The counter deltas since ``before`` as a receipt; ``pad_ratio`` is
    the pad gauge when a segment uploaded in the window, else 0.0. The
    counters are process-wide: under concurrent queries a delta holds the
    others' costs too (``collecting`` is exact)."""
    now = receipt_snapshot()
    return receipt_of({k: now[k] - before.get(k, 0) for k, _ in _RECEIPT_COUNTERS})


def receipt_of(costs: Dict[str, int]) -> Dict[str, Any]:
    """A receipt from collected costs (``collecting``)."""
    out: Dict[str, Any] = {k: int(costs.get(k, 0)) for k in RECEIPT_KEYS}
    out["pad_ratio"] = (round(devstats_metrics().gauge("device.pad.ratio"), 4)
                        if costs.get("pad_events", 0) > 0 else 0.0)
    return out


def device_debug() -> Dict[str, Any]:
    """The device telemetry as one structured payload: builds, transfers,
    padding, HBM, the coalescer's reach and the spatial join's block
    (``ops.join.join_debug``: build cache, buckets, probe counters)."""
    counters, gauges, _timers, totals = devstats_metrics().snapshot()
    build_count, build_sum_s = totals.get("kernel.build", (0, 0.0))
    prefix = "batch.coalesce.group.pow2."
    try:
        # lazy: the join subsystem may never have loaded in this process
        from geomesa_tpu_torch.ops.join import join_debug

        join_block = join_debug()
    except Exception:  # noqa: BLE001 - the debug payload renders regardless
        join_block = {}
    return {
        "device": torch.cuda.get_device_name(0) if torch.cuda.is_initialized() else "cpu",
        "kernels": {k[len("kernel.build."):]: v for k, v in sorted(counters.items())
                    if k.startswith("kernel.build.") and k != "kernel.build.total"},
        "build": {"total": counters.get("kernel.build.total", 0), "count": build_count,
                  "wall_s": round(build_sum_s, 4)},
        "launches": counters.get("kernel.launch.total", 0),
        "transfer": {"h2d_bytes": counters.get("device.h2d.bytes", 0),
                     "d2h_bytes": counters.get("device.d2h.bytes", 0)},
        "pad": {
            "rows_used": gauges.get("device.pad.rows_used", 0),
            "rows_capacity": gauges.get("device.pad.rows_capacity", 0),
            "ratio": gauges.get("device.pad.ratio", 0.0),
            "rows_used_total": counters.get("device.pad.rows_used_total", 0),
            "rows_padded_total": counters.get("device.pad.rows_padded_total", 0),
        },
        "hbm": {k[len("device.hbm."):]: v for k, v in gauges.items()
                if k.startswith("device.hbm.")},
        "coalesce": {
            "groups": counters.get("batch.coalesce.groups", 0),
            "members": counters.get("batch.coalesce.members", 0),
            "stacked_plans": counters.get("batch.coalesce.plans.stacked", 0),
            "rest_plans": counters.get("batch.coalesce.plans.rest", 0),
            "group_pow2": {k[len(prefix):]: counters[k]
                           for k in sorted((k for k in counters if k.startswith(prefix)),
                                           key=lambda k: int(k[len(prefix):]))},
        },
        "join": join_block,
    }
