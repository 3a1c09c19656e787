"""Parity under faults: the port's host degrade and its device circuit
breaker against the JAX package, on the CPU.

* ``utils/breaker.py`` (a whole copy) against the reference's, step for
  step on an injected clock: closed -> open after ``failures`` strikes in
  the window, short circuits while open, one half-open probe after the
  cooldown, closed on its success and re-opened on its failure, a
  released probe slot, ``reset``, ``peek_state`` and the registries.
* The seeded ``device.dispatch`` / ``device.fetch`` schedules of the
  reference's ``test_robustness.py`` / ``test_chaos.py`` on a point type
  and config #3's extent type: every answer (``query``, ``query_many``,
  ``count``, the stats query, density, ``aggregate()``, kNN) equals the
  fault-free answer and the reference's under the same schedule, and
  each fault fired at a device boundary gives exactly one
  ``degrade.device_to_host``, on a route labelled ``host-table-degraded``.
* The store's breaker cycle: strikes open it, an open circuit sends every
  query to the host (``host-table-breaker``) with no byte over the link,
  and after the cooldown the probe query closes it and rebuilds the
  mirror (its receipt shows the mirror's host -> device bytes), as the
  reference's breaker does on the same schedule.
* What degrades nothing: a ``QueryTimeout`` strikes no breaker and
  releases the probe slot; a kernel that fails to build, fails its
  launch or is given tensors it does not take raises
  (``kernels.KernelError``). A failed device kNN trips the session's
  device-kNN flag and answers the identical list from the host.
"""

import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import chip_smoke as cs
from geomesa_tpu.geom import base as ref_geom
from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.process import knn as ref_knn
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore
from geomesa_tpu.utils import breaker as ref_breaker
from geomesa_tpu.utils import faults as ref_faults

from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.parallel import executor as port_ex
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.process import knn as port_knn
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.utils import breaker, deadline, faults
from geomesa_tpu_torch.utils.audit import QueryTimeout, robustness_metrics
from geomesa_tpu_torch.utils.config import properties

SPEC = "dtg:Date,kind:String,cnt:Int,*geom:Point:srid=4326"
BASE = int(np.datetime64("2026-01-01T00:00:00", "ms").astype("int64"))
DAY = 86_400_000
DURING = "dtg DURING 2026-01-03T00:00:00Z/2026-01-15T00:00:00Z"
POLY = "POLYGON((-60 -30, 60 -30, 80 20, 0 45, -80 20, -60 -30))"
N = 4000
ENV = {
    "GEOMESA_EXACT_DEVICE": "1",
    "GEOMESA_DEVBATCH": "1",
    "GEOMESA_BATCH_PROTO": "bitmap",
    "GEOMESA_SEEK": "0",
    "GEOMESA_COUNT_DEVICE": "1",
    "GEOMESA_STATS_DEVICE": "1",
    "GEOMESA_DENSITY_DEVICE": "1",
    "GEOMESA_KNN_DEVICE": "1",
}


@pytest.fixture(scope="module", autouse=True)
def _env():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.delenv("GEOMESA_FAULTS", raising=False)
        yield
    torch.set_num_threads(old)


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


# -- the breaker ------------------------------------------------------------------

# (op, arg): "fail", "ok", "allow", "cancel", "reset", "tick" (seconds)
SCENARIOS = {
    "opens_and_closes": [("fail", 0), ("fail", 0), ("allow", 0), ("fail", 0), ("allow", 0),
                         ("tick", 4.0), ("allow", 0), ("tick", 1.5), ("allow", 0), ("allow", 0),
                         ("ok", 0), ("allow", 0)],
    "probe_fails_reopens": [("fail", 0)] * 3 + [("tick", 6.0), ("allow", 0), ("fail", 0),
                                                 ("allow", 0), ("tick", 5.0), ("allow", 0),
                                                 ("ok", 0), ("allow", 0)],
    "window_rolls": [("fail", 0), ("tick", 20.0), ("fail", 0), ("tick", 20.0), ("fail", 0),
                     ("allow", 0), ("fail", 0), ("allow", 0)],
    "released_probe": [("fail", 0)] * 3 + [("tick", 5.0), ("allow", 0), ("allow", 0),
                                            ("cancel", 0), ("allow", 0), ("ok", 0)],
    "straggler_success_ignored": [("fail", 0)] * 3 + [("ok", 0), ("allow", 0), ("tick", 5.0),
                                                       ("allow", 0), ("ok", 0)],
    "reset": [("fail", 0)] * 3 + [("reset", 0), ("allow", 0), ("fail", 0), ("allow", 0)],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_breaker_follows_the_reference(scenario):
    """The same operations on the port's and the reference's breaker (3
    failures in 30 s, 5 s cooldown, one injected clock each) give the same
    state, ``peek_state`` and verdict after every step, and the same
    counters."""
    clocks = Clock(), Clock()
    port = breaker.CircuitBreaker("t_" + scenario, failures=3, window_s=30.0, cooldown_s=5.0,
                                  clock=clocks[0])
    ref = ref_breaker.CircuitBreaker("t_" + scenario, failures=3, window_s=30.0,
                                     cooldown_s=5.0, clock=clocks[1])
    for op, arg in SCENARIOS[scenario]:
        got = []
        for b, clock in ((port, clocks[0]), (ref, clocks[1])):
            verdict = None
            if op == "fail":
                b.record_failure()
            elif op == "ok":
                b.record_success()
            elif op == "allow":
                verdict = b.allow()
            elif op == "cancel":
                b.cancel_probe()
            elif op == "reset":
                b.reset()
            else:
                clock.t += arg
            got.append((verdict, b.peek_state, b.state))
        assert got[0] == got[1], (op, got)
    counters = robustness_metrics().report()
    ref_counters = ref_breaker.robustness_metrics().report()
    for k in ("opens", "closes", "reopens", "probes", "short_circuit", "resets"):
        key = f"breaker.t_{scenario}.{k}"
        assert counters.get(key, 0) == ref_counters.get(key, 0), key


def test_breaker_snapshots_and_check():
    clock = Clock()
    b = breaker.CircuitBreaker("snap", failures=1, window_s=10.0, cooldown_s=2.0, clock=clock)
    assert breaker.breaker_states()["snap"] == breaker.CLOSED
    b.record_failure()
    assert breaker.open_breakers()["snap"] == breaker.OPEN
    with pytest.raises(breaker.CircuitOpen):
        b.check()
    clock.t += 2.0
    assert breaker.peek_states()["snap"] == breaker.HALF_OPEN
    assert b._state == breaker.OPEN  # peeking ran no transition
    assert "snap" not in breaker.open_breakers()
    assert robustness_metrics().report()["breaker.snap.state"] == 0.5
    with pytest.raises(ValueError):
        breaker.CircuitBreaker("bad", failures=0)


def test_breaker_knobs():
    with properties(geomesa_breaker_failures="7", geomesa_breaker_cooldown="250 ms",
                    geomesa_breaker_window="2 minutes"):
        b = breaker.CircuitBreaker("knobs")
    assert (b.failures, b.cooldown_s, b.window_s) == (7, 0.25, 120.0)
    b = breaker.CircuitBreaker("defaults")
    assert (b.failures, b.cooldown_s, b.window_s) == (5, 5.0, 30.0)


# -- the stores -------------------------------------------------------------------


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("shards",))


def _columns(seed=3):
    rng = np.random.default_rng(seed)
    return {
        "__fid__": np.array([f"f{i}" for i in range(N)], dtype=object),
        "dtg": (BASE + rng.integers(0, 20 * DAY, N)).astype(np.int64),
        "kind": np.array([f"k{v}" for v in rng.integers(0, 5, N)], dtype=object),
        "cnt": rng.integers(0, 50, N).astype(np.int32),
        "geom__x": rng.uniform(-100, 80, N),
        "geom__y": rng.uniform(-60, 60, N),
    }


WAYS = cs.synthesize_ways(2000, seed=12, bounds=(-15.0, -15.0, 45.0, 35.0), clusters=4)


def _pair(failures=10_000, cooldown=5.0, clock=None):
    """The reference's and the port's store of the same rows (two batches
    of points, the ways); the breakers never open unless asked."""
    kw = {"failures": failures, "window_s": 60.0, "cooldown_s": cooldown}
    if clock is not None:
        kw["clock"] = clock
    ref = TpuDataStore(executor=TpuScanExecutor(
        _mesh(), breaker=ref_breaker.CircuitBreaker("device", **kw)))
    port = TorchDataStore(executor=TorchScanExecutor(
        device="cpu", breaker=breaker.CircuitBreaker("device", **kw)))
    cols = _columns()
    for ds, parse, classes in ((ref, ref_parse_spec, (ref_geom.LineString, ref_geom.Polygon)),
                               (port, parse_spec, None)):
        ds.create_schema(parse("t", SPEC))
        for half in (slice(0, N // 2), slice(N // 2, N)):
            ds._insert_columns(ds.get_schema("t"), {k: v[half].copy() for k, v in cols.items()})
        ds.create_schema(parse("ways", cs.WAYS_SPEC))
        ds._insert_columns(ds.get_schema("ways"), cs.ways_columns(WAYS, classes=classes))
    return ref, port


def _boxes(seed=5, k=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        x0, y0 = rng.uniform(-90, 20), rng.uniform(-50, 20)
        out.append(f"bbox(geom, {x0}, {y0}, {x0 + rng.uniform(20, 60)}, "
                   f"{y0 + rng.uniform(10, 35)})")
    return out


BOXES = _boxes()
STREAM = [f"{b} AND {DURING}" for b in BOXES[:4]] + BOXES[4:] + [
    f"({BOXES[0]} OR {BOXES[1]}) AND {DURING}", f"kind = 'k1' AND {BOXES[2]}",
    f"INTERSECTS(geom, {POLY})"]
XZ = cs.xz_streams(reps=3, tris=1, resid=1)
DENSITY = {"density": {"envelope": (-100.0, -60.0, 80.0, 60.0), "width": 32, "height": 24}}
STATS = "Count();MinMax(cnt);TopK(kind)"


def _fids(res):
    return frozenset(map(str, res.fids.tolist()))


def _workload(ds, query, knn):
    """Every answer of the workload, in order: lone queries, a query_many
    stream of points and one of extents, counts, the stats query, density,
    the pyramid's aggregate, kNN."""
    out = []
    for cql in STREAM:
        out.append(_fids(ds.query("t", query.cql(cql))))
    out += [_fids(r) for r in ds.query_many("t", [query.cql(c) for c in STREAM])]
    out += [_fids(r) for r in ds.query_many("ways", [query.cql(c) for c, _ in XZ["xz2_bbox"]])]
    out += [_fids(r) for r in ds.query_many("ways", [query.cql(c) for c, _
                                                     in XZ["xz3_bbox_during"]])]
    for cql in (STREAM[0], STREAM[4], f"INTERSECTS(geom, {POLY})"):
        out.append(ds.count("t", cql))
    out.append(ds.count("ways", XZ["xz2_bbox"][0][0]))
    out.append(ds.query("t", query.cql(STREAM[1], hints={"stats": STATS}))
               .aggregate["stats"].to_json())
    out.append(np.asarray(ds.query("t", query.cql(STREAM[0], hints=dict(DENSITY)))
                          .aggregate["density"]).tolist())
    out.append(ds.aggregate("t", f"INTERSECTS(geom, {POLY})", columns=["cnt"]))
    out.append(knn.knn_search(ds, "t", -10.0, 0.0, k=15))
    return out


def _fired(reg):
    report = reg.report()
    return sum(v for k, v in report.items()
               if k.startswith(("fault.device.dispatch.", "fault.device.fetch."))
               and not k.endswith(".latency"))


_BASELINE = {}


def _baseline():
    if not _BASELINE:
        ref, port = _pair()
        with properties(geomesa_agg_enabled="false"):
            _BASELINE["off"] = _workload(port, Query, port_knn)
        _BASELINE["on"] = _workload(port, Query, port_knn)
        assert _BASELINE["on"] == _workload(ref, RefQuery, ref_knn)
    return _BASELINE


SCHEDULES = [
    "device.dispatch:error=0.3",
    "device.fetch:error=0.3",
    "device.dispatch:drop=0.15,device.fetch:error=0.15",
    "device.fetch:error@3x2",
]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_answers_equal_the_fault_free_ones(schedule, seed):
    """Under a seeded device schedule every answer equals the fault-free
    one (and the reference's under the same schedule), and each fired
    device fault gives exactly one ``degrade.device_to_host``."""
    want = _baseline()["on"]
    ref, port = _pair()
    reg = robustness_metrics()
    f0, d0 = _fired(reg), reg.counter("degrade.device_to_host")
    with faults.inject(schedule, seed=seed):
        got = _workload(port, Query, port_knn)
    fired = _fired(reg) - f0
    assert got == want
    assert reg.counter("degrade.device_to_host") - d0 == fired
    if "@" not in schedule:
        assert fired > 0
    with ref_faults.inject(schedule, seed=seed):
        assert _workload(ref, RefQuery, ref_knn) == want
    # the store recovers: fault-free, the device routes answer again
    assert _workload(port, Query, port_knn) == want


def test_degraded_routes_are_labelled():
    """A fetch fault on a lone query, a dispatch fault on a query_many
    batch, a density and a stats push-down: each answers from the host
    table scan, labelled ``host-table-degraded``, with the mirror evicted
    and rebuilt by the next device query."""
    _ref, port = _pair()
    reg = robustness_metrics()
    port.query("t", STREAM[0])  # the mirror
    r0 = reg.counter("degrade.mirror_rebuilds")
    with faults.inject("device.fetch:error@0x1", seed=1):
        res = port.query("t", STREAM[0])
    assert res.scan_path == "host-table-degraded" and _fids(res) == _baseline()["on"][0]
    assert reg.counter("degrade.mirror_rebuilds") == r0 + 1
    assert not port.executor._cache
    with faults.inject("device.dispatch:error@0x1", seed=1):
        got = port.query_many("t", STREAM[:4])
    assert [r.scan_path for r in got] == ["host-table-degraded"] * 4
    assert [_fids(r) for r in got] == _baseline()["on"][:4]
    with properties(geomesa_agg_enabled="false"):
        for hints in (dict(DENSITY), {"stats": STATS}):
            port.query("t", Query.cql(STREAM[0], hints=hints))  # the mirror
            with faults.inject("device.dispatch:error@0x1", seed=2):
                res = port.query("t", Query.cql(STREAM[0], hints=hints))
            assert res.scan_path == "host-table-degraded", res.scan_path
    res = port.query("t", STREAM[0])
    assert res.scan_path.startswith("device") and res.receipt["h2d_bytes"] > 0


def test_breaker_cycle_on_the_store():
    """Strikes open the port's breaker as they open the reference's; while
    open no byte crosses the link and the routes read
    ``host-table-breaker``; after the cooldown the probe query closes it
    and rebuilds the mirror; a failing probe re-opens it."""
    clocks = Clock(), Clock()
    ref, port = _pair(failures=3, cooldown=5.0, clock=clocks[0])
    ref.executor.breaker = ref_breaker.CircuitBreaker("device", failures=3, window_s=60.0,
                                                      cooldown_s=5.0, clock=clocks[1])
    want = _baseline()["on"]
    reg = robustness_metrics()
    states = []
    for ds, fl, q, clock in ((port, faults, Query, clocks[0]), (ref, ref_faults, RefQuery,
                                                                 clocks[1])):
        seq = []
        with fl.inject("device.fetch:error", seed=0):
            for i in range(5):
                res = ds.query("t", q.cql(STREAM[i]))
                assert _fids(res) == want[i]
                seq.append(ds.executor.breaker.state)
        if ds is port:
            assert [r.scan_path for r in [res]] == ["host-table-breaker"]
            s0 = reg.counter("fault.device.fetch.error")
            res = port.query("t", STREAM[5])
            assert res.scan_path == "host-table-breaker" and _fids(res) == want[5]
            assert res.receipt["h2d_bytes"] == res.receipt["d2h_bytes"] == 0
            at = 2 * len(STREAM) + len(XZ["xz2_bbox"]) + len(XZ["xz3_bbox_during"])
            assert port.count("t", STREAM[0]) == want[at]
            got = port.query_many("t", STREAM[:3])
            assert [r.scan_path for r in got] == ["host-table-breaker"] * 3
            assert reg.counter("fault.device.fetch.error") == s0
        clock.t += 5.0
        seq.append(ds.executor.breaker.state)
        with fl.inject("device.fetch:error", seed=0):
            ds.query("t", q.cql(STREAM[0]))  # the probe fails: re-opens
        seq.append(ds.executor.breaker.state)
        clock.t += 5.0
        res = ds.query("t", q.cql(STREAM[1]))  # the probe succeeds: closes
        seq.append(ds.executor.breaker.state)
        assert _fids(res) == want[1]
        if ds is port:
            assert res.scan_path.startswith("device") and res.receipt["h2d_bytes"] > 0
        states.append(seq)
    assert states[0] == states[1] == [
        "closed", "closed", "open", "open", "open", "half-open", "open", "closed"]


def test_query_timeout_strikes_nothing_and_releases_the_probe():
    clock = Clock()
    _ref, port = _pair(failures=1, cooldown=1.0, clock=clock)
    port.query("t", STREAM[0])
    ex = port.executor
    ex.breaker.record_failure()
    clock.t += 1.0
    plan = port._plan_cached("t", Query.cql(STREAM[0]))
    table = port._tables["t"][plan.index.name]
    reg = robustness_metrics()
    d0 = reg.counter("degrade.device_to_host")
    for call in (lambda: ex.scan_candidates(table, plan),
                 lambda: ex.push_down(table, ex.count_scan, table, plan),
                 lambda: ex.dispatch_many([(table, plan)])):
        with deadline.budget(0.001):
            time.sleep(0.01)
            with pytest.raises(QueryTimeout):
                call()
        assert ex.breaker.state == "half-open" and not ex.breaker._probing
    assert reg.counter("degrade.device_to_host") == d0
    assert ex._cache  # no mirror evicted
    res = port.query("t", STREAM[0])  # the probe, no timeout: closes
    assert ex.breaker.state == "closed" and res.scan_path.startswith("device")


def test_a_kernel_build_failure_raises_and_degrades_nothing(monkeypatch):
    """A kernel that fails to build is a fault of the program: the query
    raises ``KernelBuildError`` on every entry point, no breaker strike, no
    degrade."""
    _ref, port = _pair()

    def no_nvcc(name, src=None):
        raise FileNotFoundError("nvcc")

    def building(*args, **kw):
        return kernels._lib("exact_bitmap")

    monkeypatch.setattr(kernels, "_compile", no_nvcc)
    monkeypatch.setattr(kernels, "exact_bitmap", building)
    monkeypatch.setattr(kernels, "exact_count", building)
    monkeypatch.delitem(kernels._LIBS, "exact_bitmap", raising=False)
    reg = robustness_metrics()
    d0 = reg.counter("degrade.device_to_host")
    with properties(geomesa_agg_enabled="false"):
        for call in (lambda: port.query("t", STREAM[0]),
                     lambda: port.query_many("t", STREAM[:2]),
                     lambda: port.count("t", STREAM[0])):
            with pytest.raises(kernels.KernelBuildError, match="nvcc"):
                call()
    assert reg.counter("degrade.device_to_host") == d0
    assert port.executor.breaker.state == "closed" and not port.executor.breaker._window


# every wrapper that launches a hand kernel
LAUNCHING = ("candidate_mask", "exact_bitmap", "exact_mask_batch", "exact_count",
             "exact_stat_hist", "xz_mask", "xz_dual_bitmap", "density_grid", "knn_topk",
             "poly_dual_bitmap", "dual_mask_batch", "pyramid_counts")


@pytest.mark.parametrize("fault", ["launch", "argument"])
def test_a_failed_kernel_launch_raises_and_degrades_nothing(monkeypatch, fault):
    """A wrapper whose launch fails (its entry point returns a CUDA error)
    or that is given tensors its kernel does not take is a fault of the
    program, as a build failure is: every entry point raises it (solo,
    ``query_many``, the coalescer's group, count, stats, density, kNN, the
    pyramid build), with no degrade, no breaker strike and no evicted
    mirror."""
    _ref, port = _pair()
    port.query_many("t", STREAM[:4])  # the mirrors
    port.query_many("ways", [c for c, _ in XZ["xz2_bbox"]])
    mirrors = set(port.executor._cache)

    def failing(*args, **kw):
        if fault == "launch":
            kernels._raise_on(700, "exact_bitmap")
        kernels._check(torch.zeros(4, dtype=torch.int64), "xk", torch.int32, torch.device("cpu"))

    for name in LAUNCHING:
        monkeypatch.setattr(kernels, name, failing)
    want = kernels.KernelLaunchError if fault == "launch" else kernels.KernelArgumentError
    reg = robustness_metrics()
    d0 = reg.counter("degrade.device_to_host")
    with properties(geomesa_agg_enabled="false"):
        calls = [lambda: port.query("t", STREAM[0]),
                 lambda: port.query("t", STREAM[-1]),
                 lambda: port.query_many("t", STREAM[:3]),
                 lambda: port.query_many("ways", [c for c, _ in XZ["xz3_bbox_during"]]),
                 lambda: port.count("t", STREAM[0]),
                 lambda: port.query("t", Query.cql(STREAM[1], hints={"stats": STATS})),
                 lambda: port.query("t", Query.cql(STREAM[0], hints=dict(DENSITY))),
                 lambda: port_knn.knn_search(port, "t", -10.0, 0.0, k=15)]
        for call in calls:
            with pytest.raises(want):
                call()
        from geomesa_tpu_torch.parallel import batch

        members = [batch._Member(Query.cql(c), None) for c in STREAM[:4]]
        port._coalescer_obj()._execute_group("t", port.get_schema("t"), members)
        assert all(isinstance(m.outcome, want) for m in members)
    with pytest.raises(want):
        port.aggregate("t", f"INTERSECTS(geom, {POLY})", columns=["cnt"])
    assert reg.counter("degrade.device_to_host") == d0
    assert port.executor.breaker.state == "closed" and not port.executor.breaker._window
    assert mirrors <= set(port.executor._cache)  # no mirror evicted
    assert not getattr(port.executor, "_device_tripped", False)


def test_device_knn_failure_trips_to_the_host(monkeypatch):
    """One failed device kNN answers the identical list on ``host-bbox``,
    degrades once and trips the session flag (auto mode: later calls stay
    on the host); under GEOMESA_KNN_DEVICE=1 the flag stays down."""
    ref, port = _pair()
    want = ref_knn.knn_search(ref, "t", 30.0, 20.0, k=12)
    reg = robustness_metrics()
    d0 = reg.counter("degrade.device_to_host")
    calls = {"n": 0}
    real = port.executor.knn_candidates

    def boom(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("device lost")

    monkeypatch.setattr(port.executor, "knn_candidates", boom)
    got = port_knn.knn_search(port, "t", 30.0, 20.0, k=12)
    assert got == want and port_knn.last_knn_path() == "host-bbox"
    assert reg.counter("degrade.device_to_host") == d0 + 1
    assert not getattr(port.executor, "_device_tripped", False)  # forced: no trip
    monkeypatch.setenv("GEOMESA_KNN_DEVICE", "auto")
    monkeypatch.setattr(port_knn, "_device_knn_wanted", lambda store: True)
    assert port_knn.knn_search(port, "t", 30.0, 20.0, k=12) == want
    assert port.executor._device_tripped and calls["n"] == 2
    monkeypatch.setattr(port.executor, "knn_candidates", real)
    assert port_knn.knn_search(port, "t", 30.0, 20.0, k=12) == want
    assert port_knn.last_knn_path() == "host-bbox" and calls["n"] == 2


def test_open_circuit_answers_the_coalescer_and_query_many_from_the_host():
    clock = Clock()
    _ref, port = _pair(failures=1, cooldown=60.0, clock=clock)
    plans = [port._plan_cached("t", Query.cql(c)) for c in STREAM[:3]]
    items = [(port._tables["t"][p.index.name], p) for p in plans]
    port.executor.breaker.record_failure()
    for fn in (port.executor.dispatch_many, port.executor.dispatch_coalesced):
        out = fn(items)
        assert set(out.values()) == {port_ex.HOST_BREAKER}
    res = port.query_many("t", STREAM[:3])
    assert [_fids(r) for r in res] == _baseline()["on"][:3]


def test_stacked_sweep_failure_degrades_the_group_to_solo():
    """A device failure of the coalescer's stacked sweep degrades the
    executor once (the mirrors go) and the members run solo with the
    fault-free answers."""
    _ref, port = _pair()
    co = port._coalescer_obj()
    reg = robustness_metrics()
    port.query_many("t", STREAM[:4])  # the mirrors
    from geomesa_tpu_torch.parallel import batch

    members = [batch._Member(Query.cql(c), None) for c in STREAM[:4]]
    d0, s0 = reg.counter("degrade.device_to_host"), reg.counter("degrade.coalesce_to_solo")
    with faults.inject("device.fetch:error@0x1", seed=3):
        co._execute_group("t", port.get_schema("t"), members)
    assert reg.counter("degrade.device_to_host") == d0 + 1
    assert reg.counter("degrade.coalesce_to_solo") == s0 + 1
    assert not port.executor._cache
    got = [port.query("t", c) for c in STREAM[:4]]
    assert [_fids(r) for r in got] == _baseline()["on"][:4]
