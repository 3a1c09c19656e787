"""The port's flight-recorder timeline and SLO engine against the JAX
package, on the CPU.

* ``TimelineSampler``: the same counter, gauge and timer updates give the
  reference's per-tick counter deltas, gauges, timer count / sum /
  latency-bucket histograms and cache rates; the first tick primes; a
  store's tick carries its admission depth and the per-tick plan and
  tenant deltas of its queries, equal to the reference's; an idle tick
  none. ``merge_worker_ticks`` equals the reference's. ``sampler_for`` /
  ``acquire`` / ``release`` start and stop one sampler thread a store and
  raise and drop the exemplar hook.
* ``SloEngine``: on the same snapshots (no clock involved) every verdict,
  burn rate and per-tenant violation equals the reference's;
  ``default_slos``, ``violation_record``, ``engine_for``.
"""

import time

import numpy as np
import pytest
import torch

from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.utils import audit as ref_audit
from geomesa_tpu.utils import slo as ref_slo
from geomesa_tpu.utils import timeline as ref_timeline

from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.utils import audit, slo, timeline
from geomesa_tpu_torch.utils.audit import MetricsRegistry
from geomesa_tpu_torch.utils.config import properties
from telemetry_pair import REF_ENV, pair

CQL = "bbox(geom, -50, -50, 50, 50)"
SNAP_KEYS = ("counters", "gauges", "timers", "caches")


@pytest.fixture(scope="module", autouse=True)
def _env():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_ENV.items():
            mp.setenv(k, v)
        yield
    torch.set_num_threads(old)


def _updates(seed):
    rng = np.random.default_rng(seed)
    ups = []
    for _ in range(30):
        kind = int(rng.integers(0, 3))
        if kind == 0:
            ups.append(("inc", ("queries", "agg.cache.hits", "agg.cache.misses",
                                "batch.coalesce.groups", "batch.coalesce.members",
                                "queries.timeout")[int(rng.integers(0, 6))],
                        int(rng.integers(1, 4))))
        elif kind == 1:
            ups.append(("timer", ("query.scan", "query.aggregate")[int(rng.integers(0, 2))],
                        float(rng.integers(1, 20000)) / 1e5))
        else:
            ups.append(("gauge", "hbm.bytes", float(rng.integers(0, 1000))))
    return ups


def _apply(reg, ups):
    for op, name, v in ups:
        if op == "inc":
            reg.inc(name, v)
        elif op == "timer":
            reg.update_timer(name, v)
        else:
            reg.set_gauge(name, v)


def test_ticks_equal_the_reference():
    reg, ref_reg = MetricsRegistry(), ref_audit.MetricsRegistry()
    s = timeline.TimelineSampler(registries=[reg], interval_s=1.0, window_s=10.0)
    rs = ref_timeline.TimelineSampler(registries=[ref_reg], interval_s=1.0, window_s=10.0)
    got, want = [], []
    for seed in range(5):
        ups = _updates(seed)
        _apply(reg, ups)
        _apply(ref_reg, ups)
        snap, rsnap = s.tick(), rs.tick()
        got.append({k: snap[k] for k in SNAP_KEYS})
        want.append({k: rsnap[k] for k in SNAP_KEYS})
    assert got == want
    assert got[0]["counters"] == {} and got[0]["timers"] == {}  # the first tick primes
    assert any(g["timers"] for g in got[1:]) and any(g["caches"] for g in got[1:])
    assert s.ticks == 5 and len(s.window()) == 5 and len(s.window(2.0)) == 2
    assert s.payload(3.0)["returned"] == 3
    # an idle tick: no counter moved
    assert s.tick()["counters"] == {}


def test_ring_is_bounded():
    s = timeline.TimelineSampler(registries=[MetricsRegistry()], interval_s=1.0, window_s=3.0)
    for _ in range(7):
        s.tick()
    assert len(s.window()) == 3 and s.ticks == 7


def test_store_tick_carries_plans_tenants_and_admission():
    ref, port = pair(ref_kw={"metrics": ref_audit.MetricsRegistry()},
                     port_kw={"metrics": MetricsRegistry()})
    snaps = []
    for ds, mod, qc in ((ref, ref_timeline, RefQuery), (port, timeline, Query)):
        s = mod.TimelineSampler(store=ds, interval_s=0.05, window_s=10.0)
        s.tick()
        q = qc.cql(CQL)
        q.hints["tenant"] = "acme"
        ds.query("gdelt", q)
        ds.query("gdelt", qc.cql(CQL))
        snap = s.tick()
        idle = s.tick()
        snaps.append((snap, idle))
    (rsnap, ridle), (psnap, pidle) = snaps
    assert psnap["counters"]["queries"] == rsnap["counters"]["queries"] == 2
    assert psnap["timers"]["query.scan"]["count"] == 2
    assert [(r["fingerprint"], r["calls"], r["type"]) for r in psnap["plans"]] == \
        [(r["fingerprint"], r["calls"], r["type"]) for r in rsnap["plans"]]
    assert sorted((r["tenant"], r["calls"], r["bad"], r["classes"]["query"]["calls"])
                  for r in psnap["tenants"]) == \
        sorted((r["tenant"], r["calls"], r["bad"], r["classes"]["query"]["calls"])
               for r in rsnap["tenants"])
    assert psnap["admission"]["inflight"] == 0 and "max_queue" in psnap["admission"]
    assert set(psnap["admission"]) == set(rsnap["admission"])
    assert "plans" not in pidle and "tenants" not in pidle and "brownout" not in pidle
    assert "plans" not in ridle


def test_merge_worker_ticks_equals_the_reference():
    rng = np.random.default_rng(5)
    workers = {}
    for w in range(4):
        tick = {"counters": {"queries": int(rng.integers(0, 9)), "queries.shed": w},
                "timers": {"query.scan": {"count": 3, "sum_ms": float(w),
                                          "hist": {str(b): int(rng.integers(0, 4))
                                                   for b in range(-2, 6)}}},
                "breakers": {"device": "open" if w == 2 else "closed"}}
        workers[str(w)] = {"tick": tick}
    workers["9"] = {"unreachable": True}
    assert timeline.merge_worker_ticks(workers) == ref_timeline.merge_worker_ticks(workers)


def test_sampler_lifecycle_and_the_exemplar_hook():
    _ref, port = pair()
    with properties(geomesa_timeline_interval="20 ms"):
        s = timeline.acquire(port)
        assert s is timeline.sampler_for(port) and s is timeline.acquire(port)
        assert audit.exemplars_enabled()
        deadline_t = time.monotonic() + 10
        while s.ticks < 2 and time.monotonic() < deadline_t:
            time.sleep(0.02)
        assert s.ticks >= 2 and s._thread is not None
        timeline.release(port)
        assert s._thread is not None  # one hold left
        timeline.release(port)
    assert s._thread is None and timeline.sampler_for(port, create=False) is None
    assert not audit.exemplars_enabled()
    with properties(geomesa_timeline_enabled="false"):
        assert timeline.sampler_for(port) is None
    assert timeline.timeline_knobs() == ref_timeline.timeline_knobs()


# -- the SLO engine -------------------------------------------------------------


class _FakeSampler:
    """A sampler of fixed snapshots (the engine reads only these)."""

    def __init__(self, snaps, interval_s=1.0):
        self.snaps = snaps
        self.interval_s = interval_s
        self.registries = []
        self._store = lambda: None

    def window(self, s=None):
        if s is None:
            return list(self.snaps)
        return list(self.snaps[-max(1, int(round(s / self.interval_s))):])


def _snapshots(seed, n=400, bad_rate=0.0, slow_rate=0.0, tenant_bad=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = int(rng.integers(0, 5))
        bad = int(rng.random() < bad_rate) if q else 0
        slow = int(rng.random() < slow_rate) if q else 0
        snap = {"counters": {"queries": q, "queries.timeout": bad,
                             "queries.aggregate": int(rng.integers(0, 2))},
                "timers": {"query.scan": {"count": q, "sum_ms": 1.0,
                                          "hist": {"3": q - slow, "9": slow}}}}
        if tenant_bad is not None:
            snap["tenants"] = [{"tenant": "acme", "calls": q, "bad": 0,
                                "classes": {"query": {"calls": q, "bad": q and tenant_bad}}},
                               {"tenant": "beta", "calls": 1, "bad": 0,
                                "classes": {"query": {"calls": 1, "bad": 0}}}]
        out.append(snap)
    return out


@pytest.mark.parametrize("case", ["healthy", "unavailable", "slow", "tenant"])
def test_slo_verdicts_equal_the_reference(case, monkeypatch):
    kw = {"healthy": {}, "unavailable": {"bad_rate": 0.5}, "slow": {"slow_rate": 0.6},
          "tenant": {"tenant_bad": 1}}[case]
    snaps = _snapshots(3, **kw)
    monkeypatch.setenv("GEOMESA_SLO_WINDOW_FAST", "60 seconds")
    monkeypatch.setenv("GEOMESA_SLO_MIN_EVENTS", "20")
    got = slo.SloEngine(_FakeSampler(snaps)).evaluate()
    want = ref_slo.SloEngine(_FakeSampler(snaps)).evaluate()
    assert got == want
    expect = {"healthy": [], "unavailable": ["query-availability"],
              "slow": ["query-latency"], "tenant": ["query-availability@tenant:acme"]}[case]
    assert got["violating"] == expect
    assert slo.SloEngine(_FakeSampler(snaps)).violating() == expect
    rec = slo.violation_record(slo.SloEngine(_FakeSampler(snaps)))
    assert rec == ref_slo.violation_record(ref_slo.SloEngine(_FakeSampler(snaps)))
    assert (rec is None) == (not expect)


def test_slo_specs_and_engine_for(monkeypatch):
    assert [vars(s) for s in slo.default_slos()] == [vars(s) for s in ref_slo.default_slos()]
    assert slo.slo_knobs() == ref_slo.slo_knobs()
    with pytest.raises(ValueError):
        slo.SloSpec("x", "nope", "latency", 0.9, 5.0)
    with pytest.raises(ValueError):
        slo.SloSpec("x", "query", "latency", 0.9)
    with pytest.raises(ValueError):
        slo.SloSpec("x", "query", "availability", 1.5)
    _ref, port = pair()
    assert slo.engine_for(port, create=False) is None  # no sampler: no engine
    with properties(geomesa_slo_enabled="false"):
        assert slo.engine_for(port) is None
    with properties(geomesa_timeline_interval="1 hour"):
        eng = slo.engine_for(port)
        try:
            assert eng is slo.engine_for(port, create=False)
            assert eng.evaluate()["violating"] == []
        finally:
            timeline.release(port)  # engine_for started it with no hold
    assert timeline.sampler_for(port, create=False) is None


def test_worst_exemplars_link_traces():
    from geomesa_tpu_torch.utils import trace

    audit.set_exemplars(True)
    try:
        reg = MetricsRegistry()
        with trace.span("query", force=True) as root:
            reg.update_timer("query.scan", 0.3)
        reg.update_timer("query.scan", 0.001)
        s = _FakeSampler([])
        s.registries = [reg]
        got = slo.SloEngine(s).worst_exemplars("query")
        assert got[0]["trace_id"] == root.trace_id and got[0]["ms"] == 300.0
    finally:
        audit.set_exemplars(False)
