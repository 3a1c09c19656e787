"""The port's plan telemetry and EXPLAIN ANALYZE against the JAX package,
on the CPU.

* ``filter_shape``, ``fingerprint_key`` and ``fingerprint_id`` equal the
  reference's on the same filters, kinds, hints and routes;
* a ``PlanRegistry`` fed the same observations (fixed durations) gives the
  reference's rows exactly, timer summaries included; the LRU bound, the
  pending scope, ``timeline_deltas`` and ``merge_rows`` too;
* the same queries, ``query_many`` streams and aggregates through the
  reference ``TpuDataStore`` and the port's ``TorchDataStore`` fold into
  equal registry rows (calls, hits, outcomes, rows scanned, blocks,
  estimates, misestimate buckets, decision tallies), timings and receipts
  aside (the two mirrors move different bytes);
* ``explain_analyze`` gives the reference's plan, estimate, actuals,
  decisions and stage names, and its fingerprint is a registry row;
  attribution's arithmetic on spans of set durations (no wall-clock share
  is asserted on the CPU);
* the pyramid's decision points (``sub_cell_region``,
  ``boundary_dominates``, ``build_degraded``, ``hit``) and the coalescer's
  ``coalesce.joined`` tally land on the fingerprint as in the reference.
  Two recorded departures change ``scan_path`` and so the fingerprint: a
  degraded device scan reads ``host-table-degraded`` where the reference's
  count push-down reads ``host-table``, and the breaker's
  ``host-table-breaker``;
* free when off: ``geomesa.plans.enabled=false`` never touches a registry.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.filter.parser import parse_cql as ref_parse_cql
from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.utils import faults as ref_faults
from geomesa_tpu.utils import plans as ref_plans
from geomesa_tpu.utils import trace as ref_trace

from geomesa_tpu_torch.filter.parser import parse_cql
from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.store.datastore import TorchDataStore, attribution
from geomesa_tpu_torch.utils import audit, faults, plans, tenants, trace
from geomesa_tpu_torch.utils.audit import robustness_metrics
from geomesa_tpu_torch.utils.config import properties
from telemetry_pair import REF_ENV, columns, pair, untimed

CQL = "bbox(geom, -50, -50, 50, 50)"
CQLS = [
    CQL,
    "bbox(geom, -10, -10, 10, 10)",
    "bbox(geom, -30, -20, 30, 40) AND dtg DURING 2017-01-03T00:00:00Z/2017-01-19T00:00:00Z",
    "bbox(geom, -30, -20, 30, 40) AND actor = 'USA'",
    "bbox(geom, -60, -60, -20, -20) OR bbox(geom, 20, 20, 60, 60)",
    "actor = 'FRA' AND val > 50",
    "INCLUDE",
    "EXCLUDE",
    "IN ('f1', 'f2', 'f30')",
    "NOT (actor = 'USA') AND bbox(geom, 0, 0, 40, 40)",
    "INTERSECTS(geom, POLYGON((-40 -40, 40 -40, 0 40, -40 -40)))",
    "val BETWEEN 10 AND 20 AND actor LIKE 'U%'",
    "dtg AFTER 2017-01-10T00:00:00Z AND val IS NULL",
]


@pytest.fixture(scope="module", autouse=True)
def _env():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_ENV.items():
            mp.setenv(k, v)
        yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _flags():
    """The cached flags resolve from the knobs around every test."""
    for mod in (plans, ref_plans, tenants):
        mod.set_enabled(None)
    yield
    for mod in (plans, ref_plans, tenants):
        mod.set_enabled(None)


def _counter(name):
    return robustness_metrics().counter(name)


# -- fingerprints -------------------------------------------------------------


@pytest.mark.parametrize("cql", CQLS)
def test_filter_shape_and_fingerprints_equal_the_reference(cql):
    f, rf = parse_cql(cql), ref_parse_cql(cql)
    assert plans.filter_shape(f) == ref_plans.filter_shape(rf)
    for kind, hints, path in (("query", {}, "device-exact/bitmap"),
                              ("aggregate", {"stats": "Count()"}, "agg-pyramid"),
                              ("query", {"tenant": "a", "density": {}}, "host-seek")):
        q, rq = Query(f, hints=dict(hints)), RefQuery(rf, hints=dict(hints))
        key = plans.fingerprint_key(kind, "gdelt", query=q, scan_path=path)
        rkey = ref_plans.fingerprint_key(kind, "gdelt", query=rq, scan_path=path)
        assert key == rkey
        assert plans.fingerprint_id(key) == ref_plans.fingerprint_id(rkey)


def test_literals_fold_into_one_shape():
    a = plans.filter_shape(parse_cql("bbox(geom, 1, 2, 3, 4) AND val > 5"))
    b = plans.filter_shape(parse_cql("val > 99 AND bbox(geom, -9, -8, 7, 6)"))
    assert a == b == "AND(BBOX(geom),val>?)"


def _observations(seed=0, n=60):
    """Seeded observe() calls, the same for both registries."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cql = CQLS[int(rng.integers(0, 6))]
        out.append(dict(
            kind=("query", "aggregate")[int(rng.integers(0, 2))],
            cql=cql,
            scan_path=("device-exact/bitmap", "host-seek", "")[int(rng.integers(0, 3))],
            outcome=("ok", "ok", "ok", "timeout", "shed")[int(rng.integers(0, 5))],
            hits=int(rng.integers(0, 1000)),
            duration_s=float(rng.integers(1, 5000)) / 1e4,
            receipt={"recompiles": int(rng.integers(0, 2)),
                     "h2d_bytes": int(rng.integers(0, 1 << 20)),
                     "d2h_bytes": int(rng.integers(0, 1 << 16)),
                     "pad_ratio": float(rng.integers(0, 4)) / 4},
            est_cost=None if i % 7 == 0 else float(rng.integers(0, 10**6)),
            est_ranges=int(rng.integers(0, 64)),
            blocks=[(int(rng.integers(0, 5000)), int(rng.integers(0, 500)))
                    for _ in range(int(rng.integers(0, 3)))],
            decisions=[("pyramid", ("hit", "sub_cell_region")[int(rng.integers(0, 2))])
                       for _ in range(int(rng.integers(0, 3)))],
            scoped=i % 5 != 0,
        ))
    return out


def _feed(mod, query_cls, parse, reg, obs):
    for o in obs:
        tok = mod.begin() if o["scoped"] else None
        try:
            for rows_in, rows_out in o["blocks"]:
                mod.note_scan(rows_in, rows_out)
            for point, reason in o["decisions"]:
                mod.note(point, reason)
            reg.observe(o["kind"], "gdelt", query=query_cls(parse(o["cql"])),
                        scan_path=o["scan_path"], outcome=o["outcome"], hits=o["hits"],
                        duration_s=o["duration_s"], receipt=o["receipt"],
                        est_cost=o["est_cost"], est_ranges=o["est_ranges"])
        finally:
            mod.end(tok)


@pytest.mark.parametrize("cap", [4, 256])
def test_registry_rows_equal_the_reference(cap):
    """Rows, top, totals, payload and the LRU eviction are the reference's
    exactly, latency summaries included (the durations are fixed)."""
    obs = _observations()
    reg, ref = plans.PlanRegistry(cap=cap), ref_plans.PlanRegistry(cap=cap)
    _feed(plans, Query, parse_cql, reg, obs)
    _feed(ref_plans, RefQuery, ref_parse_cql, ref, obs)
    for sort in plans.SORTS:
        assert reg.rows(sort=sort, n=50) == ref.rows(sort=sort, n=50)
    assert reg.top(5) == ref.top(5)
    assert reg.totals() == ref.totals()
    assert len(reg) == len(ref) <= cap and reg.evicted == ref.evicted
    assert reg.payload(n=3) == ref.payload(n=3)
    assert plans.SORTS == ref_plans.SORTS
    with pytest.raises(ValueError):
        reg.rows(sort="nope")


def test_timeline_deltas_and_merge_rows_equal_the_reference():
    obs = _observations(seed=4)
    regs = [plans.PlanRegistry(cap=64) for _ in range(2)]
    refs = [ref_plans.PlanRegistry(cap=64) for _ in range(2)]
    for i in range(2):
        _feed(plans, Query, parse_cql, regs[i], obs[i::2])
        _feed(ref_plans, RefQuery, ref_parse_cql, refs[i], obs[i::2])
    assert plans.merge_rows([r.rows(n=99) for r in regs]) == \
        ref_plans.merge_rows([r.rows(n=99) for r in refs])
    prev, rows = plans.timeline_deltas(regs[0], {})
    rprev, rrows = ref_plans.timeline_deltas(refs[0], {})
    assert (prev, rows) == (rprev, rrows)
    _feed(plans, Query, parse_cql, regs[0], obs[:5])
    _feed(ref_plans, RefQuery, ref_parse_cql, refs[0], obs[:5])
    assert plans.timeline_deltas(regs[0], prev) == ref_plans.timeline_deltas(refs[0], rprev)
    assert plans.timeline_deltas(None, prev) == (prev, [])


def test_decision_tallies_into_the_pending_scope():
    reg = plans.PlanRegistry()
    tok = plans.begin()
    try:
        audit.decision("pyramid", "sub_cell_region", type="gdelt")
        plans.note_scan(10, 4)
        fid = reg.observe("query", "gdelt", query=Query.cql(CQL), est_cost=9.0, est_ranges=1)
    finally:
        plans.end(tok)
    row = reg.rows()[0]
    assert row["fingerprint"] == fid
    assert row["decisions"] == {"pyramid.sub_cell_region": 1}
    assert (row["rows_scanned"], row["rows_returned"], row["blocks"]) == (10, 4, 1)
    assert row["misestimate"]["hist"] == {"0": 1}


def test_detached_pending_scope_for_generators():
    p = plans.pending()
    with plans.attach(p):
        plans.note_scan(3, 2)
        plans.note("coalesce", "solo")
    plans.note_scan(99, 99)  # outside every scope: inert
    assert (p.rows_in, p.rows_out, p.blocks, p.decisions) == (3, 2, 1, [("coalesce", "solo")])
    with properties(geomesa_plans_enabled="false"):
        plans.set_enabled(None)
        assert plans.pending() is None and plans.begin() is None
        with plans.attach(None) as got:
            assert got is None


# -- the store ------------------------------------------------------------------


def _store_rows(ds):
    return {r["fingerprint"]: r for r in untimed(ds._plans_obj().rows(n=999), drop=("receipt",))}


def test_store_fingerprints_equal_the_reference():
    """Solo queries, a query_many stream and aggregates: the same
    fingerprints, calls, hits, rows, blocks, estimates, misestimates and
    decisions in both registries."""
    ref, port = pair()
    for cql in CQLS:
        for ds, qc in ((ref, RefQuery), (port, Query)):
            ds.query("gdelt", qc.cql(cql))
    stream = [f"bbox(geom, {-40 + i}, -30, {i}, 30)" for i in range(6)]
    got = port.query_many("gdelt", stream)
    want = ref.query_many("gdelt", stream)
    for g, w in zip(got, want):
        assert g.scan_path == w.plan.scan_path
    for ds in (ref, port):
        ds.aggregate("gdelt", CQL, columns=["val"])
        ds.aggregate("gdelt", "bbox(geom, 0.0, 0.0, 0.5, 0.5)")
    rows, ref_rows = _store_rows(port), _store_rows(ref)
    assert rows == ref_rows
    assert len(rows) >= 10
    # two aggregates, and the sub-cell one's exact fallback query
    assert sum(r["calls"] for r in rows.values()) == len(CQLS) + len(stream) + 2 + 1


def test_explain_analyze_equals_the_reference():
    ref, port = pair()
    cql = CQLS[2]
    for ds in (ref, port):
        ds.query("gdelt", cql)  # warm the mirrors
        ds._plan_cache.clear()  # a planned query shows its planner stage
    got = port.explain_analyze("gdelt", cql)
    want = ref.explain_analyze("gdelt", cql)
    for k in ("type", "fingerprint", "plan", "estimate", "decisions", "misestimate_log2"):
        assert got[k] == want[k], k
    for k in ("hits", "rows_scanned", "rows_out", "blocks"):
        assert got["actual"][k] == want["actual"][k], k
    assert got["actual"]["hits"] > 0 and got["actual"]["rows_scanned"] > 0

    def names(st, out):
        out.add(st["stage"])
        for c in st.get("stages", ()):
            names(c, out)
        return out

    stages = names(got["stages"], set())
    assert stages == names(want["stages"], set())
    assert {"query", "query.plan", "plan", "scan", "scan.block", "query.assemble"} <= stages
    assert got["fingerprint"] in {r["fingerprint"] for r in port._plans_obj().rows(n=99)}
    assert got["trace_id"] and got["receipt"] == port.explain_analyze("gdelt", cql)["receipt"]
    assert 0.0 <= got["attribution"]["fraction"] <= 1.0
    assert port.explain("gdelt", cql) == ref.explain("gdelt", cql)


def _span(d):
    return trace.Span.from_dict(d)


def test_attribution_arithmetic_on_set_durations():
    """The share of a root's wall its named stages explain, from spans of
    set durations: self times summed below the root, clamped at 1."""
    root = _span({"name": "query", "duration_ms": 20.0, "children": [
        {"name": "query.plan", "duration_ms": 2.0,
         "children": [{"name": "plan", "duration_ms": 1.5}]},
        {"name": "scan", "duration_ms": 15.0,
         "children": [{"name": "scan.block", "duration_ms": 12.0},
                      {"name": "scan.block", "duration_ms": 1.0}]},
        {"name": "query.assemble", "duration_ms": 1.0}]})
    got = attribution(root)
    assert got == {"attributed_ms": 18.0, "total_ms": 20.0, "fraction": 0.9}
    ref_root = ref_trace.Span.from_dict(root.to_dict())
    assert sum(s.self_time_ms for s in ref_root.walk() if s is not ref_root) == 18.0
    # concurrent stages can sum past the wall: clamped
    wide = _span({"name": "query", "duration_ms": 5.0, "children": [
        {"name": "scan", "duration_ms": 4.0}, {"name": "scan", "duration_ms": 4.0}]})
    assert attribution(wide)["fraction"] == 1.0
    assert attribution(_span({"name": "query", "duration_ms": 0.0}))["fraction"] == 1.0


# -- decision points ------------------------------------------------------------


def _aggs(ds):
    return [r for r in ds._plans_obj().rows(n=99) if r["kind"] == "aggregate"]


def test_pyramid_decisions_on_the_fingerprint():
    cols = columns()
    # 2,000 rows in one boundary cell of the last box, 20 inside it: the
    # ring dominates the interior
    cols["geom__x"][:2000] = np.linspace(0.2, 0.3, 2000)
    cols["geom__y"][:2000] = np.linspace(0.2, 0.3, 2000)
    cols["geom__x"][2000:2020] = 5.0
    cols["geom__y"][2000:2020] = 2.5
    ref, port = pair(cols=cols)
    for ds in (ref, port):
        ds.aggregate("gdelt", "bbox(geom, 0.0, 0.0, 0.5, 0.5)")  # sub-cell
        ds.aggregate("gdelt", CQL)  # the pyramid answers
        ds.aggregate("gdelt", CQL)
        ds.aggregate("gdelt", "bbox(geom, 0.1, 0.1, 10.1, 5.1)")  # boundary dominates
    rows = {r["scan_path"]: r["decisions"] for r in _aggs(port)}
    assert rows == {r["scan_path"]: r["decisions"] for r in _aggs(ref)}
    assert rows["agg-pyramid"] == {"pyramid.hit": 2}
    assert rows["agg-exact-fallback"] == {"pyramid.sub_cell_region": 1,
                                          "pyramid.boundary_dominates": 1}


def test_build_degraded_decision():
    ref, port = pair()
    c0 = _counter("decision.pyramid.build_degraded")
    with faults.inject("agg.build:error@0x1", seed=1):
        assert port.aggregate("gdelt", CQL)["count"] == len(port.query("gdelt", CQL))
    with ref_faults.inject("agg.build:error@0x1", seed=1):
        ref.aggregate("gdelt", CQL)
    assert _counter("decision.pyramid.build_degraded") == c0 + 1
    got = {r["scan_path"]: r["decisions"] for r in _aggs(port)}
    assert got == {r["scan_path"]: r["decisions"] for r in _aggs(ref)}
    assert got["agg-exact-fallback"] == {"pyramid.build_degraded": 1}


def test_pyramid_hit_of_a_cached_push_down():
    ref, port = pair()
    for ds, qc in ((ref, RefQuery), (port, Query)):
        for _ in range(2):
            q = qc.cql(CQL)
            q.hints["stats"] = "Count()"
            ds.query("gdelt", q)
    assert _store_rows(port) == _store_rows(ref)
    (row,) = [r for r in _store_rows(port).values() if r["scan_path"] == "agg-pyramid-stats"]
    assert row["decisions"] == {"pyramid.hit": 2} and row["hints"] == "stats"


def test_device_degrade_reaches_the_fingerprint():
    """``executor.degrade``'s ``degrade.device_to_host`` decision lands on
    the degraded query's fingerprint, whose route is the port's
    ``host-table-degraded`` (a recorded departure: the reference's route
    reads the same here, its count push-down ``host-table``)."""
    _ref, port = pair()
    port.query("gdelt", CQL)
    c0 = _counter("decision.degrade.device_to_host")
    with faults.inject("device.fetch:error@0x1", seed=1):
        res = port.query("gdelt", CQL)
    assert res.scan_path == "host-table-degraded"
    assert _counter("decision.degrade.device_to_host") == c0 + 1
    deg = [r for r in port._plans_obj().rows(n=99) if r["decisions"].get("degrade.device_to_host")]
    assert len(deg) == 1 and deg[0]["scan_path"] == "host-table-degraded"
    assert deg[0]["calls"] == 1
    assert len(port.query("gdelt", CQL)) == len(res)


def test_count_push_down_degrade_decision():
    """A failed device count records ``decision.degrade.count_to_host``
    (the reference's reason) and the count is the host's, exact."""
    _ref, port = pair()
    want = port.count("gdelt", CQLS[2])
    c0 = _counter("decision.degrade.count_to_host")
    with properties(geomesa_agg_enabled="false"), \
            faults.inject("device.fetch:error@0x1", seed=1):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GEOMESA_COUNT_DEVICE", "1")
            assert port.count("gdelt", CQLS[2]) == want
    assert _counter("decision.degrade.count_to_host") == c0 + 1


# -- free when off ----------------------------------------------------------------


def test_poisoned_registry_with_plans_off(monkeypatch):
    _ref, port = pair()

    def boom(*a, **k):
        raise AssertionError("the query path touched the plan registry with plans off")

    plans.set_enabled(False)
    monkeypatch.setattr(TorchDataStore, "_plans_obj", boom)
    monkeypatch.setattr(plans.PlanRegistry, "observe", boom)
    monkeypatch.setattr(plans.PlanRegistry, "__init__", boom)
    assert len(port.query("gdelt", CQL)) > 0
    port.query_many("gdelt", [CQL, CQLS[1]])
    port.aggregate("gdelt", CQL)
    plans.note("pyramid", "hit")
    plans.note_scan(10, 5)


def test_answers_equal_with_telemetry_on_and_off():
    """No answer depends on the sinks: every query, count and aggregate is
    the same with plans and tenants on (the defaults) and off."""
    _ref, port = pair()

    def answers():
        out = [sorted(port.query("gdelt", c).fids.astype(str)) for c in CQLS]
        out += [sorted(r.fids.astype(str)) for r in port.query_many("gdelt", CQLS[:5])]
        out += [port.count("gdelt", c) for c in CQLS[:4]]
        out.append(port.aggregate("gdelt", CQL, columns=["val"]))
        return out

    on = answers()
    with properties(geomesa_plans_enabled="false", geomesa_tenants_enabled="false"):
        plans.set_enabled(None)
        tenants.set_enabled(None)
        assert not plans.enabled() and not tenants.enabled()
        off = answers()
    assert on == off


def test_flag_resolves_from_the_knob():
    with properties(geomesa_plans_enabled="false"):
        plans.set_enabled(None)
        assert not plans.enabled()
    plans.set_enabled(None)
    assert plans.enabled()
    assert plans.plans_knobs() == (True, 256)


def test_registries_under_many_threads():
    """Sixteen threads fold observations into one plan and one tenant
    registry with a short switch interval: no update is lost."""
    import sys
    import threading

    reg, treg = plans.PlanRegistry(cap=8), tenants.TenantRegistry(cap=8)
    q = [Query.cql(c) for c in CQLS[:4]]
    n, threads = 200, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n):
                reg.observe("query", "gdelt", query=q[(k + i) % 4], hits=1, duration_s=1e-4)
                treg.observe(f"t{k % 3}", "query", rows=1, duration_s=1e-4)

        ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    rows = reg.rows(n=99)
    assert sum(r["calls"] for r in rows) == sum(r["hits"] for r in rows) == n * threads
    assert sum(r["calls"] for r in treg.rows(n=99)) == n * threads
    assert sum(c for c, _s, _t in reg.totals().values()) == n * threads
