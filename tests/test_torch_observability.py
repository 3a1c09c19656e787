"""The port's span trees, audit trail, metrics and slow-query log against
the JAX package, on the CPU.

* ``utils/trace.py``: the tree a query records (stage names and their
  nesting equal the reference's), ``scan.block`` rows in and out, the
  exporters (in-memory ring, JSON lines, logging), the debug ring's
  refcount, ``find_trace``, ``wrap`` across threads, ``to_dict`` /
  ``from_dict`` and ``render`` byte for byte with the reference's on a tree
  of set durations; free when off (``NOOP``);
* ``utils/audit.py``: the same queries give ``QueryEvent``s equal to the
  reference's bar their times and bytes; each event's bytes equal the
  port's own receipt (exact per query, a recorded departure); one event a
  ``query_many`` member and a timed-out query's ``timeout`` event;
  ``prometheus_text`` of equal registries byte for byte; exemplars; the
  reporters; the slow-query log, its tail and storm guard; kNN's own
  audit when the device path skips ``store.query``;
* a coalesced wave tallies ``coalesce.joined`` on its fingerprints.
"""

import io
import json
import logging
import threading

import numpy as np
import pytest
import torch

from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.utils import audit as ref_audit
from geomesa_tpu.utils import trace as ref_trace

from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.process.knn import knn_search
from geomesa_tpu_torch.utils import audit, deadline, devstats, plans, trace
from geomesa_tpu_torch.utils.audit import (
    InMemoryAuditWriter,
    MetricsRegistry,
    QueryEvent,
    QueryTimeout,
)
from geomesa_tpu_torch.utils.config import properties
from telemetry_pair import REF_ENV, pair

CQL = "bbox(geom, -50, -50, 50, 50)"
CQLS = [
    CQL,
    "bbox(geom, -30, -20, 30, 40) AND dtg DURING 2017-01-03T00:00:00Z/2017-01-19T00:00:00Z",
    "bbox(geom, -60, -60, -20, -20) OR bbox(geom, 20, 20, 60, 60)",
    "actor = 'FRA' AND val > 50",
    "EXCLUDE",
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


def _audited_pair():
    return pair(ref_kw={"audit_writer": ref_audit.InMemoryAuditWriter(),
                        "metrics": ref_audit.MetricsRegistry(), "user": "ana"},
                port_kw={"audit_writer": InMemoryAuditWriter(),
                         "metrics": MetricsRegistry(), "user": "ana"})


def _names(sp):
    return (sp.name, tuple(_names(c) for c in sp.children))


# -- span trees -----------------------------------------------------------------


@pytest.mark.parametrize("cql", CQLS[:4])
def test_query_tree_stages_equal_the_reference(cql):
    """The tree of one query (planned, so the planner's spans show): the
    same stage names in the same nesting as the reference's, and the
    blocks' rows in and out."""
    ref, port = pair()
    trees = []
    for ds, mod, qc in ((ref, ref_trace, RefQuery), (port, trace, Query)):
        ds.query("gdelt", qc.cql(cql))  # warm
        ds._plan_cache.clear()
        ring = mod.InMemoryTraceExporter()
        with mod.exporting(ring):
            res = ds.query("gdelt", qc.cql(cql))
        (root,) = ring.traces
        trees.append((root, len(res)))
    (rroot, rn), (proot, pn) = trees
    assert _names(proot) == _names(rroot)
    assert proot.name == "query" and pn == rn
    assert proot.attributes["hits"] == pn
    assert proot.attributes["scan_path"] == rroot.attributes["scan_path"]
    blocks = proot.find("scan.block")
    assert [(b.attributes["rows_in"], b.attributes["rows_out"]) for b in blocks] == \
        [(b.attributes["rows_in"], b.attributes["rows_out"]) for b in rroot.find("scan.block")]
    assert sum(b.attributes["rows_out"] for b in blocks) == pn
    assert proot.find("query.plan")[0].attributes["cache"] == "miss"
    assert proot.find("plan")[0].attributes["index"] == rroot.find("plan")[0].attributes["index"]


def test_query_many_members_and_shared_fetch_spans():
    ref, port = pair()
    stream = [f"bbox(geom, {-40 + 3 * i}, -30, {3 * i}, 30)" for i in range(5)]
    trees = []
    for ds, mod in ((ref, ref_trace), (port, trace)):
        ring = mod.InMemoryTraceExporter()
        with mod.exporting(ring):
            ds.query_many("gdelt", stream)
        (batch,) = ring.traces
        trees.append(batch)
    rb, pb = trees
    assert pb.name == "query.batch" and pb.attributes["n"] == 5
    members = [c for c in pb.children if c.name == "query"]
    assert len(members) == 5 and all(m.attributes["batched"] for m in members)
    assert [m.attributes["hits"] for m in members] == \
        [m.attributes["hits"] for m in rb.children if m.name == "query"]
    # the reference's first stream also compiles (``xla.compile``)
    assert {c.name for c in pb.children} == {c.name for c in rb.children} - {"xla.compile"}
    shared = pb.find("device.fetch.shared")
    assert shared and shared[0].attributes["shared_q"] == 5
    assert "device" in pb.attributes


def test_no_trace_no_spans():
    """With nothing listening a span is the shared no-op, and a query
    records nothing."""
    assert trace.span("x") is trace.NOOP
    assert not trace.active() and trace.current_trace_id() is None
    trace.event("nothing")
    trace.set_attr("k", 1)
    ring = trace.InMemoryTraceExporter()
    _ref, port = pair()
    port.query("gdelt", CQL)
    assert ring.traces == []


def test_tree_round_trip_and_render_equal_the_reference():
    d = {"name": "query", "trace_id": "t1", "span_id": "s1", "start_ms": 5.0,
         "duration_ms": 12.5, "attributes": {"type": "gdelt", "hits": 4},
         "events": [{"name": "decision.pyramid", "t_ms": 1.25, "reason": "hit"}],
         "children": [{"name": "scan", "trace_id": "t1", "span_id": "s2", "parent_id": "s1",
                       "start_ms": 6.0, "duration_ms": 10.0, "attributes": {"index": "z3"},
                       "children": [{"name": "scan.block", "trace_id": "t1", "span_id": "s3",
                                     "parent_id": "s2", "start_ms": 6.5, "duration_ms": 7.0,
                                     "attributes": {"rows_in": 10, "rows_out": 3}}]}]}
    sp, rsp = trace.Span.from_dict(d), ref_trace.Span.from_dict(d)
    assert sp.to_dict() == rsp.to_dict() == d
    assert sp.render() == rsp.render()
    assert sp.self_time_ms == rsp.self_time_ms == 2.5
    assert [s.name for s in sp.walk()] == ["query", "scan", "scan.block"]
    parent = trace.Span.from_dict({"name": "rpc", "trace_id": "T", "span_id": "p"})
    rparent = ref_trace.Span.from_dict({"name": "rpc", "trace_id": "T", "span_id": "p"})
    trace.graft(parent, sp, offset_ms=100.0)
    ref_trace.graft(rparent, rsp, offset_ms=100.0)
    assert parent.to_dict() == rparent.to_dict()


def test_exporters_ring_and_wrap(tmp_path):
    path = tmp_path / "traces.jsonl"
    jl = trace.JsonLinesTraceExporter(str(path))
    stream = io.StringIO()
    logger = logging.getLogger("test_torch_observability.trace")
    logger.addHandler(logging.StreamHandler(stream))
    logger.setLevel(logging.INFO)
    lg = trace.LoggingTraceExporter(logger)
    ring = trace.ensure_ring(capacity=4)
    assert trace.ensure_ring() is ring
    try:
        with trace.exporting(jl), trace.exporting(lg):
            for i in range(6):
                with trace.span("query", type="t") as root:
                    with trace.span("scan"):
                        got = []
                        th = threading.Thread(
                            target=trace.wrap(lambda: got.append(trace.current_trace_id())))
                        th.start()
                        th.join()
                assert got == [root.trace_id]
            with trace.span("stream.poll"):
                pass  # not a query root: the debug ring skips it
        assert len(ring.traces) == 4 and all(t.name == "query" for t in ring.traces)
        assert trace.recent_traces(2) == ring.traces[-2:]
        assert trace.find_trace(ring.traces[-1].trace_id) is ring.traces[-1]
        assert trace.find_trace("nope") is None and trace.recent_traces(0) == []
        assert trace.blackbox_traces(1) == ring.traces[-1:]
        lines = path.read_text().splitlines()
        assert len(lines) == 7 and json.loads(lines[0])["children"][0]["name"] == "scan"
        assert stream.getvalue().count("trace ") == 7
    finally:
        trace.release_ring()
        trace.release_ring()
    assert trace.recent_traces() == []
    assert not trace.active()


# -- the audit trail ------------------------------------------------------------

EVENT_TIMED = ("date_ms", "planning_ms", "scanning_ms", "trace_id")
EVENT_BYTES = ("recompiles", "h2d_bytes", "d2h_bytes", "pad_ratio")


def _event(ev, drop=EVENT_TIMED + EVENT_BYTES):
    return {k: v for k, v in vars(ev).items() if k not in drop}


def test_query_events_equal_the_reference():
    """Solo queries, a query_many stream and a timed-out query: the events
    bar their times and bytes equal the reference's; each event's bytes are
    the port's own receipt for that query."""
    ref, port = _audited_pair()
    got, receipts = [], []
    for cql in CQLS:
        ref.query("gdelt", RefQuery.cql(cql))
        res = port.query("gdelt", Query.cql(cql))
        receipts.append(res.receipt)
    stream = CQLS[:3]
    ref.query_many("gdelt", stream)
    receipts += [r.receipt for r in port.query_many("gdelt", stream)]
    got = port.audit_writer.events
    want = ref.audit_writer.events
    assert len(got) == len(want) == len(CQLS) + len(stream)
    for g, w in zip(got, want):
        assert g.store == "TorchDataStore" and w.store == "TpuDataStore"
        assert {**_event(g), "store": ""} == {**_event(w), "store": ""}
        assert g.user == "ana" and g.outcome == "ok"
    for ev, rc in zip(got, receipts):
        assert {k: getattr(ev, k) for k in EVENT_BYTES} == rc
    assert port.metrics.counter("queries") == ref.metrics.counter("queries") == len(got)
    assert port.metrics.report()["query.scan"]["count"] == len(got)


def test_event_joins_its_trace_and_failures_audit():
    _ref, port = _audited_pair()
    ring = trace.InMemoryTraceExporter()
    with trace.exporting(ring):
        port.query("gdelt", CQL)
    assert port.audit_writer.events[-1].trace_id == ring.traces[-1].trace_id
    with deadline.budget(1e-9):
        with pytest.raises(QueryTimeout):
            port.query("gdelt", CQL)
    ev = port.audit_writer.events[-1]
    assert (ev.outcome, ev.hits) == ("timeout", 0)
    assert port.metrics.counter("queries.timeout") == 1
    row = [r for r in port._plans_obj().rows(n=99) if "timeout" in r["outcomes"]]
    assert row and row[0]["outcomes"]["timeout"] == 1


def test_logging_audit_writer():
    stream = io.StringIO()
    logger = logging.getLogger("test_torch_observability.audit")
    logger.addHandler(logging.StreamHandler(stream))
    logger.setLevel(logging.INFO)
    ev = QueryEvent("s", "gdelt", "u", "INCLUDE", {}, 0, 1.0, 2.0, 7)
    audit.LoggingAuditWriter(logger).write_event(ev)
    assert "query type=gdelt user=u filter='INCLUDE' plan=1.0ms scan=2.0ms hits=7" in \
        stream.getvalue()
    ring = InMemoryAuditWriter(capacity=2)
    for _ in range(3):
        ring.write_event(ev)
    assert len(ring.events) == 2


def _fill_registry(mod, reg, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(40):
        reg.inc(f"c.{i % 4}", int(rng.integers(1, 5)))
        reg.update_timer(f"t.{i % 3}", float(rng.integers(1, 900)) / 1e4)
    reg.set_gauge("g.one", 1.5)
    reg.gauge_fn("g.two", lambda: 2.0)
    reg.gauge_fn("g.bad", lambda: 1 / 0)


def test_prometheus_text_equals_the_reference():
    regs = [MetricsRegistry(), MetricsRegistry()]
    refs = [ref_audit.MetricsRegistry(), ref_audit.MetricsRegistry()]
    for i in range(2):
        _fill_registry(audit, regs[i], seed=i)
        _fill_registry(ref_audit, refs[i], seed=i)
    text = audit.prometheus_text(regs)
    assert text == ref_audit.prometheus_text(refs)
    assert "# TYPE geomesa_t_0 summary" in text and "geomesa_c_0 " in text
    assert audit.prometheus_text(regs[0], prefix="") == \
        ref_audit.prometheus_text(refs[0], prefix="")
    assert regs[0].report() == refs[0].report()


def test_exemplars_equal_the_reference_and_reach_the_text():
    for mod in (audit, ref_audit):
        mod.set_exemplars(True)
    try:
        reg, ref = MetricsRegistry(), ref_audit.MetricsRegistry()
        for sec in (0.0001, 0.002, 0.05, 3.0, -1.0):
            assert audit.exemplar_bucket(sec) == ref_audit.exemplar_bucket(sec)
        with trace.span("query", force=True) as root:
            reg.update_timer("query.scan", 0.05)
        with ref_trace.span("query", force=True, trace_id=root.trace_id):
            ref.update_timer("query.scan", 0.05)
        got, want = reg.exemplars("query.scan"), ref.exemplars("query.scan")
        assert got["buckets"].keys() == want["buckets"].keys()
        assert got["buckets"][5][1] == want["buckets"][5][1] == root.trace_id
        assert f'trace_id="{root.trace_id}"' in audit.prometheus_text(reg)
        reg.drop_timer("query.scan")
        assert reg.exemplars("query.scan") == {} and reg.report() == {}
    finally:
        for mod in (audit, ref_audit):
            mod.set_exemplars(False)
    reg.update_timer("x", 0.1)
    assert reg.exemplars() == {}
    with reg.timer("y"):
        pass
    assert reg.report()["y"]["count"] == 1


def test_reporters(tmp_path):
    reg = MetricsRegistry()
    _fill_registry(audit, reg)
    stream = io.StringIO()
    audit.ConsoleReporter(reg, stream=stream).report_now()
    assert '"c.0"' in stream.getvalue()
    path = tmp_path / "metrics.tsv"
    audit.DelimitedFileReporter(reg, str(path)).report_now()
    rows = [line.split("\t") for line in path.read_text().splitlines()]
    assert {r[1] for r in rows} >= {"c.0", "g.one", "t.0.p99_ms"}
    prom = tmp_path / "metrics.prom"
    audit.PrometheusReporter(reg, str(prom), extra_registries=[]).report_now()
    assert prom.read_text() == audit.prometheus_text([reg])
    calls = []

    class Failing(audit.Reporter):
        def emit(self, snapshot):
            calls.append(1)
            raise OSError("sink down")

    r = Failing(reg, interval_s=0.01).start()
    try:
        for _ in range(200):
            if len(calls) >= 2:
                break
            threading.Event().wait(0.01)
    finally:
        r.stop()
    assert len(calls) >= 2  # an emit that raises does not end the schedule
    log = logging.getLogger("test_torch_observability.reporter")
    audit.LoggingReporter(reg, logger_name=log.name).report_now()


def test_slow_query_log_tail_and_storm_guard(caplog):
    """A zero budget: every query, member, batch overhead and aggregate files
    a summary in the tail; the storm guard (1 a minute) lets at most one
    full render through and counts the rest."""
    _ref, port = pair(port_kw={"slow_query_s": 0.0})
    assert port.slow_query_s == 0.0
    before = audit.slow_query_tail(256)
    d0 = audit.robustness_metrics().counter("slowlog.dropped")
    with properties(geomesa_query_slow_max_per_min="1"):
        with caplog.at_level(logging.WARNING, logger="geomesa_tpu_torch.slowquery"):
            port.query("gdelt", CQL)
            port.query_many("gdelt", CQLS[:2])
            port.aggregate("gdelt", CQL)
    new = audit.slow_query_tail(256)[len(before):] if len(before) < 250 else \
        audit.slow_query_tail(5)
    assert [e["kind"] for e in new] == ["query", "query", "query", "batch", "query"]
    assert all(e["type"] == "gdelt" and e["trace_id"] for e in new)
    dropped = sum(1 for e in new if e.get("dropped"))
    assert dropped >= 4
    assert audit.robustness_metrics().counter("slowlog.dropped") - d0 == dropped
    renders = [r for r in caplog.records if "slow query" in r.getMessage()]
    assert len(renders) == 5 - dropped
    assert audit.slow_query_tail(0) == []


def test_slow_query_note_matches_the_reference():
    with properties(geomesa_query_slow_max_per_min="0"):
        assert audit.slow_query_note({"kind": "query", "type": "t"}) is False
    assert audit.slow_query_tail(1)[0]["dropped"] is True


# -- kNN and the coalescer --------------------------------------------------------


def test_knn_device_path_audits_itself(monkeypatch):
    _ref, port = _audited_pair()
    monkeypatch.setenv("GEOMESA_KNN_DEVICE", "1")
    with devstats.collecting() as rc:
        got = knn_search(port, "gdelt", 1.0, 2.0, k=5)
    assert len(got) == 5
    ev = port.audit_writer.events[-1]
    assert (ev.scan_path, ev.hits, ev.filter, ev.hints) == (
        "device-topk", 5, "KNN(1.0, 2.0, k=5)", {"knn": 5})
    assert ev.h2d_bytes == rc["h2d_bytes"] and ev.d2h_bytes == rc["d2h_bytes"]
    assert port.metrics.counter("queries") == 1


def _hold_slot(ctl):
    import contextvars

    ctx = contextvars.Context()
    admit = ctl.admit()
    ctx.run(admit.__enter__)
    return lambda: ctx.run(admit.__exit__, None, None, None)


def test_coalesced_wave_audits_each_member():
    """A wave of four concurrent queries rides one group: one event a
    member, its bytes its receipt, and ``coalesce.joined`` on the
    fingerprints."""
    _ref, port = _audited_pair()
    cqls = [f"bbox(geom, {-40 + 5 * i}, -30, {5 * i}, 30)" for i in range(4)]
    results = [None] * 4
    barrier = threading.Barrier(4)

    def worker(i):
        barrier.wait(timeout=30)
        results[i] = port.query("gdelt", cqls[i])

    with properties(geomesa_batch_enabled="true", geomesa_batch_window_ms="5000",
                    geomesa_batch_max_queries="4"):
        release = _hold_slot(port.admission)
        try:
            ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
        finally:
            release()
    assert all(r is not None and r.coalesced == 4 for r in results)
    evs = port.audit_writer.events
    assert len(evs) == 4
    by_hits = sorted((e.hits, e.h2d_bytes, e.d2h_bytes) for e in evs)
    assert by_hits == sorted((len(r), r.receipt["h2d_bytes"], r.receipt["d2h_bytes"])
                             for r in results)
    joined = sum(r["decisions"].get("coalesce.joined", 0)
                 for r in port._plans_obj().rows(n=99))
    assert joined == 4
    assert plans.enabled()
