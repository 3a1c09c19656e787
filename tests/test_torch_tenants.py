"""The port's tenant metering and the tenant default priority against the
JAX package, on the CPU.

* ``tenant_of`` / ``clean_label`` label the same inputs the same way;
* a ``TenantRegistry`` fed the same observations (fixed durations) gives
  the reference's rows, top, totals and payload exactly, the LRU bound and
  its timer drop included; ``timeline_deltas`` and ``merge_rows`` too;
* queries, ``query_many`` members and aggregates of several tenants
  through the reference and the port fold into equal tenant rows, timings
  and receipts aside; per-tenant outcome sums equal the store's
  ``queries`` counters (conservation), shed and timed-out queries
  included;
* ``admission.classify``: the priority hint, then the tenant's default
  (``geomesa.tenants.priority``), then ``geomesa.priority.default``, as
  in the reference; a tenant mapped to ``background`` is shed by the
  brownout ladder's first rung;
* ``geomesa.tenants.enabled=false`` never touches a registry.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.utils import admission as ref_admission
from geomesa_tpu.utils import audit as ref_audit
from geomesa_tpu.utils import deadline as ref_deadline
from geomesa_tpu.utils import tenants as ref_tenants

from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.utils import admission, deadline, tenants
from geomesa_tpu_torch.utils.audit import MetricsRegistry, QueryTimeout, ShedLoad
from geomesa_tpu_torch.utils.config import properties
from telemetry_pair import REF_ENV, pair, untimed

CQL = "bbox(geom, -50, -50, 50, 50)"
LABELS = [None, "", "  ", "acme", " acme ", "x" * 100, 7, "beta", "anon"]


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
    def reset():
        for mod in (tenants, ref_tenants):
            mod.set_enabled(None)
            mod.reset_priority_map()
        for mod in (admission, ref_admission):
            mod.reset_default_priority()

    reset()
    yield
    reset()


@pytest.mark.parametrize("label", LABELS)
def test_labels_equal_the_reference(label):
    assert tenants.clean_label(label) == ref_tenants.clean_label(label)
    q, rq = Query.cql("INCLUDE"), RefQuery.cql("INCLUDE")
    if label is not None:
        q.hints["tenant"] = rq.hints["tenant"] = label
    assert tenants.tenant_of(q) == ref_tenants.tenant_of(rq)
    assert tenants.tenant_of(None) == "anon"


def _observations(seed=0, n=80):
    rng = np.random.default_rng(seed)
    return [dict(label=("acme", "beta", "anon", "gamma", " delta ")[int(rng.integers(0, 5))],
                 cls=("query", "aggregate", "join")[int(rng.integers(0, 3))],
                 outcome=("ok", "ok", "ok", "timeout", "shed")[int(rng.integers(0, 5))],
                 duration_s=float(rng.integers(1, 3000)) / 1e4,
                 rows=int(rng.integers(0, 1000)),
                 receipt=None if i % 4 == 0 else {
                     "recompiles": int(rng.integers(0, 2)),
                     "h2d_bytes": int(rng.integers(0, 1 << 20)),
                     "d2h_bytes": int(rng.integers(0, 1 << 12)),
                     "pad_ratio": float(rng.integers(0, 4)) / 4})
            for i in range(n)]


def _feed(reg, obs):
    for o in obs:
        reg.observe(o["label"], o["cls"], outcome=o["outcome"], duration_s=o["duration_s"],
                    rows=o["rows"], receipt=o["receipt"])


@pytest.mark.parametrize("cap", [3, 64])
def test_registry_equals_the_reference(cap):
    obs = _observations()
    reg, ref = tenants.TenantRegistry(cap=cap), ref_tenants.TenantRegistry(cap=cap)
    _feed(reg, obs)
    _feed(ref, obs)
    for sort in tenants.SORTS:
        assert reg.rows(sort=sort, n=99) == ref.rows(sort=sort, n=99)
    assert reg.top(3) == ref.top(3)
    assert reg.totals() == ref.totals()
    assert reg.payload(n=2) == ref.payload(n=2)
    assert len(reg) == len(ref) <= cap and reg.evicted == ref.evicted
    # an evicted tenant's timer goes with it
    timers = reg.metrics.snapshot()[2]
    assert set(timers) == {f"tenant.{r['tenant']}" for r in reg.rows(n=99)}
    with pytest.raises(ValueError):
        reg.rows(sort="nope")


def test_deltas_and_merge_equal_the_reference():
    obs = _observations(seed=2)
    regs = [tenants.TenantRegistry(cap=64) for _ in range(2)]
    refs = [ref_tenants.TenantRegistry(cap=64) for _ in range(2)]
    for i in range(2):
        _feed(regs[i], obs[i::2])
        _feed(refs[i], obs[i::2])
    assert tenants.merge_rows([r.rows(n=99) for r in regs]) == \
        ref_tenants.merge_rows([r.rows(n=99) for r in refs])
    prev, rows = tenants.timeline_deltas(regs[0], {})
    rprev, rrows = ref_tenants.timeline_deltas(refs[0], {})
    assert (prev, rows) == (rprev, rrows)
    _feed(regs[0], obs[:7])
    _feed(refs[0], obs[:7])
    assert tenants.timeline_deltas(regs[0], prev) == ref_tenants.timeline_deltas(refs[0], rprev)
    assert tenants.timeline_deltas(None, prev) == (prev, [])


def _q(qc, cql, tenant=None, **hints):
    q = qc.cql(cql)
    if tenant is not None:
        q.hints["tenant"] = tenant
    q.hints.update(hints)
    return q


def _untimed_rows(ds):
    """The store's tenant rows by label, without times (a class's ``ms``
    too) or receipts."""
    out = {}
    for r in untimed(ds._tenants_obj().rows(n=99), drop=("receipt",)):
        r["classes"] = {k: {kk: vv for kk, vv in v.items() if kk != "ms"}
                        for k, v in r["classes"].items()}
        out[r["tenant"]] = r
    return out


def test_store_tenant_rows_equal_the_reference():
    ref, port = pair(ref_kw={"metrics": ref_audit.MetricsRegistry()},
                     port_kw={"metrics": MetricsRegistry()})
    work = [(CQL, "acme"), ("bbox(geom, -10, -10, 10, 10)", "beta"), (CQL, None),
            ("actor = 'USA'", "acme"), ("EXCLUDE", "gamma")]
    for ds, qc, dl in ((ref, RefQuery, ref_deadline), (port, Query, deadline)):
        for cql, t in work:
            ds.query("gdelt", _q(qc, cql, t))
        ds.query_many("gdelt", [_q(qc, c, t) for c, t in work[:3]])
        ds.aggregate("gdelt", _q(qc, CQL, "beta"), columns=["val"])
        with dl.budget(1e-9):
            with pytest.raises(Exception, match="budget|exceeded"):
                ds.query("gdelt", _q(qc, CQL, "delta"))
    got, want = _untimed_rows(port), _untimed_rows(ref)
    assert got == want
    rows = list(got.values())
    assert got["acme"]["calls"] == 3 and got["anon"]["calls"] == 2
    assert got["delta"]["outcomes"] == {"timeout": 1} and got["delta"]["bad"] == 1
    assert got["beta"]["classes"]["aggregate"]["calls"] == 1
    # conservation: the tenants' query-class calls are the store's queries
    q_calls = sum(r["classes"].get("query", {}).get("calls", 0) for r in rows)
    assert q_calls == port.metrics.counter("queries") == ref.metrics.counter("queries")
    assert sum(r["outcomes"].get("timeout", 0) for r in rows) == \
        port.metrics.counter("queries.timeout") == 1


@pytest.mark.parametrize("hints,default,mapping", [
    ({}, None, None),
    ({"tenant": "acme"}, None, "acme=critical,beta=background"),
    ({"tenant": " beta "}, "batch", "acme=critical,beta=background"),
    ({"tenant": "gamma"}, "batch", "acme=critical,gamma=nonsense"),
    ({"tenant": "acme", "geomesa.query.priority": "batch"}, None, "acme=critical"),
    ({"geomesa.query.priority": "BOGUS", "tenant": "acme"}, "background", "acme=interactive"),
    ({"tenant": "anon"}, None, "anon=critical"),
])
def test_classify_equals_the_reference(hints, default, mapping, monkeypatch):
    # both packages read the environment (their programmatic tiers differ)
    for var, val in (("GEOMESA_PRIORITY_DEFAULT", default),
                     ("GEOMESA_TENANTS_PRIORITY", mapping)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    for mod in (tenants, ref_tenants):
        mod.reset_priority_map()
    for mod in (admission, ref_admission):
        mod.reset_default_priority()
    got = admission.classify(dict(hints))
    assert got == ref_admission.classify(dict(hints))
    assert got in admission.PRIORITIES
    assert tenants.default_priority("acme") == ref_tenants.default_priority("acme")


def test_a_background_tenant_is_shed_by_the_first_rung():
    """A tenant mapped to ``background`` inherits the class: level 1 of the
    brownout ladder sheds it; an unmapped tenant answers."""
    _ref, port = pair()
    with properties(geomesa_tenants_priority="bulk=background"):
        tenants.reset_priority_map()
        port._brownout.level = 1
        try:
            with pytest.raises(ShedLoad) as e:
                port.query("gdelt", _q(Query, CQL, "bulk"))
            assert e.value.retry_after_s is not None
            assert len(port.query("gdelt", _q(Query, CQL, "acme"))) > 0
        finally:
            port._brownout.level = 0
    row = {r["tenant"]: r for r in port._tenants_obj().rows(n=99)}["bulk"]
    assert row["outcomes"] == {"shed": 1} and row["bad"] == 1


def test_poisoned_registry_with_tenants_off(monkeypatch):
    _ref, port = pair()

    def boom(*a, **k):
        raise AssertionError("the query path touched the tenant registry with tenants off")

    tenants.set_enabled(False)
    monkeypatch.setattr(TorchDataStore, "_tenants_obj", boom)
    monkeypatch.setattr(tenants.TenantRegistry, "observe", boom)
    assert len(port.query("gdelt", _q(Query, CQL, "acme"))) > 0
    port.query_many("gdelt", [_q(Query, CQL, "acme")])
    port.aggregate("gdelt", _q(Query, CQL, "acme"))
    with deadline.budget(1e-9):
        with pytest.raises(QueryTimeout):
            port.query("gdelt", CQL)


def test_flag_and_knobs():
    with properties(geomesa_tenants_enabled="false", geomesa_tenants_max="5"):
        tenants.set_enabled(None)
        assert tenants.tenants_knobs() == (False, 5)
    tenants.set_enabled(None)
    assert tenants.tenants_knobs() == (True, 64)
