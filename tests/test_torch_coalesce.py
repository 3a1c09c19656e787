"""The port's cross-query coalescer against the JAX package, on the CPU.

The port's twin of ``tests/test_batch_coalesce.py``. The same columns go
through ``_insert_columns`` into the reference ``TpuDataStore`` on a
one-device CPU mesh and into the port's ``TorchDataStore(device="cpu")``:
config #1's GDELT-style points (``bench.synthesize``), config #4's
attribute table, config #3's ways and the polygon plane's points
(``chip_smoke``'s generators at small N). A wave of concurrent
``store.query`` calls of one shape (z3 box+window, z2 box, the member and
range attribute planes, xz2 extents, stars) must give each query the fids
and the route (``_scan_label``) the reference gives it under the same
concurrency, and the fids the port gives it alone.

Group formation does not depend on the scheduler: each wave holds one
admission slot (so every arrival passes the concurrency gate) and sets
``geomesa.batch.max.queries`` to the wave's size, so the group closes when
its last member joins; the wide window is only an upper bound. The knobs
go through the environment, which both packages read.
"""

import contextvars
import threading

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import bench
import chip_smoke as cs
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.utils import deadline, devstats, faults
from geomesa_tpu_torch.utils.audit import QueryTimeout, robustness_metrics
from geomesa_tpu_torch.utils.config import properties

REF_ENV = {
    "GEOMESA_EXACT_DEVICE": "1",
    "GEOMESA_DEVBATCH": "1",
    "GEOMESA_BATCH_PROTO": "bitmap",
    "GEOMESA_SEEK": "0",
    "GEOMESA_BATCH_ENABLED": "true",
    # an upper bound only: a wave's group closes on its last join
    "GEOMESA_BATCH_WINDOW_MS": "5000",
}
WAVE = 4
N_POINTS = 20_000
N_ATTR = 12_000
N_WAYS = 3000
N_POLY = 12_000
GDELT_SPEC = "dtg:Date,*geom:Point:srid=4326"


@pytest.fixture(scope="module", autouse=True)
def _env():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_ENV.items():
            mp.setenv(k, v)
        mp.setenv("GEOMESA_BATCH_MAX_QUERIES", str(WAVE))
        yield mp
    torch.set_num_threads(old)


def _fids(n, prefix="f"):
    return np.char.add(prefix, np.arange(n).astype(str))


@pytest.fixture(scope="module")
def tables():
    x, y, t = bench.synthesize(N_POINTS)
    attr, rng = cs.synthesize_attr(N_ATTR)
    ways = cs.synthesize_ways(N_WAYS, seed=2, bounds=(-15.0, -15.0, 45.0, 35.0), clusters=4)
    px, py = cs.synthesize_poly(N_POLY)
    return {
        "gdelt": (GDELT_SPEC, {"__fid__": _fids(N_POINTS), "geom__x": x, "geom__y": y,
                               "dtg": t}),
        "attr": (cs.ATTR_SPEC, cs.attr_columns(attr, _fids(N_ATTR))),
        "ways": (cs.WAYS_SPEC, cs.ways_columns(ways)),
        "poly": (cs.POLY_SPEC, {"__fid__": _fids(N_POLY), "geom__x": px, "geom__y": py}),
    }, rng


def _load(store, parse, tables):
    for name, (spec, cols) in tables.items():
        ft = parse(name, spec)
        store.create_schema(ft)
        store._insert_columns(ft, dict(cols))
    return store


@pytest.fixture(scope="module")
def stores(tables, _env):
    cols, _rng = tables
    ref = TpuDataStore(executor=TpuScanExecutor(Mesh(np.asarray(jax.devices()[:1]), ("shards",))))
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    return _load(ref, ref_parse_spec, cols), _load(port, parse_spec, cols)


def _waves(rng):
    boxes, cqls = bench.make_queries(2 * WAVE)
    j = cs.attr_streams(rng, reps=2 * WAVE)["j"]
    return {
        "z3": ("gdelt", cqls[:WAVE]),
        "z2": ("gdelt", [cs.bbox_cql(b) for b in boxes[WAVE:]]),
        "member": ("attr", [c for c, _ in j[0::2]]),
        "range": ("attr", [c for c, _ in j[1::2]]),
        "xz2": ("ways", [c for c, _ in cs.xz_streams(reps=WAVE)["xz2_bbox"]]),
        "stars": ("poly", [c for c, _ in cs.poly_streams()["l"][:WAVE]]),
    }


ROUTES = {"z3": "device-exact/mask", "z2": "device-exact/mask", "member": "device-exact/mask",
          "range": "device-exact/mask", "xz2": "device-batch-dual/mask",
          "stars": "device-batch-dual/mask"}


def _hold_slot(ctl):
    """Hold one admission slot in a context of its own: every wave arrival
    then sees another query in flight."""
    ctx = contextvars.Context()
    admit = ctl.admit()
    ctx.run(admit.__enter__)
    return lambda: ctx.run(admit.__exit__, None, None, None)


def _wave(store, name, cqls, hold=True, budgets=None):
    """One query a thread, barrier-started; -> (results, errors) by
    position. ``budgets`` gives a query its own deadline (seconds)."""
    results = [None] * len(cqls)
    errors = {}
    barrier = threading.Barrier(len(cqls))

    def worker(i):
        try:
            barrier.wait(timeout=30)
            budget = None if budgets is None else budgets[i]
            with deadline.budget(budget):
                results[i] = store.query(name, cqls[i])
        except Exception as e:  # noqa: BLE001 - surfaced to the test
            errors[i] = e

    release = _hold_slot(store.admission) if hold else (lambda: None)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(cqls))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        release()
    return results, errors


def _fidset(res):
    return set(np.asarray(res.fids).astype(str).tolist())


def _ref_route(res):
    return res.plan.scan_path


def _counter(name):
    return devstats.devstats_metrics().counter(name)


@pytest.mark.parametrize("shape", list(ROUTES))
def test_coalesced_parity_with_reference_and_solo(stores, tables, shape):
    ref, port = stores
    name, cqls = _waves(tables[1])[shape]
    solo = [port.query(name, c) for c in cqls]
    g0, s0 = _counter("batch.coalesce.groups"), _counter("batch.coalesce.plans.stacked")
    got, errors = _wave(port, name, cqls)
    assert not errors, errors
    want, ref_errors = _wave(ref, name, cqls)
    assert not ref_errors, ref_errors
    assert _counter("batch.coalesce.groups") - g0 == 1
    assert _counter("batch.coalesce.plans.stacked") - s0 == WAVE
    for c, s, g, w in zip(cqls, solo, got, want):
        assert _fidset(g) == _fidset(s) == _fidset(w), c
        assert g.scan_path == _ref_route(w) == ROUTES[shape], (c, g.scan_path, _ref_route(w))
        assert g.coalesced == WAVE
        assert s.coalesced == 0 and s.scan_path != g.scan_path


def test_escape_hatch_is_solo(stores, tables):
    _ref, port = stores
    name, cqls = _waves(tables[1])["z3"]
    solo = [port.query(name, c) for c in cqls]
    g0 = _counter("batch.coalesce.groups")
    with properties(geomesa_batch_enabled="false"):
        got, errors = _wave(port, name, cqls)
    assert not errors, errors
    assert _counter("batch.coalesce.groups") == g0
    for s, g in zip(solo, got):
        assert _fidset(g) == _fidset(s)
        assert g.scan_path == s.scan_path == "device-exact/runs"
        assert g.coalesced == 0


def test_quiet_store_skips_the_window(stores):
    _ref, port = stores
    g0 = _counter("batch.coalesce.groups")
    res = port.query("gdelt", bench.QUERY)
    assert _counter("batch.coalesce.groups") == g0
    assert res.scan_path == "device-exact/runs" and res.coalesced == 0


def test_lone_member_declines(stores, _env):
    """A wave of an exact query and an OR of boxes: the OR declines as
    kernel_ineligible, which leaves the exact query lone in its mask group
    (lone_member); both take the route a query_many batch gives them, as
    on the reference."""
    ref, port = stores
    cqls = [bench.QUERY, f"({cs.bbox_cql(bench.BOX)} OR {cs.bbox_cql((0.0, 46.0, 5.0, 50.0))}) "
                         f"AND {bench.DURING}"]
    _env.setenv("GEOMESA_BATCH_MAX_QUERIES", "2")
    try:
        reg = robustness_metrics()
        lone0 = reg.counter("decision.coalesce.lone_member")
        inel0 = reg.counter("decision.coalesce.kernel_ineligible")
        rest0 = _counter("batch.coalesce.plans.rest")
        got, errors = _wave(port, "gdelt", cqls)
        assert not errors, errors
        want, ref_errors = _wave(ref, "gdelt", cqls)
        assert not ref_errors, ref_errors
    finally:
        _env.setenv("GEOMESA_BATCH_MAX_QUERIES", str(WAVE))
    assert reg.counter("decision.coalesce.lone_member") - lone0 == 1
    assert reg.counter("decision.coalesce.kernel_ineligible") - inel0 == 1
    assert _counter("batch.coalesce.plans.rest") - rest0 == 2
    for c, g, w in zip(cqls, got, want):
        assert _fidset(g) == _fidset(w) == _fidset(port.query("gdelt", c)), c
        assert g.scan_path == _ref_route(w), (c, g.scan_path, _ref_route(w))
        assert g.coalesced == 2
    assert got[0].scan_path == "device-exact/runs"


def test_member_receipts_sum_to_the_group_cost(stores, tables):
    """The members' receipts sum exactly to the link bytes of the wave
    (the remainder of the split spreads); the d2h bytes are the q
    full-table planes, the h2d bytes the q boxes and windows."""
    _ref, port = stores
    name, cqls = _waves(tables[1])["z3"]
    port.query(name, cqls[0])  # the mirror and its exact columns, before the wave
    d0, h0 = _counter("device.d2h.bytes"), _counter("device.h2d.bytes")
    got, errors = _wave(port, name, cqls)
    assert not errors, errors
    d2h, h2d = _counter("device.d2h.bytes") - d0, _counter("device.h2d.bytes") - h0
    assert sum(r.receipt["d2h_bytes"] for r in got) == d2h
    assert sum(r.receipt["h2d_bytes"] for r in got) == h2d
    segs = port.executor.device_index(port._tables[name]["z3"]).segments
    assert d2h == WAVE * sum(seg.n_padded // 8 for seg in segs)
    assert h2d == len(segs) * WAVE * (4 + 2) * 8
    shares = sorted(r.receipt["d2h_bytes"] for r in got)
    assert shares[-1] - shares[0] <= 1


@pytest.mark.parametrize("kind", ["error", "drop", "latency"])
@pytest.mark.parametrize("seed", [3, 11])
def test_seam_fault_degrades_to_solo_with_parity(stores, tables, kind, seed):
    _ref, port = stores
    name, cqls = _waves(tables[1])["z3"]
    want = [_fidset(port.query(name, c)) for c in cqls]
    reg = robustness_metrics()
    deg0 = reg.counter("degrade.coalesce_to_solo")
    fired0 = reg.counter(f"fault.batch.coalesce.{kind}")
    with faults.inject(f"batch.coalesce:{kind}=0.7", seed=seed):
        got, errors = _wave(port, name, cqls)
    assert not errors, errors
    for w, g in zip(want, got):
        assert _fidset(g) == w  # parity, never one member's rows in another's
    fired = reg.counter(f"fault.batch.coalesce.{kind}") - fired0
    degraded = reg.counter("degrade.coalesce_to_solo") - deg0
    if kind == "latency":
        assert degraded == 0
        assert all(g.scan_path == "device-exact/mask" for g in got)
    else:
        assert degraded == fired
        if fired:
            assert all(g.scan_path == "device-exact/runs" for g in got)


def test_member_budget_dies_mid_window(stores, tables, _env):
    """A member whose budget dies in the window raises QueryTimeout while
    its siblings answer. The group waits for a fourth member that never
    comes, so the window (1 s) outlasts the tight budget (0.1 s) whoever
    leads."""
    _ref, port = stores
    name, cqls = _waves(tables[1])["z3"]
    cqls = cqls[:3]
    want = [_fidset(port.query(name, c)) for c in cqls]
    _env.setenv("GEOMESA_BATCH_WINDOW_MS", "1000")
    try:
        got, errors = _wave(port, name, cqls, budgets=[None, None, 0.1])
    finally:
        _env.setenv("GEOMESA_BATCH_WINDOW_MS", REF_ENV["GEOMESA_BATCH_WINDOW_MS"])
    assert set(errors) == {2} and isinstance(errors[2], QueryTimeout), errors
    assert _fidset(got[0]) == want[0] and _fidset(got[1]) == want[1]
