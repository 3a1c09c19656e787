"""The port's aggregate pyramid cache against the JAX package, on the CPU.

Ports the cases of ``tests/test_agg_cache.py`` that need no unported module:
the same seeded numpy columns go into the reference ``TpuDataStore`` (on a
one-device CPU mesh) and into the port's ``TorchDataStore(device="cpu")``,
and the port must give the reference's answers by the reference's routes:
counts, ``Count()`` stats, ``aggregate()`` summaries and memoized density
grids, exactly (f64 sums to rtol 1e-12), through every gate of the cache
(the escape hatch, the declines, the memo's hint whitelist, a write, the
TTL, the byte cap, ``agg.build`` faults and deadlines, concurrent callers).

Kernel level: ``pyramid_counts_plain`` (the plain edition of the
``pyramid_counts`` kernel) against the reference's ``make_pyramid_counts``
and both builds' ``host_counts``, bit for bit, on sorted and shuffled rows,
null geometries and bits 2, 8 and 12; and on the layouts that break a run
design (``tests/pyramid_layouts.py``: a hot cell of over 4M rows, a run
over many tiles, three sorted blocks, shuffled rows, pads and a masked row
inside a run, a long empty gap, 1, 31 and 4,097 rows), which the card
tests hold the kernel to.

Invalidation: a pyramid built by a count is dropped by a later delete,
compaction or ``delete_schema`` (``agg.cache.invalidated`` moves), and the
next count and ``aggregate()`` equal the reference's and numpy's over the
surviving rows. A cache-answered query still writes its ``QueryEvent`` with
a zero-dispatch receipt.

Left out (their modules are not ported): the sharded-store cases
(``ShardedDataStore``), the shard breaker case, the web ``/stats/aggregate``
endpoint and the ``/debug/device`` block.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from geomesa_tpu.geom.base import Point as RefPoint
from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.ops import pyramid as ref_pyr
from geomesa_tpu.ops.aggregations import make_pyramid_counts
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore
from geomesa_tpu.utils import faults as ref_faults
from geomesa_tpu.utils.audit import QueryTimeout as RefQueryTimeout
from geomesa_tpu.utils.config import properties as ref_properties

from geomesa_tpu_torch.geom.base import Point
from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops import pyramid as port_pyr
from geomesa_tpu_torch.ops.aggregations import pyramid_counts_plain
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.utils import deadline, devstats, faults, trace
from geomesa_tpu_torch.utils.audit import (
    InMemoryAuditWriter,
    QueryTimeout,
    robustness_metrics,
)
from geomesa_tpu_torch.utils.config import properties
from pyramid_layouts import PYRAMID_LAYOUTS, pyramid_layout

SPEC = "val:Integer,w:Double,dtg:Date,*geom:Point:srid=4326"
T0 = 1483228800000
POLY = "POLYGON((-60 -30, 60 -30, 80 20, 0 45, -80 20, -60 -30))"
CQL = f"INTERSECTS(geom, {POLY})"
BBOX = "BBOX(geom, -50.3, -25.7, 55.9, 35.2)"
SHAPES = [
    "POLYGON((-70 -40, 70 -40, 0 48, -70 -40))",
    "POLYGON((-85 -10, 85 -12, 85 8, -85 10, -85 -10))",
    "POLYGON((-60 -35, 60 -35, 60 40, -60 40, -60 -35),"
    "(-30 -15, 30 -15, 30 20, -30 20, -30 -15))",
]
ENV = (-90.0, -50.0, 90.0, 50.0)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("shards",))


def _columns(n, seed, name="e"):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-90, 90, n)
    y = rng.uniform(-50, 50, n)
    if n > 8:
        x[5], y[5] = np.nan, np.nan  # a null geometry: it never counts
    return {
        "__fid__": np.array([f"{name}{i}" for i in range(n)], dtype=object),
        "val": rng.integers(0, 100, n).astype(np.int32),
        "w": rng.uniform(0.0, 1.0, n),
        "geom__x": x,
        "geom__y": y,
        "dtg": np.full(n, T0, dtype=np.int64),
    }


def _pair(n=4000, seed=0, timeout=None, types=("events",)):
    """The reference's and the port's store of the same rows."""
    ref = TpuDataStore(executor=TpuScanExecutor(_mesh()), query_timeout_s=timeout)
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"), query_timeout_s=timeout)
    for i, name in enumerate(types):
        cols = _columns(n, seed + i, name[0])
        for ds, parse in ((ref, ref_parse_spec), (port, parse_spec)):
            ds.create_schema(parse(name, SPEC))
            ds._insert_columns(ds.get_schema(name), {k: v.copy() for k, v in cols.items()})
    return ref, port


@pytest.fixture(scope="module")
def stores():
    return _pair()


def _pyramid_route(ds, cql, name="events"):
    """Whether the store's pyramid answers this count (its ``_count_pyramid``
    is not None), with the count it gives."""
    q = ds._as_query(cql)
    plan = ds._plan_cached(name, q)
    got = ds._count_pyramid(name, ds.get_schema(name), q, plan)
    return got is not None, got


def _density(cql, width=64, height=64, loose=False, query=Query):
    q = query.cql(cql)
    q.hints["density"] = {"envelope": ENV, "width": width, "height": height}
    if loose:
        q.hints["loose_bbox"] = True
    return q


# -- build parity -------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 8, 12])
def test_device_build_matches_host_builds_bit_for_bit(stores, bits):
    """The port's device build (the kernel's plain edition on the CPU) and
    host build equal the reference's device and host builds, and the null
    geometry counts nowhere."""
    ref, port = stores
    rt, pt = ref._tables["events"]["z2"], port._tables["events"]["z2"]
    ft = port.get_schema("events")
    dev = port.executor.pyramid_counts(pt, bits)
    host = port_pyr.host_counts(pt, ft, bits)
    assert dev.dtype == np.int64 and dev.shape == (1 << bits, 1 << bits)
    assert np.array_equal(dev, host)
    assert np.array_equal(host, ref_pyr.host_counts(rt, ref.get_schema("events"), bits))
    assert np.array_equal(dev, ref.executor.pyramid_counts(rt, bits))
    assert int(host.sum()) == port.count("events") - 1


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("bits", [2, 8, 12])
def test_pyramid_counts_plain_matches_make_pyramid_counts(order, bits):
    """``pyramid_counts_plain`` equals the reference's sort-and-search
    ``make_pyramid_counts`` exactly, rows in key order or shuffled, masked
    rows (pads and null geometries) and the grid's corners included."""
    rng = np.random.default_rng(bits)
    n = 6144
    xi = rng.integers(0, 2**31, n, dtype=np.int64).astype(np.int32)
    yi = rng.integers(0, 2**31, n, dtype=np.int64).astype(np.int32)
    xi[:4] = [0, 2**31 - 1, 0, 2**31 - 1]
    yi[:4] = [0, 0, 2**31 - 1, 2**31 - 1]
    mask = rng.random(n) > 0.1
    mask[-100:] = False  # pad rows
    if order == "sorted":
        o = np.lexsort((xi, yi))
        xi, yi, mask = xi[o], yi[o], mask[o]
    want = np.asarray(make_pyramid_counts(_mesh(), bits)(xi, yi, mask))
    got = pyramid_counts_plain(torch.from_numpy(xi), torch.from_numpy(yi),
                               torch.from_numpy(mask), bits)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1 << bits, 1 << bits)
    assert np.array_equal(got.numpy(), want)
    shift = 31 - bits
    flat = ((yi[mask] >> shift).astype(np.int64) << bits) | (xi[mask] >> shift)
    assert np.array_equal(got.numpy().ravel(), np.bincount(flat, minlength=4**bits))


@pytest.fixture(scope="module")
def layouts():
    return {}


@pytest.mark.parametrize("bits", [2, 8, 12])
@pytest.mark.parametrize("layout", sorted(PYRAMID_LAYOUTS))
def test_pyramid_counts_plain_matches_make_pyramid_counts_on_run_layouts(layouts, layout, bits):
    """The layouts the card tests run ``pyramid_counts`` on: the plain
    edition (through the wrapper, with the layout's block bounds) equals
    the reference's ``make_pyramid_counts`` exactly."""
    if layout not in layouts:
        layouts[layout] = pyramid_layout(layout)
    xi, yi, mask, starts = layouts[layout]
    assert len(xi) == PYRAMID_LAYOUTS[layout] and starts[-1] <= len(xi)
    want = np.asarray(make_pyramid_counts(_mesh(), bits)(xi, yi, mask))
    got = kernels.pyramid_counts(torch.from_numpy(xi), torch.from_numpy(yi),
                                 torch.from_numpy(mask), bits, starts=starts)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1 << bits, 1 << bits)
    assert np.array_equal(got.numpy(), want)
    assert int(want.sum()) == int(mask.sum())


def test_pyramid_block_takes_the_longest_block():
    assert kernels.pyramid_block(None, 10) == (0, 10)
    assert kernels.pyramid_block([0, 3, 9, 10], 12) == (3, 9)
    assert kernels.pyramid_block([0, 4, 8], 8) == (0, 4)
    for bad in ([5], [0, 11], [-1, 4], [0, 6, 5]):
        with pytest.raises(ValueError):
            kernels.pyramid_block(bad, 10)


# -- answer parity ------------------------------------------------------------


@pytest.mark.parametrize("cql", [CQL, BBOX])
def test_count_parity_routes_and_cache_hits(stores, cql):
    ref, port = stores
    want = len(ref.query("events", cql))
    assert len(port.query("events", cql)) == want
    reg = devstats.devstats_metrics()
    h0 = reg.counter("agg.cache.hits")
    assert port.count("events", cql) == ref.count("events", cql) == want  # cold
    assert port.count("events", cql) == ref.count("events", cql) == want  # hot
    assert reg.counter("agg.cache.hits") > h0
    assert _pyramid_route(port, cql) == _pyramid_route(ref, cql) == (True, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", range(3))
def test_polygon_count_parity_across_shapes(shape, seed):
    """Triangles, slivers and a polygon with a hole: the classification
    stays conservative for every shape."""
    ref, port = _pair(seed=seed)
    cql = f"INTERSECTS(geom, {shape})"
    want = len(ref.query("events", cql))
    for _ in range(2):
        assert port.count("events", cql) == ref.count("events", cql) == want
    assert _pyramid_route(port, cql) == _pyramid_route(ref, cql)


def test_agg_enabled_knob_is_an_escape_hatch():
    """``geomesa.agg.enabled=false``: the ordinary paths, no cache activity,
    the same answers."""
    ref, port = _pair(n=800)
    want = len(ref.query("events", CQL))
    reg = devstats.devstats_metrics()
    with properties(geomesa_agg_enabled="false"), ref_properties(geomesa_agg_enabled="false"):
        b0, m0 = reg.counter("agg.cache.builds"), reg.counter("agg.cache.misses")
        for _ in range(2):
            assert port.count("events", CQL) == ref.count("events", CQL) == want
        assert (reg.counter("agg.cache.builds"), reg.counter("agg.cache.misses")) == (b0, m0)
        assert _pyramid_route(port, CQL) == _pyramid_route(ref, CQL) == (False, None)
    assert port.count("events", CQL) == want
    assert _pyramid_route(port, CQL) == (True, want)


def test_tiny_region_declines_but_stays_exact(stores):
    ref, port = stores
    cql = "BBOX(geom, 10.0, 10.0, 10.4, 10.3)"
    reg = devstats.devstats_metrics()
    d0 = reg.counter("agg.cache.declined")
    assert port.count("events", cql) == ref.count("events", cql) == len(ref.query("events", cql))
    assert reg.counter("agg.cache.declined") > d0
    assert _pyramid_route(port, cql) == _pyramid_route(ref, cql) == (False, None)


@pytest.mark.parametrize("cql", [f"CONTAINS(geom, {POLY})",
                                 "DWITHIN(geom, POINT(10 10), 2000000, meters)"])
def test_non_containment_predicates_decline_the_pyramid(stores, cql):
    """CONTAINS inverts the operands and DWITHIN reaches past the literal:
    the pyramid must decline both."""
    ref, port = stores
    want = len(ref.query("events", cql))
    for _ in range(2):
        assert port.count("events", cql) == ref.count("events", cql) == want
    assert _pyramid_route(port, cql) == _pyramid_route(ref, cql) == (False, None)


def test_loose_bbox_never_shares_the_density_memo(monkeypatch):
    monkeypatch.setenv("GEOMESA_DENSITY_DEVICE", "1")
    ref, port = _pair()
    reg = devstats.devstats_metrics()
    routes = []
    for ds, query in ((ref, RefQuery), (port, Query)):
        ds.query("events", _density(BBOX, 32, 32, query=query))  # fills the memo
        # a plan object is shared by the queries of one filter: read each
        # query's route before the next query runs
        hot = ds.query("events", _density(BBOX, 32, 32, query=query)).plan.scan_path
        loose = ds.query("events", _density(BBOX, 32, 32, loose=True, query=query))
        routes.append((hot, loose.plan.scan_path))
    assert routes[1][0] == "agg-cache-density"
    assert routes[0] == routes[1]
    h0 = reg.counter("agg.cache.hits")
    port.query("events", _density(BBOX, 32, 32, loose=True))
    assert reg.counter("agg.cache.hits") == h0


def _aggregate_route(ds, monkeypatch):
    """Record which route each ``aggregate`` call of ``ds`` takes."""
    seen = []
    own = ds._aggregate_pyramid

    def spy(*a, **kw):
        got = own(*a, **kw)
        seen.append("agg-pyramid" if got is not None else "agg-exact-fallback")
        return got

    monkeypatch.setattr(ds, "_aggregate_pyramid", spy)
    return seen


@pytest.mark.parametrize("cql", [CQL, BBOX])
def test_aggregate_columns_parity(cql, monkeypatch):
    """``aggregate()`` from the pyramid equals the reference's and the full
    uncached query's: counts, integer sums, min and max exactly, the f64 sum
    to rtol 1e-12; the hot repeat gives the same summary."""
    ref, port = _pair()
    routes = [_aggregate_route(ref, monkeypatch), _aggregate_route(port, monkeypatch)]
    got = port.aggregate("events", cql, columns=["val", "w"])
    want = ref.aggregate("events", cql, columns=["val", "w"])
    res = port.query("events", cql)
    v, w = np.asarray(res.columns["val"]), np.asarray(res.columns["w"])
    assert got["count"] == want["count"] == len(res)
    assert got["columns"]["val"] == want["columns"]["val"]
    assert got["columns"]["val"]["sum"] == int(v.sum())
    assert (got["columns"]["val"]["min"], got["columns"]["val"]["max"]) == (v.min(), v.max())
    gw, ww = got["columns"]["w"], want["columns"]["w"]
    assert (gw["count"], gw["min"], gw["max"]) == (ww["count"], ww["min"], ww["max"])
    assert (gw["min"], gw["max"]) == (float(w.min()), float(w.max()))
    assert np.isclose(gw["sum"], ww["sum"], rtol=1e-12, atol=0)
    assert np.isclose(gw["sum"], w.sum(), rtol=1e-12, atol=0)
    assert port.aggregate("events", cql, columns=["val", "w"]) == got
    assert ref.aggregate("events", cql, columns=["val", "w"]) == want
    assert routes[0] == routes[1] == ["agg-pyramid", "agg-pyramid"]


def test_aggregate_fallback_parity_on_non_spatial_filter(stores, monkeypatch):
    ref, port = stores
    routes = [_aggregate_route(ref, monkeypatch), _aggregate_route(port, monkeypatch)]
    cql = f"{CQL} AND val > 50"
    got = port.aggregate("events", cql, columns=["val"])
    assert got == ref.aggregate("events", cql, columns=["val"])
    res = port.query("events", cql)
    assert got["count"] == len(res)
    assert got["columns"]["val"]["sum"] == int(np.asarray(res.columns["val"]).sum())
    assert routes[0] == routes[1] == ["agg-exact-fallback"]


def test_aggregate_validates_columns():
    ref, port = _pair(n=50)
    for ds, err in ((ref, ref_pyr.AggError), (port, port_pyr.AggError)):
        with pytest.raises(err):
            ds.aggregate("events", CQL, columns=["nope"])
    port.create_schema(parse_spec("tagged", "tag:String,*geom:Point:srid=4326"))
    with port.writer("tagged") as w:
        w.write(["a", Point(1.0, 2.0)], fid="t0")
    with pytest.raises(port_pyr.AggError, match="not numeric"):
        port.aggregate("tagged", "INCLUDE", columns=["tag"])


@pytest.mark.parametrize("spec", ["Count()", "Count();Count()"])
def test_stats_count_shortcut_parity(stores, spec):
    ref, port = stores
    want = len(ref.query("events", CQL))
    for _ in range(2):  # cold, then hot
        got = [ds.query("events", query.cql(CQL, hints={"stats": spec}))
               for ds, query in ((ref, RefQuery), (port, Query))]
        for r in got:
            stats = r.aggregate["stats"]
            for st in getattr(stats, "stats", [stats]):
                assert int(st.count) == want
        assert got[0].plan.scan_path == got[1].plan.scan_path == "agg-pyramid-stats"
        assert got[1].scan_path == "agg-pyramid-stats"


def test_density_memo_is_bit_identical(monkeypatch):
    """The memo's grid is the computed grid; a second query of it routes
    ``agg-cache-density`` in both, and another grid spec is another key."""
    monkeypatch.setenv("GEOMESA_DENSITY_DEVICE", "1")
    ref, port = _pair()
    for cql in (CQL, BBOX):
        r_first = ref.query("events", _density(cql, query=RefQuery))
        first = port.query("events", _density(cql))
        assert first.plan.scan_path == r_first.plan.scan_path
        assert np.array_equal(np.asarray(first.aggregate["density"]),
                              np.asarray(r_first.aggregate["density"]))
        again = port.query("events", _density(cql))
        r_again = ref.query("events", _density(cql, query=RefQuery))
        assert again.plan.scan_path == r_again.plan.scan_path == "agg-cache-density"
        assert np.array_equal(again.aggregate["density"], first.aggregate["density"])
        assert np.array_equal(again.aggregate["density"], np.asarray(r_again.aggregate["density"]))
        other = port.query("events", _density(cql, width=32))
        assert other.aggregate["density"].shape == (64, 32)
        assert other.plan.scan_path != "agg-cache-density"


def test_write_invalidates_pyramid():
    ref, port = _pair()
    n = port.count("events", CQL)
    assert port.count("events", CQL) == n
    reg = devstats.devstats_metrics()
    i0 = reg.counter("agg.cache.invalidated")
    with port.writer("events") as w:
        w.write([1, 0.5, T0, Point(0.0, 0.0)], fid="inside")
        w.write([2, 0.5, T0, Point(120.0, 80.0)], fid="out")
    assert reg.counter("agg.cache.invalidated") > i0
    assert port.count("events", CQL) == n + 1 == len(port.query("events", CQL))
    got = port.aggregate("events", CQL, columns=["val"])
    assert got["count"] == n + 1


def test_ttl_expiry_releases_device_arrays():
    _ref, port = _pair()
    reg = devstats.devstats_metrics()
    with properties(geomesa_agg_cache_ttl="50 ms"):
        port.count("events", CQL)
        cache = port._agg_cache
        pyr = next(e for e in cache._entries.values() if hasattr(e, "counts"))
        assert pyr._dev is not None and len(pyr._dev) == pyr.levels
        assert pyr._dev[0].dtype == torch.int32
        time.sleep(0.1)
        x0 = reg.counter("agg.cache.expired")
        assert cache.get(("probe",), 0.05) is None  # the sweep runs on get
        assert reg.counter("agg.cache.expired") > x0
        assert len(cache) == 0
        assert pyr._dev is None


def test_cache_bytes_cap_evicts_lru():
    """At 8 bits a finest level alone is 512 KiB: a 600 KB cap holds one
    pyramid, so the second type's build evicts the first."""
    ref, port = _pair(n=500, types=("events", "other"))
    reg = devstats.devstats_metrics()
    with properties(geomesa_agg_cache_bytes="600KB"):
        e0 = reg.counter("agg.cache.evicted")
        assert port.count("events", CQL) == len(ref.query("events", CQL))
        assert port.count("other", CQL) == len(ref.query("other", CQL))
        assert reg.counter("agg.cache.evicted") > e0
        assert len(port._agg_cache) == 1
        assert port.count("events", CQL) == len(ref.query("events", CQL))


# -- the failure envelope -------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("schedule", ["agg.build:error=1.0", "agg.build:drop=0.5"])
def test_agg_parity_under_faults(schedule, seed, monkeypatch):
    """An injected ``agg.build`` fault costs the cache, never an answer:
    count, ``aggregate()`` and the density grid equal the fault-free ones
    (and the reference's under the same schedule), and the store recovers
    to the cache afterwards."""
    monkeypatch.setenv("GEOMESA_DENSITY_DEVICE", "1")
    _base_ref, base = _pair(n=1500, seed=seed)
    want_n = base.count("events", CQL)
    want_agg = base.aggregate("events", CQL, columns=["val"])
    want_grid = base.query("events", _density(CQL, 32, 32)).aggregate["density"]
    ref, port = _pair(n=1500, seed=seed)
    reg = robustness_metrics()
    d0 = reg.counter("degrade.agg_to_scan")
    with faults.inject(schedule, seed=seed), ref_faults.inject(schedule, seed=seed):
        for _ in range(2):
            assert port.count("events", CQL) == ref.count("events", CQL) == want_n
        got = port.aggregate("events", CQL, columns=["val"])
        assert got == ref.aggregate("events", CQL, columns=["val"]) == want_agg
        grid = port.query("events", _density(CQL, 32, 32)).aggregate["density"]
        assert np.array_equal(grid, want_grid)
        assert np.array_equal(grid, np.asarray(
            ref.query("events", _density(CQL, 32, 32, query=RefQuery)).aggregate["density"]))
    if schedule.endswith("=1.0"):
        assert reg.counter("degrade.agg_to_scan") > d0
    assert port.count("events", CQL) == want_n
    assert _pyramid_route(port, CQL) == (True, want_n)


def test_agg_build_crash_dies_crisply():
    ref, port = _pair(n=800)
    for ds, fl in ((ref, ref_faults), (port, faults)):
        with fl.inject("agg.build:crash", seed=1):
            with pytest.raises(fl.SimulatedCrash):
                ds.count("events", CQL)
    assert port.count("events", CQL) == ref.count("events", CQL) == len(ref.query("events", CQL))


def test_agg_build_stopped_by_its_deadline():
    """A latency storm on the build costs at most the query budget: the
    count answers exactly or dies with a crisp QueryTimeout, in both."""
    _r, base = _pair(n=800)
    want = base.count("events", CQL)
    ref, port = _pair(n=800, timeout=0.15)
    for ds, fl, timeout in ((ref, ref_faults, RefQueryTimeout), (port, faults, QueryTimeout)):
        with fl.inject(rules=[fl.FaultRule("agg.build", "latency", latency_s=0.4)]):
            t0 = time.perf_counter()
            try:
                got = ds.aggregate("events", CQL, columns=["val"])
                assert got["count"] == want
            except timeout:
                pass
            assert time.perf_counter() - t0 < 5.0
    # an expired budget at the build's check raises, never a wrong answer
    fresh = _pair(n=800)[1]
    with deadline.budget(0.0):
        time.sleep(0.01)
        with pytest.raises(QueryTimeout):
            port_pyr.build_pyramid(fresh._tables["events"]["z2"], fresh.get_schema("events"),
                                   fresh.executor)


def test_eight_threads_count_through_one_pyramid():
    """Eight concurrent first counts agree on one cache object and give
    the same exact answer."""
    ref, port = _pair()
    want = len(ref.query("events", CQL))
    out, caches = [None] * 8, [None] * 8
    barrier = threading.Barrier(8)

    def run(i):
        barrier.wait(30)
        out[i] = port.count("events", CQL)
        caches[i] = port._agg_cache_obj()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert out == [want] * 8
    assert all(c is caches[0] for c in caches)
    assert len(caches[0]) == 1


# -- invalidation of a built pyramid ------------------------------------------


def _bbox_oracle(cols, dead, box=(-50.3, -25.7, 55.9, 35.2)):
    """numpy over the surviving rows: the BBOX count and the val sum."""
    x, y = cols["geom__x"], cols["geom__y"]
    alive = ~np.isin(cols["__fid__"], list(dead))
    m = alive & (x >= box[0]) & (x <= box[2]) & (y >= box[1]) & (y <= box[3])
    return int(m.sum()), int(cols["val"][m].astype(np.int64).sum())


@pytest.mark.parametrize("step", ["delete", "compact"])
def test_built_pyramid_is_invalidated_by_the_lifecycle(step):
    """The port's twin of the reference's invalidation tests: count through
    the pyramid first, then delete (or delete and compact), then count and
    aggregate again. The entry is dropped at once, and the next answers
    equal the reference's and numpy's over the surviving rows."""
    reg = devstats.devstats_metrics()
    ref, port = _pair(seed=7)
    cols = _columns(4000, 7, "e")
    n0 = _bbox_oracle(cols, ())[0]
    for ds in (ref, port):
        assert ds.count("events", BBOX) == n0
        assert ds.count("events", CQL) == ds.count("events", CQL)
    assert _pyramid_route(port, BBOX)[0]
    assert len(port._agg_cache) > 0
    dead = [f"e{i}" for i in range(0, 4000, 7)]
    i0 = reg.counter("agg.cache.invalidated")
    for ds in (ref, port):
        ds.delete_features("events", dead)
        if step == "compact":
            ds.compact("events")
    assert reg.counter("agg.cache.invalidated") > i0
    assert len(port._agg_cache) == 0
    n, val = _bbox_oracle(cols, dead)
    assert n < n0
    assert port.count("events", BBOX) == ref.count("events", BBOX) == n
    assert port.count("events", CQL) == ref.count("events", CQL)
    got = port.aggregate("events", BBOX, columns=["val"])
    assert got == ref.aggregate("events", BBOX, columns=["val"])
    assert got["count"] == n and got["columns"]["val"]["sum"] == val
    assert _pyramid_route(port, BBOX) == (True, n)  # rebuilt on the new generation


def test_delete_schema_drops_pyramid_entries():
    """``delete_schema`` drops the type's pyramid; a recreated type answers
    its own rows, as in the reference."""
    ref, port = _pair(seed=3)
    for ds, parse, point in ((ref, ref_parse_spec, RefPoint), (port, parse_spec, Point)):
        assert ds.count("events", CQL) == ds.count("events", CQL)
        gen = ds._write_gen["events"]
        assert len(ds._agg_cache) > 0
        ds.delete_schema("events")
        assert len(ds._agg_cache) == 0
        assert "events" not in ds.type_names
        ds.create_schema(parse("events", SPEC))
        assert ds._write_gen["events"] == gen + 1  # the generation survives
        with ds.writer("events") as w:
            w.write([1, 0.1, T0, point(0.0, 0.0)], fid="only")
        assert ds.count("events", CQL) == 1
        assert ds.count("events", CQL) == 1
    assert port.type_names == ref.type_names == ["events"]


def test_cache_hit_writes_query_event_and_zero_dispatch_receipt():
    """The reference's audit-writer receipt case: a ``Count()`` stats query
    the pyramid answers writes its ``QueryEvent`` (route
    ``agg-pyramid-stats``) with a zero-dispatch receipt, and the query's
    root span says ``agg.cache`` = hit."""
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"),
                          audit_writer=InMemoryAuditWriter())
    port.create_schema(parse_spec("events", SPEC))
    port._insert_columns(port.get_schema("events"), _columns(4000, 0, "e"))
    ring = trace.install(trace.InMemoryTraceExporter())
    try:
        def run():
            q = Query.cql(CQL)
            q.hints["stats"] = "Count()"
            return port.query("events", q)

        cold = run()
        n0 = len(port.audit_writer.events)
        hot = run()
        assert int(hot.aggregate["stats"].count) == int(cold.aggregate["stats"].count)
        evs = port.audit_writer.events
        assert len(evs) == n0 + 1
        ev = evs[-1]
        assert ev.outcome == "ok" and ev.scan_path == "agg-pyramid-stats"
        assert ev.recompiles == 0 and ev.h2d_bytes == 0 and ev.d2h_bytes == 0
        assert ev.trace_id == ring.traces[-1].trace_id
        root = ring.traces[-1]
        assert root.name == "query" and root.attributes.get("agg.cache") == "hit"
    finally:
        trace.uninstall(ring)
