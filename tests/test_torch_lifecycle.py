"""The port's write lifecycle against the JAX package, on the CPU.

Deletes (``delete_features``), compaction (``compact``), age-off under
``geomesa.feature.expiry`` and the ``age_off()`` sweep, on a point type
(z3, z2, id and an attribute index; null dates; three write batches, so
three record blocks and three device segments) and on config #3's extent
type (xz2, xz3, id; ``chip_smoke.synthesize_ways`` at a small size). Each
case builds three stores from the same seeded numpy columns: the
reference ``TpuDataStore`` on a one-device CPU mesh, the port's
``TorchDataStore(device="cpu")`` (kernels as their plain editions), both
warmed so that every device column is resident before the lifecycle step,
and a brute-force oracle: the reference's host-only store of the surviving
rows alone. Fid sets, counts, density grids, stats and pyramid aggregates
are equal; kNN lists equal in fids and in f64 distances to 1e-9.

The temporal routes must not return a deleted row: the port's temporal
valid columns (``tvalid``, ``xz_tvalid``) are ``valid & ~nulls`` with the
tombstones cleared, and ``agg_mask``'s cache re-keys on the new ``valid``.
``pyramid_counts_plain`` is held to the reference's ``make_pyramid_counts``
on ``tests/pyramid_layouts.py``'s layouts with holes punched inside their
key-sorted runs, at 2, 8 and 12 bits.
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
from geomesa_tpu.ops.aggregations import make_pyramid_counts
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.process import knn as ref_knn
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.aggregations import pyramid_counts_plain
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.process import knn as port_knn
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.utils.config import properties

from pyramid_layouts import PYRAMID_LAYOUTS, holed_in_runs, pyramid_layout

SPEC = "dtg:Date,kind:String:index=true,cnt:Int,val:Double,*geom:Point:srid=4326"
BASE = int(np.datetime64("2026-01-01T00:00:00", "ms").astype("int64"))
DAY = 86_400_000
# the age-off cut: rows keep their dates two hours clear of it, so the
# seconds a test takes never move a row across it
T_CUT = BASE + 6 * DAY
N_POINTS = 6000
N_WAYS = 3000
WAYS_BOUNDS = (-15.0, -15.0, 45.0, 35.0)
DURING = "dtg DURING 2026-01-03T00:00:00Z/2026-01-15T00:00:00Z"
POLY = "POLYGON((-60 -30, 60 -30, 80 20, 0 45, -80 20, -60 -30))"
CASES = ("delete", "compact", "expiry", "age_off")
# the rows of this box are deleted whole (besides every 7th fid)
DEAD_BOX = (-20.0, -10.0, 0.0, 10.0)

ENV = {
    "GEOMESA_EXACT_DEVICE": "1",
    "GEOMESA_DEVBATCH": "1",
    "GEOMESA_BATCH_PROTO": "bitmap",
    "GEOMESA_SEEK": "0",
    "GEOMESA_COUNT_DEVICE": "1",
    "GEOMESA_KNN_DEVICE": "1",
}


@pytest.fixture(scope="module", autouse=True)
def _env():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.delenv("GEOMESA_FEATURE_EXPIRY", raising=False)
        yield
    torch.set_num_threads(old)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("shards",))


def _point_batches(seed=7):
    """Three write batches of point columns: null dates and kinds, dates
    kept two hours clear of ``T_CUT``."""
    rng = np.random.default_rng(seed)
    out = []
    per = N_POINTS // 3
    for b in range(3):
        n = per
        t = BASE + rng.integers(0, 20 * DAY, n)
        near = np.abs(t - T_CUT) < 2 * 3_600_000
        t[near] += 4 * 3_600_000
        kinds = np.array([f"k{v}" for v in rng.integers(0, 5, n)], dtype=object)
        kinds[rng.random(n) < 0.05] = None
        cols = {
            "__fid__": np.array([f"f{b * per + i}" for i in range(n)], dtype=object),
            "dtg": t.astype(np.int64),
            "dtg__null": rng.random(n) < 0.02,
            "kind": kinds,
            "cnt": rng.integers(0, 50, n).astype(np.int32),
            "val": rng.uniform(0.0, 1.0, n),
            "geom__x": rng.uniform(-100, 80, n),
            "geom__y": rng.uniform(-60, 60, n),
        }
        out.append(cols)
    return out


def _survivors(case, cols):
    """Keep-mask of one point batch after the case's lifecycle step."""
    t, nulls = cols["dtg"], cols["dtg__null"]
    if case in ("expiry", "age_off"):
        return (t >= T_CUT) | nulls
    ids = np.array([int(f[1:]) for f in cols["__fid__"]])
    x, y = cols["geom__x"], cols["geom__y"]
    in_box = ((x >= DEAD_BOX[0]) & (x <= DEAD_BOX[2]) & (y >= DEAD_BOX[1])
              & (y <= DEAD_BOX[3]))
    return ~((ids % 7 == 0) | in_box)


def _ways():
    w = cs.synthesize_ways(N_WAYS, seed=5, bounds=WAYS_BOUNDS, clusters=4)
    null_dates = np.random.default_rng(6).random(N_WAYS) < 0.01
    return w, null_dates


def _ways_survivors(case):
    """The ways age nothing off (the sweep runs on the point type; under
    the retention window every store, the oracle too, masks at scan)."""
    if case in ("expiry", "age_off"):
        return np.ones(N_WAYS, dtype=bool)
    return np.arange(N_WAYS) % 9 != 0


_WORLDS = {}


def _apply(case, ds, doomed, ways_doomed):
    """The case's lifecycle step on one store."""
    if case in ("delete", "compact"):
        ds.delete_features("t", doomed)
        ds.delete_features("ways", ways_doomed)
        if case == "compact":
            ds.compact("t")
            ds.compact("ways")
    elif case == "age_off":
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GEOMESA_FEATURE_EXPIRY", f"{int(time.time() * 1000) - T_CUT} ms")
            assert ds.age_off("t") == len(doomed)


def _warm(ds, query):
    """Every device column of both types resident before the step: the
    exact and raw columns, the temporal-valid columns, the pyramid mask."""
    box = "bbox(geom, -60, -40, 40, 30)"
    ds.query_many("t", [query.cql(f"{box} AND {DURING}"), query.cql(box)])
    ds.query("t", query.cql(f"{box} AND {DURING}"))
    ds.count("t", f"{box} AND {DURING}")
    ds.query("t", query.cql(f"INTERSECTS(geom, {POLY})"))
    items = cs.xz_streams(reps=2, tris=1, resid=1)
    ds.query_many("ways", [query.cql(c) for c, _ in items["xz3_bbox_during"]])
    ds.query_many("ways", [query.cql(c) for c, _ in items["xz2_bbox"]])


def world(case):
    """(ref, port, oracle, survivors by fid, ways survivors) of one case,
    built once a module."""
    if case in _WORLDS:
        return _WORLDS[case]
    batches = _point_batches()
    w, null_dates = _ways()
    ref = TpuDataStore(executor=TpuScanExecutor(_mesh()))
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    oracle = TpuDataStore()
    keep = [_survivors(case, b) for b in batches]
    wkeep = _ways_survivors(case)
    for ds, parse, classes in ((ref, ref_parse_spec, (ref_geom.LineString, ref_geom.Polygon)),
                               (port, parse_spec, None),
                               (oracle, ref_parse_spec, (ref_geom.LineString, ref_geom.Polygon))):
        ds.create_schema(parse("t", SPEC))
        ds.create_schema(parse("ways", cs.WAYS_SPEC))
        for b, k in zip(batches, keep):
            cols = {c: v.copy() for c, v in b.items()}
            if ds is oracle:
                cols = {c: v[k] for c, v in cols.items()}
            ds._insert_columns(ds.get_schema("t"), cols)
        wcols = dict(cs.ways_columns(w, classes=classes), dtg__null=null_dates)
        if ds is oracle:
            wcols = {c: v[wkeep] for c, v in wcols.items()}
        ds._insert_columns(ds.get_schema("ways"), wcols)
    doomed = [f for b, k in zip(batches, keep) for f in b["__fid__"][~k]]
    ways_doomed = [f"w{i}" for i in np.flatnonzero(~wkeep)]
    with properties(geomesa_agg_enabled="false"):
        _warm(port, Query)
        _warm(ref, RefQuery)
    for ds in (ref, port):
        _apply(case, ds, doomed, ways_doomed)
    _WORLDS[case] = (ref, port, oracle, set(doomed), set(ways_doomed))
    return _WORLDS[case]


@pytest.fixture
def expiry(monkeypatch):
    """Sets the age-off window of the cases that need it: ``geomesa.
    feature.expiry`` so that ``T_CUT`` is the cut now (about 30% of the
    points expire)."""

    def on(case):
        if case == "expiry":
            monkeypatch.setenv("GEOMESA_FEATURE_EXPIRY", f"{int(time.time() * 1000) - T_CUT} ms")

    return on


def _fids(res):
    return set(map(str, res.fids.tolist()))


def _boxes(rng, k):
    out = []
    for _ in range(k):
        x0, y0 = rng.uniform(-90, 20), rng.uniform(-50, 20)
        out.append((float(x0), float(y0), float(x0 + rng.uniform(20, 60)),
                    float(y0 + rng.uniform(10, 35))))
    return out


def _point_cqls(seed=3):
    rng = np.random.default_rng(seed)
    bx = [f"bbox(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})" for b in _boxes(rng, 6)]
    return {
        "z3": [f"{b} AND {DURING}" for b in bx[:4]],
        "z2": bx[4:],
        "residual": [f"({bx[0]} OR {bx[1]}) AND {DURING}", f"{bx[2]} OR {bx[3]}"],
        "attr": [f"kind = 'k2' AND {bx[0]}", f"cnt BETWEEN 10 AND 30 AND {bx[1]}",
                 f"kind IN ('k0', 'k3') AND {bx[2]} AND {DURING}"],
        "polygon": [f"INTERSECTS(geom, {POLY})", f"INTERSECTS(geom, {POLY}) AND {DURING}"],
        "dead_box": [f"bbox(geom, {DEAD_BOX[0]}, {DEAD_BOX[1]}, {DEAD_BOX[2]}, "
                     f"{DEAD_BOX[3]}) AND {DURING}"],
    }


POINT_CQLS = _point_cqls()


@pytest.mark.parametrize("seek", ["0", "1"])
@pytest.mark.parametrize("route", sorted(POINT_CQLS))
@pytest.mark.parametrize("case", CASES)
def test_point_routes_after_lifecycle(case, route, seek, expiry, monkeypatch):
    """Every point route (the exact z3 and z2 batches, the candidate route
    of a residual, the attribute plane, the polygon plane, and the host
    seek under GEOMESA_SEEK=1), through ``query_many`` and ``query``: the
    port's fids equal the reference's and the survivors' oracle, and no
    deleted or expired fid comes back. Under the seek the port is held to
    the oracle (the reference's host-only store), not to the reference's
    host seek, which returns null-date rows of contained z3 ranges."""
    ref, port, oracle, doomed, _wd = world(case)
    expiry(case)
    monkeypatch.setenv("GEOMESA_SEEK", seek)
    cqls = POINT_CQLS[route]
    got = port.query_many("t", [Query.cql(c) for c in cqls])
    want = ref.query_many("t", [RefQuery.cql(c) for c in cqls])
    for cql, g, r in zip(cqls, got, want):
        truth = _fids(oracle.query("t", cql))
        assert _fids(g) == truth, (case, cql)
        if seek == "0":
            # the reference's host seek lets a null-date row of a contained
            # z3 range through a DURING (the port clears such rows' covered
            # flag): under the seek the oracle alone is the reference
            assert _fids(r) == truth, (case, cql)
        assert not _fids(g) & doomed
        if seek == "0" and route in ("z3", "z2"):
            assert g.scan_path.startswith("device"), (cql, g.scan_path)
        alone = port.query("t", Query.cql(cql))
        assert _fids(alone) == truth


@pytest.mark.parametrize("case", CASES)
def test_counts_after_lifecycle(case, expiry):
    """``count`` with and without a filter: the device count answers after
    deletes, a compaction and the age_off sweep; under a retention window
    the count goes through the query, as in the reference."""
    ref, port, oracle, _d, _wd = world(case)
    expiry(case)
    with properties(geomesa_agg_enabled="false"):
        for cql in POINT_CQLS["z3"] + POINT_CQLS["z2"] + POINT_CQLS["attr"][:2]:
            truth = len(oracle.query("t", cql))
            assert port.count("t", cql) == ref.count("t", cql) == truth, (case, cql)
            if case == "expiry":
                # a retention window: the count takes the query path
                assert not port._shortcuts_ok("t", port.get_schema("t"))
            elif " AND kind" not in cql and not cql.startswith("kind"):
                assert port._count_device("t", Query.cql(cql)) == truth, (case, cql)
        assert port.count("t") == ref.count("t") == oracle.count("t")
        assert port.count("ways") == ref.count("ways") == oracle.count("ways")


@pytest.mark.parametrize("case", CASES)
def test_density_after_lifecycle(case, expiry):
    """The density grid equals the reference host reducer's and the
    oracle's; the push-down answers after deletes and compaction and
    declines under a retention window (it would count expired rows)."""
    ref, port, oracle, _d, _wd = world(case)
    expiry(case)
    hint = {"density": {"envelope": (-100.0, -60.0, 80.0, 60.0), "width": 48, "height": 32}}
    with properties(geomesa_agg_enabled="false"):
        for cql in (POINT_CQLS["z3"][0], POINT_CQLS["z2"][0]):
            got = port.query("t", Query.cql(cql, hints=dict(hint)))
            want = ref.query("t", RefQuery.cql(cql, hints=dict(hint)))
            truth = oracle.query("t", RefQuery.cql(cql, hints=dict(hint)))
            assert np.array_equal(got.aggregate["density"], np.asarray(want.aggregate["density"]))
            assert np.array_equal(got.aggregate["density"], np.asarray(truth.aggregate["density"]))
            assert (got.scan_path == "device-density") == (case != "expiry"), got.scan_path


@pytest.mark.parametrize("case", CASES)
def test_stats_after_lifecycle(case, expiry, monkeypatch):
    """The stats query: the port's push-down (declined under a retention
    window) against the reference's host reducer and the oracle's."""
    ref, port, oracle, _d, _wd = world(case)
    expiry(case)
    spec = "Count();MinMax(cnt);TopK(kind)"
    cql = POINT_CQLS["z3"][1]
    monkeypatch.setenv("GEOMESA_STATS_DEVICE", "1")
    got = port.query("t", Query.cql(cql, hints={"stats": spec}))
    monkeypatch.setenv("GEOMESA_STATS_DEVICE", "0")
    want = ref.query("t", RefQuery.cql(cql, hints={"stats": spec}))
    truth = oracle.query("t", RefQuery.cql(cql, hints={"stats": spec}))
    assert got.aggregate["stats"].to_json() == want.aggregate["stats"].to_json()
    assert got.aggregate["stats"].to_json() == truth.aggregate["stats"].to_json()
    assert (got.scan_path == "device-stats") == (case != "expiry"), got.scan_path


@pytest.mark.parametrize("case", CASES)
def test_pyramid_after_lifecycle(case, expiry):
    """The pyramid's count and ``aggregate()`` after the step: the build
    re-keys on the schema generation (the reference's
    ``test_delete_features_invalidates_pyramid`` / ``test_compact_
    invalidates_pyramid``); a retention window declines it."""
    ref, port, oracle, _d, _wd = world(case)
    expiry(case)
    cql = f"INTERSECTS(geom, {POLY})"
    truth = len(oracle.query("t", cql))
    assert port.count("t", cql) == ref.count("t", cql) == truth
    q = Query.cql(cql)
    plan = port._plan_cached("t", q)
    got = port._count_pyramid("t", port.get_schema("t"), q, plan)
    assert (got is None) == (case == "expiry")
    assert got is None or got == truth
    agg = port.aggregate("t", cql, columns=["cnt", "val"])
    want = ref.aggregate("t", cql, columns=["cnt", "val"])
    assert agg["count"] == want["count"] == truth
    assert agg["columns"]["cnt"] == want["columns"]["cnt"]
    for k in ("count", "min", "max"):
        assert agg["columns"]["val"][k] == want["columns"]["val"][k]
    assert agg["columns"]["val"]["sum"] == pytest.approx(want["columns"]["val"]["sum"], rel=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_knn_after_lifecycle(case, expiry):
    """kNN: the device top-k never ranks a deleted row; under a retention
    window both packages take the host path. Fids equal, f64 distances to
    1e-9."""
    ref, port, oracle, doomed, _wd = world(case)
    expiry(case)
    for point, k in (((-10.0, 0.0), 10), ((30.0, 20.0), 25)):
        got = port_knn.knn_search(port, "t", *point, k=k)
        path = port_knn.last_knn_path()
        want = ref_knn.knn_search(ref, "t", *point, k=k)
        truth = ref_knn.knn_search(oracle, "t", *point, k=k)
        assert [f for f, _ in got] == [f for f, _ in want] == [f for f, _ in truth]
        np.testing.assert_allclose([d for _, d in got], [d for _, d in truth], rtol=1e-9)
        assert not {f for f, _ in got} & doomed
        assert path == ("host-bbox" if case == "expiry" else "device-topk")


STREAMS = cs.xz_streams(reps=3, tris=1, resid=2)


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("case", ["delete", "compact", "age_off"])
def test_extent_streams_after_lifecycle(case, stream):
    """Config #3's streams (a)-(e) on the extent type after deletes and a
    compaction (xz2 dual, xz3 dual with ``xz_tvalid``, the triangle ring,
    the residual candidate routes): port, reference and oracle agree."""
    ref, port, oracle, _d, wdoomed = world(case)
    items = STREAMS[stream]
    got = port.query_many("ways", [Query.cql(c) for c, _ in items])
    want = ref.query_many("ways", [RefQuery.cql(c) for c, _ in items])
    for (cql, _spec), g, r in zip(items, got, want):
        truth = _fids(oracle.query("ways", cql))
        assert _fids(g) == _fids(r) == truth, (case, cql)
        assert not _fids(g) & wdoomed
    count_cql = items[0][0]
    assert port.count("ways", count_cql) == ref.count("ways", count_cql) == \
        len(oracle.query("ways", count_cql))


def test_temporal_valid_columns_clear_deleted_rows():
    """The tvalid hazard: after a delete, the resident segments' ``valid``,
    ``tvalid`` and ``xz_tvalid`` clear the deleted rows (null-date rows stay
    cleared in the temporal ones), and ``agg_mask`` re-keys on the new
    ``valid``."""
    _ref, port, _o, doomed, wdoomed = world("delete")
    with properties(geomesa_agg_enabled="false"):
        port.query("t", Query.cql(f"bbox(geom, -60, -40, 40, 30) AND {DURING}"))
    for name, cols, gone in (("t", ("valid", "tvalid"), doomed),
                             ("ways", ("valid", "xz_tvalid"), wdoomed)):
        index = "z3" if name == "t" else "xz3"
        table = port._tables[name][index]
        dev = port.executor.device_index(table)
        for seg in dev.segments:
            fids = np.concatenate([b.full_col("__fid__") for b in seg.blocks]).astype(str)
            dead = np.isin(fids, list(gone))
            assert dead.any()
            nulls = np.concatenate([b.full_col("dtg__null") for b in seg.blocks])
            valid = seg.valid.numpy()[:seg.n]
            assert np.array_equal(valid, ~dead)
            tv = getattr(seg, cols[1])
            assert tv is not None
            assert np.array_equal(tv.numpy()[:seg.n], ~dead & ~nulls)
            assert not seg.valid.numpy()[seg.n:].any()
    table = port._tables["t"]["z2"]
    seg = port.executor.device_index(table).segments[0]
    before = seg.agg_mask(table)
    assert seg.agg_mask(table) is before
    fids = np.concatenate([b.full_col("__fid__") for b in seg.blocks])
    victim, live = str(fids[~seg._valid_host][0]), str(fids[seg._valid_host][0])
    port.delete_features("t", [victim, live])
    port.query("t", Query.cql("bbox(geom, -180, -90, 180, 90)"))
    seg = port.executor.device_index(table).segments[0]
    after = seg.agg_mask(table)
    assert after is not before
    assert int(before.sum()) - int(after.sum()) == 1
    _WORLDS.pop("delete", None)  # the next user rebuilds a clean world


def test_compaction_rebuilds_the_mirror_without_tombstones():
    _ref, port, oracle, _d, _wd = world("compact")
    for name in ("t", "ways"):
        for table in port._tables[name].values():
            assert not table.tombstones and len(table.blocks) == 1
    assert port._tables["t"]["z3"].num_rows == oracle._tables["t"]["z3"].num_rows


def test_age_off_sweep_counts_and_returns_expired():
    """``age_off()`` tombstones exactly the expired rows (the same number
    as the reference's), and a type without a retention window ages
    nothing off."""
    batches = _point_batches(seed=11)
    ref = TpuDataStore(executor=TpuScanExecutor(_mesh()))
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    for ds, parse in ((ref, ref_parse_spec), (port, parse_spec)):
        ds.create_schema(parse("t", SPEC))
        for b in batches:
            ds._insert_columns(ds.get_schema("t"), {c: v.copy() for c, v in b.items()})
    assert port.age_off("t") == ref.age_off("t") == 0
    expired = sum(int((~_survivors("age_off", b)).sum()) for b in batches)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_FEATURE_EXPIRY", f"{int(time.time() * 1000) - T_CUT} ms")
        assert port.age_off("t") == ref.age_off("t") == expired
    assert 0.2 < expired / N_POINTS < 0.4
    assert port.count("t") == ref.count("t") == N_POINTS - expired


@pytest.mark.parametrize("bits", [2, 8, 12])
@pytest.mark.parametrize("layout", sorted(PYRAMID_LAYOUTS))
def test_pyramid_counts_plain_with_holes_inside_runs(layout, bits):
    """``pyramid_counts_plain`` (through the wrapper, with the layout's
    block bounds) against the reference's ``make_pyramid_counts`` and a
    bincount, the mask holed inside the runs (the deletes' mask)."""
    n = min(PYRAMID_LAYOUTS[layout], 60_000)
    xi, yi, mask, starts = pyramid_layout(layout, n=n)
    mask = holed_in_runs(xi, yi, mask)
    want = np.asarray(make_pyramid_counts(_mesh(), bits)(xi, yi, mask))
    got = kernels.pyramid_counts(torch.from_numpy(xi), torch.from_numpy(yi),
                                 torch.from_numpy(mask), bits, starts=starts)
    assert np.array_equal(got.numpy(), want)
    shift = 31 - bits
    flat = ((yi[mask] >> shift).astype(np.int64) << bits) | (xi[mask] >> shift)
    assert np.array_equal(got.numpy().ravel(), np.bincount(flat, minlength=4**bits))
    plain = pyramid_counts_plain(torch.from_numpy(xi), torch.from_numpy(yi),
                                 torch.from_numpy(mask), bits)
    assert np.array_equal(plain.numpy(), want)


@pytest.mark.parametrize("index", ["z3", "z2", "id", "attr:kind"])
def test_tombstone_keep_masks_equal_probing_each_row(index):
    """The host tombstone filter (``IndexTable.tombstone_keep``) equals
    ``np.isin`` of the rows' own fids before and after its keep mask of
    each record block is made (once the rows probed add up to the
    record's size), after a second delete forgets the masks, after the
    device mirror's sync makes them, and after ``compact``."""
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    port.create_schema(parse_spec("t", SPEC))
    batches = _point_batches()
    for b in batches:
        port._insert_columns(port.get_schema("t"), {c: v.copy() for c, v in b.items()})
    fids = np.concatenate([b["__fid__"] for b in batches]).astype(str)
    rng = np.random.default_rng(11)

    def check(table, probes):
        tomb = np.asarray(sorted(table.tombstones))
        for blk in table.blocks:
            for _ in range(probes):
                rows = np.unique(rng.integers(0, blk.n, blk.n // 3))
                want = ~np.isin(blk.gather("__fid__", rows), tomb)
                got = table.tombstone_keep(blk, rows)
                assert np.array_equal(np.ones(len(rows), bool) if got is None else got, want)

    port.delete_features("t", fids[::7].tolist())
    table = port._tables["t"][index]
    assert not table._keep_masks
    check(table, 6)
    assert {id(blk.record) for blk in table.blocks} == set(table._keep_masks)
    port.delete_features("t", fids[1::5].tolist())
    assert not table._keep_masks
    check(table, 1)
    if index in ("z3", "z2"):
        port.executor.device_index(table)
        assert {id(blk.record) for blk in table.blocks} == set(table._keep_masks)
        check(table, 2)
    port.compact("t")
    table = port._tables["t"][index]
    assert not table.tombstones and not table._keep_masks
    assert table.tombstone_keep(table.blocks[0], np.arange(table.blocks[0].n)) is None
    dead = set(fids[::7]) | set(fids[1::5])
    assert port._tables["t"]["id"].num_rows == len(fids) - len(dead)
