"""The port's host-seek chooser against the JAX package's, on the CPU.

The same GDELT-style points (``chip_smoke.synthesize``) and OSM-way-shaped
extents (``chip_smoke.synthesize_ways``) go into the reference
``TpuDataStore`` on a one-device CPU mesh, run as on an accelerator (exact
device predicate, batched dispatch, the bitmap protocol), and into the
port's ``TorchDataStore(device="cpu")``. Under ``GEOMESA_SEEK`` = auto, 0 and
1 every query, alone and in a stream, must take the reference's route
(``scan_path``) and return its fid set; the one known departure is a lone
extent query that the chooser leaves to the device (the port's dual route,
the reference's candidate mask). The seek's own paths follow: covered rows skip the post-filter, the
C++ seek scans skip it entirely and equal the plain scan, and null dates
keep the native point scan out.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import chip_smoke as cs
from geomesa_tpu.geom import base as ref_geom
from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor, _HostSeekScan
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore

REF_ENV = {
    "GEOMESA_EXACT_DEVICE": "1",
    "GEOMESA_DEVBATCH": "1",
    "GEOMESA_BATCH_PROTO": "bitmap",
}
N_POINTS = 30_000
N_WAYS = 8_000
SPEC = "dtg:Date,*geom:Point:srid=4326"
TRI = "POLYGON((-80 36, -70 36, -75 41, -80 36))"

# point queries: selective and wide, exact and residual, z3 and z2
POINT_QUERIES = [
    cs.QUERY,
    f"{cs.bbox_cql((-76.0, 38.0, -74.0, 40.0))} AND {cs.DURING}",
    cs.bbox_cql((-76.0, 38.0, -74.0, 40.0)),
    cs.bbox_cql((-170.0, -80.0, 170.0, 80.0)),
    f"{cs.bbox_cql((-180.0, -90.0, 180.0, 90.0))} AND {cs.DURING}",
    f"({cs.bbox_cql(cs.BOX)} OR {cs.bbox_cql(cs.BOX_B)}) AND {cs.DURING}",
    f"{cs.bbox_cql(cs.BOX)} OR {cs.bbox_cql(cs.BOX_B)}",
    f"intersects(geom, {TRI}) AND {cs.DURING}",
]
_STREAMS = cs.xz_streams(reps=3, tris=1, resid=2)
EXTENT_QUERIES = [c for name in sorted(_STREAMS) for c, _spec in _STREAMS[name]] + [
    cs.xz_bbox_cql((-14.0, -14.0, 44.0, 34.0)),  # the whole table: no seek
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


@pytest.fixture(scope="module")
def points():
    x, y, t = cs.synthesize(N_POINTS, seed=5)
    fids = np.char.add("f", np.arange(N_POINTS).astype(str))
    return {"__fid__": fids, "geom__x": x, "geom__y": y, "dtg": t}


@pytest.fixture(scope="module")
def stores(points, _env):
    ref = TpuDataStore(executor=TpuScanExecutor(Mesh(np.asarray(jax.devices()[:1]), ("shards",))))
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    ways = cs.synthesize_ways(N_WAYS, seed=3, bounds=(-15.0, -15.0, 45.0, 35.0), clusters=8)
    for store, parse, classes in ((ref, ref_parse_spec, (ref_geom.LineString, ref_geom.Polygon)),
                                  (port, parse_spec, None)):
        ft = parse("gdelt", SPEC)
        store.create_schema(ft)
        store._insert_columns(ft, dict(points))
        wft = parse("ways", cs.WAYS_SPEC)
        store.create_schema(wft)
        store._insert_columns(wft, cs.ways_columns(ways, classes=classes))
    return ref, port


def _fids(res):
    return set(res.fids.astype(str).tolist())


def _lone_departure(port_res, ref_res):
    """A lone extent query the chooser leaves to the device (alone, or the
    only extent plan of a stream's batch) takes the port's dual route,
    where the reference takes the candidate mask."""
    return (port_res.plan.index.name in ("xz2", "xz3")
            and (port_res.plan.scan_path, ref_res.plan.scan_path)
            == ("device-batch-dual/runs", "device-mask/runs"))


@pytest.mark.parametrize("mode", ["auto", "0", "1"])
@pytest.mark.parametrize("table", ["gdelt", "ways"])
def test_routes_and_results_match_the_reference(stores, monkeypatch, mode, table):
    monkeypatch.setenv("GEOMESA_SEEK", mode)
    ref, port = stores
    cqls = POINT_QUERIES if table == "gdelt" else EXTENT_QUERIES
    paths = []
    for cql in cqls:
        p, r = port.query(table, cql), ref.query(table, RefQuery.cql(cql))
        assert _fids(p) == _fids(r), cql
        if not _lone_departure(p, r):
            assert p.plan.scan_path == r.plan.scan_path, (cql, p.plan.scan_path)
        paths.append(p.plan.scan_path)
    got = port.query_many(table, [Query.cql(c, properties=[]) for c in cqls])
    want = ref.query_many(table, [RefQuery.cql(c, properties=[]) for c in cqls])
    for cql, p, r in zip(cqls, got, want):
        assert _fids(p) == _fids(r), cql
        if not _lone_departure(p, r):  # the only extent plan of its batch
            assert p.plan.scan_path == r.plan.scan_path, (cql, p.plan.scan_path)
        paths.append(p.plan.scan_path)
    seeks = sum(path == "host-seek" for path in paths)
    if mode == "0":
        assert seeks == 0
    elif mode == "1":
        assert seeks == len(paths)
    else:  # auto: selective plans seek, the wide ones go to the device
        assert 0 < seeks < len(paths), paths


def test_config1_seek_matches_brute_force(stores, points, monkeypatch):
    monkeypatch.setenv("GEOMESA_SEEK", "auto")
    _ref, port = stores
    res = port.query("gdelt", cs.QUERY)
    assert res.plan.scan_path == "host-seek"
    x, y, t = points["geom__x"], points["geom__y"], points["dtg"]
    want = np.flatnonzero(cs.in_box(x, y, cs.BOX) & (t > cs.T_LO) & (t < cs.T_HI))
    assert _fids(res) == {f"f{i}" for i in want} and len(want) > 100


def _seek(port, table, cql):
    plan = port._plan_cached(table, Query.cql(cql))
    scan = port.executor.scan_candidates(port._tables[table][plan.index.name], plan)
    assert isinstance(scan, _HostSeekScan)
    return plan, scan


def test_covered_rows_skip_the_post_filter(stores, monkeypatch):
    """Without the C++ scan, rows of contained ranges skip the post-filter:
    it sees exactly the uncovered rows, and the result is unchanged."""
    monkeypatch.setenv("GEOMESA_SEEK", "1")
    monkeypatch.setenv("GEOMESA_TPU_NO_NATIVE", "1")
    _ref, port = stores
    cql = f"{cs.bbox_cql((-85.0, 30.0, -65.0, 45.0))} AND {cs.DURING}"
    plan, scan = _seek(port, "gdelt", cql)
    assert scan.pred is None and not scan.exact
    assert any(r.contained for r in plan.ranges)
    ncov = nuncov = 0
    for _block, _rows, covered in scan:
        ncov += int(covered.sum())
        nuncov += int((~covered).sum())
    assert ncov > 0 and nuncov > 0
    seen = []
    orig = TorchScanExecutor.post_filter

    def spy(self, ft, p, cols):
        seen.append(len(next(iter(cols.values()))))
        return orig(self, ft, p, cols)

    monkeypatch.setattr(TorchScanExecutor, "post_filter", spy)
    plain = _fids(port.query("gdelt", cql))
    assert sum(seen) == nuncov
    monkeypatch.delenv("GEOMESA_TPU_NO_NATIVE")
    assert _fids(port.query("gdelt", cql)) == plain


@pytest.mark.parametrize("table,cql", [
    ("gdelt", cs.QUERY),
    ("gdelt", cs.bbox_cql((-76.0, 38.0, -74.0, 40.0))),
    ("ways", cs.xz_bbox_cql(cs.XZ2_BOX)),
    ("ways", "intersects(geom, POLYGON((0 0, 20 0, 10 15, 0 0)))"),
])
def test_native_seek_scans_are_exact_and_equal_the_plain_scan(stores, monkeypatch, table, cql):
    """With the library, a pure box(+window) point plan and a one-predicate
    xz2 plan run the C++ seek scan (exact: no post-filter); without it the
    covered-split scan answers the same rows."""
    monkeypatch.setenv("GEOMESA_SEEK", "1")
    _ref, port = stores
    _plan, scan = _seek(port, table, cql)
    assert scan.exact and scan.pred[0] == ("xz" if table == "ways" else "z")

    def boom(*a, **k):
        raise AssertionError("the native seek scan is exact: no post-filter")

    with monkeypatch.context() as mp:
        mp.setattr(TorchScanExecutor, "post_filter", boom)
        native = _fids(port.query(table, cql))
    monkeypatch.setenv("GEOMESA_TPU_NO_NATIVE", "1")
    assert _seek(port, table, cql)[1].pred is None
    assert _fids(port.query(table, cql)) == native and native


def test_null_dates_keep_the_native_point_scan_out(monkeypatch):
    """Null dates are stored as 0 + a __null mask: a temporal plan on such a
    table takes the covered-split scan, which rejects them."""
    monkeypatch.setenv("GEOMESA_SEEK", "1")
    rng = np.random.default_rng(8)
    n = 2_000
    x, y = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
    t = rng.integers(-5 * 86400_000, 5 * 86400_000, n).astype(np.int64)
    nulls = rng.random(n) < 0.05
    t[nulls] = 0
    port = TorchDataStore(device="cpu")
    ft = parse_spec("n", SPEC)
    port.create_schema(ft)
    port._insert_columns(ft, {"__fid__": np.char.add("f", np.arange(n).astype(str)),
                              "geom__x": x, "geom__y": y, "dtg": t, "dtg__null": nulls})
    cql = "bbox(geom, -5, -5, 5, 5) AND dtg DURING 1969-12-30T00:00:00Z/1970-01-03T00:00:00Z"
    plan, scan = _seek(port, "n", cql)
    assert scan.pred is None
    lo, hi = -2 * 86400_000, 2 * 86400_000
    m = (x >= -5) & (x <= 5) & (y >= -5) & (y <= 5) & (t > lo) & (t < hi) & ~nulls
    assert _fids(port.query("n", cql)) == {f"f{i}" for i in np.flatnonzero(m)}
