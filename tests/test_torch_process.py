"""The port's process layer against the JAX package, on the CPU.

Twins of the reference's ``tests/test_process.py``
(``test_proximity_search``, ``test_unique_values``),
``tests/test_route_geohash.py``'s two route tests and
``tests/test_parity_extras.py``'s ``test_point2point_and_labels``,
``test_hash_attribute_stability``, ``test_join`` and
``test_legacy_curves_roundtrip``, plus the analytic processes
(``process/analytic.py``). The same seeded numpy columns go into the
reference ``TpuDataStore`` and the port's ``TorchDataStore(device="cpu")``;
every answer is held against the reference's exactly (fid sets, counts,
segments, labels, hashes, grids) and against a brute-force oracle.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from geomesa_tpu.curve.legacy import LegacyZ2SFC as RefZ2, LegacyZ3SFC as RefZ3
from geomesa_tpu.geom.base import LineString as RefLine, Point as RefPoint
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.process import analytic as ref_analytic
from geomesa_tpu.process import proximity_search as ref_proximity
from geomesa_tpu.process import unique_values as ref_unique
from geomesa_tpu.process.route import match_route as ref_match_route
from geomesa_tpu.process.route import route_search as ref_route_search
from geomesa_tpu.process.tracks import hash_attribute as ref_hash
from geomesa_tpu.process.tracks import join as ref_join
from geomesa_tpu.process.tracks import point2point as ref_p2p
from geomesa_tpu.process.tracks import track_labels as ref_labels
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.curve.legacy import LegacyZ2SFC, LegacyZ3SFC
from geomesa_tpu_torch.geom.base import LineString, Point
from geomesa_tpu_torch.process import analytic, proximity_search, unique_values
from geomesa_tpu_torch.process.geodesy import haversine_m
from geomesa_tpu_torch.process.route import match_route, route_search
from geomesa_tpu_torch.process.tracks import hash_attribute, join, point2point, track_labels
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore

SPEC = "actor:String,dtg:Date,*geom:Point:srid=4326"
T0 = int(np.datetime64("2026-04-01T00:00:00", "ms").astype("int64"))
N = 4000


def _ref_store():
    return TpuDataStore(executor=TpuScanExecutor(Mesh(np.asarray(jax.devices()[:1]), ("shards",))))


@pytest.fixture(scope="module", autouse=True)
def _env():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_SEEK", "0")
        yield
    torch.set_num_threads(old)


def _columns():
    rng = np.random.default_rng(23)
    return {
        "__fid__": np.array([f"f{i}" for i in range(N)], dtype=object),
        "geom__x": rng.uniform(-10, 10, N),
        "geom__y": rng.uniform(40, 60, N),
        "dtg": T0 + rng.integers(0, 86400_000, N),
        "actor": np.array([["a", "b", "c", "d"][i % 4] for i in range(N)], dtype=object),
    }


@pytest.fixture(scope="module")
def pair():
    cols = _columns()
    ref = _ref_store()
    ref.create_schema(ref_parse_spec("pts", SPEC))
    ref._insert_columns(ref.get_schema("pts"), {k: v.copy() for k, v in cols.items()})
    port = TorchDataStore(device="cpu")
    port.create_schema(parse_spec("pts", SPEC))
    port._insert_columns(port.get_schema("pts"), {k: v.copy() for k, v in cols.items()})
    return ref, port, cols


def test_proximity_search(pair):
    ref, port, cols = pair
    pts = [(0.0, 50.0), (5.0, 55.0)]
    got = proximity_search(port, "pts", pts, distance_m=100_000.0)
    want = ref_proximity(ref, "pts", pts, distance_m=100_000.0)
    d0 = haversine_m(cols["geom__x"], cols["geom__y"], *pts[0])
    d1 = haversine_m(cols["geom__x"], cols["geom__y"], *pts[1])
    brute = set(cols["__fid__"][(d0 <= 100_000) | (d1 <= 100_000)])
    assert set(got.fids) == set(want.fids) == brute and brute
    # the bbox OR answers on the device through the residual OR route
    assert got.scan_path.startswith("device-")
    # with a filter, and with no point at all
    cql = "actor = 'b'"
    got = proximity_search(port, "pts", pts, 100_000.0, cql=cql)
    assert set(got.fids) == set(ref_proximity(ref, "pts", pts, 100_000.0, cql=cql).fids)
    assert len(proximity_search(port, "pts", [], 1000.0)) == 0


def test_unique_values(pair):
    ref, port, _ = pair
    vals = unique_values(port, "pts", "actor")
    assert vals == ref_unique(ref, "pts", "actor")
    assert {v for v, _ in vals} == {"a", "b", "c", "d"}
    assert sum(c for _, c in vals) == N
    box = "bbox(geom, -10, 40, 0, 50)"
    sub = unique_values(port, "pts", "actor", box, sort_by_count=False)
    assert sub == ref_unique(ref, "pts", "actor", box, sort_by_count=False)
    assert sum(c for _, c in sub) == len(port.query("pts", box))


def test_analytic_processes(pair):
    ref, port, _ = pair
    box = "bbox(geom, -5, 45, 5, 55)"
    assert len(analytic.query_process(port, "pts", box)) == len(
        ref_analytic.query_process(ref, "pts", box))
    for exact in (False, True):
        got = analytic.min_max(port, "pts", "dtg", exact=exact)
        assert tuple(map(int, got)) == tuple(map(int, ref_analytic.min_max(
            ref, "pts", "dtg", exact=exact)))
    got = analytic.min_max(port, "pts", "dtg", box)
    assert tuple(map(int, got)) == tuple(map(int, ref_analytic.min_max(ref, "pts", "dtg", box)))
    spec = "Count();MinMax(dtg)"
    g = analytic.stats_process(port, "pts", spec, box)
    w = ref_analytic.stats_process(ref, "pts", spec, box)
    assert g.to_json() == w.to_json()
    env = (-10.0, 40.0, 10.0, 60.0)
    grid = analytic.density_process(port, "pts", env, 40, 30, box)
    assert np.array_equal(grid, ref_analytic.density_process(ref, "pts", env, 40, 30, box))
    assert grid.sum() == len(port.query("pts", box))
    s = analytic.sampling_process(port, "pts", 400)
    assert sorted(s.fids) == sorted(ref_analytic.sampling_process(ref, "pts", 400).fids)
    assert analytic.bin_conversion(port, "pts", box) == ref_analytic.bin_conversion(
        ref, "pts", box)
    with pytest.raises(NotImplementedError, match="item 19"):
        analytic.arrow_conversion(port, "pts")


def test_match_route_buffer_and_heading():
    coords = [[0.0, 0.0], [1.0, 0.0]]  # due east along the equator
    px = np.array([0.5, 0.5, 0.5, 5.0])
    py = np.array([0.0001, 0.0001, 0.0001, 5.0])
    headings = np.array([90.0, 270.0, 0.0, 90.0])
    for bidir, want in ((False, [True, False, False, False]), (True, [True, True, False, False])):
        m = match_route(px, py, headings, LineString(coords), buffer_m=50.0,
                        heading_threshold=30.0, bidirectional=bidir)
        r = ref_match_route(px, py, headings, RefLine(coords), buffer_m=50.0,
                            heading_threshold=30.0, bidirectional=bidir)
        assert list(m) == list(r) == want


def _route_rows():
    base = np.datetime64("2026-01-01T00:00:00", "ms").astype("int64")
    rows = [([90.0, int(base + i), (0.1 + 0.2 * i, 0.00005)], f"on{i}") for i in range(5)]
    rows += [([0.0, int(base + i), (0.3 + 0.2 * i, 0.00005)], f"x{i}") for i in range(3)]
    rows += [([None, int(base), (0.5, 0.00005)], "nohead"), ([90.0, int(base), (10.0, 10.0)], "far")]
    return rows


def test_route_search_store_level():
    spec = "heading:Double,dtg:Date,*geom:Point:srid=4326"
    ref = _ref_store()
    ref.create_schema(ref_parse_spec("t", spec))
    port = TorchDataStore(device="cpu")
    port.create_schema(parse_spec("t", spec))
    with ref.writer("t") as rw, port.writer("t") as pw:
        for (h, t, (x, y)), fid in _route_rows():
            rw.write([h, t, RefPoint(x, y)], fid=fid)
            pw.write([h, t, Point(x, y)], fid=fid)
    coords = [[0.0, 0.0], [1.0, 0.0]]
    got = route_search(port, "t", [LineString(coords)], buffer_m=100.0, heading_threshold=20.0,
                       heading_attr="heading")
    want = ref_route_search(ref, "t", [RefLine(coords)], buffer_m=100.0,
                            heading_threshold=20.0, heading_attr="heading")
    assert sorted(got) == sorted(want) == [f"on{i}" for i in range(5)]
    # without headings every point in the buffer follows
    got = route_search(port, "t", [LineString(coords)], 100.0, 20.0)
    assert sorted(got) == sorted(ref_route_search(ref, "t", [RefLine(coords)], 100.0, 20.0))


@pytest.fixture()
def tracks():
    T = int(np.datetime64("2026-06-01T00:00:00", "ms").astype("int64"))
    spec = "ship:String,dtg:Date,*geom:Point:srid=4326"
    meta = "ship:String,cls:String,dtg:Date,*geom:Point:srid=4326"
    ref = _ref_store()
    port = TorchDataStore(device="cpu")
    for s, ps, P in ((ref, ref_parse_spec, RefPoint), (port, parse_spec, Point)):
        s.create_schema(ps("trk", spec))
        s.create_schema(ps("ships", meta))
        with s.writer("trk") as w:
            for ship in ("a", "b"):
                # written out of time order: the segments sort by time
                for i in (2, 0, 3, 1):
                    w.write([ship, T + i * 60000 + (86400_000 if i == 3 else 0),
                             P(i, 0 if ship == "a" else 5)], fid=f"{ship}{i}")
        with s.writer("ships") as w:
            w.write(["a", "tanker", T, P(0, 0)], fid="ma")
            w.write(["b", "cargo", T, P(0, 0)], fid="mb")
            w.write(["a", "dup", T, P(0, 0)], fid="mc")
    return ref, port


def test_point2point_and_labels(tracks):
    ref, port = tracks
    for brk in (False, True):
        segs = point2point(port, "trk", "ship", break_on_day=brk)
        assert segs == ref_p2p(ref, "trk", "ship", break_on_day=brk)
        assert len(segs) == (4 if brk else 6)
    a_segs = [s for s in point2point(port, "trk", "ship") if s["track"] == "a"]
    assert a_segs[0]["coords"] == [[0.0, 0.0], [1.0, 0.0]]
    labels = track_labels(port, "trk", "ship")
    assert labels == ref_labels(ref, "trk", "ship")
    assert {lb["track"]: lb["fid"] for lb in labels} == {"a": "a3", "b": "b3"}


def test_hash_attribute_stability():
    vals = np.array(["x", "y", "x", 7, None], dtype=object)
    h = hash_attribute(vals, 10)
    assert np.array_equal(h, ref_hash(vals, 10))
    assert h[0] == h[2] and 0 <= h.min() and h.max() < 10


def test_join(tracks):
    ref, port = tracks
    out = join(port, "trk", "ships", "ship", "ship")
    want = ref_join(ref, "trk", "ships", "ship", "ship")
    assert sorted(out) == sorted(want)
    assert len(out["__fid__"]) == 8
    got = sorted((str(f), c) for f, c in zip(out["__fid__"], out["ships.cls"]))
    assert got == sorted((str(f), c) for f, c in zip(want["__fid__"], want["ships.cls"]))
    assert ("a0", "tanker") in got and ("b3", "cargo") in got  # the first match wins


def test_legacy_curves_roundtrip():
    sfc, ref = LegacyZ2SFC(), RefZ2()
    xs, ys = [-77.0, 2.35, -180.0, 179.99], [38.9, 48.85, -90.0, 89.99]
    z = sfc.index(xs, ys)
    assert np.array_equal(z, ref.index(xs, ys))
    x, y = sfc.invert(z)
    rx, ry = ref.invert(z)
    assert np.array_equal(x, rx) and np.array_equal(y, ry)
    np.testing.assert_allclose(x[:2], [-77.0, 2.35], atol=1e-6)
    np.testing.assert_allclose(y[:2], [38.9, 48.85], atol=1e-6)
    for period in ("day", "week", "month", "year"):
        z3, r3 = LegacyZ3SFC.for_period(period), RefZ3.for_period(period)
        zz = z3.index([10.0, -120.5], [20.0, -45.25], [1000, 86_000_000])
        assert np.array_equal(zz, r3.index([10.0, -120.5], [20.0, -45.25], [1000, 86_000_000]))
        for a, b in zip(z3.invert(zz), r3.invert(zz)):
            assert np.array_equal(a, b)
    xx, yy, tt = LegacyZ3SFC.for_period("week").invert(
        LegacyZ3SFC.for_period("week").index([10.0], [20.0], [1000]))
    assert abs(float(xx[0]) - 10.0) < 1e-3 and abs(float(tt[0]) - 1000) < 1
