"""The port's visibility labels against the JAX package, on the CPU.

The expression layer (``security/visibility.py``, a whole copy): the
parser, the evaluator and the row mask against the reference's on the
same expressions and columns. The store: a point type with a ``__vis__``
column of eight label expressions (``write_columns``, as the reference's
bulk ingest takes it, plus rows of ``writer.write(..., visibility=)``) and
config #3's extent type with labels, in the reference ``TpuDataStore`` on
a one-device CPU mesh and the port's ``TorchDataStore(device="cpu")``,
under three authorization sets. Every route (z3, z2, the candidate route,
the attribute plane, the polygon plane, the host seek, xz2, xz3) returns
the reference's fids, which equal a numpy oracle of predicate AND label;
``count``, the stats query, density, kNN and the pyramid's ``aggregate``
equal the reference's, and the port takes the reference's declines: no
device count, stats or density push-down, no pyramid, no device kNN.
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
from geomesa_tpu.process import knn as ref_knn
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.security import DefaultAuthorizationsProvider as RefProvider
from geomesa_tpu.security import VisibilityEvaluator as RefEvaluator
from geomesa_tpu.security import visibility_mask as ref_visibility_mask
from geomesa_tpu.security.visibility import VisibilityError as RefVisibilityError
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.geom import base as port_geom
from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.process import knn as port_knn
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.security import (
    DefaultAuthorizationsProvider,
    VisibilityError,
    VisibilityEvaluator,
    visibility_mask,
)
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.utils.config import properties

SPEC = "dtg:Date,kind:String,cnt:Int,*geom:Point:srid=4326"
BASE = int(np.datetime64("2026-01-01T00:00:00", "ms").astype("int64"))
DAY = 86_400_000
DURING = "dtg DURING 2026-01-03T00:00:00Z/2026-01-15T00:00:00Z"
LABELS = np.array([None, "", "USA", "USA&SECRET", "USA|GBR", "(USA|GBR)&SECRET", "GBR",
                   '"NO FORN"|ADMIN'], dtype=object)
AUTHS = {"none": [], "usa": ["USA"], "cleared": ["USA", "GBR", "SECRET"]}
POLY = "POLYGON((-60 -30, 60 -30, 80 20, 0 45, -80 20, -60 -30))"
N = 6000
N_WAYS = 2000
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
        yield
    torch.set_num_threads(old)


# -- the expression layer ------------------------------------------------------

EXPRESSIONS = ["", "a", "a&b", "a|b", "a&(b|c)", "(a|b)&(c|d)", '"weird label"|x',
               "a&b&c", "x|y|z", "A_1:2/3.4-5", '"q\\"uote"&a']
BAD = ["a&b|c", "(a&b", "a)", "&a", "a&", '"open', "a b", "()"]


@pytest.mark.parametrize("auths", [[], ["a"], ["a", "b"], ["a", "c"], ["b", "c", "d"],
                                   ["weird label"], ["A_1:2/3.4-5", 'q"uote', "a"]])
def test_evaluator_matches_reference(auths):
    for expr in EXPRESSIONS:
        assert VisibilityEvaluator.evaluate(expr, auths) == RefEvaluator.evaluate(expr, auths), expr


@pytest.mark.parametrize("expr", BAD)
def test_malformed_expressions_raise_as_in_reference(expr):
    with pytest.raises(RefVisibilityError):
        RefEvaluator.parse(expr)
    with pytest.raises(VisibilityError):
        VisibilityEvaluator.parse(expr)


@pytest.mark.parametrize("auths", sorted(AUTHS))
def test_visibility_mask_matches_reference(auths):
    col = np.random.default_rng(1).choice(LABELS, 5000)
    got = visibility_mask(col, AUTHS[auths])
    assert got.dtype == bool
    np.testing.assert_array_equal(got, ref_visibility_mask(col, AUTHS[auths]))
    np.testing.assert_array_equal(visibility_mask(np.array(["a", "a&b", None, "", "b"],
                                                        dtype=object), ["a"]),
                                  [True, False, True, True, False])


# -- the store ------------------------------------------------------------------


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("shards",))


def _columns(seed=2):
    rng = np.random.default_rng(seed)
    return {
        "__fid__": np.array([f"f{i}" for i in range(N)], dtype=object),
        "dtg": (BASE + rng.integers(0, 20 * DAY, N)).astype(np.int64),
        "kind": np.array([f"k{v}" for v in rng.integers(0, 5, N)], dtype=object),
        "cnt": rng.integers(0, 50, N).astype(np.int32),
        "geom__x": rng.uniform(-100, 80, N),
        "geom__y": rng.uniform(-60, 60, N),
        "__vis__": rng.choice(LABELS, N),
    }


# rows written one by one through the writer's visibility= (fid, label,
# values): a second block, labelled and not
ROWS = [(f"r{i}", LABELS[i % len(LABELS)], (BASE + i * 3_600_000, f"k{i % 5}", i,
                                           -50.0 + i * 0.9, -20.0 + i * 0.4))
        for i in range(120)]


_STORES = {}


def stores(auths: str):
    """(ref, port, numpy columns of every row) under one authorization set;
    the reference reads its labels through a provider, the port a list."""
    if auths in _STORES:
        return _STORES[auths]
    cols = _columns()
    ways = cs.synthesize_ways(N_WAYS, seed=8, bounds=(-15.0, -15.0, 45.0, 35.0), clusters=4)
    wvis = np.random.default_rng(9).choice(LABELS, N_WAYS)
    ref = TpuDataStore(executor=TpuScanExecutor(_mesh()), auths=RefProvider(AUTHS[auths]))
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"), auths=AUTHS[auths])
    for ds, parse, geom, classes in (
            (ref, ref_parse_spec, ref_geom, (ref_geom.LineString, ref_geom.Polygon)),
            (port, parse_spec, port_geom, None)):
        ds.create_schema(parse("t", SPEC))
        with ds.writer("t") as w:
            w.write_columns({k: v.copy() for k, v in cols.items()})
            for fid, label, (t, kind, cnt, x, y) in ROWS:
                w.write([int(t), kind, cnt, geom.Point(x, y)], fid=fid, visibility=label)
        ds.create_schema(parse("ways", cs.WAYS_SPEC))
        with ds.writer("ways") as w:
            w.write_columns(dict(cs.ways_columns(ways, classes=classes), __vis__=wvis))
    allc = {
        "fid": np.concatenate([cols["__fid__"], [r[0] for r in ROWS]]).astype(str),
        "vis": np.concatenate([cols["__vis__"], np.array([r[1] for r in ROWS], dtype=object)]),
        "x": np.concatenate([cols["geom__x"], [r[2][3] for r in ROWS]]),
        "y": np.concatenate([cols["geom__y"], [r[2][4] for r in ROWS]]),
        "t": np.concatenate([cols["dtg"], [r[2][0] for r in ROWS]]),
        "kind": np.concatenate([cols["kind"], [r[2][1] for r in ROWS]]).astype(str),
    }
    _STORES[auths] = (ref, port, allc, ways, wvis)
    return _STORES[auths]


def _readable(vis, auths):
    return np.array([v in (None, "") or RefEvaluator.evaluate(v, auths) for v in vis])


def _fids(res):
    return set(map(str, res.fids.tolist()))


def _boxes(seed=4, k=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        x0, y0 = rng.uniform(-90, 20), rng.uniform(-50, 20)
        out.append((float(x0), float(y0), float(x0 + rng.uniform(20, 60)),
                    float(y0 + rng.uniform(10, 35))))
    return out


BOXES = _boxes()
T_LO = int(np.datetime64("2026-01-03T00:00:00", "ms").astype("int64"))
T_HI = int(np.datetime64("2026-01-15T00:00:00", "ms").astype("int64"))


def _bbox(b):
    return f"bbox(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"


def _in_box(c, b):
    return (c["x"] >= b[0]) & (c["x"] <= b[2]) & (c["y"] >= b[1]) & (c["y"] <= b[3])


def _point_items():
    """(route, cql, numpy predicate over the rows)."""
    during = lambda c: (c["t"] > T_LO) & (c["t"] < T_HI)  # noqa: E731
    items = []
    for b in BOXES[:3]:
        items.append(("z3", f"{_bbox(b)} AND {DURING}",
                      lambda c, b=b: _in_box(c, b) & during(c)))
    for b in BOXES[3:]:
        items.append(("z2", _bbox(b), lambda c, b=b: _in_box(c, b)))
    b0, b1 = BOXES[0], BOXES[1]
    items.append(("residual", f"({_bbox(b0)} OR {_bbox(b1)}) AND {DURING}",
                  lambda c: (_in_box(c, b0) | _in_box(c, b1)) & during(c)))
    items.append(("attr", f"kind = 'k2' AND {_bbox(b1)}",
                  lambda c: (c["kind"] == "k2") & _in_box(c, b1)))
    return items


POINT_ITEMS = _point_items()


@pytest.mark.parametrize("seek", ["0", "1"])
@pytest.mark.parametrize("auths", sorted(AUTHS))
def test_point_routes_under_labels(auths, seek, monkeypatch):
    """query_many and query on every point route: the port's fids equal the
    reference's and the oracle of predicate AND label."""
    monkeypatch.setenv("GEOMESA_SEEK", seek)
    ref, port, c, _w, _wv = stores(auths)
    ok = _readable(c["vis"], AUTHS[auths])
    cqls = [cql for _r, cql, _p in POINT_ITEMS]
    got = port.query_many("t", [Query.cql(q) for q in cqls])
    want = ref.query_many("t", [RefQuery.cql(q) for q in cqls])
    for (route, cql, pred), g, r in zip(POINT_ITEMS, got, want):
        truth = set(c["fid"][pred(c) & ok])
        assert _fids(g) == _fids(r) == truth, (route, cql)
        assert _fids(port.query("t", cql)) == truth
        if seek == "0" and route in ("z3", "z2"):
            assert g.scan_path.startswith("device"), g.scan_path
    # the polygon plane: the reference's answer (its host test is the oracle)
    cql = f"INTERSECTS(geom, {POLY})"
    assert _fids(port.query("t", cql)) == _fids(ref.query("t", cql))
    assert len(_fids(port.query("t", "INCLUDE"))) == int(ok.sum())


@pytest.mark.parametrize("auths", sorted(AUTHS))
def test_extent_streams_under_labels(auths):
    ref, port, _c, ways, wvis = stores(auths)
    ok = _readable(wvis, AUTHS[auths])
    items = cs.xz_streams(reps=3, tris=1, resid=1)
    for stream in ("xz2_bbox", "xz3_bbox_during", "xz2_triangle"):
        got = port.query_many("ways", [Query.cql(q) for q, _s in items[stream]])
        want = ref.query_many("ways", [RefQuery.cql(q) for q, _s in items[stream]])
        for (cql, spec), g, r in zip(items[stream], got, want):
            rows = cs.oracle_rows(ways, *spec)
            truth = {f"w{i}" for i in rows if ok[i]}
            assert _fids(g) == _fids(r) == truth, (stream, cql)


@pytest.mark.parametrize("auths", sorted(AUTHS))
def test_counts_decline_to_the_query(auths):
    """A labelled type counts through the auth-checked query: no pyramid,
    no device count (the executor declines), no sketch estimate; the counts
    equal the reference's and the oracle's."""
    ref, port, c, _w, _wv = stores(auths)
    ok = _readable(c["vis"], AUTHS[auths])
    assert not port._agg_eligible("t")
    for route, cql, pred in POINT_ITEMS:
        truth = int((pred(c) & ok).sum())
        assert port.count("t", cql) == ref.count("t", cql) == truth, cql
        assert port.count("t", cql, exact=False) == ref.count("t", cql, exact=False) == truth
        q = Query.cql(cql)
        plan = port._plan_cached("t", q)
        table = port._tables["t"][plan.index.name]
        assert port.executor.count_scan(table, plan) is None
    assert port.count("t") == ref.count("t") == int(ok.sum())
    assert port.count("ways") == ref.count("ways")


@pytest.mark.parametrize("auths", sorted(AUTHS))
def test_stats_and_density_decline_under_labels(auths):
    ref, port, c, _w, _wv = stores(auths)
    ok = _readable(c["vis"], AUTHS[auths])
    _route, cql, pred = POINT_ITEMS[0]
    spec = "Count();MinMax(cnt);TopK(kind)"
    got = port.query("t", Query.cql(cql, hints={"stats": spec}))
    want = ref.query("t", RefQuery.cql(cql, hints={"stats": spec}))
    assert got.scan_path != "device-stats"
    assert got.aggregate["stats"].to_json() == want.aggregate["stats"].to_json()
    env = (-100.0, -60.0, 80.0, 60.0)
    hint = {"density": {"envelope": env, "width": 40, "height": 30}}
    with properties(geomesa_agg_enabled="true"):
        for _ in range(2):  # the second would hit the density memo on an unlabelled type
            g = port.query("t", Query.cql(cql, hints=dict(hint)))
            assert g.scan_path not in ("device-density", "agg-cache-density"), g.scan_path
    w = ref.query("t", RefQuery.cql(cql, hints=dict(hint)))
    assert np.array_equal(g.aggregate["density"], np.asarray(w.aggregate["density"]))
    m = pred(c) & ok
    col = np.clip(np.floor((c["x"][m] - env[0]) / ((env[2] - env[0]) / 40)).astype(int), 0, 39)
    row = np.clip(np.floor((c["y"][m] - env[1]) / ((env[3] - env[1]) / 30)).astype(int), 0, 29)
    assert g.aggregate["density"].sum() == m.sum()
    assert np.array_equal(g.aggregate["density"],
                          np.bincount(row * 40 + col, minlength=1200).reshape(30, 40))


@pytest.mark.parametrize("auths", sorted(AUTHS))
def test_knn_and_aggregate_under_labels(auths):
    """The device kNN declines a labelled type (the host path checks each
    row's label); ``aggregate()`` skips the pyramid: both equal the
    reference's."""
    ref, port, _c, _w, _wv = stores(auths)
    for point, k in (((-10.0, 0.0), 10), ((30.0, 20.0), 40)):
        got = port_knn.knn_search(port, "t", *point, k=k)
        assert port_knn.last_knn_path() == "host-bbox"
        want = ref_knn.knn_search(ref, "t", *point, k=k)
        assert [f for f, _ in got] == [f for f, _ in want]
        np.testing.assert_allclose([d for _, d in got], [d for _, d in want], rtol=1e-9)
    cql = f"INTERSECTS(geom, {POLY})"
    assert port.aggregate("t", cql, columns=["cnt"]) == ref.aggregate("t", cql, columns=["cnt"])


def test_a_provider_is_read_at_each_query():
    """``auths`` may be a provider: its current authorizations apply to the
    next query."""
    prov = DefaultAuthorizationsProvider(["USA"])
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"), auths=prov)
    port.create_schema(parse_spec("v", SPEC))
    with port.writer("v") as w:
        w.write([BASE, "a", 1, port_geom.Point(0, 0)], fid="open")
        w.write([BASE, "b", 2, port_geom.Point(0, 0)], fid="usa", visibility="USA")
        w.write([BASE, "c", 3, port_geom.Point(0, 0)], fid="secret", visibility="USA&SECRET")
    assert port.authorizations == ["USA"]
    assert sorted(port.query("v").fids) == ["open", "usa"]
    prov._auths = ["USA", "SECRET"]
    assert sorted(port.query("v").fids) == ["open", "secret", "usa"]
    none = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    none.create_schema(parse_spec("v", SPEC))
    with none.writer("v") as w:
        w.write([BASE, "a", 1, port_geom.Point(0, 0)], fid="open")
        w.write([BASE, "b", 2, port_geom.Point(0, 0)], fid="usa", visibility="USA")
    assert list(none.query("v").fids) == ["open"] and none.count("v") == 1
