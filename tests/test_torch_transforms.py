"""The port's query transforms, sampling and BIN reducer against the JAX
package, on the CPU.

``parse_transform`` (``tools/convert.py``) evaluates each expression of the
transform language as the reference's does; ``QueryTransforms`` holds the
cases of ``tests/test_transforms.py`` (the derived schema and values, a
geometry expression, sort and limit, the plain projection) on the port's
store beside a ``TpuDataStore`` of the same rows (the export case needs
``tools/export.py``, which is not ported). Then, against the reference's
store: sampling and ``sample_by`` alone and under density and stats (the
same sampled fid sets and the same aggregates), a stats query over a
computed property, and ``run_bin`` with and without a label and a sort,
compared byte for byte. ``arrow`` still raises, naming its ROADMAP item.
"""

import numpy as np
import pytest

from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.index.transforms import QueryTransforms as RefTransforms
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import HostScanExecutor, TpuDataStore
from geomesa_tpu.tools.convert import parse_transform as ref_parse_transform

from geomesa_tpu_torch.geom.base import Geometry
from geomesa_tpu_torch.index.aggregators import BIN_DTYPE, BIN_DTYPE_LABEL, run_bin
from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.index.transforms import QueryTransforms
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.schema.featuretype import AttributeType, parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.tools.convert import parse_transform

SPEC = "name:String,age:Int,dtg:Date,*geom:Point:srid=4326"
BASE = np.datetime64("2026-01-05T00:00:00", "ms").astype("int64")

ROW = ["a b", "2", "3.5", "2026-01-05T00:00:00Z", "POINT (1 2)", ""]
FIELDS = {"name": "Bob", "age": 7}
EXPRS = [
    "toInt($2)", "toLong('12345678901234567')", "toDouble($3)", "toString($age)",
    "toBoolean('yes')", "trim('  x ')", "strlen($name)", "lowercase($name)",
    "uppercase($name)", "concat($1, '-', $name)", "capitalize('abc')",
    "regexReplace('o', '0', $name)", "substr($name, 0, 2)",
    "withDefault(emptyToNull($6), 'd')", "date('ISO', $4)", "dateToMillis(date('ISO', $4))",
    "date('yyyyMMdd', '20260105')", "isoDate('20260105')", "secsToDate('1767571200')",
    "millisToSecs('1767571200123')", "basicDateTimeNoMillis('20260105T000000')",
    "dateToString('yyyy-MM-dd HH:mm:ss.SSS', 1767571200123)", "point(toDouble($2), toDouble($3))",
    "point($5)", "geometry($5)", "md5($name)", "murmur3_32($name)", "murmur3_64($name)",
    "base64($name)", "add($2, $3)", "subtract($3, $2)", "multiply($2, $3, 2)", "divide($3, 0)",
    "mean(1, 2, 4)", "min(3, $2)", "max(3, $2)", "printf('%s-%s', $name, $age)",
    "stringToInt('x', 5)", "stringToDouble('2.5')", "stringToBoolean('t')",
    "mkString('/', $1, $2)", "stripQuotes('\"q\"')", "jsonPath('$.a.b', '{\"a\": {\"b\": 3}}')",
    "jsonToString(parseMap('string->int', 'a->1,b->2'))", "parseList('int', '1,2,3')",
    "list($1, $2)", "mapValue(parseMap('string->int', 'a->1,b->2'), 'b')", "string2bytes($name)",
    "lineNo()",
]


def _norm(v):
    """Geometries compare by their WKT; everything else as is."""
    return repr(v) if isinstance(v, Geometry) or type(v).__name__ in (
        "Point", "Polygon", "LineString") else v


@pytest.mark.parametrize("text", EXPRS)
def test_parse_transform_matches_the_reference(text):
    got = parse_transform(text)(ROW, FIELDS)
    want = ref_parse_transform(text)(ROW, FIELDS)
    assert _norm(got) == _norm(want)
    assert type(got).__name__ == type(want).__name__


@pytest.mark.parametrize("text", ["nosuch($1)", "concat($1", "toInt($1) extra", "'", ""])
def test_parse_transform_rejects_what_the_reference_rejects(text):
    with pytest.raises(ValueError):
        ref_parse_transform(text)
    with pytest.raises(ValueError):
        parse_transform(text)


def _columns(n=50):
    i = np.arange(n)
    return {
        "__fid__": np.array([f"f{j}" for j in i], dtype=object),
        "name": np.array([f"name{j % 7}" if j % 11 else f"name{j}" for j in i], dtype=object),
        "age": i.astype(np.int32),
        "dtg": (BASE + ((i * 7919) % n) * 1000).astype(np.int64),
        "geom__x": (i % 90).astype(np.float64) - 0.5,
        "geom__y": (i % 45).astype(np.float64) - 0.25,
    }


@pytest.fixture(scope="module")
def stores():
    ref = TpuDataStore(executor=HostScanExecutor())
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    for ds, parse in ((ref, ref_parse_spec), (port, parse_spec)):
        ds.create_schema(parse("t", SPEC))
        ds._insert_columns(ds.get_schema("t"), _columns())
    return ref, port


def _both(stores, cql, **kw):
    """(the port's result, the reference's) of one query."""
    ref, port = stores
    return port.query("t", Query.cql(cql, **kw)), ref.query("t", RefQuery.cql(cql, **kw))


def _sorted(res):
    """Result columns in fid order, materialized."""
    cols = dict(res.columns)
    order = np.argsort(np.asarray(cols["__fid__"]).astype(str), kind="stable")
    return {k: np.asarray(v)[order] for k, v in cols.items()}


def _same_columns(got, want):
    g, w = _sorted(got), _sorted(want)
    assert set(g) == set(w)
    for k in w:
        assert np.array_equal(g[k], w[k]), k


def _schema(ft):
    return [(a.name, a.type.value) for a in ft.attributes]


PROPS = [
    ["geom", "who=uppercase($name)", "age2=toint(concat($age, '0'))"],
    ["pt=point($age, $age)", "name"],
    ["geom", "d=dateToMillis($dtg)", "half=divide($age, 2)", "n=withDefault($name, 'x')"],
]


@pytest.mark.parametrize("props", PROPS)
def test_query_transforms_parse_and_schema(props):
    ref_ft, port_ft = ref_parse_spec("t", SPEC), parse_spec("t", SPEC)
    tf = QueryTransforms.parse(port_ft, props)
    assert _schema(tf.schema()) == _schema(RefTransforms.parse(ref_ft, props).schema())
    assert QueryTransforms.parse(port_ft, ["geom", "name"]) is None
    assert QueryTransforms.parse(port_ft, None) is None


def test_transform_schema_and_values(stores):
    got, want = _both(stores, "age < 10", properties=PROPS[0])
    assert [a.name for a in got.ft.attributes] == ["geom", "who", "age2"]
    assert got.ft.attr("who").type == AttributeType.STRING
    assert got.ft.attr("age2").type == AttributeType.INT
    assert got.ft.default_geometry is not None
    assert _schema(got.ft) == _schema(want.ft)
    _same_columns(got, want)
    cols = _sorted(got)
    for fid, who, a2 in zip(cols["__fid__"], cols["who"], cols["age2"]):
        i = int(fid[1:])
        assert who == _columns()["name"][i].upper() and int(a2) == i * 10


def test_transform_geometry_expression(stores):
    got, want = _both(stores, "age = 3", properties=PROPS[1])
    assert got.ft.attr("pt").type == AttributeType.POINT
    assert (float(got.columns["pt__x"][0]), float(got.columns["pt__y"][0])) == (3.0, 3.0)
    _same_columns(got, want)


def test_transform_composes_with_sort_and_limit(stores):
    got, want = _both(stores, "INCLUDE", properties=["who=uppercase($name)"],
                      sort_by=[("age", False)], max_features=3)
    assert len(got) == 3
    assert list(got.fids) == list(want.fids) == ["f49", "f48", "f47"]
    assert list(got.columns["who"]) == list(want.columns["who"])


def test_transform_with_dates_and_nulls(stores):
    got, want = _both(stores, "age >= 20", properties=PROPS[2])
    assert _schema(got.ft) == _schema(want.ft)
    _same_columns(got, want)


def test_plain_projection_unchanged(stores):
    got, want = _both(stores, "age = 2", properties=["name"])
    assert "name" in got.columns and "age" not in got.columns
    assert [a.name for a in got.ft.attributes] == ["name"]
    _same_columns(got, want)


SAMPLED = [
    ({"sampling": 0.25}, None),
    ({"sampling": 0.1, "sample_by": "name"}, None),
    ({"sampling": 0.5}, [("age", False)]),
    ({"sampling": 0.3, "sample_by": "name"}, ["name", "age"]),
]


@pytest.mark.parametrize("hints,extra", SAMPLED)
def test_sampling_matches_the_reference(stores, hints, extra):
    """The same sampled fid set (every n-th row of the result, of each
    ``sample_by`` value), alone, sorted or projected."""
    kw = {"hints": dict(hints)}
    if extra and isinstance(extra[0], tuple):
        kw["sort_by"] = extra
    elif extra:
        kw["properties"] = extra
    got, want = _both(stores, "bbox(geom, -10, -10, 60, 40)", **kw)
    assert 0 < len(got) < len(stores[1].query("t", "bbox(geom, -10, -10, 60, 40)"))
    assert sorted(got.fids) == sorted(want.fids)
    if "sort_by" in kw:
        assert list(got.fids) == list(want.fids)
    _same_columns(got, want)


@pytest.mark.parametrize("sample_by", [None, "name"])
def test_sampling_under_density(stores, sample_by):
    hints = {"sampling": 0.2, "density": {"envelope": (-10.0, -10.0, 60.0, 40.0),
                                          "width": 16, "height": 8}}
    if sample_by:
        hints["sample_by"] = sample_by
    got, want = _both(stores, "bbox(geom, -10, -10, 60, 40)", hints=hints)
    full = stores[1].query("t", Query.cql("bbox(geom, -10, -10, 60, 40)", hints={
        "density": hints["density"]}))
    assert np.array_equal(got.aggregate["density"], np.asarray(want.aggregate["density"]))
    assert got.aggregate["density"].sum() < full.aggregate["density"].sum()


@pytest.mark.parametrize("spec", ["Count();MinMax(age)", "Count();TopK(name)"])
@pytest.mark.parametrize("sample_by", [None, "name"])
def test_sampling_under_stats(stores, spec, sample_by):
    hints = {"sampling": 0.25, "stats": spec}
    if sample_by:
        hints["sample_by"] = sample_by
    got, want = _both(stores, "bbox(geom, -10, -10, 60, 40)", hints=hints)
    assert got.aggregate["stats"].to_json() == want.aggregate["stats"].to_json()
    # a sampled query scans: no push-down or cache answers it
    assert got.scan_path not in ("device-stats", "agg-pyramid-stats")


@pytest.mark.parametrize("spec,prop", [
    ("MinMax(a2)", "a2=multiply($age, 2)"),
    ("Count();MinMax(a2)", "a2=add($age, 1)"),
    ("TopK(who)", "who=uppercase($name)"),
])
def test_stats_over_a_computed_property(stores, spec, prop):
    """A stats query with a transform aggregates the transformed values, as
    in the reference (no push-down or cache answers it)."""
    got, want = _both(stores, "age < 30", properties=["geom", prop], hints={"stats": spec})
    assert got.aggregate["stats"].to_json() == want.aggregate["stats"].to_json()
    assert got.scan_path not in ("device-stats", "agg-pyramid-stats")
    if spec == "MinMax(a2)":
        assert (got.aggregate["stats"].min, got.aggregate["stats"].max) == (0.0, 58.0)


@pytest.mark.parametrize("spec", [
    {"track": "name"},
    {"track": "name", "label": "age"},
    {"track": "age", "sort": True},
    {"track": "id", "label": "name", "sort": True},
])
def test_run_bin_matches_the_reference_byte_for_byte(stores, spec):
    got, want = _both(stores, "bbox(geom, -10, -10, 60, 40)", hints={"bin": dict(spec)})
    g, w = got.aggregate["bin"], want.aggregate["bin"]
    assert g.dtype == (BIN_DTYPE_LABEL if spec.get("label") else BIN_DTYPE)
    assert g.dtype == w.dtype and len(g) == len(w) > 0
    assert g.tobytes() == w.tobytes()
    if spec.get("sort"):
        assert np.all(np.diff(g["dtg"]) >= 0)


def test_run_bin_on_columns():
    ft = parse_spec("t", SPEC)
    cols = _columns(10)
    out = run_bin(ft, {"track": "name", "label": "name"}, cols)
    assert out.dtype == BIN_DTYPE_LABEL and len(out) == 10
    assert np.array_equal(out["lon"], cols["geom__x"].astype(np.float32))
    assert np.array_equal(out["dtg"], (cols["dtg"] // 1000).astype(np.int32))
    assert np.array_equal(out["track"].astype(np.int64), out["label"])


def test_arrow_still_raises_naming_its_item(stores):
    with pytest.raises(NotImplementedError, match="item 19"):
        stores[1].query("t", Query.cql("age < 3", hints={"arrow": {}}))
