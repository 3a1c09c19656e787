"""Planning of the port's attribute index against the JAX package.

The attribute sketches (``MinMax``, ``TopK``, ``Frequency``, the
auto-ranging ``Histogram``) on the same columns, the estimator's counts
for attribute, spatial and temporal filters, the index each query plans
on, ``AttributeKeySpace.get_ranges`` (with its z2 tiebreak ranges) and the
attribute blocks' ``scan_intervals`` must equal the reference's exactly.
Both stores ingest the same three write batches (three blocks per table).
"""

import numpy as np
import pytest

from geomesa_tpu.filter.parser import parse_cql as ref_parse_cql
from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.stats import sketches as ref_sk
from geomesa_tpu.store.datastore import HostScanExecutor, TpuDataStore

from geomesa_tpu_torch.filter.parser import parse_cql
from geomesa_tpu_torch.index.keyspace import default_indices
from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.stats import sketches as sk
from geomesa_tpu_torch.store.datastore import TorchDataStore

SPEC = ("actor1:String:index=true,goldstein:Double,score:Double:index=true,"
        "n:Integer:index=true,name:String,dtg:Date,*geom:Point:srid=4326")
T0 = np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64)
BATCH = 6_000


def _batches(seed: int = 17):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(3):
        n = BATCH
        actors = np.array(["USA", "CHN", "RUS", "FRA", "BRA", f"X{b}"], dtype=object)[
            rng.choice(6, n, p=[0.4, 0.2, 0.15, 0.1, 0.1, 0.05])]
        actors[rng.random(n) < 0.05] = None
        score = rng.normal(3 * b, 2.0, n)  # shifts per batch: the histogram re-ranges
        score[rng.random(n) < 0.05] = np.nan
        nv = rng.integers(0, 1000, n).astype(np.int32)
        out.append({
            "__fid__": np.char.add(f"b{b}_", np.arange(n).astype(str)),
            "actor1": actors, "goldstein": np.round(rng.uniform(-10, 10, n), 1),
            "score": score, "n": nv, "n__null": rng.random(n) < 0.1,
            "name": np.char.add("nm", rng.integers(0, 50, n).astype(str)).astype(object),
            "geom__x": rng.uniform(-180, 180, n), "geom__y": rng.uniform(-85, 85, n),
            "dtg": T0 + rng.integers(0, 30 * 86_400_000, n),
        })
    return out


@pytest.fixture(scope="module")
def stores():
    ref = TpuDataStore(executor=HostScanExecutor())
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    for store, parse in ((ref, ref_parse_spec), (port, parse_spec)):
        ft = parse("g", SPEC)
        store.create_schema(ft)
        for cols in _batches():
            store._insert_columns(ft, {k: v.copy() for k, v in cols.items()})
    return ref, port


def test_default_indices_add_the_attribute_tables():
    ft = parse_spec("g", SPEC)
    assert [i.name for i in default_indices(ft)] == [
        "z3", "z2", "id", "attr:actor1", "attr:score", "attr:n"]


def _values(kind, rng, n=5000):
    if kind == "str":
        v = np.array([f"v{i}" for i in rng.integers(0, 300, n)], dtype=object)
        v[::37] = None
        return v, None
    if kind == "f8":
        v = np.round(rng.normal(0, 5, n), 2)
        v[::29] = np.nan
        v[::31] = -0.0
        return v, None
    v = rng.integers(-100, 100, n)
    return v, rng.random(n) < 0.1


@pytest.mark.parametrize("kind", ["str", "f8", "i8"])
def test_sketches_equal_the_reference(kind):
    """Two batches through ``observe`` and their distinct values through
    ``observe_counts``: MinMax bounds and registers (and so cardinality),
    TopK counts past its capacity, Frequency tables and counts."""
    rng = np.random.default_rng(4)
    batches = [_values(kind, rng) for _ in range(2)]
    pairs = [
        (sk.MinMax("a"), ref_sk.MinMax("a")),
        (sk.TopK("a", capacity=64), ref_sk.TopK("a", capacity=64)),
        (sk.Frequency("a", width=128), ref_sk.Frequency("a", width=128)),
    ]
    if kind != "str":
        pairs.append((sk.Histogram("a", 50), ref_sk.Histogram("a", 50)))
    for port, ref in pairs:
        for v, nulls in batches:
            port.observe(v, nulls)
            ref.observe(v, nulls)
        live = ref_sk._clean(np.asarray(batches[0][0]), batches[0][1])
        uniq, cnt = np.unique(live, return_counts=True)
        port.observe_counts(uniq, cnt)
        ref.observe_counts(uniq, cnt)
    (mm, rmm), (tk, rtk), (fq, rfq) = pairs[:3]
    assert (mm.min, mm.max) == (rmm.min, rmm.max)
    assert np.array_equal(mm.registers, rmm.registers) and mm.cardinality == rmm.cardinality
    assert tk.counts == rtk.counts and tk.topk(5) == rtk.topk(5)
    assert np.array_equal(fq.table, rfq.table)
    probe = batches[0][0][:20].tolist() + (["absent"] if kind == "str" else [1e9])
    assert [fq.count(v) for v in probe if v is not None] == \
        [rfq.count(v) for v in probe if v is not None]
    if kind != "str":
        h, rh = pairs[3]
        assert (h.lo, h.hi) == (rh.lo, rh.hi) and np.array_equal(h.counts, rh.counts)


def test_datastore_sketches_equal_the_reference(stores):
    ref, port = stores
    ps = port.stats.stats_for(port.get_schema("g"))
    rs = ref.stats.stats_for(ref.get_schema("g"))
    want = set(rs)
    assert set(ps) == want
    assert ps["count"].count == rs["count"].count
    for key in sorted(want - {"count"}):
        p, r = ps[key], rs[key]
        if key == "z3":
            assert p.to_json() == r.to_json(), key
        elif key.startswith("minmax:"):
            assert (p.min, p.max, p.cardinality) == (r.min, r.max, r.cardinality), key
        elif key.startswith("topk:"):
            assert p.counts == r.counts, key
        elif key.startswith("freq:"):
            assert np.array_equal(p.table, r.table), key
        else:
            assert (p.lo, p.hi) == (r.lo, r.hi) and np.array_equal(p.counts, r.counts), key


ESTIMATES = [
    "actor1 = 'USA'", "actor1 = 'X1'", "actor1 = 'absent'", "goldstein = 1.5",
    "n = 7", "score > 4.5", "score <= -1", "score BETWEEN 0 AND 3", "goldstein > -3.4",
    "goldstein <= 2", "n < 100", "name = 'nm3'",
    "bbox(geom, -30, 0, 10, 30)", "dtg DURING 2026-01-05T00:00:00Z/2026-01-12T00:00:00Z",
    "actor1 = 'USA' AND bbox(geom, -30, 0, 10, 30)",
    "actor1 = 'USA' OR actor1 = 'CHN'", "NOT (actor1 = 'RUS')",
    "actor1 IN ('USA', 'CHN')", "actor1 LIKE 'U%'",
]


@pytest.mark.parametrize("cql", ESTIMATES)
def test_estimates_equal_the_reference(stores, cql):
    ref, port = stores
    got = port.stats.get_count(port.get_schema("g"), parse_cql(cql))
    want = ref.stats.get_count(ref.get_schema("g"), ref_parse_cql(cql))
    assert got == want


PLANS = [
    "actor1 = 'USA' AND bbox(geom, -30, 0, 10, 30)",
    "actor1 = 'USA'",
    "actor1 = 'X2' AND bbox(geom, -180, -90, 180, 90)",
    "actor1 IN ('USA', 'CHN', 'RUS') AND bbox(geom, -100, -50, 100, 50)",
    "actor1 LIKE 'U%' AND bbox(geom, -30, 0, 10, 30)",
    "actor1 LIKE 'C%'",
    "actor1 >= 'CHN' AND actor1 < 'RUS'",
    "score > 8 AND bbox(geom, -180, -90, 180, 90)",
    "score BETWEEN 0 AND 1",
    "n = 7 AND bbox(geom, -180, -90, 180, 90)",
    "n < 10 OR n > 990",
    "goldstein > 1 AND bbox(geom, -30, 0, 10, 30)",
    "actor1 = 'USA' AND bbox(geom, -30, 0, 10, 30) AND "
    "dtg DURING 2026-01-05T00:00:00Z/2026-01-12T00:00:00Z",
]


def _range_tuple(r):
    return (r.bin, r.lower, r.upper, r.contained, r.lower_inclusive, r.upper_inclusive,
            None if r.tiebreak_ranges is None else [tuple(map(int, t)) for t in r.tiebreak_ranges])


@pytest.mark.parametrize("cql", PLANS)
def test_plans_ranges_and_intervals_equal_the_reference(stores, cql):
    """The chosen index and its cost, the post-filter, the attribute
    index's ranges (tiebreak z2 sub-ranges included) and, per block, the
    row intervals they seek to."""
    ref, port = stores
    p = port._plan_cached("g", Query.cql(cql))
    r = ref._plan_cached("g", RefQuery.cql(cql))
    assert p.index.name == r.index.name and p.cost == r.cost, (p.index.name, r.index.name)
    assert (p.full_filter is None) == (r.full_filter is None)
    if not p.index.name.startswith("attr"):
        return
    assert [_range_tuple(x) for x in p.ranges] == [_range_tuple(x) for x in r.ranges]
    pt, rt = port._tables["g"][p.index.name], ref._tables["g"][r.index.name]
    assert len(pt.blocks) == len(rt.blocks) == 3
    for pb, rb in zip(pt.blocks, rt.blocks):
        assert np.array_equal(pb.key, rb.key) and np.array_equal(pb.tiebreak, rb.tiebreak)
        assert (pb.key_vocab is None) == (rb.key_vocab is None)
        for a, b in zip(pb.scan_intervals(p.ranges), rb.scan_intervals(r.ranges)):
            assert np.array_equal(a, b), cql
    assert np.array_equal(pb.rowid, rb.rowid)
