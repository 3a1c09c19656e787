"""The port's attribute planes (BASELINE config #4) against the JAX package.

The same columns go into the reference ``TpuDataStore`` on a one-device CPU
mesh, run as on an accelerator (exact device predicate, batched dispatch,
the bitmap protocol), and into the port's ``TorchDataStore(device="cpu")``.
Held exactly against the reference: the unified code columns of
``load_attr_codes`` (dictionary strings, doubles with NaN, ints with nulls,
dates, the fixed-width string fallback), the per-query code vectors
(``attr_qcode`` / ``attr_qrange`` / ``attr_qcodes`` / ``attr_qmask``), the
torch ``attr_combine`` in each edition, ``exact_bitmap_plain`` with each
edition against ``_exact_bitmap_batch_fn(..., attr=...)`` (bits and
header), and the slice as a whole: a bench_attr_bbox-shaped store
(``chip_smoke.synthesize_attr``) answering streams (j) and (k) and the lone
query under ``GEOMESA_SEEK`` = auto, 0 and 1 with the reference's fid sets,
index and ``scan_path``, and the numpy oracle's rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import chip_smoke as cs
from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.ops import zkernels as ref_z
from geomesa_tpu.parallel import executor as ref_ex
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops import zkernels as Z
from geomesa_tpu_torch.ops.filters import ATTR_KINDS, attr_combine
from geomesa_tpu_torch.parallel import executor as port_ex
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore

REF_ENV = {
    "GEOMESA_EXACT_DEVICE": "1",
    "GEOMESA_DEVBATCH": "1",
    "GEOMESA_BATCH_PROTO": "bitmap",
}
N_BENCH = 20_000
# three write batches (three blocks per table, each with its own vocab),
# null strings, NaN doubles, null ints and dates, a high-cardinality string
# (dtg first: the first date attribute is the default date, seen a secondary one)
MIXED_SPEC = ("dtg:Date,actor1:String:index=true,goldstein:Double,score:Double:index=true,"
              "n:Integer:index=true,seen:Date:index=true,tag:String,*geom:Point:srid=4326")
MIXED_BATCH = 9_000
T0 = np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64)


@pytest.fixture(scope="module", autouse=True)
def _env():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_ENV.items():
            mp.setenv(k, v)
        yield
    torch.set_num_threads(old)


def _stores():
    ref = TpuDataStore(executor=TpuScanExecutor(Mesh(np.asarray(jax.devices()[:1]), ("shards",))))
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    return ref, port


def _mixed_batches(seed: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(3):
        n = MIXED_BATCH
        actors = np.array([f"a{(b + j) % 7}" for j in range(4)] + ["Z\U0010ffff", "zz"],
                          dtype=object)[rng.integers(0, 6, n)]
        actors[rng.random(n) < 0.08] = None
        gold = np.round(rng.uniform(-10, 10, n), 1)
        gold[rng.random(n) < 0.05] = np.nan
        score = rng.normal(b, 3.0, n)
        score[rng.random(n) < 0.05] = np.nan
        nv = rng.integers(-50, 50, n).astype(np.int32)
        n_null = rng.random(n) < 0.1
        nv[n_null] = 0
        seen = T0 + rng.integers(0, 20, n) * 86_400_000
        seen_null = rng.random(n) < 0.1
        seen[seen_null] = 0
        tag = np.char.add("t", rng.integers(0, 10**9, n).astype(str)).astype(object)
        tag[rng.random(n) < 0.02] = None
        out.append({
            "__fid__": np.char.add(f"b{b}_", np.arange(n).astype(str)),
            "actor1": actors, "goldstein": gold, "score": score,
            "n": nv, "n__null": n_null, "seen": seen, "seen__null": seen_null,
            "tag": tag,
            "geom__x": rng.uniform(-60, 60, n), "geom__y": rng.uniform(-40, 40, n),
            "dtg": T0 + rng.integers(0, 30 * 86_400_000, n),
        })
    return out


@pytest.fixture(scope="module")
def mixed(_env):
    ref, port = _stores()
    for store, parse in ((ref, ref_parse_spec), (port, parse_spec)):
        ft = parse("mixed", MIXED_SPEC)
        store.create_schema(ft)
        for cols in _mixed_batches():
            store._insert_columns(ft, {k: v.copy() for k, v in cols.items()})
    return ref, port


def _segments(ref, port, attr):
    """(reference segment, port segment) pairs of the z2 tables, codes of
    ``attr`` loaded in both."""
    rt, pt = ref._tables["mixed"]["z2"], port._tables["mixed"]["z2"]
    rsegs = ref.executor.device_index(rt).segments
    psegs = port.executor.device_index(pt).segments
    assert [len(s.blocks) for s in rsegs] == [len(s.blocks) for s in psegs]
    out = []
    for rs, ps in zip(rsegs, psegs):
        assert rs.load_attr_codes(attr) == ps.load_attr_codes(attr) is True
        out.append((rs, ps))
    return out


@pytest.mark.parametrize("attr", ["actor1", "goldstein", "score", "n", "seen", "tag"])
def test_unified_codes_equal_the_reference(mixed, attr):
    ref, port = mixed
    for rs, ps in _segments(ref, port, attr):
        rdev, runi = rs._attr_codes[attr]
        pdev, puni = ps._attr_codes[attr]
        n = ps.n
        want = np.asarray(rdev)
        got = pdev.numpy()
        assert got.dtype == np.int32
        assert np.array_equal(got[:n], want[:n])
        assert (got[n:] == -1).all() and (want[n:] == -1).all()  # pad rows
        assert puni.dtype == runi.dtype and np.array_equal(puni, runi)
        assert (got[:n] == -1).any()  # nulls rank -1


# (attribute, literal) of attr_qcode, including absent and incomparable
QCODES = [
    ("actor1", "a3"), ("actor1", "absent"), ("actor1", "Z\U0010ffff"), ("actor1", 3.5),
    ("goldstein", 1.5), ("goldstein", 1.55), ("goldstein", "x"), ("goldstein", -0.0),
    ("n", 7), ("n", 1000), ("seen", int(T0 + 3 * 86_400_000)), ("seen", int(T0 + 1)),
]
# (attribute, predicates) of attr_qrange
QRANGES = [
    ("goldstein", ((">", -3.4), ("<=", 2.0))),
    ("goldstein", (("between", (-1.0, 1.0)),)),
    ("goldstein", (("=", 0.5),)),
    ("goldstein", (("isnull", None),)),
    ("goldstein", (("notnull", None),)),
    ("goldstein", ((">", 20.0),)),
    ("goldstein", (("<", "x"),)),
    ("score", ((">=", 0.0), ("<", 1.0))),
    ("n", (("<", 0),)),
    ("n", (("isnull", None), (">", 3))),
    ("actor1", (("prefix", "a"),)),
    ("actor1", (("prefix", "Z\U0010ffff"),)),
    ("actor1", (("prefix", "\U0010ffff"),)),
    ("actor1", (("prefix", ""),)),
    ("actor1", (("<", "a3"), (">=", "a1"))),
    ("seen", (("during", (int(T0), int(T0 + 5 * 86_400_000))),)),
    ("seen", (("before", int(T0 + 86_400_000)),)),
    ("seen", (("after", int(T0 + 10 * 86_400_000)),)),
    ("tag", (("prefix", "t1"),)),
]
# (attribute, values, K) of attr_qcodes and (attribute, pattern, ci) of attr_qmask
QLISTS = [("actor1", ("a1", "a2", "nope"), 4), ("n", (1, 2, 3, 4, 5), 8), ("actor1", ("a1",), 1)]
QMASKS = [("actor1", "%3", False), ("actor1", "A_", True), ("actor1", "Z%", False),
          ("goldstein", "1%", False)]


def test_query_vectors_equal_the_reference(mixed):
    ref, port = mixed
    for attr in {a for a, *_ in QCODES + QRANGES + QLISTS + QMASKS}:
        for rs, ps in _segments(ref, port, attr):
            for a, v in QCODES:
                if a == attr:
                    assert ps.attr_qcode(attr, v) == rs.attr_qcode(attr, v), (attr, v)
            for a, preds in QRANGES:
                if a == attr:
                    assert np.array_equal(ps.attr_qrange(attr, preds),
                                          rs.attr_qrange(attr, preds)), (attr, preds)
            for a, vals, k in QLISTS:
                if a == attr:
                    assert np.array_equal(ps.attr_qcodes(attr, vals, k),
                                          rs.attr_qcodes(attr, vals, k)), (attr, vals)
            for a, pat, ci in QMASKS:
                if a == attr:
                    assert np.array_equal(ps.attr_qmask(attr, (pat, ci)),
                                          rs.attr_qmask(attr, (pat, ci))), (attr, pat)
            assert ps.attr_vocab_ok(attr) == rs.attr_vocab_ok(attr)


@pytest.mark.parametrize("s", ["abc", "a\U0010ffff", "\U0010ffff\U0010ffff", "", "z"])
def test_str_successor_equals_the_reference(s):
    assert port_ex._str_successor(s) == ref_ex._str_successor(s)


def _qcode(kind, rng, q):
    if kind == "range":
        lo = rng.integers(-1, 40, q)
        return np.stack([lo, lo + rng.integers(-2, 20, q)], 1).astype(np.int32)
    if kind == "vocabmask":
        return (rng.random((q, 64)) < 0.3).astype(np.uint8)
    return rng.integers(-2, 50, (q, 4)).astype(np.int32)


@pytest.mark.parametrize("kind", ATTR_KINDS)
def test_attr_combine_equals_the_reference(kind):
    rng = np.random.default_rng(5)
    n = 4096
    codes = rng.integers(-1, 70, n).astype(np.int32)  # past the lookup's end too
    m = rng.random(n) < 0.7
    combine = ref_ex._attr_combine(kind)
    for qc in _qcode(kind, rng, 6):
        want = np.asarray(combine(jnp.asarray(m), jnp.asarray(codes), jnp.asarray(qc)))
        got = attr_combine(torch.from_numpy(m), torch.from_numpy(codes), torch.from_numpy(qc),
                           kind)
        assert np.array_equal(got.numpy(), want)


_N = 8192
# (xmin, ymin, xmax, ymax, t_lo, t_hi): one empty box, one at the table's
# first and last rows, wide and narrow ones
_SHAPES = [
    (100.0, 100.0, 101.0, 101.0, T0, T0 + 20 * 86_400_000),
    (49.5, 49.5, 50.5, 50.5, T0, T0 + 20 * 86_400_000),
    (-10.0, -10.0, 10.0, 10.0, T0, T0 + 5 * 86_400_000),
    (-2.0, -2.0, 3.0, 3.0, None, T0 + 10 * 86_400_000),
    (-10.0, -10.0, 10.0, 10.0, T0 + 86_400_000, None),
]


def _bitmap_rows(seed: int = 11):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-10, 10, _N), rng.uniform(-10, 10, _N)
    t = T0 + rng.integers(0, 10 * 86_400_000, _N)
    x[0] = x[_N - 1] = y[0] = y[_N - 1] = 50.0
    valid = np.ones(_N, dtype=bool)
    valid[_N - 64:] = False  # pad rows: code -1, invalid
    tvalid = valid.copy()
    tvalid[100:120] = False
    codes = rng.integers(0, 60, _N).astype(np.int32)
    codes[rng.random(_N) < 0.1] = -1
    codes[_N - 64:] = -1
    codes[0] = 7
    return x, y, t, valid, tvalid, codes


@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("kind", ATTR_KINDS)
def test_exact_bitmap_plain_attr_equals_the_reference(kind, has_time):
    x, y, t, valid, tvalid, codes = _bitmap_rows()
    shapes = _SHAPES if has_time else [s[:4] + (None, None) for s in _SHAPES]
    q = len(shapes)
    qcodes = _qcode(kind, np.random.default_rng(9), q)
    if kind == "range":
        qcodes[0] = (-1, -1)  # IS NULL: pad rows stay out through valid
        qcodes[3] = (5, 2)  # empty interval
    elif kind != "vocabmask":
        qcodes[1] = (7, -2, -2, -2)  # row 0's code
    span_cap = _N // 2

    def limbs(keys):
        hi, lo = ref_z.split_u64_to_limbs(keys)
        return jnp.asarray(hi), jnp.asarray(lo)

    xh, xl = limbs(ref_z.f64_sort_keys(x))
    yh, yl = limbs(ref_z.f64_sort_keys(y))
    rdesc = [TpuScanExecutor._shape_limbs(s) for s in shapes]
    boxes = jnp.asarray(np.stack([d[0] for d in rdesc]))
    if has_time:
        th, tl = limbs(ref_z.i64_sort_keys(t))
        args = (xh, xl, yh, yl, th, tl, jnp.asarray(tvalid), jnp.asarray(codes), boxes,
                jnp.asarray(np.stack([d[1] for d in rdesc])), jnp.asarray(qcodes))
    else:
        args = (xh, xl, yh, yl, jnp.asarray(valid), jnp.asarray(codes), boxes,
                jnp.asarray(qcodes))
    fn = ref_ex._exact_bitmap_batch_fn(has_time, span_cap, q, "local",
                                       Mesh(np.asarray(jax.devices()[:1]), ("shards",)), kind)
    want_hdr, want_bits = (np.asarray(a) for a in fn(*args))

    pdesc = [TorchScanExecutor._shape_keys(s) for s in shapes]
    wins = torch.from_numpy(np.stack([d[1] for d in pdesc])) if has_time else None
    bits, hdr = kernels.exact_bitmap(
        torch.from_numpy(Z.f64_keys(x)), torch.from_numpy(Z.f64_keys(y)),
        torch.from_numpy(t) if has_time else None,
        torch.from_numpy(tvalid if has_time else valid),
        torch.from_numpy(np.stack([d[0] for d in pdesc])), wins,
        torch.from_numpy(codes), torch.from_numpy(qcodes), kind)
    got_hdr, got_bits = kernels.frame_bitmaps(bits, hdr, span_cap)
    assert np.array_equal(got_hdr.numpy(), want_hdr)
    assert np.array_equal(got_bits.numpy(), want_bits)
    cnt, lo, hi, _start = want_hdr.T
    assert cnt[0] == 0 and (lo[0], hi[0]) == (0, _N - 1)  # the empty rule
    assert cnt[2] > 0


# -- the slice as a whole ------------------------------------------------------


@pytest.fixture(scope="module")
def bench(_env):
    data, rng = cs.synthesize_attr(N_BENCH)
    streams = cs.attr_streams(rng)
    ref, port = _stores()
    fids = np.char.add("f", np.arange(N_BENCH).astype(str))
    for store, parse in ((ref, ref_parse_spec), (port, parse_spec)):
        ft = parse("gdelt", cs.ATTR_SPEC)
        store.create_schema(ft)
        store._insert_columns(ft, cs.attr_columns(
            {k: v.copy() for k, v in data.items()}, fids))
    return data, streams, ref, port


def _fids(res):
    return set(res.fids.astype(str).tolist())


def _same(p, r, what):
    assert _fids(p) == _fids(r), what
    assert p.plan.index.name == r.plan.index.name, (what, p.plan.index.name)
    assert p.plan.scan_path == r.plan.scan_path, (what, p.plan.scan_path, r.plan.scan_path)


@pytest.mark.parametrize("mode", ["auto", "0", "1"])
def test_streams_take_the_reference_routes(bench, monkeypatch, mode):
    """Streams (j) and (k) through query_many, each query alone through
    query, and the lone query through query_many: the reference's fids,
    index and scan_path, and the oracle's rows."""
    monkeypatch.setenv("GEOMESA_SEEK", mode)
    data, streams, ref, port = bench
    items = streams["j"] + streams["k"]
    cqls = [c for c, _ in items]
    got = port.query_many("gdelt", [Query.cql(c, properties=[]) for c in cqls])
    want = ref.query_many("gdelt", [RefQuery.cql(c, properties=[]) for c in cqls])
    for (c, spec), p, r in zip(items, got, want):
        _same(p, r, c)
        assert _fids(p) == {f"f{i}" for i in cs.attr_oracle(data, spec)}, c
    # read before the queries below: plans are cached, and a plan's
    # scan_path is the last route it took
    paths = {q.plan.scan_path for q in got}
    for c, _spec in streams["k"][:4] + streams["j"][:2]:
        _same(port.query("gdelt", c), ref.query("gdelt", RefQuery.cql(c)), c)
    lone, spec = streams["lone"][0]
    p = port.query_many("gdelt", [lone])[0]
    _same(p, ref.query_many("gdelt", [RefQuery.cql(lone)])[0], lone)
    lone_path = p.plan.scan_path
    _same(port.query("gdelt", lone), ref.query("gdelt", RefQuery.cql(lone)), lone)
    if mode == "0":
        assert paths == {"device-exact/bitmap"}
        assert lone_path == "device-exact/runs"
    else:
        assert paths == {"host-seek"}


def test_every_edition_launches_on_the_stream(bench, monkeypatch):
    """Under GEOMESA_SEEK=0 the streams reach all eight attribute
    instantiations of exact_bitmap (z2 and z3, four editions each)."""
    monkeypatch.setenv("GEOMESA_SEEK", "0")
    _data, streams, _ref, port = bench
    calls = []
    orig = kernels.exact_bitmap

    def spy(*a, **k):
        calls.append((a[2] is not None, k.get("attr_kind", a[8] if len(a) > 8 else None)))
        return orig(*a, **k)

    monkeypatch.setattr(kernels, "exact_bitmap", spy)
    port.query_many("gdelt", [c for c, _ in streams["j"] + streams["k"]])
    assert set(calls) == {(t, k) for t in (True, False) for k in ATTR_KINDS}


ATTR_QUERIES_RESIDUAL = [
    "actor1 = 'USA' AND bbox(geom, -180, -90, 180, 90)",  # attr plan, residual box
    "actor1 = 'CHN' AND bbox(geom, -100, -80, 100, 80) AND "
    "dtg DURING 2026-01-02T00:00:00Z/2026-01-30T00:00:00Z",  # residual box + window
    "actor1 = 'RUS'",
]


@pytest.mark.parametrize("mode", ["auto", "1"])
def test_attribute_plans_seek_with_the_residual_shape(bench, monkeypatch, mode):
    """A plan on attr:actor1 whose residual is one box(+window) runs the C++
    seek over its candidates (the reference's ``_residual_shape``)."""
    monkeypatch.setenv("GEOMESA_SEEK", mode)
    _data, _streams, ref, port = bench
    for cql in ATTR_QUERIES_RESIDUAL:
        p, r = port.query("gdelt", cql), ref.query("gdelt", RefQuery.cql(cql))
        _same(p, r, cql)
        assert p.plan.index.name == "attr:actor1"
    plan = port._plan_cached("gdelt", Query.cql(ATTR_QUERIES_RESIDUAL[0]))
    scan = port.executor.scan_candidates(port._tables["gdelt"][plan.index.name], plan)
    assert scan.exact and scan.pred[-1] is False  # residual mode: every row tested


# a table with null actors and NaN goldstein: IS [NOT] NULL, '<>' and a
# literal the segment lacks (code -2) on the device plane


@pytest.mark.parametrize("mode", ["auto", "0"])
def test_null_values_equal_the_reference_and_the_oracle(monkeypatch, mode):
    monkeypatch.setenv("GEOMESA_SEEK", mode)
    data, cols = cs.attr_null_table(4_000)
    ref, port = _stores()
    for store, parse in ((ref, ref_parse_spec), (port, parse_spec)):
        ft = parse("nulls", cs.ATTR_SPEC)
        store.create_schema(ft)
        store._insert_columns(ft, {k: v.copy() for k, v in cols.items()})
    cqls = cs.attr_null_queries()
    got = port.query_many("nulls", cqls)
    want = ref.query_many("nulls", [RefQuery.cql(c) for c in cqls])
    for cql, p, r, (_oracle, device) in zip(cqls, got, want, cs.ATTR_NULL_QUERIES.values()):
        _same(p, r, cql)
        rows = cs.attr_null_oracle(data, cql)
        assert _fids(p) == {f"n{i}" for i in rows}, cql
        if mode == "0":
            assert p.plan.scan_path.startswith("device-exact/") == device, cql
    assert sum(len(p) for p in got) > 0


@pytest.mark.parametrize("mode", ["auto", "0"])
def test_extent_attribute_queries_keep_the_candidate_route(monkeypatch, mode):
    """An extent query with an attribute predicate: the reference's fids
    and, on the device, its route: the dual plane with the attribute
    edition of ``xz_dual_bitmap`` (the name is the test's from before the
    port had that edition)."""
    from geomesa_tpu.geom import base as ref_geom

    monkeypatch.setenv("GEOMESA_SEEK", mode)
    ways = cs.synthesize_ways(3_000, seed=5, bounds=(-15.0, -15.0, 45.0, 35.0), clusters=4)
    kinds = np.array(["road", "river", "rail"], dtype=object)[np.arange(3_000) % 3]
    spec = cs.WAYS_SPEC  # kind not indexed: the attribute table would take it
    ref, port = _stores()
    for store, parse, classes in ((ref, ref_parse_spec, (ref_geom.LineString, ref_geom.Polygon)),
                                  (port, parse_spec, None)):
        ft = parse("wk", spec)
        store.create_schema(ft)
        store._insert_columns(ft, {**cs.ways_columns(ways, classes=classes), "kind": kinds.copy()})
    cqls = [f"kind = 'road' AND {cs.xz_bbox_cql((0.0, 0.0, 20.0, 20.0))}",
            f"kind IN ('rail', 'river') AND {cs.xz_bbox_cql((-10.0, -5.0, 30.0, 25.0))}"]
    for cql, p, r in zip(cqls, port.query_many("wk", cqls),
                         ref.query_many("wk", [RefQuery.cql(c) for c in cqls])):
        assert _fids(p) == _fids(r) and len(r), cql
        assert p.plan.index.name == r.plan.index.name
        assert p.plan.scan_path == r.plan.scan_path, cql
        if mode == "0":
            assert p.plan.scan_path == "device-batch-dual/bitmap", cql


@pytest.mark.parametrize("mode", ["0", "1"])
def test_attributes_without_device_codes_take_the_candidate_route(monkeypatch, mode):
    """A string column with one value past 128 characters stays object
    (host only): its codes cannot load, so the group takes the candidate
    mask and the host post-filter (the reference's fallback), with the
    reference's answers."""
    monkeypatch.setenv("GEOMESA_SEEK", mode)
    data, rng = cs.synthesize_attr(6_000)
    data["actors"] = data["actors"].copy()
    data["actors"][17] = "L" * 200
    ref, port = _stores()
    fids = np.char.add("f", np.arange(6_000).astype(str))
    for store, parse in ((ref, ref_parse_spec), (port, parse_spec)):
        ft = parse("obj", cs.ATTR_SPEC)
        store.create_schema(ft)
        store._insert_columns(ft, cs.attr_columns({k: v.copy() for k, v in data.items()}, fids))
    items = cs.attr_streams(rng, reps=4)["j"]
    got = port.query_many("obj", [c for c, _ in items])
    want = ref.query_many("obj", [RefQuery.cql(c) for c, _ in items])
    for (cql, spec), p, r in zip(items, got, want):
        _same(p, r, cql)
        if spec[1] is not None and mode == "0":  # the actor1 queries
            assert p.plan.scan_path == "device-mask/runs", cql
    seg = port.executor.device_index(port._tables["obj"]["z2"]).segments[0]
    assert seg.load_attr_codes("actor1") is False and seg.load_attr_codes("goldstein")


MIXED_BOX = "bbox(geom, -20, -15, 25, 20)"
MIXED_QUERIES = [
    "seen DURING 2026-01-03T00:00:00Z/2026-01-09T00:00:00Z",
    "seen BEFORE 2026-01-05T00:00:00Z",
    "seen AFTER 2026-01-12T00:00:00Z AND seen BEFORE 2026-01-18T00:00:00Z",
    "n BETWEEN -10 AND 12",
    "n IN (1, 2, 3, 4, 5, 7, 11)",
    "n IS NULL",
    "score > 2.25 AND score <= 6",
    "goldstein = 1.5",
    "tag LIKE 't1%'",
    "tag <> 't5'",
    "actor1 LIKE '%3'",
    "actor1 LIKE 'Z%'",
    "actor1 ILIKE 'A_'",
    "actor1 IS NOT NULL",
    "actor1 >= 'a2' AND actor1 < 'a5'",
]


@pytest.mark.parametrize("mode", ["auto", "0"])
def test_mixed_attribute_predicates_equal_the_reference(mixed, monkeypatch, mode):
    """Every edition over dictionary strings (three blocks, three vocabs),
    the fixed-width string fallback, NaN doubles, null ints and a
    secondary date attribute (DURING / BEFORE / AFTER, the exclusive
    forms), each ANDed with a box, in one stream and alone: the
    reference's fids, index and scan_path."""
    monkeypatch.setenv("GEOMESA_SEEK", mode)
    ref, port = mixed
    cqls = [f"{q} AND {MIXED_BOX}" for q in MIXED_QUERIES]
    got = port.query_many("mixed", [Query.cql(c, properties=[]) for c in cqls])
    want = ref.query_many("mixed", [RefQuery.cql(c, properties=[]) for c in cqls])
    for cql, p, r in zip(cqls, got, want):
        _same(p, r, cql)
    if mode == "0":
        assert {p.plan.scan_path for p in got} <= {"device-exact/bitmap", "device-exact/runs"}
    for cql in cqls[:4]:
        _same(port.query("mixed", cql), ref.query("mixed", RefQuery.cql(cql)), cql)
