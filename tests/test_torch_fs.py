"""The port's file store (``store/fs.py``, ``store/partitions.py``) against
the JAX package, on the CPU.

Twin of the reference's ``tests/test_fs_partitions.py`` without its
parquet cases (parquet waits for ``arrow/``), of
``tests/test_join.py::test_fs_store_join_with_lazy_replay``, and of the
on-disk format itself: a store the reference writes opens in the port, and
a store the port writes opens in the reference, each with the same
schemas, persisted sketches, fid sets, counts, plans and routes (the
reference on a one-device CPU mesh, on its accelerator path: ``REF_ENV``). The
lazy store is held to brute force across loads that land after the device
mirror exists (week 1, then week 3), on the device route each time.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import chip_smoke as cs
from geomesa_tpu.filter.parser import parse_cql as ref_parse_cql
from geomesa_tpu.geom.base import LineString as RefLineString
from geomesa_tpu.geom.base import Point as RefPoint
from geomesa_tpu.geom.base import Polygon as RefPolygon
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store import partitions as ref_partitions
from geomesa_tpu.store.fs import FsDataStore as RefFsDataStore

from geomesa_tpu_torch.filter.parser import parse_cql
from geomesa_tpu_torch.geom.base import Point, Polygon
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.store.fs import FsDataStore
from geomesa_tpu_torch.store.partitions import (
    CompositeScheme,
    DateTimeScheme,
    Z2Scheme,
    from_config,
    load_scheme,
    parse_scheme,
    save_scheme,
)
from geomesa_tpu_torch.utils.config import properties

SPEC = "name:String,dtg:Date,*geom:Point:srid=4326"
FT = parse_spec("t", SPEC)
REF_FT = ref_parse_spec("t", SPEC)
MS = np.datetime64("2026-03-05T13:45:00", "ms").astype(np.int64)


# the reference on its accelerator path, where its routes are the port's
REF_ENV = {
    "GEOMESA_EXACT_DEVICE": "1",
    "GEOMESA_DEVBATCH": "1",
    "GEOMESA_BATCH_PROTO": "bitmap",
    "GEOMESA_SEEK": "0",
}


@pytest.fixture(scope="module", autouse=True)
def _env():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_ENV.items():
            mp.setenv(k, v)
        yield
    torch.set_num_threads(old)


def _ref_executor():
    return TpuScanExecutor(Mesh(np.asarray(jax.devices()[:1]), ("shards",)))


def port_open(root, **kw):
    return FsDataStore(root, device="cpu", **kw)


def ref_open(root, **kw):
    return RefFsDataStore(root, executor=_ref_executor(), **kw)


def _cols(xs, ys, ts):
    return {"geom__x": np.asarray(xs, dtype=np.float64),
            "geom__y": np.asarray(ys, dtype=np.float64),
            "dtg": np.asarray(ts, dtype=np.int64)}


# -- partition schemes --------------------------------------------------------


COVER_CQLS = [
    "dtg DURING 2026-03-04T00:00:00Z/2026-03-06T23:00:00Z",
    "dtg DURING 2025-11-15T00:00:00Z/2026-02-01T00:00:00Z",
    "bbox(geom, -170, -80, -100, -10)",
    "bbox(geom, -91, -46, -89, -44)",
    "bbox(geom, 5, 5, 15, 15) AND dtg DURING 2026-03-05T00:00:00Z/2026-03-05T23:00:00Z",
    "bbox(geom,0,0,1,1)",
    "dtg DURING 2026-03-05T00:00:00Z/2026-03-05T23:00:00Z",
    "dtg > 2026-03-05T00:00:00Z",
    "INCLUDE",
]
SCHEMES = ["daily", "monthly", "julian-day", "hourly", "weekly", "z2-4bits", "z2-2bits",
           "daily,z2-2bits", "monthly,z2-4bits"]


@pytest.mark.parametrize("spec", SCHEMES)
def test_scheme_names_and_covering_equal_the_reference(spec):
    port, ref = parse_scheme(spec), ref_partitions.parse_scheme(spec)
    assert port.to_config() == ref.to_config()
    rng = np.random.default_rng(5)
    cols = _cols(rng.uniform(-180, 180, 200), rng.uniform(-90, 90, 200),
                 MS + rng.integers(-90 * 86400_000, 90 * 86400_000, 200))
    assert list(port.partition_names(FT, cols)) == list(ref.partition_names(REF_FT, cols))
    for cql in COVER_CQLS:
        assert port.covering(FT, parse_cql(cql)) == ref.covering(REF_FT, ref_parse_cql(cql)), cql


def test_datetime_scheme_names_and_covering():
    s = DateTimeScheme("daily")
    assert list(s.partition_names(FT, _cols([0], [0], [MS]))) == ["2026/03/05"]
    cov = s.covering(FT, parse_cql("dtg DURING 2026-03-04T00:00:00Z/2026-03-06T23:00:00Z"))
    assert cov == ["2026/03/04", "2026/03/05", "2026/03/06"]
    assert s.covering(FT, parse_cql("bbox(geom,0,0,1,1)")) is None


def test_datetime_monthly_and_julian():
    m = DateTimeScheme("monthly")
    assert list(m.partition_names(FT, _cols([0], [0], [MS]))) == ["2026/03"]
    cov = m.covering(FT, parse_cql("dtg DURING 2025-11-15T00:00:00Z/2026-02-01T00:00:00Z"))
    assert cov == ["2025/11", "2025/12", "2026/01", "2026/02"]
    j = DateTimeScheme("julian-day")
    assert list(j.partition_names(FT, _cols([0], [0], [MS]))) == ["2026/064"]


def test_z2_scheme_names_and_covering():
    s = Z2Scheme(bits=4)
    names = s.partition_names(FT, _cols([-90, 90, -90, 90], [-45, 45, 45, -45], [MS] * 4))
    assert len(set(names)) == 4 and all(len(n) == s.digits for n in names)
    target = s.partition_names(FT, _cols([-90], [-45], [MS]))[0]
    assert target in s.covering(FT, parse_cql("bbox(geom, -91, -46, -89, -44)"))


def test_composite_scheme_prefix_covering():
    s = CompositeScheme([DateTimeScheme("daily"), Z2Scheme(bits=2)])
    assert s.partition_names(FT, _cols([10], [10], [MS]))[0].startswith("2026/03/05/")
    cov = s.covering(FT, parse_cql("dtg DURING 2026-03-05T00:00:00Z/2026-03-05T23:00:00Z"))
    assert cov == ["2026/03/05"]
    cov2 = s.covering(FT, parse_cql(
        "bbox(geom, 5, 5, 15, 15) AND dtg DURING 2026-03-05T00:00:00Z/2026-03-05T23:00:00Z"))
    assert all(c.startswith("2026/03/05/") for c in cov2)


def test_scheme_config_roundtrip_and_sidecar(tmp_path):
    for s in (DateTimeScheme("hourly"), Z2Scheme(bits=6),
              CompositeScheme([DateTimeScheme("daily"), Z2Scheme(bits=4)]),
              parse_scheme("daily,z2-4bits")):
        assert from_config(s.to_config()).to_config() == s.to_config()
        # the sidecar is the reference's file, read by either package
        path = str(tmp_path / "_scheme.json")
        save_scheme(path, s)
        assert ref_partitions.load_scheme(path).to_config() == s.to_config()
        ref_partitions.save_scheme(path, ref_partitions.from_config(s.to_config()))
        assert load_scheme(path).to_config() == s.to_config()
    assert isinstance(parse_scheme("z2-6bits"), Z2Scheme)
    assert isinstance(parse_scheme("monthly"), DateTimeScheme)
    # a torn sidecar quarantines: the type reads unpartitioned
    with open(path, "wb") as fh:
        fh.write(b'{"name": "dat')
    assert load_scheme(path) is None and os.path.exists(path + ".quarantine")


# -- the partitioned store -----------------------------------------------------


def _day_rows(n_days=6, per_day=40):
    rng = np.random.default_rng(9)
    base = np.datetime64("2026-03-01T00:00:00", "ms").astype(np.int64)
    return [([f"d{d}", int(base + d * 86400_000 + int(rng.integers(0, 86400_000)))],
             (float(rng.uniform(-170, 170)), float(rng.uniform(-80, 80))), f"f{d}-{i}")
            for d in range(n_days) for i in range(per_day)]


def _write_days(store, n_days=6, point=Point):
    with store.writer("t") as w:
        for vals, (x, y), fid in _day_rows(n_days):
            w.write(vals + [point(x, y)], fid=fid)


def test_partitioned_store_roundtrip(tmp_path):
    root = str(tmp_path / "store")
    ds = port_open(root, partition_scheme="daily")
    ds.create_schema(parse_spec("t", SPEC))
    _write_days(ds)
    days = sorted(os.listdir(os.path.join(root, "blocks", "t", "2026", "03")))
    assert days == ["01", "02", "03", "04", "05", "06"]
    q = "dtg DURING 2026-03-02T00:00:00Z/2026-03-03T23:59:59Z"
    want = sorted(ds.query("t", q).fids)
    ds2 = port_open(root)
    assert sorted(ds2.query("t", q).fids) == want
    assert ds2.count("t") == 240
    assert sorted(ref_open(root).query("t", q).fids) == want


def test_lazy_loading_reads_only_covering_partitions(tmp_path):
    root = str(tmp_path / "store")
    ds = port_open(root, partition_scheme="daily")
    ds.create_schema(parse_spec("t", SPEC))
    _write_days(ds)
    q = "dtg DURING 2026-03-02T00:00:00Z/2026-03-02T23:00:00Z"
    want = sorted(ds.query("t", q).fids)
    lazy = port_open(root, lazy=True)
    assert lazy._loaded["t"] == set()
    assert sorted(lazy.query("t", q).fids) == want
    loaded = lazy._loaded["t"]
    assert loaded and all(rel.startswith("2026/03/02") for rel in loaded)
    ref_lazy = ref_open(root, lazy=True)
    ref_lazy.query("t", q)
    assert ref_lazy._loaded["t"] == loaded
    # a broader query loads the rest and matches the eager store
    assert sorted(lazy.query("t").fids) == sorted(ds.query("t").fids)


def test_lazy_delete_applies_to_late_loaded_partitions(tmp_path):
    root = str(tmp_path / "store")
    ds = port_open(root, partition_scheme="daily")
    ds.create_schema(parse_spec("t", SPEC))
    _write_days(ds)
    victims = [f"f3-{i}" for i in range(10)]
    ds.delete_features("t", victims)
    lazy = port_open(root, lazy=True)
    lazy.query("t", "dtg DURING 2026-03-01T00:00:00Z/2026-03-01T23:00:00Z")
    got = lazy.query("t", "dtg DURING 2026-03-04T00:00:00Z/2026-03-04T23:59:59Z")
    assert not (set(got.fids) & set(victims)) and len(got) == 30
    # the late partition's rows leave the device mirror too
    got = lazy.query("t", "bbox(geom, -180, -90, 180, 90) AND "
                          "dtg DURING 2026-03-04T00:00:00Z/2026-03-04T23:59:59Z")
    assert not (set(got.fids) & set(victims)) and len(got) == 30
    assert got.scan_path.startswith("device-")
    assert sorted(lazy.query("t").fids) == sorted(ds.query("t").fids)


def test_parquet_waits_for_arrow(tmp_path):
    with pytest.raises(NotImplementedError, match="item 19"):
        port_open(str(tmp_path / "p"), block_format="parquet")
    with pytest.raises(ValueError):
        port_open(str(tmp_path / "q"), block_format="orc")


def test_scheme_validation_fails_fast(tmp_path):
    ds = port_open(str(tmp_path / "a"), partition_scheme="daily")
    with pytest.raises(ValueError, match="Date attribute"):
        ds.create_schema(parse_spec("nodate", "name:String,*geom:Point:srid=4326"))
    ds2 = port_open(str(tmp_path / "b"), partition_scheme="z2-4bits")
    with pytest.raises(ValueError, match="Point"):
        ds2.create_schema(parse_spec("poly", "dtg:Date,*geom:Polygon:srid=4326"))
    assert not os.path.exists(str(tmp_path / "a" / "blocks" / "nodate"))
    assert port_open(str(tmp_path / "a")).type_names == []


def test_reopen_does_not_double_count_stats(tmp_path):
    root = str(tmp_path / "store")
    ds = port_open(root)
    ds.create_schema(parse_spec("t", SPEC))
    _write_days(ds, n_days=2)
    ds.stats.flush()  # persist the sketches
    before = ds.stats.get_count(ds.get_schema("t"))
    ds2 = port_open(root)  # the replay must not observe persisted rows again
    assert ds2.stats.get_count(ds2.get_schema("t")) == before == 80
    lazy = port_open(root, lazy=True)
    # an estimate answers from the persisted sketches, loading nothing
    box = "bbox(geom, -100, -40, 100, 40)"
    assert lazy.count("t", box, exact=False) == ds.count("t", box, exact=False)
    assert lazy._loaded["t"] == set()
    assert ref_open(root, lazy=True).count("t", box, exact=False) == lazy.count(
        "t", box, exact=False)


def test_legacy_tombstone_sidecar_still_applies(tmp_path):
    root = str(tmp_path / "store")
    ds = port_open(root)
    ds.create_schema(parse_spec("t", SPEC))
    _write_days(ds, n_days=1)
    with open(os.path.join(root, "blocks", "t", "tombstones.txt"), "w") as fh:
        fh.write("f0-0\nf0-1\n")
    fids = set(port_open(root).query("t").fids)
    assert "f0-0" not in fids and "f0-1" not in fids and len(fids) == 38


def test_compact_preserves_partitions(tmp_path):
    root = str(tmp_path / "store")
    ds = port_open(root, partition_scheme="daily")
    ds.create_schema(parse_spec("t", SPEC))
    _write_days(ds, n_days=3)
    ds.delete_features("t", [f"f1-{i}" for i in range(20)])
    spill = str(tmp_path / "spill")
    with properties(geomesa_spill_dir=spill, geomesa_spill_min_bytes="1"):
        ds.compact("t")
        # the merged record spilled: its numeric columns are memory-mapped
        rec = ds._tables["t"]["z3"].blocks[0].record
        assert isinstance(rec.columns["geom__x"], np.memmap)
        assert os.listdir(spill)
    assert not os.path.exists(os.path.join(root, "blocks", "t", "_tombstones.txt"))
    for s in (port_open(root), ref_open(root)):
        assert s.count("t") == 3 * 40 - 20
        d2 = sorted(s.query("t", "dtg DURING 2026-03-02T00:00:00Z/2026-03-02T23:59:59Z").fids)
        assert all(f.startswith("f1-") for f in d2) and len(d2) == 20


def test_explain_and_delete_schema(tmp_path):
    root = str(tmp_path / "store")
    ds = port_open(root, partition_scheme="daily")
    ds.create_schema(parse_spec("t", SPEC))
    _write_days(ds, n_days=2)
    lazy = port_open(root, lazy=True)
    q = "dtg DURING 2026-03-02T00:00:00Z/2026-03-02T23:00:00Z"
    assert "z3" in lazy.explain("t", q)
    assert all(rel.startswith("2026/03/02") for rel in lazy._loaded["t"])
    lazy.delete_schema("t")
    assert lazy.type_names == [] and not os.path.exists(os.path.join(root, "blocks", "t"))
    assert port_open(root).type_names == ref_open(root).type_names == []


# -- one on-disk format --------------------------------------------------------

POINT_QUERIES = [
    "INCLUDE",
    "bbox(geom, -80, 30, -60, 50)",
    "bbox(geom, -80, 30, -60, 50) AND dtg DURING 2026-03-02T00:00:00Z/2026-03-04T00:00:00Z",
    "name = 'd3'",
    "bbox(geom, -170, -80, -100, -10) OR bbox(geom, 100, 10, 170, 80)",
]
EXTENT_SPEC = "name:String,dtg:Date,*geom:Geometry:srid=4326"


def _write_extents(store, line_cls, poly_cls):
    rng = np.random.default_rng(31)
    base = np.datetime64("2026-03-01T00:00:00", "ms").astype(np.int64)
    with store.writer("x") as w:
        for i in range(60):
            x, y = float(rng.uniform(-170, 160)), float(rng.uniform(-80, 70))
            g = (poly_cls([[x, y], [x + 5, y], [x + 5, y + 5], [x, y + 5], [x, y]]) if i % 2
                 else line_cls([[x, y], [x + 3, y + 4]]))
            w.write([f"n{i % 3}", int(base + i * 3600_000), g if i % 13 else None], fid=f"x{i}")


def _fill(store, pkg):
    P, L, G = ((Point, None, Polygon) if pkg == "port"
               else (RefPoint, RefLineString, RefPolygon))
    if pkg == "port":
        from geomesa_tpu_torch.geom.base import LineString as L
    ps = parse_spec if pkg == "port" else ref_parse_spec
    store.create_schema(ps("t", SPEC))
    store.create_schema(ps("x", EXTENT_SPEC))
    _write_days(store, point=P)
    _write_extents(store, L, G)
    store.delete_features("t", ["f2-3", "f4-0"])
    store.stats.flush()


def _route(store, res):
    """The route, with the recorded departure of a lone extent query read
    as the reference's: the port's dual route where the reference takes the
    candidate mask (ROADMAP "Deliberate departures")."""
    path = res.plan.scan_path
    if (isinstance(store, FsDataStore) and res.plan.index.name in ("xz2", "xz3")
            and path == "device-batch-dual/runs"):
        return "device-mask/runs"
    return path


def _store_view(store, routes=True):
    out = {"types": store.type_names}
    for name in store.type_names:
        ft = store.get_schema(name)
        out[name] = {"spec": ft.spec(), "count": store.count(name)}
        for q in POINT_QUERIES[:4] if name == "t" else ["INCLUDE", "bbox(geom, -80, 30, -60, 50)",
                                                         "bbox(geom, 0, -60, 90, 10)"]:
            res = store.query(name, q)
            out[name][q] = (sorted(str(f) for f in res.fids), res.plan.index.name,
                            _route(store, res) if routes else None, store.count(name, q))
        stats = store.stats.stats_for(ft)
        out[name]["stats"] = {k: json.loads(v.to_json()) for k, v in stats.items()}
    return out


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_store_opens_in_the_other_package(tmp_path, writer):
    """The on-disk store is one format: the port and the reference read the
    same view of it (schemas, persisted sketches, fid sets, counts, plans,
    routes), eager and lazy, and it is the writer's (the writer's routes
    aside: its batches are not the reader's per-partition blocks); the
    metadata JSON holds the reference's keys."""
    root = str(tmp_path / "store")
    if writer == "reference":
        w = ref_open(root, partition_scheme="daily")
        _fill(w, "ref")
    else:
        w = port_open(root, partition_scheme="daily")
        _fill(w, "port")
    want = _store_view(w, routes=False)
    for lazy in (False, True):
        got_port = _store_view(port_open(root, lazy=lazy))
        got_ref = _store_view(ref_open(root, lazy=lazy))
        assert got_port == got_ref, lazy
        assert _store_view(port_open(root, lazy=lazy), routes=False) == want, lazy
    with open(os.path.join(root, "metadata.json"), "rb") as fh:
        meta = json.loads(fh.read()[:-16].decode())  # the CRC footer stripped
    assert sorted(meta) == ["t", "x"]
    assert sorted(meta["t"]) == ["attributes", "geomesa.vis", "stats"]
    assert meta["t"]["geomesa.vis"] == "false"


def test_port_and_reference_write_the_same_store(tmp_path):
    """The same writes through either package leave the same files: the same
    paths, the same npz keys and dtypes, the same sidecars and registry."""
    roots = {}
    for pkg, opener in (("port", port_open), ("ref", ref_open)):
        roots[pkg] = str(tmp_path / pkg)
        _fill(opener(roots[pkg], partition_scheme="daily"), pkg)

    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _s, fs in os.walk(root) for f in fs)

    assert listing(roots["port"]) == listing(roots["ref"])
    for rel in listing(roots["port"]):
        a, b = (os.path.join(roots[p], rel) for p in ("port", "ref"))
        if rel.endswith(".npz"):
            with np.load(a, allow_pickle=True) as pa, np.load(b, allow_pickle=True) as pb:
                assert pa.files == pb.files, rel
                for k in pa.files:
                    assert pa[k].dtype == pb[k].dtype, (rel, k)
                    if pa[k].dtype != object:
                        assert np.array_equal(pa[k], pb[k]), (rel, k)
                    else:
                        assert [str(v) for v in pa[k]] == [str(v) for v in pb[k]], (rel, k)
        elif rel.endswith((".json", ".txt")):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


# -- lazy loads after the mirror exists ---------------------------------------


def test_lazy_loads_after_the_mirror_exists_answer_on_the_device(tmp_path):
    """Week 1, then week 3, of a lazy daily store of config #1's shape: each
    answer equals brute force and the in-memory store's, on the device
    route; the second load's partitions join the mirror as a new segment
    and move the write generation (no cache answers from before it)."""
    n = 20_000
    x, y, t = cs.synthesize(n, seed=3)
    cols = {"__fid__": np.char.add("f", np.arange(n).astype(str)), "geom__x": x, "geom__y": y,
            "dtg": t}
    root = str(tmp_path / "store")
    w = port_open(root, partition_scheme="daily")
    mem = TorchDataStore(device="cpu")
    for s in (w, mem):
        s.create_schema(parse_spec("gdelt", "dtg:Date,*geom:Point:srid=4326"))
        s._insert_columns(s.get_schema("gdelt"), {k: v.copy() for k, v in cols.items()})
    lazy = port_open(root, lazy=True)
    box = (-100.0, 20.0, -50.0, 60.0)
    weeks = [("2026-01-01", "2026-01-08"), ("2026-01-15", "2026-01-22")]
    gens = []
    for lo, hi in weeks:
        cql = f"{cs.bbox_cql(box)} AND dtg DURING {lo}T00:00:00Z/{hi}T00:00:00Z"
        tlo = np.datetime64(f"{lo}T00:00:00", "ms").astype(np.int64)
        thi = np.datetime64(f"{hi}T00:00:00", "ms").astype(np.int64)
        brute = np.flatnonzero(cs.in_box(x, y, box) & (t > tlo) & (t < thi))
        res = lazy.query("gdelt", cql)
        assert sorted(res.fids) == sorted(cols["__fid__"][brute])
        ref = mem.query("gdelt", cql)
        assert res.scan_path == ref.scan_path and res.scan_path.startswith("device-")
        assert lazy.count("gdelt", cql) == len(brute)
        gens.append(lazy.schema_generation("gdelt"))
        many = lazy.query_many("gdelt", [cql, cql])
        assert [sorted(r.fids) for r in many] == [sorted(res.fids)] * 2
    assert gens[0] != gens[1]
    # eight days a week: DURING's covering includes its upper bound's day
    assert len(lazy._loaded["gdelt"]) == 16
    dev = lazy.executor.device_index(lazy._tables["gdelt"]["z3"])
    assert len(dev.segments) == 2  # the second load joined as a segment


def test_a_reopened_extent_store_builds_its_dual_planes(tmp_path):
    """Config #3's ways (geometry objects pickled under the reference's
    class names) reopen with their xz planes: streams (a)-(e) equal the
    oracle and the in-memory store's routes."""
    ways = cs.synthesize_ways(3000, seed=5)
    cols = cs.ways_columns(ways)
    root = str(tmp_path / "store")
    w = port_open(root)
    mem = TorchDataStore(device="cpu")
    for s in (w, mem):
        s.create_schema(parse_spec("ways", cs.WAYS_SPEC))
        s._insert_columns(s.get_schema("ways"), dict(cols))
    streams = cs.xz_streams(reps=3, tris=1, resid=2)
    for store in (port_open(root), ref_open(root)):
        for name, items in streams.items():
            for cql, spec in items:
                res = store.query("ways", cql)
                want = cols["__fid__"][cs.oracle_rows(ways, *spec)]
                assert sorted(str(f) for f in res.fids) == sorted(want), (name, cql)
                if isinstance(store, FsDataStore):
                    assert res.scan_path == mem.query("ways", cql).scan_path, cql


def test_fs_store_join_with_lazy_replay(tmp_path):
    """query_join on a file store: the build side's lazy load lands inside
    the join, the build caches under the generation it read (a hit on the
    second join), and a reopened store answers the same pairs as the
    reference's."""
    zones = [[[0, 0], [5, 0], [5, 10], [0, 10], [0, 0]],
             [[5, 0], [10, 0], [10, 10], [5, 10], [5, 0]],
             [[20, 20], [30, 20], [25, 30], [20, 20]]]
    rng = np.random.default_rng(4)
    n = 150
    cols = {"__fid__": np.array([f"e{i}" for i in range(n)], dtype=object),
            "kind": np.array([f"k{i % 3}" for i in range(n)], dtype=object),
            "geom__x": rng.uniform(-5, 35, n), "geom__y": rng.uniform(-5, 35, n),
            "dtg": np.full(n, 1767225600000, dtype=np.int64)}

    def fill(store, ps, poly):
        store.create_schema(ps("events", "kind:String,dtg:Date,*geom:Point:srid=4326"))
        store._insert_columns(store.get_schema("events"), {k: v.copy() for k, v in cols.items()})
        store.create_schema(ps("zones", "zname:String,*geom:Polygon:srid=4326"))
        with store.writer("zones") as w:
            for i, p in enumerate(zones):
                w.write([f"z{i}", poly(p)], fid=f"g{i}")

    root = str(tmp_path / "store")
    s1 = port_open(root)
    fill(s1, parse_spec, Polygon)
    first = s1.query_join("zones", "events", predicate="contains")
    assert first.stats["build"] == "rebuild"
    again = s1.query_join("zones", "events", predicate="contains")
    assert again.stats["build"] == "hit" and again.pairs() == first.pairs()
    ref_root = str(tmp_path / "ref")
    fill(ref_open(ref_root), ref_parse_spec, RefPolygon)
    want = ref_open(ref_root).query_join("zones", "events", predicate="contains").pairs()
    assert sorted(first.pairs()) == sorted(want)
    for lazy in (False, True):
        s2 = port_open(root, lazy=lazy)
        r1 = s2.query_join("zones", "events", predicate="contains")
        assert r1.pairs() == first.pairs()
        r2 = s2.query_join("zones", "events", predicate="contains")
        assert r2.stats["build"] == "hit"
