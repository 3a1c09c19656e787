"""The port's stats push-down and stats reducer against the JAX package, on
the CPU.

Mirrors ``tests/test_device_stats.py``: the same columns go into the
reference's host store (``HostScanExecutor``), the reference's device store
(a one-device CPU mesh) and the port's ``TorchDataStore(device="cpu")``
with ``GEOMESA_STATS_DEVICE=1`` (and the reference's
``GEOMESA_EXACT_DEVICE=1``). For every spec there, the port's stat JSON
on its device path (``scan_path`` = ``device-stats``) and on its host path
(``GEOMESA_STATS_DEVICE=0``: rows extracted, ``run_stats``) equals the
reference's, MinMax's hyperloglog registers included; the port declines
where the reference does. The one tolerance: ``DescriptiveStats`` on the
store path, whose mean and M2 are float sums over the rows in scan order,
which may differ between the packages (relative 1e-12; its count exact).

Module level: ``parse_stat`` and ``run_stats`` against the reference's over
its spec grammar (GroupBy, Z3Histogram, Z3Frequency, DescriptiveStats,
MinMax of the geometry), JSON for JSON, and ``exact_stat_hist_plain`` (the
plain edition of the histogram kernel) against ``_exact_stat_hist_fn``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from geomesa_tpu.index import aggregators as ref_agg
from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.ops import zkernels as ref_z
from geomesa_tpu.parallel import executor as ref_ex
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.stats import parser as ref_parser
from geomesa_tpu.stats import sketches as ref_sk
from geomesa_tpu.store.datastore import HostScanExecutor, TpuDataStore

from geomesa_tpu_torch.index import aggregators as port_agg
from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops import zkernels as Z
from geomesa_tpu_torch.parallel import executor as port_ex
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.stats import parser as port_parser
from geomesa_tpu_torch.stats import sketches as port_sk
from geomesa_tpu_torch.store.datastore import TorchDataStore

SPEC = "actor:String,val:Double,age:Int,dtg:Date,*geom:Point:srid=4326"
CQL = (
    "bbox(geom, -20, -20, 20, 20) AND "
    "dtg DURING 2026-01-02T00:00:00Z/2026-01-12T00:00:00Z"
)


@pytest.fixture(autouse=True)
def _force_device_stats(monkeypatch):
    monkeypatch.setenv("GEOMESA_STATS_DEVICE", "1")
    monkeypatch.setenv("GEOMESA_EXACT_DEVICE", "1")


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("shards",))


def _columns(n=4000, seed=31):
    rng = np.random.default_rng(seed)
    base = np.datetime64("2026-01-01T00:00:00", "ms").astype("int64")
    nulls = rng.random(n) < 0.05
    vals = rng.uniform(0, 10, n)
    return {
        "__fid__": np.array([f"f{i}" for i in range(n)], dtype=object),
        "geom__x": rng.uniform(-50, 50, n),
        "geom__y": rng.uniform(-50, 50, n),
        "dtg": base + rng.integers(0, 20 * 86400, n) * 1000,
        "actor": np.array([["USA", "FRA", "CHN", "BRA", "IND"][i % 5] for i in range(n)],
                          dtype=object),
        "val": np.where(nulls, np.nan, vals),
        "val__null": nulls,
        "age": rng.integers(0, 90, n).astype(np.int32),
    }


def _fill(store, parse):
    ft = parse("st", SPEC)
    store.create_schema(ft)
    store._insert_columns(ft, {k: v.copy() for k, v in _columns().items()})
    return ft


@pytest.fixture(scope="module")
def stores():
    host = TpuDataStore(executor=HostScanExecutor())
    _fill(host, ref_parse_spec)
    tpu = TpuDataStore(executor=TpuScanExecutor(_mesh()))
    _fill(tpu, ref_parse_spec)
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    _fill(port, parse_spec)
    return host, tpu, port


SPECS = [
    "Count()",
    "MinMax(actor)",
    "MinMax(val)",
    "MinMax(dtg)",
    "Enumeration(actor)",
    "Enumeration(age)",
    "TopK(actor)",
    "Histogram(val,20,0,10)",
    "Frequency(actor)",
    "Count();MinMax(dtg);TopK(actor)",
    "MinMax(age);Enumeration(actor);Count()",
    "GroupBy(actor,Count())",
    "GroupBy(age,Count());Count()",
]


def _state(res):
    return res.aggregate["stats"].to_json()


@pytest.mark.parametrize("spec", SPECS)
def test_device_stats_state_equals_host(stores, monkeypatch, spec):
    host, tpu, port = stores
    want = host.query("st", RefQuery.cql(CQL, hints={"stats": spec}))
    assert want.plan.scan_path != "device-stats"
    ref_dev = tpu.query("st", RefQuery.cql(CQL, hints={"stats": spec}))
    assert ref_dev.plan.scan_path == "device-stats"
    got = port.query("st", Query.cql(CQL, hints={"stats": spec}))
    assert got.plan.scan_path == "device-stats", got.plan.scan_path
    assert _state(got) == _state(want) == _state(ref_dev)
    monkeypatch.setenv("GEOMESA_STATS_DEVICE", "0")
    got = port.query("st", Query.cql(CQL, hints={"stats": spec}))
    assert got.plan.scan_path != "device-stats"
    assert _state(got) == _state(want)


def test_device_stats_bbox_only_leg(stores):
    host, _tpu, port = stores
    cql = "bbox(geom, -20, -20, 20, 20)"
    got = port.query("st", Query.cql(cql, hints={"stats": "MinMax(actor);Count()"}))
    assert got.plan.scan_path == "device-stats"
    want = host.query("st", RefQuery.cql(cql, hints={"stats": "MinMax(actor);Count()"}))
    assert _state(got) == _state(want)


def _descriptive_close(got: str, want: str) -> None:
    """DescriptiveStats' n exactly, its float sums to 1e-12 (row order)."""
    g, w = json.loads(got), json.loads(want)
    assert g["kind"] == w["kind"] == "descriptive" and g["n"] == w["n"]
    assert g["mean"] == pytest.approx(w["mean"], rel=1e-12)
    assert g["m2"] == pytest.approx(w["m2"], rel=1e-12)


@pytest.mark.parametrize(
    "spec",
    [
        "GroupBy(actor,MinMax(val))",  # joint distribution: host path
        "MinMax(geom)",  # geometry bounds: host path
        "DescriptiveStats(val)",  # moment stats: host path
    ],
)
def test_device_stats_declines_to_host(stores, spec):
    host, tpu, port = stores
    got = port.query("st", Query.cql(CQL, hints={"stats": spec}))
    assert got.plan.scan_path != "device-stats"
    assert tpu.query("st", RefQuery.cql(CQL, hints={"stats": spec})).plan.scan_path != \
        "device-stats"
    want = host.query("st", RefQuery.cql(CQL, hints={"stats": spec}))
    if spec.startswith("Descriptive"):
        _descriptive_close(_state(got), _state(want))
    else:
        assert _state(got) == _state(want)


def test_device_stats_declines_on_attr_filter(stores):
    host, _tpu, port = stores
    cql = CQL + " AND actor = 'USA'"
    got = port.query("st", Query.cql(cql, hints={"stats": "Count();MinMax(val)"}))
    assert got.plan.scan_path != "device-stats"
    want = host.query("st", RefQuery.cql(cql, hints={"stats": "Count();MinMax(val)"}))
    assert _state(got) == _state(want)


def test_minmax_hll_registers_identical(stores):
    host, _tpu, port = stores
    h = host.query("st", RefQuery.cql(CQL, hints={"stats": "MinMax(actor)"})).aggregate["stats"]
    d = port.query("st", Query.cql(CQL, hints={"stats": "MinMax(actor)"})).aggregate["stats"]
    np.testing.assert_array_equal(d.registers, h.registers)
    assert (d.min, d.max) == (h.min, h.max)


def test_negative_zero_hashes_as_value_equality():
    """-0.0 and 0.0 hash alike in the port's sketches, as in the
    reference's (the device rebuild sees the value set only)."""
    assert port_sk._hash64(np.array([-0.0])) == port_sk._hash64(np.array([0.0]))
    assert port_sk._hash64(np.array([-0.0, 2.5, 7.0])).tolist() == \
        ref_sk._hash64(np.array([-0.0, 2.5, 7.0])).tolist()
    a, b = port_sk.MinMax("v"), port_sk.MinMax("v")
    a.observe(np.array([-0.0, 1.5]))
    b.observe(np.array([0.0, -0.0, 1.5]))
    np.testing.assert_array_equal(a.registers, b.registers)
    fa, fb = port_sk.Frequency("v"), port_sk.Frequency("v")
    fa.observe(np.array([-0.0, 0.0]))
    fb.observe(np.array([0.0, 0.0]))
    np.testing.assert_array_equal(fa.table, fb.table)


def test_device_stats_declines_over_vocab_cap(stores, monkeypatch):
    host, _tpu, _port = stores
    monkeypatch.setattr(port_ex.DeviceSegment, "ATTR_VOCAB_MASK_CAP", 4)
    port2 = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    _fill(port2, parse_spec)
    got = port2.query("st", Query.cql(CQL, hints={"stats": "MinMax(val)"}))
    assert got.plan.scan_path != "device-stats"
    want = host.query("st", RefQuery.cql(CQL, hints={"stats": "MinMax(val)"}))
    assert _state(got) == _state(want)


def test_device_stats_declines_on_transform(stores):
    """A computed property: the device path declines and the host path
    aggregates the transformed values, in the reference and in the port."""
    host, tpu, port = stores
    props = ["doubled=multiply($val, 2)"]
    rq = RefQuery.cql(CQL, properties=props, hints={"stats": "MinMax(doubled)"})
    assert tpu.query("st", rq).plan.scan_path != "device-stats"
    want = host.query("st", rq).aggregate["stats"]
    assert want.max is not None
    got = port.query("st", Query.cql(CQL, properties=props, hints={"stats": "MinMax(doubled)"}))
    assert got.scan_path != "device-stats"
    assert _state(got) == _state(host.query("st", rq))
    assert (got.aggregate["stats"].min, got.aggregate["stats"].max) == (want.min, want.max)


def test_stats_stream_through_query_many(stores):
    """A stats query in a stream is left out of the batched row dispatch
    and answers on its push-down; the row queries beside it stay equal."""
    host, _tpu, port = stores
    # other filters than the stats query's: a cached plan records the last
    # route its filter took
    cqls = ["bbox(geom, -12, -10, 10, 10)", "bbox(geom, -10, -10, 10, 10)"]
    got = port.query_many("st", [Query.cql(CQL, hints={"stats": "TopK(actor)"})]
                          + [Query.cql(c) for c in cqls])
    assert got[0].plan.scan_path == "device-stats"
    assert _state(got[0]) == _state(host.query("st", RefQuery.cql(
        CQL, hints={"stats": "TopK(actor)"})))
    for res, cql in zip(got[1:], cqls):
        assert set(res.fids.tolist()) == set(host.query("st", cql).fids.tolist())


# -- the parser and the reducer against the reference's ----------------------------


GRAMMAR = [
    "Count()",
    "MinMax(val)",
    "MinMax('actor')",
    "Enumeration(actor)",
    "TopK(actor,3)",
    "Histogram(val,16,0,10)",
    "Frequency(actor,64)",
    "DescriptiveStats(val)",
    "Z3Histogram(geom,dtg,week,1024)",
    "Z3Histogram(geom,dtg,day,64)",
    "Z3Frequency(geom,dtg)",
    "Z3Frequency(geom,dtg,day,21,128)",
    "GroupBy(actor,Count())",
    "GroupBy(actor,MinMax(val))",
    "GroupBy(age,TopK(actor))",
    "MinMax(geom)",
    "Count();MinMax(geom);GroupBy(actor,Enumeration(age));Z3Histogram(geom,dtg,week,256)",
]


@pytest.mark.parametrize("spec", GRAMMAR)
def test_parse_stat_equals_the_reference(spec):
    assert port_parser.parse_stat(spec).to_json() == ref_parser.parse_stat(spec).to_json()


@pytest.mark.parametrize("bad", ["Nope(a)", "MinMax", "Count(;"])
def test_parse_stat_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        ref_parser.parse_stat(bad)
    with pytest.raises(ValueError):
        port_parser.parse_stat(bad)


@pytest.mark.parametrize("spec", GRAMMAR)
def test_run_stats_equals_the_reference(spec):
    """The host reducer over the same columns (nulls, NaN, a dictionary
    column and its vocab): equal JSON state."""
    cols = _columns(1500, 5)
    codes = np.searchsorted(np.array(["BRA", "CHN", "FRA", "IND", "USA"]),
                            cols["actor"].astype(str)).astype(np.int32)
    codes[::13] = -1
    dict_cols = dict(cols, actor=codes,
                     actor__vocab=np.array(["BRA", "CHN", "FRA", "IND", "USA"], dtype=object))
    for columns in (cols, dict_cols):
        ref_ft = ref_parse_spec("st", SPEC)
        port_ft = parse_spec("st", SPEC)
        want = ref_agg.run_stats(ref_ft, spec, {k: v.copy() for k, v in columns.items()})
        got = port_agg.run_stats(port_ft, spec, {k: v.copy() for k, v in columns.items()})
        assert got.to_json() == want.to_json()
        assert port_sk.from_json(got.to_json()).to_json() == got.to_json()


def test_sketch_merge_equals_the_reference():
    """Merging two observed halves gives the reference's state (the shard
    reduce of the sketches), for every kind."""
    cols = _columns(2000, 9)
    ref_ft = ref_parse_spec("st", SPEC)
    port_ft = parse_spec("st", SPEC)
    spec = ("Count();MinMax(val);Enumeration(actor);TopK(actor);Histogram(val,8,0,10);"
            "Frequency(actor);DescriptiveStats(val);MinMax(geom);GroupBy(actor,Count());"
            "Z3Histogram(geom,dtg,week,64);Z3Frequency(geom,dtg)")
    halves = [{k: v[:1000] for k, v in cols.items()}, {k: v[1000:] for k, v in cols.items()}]
    want = [ref_agg.run_stats(ref_ft, spec, h) for h in halves]
    got = [port_agg.run_stats(port_ft, spec, h) for h in halves]
    assert (got[0] + got[1]).to_json() == (want[0] + want[1]).to_json()


# -- the plain edition of the histogram kernel against _exact_stat_hist_fn ------------


@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("vocab,u_pad", [(5, 8), (3, 64), (200, 256), (1, 8)])
def test_exact_stat_hist_plain_equals_the_reference(vocab, u_pad, has_time):
    """Total hits then per-code hits: null codes (-1) count in the total
    only, u_pad past the vocab leaves empty bins, pad rows stay out."""
    n = 8192
    rng = np.random.default_rng(vocab + u_pad)
    t0 = np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64)
    x, y = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
    t = t0 + rng.integers(0, 10 * 86_400_000, n)
    valid = np.ones(n, dtype=bool)
    valid[n - 64:] = False
    tvalid = valid.copy()
    tvalid[100:140] = False
    codes = rng.integers(0, vocab, n).astype(np.int32)
    codes[rng.random(n) < 0.1] = -1
    codes[n - 64:] = -1

    def limbs(keys):
        hi, lo = ref_z.split_u64_to_limbs(keys)
        return jnp.asarray(hi), jnp.asarray(lo)

    xh, xl = limbs(ref_z.f64_sort_keys(x))
    yh, yl = limbs(ref_z.f64_sort_keys(y))
    th, tl = limbs(ref_z.i64_sort_keys(t))
    fn = ref_ex._exact_stat_hist_fn(has_time, "local", _mesh(), u_pad)
    for shape in [(-5.0, -5.0, 5.0, 5.0, t0, t0 + 4 * 86_400_000),
                  (100.0, 100.0, 101.0, 101.0, t0, t0 + 86_400_000),
                  (-20.0, -20.0, 20.0, 20.0, None, t0 + 9 * 86_400_000)]:
        shape = shape if has_time else shape[:4] + (None, None)
        rbox, rwin = TpuScanExecutor._shape_limbs(shape)
        args = [xh, xl, yh, yl] + ([th, tl, jnp.asarray(tvalid)] if has_time
                                   else [jnp.asarray(valid)]) + [jnp.asarray(rbox)]
        if has_time:
            args.append(jnp.asarray(rwin))
        want = np.asarray(fn(jnp.asarray(codes), *args))
        box, win = TorchScanExecutor._shape_keys(shape)
        got = kernels.exact_stat_hist(
            torch.from_numpy(Z.f64_keys(x)), torch.from_numpy(Z.f64_keys(y)),
            torch.from_numpy(t) if has_time else None,
            torch.from_numpy(tvalid if has_time else valid), torch.from_numpy(box),
            torch.from_numpy(win) if has_time else None, torch.from_numpy(codes), u_pad)
        assert got.dtype == torch.int32 and got.shape == (1 + u_pad,)
        assert np.array_equal(got.numpy(), want), shape
