"""The port's slice as a whole against the JAX package, on the CPU.

The same GDELT-style columns (bench.py ``synthesize``, ~50k rows) go into
the reference ``TpuDataStore(executor=TpuScanExecutor(...))`` on a
one-device CPU mesh, run as on an accelerator (exact device predicate,
batched dispatch, the bitmap protocol, no host seek), and into the port's
``TorchDataStore(executor=TorchScanExecutor(device="cpu"))``. Every query's
fids must be equal, and equal to a numpy brute-force scan. A
``segment_from_reference`` case feeds both implementations one segment's
state and compares their masks. Exact equality throughout.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import bench
from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.ops import filters as ref_filters
from geomesa_tpu.parallel import executor as ref_ex
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.parallel.executor import (
    TorchScanExecutor,
    segment_from_reference,
)
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore

N = 50_000
SPEC = "dtg:Date,*geom:Point:srid=4326"
BOX_B = (0.0, 46.0, 5.0, 50.0)
REF_ENV = {
    "GEOMESA_EXACT_DEVICE": "1",
    "GEOMESA_DEVBATCH": "1",
    "GEOMESA_BATCH_PROTO": "bitmap",
    "GEOMESA_SEEK": "0",
}


@pytest.fixture(scope="module", autouse=True)
def _env():
    """One torch thread (the suite runs in parallel workers beside
    timing-sensitive tests) and the reference's accelerator-path knobs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_ENV.items():
            mp.setenv(k, v)
        yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def data():
    x, y, t = bench.synthesize(N)
    # a few rows on the base query's edges and DURING bounds ±1 ms
    x[:6] = [-80.0, -70.0, -75.0, -75.0, -75.0, -75.0]
    y[:6] = [38.0, 38.0, 36.0, 41.0, 38.0, 38.0]
    t[:6] = [bench.T_LO + 1, bench.T_HI - 1, bench.T_LO + 5, bench.T_HI - 5,
             bench.T_LO, bench.T_HI]
    fids = np.char.add("f", np.arange(N).astype(f"<U{len(str(N - 1))}"))
    return {"__fid__": fids, "geom__x": x, "geom__y": y, "dtg": t}


@pytest.fixture(scope="module")
def stores(data, _env):
    ref = TpuDataStore(
        executor=TpuScanExecutor(Mesh(np.asarray(jax.devices()[:1]), ("shards",)))
    )
    ref_ft = ref_parse_spec("gdelt", SPEC)
    ref.create_schema(ref_ft)
    ref._insert_columns(ref_ft, dict(data))
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    ft = parse_spec("gdelt", SPEC)
    port.create_schema(ft)
    port._insert_columns(ft, dict(data))
    return ref, port


def _in_box(data, box):
    x, y = data["geom__x"], data["geom__y"]
    return (x >= box[0]) & (x <= box[2]) & (y >= box[1]) & (y <= box[3])


def _during(data):
    t = data["dtg"]
    return (t > bench.T_LO) & (t < bench.T_HI)


def _bbox(b) -> str:
    return f"bbox(geom, {b[0]!r}, {b[1]!r}, {b[2]!r}, {b[3]!r})"


def _same(ref_res, port_res, want_rows):
    got = np.sort(port_res.fids.astype(str))
    assert np.array_equal(got, np.sort(ref_res.fids.astype(str)))
    assert np.array_equal(got, np.sort(np.char.add("f", want_rows.astype(str))))


def test_config1_query(stores, data):
    ref, port = stores
    res = port.query("gdelt", bench.QUERY)
    want = ref.query("gdelt", bench.QUERY)
    assert res.plan.index.name == "z3" and res.plan.scan_path == "device-exact/runs"
    assert res.plan.scan_path == want.plan.scan_path
    _same(want, res,
          np.flatnonzero(_in_box(data, bench.BOX) & _during(data)))


def test_config1_query_many(stores, data):
    ref, port = stores
    boxes, cqls = bench.make_queries(20)
    got = port.query_many("gdelt", [Query.cql(c, properties=[]) for c in cqls])
    want = ref.query_many("gdelt", [RefQuery.cql(c, properties=[]) for c in cqls])
    for b, r, p in zip(boxes, want, got):
        assert p.plan.scan_path == r.plan.scan_path == "device-exact/bitmap"
        assert set(p.columns) == {"__fid__"}
        _same(r, p, np.flatnonzero(_in_box(data, b) & _during(data)))


@pytest.mark.parametrize("seek", ["0", "1"])
def test_lazy_result_gathers_only_when_read(stores, data, monkeypatch, seek):
    """A plain fid-only ``query_many`` (device route, or the host seek's
    C++ scan) returns lazy columns: no block gather until ``.fids`` is
    read, none for ``len(result)``, and one per part then."""
    from geomesa_tpu_torch.store import blocks
    from geomesa_tpu_torch.store.datastore import LazyColumns

    ref, port = stores
    monkeypatch.setenv("GEOMESA_SEEK", seek)
    calls = []
    orig = blocks.FeatureBlock.gather

    def spy(self, k, rows, record_rows=None):
        calls.append(k)
        return orig(self, k, rows, record_rows)

    monkeypatch.setattr(blocks.FeatureBlock, "gather", spy)
    boxes, cqls = bench.make_queries(6)
    got = port.query_many("gdelt", [Query.cql(c, properties=[]) for c in cqls])
    assert {p.plan.scan_path for p in got} == (
        {"device-exact/bitmap"} if seek == "0" else {"host-seek"})
    assert all(isinstance(p.columns, LazyColumns) for p in got)
    sizes = [len(p) for p in got]
    assert calls == [] and min(sizes) > 0
    monkeypatch.setenv("GEOMESA_SEEK", "0")
    want = ref.query_many("gdelt", [RefQuery.cql(c, properties=[]) for c in cqls])
    for b, r, p, n in zip(boxes, want, got, sizes):
        _same(r, p, np.flatnonzero(_in_box(data, b) & _during(data)))
        assert len(p.fids) == n == len(r)
    assert calls and set(calls) == {"__fid__"}
    assert len(calls) == sum(len(p.columns._parts) for p in got)


@pytest.mark.parametrize("options", ["plain", "projected", "sorted", "limited"])
def test_materialized_columns_equal_the_reference(stores, options):
    """Every column of a result, lazy or materialized by sort or limit,
    equals the reference's, key for key and row for row."""
    from geomesa_tpu.store.datastore import _materialize as ref_materialize
    from geomesa_tpu_torch.store.datastore import LazyColumns, _materialize

    ref, port = stores
    kw = {"plain": {}, "projected": {"properties": ["dtg"]},
          "sorted": {"sort_by": [("dtg", False)]}, "limited": {"max_features": 7}}[options]
    res = port.query("gdelt", Query.cql(bench.QUERY, **kw))
    want = ref.query("gdelt", RefQuery.cql(bench.QUERY, **kw))
    assert isinstance(res.columns, LazyColumns) == (options in ("plain", "projected"))
    got, exp = _materialize(res.columns), ref_materialize(want.columns)
    assert set(got) == set(exp) and len(res) == len(want) > 0
    if options in ("plain", "projected"):  # row order may differ: key by fid
        o, r = np.argsort(got["__fid__"].astype(str)), np.argsort(exp["__fid__"].astype(str))
    else:
        o = r = slice(None)
    for k in exp:
        assert np.array_equal(got[k][o], exp[k][r]), k


def _or_queries(k: int):
    a = bench.make_queries(k)[0]
    rng = np.random.default_rng(5)
    b = [tuple(float(round(v + d, 3)) for v, d in zip(BOX_B, np.tile(rng.uniform(-1, 1, 2), 2)))
         for _ in range(k)]
    return list(zip(a, b))


@pytest.mark.parametrize("kind", ["bbox", "or_dtg", "or", "empty", "dtg_only_edge"])
def test_query_shapes(stores, data, kind):
    ref, port = stores
    if kind == "bbox":
        box = (-79.0, 37.0, -71.0, 40.0)
        cqls = [_bbox(box)]
        wants = [_in_box(data, box)]
        index, path = "z2", "device-exact/runs"
    elif kind in ("or_dtg", "or"):
        pairs = _or_queries(3)
        if kind == "or_dtg":
            cqls = [f"({_bbox(a)} OR {_bbox(b)}) AND {bench.DURING}" for a, b in pairs]
            wants = [(_in_box(data, a) | _in_box(data, b)) & _during(data) for a, b in pairs]
            index = "z3"
        else:
            cqls = [f"{_bbox(a)} OR {_bbox(b)}" for a, b in pairs]
            wants = [_in_box(data, a) | _in_box(data, b) for a, b in pairs]
            index = "z2"
        path = "device-mask/runs"
    elif kind == "empty":
        box = (150.0, -80.0, 151.0, -79.0)
        cqls = [f"{_bbox(box)} AND dtg DURING 2030-01-01T00:00:00Z/2030-01-02T00:00:00Z"]
        wants = [np.zeros(N, dtype=bool)]
        index = path = None
    else:  # the DURING bounds are exclusive: rows at T_LO / T_HI drop
        box = (-80.0, 36.0, -70.0, 41.0)
        cqls = [f"{_bbox(box)} AND {bench.DURING}"]
        wants = [_in_box(data, box) & _during(data)]
        index, path = "z3", "device-exact/runs"
    for cql, want in zip(cqls, wants):
        res = port.query("gdelt", cql)
        ref_res = ref.query("gdelt", cql)
        if index is not None:
            assert (res.plan.index.name, res.plan.scan_path) == (index, path)
            assert res.plan.scan_path == ref_res.plan.scan_path
        _same(ref_res, res, np.flatnonzero(want))
    # and the same queries as one pipelined stream
    for cql, p, r, want in zip(cqls, port.query_many("gdelt", cqls),
                               ref.query_many("gdelt", cqls), wants):
        _same(r, p, np.flatnonzero(want))


def _ref_segment(ref, index: str):
    table = ref._tables["gdelt"][index]
    seg = ref.executor.device_index(table).segments[0]
    seg.load_exact(table)
    names = ["xi", "yi", "valid", "xk_hi", "xk_lo", "yk_hi", "yk_lo"]
    if index == "z3":
        names += ["bins", "ti", "tk_hi", "tk_lo", "tvalid"]
    return seg, {k: np.asarray(getattr(seg, k)) for k in names}


def test_query_many_profiler_ranges_split_the_host_steps(stores):
    """A profiler trace of a config #1 stream holds each host step's range
    once per occurrence, and the traced stream answers as the untraced one."""
    from torch.profiler import ProfilerActivity, profile

    _ref, port = stores
    queries = [Query.cql(c, properties=[]) for c in bench.make_queries(4)[1]]
    want = [np.sort(r.fids.astype(str)) for r in port.query_many("gdelt", queries)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = port.query_many("gdelt", queries)
    counts = {e.key: e.count for e in prof.key_averages() if e.key.startswith("geomesa.")}
    assert counts["geomesa.plan"] == 1 and counts["geomesa.dispatch"] == 1
    assert counts["geomesa.assemble"] == len(queries)
    assert counts["geomesa.decode"] >= len(queries)
    assert counts["geomesa.fetch"] >= 1 and counts["geomesa.block_rows"] >= len(queries)
    assert "geomesa.post_filter" not in counts  # the exact route skips it
    for g, w in zip(got, want):
        assert np.array_equal(np.sort(g.fids.astype(str)), w)


def test_segment_from_reference_gives_equal_masks(stores):
    ref, _port = stores
    seg, arrays = _ref_segment(ref, "z3")
    pseg = segment_from_reference(arrays, "cpu")
    assert pseg.n_padded == seg.n_padded
    # the candidate mask of an OR residual query, on identical state
    plan = ref._plan_cached("gdelt", RefQuery.cql(
        f"({_bbox(bench.BOX)} OR {_bbox(BOX_B)}) AND {bench.DURING}"))
    boxes, windows = (np.array(a) for a in ref.executor._query_descriptor(
        ref._tables["gdelt"]["z3"], plan))
    want = np.asarray(ref_filters.z3_query_mask(
        arrays["xi"], arrays["yi"], arrays["bins"], arrays["ti"], arrays["valid"],
        boxes, windows))
    got = kernels.candidate_mask(pseg.xi, pseg.yi, pseg.valid, torch.from_numpy(boxes),
                                 pseg.bins, pseg.ti, torch.from_numpy(windows))
    assert np.array_equal(got.numpy(), want) and want.any()
    # the exact bitmaps + framing of the config #1 stream
    boxes_q, cqls = bench.make_queries(8)
    shapes = [b + (int(bench.T_LO) + 1, int(bench.T_HI) - 1) for b in boxes_q]
    ref_descs = [TpuScanExecutor._shape_limbs(s) for s in shapes]
    span_cap = seg.n_padded // 2
    fn = ref_ex._exact_bitmap_batch_fn(True, span_cap, len(shapes), "local", seg.mesh)
    want_hdr, want_bits = (np.asarray(a) for a in fn(
        seg.xk_hi, seg.xk_lo, seg.yk_hi, seg.yk_lo, seg.tk_hi, seg.tk_lo, seg.tvalid,
        np.stack([d[0] for d in ref_descs]), np.stack([d[1] for d in ref_descs])))
    descs = [TorchScanExecutor._shape_keys(s) for s in shapes]
    bits, hdr = kernels.exact_bitmap(
        pseg.xk, pseg.yk, pseg.tk, pseg.tvalid,
        torch.from_numpy(np.stack([d[0] for d in descs])),
        torch.from_numpy(np.stack([d[1] for d in descs])))
    got_hdr, got_bits = kernels.frame_bitmaps(bits, hdr, span_cap)
    assert np.array_equal(got_hdr.numpy(), want_hdr)
    assert np.array_equal(got_bits.numpy(), want_bits)
    assert (want_hdr[:, 0] > 0).all()


def test_segment_from_reference_z2_exact(stores):
    ref, _port = stores
    seg, arrays = _ref_segment(ref, "z2")
    pseg = segment_from_reference(arrays, "cpu")
    assert pseg.kind == "z2" and pseg.tk is None
    shape = bench.BOX + (None, None)
    box_l, _ = TpuScanExecutor._shape_limbs(shape)
    want = np.asarray(ref_filters.exact_st_mask(
        arrays["xk_hi"], arrays["xk_lo"], arrays["yk_hi"], arrays["yk_lo"], arrays["valid"],
        box_l))
    rows = pseg.dispatch_exact(torch.from_numpy(TorchScanExecutor._shape_keys(shape)[0]),
                               None).rows()
    assert np.array_equal(rows, np.flatnonzero(want)) and len(rows)


def test_writer_rows_match_reference():
    """Row-at-a-time writes (several flushed blocks, a null date) answer like
    the reference on both device routes."""
    from geomesa_tpu.geom.base import Point as RefPoint
    from geomesa_tpu_torch.geom.base import Point

    rng = np.random.default_rng(8)
    rows = [(f"w{i}", rng.uniform(-80, -70), rng.uniform(36, 41),
             None if i % 17 == 0 else int(bench.T_LO + rng.integers(-5, 20) * 86_400_000))
            for i in range(300)]
    ref = TpuDataStore(executor=TpuScanExecutor(Mesh(np.asarray(jax.devices()[:1]), ("shards",))))
    ref.create_schema(ref_parse_spec("w", SPEC))
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    port.create_schema(parse_spec("w", SPEC))
    for store, point, flush in ((ref, RefPoint, 64), (port, Point, 64)):
        with store.writer("w", flush_size=flush) as w:
            for fid, x, y, t in rows:
                w.write([t, point(x, y)], fid=fid)
    assert len(port._tables["w"]["z3"].blocks) == 5
    for cql in [f"bbox(geom, -78.0, 37.0, -72.0, 40.0) AND {bench.DURING}",
                "bbox(geom, -78.0, 37.0, -72.0, 40.0)",
                f"(bbox(geom, -78.0, 37.0, -75.0, 40.0) OR bbox(geom, -74.0, 37.0, -72.0, 40.0))"
                f" AND {bench.DURING}"]:
        got = np.sort(port.query("w", cql).fids.astype(str))
        assert np.array_equal(got, np.sort(ref.query("w", cql).fids.astype(str)))
        assert len(got)


def test_incremental_segments_match_reference():
    """Writes between queries: each batch becomes a new device segment,
    and past MAX_SEGMENTS the mirror rebuilds as one merged segment; every
    answer on the way equals the reference's."""
    from geomesa_tpu_torch.parallel.executor import MAX_SEGMENTS

    rng = np.random.default_rng(12)
    ref = TpuDataStore(executor=TpuScanExecutor(Mesh(np.asarray(jax.devices()[:1]), ("shards",))))
    ref_ft = ref_parse_spec("inc", SPEC)
    ref.create_schema(ref_ft)
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    ft = parse_spec("inc", SPEC)
    port.create_schema(ft)
    cqls = [bench.QUERY, _bbox(bench.BOX),
            f"({_bbox(bench.BOX)} OR {_bbox(BOX_B)}) AND {bench.DURING}"]
    seen = []
    for batch in range(MAX_SEGMENTS + 2):
        n = 300
        cols = {
            "__fid__": np.char.add(f"b{batch}_", np.arange(n).astype(str)),
            "geom__x": rng.uniform(-82, 6, n),
            "geom__y": rng.uniform(34, 52, n),
            "dtg": bench.T_LO + rng.integers(-3, 17, n) * 86_400_000,
        }
        ref._insert_columns(ref_ft, dict(cols))
        port._insert_columns(ft, dict(cols))
        got = port.query_many("inc", cqls)
        for cql, p, r in zip(cqls, got, ref.query_many("inc", cqls)):
            assert np.array_equal(np.sort(p.fids.astype(str)), np.sort(r.fids.astype(str))), cql
        dev = port.executor.device_index(port._tables["inc"]["z3"])
        seen.append(len(dev.segments))
    assert seen[:MAX_SEGMENTS] == list(range(1, MAX_SEGMENTS + 1))
    assert seen[MAX_SEGMENTS] == 1  # merged rebuild past the fragmentation limit


@pytest.mark.parametrize("pattern", ["escalate", "dense"])
def test_span_and_run_capacity_fallbacks(pattern):
    """A span wider than the bitmap window refetches that query alone as
    runs; runs past the capacity escalate it, and past the dense
    break-even (n/64 runs) fetch its packed bitmap instead. Every route
    returns the exact rows."""
    from geomesa_tpu.ops.zkernels import f64_sort_keys, split_u64_to_limbs

    n = 4096
    x = np.full(n, 100.0)
    if pattern == "escalate":
        for s in range(0, n, 100):  # 41 runs of 5 rows
            x[s : s + 5] = 0.0
    else:
        x[::2] = 0.0  # n/2 one-row runs
    arrays = {"valid": np.ones(n, dtype=bool), "xi": np.zeros(n, np.int32),
              "yi": np.zeros(n, np.int32)}
    for k, v in (("xk", x), ("yk", np.zeros(n))):
        arrays[k + "_hi"], arrays[k + "_lo"] = split_u64_to_limbs(f64_sort_keys(v))
    seg = segment_from_reference(arrays, "cpu")
    seg._span_cap, seg._rcap = 8, 8  # an 8-row window: every span overflows
    box = TorchScanExecutor._shape_keys((-1.0, -1.0, 1.0, 1.0, None, None))[0]
    pend = seg.dispatch_exact_batch([(box, None), (box, None)], has_time=False)
    want = np.flatnonzero(x == 0.0)
    runs = seg.dispatch_exact(torch.from_numpy(box), None).buf.numpy()[1]
    assert runs > 8 and (runs > n // 64) == (pattern == "dense")
    for ph in pend:
        assert np.array_equal(ph.rows(), want)
    assert seg._rcap > 8  # the segment learned a larger run capacity
