"""The port's extent (XZ) query path against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its port: the XZ
curves, the envelope companions, the xz2/xz3 candidate masks (the Pallas
kernels in interpret mode against the plain editions of ``xz_mask``), the
dual-plane exact bitmap batch (``_xz_bitmap_batch_fn`` against the plain
edition of ``xz_dual_bitmap`` plus the span framing) and, at the store
level, the five query streams of config #3 at a small size
(``chip_smoke.xz_streams``: bbox on xz2, bbox + DURING on xz3, a triangle,
and the two residual OR streams) through ``TpuDataStore`` and
``TorchDataStore(device="cpu")``, each query also held against the numpy
oracle of ``chip_smoke.oracle_rows``. Tolerance: exact equality everywhere
(bits, headers, fid sets, scan paths).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import chip_smoke as cs
from geomesa_tpu.curve import XZ2SFC as RefXZ2SFC
from geomesa_tpu.curve import XZ3SFC as RefXZ3SFC
from geomesa_tpu.geom import base as ref_geom
from geomesa_tpu.index.keyspace import _envelope_columns as ref_envelope_columns
from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.ops import pallas_kernels as pk
from geomesa_tpu.ops import zkernels as ref_z
from geomesa_tpu.parallel import executor as ref_ex
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.curve import XZ2SFC, XZ3SFC
from geomesa_tpu_torch.geom import base as port_geom
from geomesa_tpu_torch.index.keyspace import _envelope_columns
from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops import zkernels as Z
from geomesa_tpu_torch.parallel.executor import (
    TorchScanExecutor,
    segment_from_reference,
)
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore

REF_ENV = {
    "GEOMESA_EXACT_DEVICE": "1",
    "GEOMESA_DEVBATCH": "1",
    "GEOMESA_BATCH_PROTO": "bitmap",
    "GEOMESA_SEEK": "0",
}
N_WAYS = 20_000
# the config #3 boxes jitter +-10 deg around (0, 0, 20, 15): keep the small
# table where they look
BOUNDS = (-15.0, -15.0, 45.0, 35.0)


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


def _one_device_mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("shards",))


# -- curves -----------------------------------------------------------------


@pytest.mark.parametrize("g", [6, 12])
@pytest.mark.parametrize("max_ranges", [16, 300])
def test_xz_sfc_index_and_ranges_match_reference(g, max_ranges):
    rng = np.random.default_rng(g + max_ranges)
    x0 = rng.uniform(-190, 170, 500)
    y0 = rng.uniform(-95, 80, 500)
    x1 = x0 + rng.exponential(2.0, 500)
    y1 = y0 + rng.exponential(2.0, 500)
    x1[:10] = x0[:10]  # degenerate (zero-extent) boxes
    assert np.array_equal(XZ2SFC.for_g(g).index(x0, y0, x1, y1, lenient=True),
                          RefXZ2SFC.for_g(g).index(x0, y0, x1, y1, lenient=True))
    t0 = rng.uniform(0, 500_000, 500)
    t1 = np.minimum(t0 + rng.exponential(20_000, 500), 604_800)
    port3, ref3 = XZ3SFC.for_period(g, "week"), RefXZ3SFC.for_period(g, "week")
    assert np.array_equal(port3.index(x0, y0, t0, x1, y1, t1, lenient=True),
                          ref3.index(x0, y0, t0, x1, y1, t1, lenient=True))
    queries = [(0.0, 0.0, 20.0, 15.0), (-100.5, -3.25, -80.0, 9.0)]
    assert XZ2SFC.for_g(g).ranges(queries, max_ranges=max_ranges) == \
        RefXZ2SFC.for_g(g).ranges(queries, max_ranges=max_ranges)
    q3 = [(0.0, 0.0, 1000.0, 20.0, 15.0, 300_000.0)]
    assert port3.ranges(q3, max_ranges=max_ranges) == ref3.ranges(q3, max_ranges=max_ranges)


# -- envelope companions ----------------------------------------------------


def _mixed_geoms(mod):
    return np.array([
        mod.Polygon([[0, 0], [2, 0], [2, 1], [0, 1], [0, 0]]),  # a rectangle
        mod.Polygon([[0, 0], [2, 0.5], [1, 2], [0, 0]]),
        None,
        mod.LineString([[5, 5], [6, 7], [4, 8]]),
        mod.Polygon([[0, 0], [2, 0], [0, 1], [2, 1], [0, 0]]),  # a bowtie
        mod.Point(3.0, -4.0),
        None,
    ], dtype=object)


def test_envelope_columns_match_reference():
    port = _envelope_columns("geom", {"geom": _mixed_geoms(port_geom)})
    ref = ref_envelope_columns("geom", {"geom": _mixed_geoms(ref_geom)})
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype and np.array_equal(port[k], ref[k]), k
    assert port["geom__isrect"].tolist() == [1, 0, 0, 0, 0, 0, 0]
    assert port["geom__bxmax"][2] == 0.0  # null geometries: (0, 0, 0, 0)
    # precomputed companions pass through (isrect as uint8)
    given = {k: v for k, v in ref.items()}
    given["geom__isrect"] = given["geom__isrect"].astype(bool)
    port = _envelope_columns("geom", given)
    ref = ref_envelope_columns("geom", dict(given))
    for k in ref:
        assert port[k].dtype == ref[k].dtype and np.array_equal(port[k], ref[k]), k


# -- the candidate masks ----------------------------------------------------


def _f32_rows(n: int, seed: int):
    """float32 envelopes with NaN, +-0.0, inverted pad rows and rows whose
    edges sit exactly on a query box's edges."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-20, 20, n).astype(np.float32)
    y0 = rng.uniform(-20, 20, n).astype(np.float32)
    x1 = x0 + rng.uniform(0, 3, n).astype(np.float32)
    y1 = y0 + rng.uniform(0, 3, n).astype(np.float32)
    valid = rng.random(n) > 0.05
    bins = rng.integers(0, 4, n).astype(np.int32)
    offs = rng.integers(0, 1 << 20, n).astype(np.int32)
    x0[0], x1[0] = np.nan, np.nan
    y0[1] = np.nan
    x0[2], x1[2], y0[2], y1[2] = -0.0, 0.0, -0.0, 0.0
    x0[3], x1[3], y0[3], y1[3] = 5.0, 5.5, -2.0, -1.0  # touches box 0 at x = 5
    x0[4], x1[4], y0[4], y1[4] = 1.0, 2.0, 9.0, 9.5  # touches box 0 at y = 9
    x0[5], x1[5], y0[5], y1[5] = np.nextafter(np.float32(5), np.float32(6)), 6.0, 0.0, 1.0
    valid[:6] = True
    x0[n - 64:], y0[n - 64:], x1[n - 64:], y1[n - 64:] = 1.0, 1.0, 0.0, 0.0  # pads
    valid[n - 64:] = False
    return x0, y0, x1, y1, valid, bins, offs


_BOXES = np.array([[-0.0, -3.0, 5.0, 9.0], [10.0, 10.0, 12.0, 11.0],
                   [1.0, 1.0, 0.0, 0.0], [-50.0, -50.0, -40.0, -40.0]], dtype=np.float32)
_WINDOWS = np.array([[1, 0, 1 << 19], [3, 100, 200_000], [-1, 1, 0], [0, 5, 5]], dtype=np.int32)


@pytest.mark.parametrize("has_time", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_xz_mask_plain_matches_pallas(has_time, k):
    n = 2 * pk.TILE
    x0, y0, x1, y1, valid, bins, offs = _f32_rows(n, k)
    boxes, windows = _BOXES[:k], _WINDOWS[:k]
    t = [torch.from_numpy(a) for a in (x0, y0, x1, y1, valid, boxes)]
    if has_time:
        want = np.asarray(pk.xz3_overlap_mask_pallas(
            x0, y0, x1, y1, bins, offs, valid, boxes, windows, interpret=True))
        got = kernels.xz_mask(*t, torch.from_numpy(bins), torch.from_numpy(offs),
                              torch.from_numpy(windows))
    else:
        want = np.asarray(pk.xz2_overlap_mask_pallas(x0, y0, x1, y1, valid, boxes, interpret=True))
        got = kernels.xz_mask(*t)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert want.any() and not want[n - 64:].any()
    assert not want[0] and not want[1]  # NaN fails every compare
    if not has_time:
        assert want[2] and want[3] and want[4] and not want[5]


# -- the dual-plane exact bitmap ----------------------------------------------

_N = 4096
_T0 = 1_767_225_600_000
_DAY = 86_400_000


def _xz_rows():
    """float64 envelopes with placeholder (null-geometry) rows, rectangles,
    a NaN envelope, rows exactly on query edges, a tail cluster clipped at
    the table's end, invalid rows and a null date."""
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-10, 10, _N)
    y0 = rng.uniform(-10, 10, _N)
    x1 = x0 + rng.uniform(0, 0.5, _N)
    y1 = y0 + rng.uniform(0, 0.5, _N)
    isrect = rng.random(_N) < 0.3
    t = _T0 + rng.integers(0, 10 * _DAY, _N)
    valid = np.ones(_N, dtype=bool)
    valid[2000:2024] = False
    for r in (7, 300, 2010):  # placeholders; row 2010 is invalid
        x0[r] = y0[r] = x1[r] = y1[r] = 0.0
    x0[8], y0[8] = -0.0, -0.0
    x1[8], y1[8] = 0.25, 0.25
    x0[9] = np.nan
    x0[10], y0[10], x1[10], y1[10] = 20.0, 20.0, 21.0, 21.0  # box edges
    x0[_N - 60:_N - 2], y0[_N - 60:_N - 2] = 80.0, 80.0
    x1[_N - 60:_N - 2], y1[_N - 60:_N - 2] = 80.5, 80.5
    t[_N - 40:_N - 20] = _T0 + 1000 + np.arange(20) - 10
    tvalid = valid.copy()
    tvalid[_N - 30] = False  # a null date inside the window
    return (x0, y0, x1, y1), isrect, valid, tvalid, t


# (xmin, ymin, xmax, ymax, rect, t_lo, t_hi)
_XZ_SHAPES = [
    (100.0, 100.0, 101.0, 101.0, True, _T0, _T0 + 20 * _DAY),  # empty
    (-0.5, -0.5, 0.5, 0.5, True, _T0, _T0 + 20 * _DAY),  # placeholders overlap
    (-2.0, -2.0, 2.0, 2.0, False, _T0, _T0 + 20 * _DAY),  # rect = false
    (21.0, 21.0, 22.0, 22.0, True, _T0, None),  # touches row 10, open upper
    (79.0, 79.0, 81.0, 81.0, True, _T0 + 995, _T0 + 1004),  # tail, window
    (79.0, 79.0, 80.25, 81.0, True, None, _T0 + 5 * _DAY),  # open lower
    (-10.0, -10.0, 10.0, 10.0, True, _T0, _T0 + _DAY),  # a wide query
]


def _ref_dual(cols, isrect, valid, tvalid, t, shapes, has_time, span_cap):
    limbs = []
    for c in cols:
        hi, lo = ref_z.split_u64_to_limbs(ref_z.f64_sort_keys(c))
        limbs += [jnp.asarray(hi), jnp.asarray(lo)]
    th = tl = limbs[0]
    if has_time:
        thi, tlo = ref_z.split_u64_to_limbs(ref_z.i64_sort_keys(t))
        th, tl = jnp.asarray(thi), jnp.asarray(tlo)
    descs = [ref_ex._xz_query_limbs(ref_geom.Envelope(*s[:4]), s[4],
                                    *(s[5:] if has_time else (None, None))) for s in shapes]
    qboxes = jnp.asarray(np.stack([d[0] for d in descs]))
    wins = jnp.asarray(np.stack([d[1] for d in descs]))
    fn = ref_ex._xz_bitmap_batch_fn(has_time, span_cap, len(shapes), "local", _one_device_mesh())
    hdr, bits = fn(*limbs, jnp.asarray(isrect), jnp.asarray(tvalid if has_time else valid),
                   th, tl, qboxes, wins)
    return np.asarray(hdr), np.asarray(bits)


def _port_descs(shapes, has_time):
    return torch.from_numpy(np.stack([
        TorchScanExecutor._xz_desc(port_geom.Envelope(*s[:4]), s[4],
                                   *(s[5:] if has_time else (None, None)))[0]
        for s in shapes
    ]))


@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("span_cap", [_N, _N // 4])
def test_xz_dual_bitmap_plain_matches_reference(has_time, span_cap):
    cols, isrect, valid, tvalid, t = _xz_rows()
    want_hdr, want_bits = _ref_dual(cols, isrect, valid, tvalid, t, _XZ_SHAPES, has_time, span_cap)
    keys = [torch.from_numpy(Z.f64_keys(c)) for c in cols]
    hit, dec, hdr = kernels.xz_dual_bitmap(
        *keys, torch.from_numpy(isrect), torch.from_numpy(tvalid if has_time else valid),
        _port_descs(_XZ_SHAPES, has_time), tk=torch.from_numpy(t) if has_time else None)
    header, window = kernels.frame_dual_bitmaps(hit, dec, hdr, span_cap)
    assert header.dtype == torch.int32 and window.dtype == torch.uint8
    assert np.array_equal(header.numpy(), want_hdr)
    assert np.array_equal(window.numpy(), want_bits)
    cnt, lo, hi, start = want_hdr.T
    assert cnt[0] == 0 and (lo[0], hi[0]) == (0, _N - 1)  # the empty rule
    half = span_cap // 8
    hit_rows = np.flatnonzero(np.unpackbits(want_bits[1, :half])) + start[1]
    dec_rows = np.flatnonzero(np.unpackbits(want_bits[1, half:])) + start[1]
    assert {7, 300}.issubset(hit_rows) and not {7, 300} & set(dec_rows)  # placeholders
    assert cnt[2] > 0 and not want_bits[2, half:].any()  # rect = false decides nothing
    assert cnt[3] == 1  # the edge touch
    if span_cap < _N:
        assert start[4] == _N - span_cap  # clipped at the table's end
    if has_time:
        assert cnt[4] == 10 - 1  # T0+995..T0+1004 minus the null date


# -- the store --------------------------------------------------------------


@pytest.fixture(scope="module")
def ways():
    w = cs.synthesize_ways(N_WAYS, seed=3, bounds=BOUNDS, clusters=8)
    null_dates = np.random.default_rng(4).random(N_WAYS) < 0.002
    return w, null_dates


@pytest.fixture(scope="module")
def xz_stores(ways, _env):
    w, null_dates = ways
    ref = TpuDataStore(executor=TpuScanExecutor(_one_device_mesh()))
    ref_ft = ref_parse_spec("ways", cs.WAYS_SPEC)
    ref.create_schema(ref_ft)
    cols = cs.ways_columns(w, classes=(ref_geom.LineString, ref_geom.Polygon))
    ref._insert_columns(ref_ft, dict(cols, dtg__null=null_dates))
    port = TorchDataStore(device="cpu")
    ft = parse_spec("ways", cs.WAYS_SPEC)
    port.create_schema(ft)
    port._insert_columns(ft, dict(cs.ways_columns(w), dtg__null=null_dates))
    return ref, port


def _oracle(ways, spec):
    w, null_dates = ways
    # a null date matches no DURING window
    return cs.oracle_rows(dict(w, dtg=np.where(null_dates, -1, w["dtg"])), *spec)


def _fids(rows):
    return {f"w{i}" for i in rows}


_STREAMS = cs.xz_streams(reps=5, tris=2, resid=3)


@pytest.mark.parametrize("stream", sorted(_STREAMS))
def test_xz_streams_match_reference(xz_stores, ways, stream):
    ref, port = xz_stores
    items = _STREAMS[stream]
    got = port.query_many("ways", [Query.cql(c, properties=[]) for c, _ in items])
    want = ref.query_many("ways", [RefQuery.cql(c, properties=[]) for c, _ in items])
    index, path, _lone_path = cs.XZ_PATHS[stream]
    for (cql, spec), p, r in zip(items, got, want):
        assert (p.plan.index.name, p.plan.scan_path) == (index, path), cql
        assert p.plan.scan_path == r.plan.scan_path
        assert set(p.columns) == {"__fid__"}
        fids = set(p.fids.tolist())
        assert fids == set(r.fids.tolist()) == _fids(_oracle(ways, spec)), cql
    assert any(len(p) for p in got)


@pytest.mark.parametrize("stream", ["xz2_bbox", "xz3_bbox_during", "xz2_triangle"])
def test_xz_single_query_matches_reference(xz_stores, ways, stream):
    """A lone extent query takes the dual route with q = 1 (run-length
    encoded planes); the reference's lone query takes the candidate mask
    under GEOMESA_SEEK=0: the fid sets agree."""
    ref, port = xz_stores
    cql, spec = _STREAMS[stream][1]
    res = port.query("ways", cql)
    assert res.plan.scan_path == cs.XZ_PATHS[stream][2] == "device-batch-dual/runs"
    want = ref.query("ways", cql)
    assert set(res.fids.tolist()) == set(want.fids.tolist()) == _fids(_oracle(ways, spec))
    # results never carry the envelope companions
    assert not any(k.startswith("geom__") for k in res.columns)
    assert len(res) == 0 or isinstance(res.columns["geom"][0], port_geom.Geometry)


def _ref_xz_segment(ref, index: str):
    table = ref._tables["ways"][index]
    seg = ref.executor.device_index(table).segments[0]
    assert seg.load_exact_xz(table)
    arrays = {k: np.asarray(getattr(seg, k))
              for k in ("valid", "bxmin", "bymin", "bxmax", "bymax", "bins", "ti")
              if getattr(seg, k, None) is not None}
    arrays["xz_limbs"] = [np.asarray(a) for a in seg.xz_limbs]
    arrays["xz_isrect"] = np.asarray(seg.xz_isrect)
    if index == "xz3":
        arrays["xz_tk"] = [np.asarray(a) for a in seg.xz_tk]
        tv = seg.xz_tvalid if seg.xz_tvalid is not None else seg.valid
        arrays["xz_tvalid"] = np.asarray(tv)
    return seg, arrays


@pytest.mark.parametrize("pattern", ["window", "overflow", "runs"])
@pytest.mark.parametrize("index", ["xz2", "xz3"])
def test_segment_from_reference_xz(xz_stores, index, pattern):
    """A port segment built from the JAX segment's arrays gives the same
    candidate rows and (hit, decided) rows, through the span window, its
    overflow refetch as dual runs, and the runs' capacity escalation and
    dense degrade (a run capacity of 1: a query past n/64 runs takes the
    packed planes, the rest escalate)."""
    ref, port = xz_stores
    stream = "xz2_or" if index == "xz2" else "xz3_or_during"
    exact = "xz2_bbox" if index == "xz2" else "xz3_bbox_during"
    ref_seg, arrays = _ref_xz_segment(ref, index)
    seg = segment_from_reference(arrays, "cpu")
    assert seg.kind == index and seg.n_padded == ref_seg.n_padded
    ref_table = ref._tables["ways"][index]
    ref_ex_, port_ex = ref.executor, port.executor
    # candidate route: same descriptor, same mask rows
    cql = _STREAMS[stream][0][0]
    ref_plan = ref.planner("ways").plan(RefQuery.cql(cql))
    plan = port._plan_cached("ways", Query.cql(cql))
    rb, rw = ref_ex_._query_descriptor(ref_table, ref_plan)
    pb, pw = port_ex._query_descriptor(port._tables["ways"][index], plan)
    assert np.array_equal(pb.numpy(), np.asarray(rb))
    assert (pw is None) == (rw is None) and (pw is None or np.array_equal(pw.numpy(), np.asarray(rw)))
    assert np.array_equal(seg.dispatch_hits(pb, pw).rows(), ref_seg.hit_rows(rb, rw))
    # dual route: the reference's batch rows
    items = _STREAMS[exact]
    ref_descs, port_descs = [], []
    for c, _ in items:
        rplan = ref.planner("ways").plan(RefQuery.cql(c))
        rd = ref_ex_._xz_batch_desc(ref_table, rplan)
        ref_descs.append((rd[0], rd[1]))
        pd = port_ex._xz_batch_desc(port._tables["ways"][index], port._plan_cached("ways", Query.cql(c)))
        port_descs.append(pd[0])
        has_time = pd[1]
    want = [ph.rows() for ph in ref_seg.dispatch_exact_xz_batch(ref_descs, has_time)]
    if pattern == "overflow":
        seg._span_cap = 1 << 10  # narrower than the spans: single refetches
    elif pattern == "runs":
        seg._span_cap = 8
        seg._rcap = 1  # the refetch's runs overflow at once
    got = [ph.rows() for ph in seg.dispatch_exact_xz_batch(np.stack(port_descs), has_time)]
    for (wh, wd), (gh, gd) in zip(want, got):
        assert np.array_equal(gh, wh) and np.array_equal(gd, wd)
    assert any(len(h) for h, _ in want) and any(len(d) for _, d in want)
    if pattern == "runs":
        assert seg._rcap > 1  # the segment learned a larger run capacity


# -- the attribute editions of the dual plane ----------------------------------------


def _xz_qcodes(kind: str, q: int, rng):
    """One attribute vector a shape: member / notmember codes (K = 4, the
    absent -2 and null -1 among them), range intervals (IS NULL, wide,
    empty), vocabmask lookups of 64 entries."""
    if kind == "range":
        out = np.stack([rng.integers(0, 20, q), rng.integers(20, 60, q)], 1).astype(np.int32)
        out[:3] = [(-1, -1), (0, 10**6), (9, 3)][:q]
        return out
    if kind == "vocabmask":
        return (rng.random((q, 64)) < 0.4).astype(np.uint8)
    out = rng.integers(-2, 50, (q, 4)).astype(np.int32)
    out[0] = (-1, -2, 7, 7)
    return out


@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("kind", ["member", "range", "notmember", "vocabmask"])
def test_xz_dual_bitmap_plain_attr_matches_reference(kind, has_time):
    """``xz_dual_bitmap_plain`` with each attribute edition against the
    reference's ``_xz_bitmap_batch_fn(..., attr=)`` (``_xz_exact_mask_body``
    with the combine ANDed into hit before decided): headers and both
    planes' span windows bit for bit."""
    cols, isrect, valid, tvalid, t = _xz_rows()
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 50, _N).astype(np.int32)
    codes[rng.random(_N) < 0.1] = -1
    codes[2000:2024] = -1  # the invalid rows
    qcodes = _xz_qcodes(kind, len(_XZ_SHAPES), rng)
    span_cap = _N // 2
    limbs = []
    for c in cols:
        hi, lo = ref_z.split_u64_to_limbs(ref_z.f64_sort_keys(c))
        limbs += [jnp.asarray(hi), jnp.asarray(lo)]
    th = tl = limbs[0]
    if has_time:
        thi, tlo = ref_z.split_u64_to_limbs(ref_z.i64_sort_keys(t))
        th, tl = jnp.asarray(thi), jnp.asarray(tlo)
    descs = [ref_ex._xz_query_limbs(ref_geom.Envelope(*s[:4]), s[4],
                                    *(s[5:] if has_time else (None, None))) for s in _XZ_SHAPES]
    fn = ref_ex._xz_bitmap_batch_fn(has_time, span_cap, len(_XZ_SHAPES), "local",
                                    _one_device_mesh(), kind)
    want_hdr, want_bits = (np.asarray(a) for a in fn(
        *limbs, jnp.asarray(isrect), jnp.asarray(tvalid if has_time else valid), th, tl,
        jnp.asarray(codes), jnp.asarray(np.stack([d[0] for d in descs])),
        jnp.asarray(np.stack([d[1] for d in descs])), jnp.asarray(qcodes)))
    keys = [torch.from_numpy(Z.f64_keys(c)) for c in cols]
    hit, dec, hdr = kernels.xz_dual_bitmap(
        *keys, torch.from_numpy(isrect), torch.from_numpy(tvalid if has_time else valid),
        _port_descs(_XZ_SHAPES, has_time), torch.from_numpy(t) if has_time else None,
        torch.from_numpy(codes), torch.from_numpy(qcodes), kind)
    header, window = kernels.frame_dual_bitmaps(hit, dec, hdr, span_cap)
    assert np.array_equal(header.numpy(), want_hdr)
    assert np.array_equal(window.numpy(), want_bits)
    assert (want_hdr[:, 0] > 0).any()


# (a') of chip_smoke at a small size: bbox AND predicates on the way's kind,
# two queries an edition so each edition batches as the reference's does
_KIND_PREDS = [
    ("kind = 'line'", ("line",)),
    ("kind IN ('rect', 'polygon')", ("rect", "polygon")),
    ("kind >= 'polygon'", ("polygon", "rect")),
    ("kind < 'polygon'", ("line",)),
    ("kind <> 'line'", ("polygon", "rect")),
    ("kind <> 'rect' AND kind <> 'polygon'", ("line",)),
    ("kind LIKE '%o%'", ("polygon",)),
    ("kind ILIKE 'RECT'", ("rect",)),
]


def _kind_items(during: bool):
    boxes = cs.xz2_boxes(len(_KIND_PREDS), seed=91)
    wins = cs.three_week_windows(len(_KIND_PREDS), seed=92)
    out = []
    for (pred, kinds), b, w in zip(_KIND_PREDS, boxes, wins):
        cql = f"{pred} AND {cs.xz_bbox_cql(b)}" + (f" AND {cs.during_cql(w)}" if during else "")
        out.append((cql, ([b], None, w if during else None), kinds))
    return out


def _kind_oracle(ways, spec, kinds):
    w, _null_dates = ways
    rows = _oracle(ways, spec)
    return rows[np.isin(cs.KIND_NAMES[w["kind"][rows].astype(int) + 1], kinds)]


@pytest.mark.parametrize("during", [False, True])
@pytest.mark.parametrize("mode", ["auto", "0", "1"])
def test_xz_attr_streams_and_counts_match_reference(xz_stores, ways, monkeypatch, mode, during):
    """Extent queries AND an attribute predicate (every edition, two
    queries each) through ``query_many``: the reference's fids, index and
    route (under 0 the dual plane, ``device-batch-dual/bitmap``) and the
    oracle's rows; each alone through ``query`` (the reference's route for
    a lone extent query with an attribute predicate, the candidate mask);
    and their counts under ``GEOMESA_COUNT_DEVICE=1`` (the q = 1 dual
    planes with the attribute plane), equal to the reference's."""
    monkeypatch.setenv("GEOMESA_SEEK", mode)
    ref, port = xz_stores
    items = _kind_items(during)
    cqls = [c for c, _s, _k in items]
    got = port.query_many("ways", [Query.cql(c, properties=[]) for c in cqls])
    want = ref.query_many("ways", [RefQuery.cql(c, properties=[]) for c in cqls])
    for (cql, spec, kinds), p, r in zip(items, got, want):
        assert (p.plan.index.name, p.plan.scan_path) == (r.plan.index.name, r.plan.scan_path), cql
        assert set(p.fids.tolist()) == set(r.fids.tolist()) == _fids(
            _kind_oracle(ways, spec, kinds)), cql
        if mode == "0":
            assert p.plan.scan_path == "device-batch-dual/bitmap", cql
    assert sum(len(p) for p in got)
    monkeypatch.setenv("GEOMESA_COUNT_DEVICE", "1")
    for cql, spec, kinds in items[:4]:
        p = port.query("ways", cql)
        assert set(p.fids.tolist()) == _fids(_kind_oracle(ways, spec, kinds)), cql
        assert p.plan.scan_path == ref.query("ways", RefQuery.cql(cql)).plan.scan_path, cql
        assert port.count("ways", cql) == ref.count("ways", cql) == len(p), cql
