"""The port's banded polygon plane (bench_suite.py ``bench_poly``) against the
JAX package, on the CPU.

The same numpy points (uniform, plus points exactly on edges, vertices and
a horizontal edge) go into the reference ``TpuDataStore`` on a one-device
CPU mesh, run as on an accelerator (``GEOMESA_EXACT_DEVICE=1``,
``GEOMESA_DEVBATCH=1``, the bitmap protocol), and into the port's
``TorchDataStore(device="cpu")``. Kernel level: the polygon descriptors,
then the plain edition of ``poly_dual_bitmap`` (``poly_planes``) on a
segment carried by ``segment_from_reference`` against the reference's
``_poly_mask_body`` and ``_poly_bitmap_batch_fn``: hit and decided planes,
headers and span windows bit for bit (z2 and z3; a star, a polygon with a
hole, a disjoint MultiPolygon). Store level: ``query_many`` streams through
both packages, equal fids and equal ``scan_path``, and each answer equal to
an f64 even-odd oracle (bench_poly's ``pip``) where no point lies on a
boundary; routes under ``GEOMESA_SEEK`` auto, 0 and 1.

The reference on the CPU computes ``xint`` with a fused multiply-add (XLA
contracts ``x1 + t * dx``); the port rounds each operation, as the kernel
does on the card. A row within an ulp of the band's edge can then be in the
band on one and decided on the other: ``test_xint_contraction_moves_rows_
between_ring_and_decided`` builds such rows and shows that the answers stay
equal (the ring takes the host's exact test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.parallel import executor as ref_ex
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.filters import POLY_EPS, POLY_XINT_K, poly_planes
from geomesa_tpu_torch.ops.zkernels import limbs_to_keys, unpack_mask_rows
from geomesa_tpu_torch.parallel import executor as port_ex
from geomesa_tpu_torch.parallel.executor import segment_from_reference
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore

SPEC = "actor:String,dtg:Date,*geom:Point:srid=4326"
T0 = int(np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
REF_ENV = {
    "GEOMESA_EXACT_DEVICE": "1",
    "GEOMESA_DEVBATCH": "1",
    "GEOMESA_BATCH_PROTO": "bitmap",
    "GEOMESA_SEEK": "0",
}

TRIANGLE = "POLYGON ((-20 -20, 30 -10, 5 35, -20 -20))"
CONCAVE = "POLYGON ((-40 -40, 40 -40, 40 40, 0 0, -40 40, -40 -40))"
HOLED = ("POLYGON ((-30 -30, 30 -30, 30 30, -30 30, -30 -30), "
         "(-10 -10, 10 -10, 10 10, -10 10, -10 -10))")
MULTI = ("MULTIPOLYGON (((-60 -60, -45 -60, -45 -45, -60 -45, -60 -60)), "
         "((45 45, 60 45, 52 60, 45 45)))")
OVERLAP = ("MULTIPOLYGON (((-20 -20, 20 -20, 20 20, -20 20, -20 -20)), "
           "((0 0, 30 0, 30 30, 0 30, 0 0)))")
RECT = "POLYGON ((-10 -10, 10 -10, 10 10, -10 10, -10 -10))"


def star(cx: float, cy: float, r: float) -> np.ndarray:
    """bench_poly's 12-point star, its vertices as its WKT text gives them."""
    ang = np.linspace(0, 2 * np.pi, 13)[:-1]
    rad = np.where(np.arange(12) % 2 == 0, r, 0.45 * r)
    pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], axis=1)
    return np.array([[float(f"{a:.6f}"), float(f"{b:.6f}")] for a, b in np.vstack([pts, pts[:1]])])


def wkt(poly: np.ndarray) -> str:
    return "POLYGON ((" + ", ".join(f"{a:.6f} {b:.6f}" for a, b in poly) + "))"


def pip(poly: np.ndarray, px, py) -> np.ndarray:
    """bench_poly's f64 even-odd oracle."""
    inside = np.zeros(len(px), bool)
    for (x1, y1), (x2, y2) in zip(poly[:-1], poly[1:]):
        cond = (y1 > py) != (y2 > py)
        if y1 != y2:
            xint = x1 + (py - y1) * (x2 - x1) / (y2 - y1)
            inside ^= cond & (px < xint)
    return inside


STAR = wkt(star(2.0, 10.0, 14.0))
POLYS = {"star": STAR, "holed": HOLED, "multi": MULTI}


def stars(k: int, seed: int = 99):
    """bench_poly's jittered stars (+-6 deg)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        dx, dy = rng.uniform(-6, 6, 2)
        out.append(star(2.0 + dx, 10.0 + dy, 14.0))
    return out


@pytest.fixture(scope="module", autouse=True)
def _env():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_ENV.items():
            mp.setenv(k, v)
        yield
    torch.set_num_threads(old)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("shards",))


def _points(n: int, seed: int):
    """Uniform points, then points exactly on the triangle's edge, on
    HOLED's horizontal edge and on every vertex."""
    rng = np.random.default_rng(seed)
    ts = np.linspace(0, 1, 41)
    hx = np.linspace(-30, 30, 31)
    vx = np.array([-20.0, 30.0, 5.0, -40.0, 40.0, 0.0, -30.0, 30.0, -10.0, 10.0, -60.0, 52.0])
    vy = np.array([-20.0, -10.0, 35.0, -40.0, 40.0, 0.0, -30.0, 30.0, -10.0, 10.0, -45.0, 60.0])
    x = np.concatenate([rng.uniform(-70, 70, n), -20 + ts * 50, hx, vx])
    y = np.concatenate([rng.uniform(-70, 70, n), -20 + ts * 10, np.full_like(hx, -30.0), vy])
    return x, y


def _stores(x, y, seed: int = 1, name: str = "t"):
    rng = np.random.default_rng(seed)
    n = len(x)
    cols = {"__fid__": np.char.add("f", np.arange(n).astype(f"<U{len(str(n - 1))}")),
            "geom__x": x, "geom__y": y, "dtg": T0 + rng.integers(0, 20 * DAY, n),
            "actor": np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)]}
    ref = TpuDataStore(executor=TpuScanExecutor(_mesh()))
    ref.create_schema(ref_parse_spec(name, SPEC))
    ref._insert_columns(ref.get_schema(name), dict(cols))
    port = TorchDataStore(device="cpu")
    port.create_schema(parse_spec(name, SPEC))
    port._insert_columns(port.get_schema(name), dict(cols))
    return ref, port, cols


@pytest.fixture(scope="module")
def stores(_env):
    return _stores(*_points(30_000, 3))


def _parity(ref, port, cqls, path=None, name="t"):
    """Equal fid sets and scan paths of one stream through both packages;
    returns the port's results."""
    got = port.query_many(name, [Query.cql(c, properties=[]) for c in cqls])
    want = ref.query_many(name, [RefQuery.cql(c, properties=[]) for c in cqls])
    for cql, p, r in zip(cqls, got, want):
        assert set(p.fids.tolist()) == set(r.fids.tolist()), cql
        assert p.plan.scan_path == r.plan.scan_path, (cql, p.plan.scan_path, r.plan.scan_path)
        if path is not None:
            assert p.plan.scan_path == path, cql
    return got


def _during(d0: int, d1: int) -> str:
    return f"dtg DURING 2026-01-{d0:02d}T00:00:00Z/2026-01-{d1:02d}T00:00:00Z"


# -- descriptors ----------------------------------------------------------------


@pytest.mark.parametrize("poly", ["star", "holed", "multi", "triangle", "overlap", "rect"])
@pytest.mark.parametrize("during", [False, True])
def test_poly_desc_matches_reference(stores, poly, during):
    ref, port, _cols = stores
    g = {"triangle": TRIANGLE, "overlap": OVERLAP, "rect": RECT}.get(poly) or POLYS[poly]
    cql = f"intersects(geom, {g})" + (f" AND {_during(3, 9)}" if during else "")
    index = "z3" if during else "z2"
    rplan = ref._plan_cached("t", RefQuery.cql(cql))
    pplan = port._plan_cached("t", Query.cql(cql))
    assert rplan.index.name == pplan.index.name == index
    want = ref.executor._poly_batch_desc(ref._tables["t"][index], rplan)
    got = port.executor._poly_batch_desc(port._tables["t"][index], pplan)
    assert (got is None) == (want is None) == (poly in ("overlap", "rect"))
    if got is None:
        return
    edges, box, win, has_time, _geom, _node, attr_info = got
    assert attr_info is None and want[6] is None
    assert edges.dtype == np.float32 and np.array_equal(edges, want[0])
    assert np.array_equal(box, limbs_to_keys(want[1][0::2], want[1][1::2]))
    assert has_time == want[3] == during
    if during:
        assert np.array_equal(win, limbs_to_keys(want[2][0::2], want[2][1::2]))


# -- the planes: poly_dual_bitmap_plain against _poly_mask_body ---------------------


@pytest.fixture(scope="module")
def carried(stores):
    """Per index: (reference segment, its arrays, the port segment)."""
    ref, _port, _cols = stores
    out = {}
    for index in ("z2", "z3"):
        table = ref._tables["t"][index]
        seg = ref.executor.device_index(table).segments[0]
        assert seg.load_poly(table)
        names = ["xi", "yi", "valid", "xk_hi", "xk_lo", "yk_hi", "yk_lo", "xf", "yf"]
        if index == "z3":
            names += ["bins", "ti", "tk_hi", "tk_lo", "tvalid", "t_ms"]
        arrays = {k: np.array(getattr(seg, k)) for k in names}
        out[index] = (seg, arrays, segment_from_reference(arrays, "cpu"))
    return out


def _descs(ref, index, polys, during):
    """The reference's descriptors of ``polys`` (equal to the port's:
    ``test_poly_desc_matches_reference``)."""
    out = []
    for g in polys:
        cql = f"intersects(geom, {g})" + (f" AND {_during(3, 9)}" if during else "")
        out.append(ref.executor._poly_batch_desc(ref._tables["t"][index],
                                                 ref._plan_cached("t", RefQuery.cql(cql))))
    return out


def _padded_edges(descs, ecap):
    edges = np.zeros((len(descs), ecap, 4), np.float32)
    for i, d in enumerate(descs):
        edges[i, :len(d[0])] = d[0]
    return edges


def _port_args(descs, during):
    box = torch.from_numpy(np.stack([limbs_to_keys(d[1][0::2], d[1][1::2]) for d in descs]))
    win = (torch.from_numpy(np.stack([limbs_to_keys(d[2][0::2], d[2][1::2]) for d in descs]))
           if during else None)
    return box, win


@pytest.mark.parametrize("poly", sorted(POLYS))
@pytest.mark.parametrize("index", ["z2", "z3"])
def test_poly_planes_match_reference(stores, carried, index, poly):
    ref, _port, _cols = stores
    seg, arrays, pseg = carried[index]
    during = index == "z3"
    (d,) = _descs(ref, index, [POLYS[poly]], during)
    edges = _padded_edges([d], 16)
    body = ref_ex._poly_mask_body(during, "local", _mesh())
    if during:
        args = (seg.xk_hi, seg.xk_lo, seg.yk_hi, seg.yk_lo, seg.tk_hi, seg.tk_lo, seg.tvalid,
                seg.xf, seg.yf, jnp.asarray(edges[0]), jnp.asarray(d[1]), jnp.asarray(d[2]))
    else:
        args = (seg.xk_hi, seg.xk_lo, seg.yk_hi, seg.yk_lo, seg.valid, seg.xf, seg.yf,
                jnp.asarray(edges[0]), jnp.asarray(d[1]), jnp.asarray(np.zeros(4, np.uint32)))
    want_hit, want_dec = (np.asarray(a) for a in jax.jit(body)(*args))
    box, win = _port_args([d], during)
    valid = pseg.tvalid if during else pseg.valid
    hit, dec = poly_planes(pseg.xk, pseg.yk, valid, box[0], pseg.xf, pseg.yf,
                           torch.from_numpy(edges[0]), pseg.tk if during else None,
                           None if win is None else win[0])
    assert np.array_equal(hit.numpy(), want_hit) and np.array_equal(dec.numpy(), want_dec)
    assert want_dec.any()
    if not during:
        assert (want_hit & ~want_dec).any()  # the vertices in the data make a ring
    hb, db, hdr = kernels.poly_dual_bitmap(pseg.xk, pseg.yk, valid, pseg.xf, pseg.yf,
                                           torch.from_numpy(edges), box, win,
                                           pseg.tk if during else None)
    assert np.array_equal(unpack_mask_rows(hb[0]).numpy(), want_hit)
    assert np.array_equal(unpack_mask_rows(db[0]).numpy(), want_dec)
    rows = np.flatnonzero(want_hit)
    assert hdr.tolist() == [[len(rows), rows[0], rows[-1]]]


@pytest.mark.parametrize("span", ["full", "narrow"])
@pytest.mark.parametrize("index", ["z2", "z3"])
def test_poly_bitmap_batch_matches_reference(stores, carried, index, span):
    """A batch of four (stars, the holed polygon, the MultiPolygon, an
    empty-window query) through the reference's ``_poly_bitmap_batch_fn``
    and the port's kernel + ``frame_dual_bitmaps``: equal headers and span
    windows (hit then decided)."""
    ref, _port, _cols = stores
    seg, _arrays, pseg = carried[index]
    during = index == "z3"
    polys = [STAR, HOLED, MULTI, wkt(star(100.0, 80.0, 5.0))]
    descs = _descs(ref, index, polys, during)
    edges = _padded_edges(descs, 16)
    span_cap = seg.n_padded if span == "full" else seg.n_padded // 4
    fn = ref_ex._poly_bitmap_batch_fn(during, span_cap, len(descs), "local", _mesh())
    wins = np.stack([d[2] if d[2] is not None else np.zeros(4, np.uint32) for d in descs])
    if during:
        cols = (seg.xk_hi, seg.xk_lo, seg.yk_hi, seg.yk_lo, seg.tk_hi, seg.tk_lo, seg.tvalid,
                seg.xf, seg.yf)
    else:
        cols = (seg.xk_hi, seg.xk_lo, seg.yk_hi, seg.yk_lo, seg.valid, seg.xf, seg.yf)
    want_hdr, want_bits = (np.asarray(a) for a in fn(
        *cols, jnp.asarray(edges), jnp.asarray(np.stack([d[1] for d in descs])), jnp.asarray(wins)))
    box, win = _port_args(descs, during)
    hb, db, hdr = kernels.poly_dual_bitmap(
        pseg.xk, pseg.yk, pseg.tvalid if during else pseg.valid, pseg.xf, pseg.yf,
        torch.from_numpy(edges), box, win, pseg.tk if during else None)
    header, window = kernels.frame_dual_bitmaps(hb, db, hdr, span_cap)
    assert np.array_equal(header.numpy(), want_hdr)
    assert np.array_equal(window.numpy(), want_bits)
    assert want_hdr[3, 0] == 0 and (want_hdr[:3, 0] > 0).all()


def _ring(m: int, r_out: float, r_in: tuple, seed: int) -> np.ndarray:
    """A concave ring of m vertices around the origin: every other vertex at
    r_out, the rest at a seeded radius in r_in."""
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, m))
    rad = np.where(np.arange(m) % 2 == 0, r_out, rng.uniform(*r_in, m))
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
    return np.round(np.vstack([pts, pts[:1]]), 6)


def _worst_layout(layout: str):
    """The kernel's heaviest layouts: 64 queries on the same chunks (one
    star's copies, jittered by 0.05 deg), envelopes over the whole table
    (every chunk enveloped by every query), ~1,000 edges a query (edges
    past the shared-memory tile on the card) and a single query."""
    if layout == "same_chunks_q64":
        rng = np.random.default_rng(64)
        return [wkt(star(2.0 + dx, 10.0 + dy, 14.0)) for dx, dy in rng.uniform(-0.05, 0.05, (64, 2))]
    if layout == "whole_table_q8":
        rings = [_ring(16, 110.0, (30.0, 90.0), seed) for seed in range(8)]
        # each envelope holds every row (_points: within [-70, 70] a side)
        assert all((r.min(0) < -70).all() and (r.max(0) > 70).all() for r in rings)
        return [wkt(r) for r in rings]
    if layout == "edges_1000_q3":
        return [wkt(_ring(1000, 110.0, (60.0, 100.0), seed)) for seed in range(3)]
    return [STAR]


@pytest.mark.parametrize("layout", ["same_chunks_q64", "whole_table_q8", "edges_1000_q3", "q1"])
@pytest.mark.parametrize("index", ["z2", "z3"])
def test_poly_bitmap_batch_worst_layouts_match_reference(stores, carried, index, layout):
    """The layouts of the card's worst-case tests through the reference's
    ``_poly_bitmap_batch_fn`` and the port's kernel (its plain edition
    here) + ``frame_dual_bitmaps``: equal headers and windows."""
    ref, _port, _cols = stores
    seg, _arrays, pseg = carried[index]
    during = index == "z3"
    descs = _descs(ref, index, _worst_layout(layout), during)
    ecap = 16
    while ecap < max(len(d[0]) for d in descs):
        ecap *= 2
    assert ecap == (1024 if layout == "edges_1000_q3" else 16)
    edges = _padded_edges(descs, ecap)
    fn = ref_ex._poly_bitmap_batch_fn(during, seg.n_padded, len(descs), "local", _mesh())
    wins = np.stack([d[2] if d[2] is not None else np.zeros(4, np.uint32) for d in descs])
    if during:
        cols = (seg.xk_hi, seg.xk_lo, seg.yk_hi, seg.yk_lo, seg.tk_hi, seg.tk_lo, seg.tvalid,
                seg.xf, seg.yf)
    else:
        cols = (seg.xk_hi, seg.xk_lo, seg.yk_hi, seg.yk_lo, seg.valid, seg.xf, seg.yf)
    want_hdr, want_bits = (np.asarray(a) for a in fn(
        *cols, jnp.asarray(edges), jnp.asarray(np.stack([d[1] for d in descs])), jnp.asarray(wins)))
    box, win = _port_args(descs, during)
    hb, db, hdr = kernels.poly_dual_bitmap(
        pseg.xk, pseg.yk, pseg.tvalid if during else pseg.valid, pseg.xf, pseg.yf,
        torch.from_numpy(edges), box, win, pseg.tk if during else None)
    header, window = kernels.frame_dual_bitmaps(hb, db, hdr, seg.n_padded)
    assert np.array_equal(header.numpy(), want_hdr)
    assert np.array_equal(window.numpy(), want_bits)
    assert (want_hdr[:, 0] > 0).all()


def _fma_f32(a, b, c):
    """round_f32(a * b + c) with one rounding (a * b of two f32 is exact in f64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _band_by_source(seg_xk_order_fids, hit, dec, n):
    """Band flags (hit and not decided) of the first ``n`` source points,
    from a key-ordered segment's planes and its rows' fids ``f<source>``."""
    src = np.array([int(f[1:]) for f in seg_xk_order_fids])
    band = (hit & ~dec)[:len(src)]
    out = np.zeros(n, dtype=bool)
    keep = src < n
    out[src[keep]] = band[keep]
    return out


def test_xint_contraction_moves_rows_between_ring_and_decided():
    """Rows at the band's edge of a tilted edge: one rounding per operation
    puts some in the band where a fused ``x1 + t * dx`` (the reference on
    the CPU: XLA contracts it) does not, and the other way. The port's
    planes follow one rounding per operation exactly (numpy emulation), the
    reference's the fused form; both packages' answers are equal, and equal
    to the f64 oracle."""
    f32 = np.float32
    x1, y1, x2, y2 = f32(-60.0), f32(50.0), f32(60.0), f32(80.0)
    eps, keps = f32(POLY_EPS), f32(POLY_EPS * POLY_XINT_K)
    rng = np.random.default_rng(4)
    yf = rng.uniform(55.0, 75.0, 200_000).astype(f32)  # clear of the vertex strips
    dy, dx = f32(y2 - y1), f32(x2 - x1)
    tol = f32(keps * f32(f32(1.0) + f32(abs(dx) / max(abs(dy), eps))))
    t = ((yf - y1) / dy).astype(f32)
    x_round = (x1 + (t * dx).astype(f32)).astype(f32)
    x_fused = _fma_f32(t, np.full_like(t, dx), np.full_like(t, x1))
    # xf a few ulps either side of xint - tol, where the xints can disagree
    base = (x_round - tol).astype(f32)
    xf = np.concatenate([base] + [np.nextafter(base, f32(s * np.inf)) for s in (-1, 1)])
    yf, x_round, x_fused = (np.tile(a, 3) for a in (yf, x_round, x_fused))
    band_round = np.abs((xf - x_round).astype(f32)) < tol
    band_fused = np.abs((xf - x_fused).astype(f32)) < tol
    flip = np.flatnonzero(band_round != band_fused)[:200]
    assert len(flip) >= 20
    n = len(flip)
    ref, port, cols = _stores(np.concatenate([xf[flip].astype(np.float64), [-59.0, 59.0]]),
                              np.concatenate([yf[flip].astype(np.float64), [84.0, 84.0]]),
                              name="s")
    tilted = "POLYGON ((-60 50, 60 80, 60 85, -60 85, -60 50))"
    # a second polygon: a stream of one would take the candidate route
    cqls = [f"intersects(geom, {tilted})", f"intersects(geom, {TRIANGLE})"]
    got = _parity(ref, port, cqls, path="device-batch-dual/bitmap", name="s")
    sl = np.array([[-60, 50], [60, 80], [60, 85], [-60, 85], [-60, 50]], np.float64)
    want = set(cols["__fid__"][pip(sl, cols["geom__x"], cols["geom__y"])].tolist())
    assert set(got[0].fids.tolist()) == want
    # the port's band: one rounding per operation
    table = port._tables["s"]["z2"]
    pseg = port.executor.device_index(table).segments[0]
    pdesc = port.executor._poly_batch_desc(table, port._plan_cached("s", Query.cql(cqls[0])))
    hit, dec = poly_planes(pseg.xk, pseg.yk, pseg.valid, torch.from_numpy(pdesc[1]), pseg.xf,
                           pseg.yf, torch.from_numpy(pdesc[0]))
    port_band = _band_by_source(table.blocks[0].full_col("__fid__"), hit.numpy(), dec.numpy(), n)
    assert np.array_equal(port_band, band_round[flip])
    # the reference's band on the CPU: the fused form
    rtable = ref._tables["s"]["z2"]
    rseg = ref.executor.device_index(rtable).segments[0]
    assert rseg.load_poly(rtable)
    rdesc = ref.executor._poly_batch_desc(rtable, ref._plan_cached("s", RefQuery.cql(cqls[0])))
    body = jax.jit(ref_ex._poly_mask_body(False, "local", _mesh()))
    rhit, rdec = (np.asarray(a) for a in body(
        rseg.xk_hi, rseg.xk_lo, rseg.yk_hi, rseg.yk_lo, rseg.valid, rseg.xf, rseg.yf,
        jnp.asarray(_padded_edges([rdesc], 8)[0]), jnp.asarray(rdesc[1]),
        jnp.asarray(np.zeros(4, np.uint32))))
    ref_band = _band_by_source(rtable.blocks[0].full_col("__fid__"), rhit, rdec, n)
    assert np.array_equal(ref_band, band_fused[flip])


# -- the store ------------------------------------------------------------------


def test_star_stream_matches_reference_and_oracle(stores):
    """bench_poly's jittered stars through query_many: the dual bitmap
    route in both packages, every answer the f64 oracle's (no uniform point
    lies on a star's boundary)."""
    ref, port, cols = stores
    polys = stars(6)
    got = _parity(ref, port, [f"intersects(geom, {wkt(p)})" for p in polys],
                  path="device-batch-dual/bitmap")
    for p, r in zip(polys, got):
        want = pip(p, cols["geom__x"], cols["geom__y"])
        assert set(r.fids.tolist()) == set(cols["__fid__"][want].tolist())


def test_polygons_with_time_match_reference(stores):
    ref, port, _cols = stores
    cqls = [f"intersects(geom, {g}) AND {_during(d, d + 8)}"
            for g, d in ((TRIANGLE, 2), (CONCAVE, 5), (HOLED, 1), (MULTI, 9), (STAR, 3))]
    got = _parity(ref, port, cqls, path="device-batch-dual/bitmap")
    assert all(r.plan.index.name == "z3" for r in got) and all(len(r) for r in got)


def test_boundary_points_match_reference(stores):
    """Points on edges, vertices and a horizontal edge sit in the band:
    the host decides them, as in the reference."""
    ref, port, cols = stores
    cqls = [f"intersects(geom, {g})" for g in (TRIANGLE, CONCAVE, HOLED, MULTI)]
    got = _parity(ref, port, cqls, path="device-batch-dual/bitmap")
    on_edge = {f"f{30_000 + i}" for i in range(41)}  # the triangle's edge
    assert on_edge <= set(got[0].fids.tolist())


def test_near_horizontal_long_edge_band():
    rng = np.random.default_rng(10)
    x = np.concatenate([rng.uniform(-65, 65, 20_000), rng.uniform(-70, 70, 5000)])
    y = np.concatenate([50.0 + rng.uniform(-0.002, 0.002, 20_000), rng.uniform(20, 70, 5000)])
    ref, port, _cols = _stores(x, y, name="h")
    sliver = "POLYGON ((-60 50, 60 50.0003, 60 65, -60 65, -60 50))"
    sliver2 = "POLYGON ((-60 50.0001, 60 50.0004, 60 65, -60 65, -60 50.0001))"
    _parity(ref, port, [f"intersects(geom, {g})" for g in (sliver, sliver2)],
            path="device-batch-dual/bitmap", name="h")


def test_overlapping_multipolygon_and_rectangle_decline(stores):
    """An overlapping MultiPolygon takes the candidate route, a rectangle
    the exact box batch: as in the reference."""
    ref, port, _cols = stores
    overlap2 = OVERLAP.replace("30 30", "31 31")
    rect2 = RECT.replace("-10", "-11")
    _parity(ref, port, [f"intersects(geom, {OVERLAP})", f"intersects(geom, {overlap2})"],
            path="device-mask/runs")
    _parity(ref, port, [f"intersects(geom, {RECT})", f"intersects(geom, {rect2})"],
            path="device-exact/bitmap")


def test_lone_polygon_takes_the_candidate_route(stores):
    """A polygon alone (store.query, or a stream of one) takes the
    reference's route for a query alone: the candidate mask and the host
    post-filter."""
    ref, port, cols = stores
    cql = f"intersects(geom, {STAR})"
    p, r = port.query("t", cql), ref.query("t", cql)
    assert p.plan.scan_path == r.plan.scan_path == "device-mask/runs"
    assert set(p.fids.tolist()) == set(r.fids.tolist())
    _parity(ref, port, [cql], path="device-mask/runs")


def test_polygon_with_attribute_predicate(stores):
    """A polygon AND an attribute predicate: the port answers on the dual
    plane with the attribute edition of ``poly_dual_bitmap``, as the
    reference does. The answers are equal."""
    ref, port, _cols = stores
    cqls = [f"intersects(geom, {g}) AND actor = 'a'" for g in (STAR, HOLED)]
    got = port.query_many("t", [Query.cql(c, properties=[]) for c in cqls])
    want = ref.query_many("t", [RefQuery.cql(c, properties=[]) for c in cqls])
    for p, r in zip(got, want):
        assert p.plan.scan_path == r.plan.scan_path == "device-batch-dual/bitmap"
        assert set(p.fids.tolist()) == set(r.fids.tolist()) and len(p)


@pytest.mark.parametrize("pattern", ["span", "runs"])
def test_span_overflow_refetches_alone(stores, pattern):
    """A span window narrower than the queries' spans: each refetches
    alone at q = 1 (dual runs); with a run capacity of 4 those escalate
    (or degrade to the packed planes). Answers equal the reference's."""
    ref, port, _cols = stores
    cqls = [f"intersects(geom, {g})" for g in (CONCAVE, HOLED, TRIANGLE, MULTI)]
    port.query_many("t", [Query.cql(c) for c in cqls])  # the mirror
    seg = port.executor.device_index(port._tables["t"]["z2"]).segments[0]
    calls = []
    single = port_ex.DeviceSegment.dispatch_poly

    def counting(self, *a):
        calls.append(1)
        return single(self, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_ex.DeviceSegment, "dispatch_poly", counting)
        seg._span_cap = 8
        if pattern == "runs":
            seg._rcap = 4
        _parity(ref, port, cqls, path="device-batch-dual/bitmap")
    assert len(calls) == len(cqls)
    seg._span_cap = 0
    seg._rcap = port_ex.HIT_CAPACITY0


def test_chunking_past_batch_max(stores, monkeypatch):
    """Chunks of 3 and a lone tail (the candidate route), as the reference
    chunks them."""
    ref, port, _cols = stores
    monkeypatch.setattr(port_ex.TorchScanExecutor, "BATCH_MAX", 3)
    monkeypatch.setattr(ref_ex.TpuScanExecutor, "BATCH_MAX", 3)
    polys = [TRIANGLE, CONCAVE, HOLED, MULTI, STAR, wkt(star(-30.0, -30.0, 8.0)),
             wkt(star(30.0, 30.0, 8.0))]
    got = _parity(ref, port, [f"intersects(geom, {g})" for g in polys])
    assert [r.plan.scan_path for r in got] == ["device-batch-dual/bitmap"] * 6 + [
        "device-mask/runs"]


@pytest.mark.parametrize("mode", ["auto", "0", "1"])
def test_routes_under_seek_modes(stores, monkeypatch, mode):
    """A mixed stream (small stars the seek takes under auto, the wide
    concave polygon it leaves to the device, a holed polygon with a
    window) under each GEOMESA_SEEK: the reference's routes and fids."""
    ref, port, _cols = stores
    monkeypatch.setenv("GEOMESA_SEEK", mode)
    cqls = [f"intersects(geom, {wkt(star(0.0, 0.0, 4.0))})",
            f"intersects(geom, {wkt(star(20.0, -10.0, 3.0))})",
            f"intersects(geom, {CONCAVE})",
            f"intersects(geom, {HOLED}) AND {_during(2, 6)}",
            f"intersects(geom, {MULTI})"]
    got = _parity(ref, port, cqls)
    routes = [r.plan.scan_path for r in got]
    if mode == "1":
        assert set(routes) == {"host-seek"}
    elif mode == "0":
        assert "host-seek" not in routes
    else:
        assert "host-seek" in routes


def test_polygon_stream_over_several_segments():
    """Two ingests make two device segments: each runs its own batch and
    the answers join, as in the reference."""
    rng = np.random.default_rng(13)
    ref = TpuDataStore(executor=TpuScanExecutor(_mesh()))
    port = TorchDataStore(device="cpu")
    for s in (ref, port):
        s.create_schema((ref_parse_spec if s is ref else parse_spec)("two", SPEC))
    for part in range(2):
        n = 8000
        cols = {"__fid__": np.char.add(f"p{part}_", np.arange(n).astype("<U4")),
                "geom__x": rng.uniform(-70, 70, n), "geom__y": rng.uniform(-70, 70, n),
                "dtg": T0 + rng.integers(0, 20 * DAY, n),
                "actor": np.array(["a", "b"], dtype=object)[rng.integers(0, 2, n)]}
        for s in (ref, port):
            s._insert_columns(s.get_schema("two"), dict(cols))
            s.executor.device_index(s._tables["two"]["z2"])  # a segment a batch
    assert len(port.executor.device_index(port._tables["two"]["z2"]).segments) == 2
    cqls = [f"intersects(geom, {g})" for g in (STAR, HOLED, MULTI, TRIANGLE)]
    got = _parity(ref, port, cqls, path="device-batch-dual/bitmap", name="two")
    assert all(len(r) for r in got)


# -- the attribute editions of the polygon plane -----------------------------------


def _poly_qcode(kind: str, rng):
    if kind == "range":
        return np.asarray([3, 40], dtype=np.int32)
    if kind == "vocabmask":
        return (rng.random(64) < 0.4).astype(np.uint8)
    return np.asarray([7, -1, 30, -2], dtype=np.int32)


@pytest.mark.parametrize("kind", ["member", "range", "notmember", "vocabmask"])
@pytest.mark.parametrize("index", ["z2", "z3"])
def test_poly_planes_attr_editions_match_reference(stores, carried, index, kind):
    """``poly_dual_bitmap_plain`` with each attribute edition against the
    reference's ``_poly_mask_body(..., attr=)``: the combine ANDed into hit
    before decided derives from it, both planes bit for bit."""
    ref, _port, _cols = stores
    seg, _arrays, pseg = carried[index]
    during = index == "z3"
    (d,) = _descs(ref, index, [STAR], during)
    edges = _padded_edges([d], 16)
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 50, pseg.n_padded).astype(np.int32)
    codes[rng.random(pseg.n_padded) < 0.1] = -1
    codes[pseg.n:] = -1
    qc = _poly_qcode(kind, rng)
    body = ref_ex._poly_mask_body(during, "local", _mesh(), kind)
    if during:
        args = (seg.xk_hi, seg.xk_lo, seg.yk_hi, seg.yk_lo, seg.tk_hi, seg.tk_lo, seg.tvalid,
                seg.xf, seg.yf, jnp.asarray(codes), jnp.asarray(edges[0]), jnp.asarray(d[1]),
                jnp.asarray(d[2]), jnp.asarray(qc))
    else:
        args = (seg.xk_hi, seg.xk_lo, seg.yk_hi, seg.yk_lo, seg.valid, seg.xf, seg.yf,
                jnp.asarray(codes), jnp.asarray(edges[0]), jnp.asarray(d[1]),
                jnp.asarray(np.zeros(4, np.uint32)), jnp.asarray(qc))
    want_hit, want_dec = (np.asarray(a) for a in jax.jit(body)(*args))
    box, win = _port_args([d], during)
    hb, db, hdr = kernels.poly_dual_bitmap(
        pseg.xk, pseg.yk, pseg.tvalid if during else pseg.valid, pseg.xf, pseg.yf,
        torch.from_numpy(edges), box, win, pseg.tk if during else None,
        torch.from_numpy(codes), torch.from_numpy(qc[None]), kind)
    assert np.array_equal(unpack_mask_rows(hb[0]).numpy(), want_hit)
    assert np.array_equal(unpack_mask_rows(db[0]).numpy(), want_dec)
    rows = np.flatnonzero(want_hit)
    assert len(rows) and hdr.tolist() == [[len(rows), rows[0], rows[-1]]]


# two queries an edition, so each edition batches as the reference's does
_ACTOR_PREDS = ["actor = 'a'", "actor IN ('b', 'c')", "actor >= 'b'", "actor < 'b'",
                "actor <> 'a'", "actor <> 'b' AND actor <> 'c'", "actor LIKE '%b%'",
                "actor ILIKE 'C'"]


@pytest.mark.parametrize("mode", ["auto", "0", "1"])
def test_polygon_attr_streams_and_counts_match_reference(stores, monkeypatch, mode):
    """Jittered stars AND an attribute predicate (every edition, two
    queries each; the range pair with a window) through ``query_many``: the
    reference's fids and routes (under 0 the dual plane); each through
    ``query`` (alone: the candidate route, as the reference's) and its
    count under ``GEOMESA_COUNT_DEVICE=1`` (the q = 1 ray cast with the
    attribute plane), equal to the reference's."""
    ref, port, _cols = stores
    monkeypatch.setenv("GEOMESA_SEEK", mode)
    cqls = [f"{pred} AND intersects(geom, {wkt(s)})"
            for pred, s in zip(_ACTOR_PREDS, stars(len(_ACTOR_PREDS), seed=12))]
    for i in (2, 3):  # the range pair with a window: a z3 batch of two
        cqls[i] += f" AND {_during(2, 9)}"
    got = _parity(ref, port, cqls)
    if mode == "0":
        assert {p.plan.scan_path for p in got} == {"device-batch-dual/bitmap"}
    assert all(len(p) for p in got)
    monkeypatch.setenv("GEOMESA_COUNT_DEVICE", "1")
    for cql, p in zip(cqls, got):
        lone, r = port.query("t", cql), ref.query("t", RefQuery.cql(cql))
        assert lone.plan.scan_path == r.plan.scan_path, cql
        assert set(lone.fids.tolist()) == set(p.fids.tolist()) == set(r.fids.tolist()), cql
        assert port.count("t", cql) == ref.count("t", cql) == len(p), cql
