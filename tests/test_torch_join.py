"""The port's spatial joins (``geomesa_tpu_torch/ops/join.py`` and
``TorchDataStore.query_join``) against the JAX package, on the CPU.

Kernel level: ``join_pip_plain`` against the reference's ``_pip_fn()`` bit
for bit on seeded random rows and on degenerate ones (a row on an edge, on
a vertex, on a shared corner, NaN pads, -1 slots, a geometry with no edges,
a polygon with a hole); ``join_dwithin_plain`` against ``_dwithin_fn()``,
equal except pairs whose f32 distance lies within ``ULPS`` ulps of ``r -
eps`` or ``r + eps``, where XLA's and torch's f32 ``sin`` / ``cos`` /
``asin`` may round a pair across the threshold (the pair then moves between
accept and check; the host decides every check pair in f64, so the join's
pairs do not change). The chunk wrappers (``kernels.join_pip`` /
``join_dwithin``) take their plain chunk editions on CPU tensors, equal to
the per-group plain edition; on any other device that is not CUDA they
raise ``KernelArgumentError`` (no fallback).

Build state: the port's ``JoinBuild`` on the same rows and knobs as the
reference's gives the same buckets, splits, bucket rows, candidate matrix
and cap, expanded envelopes, stats and route() groups, on skewed,
antimeridian and polar builds.

Store level: port twins of ``tests/test_join.py`` (each named after its
reference's line): pairs equal the reference store's ``query_join`` (its
device path on a one-device CPU mesh, and its host path) and this file's
own pure-numpy reference, in canonical order. The port store runs on the
CPU (``TorchDataStore(device="cpu")``: the kernels' plain editions), and
its device-join path is taken. The web (``:314``, ``:766``, ``:908``), SQL
(``:360``, ``:382``), lazy-fs (``:478``) and sharded (``:593``, ``:802``)
cases wait for the port's web surface, SQL layer, file store and sharded
store.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomesa_tpu.geom.base import Point as RefPoint
from geomesa_tpu.geom.base import Polygon as RefPolygon
from geomesa_tpu.ops import join as ref_join
from geomesa_tpu.parallel import TpuScanExecutor, default_mesh
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore
from geomesa_tpu.utils.config import properties as ref_properties

from geomesa_tpu_torch.geom.base import MultiPolygon, Point, Polygon
from geomesa_tpu_torch.ops import join as port_join
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.geometry import (
    dwithin_threshold_band,
    join_dwithin_distances,
    join_dwithin_plain,
    join_pip_plain,
    polygon_edges,
    snap_epsilon_deg,
    snap_epsilon_m,
)
from geomesa_tpu_torch.ops.join import JoinBuild, JoinError, JoinSpec, host_join, join_debug
from geomesa_tpu_torch.process.geodesy import haversine_m
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.utils import faults, trace
from geomesa_tpu_torch.utils.audit import (
    InMemoryAuditWriter,
    MetricsRegistry,
    QueryTimeout,
    ShedLoad,
    robustness_metrics,
)
from geomesa_tpu_torch.utils.config import properties
from join_layouts import LAYOUT_EPS_DEG, LAYOUT_RADIUS_M
from join_layouts import LAYOUTS as JOIN_LAYOUTS
from join_layouts import edge_table as join_edge_table
from join_layouts import layout as join_layout
from join_layouts import sites as join_sites

T0 = 1483228800000
# the ulps of f32 distance within which join_dwithin's accept / check may
# differ between XLA's and torch's f32 transcendental functions
ULPS = 4

ZONE_RINGS = [
    # two rectangles SHARING the edge x=5 (touching edges), plus a triangle
    # with a vertex exactly at (20, 20)
    [[0, 0], [5, 0], [5, 10], [0, 10], [0, 0]],
    [[5, 0], [10, 0], [10, 10], [5, 10], [5, 0]],
    [[20, 20], [30, 20], [25, 30], [20, 20]],
]
ZONES = [Polygon(r) for r in ZONE_RINGS]
REF_ZONES = [RefPolygon(r) for r in ZONE_RINGS]
DONUT = ([[0, 0], [10, 0], [10, 10], [0, 10], [0, 0]],
         [[[3, 3], [7, 3], [7, 7], [3, 7], [3, 3]]])


def _ref_poly(p: Polygon) -> RefPolygon:
    return RefPolygon(p.shell.tolist(), holes=[h.tolist() for h in p.holes])


# -- this file's own references ------------------------------------------------


def _point_in_poly_ref(x, y, poly) -> np.ndarray:
    """Even-odd ray cast over shell + holes with an explicit boundary test,
    pure numpy."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    inside = np.zeros(len(x), dtype=bool)
    on_edge = np.zeros(len(x), dtype=bool)
    for ring in [poly.shell] + list(poly.holes or []):
        r = np.asarray(ring, float)
        for i in range(len(r) - 1):
            (x0, y0), (x1, y1) = r[i], r[i + 1]
            straddles = (y0 > y) != (y1 > y)
            with np.errstate(divide="ignore", invalid="ignore"):
                xint = x0 + (y - y0) * (x1 - x0) / ((y1 - y0) or 1.0)
            inside ^= straddles & (xint > x)
            abx, aby = x1 - x0, y1 - y0
            den = abx * abx + aby * aby
            t = np.clip(((x - x0) * abx + (y - y0) * aby) / (den if den else 1.0), 0.0, 1.0)
            d2 = (x - (x0 + t * abx)) ** 2 + (y - (y0 + t * aby)) ** 2
            on_edge |= d2 == 0.0
    return inside | on_edge


def _pairs_contains(polys, fids_b, px, py, fids_p):
    out = set()
    for gi, p in enumerate(polys):
        m = _point_in_poly_ref(px, py, p) & ~np.isnan(px) & ~np.isnan(py)
        out.update((str(fids_b[gi]), str(fids_p[i])) for i in np.flatnonzero(m))
    return out


def _pairs_dwithin(bx, by, fids_b, px, py, fids_p, r):
    out = set()
    for gi in range(len(bx)):
        d = haversine_m(px, py, bx[gi], by[gi])
        m = (d <= r) & ~np.isnan(px) & ~np.isnan(py)
        out.update((str(fids_b[gi]), str(fids_p[i])) for i in np.flatnonzero(m))
    return out


# -- store pairs ----------------------------------------------------------------


def _events(n, seed, boundary_probes):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, 35, n)
    y = rng.uniform(-5, 35, n)
    if boundary_probes and n >= 12:
        x[0], y[0] = 5.0, 5.0      # ON the touching edge
        x[1], y[1] = 20.0, 20.0    # ON a polygon vertex
        x[2], y[2] = 5.0, 0.0      # the rectangles' shared corner
        x[3], y[3] = np.nan, np.nan  # a null geometry
    return x, y


def _fill(store, spec_fn, x, y, zones):
    n = len(x)
    store.create_schema(spec_fn("events", "kind:String,dtg:Date,*geom:Point:srid=4326"))
    store._insert_columns(store.get_schema("events"), {
        "__fid__": np.array([f"e{i}" for i in range(n)], dtype=object),
        "kind": np.array([f"k{i % 3}" for i in range(n)], dtype=object),
        "geom__x": x, "geom__y": y,
        "dtg": np.full(n, T0, dtype=np.int64),
    })
    store.create_schema(spec_fn("zones", "zname:String,*geom:Polygon:srid=4326"))
    with store.writer("zones") as w:
        for i, p in enumerate(zones):
            w.write([f"z{i}", p], fid=f"g{i}")


def _port(n=300, seed=0, zones=ZONES, boundary_probes=True, **kw):
    x, y = _events(n, seed, boundary_probes)
    store = TorchDataStore(device="cpu", **kw)
    _fill(store, parse_spec, x, y, zones)
    return store, x, y


_REF_CACHE = {}


def _ref_pairs(kind, n=300, seed=0, zones=None, boundary_probes=True, build="zones",
               probe="events", predicate="contains", knobs=()):
    """(device pairs, host pairs) of the reference store on the same rows,
    memoized per case."""
    key = (kind, n, seed, None if zones is None else repr(zones), boundary_probes, repr(build),
           repr(probe), predicate, knobs)
    got = _REF_CACHE.get(key)
    if got is None:
        x, y = _events(n, seed, boundary_probes)
        rz = REF_ZONES if zones is None else [_ref_poly(z) for z in zones]
        out = []
        for device in (True, False):
            store = TpuDataStore(executor=TpuScanExecutor(default_mesh()) if device else None)
            _fill(store, ref_parse_spec, x, y, rz)
            with ref_properties(**dict(knobs)):
                res = store.query_join(build, probe, predicate=predicate)
            assert res.stats["path"] == ("device-join" if device else "host-join")
            out.append(res.pairs())
        got = _REF_CACHE[key] = tuple(out)
    return got


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("GEOMESA_SEEK", "0")
    monkeypatch.delenv("GEOMESA_JOIN_DEVICE", raising=False)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- kernel editions -------------------------------------------------------------


def _edge_table(polys):
    edges = [polygon_edges(p) for p in polys]
    e_pad = max(8, 1 << int(np.ceil(np.log2(max(len(e) for e in edges)))))
    out = np.zeros((len(polys) + 1, e_pad, 4), np.float32)  # the last: no edges
    cnt = np.zeros(len(polys) + 1, np.int32)
    for i, e in enumerate(edges):
        out[i, :len(e)] = e
        cnt[i] = len(e)
    return out, cnt


def _pip_rows(seed):
    rng = np.random.default_rng(seed)
    px = rng.uniform(-2, 32, 256).astype(np.float32)
    py = rng.uniform(-2, 32, 256).astype(np.float32)
    # degenerate rows: on an edge, on a vertex, the shared corner, inside the
    # donut's hole, on the hole's edge, NaN pads
    for i, (a, b) in enumerate([(5, 5), (20, 20), (5, 0), (5, 5), (3, 5), (10, 10), (25, 30),
                                (7, 7), (np.nan, np.nan)]):
        px[i], py[i] = a, b
    px[-8:] = np.nan
    py[-8:] = np.nan
    return px, py


@pytest.mark.parametrize("seed", [0, 1])
def test_join_pip_plain_matches_pip_fn_bit_for_bit(seed):
    polys = ZONES + [Polygon(DONUT[0], holes=DONUT[1])]
    edges, ecnt = _edge_table(polys)
    px, py = _pip_rows(seed)
    eps = np.float32(max(snap_epsilon_deg(), port_join.PIP_BAND_DEG))
    # -1 slots and the edgeless geometry (index 4) among the candidates
    cand = np.array([0, 1, 2, 3, 4, -1, 2, -1], np.int32)
    want = ref_join._pip_fn()(jnp.asarray(px), jnp.asarray(py), jnp.asarray(cand),
                              jnp.asarray(edges), jnp.asarray(ecnt), eps)
    got = join_pip_plain(torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(cand),
                         torch.from_numpy(edges), torch.from_numpy(ecnt), eps)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    acc, chk = (g.numpy() for g in got)
    assert chk[0, 0] and chk[0, 1]     # the shared edge: near both rectangles
    # the donut's hole edge is near; a row inside its hole is out
    assert chk[4, 3] and not (acc[3, 3] or chk[3, 3])
    assert not (acc[:, 4] | chk[:, 4] | acc[:, 5] | chk[:, 5]).any()
    assert not (acc[-8:] | chk[-8:]).any()
    assert acc.any()


@pytest.mark.parametrize("radius", [300_000.0, 5000.0])
def test_join_dwithin_plain_matches_dwithin_fn_outside_the_ulp_band(radius):
    rng = np.random.default_rng(int(radius))
    gx = rng.uniform(-20, 20, 16).astype(np.float32)
    gy = rng.uniform(-20, 20, 16).astype(np.float32)
    gx[3] = gy[3] = np.nan  # a null build geometry
    px = rng.uniform(-25, 25, 512).astype(np.float32)
    py = rng.uniform(-25, 25, 512).astype(np.float32)
    px[-5:] = np.nan
    # rows placed at the threshold: on a build point's parallel at r - eps
    eps = np.float32(snap_epsilon_m(radius))
    r32 = np.float32(radius)
    for i in range(8):
        px[i] = gx[i % 3]
        py[i] = np.float32(gy[i % 3] + (r32 - eps + (i - 4)) / 111195.0)
    cand = np.array(list(range(16)) + [-1] * 16, np.int32)
    want = ref_join._dwithin_fn()(jnp.asarray(px), jnp.asarray(py), jnp.asarray(cand),
                                  jnp.asarray(gx), jnp.asarray(gy), r32, eps)
    t = [torch.from_numpy(a) for a in (px, py, cand, gx, gy)]
    got = join_dwithin_plain(*t, r32, eps)
    band = dwithin_threshold_band(join_dwithin_distances(*t), r32, eps, ULPS).numpy()
    for g, w in zip(got, want):
        diff = g.numpy() != np.asarray(w)
        assert not (diff & ~band).any()
    acc, chk = (g.numpy() for g in got)
    assert acc.any() and not (acc[:, 16:] | chk[:, 16:]).any()
    assert not (acc[:, 3] | chk[:, 3]).any() and not (acc[-5:] | chk[-5:]).any()


def test_geometry_f32_predicates_match_the_reference():
    """``points_in_polygon_f32`` bit for bit; ``haversine_m_f32`` within 4
    ulps of XLA's and ``dwithin_mask_f32`` equal outside that band."""
    from geomesa_tpu.ops import geometry as ref_geometry

    from geomesa_tpu_torch.ops import geometry

    donut = Polygon(DONUT[0], holes=DONUT[1])
    edges = polygon_edges(donut)
    assert np.array_equal(edges, ref_geometry.polygon_edges(_ref_poly(donut)))
    px, py = _pip_rows(4)
    want = ref_geometry.points_in_polygon_f32(jnp.asarray(px), jnp.asarray(py),
                                              jnp.asarray(edges))
    got = geometry.points_in_polygon_f32(torch.from_numpy(px), torch.from_numpy(py),
                                         torch.from_numpy(edges))
    assert np.array_equal(got.numpy(), np.asarray(want)) and got.any()
    want_d = np.asarray(ref_geometry.haversine_m_f32(jnp.asarray(px), jnp.asarray(py),
                                                     np.float32(5.0), np.float32(5.0)))
    got_d = geometry.haversine_m_f32(torch.from_numpy(px), torch.from_numpy(py),
                                     torch.tensor(np.float32(5.0)),
                                     torch.tensor(np.float32(5.0))).numpy()
    live = ~np.isnan(want_d)
    assert np.array_equal(np.isnan(got_d), ~live)
    ulp = np.spacing(np.abs(want_d[live]).astype(np.float32))
    assert (np.abs(got_d[live] - want_d[live]) <= ULPS * ulp).all()
    r = 900_000.0
    want_m = np.asarray(ref_geometry.dwithin_mask_f32(jnp.asarray(px), jnp.asarray(py), 5.0,
                                                      5.0, r))
    got_m = geometry.dwithin_mask_f32(torch.from_numpy(px), torch.from_numpy(py), 5.0, 5.0,
                                      r).numpy()
    hi = np.float32(np.float32(r) + np.float32(snap_epsilon_m(r)))
    band = np.abs(got_d.astype(np.float64) - hi) <= ULPS * np.spacing(hi)
    assert not ((got_m != want_m) & ~band).any() and got_m.any()
    assert snap_epsilon_m(r) == ref_geometry.snap_epsilon_m(r)


def _chunk(seed, groups=3):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 40, groups)
    goff = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    px = rng.uniform(-2, 32, goff[-1]).astype(np.float32)
    py = rng.uniform(-2, 32, goff[-1]).astype(np.float32)
    cand = np.array([[0, 1, -1, -1], [2, 3, 0, -1], [1, -1, -1, -1]], np.int32)
    grow = rng.integers(0, 3, groups).astype(np.int32)
    return px, py, goff, grow, cand


def test_chunk_wrappers_equal_the_per_group_plain_edition():
    polys = ZONES + [Polygon(DONUT[0], holes=DONUT[1])]
    edges, ecnt = _edge_table(polys)
    px, py, goff, grow, cand = _chunk(3)
    eps = np.float32(1e-3)
    args = [torch.from_numpy(a) for a in (px, py, goff, grow, cand)]
    flags = kernels.join_pip(*args, torch.from_numpy(edges), torch.from_numpy(ecnt), eps)
    bx = torch.from_numpy(np.array([1.0, 5.0, 20.0, 25.0, 0.0], np.float32))
    by = torch.from_numpy(np.array([1.0, 5.0, 22.0, 25.0, 0.0], np.float32))
    dflags = kernels.join_dwithin(*args, bx, by, 400_000.0, 20.0)
    assert flags.shape == dflags.shape == (4, len(px)) and flags.dtype == torch.uint8
    for g in range(len(grow)):
        r0, r1 = goff[g], goff[g + 1]
        rows = slice(r0, r1)
        c = torch.from_numpy(cand[grow[g]])
        acc, chk = join_pip_plain(args[0][rows], args[1][rows], c, torch.from_numpy(edges),
                                  torch.from_numpy(ecnt), eps)
        assert torch.equal(flags[:, rows], (acc.to(torch.uint8) | chk.to(torch.uint8) << 1).t())
        acc, chk = join_dwithin_plain(args[0][rows], args[1][rows], c, bx, by, 400_000.0, 20.0)
        assert torch.equal(dflags[:, rows], (acc.to(torch.uint8) | chk.to(torch.uint8) << 1).t())
    assert (flags & 1).any() and (dflags & 1).any()


def _ref_group_flags(fn, layout_args, *rest):
    """u8 flags [C, R] of the reference's per-group kernel ``fn`` (``_pip_fn()``
    or ``_dwithin_fn()``) over a chunk layout: each group's rows NaN-padded
    to a power of two (at least 8), as the reference launches them, against
    its candidate row."""
    px, py, goff, grow, cand = layout_args
    out = np.zeros((cand.shape[1], len(px)), np.uint8)
    for g in range(len(grow)):
        r0, r1 = int(goff[g]), int(goff[g + 1])
        pad = max(8, 1 << int(np.ceil(np.log2(r1 - r0))))
        gx = np.full(pad, np.nan, np.float32)
        gy = np.full(pad, np.nan, np.float32)
        gx[:r1 - r0], gy[:r1 - r0] = px[r0:r1], py[r0:r1]
        acc, chk = fn(jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(cand[grow[g]]),
                      *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in rest))
        acc, chk = np.asarray(acc)[:r1 - r0], np.asarray(chk)[:r1 - r0]
        out[:, r0:r1] = (acc.astype(np.uint8) | chk.astype(np.uint8) << 1).T
    return out


@pytest.mark.parametrize("name", sorted(JOIN_LAYOUTS))
def test_join_pip_chunk_plain_matches_pip_fn_on_every_layout(name):
    """``join_pip_chunk_plain`` (the card kernel's plain edition) equals the
    reference's ``_pip_fn()`` group by group, bit for bit, on the layouts
    that a grid of row tiles x candidate slots can get wrong
    (``tests/join_layouts.py``; the card tests hold the kernel to the plain
    edition on the same layouts)."""
    args = join_layout(name)
    edges, ecnt = join_edge_table(name)
    eps = np.float32(LAYOUT_EPS_DEG)
    got = kernels.join_pip_chunk_plain(*(torch.from_numpy(a) for a in args),
                                       torch.from_numpy(edges), torch.from_numpy(ecnt),
                                       eps).numpy()
    want = _ref_group_flags(ref_join._pip_fn(), args, edges, ecnt, eps)
    assert np.array_equal(got, want)
    assert (got & 1).any() and (got & 2).any()


@pytest.mark.parametrize("name", sorted(JOIN_LAYOUTS))
def test_join_dwithin_chunk_plain_matches_dwithin_fn_on_every_layout(name):
    """``join_dwithin_chunk_plain`` against the reference's
    ``_dwithin_fn()`` group by group on the same layouts: equal except
    pairs within ``ULPS`` ulps of a threshold."""
    args = join_layout(name)
    bx, by = join_sites()
    r32 = np.float32(LAYOUT_RADIUS_M)
    eps = np.float32(snap_epsilon_m(LAYOUT_RADIUS_M))
    t = [torch.from_numpy(a) for a in args]
    got = kernels.join_dwithin_chunk_plain(*t, torch.from_numpy(bx), torch.from_numpy(by),
                                           r32, eps).numpy()
    want = _ref_group_flags(ref_join._dwithin_fn(), args, bx, by, r32, eps)
    rc = kernels._group_candidates(len(args[0]), t[2], t[3], t[4])
    band = dwithin_threshold_band(
        join_dwithin_distances(t[0], t[1], rc, torch.from_numpy(bx), torch.from_numpy(by)),
        r32, eps, ULPS).t().numpy()
    assert not ((got != want) & ~band).any()
    assert (got & 1).any()


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    """A tensor on a device with no kernel and no plain edition (the meta
    device) raises ``KernelArgumentError``: the wrappers never fall back."""
    meta = torch.device("meta")
    px = torch.empty(8, dtype=torch.float32, device=meta)
    i32 = torch.empty(2, dtype=torch.int32, device=meta)
    cand = torch.empty((1, 8), dtype=torch.int32, device=meta)
    with pytest.raises(kernels.KernelArgumentError):
        kernels.join_pip(px, px, i32, i32[:1], cand, torch.empty((1, 8, 4), device=meta),
                         i32[:1], 1e-3)
    with pytest.raises(kernels.KernelArgumentError):
        kernels.join_dwithin(px, px, i32, i32[:1], cand, px, px, 10.0, 1.0)


# -- build state -----------------------------------------------------------------


def _stars(n, seed, lo=(-12.0, -8.0), hi=(12.0, 8.0), r=(0.2, 1.5)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(lo[0], hi[0]), rng.uniform(lo[1], hi[1])
        k = int(rng.integers(4, 12))
        ang = np.linspace(0, 2 * np.pi, 2 * k + 1)[:-1]
        rad = np.where(np.arange(2 * k) % 2 == 0, 1.0, 0.45) * rng.uniform(*r)
        ring = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
        out.append(np.vstack([ring, ring[:1]]).tolist())
    return out


def _builds(kind, rings_or_pts, radius=0.0):
    spec = "zname:String,*geom:Polygon:srid=4326" if kind == "contains" \
        else "zname:String,*geom:Point:srid=4326"
    out = []
    for mod, spec_fn, poly_cls in ((ref_join, ref_parse_spec, RefPolygon),
                                   (port_join, parse_spec, Polygon)):
        js = mod.JoinSpec("contains") if kind == "contains" else mod.JoinSpec("dwithin", radius)
        ft = spec_fn("z", spec)
        n = len(rings_or_pts)
        fids = np.array([f"g{i}" for i in range(n)], dtype=object)
        cols = {"__fid__": fids}
        if kind == "contains":
            geoms = [poly_cls(r) for r in rings_or_pts]
            geoms[1] = None  # a null geometry
            out.append(mod.JoinBuild(js, ft, cols, fids, geoms, None, None))
        else:
            bx = np.array([p[0] for p in rings_or_pts], float)
            by = np.array([p[1] for p in rings_or_pts], float)
            bx[2] = by[2] = np.nan
            out.append(mod.JoinBuild(js, ft, cols, fids, None, bx, by))
    return out


BUILD_CASES = {
    # 60 stars in one base cell: the adaptive splits run (threshold 8)
    "skewed": ("contains", lambda: _stars(60, 1, lo=(1.0, 1.0), hi=(20.0, 20.0), r=(0.1, 0.8)),
               0.0),
    # points astride the antimeridian at a 50 km radius
    "antimeridian": ("dwithin", lambda: [(179.95 - 0.01 * i, (i % 7) - 3.0) for i in range(30)]
                     + [(-179.95 + 0.01 * i, (i % 5) - 2.0) for i in range(30)], 50_000.0),
    # points near both poles: caps over a pole cover every column
    "polar": ("dwithin", lambda: [(10.0 * i - 170.0, 89.5 - 0.01 * i) for i in range(35)]
              + [(7.0 * i - 120.0, -89.9) for i in range(25)], 25_000.0),
}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_join_build_state_equals_the_reference(case):
    kind, make, radius = BUILD_CASES[case]
    env = {"geomesa_join_skew_threshold": "8", "geomesa_join_split_depth": "3"}
    with ref_properties(**env), properties(**env):
        ref, port = _builds(kind, make(), radius)
    assert set(port.buckets) == set(ref.buckets)
    for c in ref.buckets:
        assert np.array_equal(port.buckets[c], np.asarray(ref.buckets[c])), c
    assert port.splits == ref.splits and port.bucket_rows == ref.bucket_rows
    assert port.cand_cap == ref.cand_cap and np.array_equal(port.cand, ref.cand)
    assert np.array_equal(port.envs, ref.envs) and np.array_equal(port.active, ref.active)
    assert port.stats == ref.stats
    if case == "skewed":
        assert port.splits
    rng = np.random.default_rng(5)
    if kind == "contains":
        px, py = rng.uniform(-5, 25, 4000), rng.uniform(-5, 25, 4000)
    else:
        px = np.concatenate([rng.uniform(179.0, 180.0, 2000), rng.uniform(-180.0, -179.0, 2000)])
        py = rng.uniform(-90, 90, 4000) if case == "polar" else rng.uniform(-5, 5, 4000)
    px[:3] = np.nan
    want = ref.route(px, py)
    got = port.route(px, py)
    assert set(got) == set(want) and got
    for c in want:
        assert np.array_equal(got[c], want[c]), c
    # the per-point descent the vectorized route replaces
    slow = port._route_per_point(px, py)
    assert set(slow) == set(got) and all(np.array_equal(slow[c], got[c]) for c in got)


# -- store twins of tests/test_join.py ---------------------------------------------


def test_contains_parity_device_host_reference():  # test_join.py:127
    store, x, y = _port()
    dev = store.query_join("zones", "events", predicate="contains")
    assert dev.stats["path"] == "device-join"
    os.environ["GEOMESA_JOIN_DEVICE"] = "0"
    try:
        host = store.query_join("zones", "events", predicate="contains")
    finally:
        del os.environ["GEOMESA_JOIN_DEVICE"]
    assert host.stats["path"] == "host-join"
    ref_dev, ref_host = _ref_pairs("contains")
    fids_p = [f"e{i}" for i in range(len(x))]
    want = _pairs_contains(ZONES, [f"g{i}" for i in range(3)], x, y, fids_p)
    assert dev.pairs() == host.pairs() == ref_dev == ref_host
    assert set(dev.pairs()) == want
    got = set(dev.pairs())
    assert ("g0", "e0") in got and ("g1", "e0") in got and ("g2", "e1") in got
    assert not any(p == "e3" for _b, p in got)


def test_dwithin_parity_device_host_reference():  # test_join.py:151
    r = 300_000.0
    store, x, y = _port(n=200, seed=1)
    b, p = ("events", "kind = 'k0'"), ("events", "kind <> 'k0'")
    dev = store.query_join(b, p, predicate=f"dwithin({r})")
    assert dev.stats["path"] == "device-join"
    ref_dev, ref_host = _ref_pairs("dwithin", n=200, seed=1, build=b, probe=p,
                                   predicate=f"dwithin({r})")
    assert dev.pairs() == ref_dev == ref_host
    k = np.array([f"k{i % 3}" for i in range(200)])
    bs, ps = np.flatnonzero(k == "k0"), np.flatnonzero(k != "k0")
    want = _pairs_dwithin(x[bs], y[bs], [f"e{i}" for i in bs], x[ps], y[ps],
                          [f"e{i}" for i in ps], r)
    assert set(dev.pairs()) == want and want


def test_empty_build_side_and_empty_probe():  # test_join.py:175
    store, _x, _y = _port()
    res = store.query_join(("zones", "zname = 'nope'"), "events", predicate="contains")
    assert len(res) == 0 and res.pairs() == []
    res2 = store.query_join("zones", ("events", "kind = 'nope'"), predicate="contains")
    assert len(res2) == 0


def test_polygon_with_hole_parity():  # test_join.py:185
    donut = Polygon(DONUT[0], holes=DONUT[1])
    store, x, y = _port(zones=[donut], boundary_probes=False)
    dev = store.query_join("zones", "events", predicate="contains")
    ref_dev, ref_host = _ref_pairs("contains", zones=[donut], boundary_probes=False)
    assert dev.pairs() == ref_dev == ref_host
    assert set(dev.pairs()) == _pairs_contains([donut], ["g0"], x, y,
                                               [f"e{i}" for i in range(len(x))])
    hole = (x > 3.5) & (x < 6.5) & (y > 3.5) & (y < 6.5)
    assert hole.any()
    got = {p for _b, p in dev.pairs()}
    assert not any(f"e{i}" in got for i in np.flatnonzero(hole))


def _skew_zones():
    rng = np.random.default_rng(7)
    zones = []
    for _ in range(40):
        cx, cy = rng.uniform(0, 18, 2)
        zones.append(Polygon([[cx, cy], [cx + 1, cy], [cx + 1, cy + 1], [cx, cy + 1],
                              [cx, cy]]))
    for i in range(4):
        cx = -170 + i * 40
        zones.append(Polygon([[cx, -80], [cx + 2, -80], [cx + 2, -78], [cx, -78], [cx, -80]]))
    return zones


def test_skewed_build_splits_and_completes_within_deadline():  # test_join.py:209
    zones = _skew_zones()
    with properties(geomesa_join_skew_threshold="8"):
        store, x, y = _port(n=400, seed=3, zones=zones, query_timeout_s=30.0)
        res = store.query_join("zones", "events", predicate="contains")
    assert res.stats["path"] == "device-join"
    assert res.stats["splits"] > 0 and res.stats["max_bucket"] <= 40
    ref_dev, ref_host = _ref_pairs("contains", n=400, seed=3, zones=zones,
                                   knobs=(("geomesa_join_skew_threshold", "8"),))
    assert res.pairs() == ref_dev == ref_host
    assert set(res.pairs()) == _pairs_contains(zones, [f"g{i}" for i in range(len(zones))],
                                               x, y, [f"e{i}" for i in range(len(x))])


def test_build_cache_hit_and_generation_invalidation():  # test_join.py:245
    store, _x, _y = _port()
    r1 = store.query_join("zones", "events", predicate="contains")
    assert r1.stats["build"] == "rebuild"
    r2 = store.query_join("zones", "events", predicate="contains")
    assert r2.stats["build"] == "hit" and r1.pairs() == r2.pairs()
    with store.writer("zones") as w:
        w.write(["z9", Polygon([[30, -5], [32, -5], [32, -3], [30, -3], [30, -5]])], fid="g9")
    r3 = store.query_join("zones", "events", predicate="contains")
    assert r3.stats["build"] == "rebuild" and r3.stats["geometries"] == len(ZONES) + 1
    r4 = store.query_join(("zones", "zname = 'z0'"), "events", predicate="contains")
    assert r4.stats["build"] == "rebuild"


def test_join_spec_parse_errors():  # test_join.py:266
    assert JoinSpec.parse("dwithin(500)").radius_m == 500.0
    assert JoinSpec.parse("contains").kind == "contains"
    assert JoinSpec.parse("dwithin", 10.0).radius_m == 10.0
    for bad in ("dwithin", "touches", "dwithin(-5)"):
        with pytest.raises(JoinError):
            JoinSpec.parse(bad)
    store, _x, _y = _port()
    with pytest.raises(JoinError):
        store.query_join("events", "events", predicate="contains")
    with pytest.raises(JoinError):
        store.query_join("zones", "events", predicate="dwithin(10)")
    with pytest.raises(KeyError):
        store.query_join("missing", "events")


def test_join_stats_on_root_span_and_debug_block():  # test_join.py:290
    from geomesa_tpu_torch.utils import devstats

    store, _x, _y = _port()
    ring = trace.InMemoryTraceExporter(capacity=8)
    with trace.exporting(ring):
        store.query_join("zones", "events", predicate="contains")
    roots = [t for t in ring.traces if t.name == "query.join"]
    assert len(roots) == 1
    js = roots[0].attributes["join"]
    assert js["path"] == "device-join"
    assert {"buckets", "splits", "max_bucket", "pairs", "probed", "build", "histogram",
            "chunks", "band_verified"} <= set(js)
    assert "device" in roots[0].attributes
    names = {s.name for s in roots[0].walk()}
    assert "join.build" in names and "join.probe" in names
    dbg = join_debug()
    assert dbg["build_cache"]["entries"] >= 1 and dbg["buckets"]["count"] >= 1
    assert isinstance(dbg["buckets"]["histogram"], dict)
    assert devstats.device_debug()["join"]["probe"]["chunks"] >= 1


SCHEDULES = [
    "join.build:error=1.0",
    "join.probe:error=0.5",
    "join.probe:drop=0.5",
    "join.build:latency=1.0,join.probe:latency=0.5",
    "device.dispatch:error=0.3,device.fetch:error=0.3,join.probe:error=0.2",
]


def _fired_and_degraded(reg):
    rep = reg.report()
    fired = sum(v for k, v in rep.items() if k.startswith("fault.")
                and k.rsplit(".", 1)[1] in ("error", "drop"))
    return fired, rep.get("degrade.device_to_host", 0), rep.get("degrade.join_to_host", 0)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_join_parity_under_faults(schedule, seed):  # test_join.py:411
    """Any schedule costs latency (a device -> host degrade), never
    correctness: the pairs equal the fault-free ones (and the reference's),
    and every fired fault degrades exactly once."""
    reg = robustness_metrics()
    ref_dev, _ref_host = _ref_pairs("contains", seed=seed)
    store, _x, _y = _port(seed=seed)
    f0, d0, j0 = _fired_and_degraded(reg)
    with faults.inject(schedule, seed=seed):
        got = store.query_join("zones", "events", predicate="contains")
    f1, d1, j1 = _fired_and_degraded(reg)
    assert got.pairs() == ref_dev
    assert got.stats["path"] in ("device-join", "host-join-degraded")
    assert d1 - d0 == f1 - f0
    assert (j1 - j0) == (got.stats["path"] == "host-join-degraded")
    if seed == 0:
        b = p = "events"
        want = _ref_pairs("dwithin", n=120, seed=11, build=b, probe=p,
                          predicate="dwithin(200000)")[0]
        s2, _, _ = _port(n=120, seed=11)
        with faults.inject(schedule, seed=seed):
            got2 = s2.query_join(b, p, predicate="dwithin(200000)")
        assert got2.pairs() == want


def test_join_crash_dies_crisply():  # test_join.py:434
    store, _x, _y = _port()
    with faults.inject("join.probe:crash", seed=1):
        with pytest.raises(faults.SimulatedCrash):
            store.query_join("zones", "events", predicate="contains")
    fresh, _x, _y = _port()
    assert (store.query_join("zones", "events", predicate="contains").pairs()
            == fresh.query_join("zones", "events", predicate="contains").pairs())


def test_join_latency_bounded_by_deadline():  # test_join.py:448
    base = _ref_pairs("contains", n=400)[0]
    store, _x, _y = _port(n=400, query_timeout_s=0.15)
    rules = [faults.FaultRule("join.probe", "latency", latency_s=0.2),
             faults.FaultRule("join.build", "latency", latency_s=0.2)]
    with faults.inject(rules=rules):
        t0 = time.perf_counter()
        try:
            got = store.query_join("zones", "events", predicate="contains")
            assert got.pairs() == base
        except QueryTimeout:
            pass  # crisp, never truncated
        elapsed = time.perf_counter() - t0
    assert elapsed < 5.0


def _pts_store(spec_fn, store, rows):
    store.create_schema(spec_fn("pts", "side:String,*geom:Point:srid=4326"))
    with store.writer("pts") as w:
        for side, x, y, fid in rows:
            w.write([side, (RefPoint if spec_fn is ref_parse_spec else Point)(x, y)], fid=fid)
    return store


def test_dwithin_pairs_across_antimeridian():  # test_join.py:523
    rows = [("b", 179.9, 0.0, "east"), ("p", -179.9, 0.0, "west"), ("p", 0.0, 0.0, "far")]
    port = _pts_store(parse_spec, TorchDataStore(device="cpu"), rows)
    ref = _pts_store(ref_parse_spec, TpuDataStore(executor=TpuScanExecutor(default_mesh())),
                     rows)
    sides = (("pts", "side = 'b'"), ("pts", "side = 'p'"))
    dev = port.query_join(*sides, predicate="dwithin(50000)")
    assert dev.stats["path"] == "device-join"
    assert dev.pairs() == ref.query_join(*sides, predicate="dwithin(50000)").pairs() \
        == [("east", "west")]


def test_dwithin_pairs_over_the_pole():  # test_join.py:547
    rows = [("b", 0.0, 89.9, "build"), ("p", 170.0, 89.9, "near"), ("p", 170.0, 80.0, "far")]
    sides = (("pts", "side = 'b'"), ("pts", "side = 'p'"))
    ref = _pts_store(ref_parse_spec, TpuDataStore(executor=TpuScanExecutor(default_mesh())),
                     rows)
    want = ref.query_join(*sides, predicate="dwithin(25000)").pairs()
    assert want == [("build", "near")]
    for env in ("auto", "0"):
        os.environ["GEOMESA_JOIN_DEVICE"] = env
        try:
            port = _pts_store(parse_spec, TorchDataStore(device="cpu"), rows)
            res = port.query_join(*sides, predicate="dwithin(25000)")
        finally:
            del os.environ["GEOMESA_JOIN_DEVICE"]
        assert res.pairs() == want, (env, res.pairs())
        assert res.stats["path"] == ("device-join" if env == "auto" else "host-join")


def _hold_slot(ctl):
    import contextvars

    ctx = contextvars.Context()
    admit = ctl.admit()
    ctx.run(admit.__enter__)
    return lambda: ctx.run(admit.__exit__, None, None, None)


def test_join_holds_one_admission_slot_end_to_end():  # test_join.py:568
    store, _x, _y = _port(n=50, max_inflight=1, max_queue=0)
    res = store.query_join("zones", "events", predicate="contains")
    assert res.stats["path"] == "device-join" and len(res) > 0
    assert res.pairs() == _ref_pairs("contains", n=50)[0]
    release = _hold_slot(store.admission)
    try:
        with pytest.raises(ShedLoad):
            store.query_join("zones", "events", predicate="contains")
    finally:
        release()
    again = store.query_join("zones", "events", predicate="contains")
    assert sorted(again.pairs()) == sorted(res.pairs())


def test_delete_schema_invalidates_build_cache():  # test_join.py:628
    zspec = "zname:String,*geom:Polygon:srid=4326"
    store = TorchDataStore(device="cpu")
    store.create_schema(parse_spec("events", "kind:String,dtg:Date,*geom:Point:srid=4326"))
    store._insert_columns(store.get_schema("events"), {
        "__fid__": np.array(["e0"], dtype=object), "kind": np.array(["k"], dtype=object),
        "geom__x": np.array([2.0]), "geom__y": np.array([2.0]),
        "dtg": np.full(1, T0, dtype=np.int64)})
    store.create_schema(parse_spec("zones", zspec))
    with store.writer("zones") as w:
        w.write(["z0", ZONES[0]], fid="g0")
    assert store.query_join("zones", "events", predicate="contains").pairs() == [("g0", "e0")]
    gen = store.schema_generation("zones")
    store.delete_schema("zones")
    store.create_schema(parse_spec("zones", zspec))
    assert store.schema_generation("zones") != gen
    r2 = store.query_join("zones", "events", predicate="contains")
    assert r2.stats["build"] == "rebuild" and r2.pairs() == []


def test_write_landing_mid_build_never_serves_stale_pairs():  # test_join.py:664
    store, _x, _y = _port()
    orig = store.query
    fired = []

    def query_then_write(name, q=None, **kw):
        res = orig(name, q, **kw)
        if name == "zones" and not fired:
            fired.append(True)
            store.query = orig
            with store.writer("zones") as w:
                w.write(["late", ZONES[2]], fid="glate")
        return res

    store.query = query_then_write
    r1 = store.query_join("zones", "events", predicate="contains")
    assert r1.stats["geometries"] == 3
    r2 = store.query_join("zones", "events", predicate="contains")
    assert r2.stats["build"] == "rebuild" and r2.stats["geometries"] == 4
    assert ({p for b, p in r2.pairs() if b == "g2"} == {p for b, p in r2.pairs() if b == "glate"})


def test_concurrent_first_joins_share_one_build_cache():  # test_join.py:695
    store, _x, _y = _port(n=60)
    assert getattr(store, "_join_cache", None) is None
    results, errs = [], []

    def first_join():
        try:
            results.append(sorted(store.query_join("zones", "events",
                                                   predicate="contains").pairs()))
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=first_join) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not errs and len(set(map(tuple, results))) == 1
    assert results[0] == sorted(_ref_pairs("contains", n=60)[0])
    cache = store._join_cache
    again = store.query_join("zones", "events", predicate="contains")
    assert store._join_cache is cache and again.stats["build"] == "hit"


def test_multimember_multipolygon_takes_host_path():  # test_join.py:727
    overlap = MultiPolygon([
        Polygon([[0, 0], [6, 0], [6, 6], [0, 6], [0, 0]]),
        Polygon([[4, 4], [10, 4], [10, 10], [4, 10], [4, 4]]),
    ])
    store = TorchDataStore(device="cpu")
    store.create_schema(parse_spec("pts", "dtg:Date,*geom:Point:srid=4326"))
    with store.writer("pts") as w:
        w.write([T0, Point(5.0, 5.0)], fid="inside-overlap")
        w.write([T0, Point(20.0, 20.0)], fid="outside")
    store.create_schema(parse_spec("mz", "zname:String,*geom:MultiPolygon:srid=4326"))
    with store.writer("mz") as w:
        w.write(["m", overlap], fid="g0")
    reg = robustness_metrics()
    c0 = reg.counter("decision.join.kernel.build_ineligible")
    res = store.query_join("mz", "pts", predicate="contains")
    assert res.stats["path"] == "host-join"
    assert res.pairs() == [("g0", "inside-overlap")]
    assert reg.counter("decision.join.kernel.build_ineligible") == c0 + 1


def test_join_spec_radius_coercion():  # test_join.py:753
    assert JoinSpec.parse("dwithin", "500").radius_m == 500.0
    with pytest.raises(JoinError):
        JoinSpec.parse("dwithin", "all")
    for typo in ("dwithin500", "dwithin(500]x", "dwithin(500)x"):
        with pytest.raises(JoinError):
            JoinSpec.parse(typo, 500)


def test_build_query_identity_keys_the_cache():  # test_join.py:785
    from geomesa_tpu_torch.index.planner import Query

    store, _x, _y = _port()
    limited = store.query_join(("zones", Query(max_features=1)), "events",
                               predicate="contains")
    assert limited.stats["geometries"] == 1
    full = store.query_join("zones", "events", predicate="contains")
    assert full.stats["build"] == "rebuild" and full.stats["geometries"] == len(ZONES)
    assert {b for b, _p in full.pairs()} > {b for b, _p in limited.pairs()}


def test_explicit_zero_join_knobs_honored():  # test_join.py:832
    zones = [Polygon([[i * 0.5, 0], [i * 0.5 + 0.4, 0], [i * 0.5 + 0.4, 0.4], [i * 0.5, 0.4],
                      [i * 0.5, 0]]) for i in range(12)]
    knobs = (("geomesa_join_split_depth", "0"), ("geomesa_join_skew_threshold", "2"))
    with properties(**dict(knobs)):
        store, _x, _y = _port(n=60, zones=zones, boundary_probes=False)
        res = store.query_join("zones", "events", predicate="contains")
        assert res.stats["splits"] == 0 and res.stats["max_bucket"] >= 3
    ref_dev, ref_host = _ref_pairs("contains", n=60, zones=zones, boundary_probes=False,
                                   knobs=knobs)
    assert res.pairs() == ref_dev == ref_host


def test_host_join_direct_unit():  # test_join.py:853
    spec = JoinSpec.parse("contains")
    ft = parse_spec("z", "zname:String,*geom:Polygon:srid=4326")
    fids = np.array(["a", "b"], dtype=object)
    cols = {"__fid__": fids, "zname": np.array(["p", "q"], dtype=object)}
    build = JoinBuild(spec, ft, cols, fids, list(ZONES[:2]), None, None)
    px = np.array([2.0, 7.0, 5.0, np.nan])
    py = np.array([2.0, 2.0, 5.0, 1.0])
    bi, pi = host_join(build, px, py)
    assert {(int(b), int(p)) for b, p in zip(bi, pi)} == {(0, 0), (1, 1), (0, 2), (1, 2)}
    ref_build = ref_join.JoinBuild(ref_join.JoinSpec("contains"),
                                   ref_parse_spec("z", "zname:String,*geom:Polygon:srid=4326"),
                                   cols, fids, list(REF_ZONES[:2]), None, None)
    rbi, rpi = ref_join.host_join(ref_build, px, py)
    assert np.array_equal(bi, rbi) and np.array_equal(pi, rpi)


def test_shed_or_timed_out_join_audits_outcome():  # test_join.py:870
    store, _, _ = _port(n=40, max_inflight=1, max_queue=0, audit_writer=InMemoryAuditWriter())
    release = _hold_slot(store.admission)
    try:
        with pytest.raises(ShedLoad):
            store.query_join("zones", "events", predicate="contains")
    finally:
        release()
    ev = store.audit_writer.events[-1]
    assert ev.outcome == "shed" and ev.hits == 0 and ev.type_name == "zones+events"
    store2, _, _ = _port(n=40, query_timeout_s=0.0, audit_writer=InMemoryAuditWriter(),
                         metrics=MetricsRegistry())
    with pytest.raises(QueryTimeout):
        store2.query_join("zones", "events", predicate="contains")
    ev2 = store2.audit_writer.events[-1]
    assert ev2.outcome == "timeout" and ev2.hits == 0 and ev2.type_name == "zones+events"
    assert store2.metrics.counter("queries.join.timeout") == 1
    # no double count: the inner queries audited themselves (each into
    # queries, a timed-out one into queries.timeout too); the join's failure
    # stays in the join-scoped counters
    inner = store2.audit_writer.events[:-1]
    assert store2.metrics.counter("queries") == len(inner)
    assert store2.metrics.counter("queries.timeout") == sum(e.outcome == "timeout" for e in inner)


def test_build_cache_put_evicts_displaced_same_key_build():  # test_join.py:935
    class _Build:
        evicted = False

        def evict_device(self):
            self.evicted = True

    cache = port_join.JoinBuildCache()
    winner, loser = _Build(), _Build()
    cache.put(("k",), loser)
    cache.put(("k",), winner)
    assert loser.evicted and not winner.evicted
    cache.put(("k",), winner)
    assert not winner.evicted


def test_build_cache_ttl_evicts_idle_not_hot():  # test_join.py:958
    class _Build:
        def __init__(self):
            self.built_at = self.last_used = time.time()
            self.evicted = False

        def evict_device(self):
            self.evicted = True

    cache = port_join.JoinBuildCache()
    hot, idle = _Build(), _Build()
    cache.put(("hot",), hot)
    cache.put(("idle",), idle)
    hot.last_used = idle.last_used = time.time() - 10.0
    assert cache.get(("hot",), ttl_s=20.0) is hot
    assert cache.get(("hot",), ttl_s=5.0) is hot
    assert idle.evicted and cache.get(("idle",), ttl_s=5.0) is None


def test_near_antipodal_dwithin_declines_device():  # test_join.py:986
    r = 1.9e7
    store, x, y = _port(n=40, seed=3)
    sides = (("events", "kind = 'k0'"), ("events", "kind <> 'k0'"))
    res = store.query_join(*sides, predicate="dwithin", radius_m=r)
    assert res.stats["path"] == "host-join"
    k = np.array([f"k{i % 3}" for i in range(40)])
    bs, ps = np.flatnonzero(k == "k0"), np.flatnonzero(k != "k0")
    want = _pairs_dwithin(x[bs], y[bs], [f"e{i}" for i in bs], x[ps], y[ps],
                          [f"e{i}" for i in ps], r)
    assert set(res.pairs()) == want and want


# -- the port's own envelope: the breaker, the trip, kernel faults ----------------------


def test_open_circuit_answers_host_join_breaker():
    store, _x, _y = _port()
    want = store.query_join("zones", "events", predicate="contains").pairs()
    br = store.executor.breaker
    for _ in range(br.failures):
        br.record_failure()
    res = store.query_join("zones", "events", predicate="contains")
    assert res.stats["path"] == "host-join-breaker" and res.pairs() == want


def test_degrade_trips_the_session_unless_forced(monkeypatch):
    store, _x, _y = _port()
    want = store.query_join("zones", "events", predicate="contains").pairs()
    with faults.inject("join.probe:error@0x1", seed=1):
        got = store.query_join("zones", "events", predicate="contains")
    assert got.stats["path"] == "host-join-degraded" and got.pairs() == want
    assert store.executor._device_tripped
    again = store.query_join("zones", "events", predicate="contains")
    assert again.stats["path"] == "host-join" and again.pairs() == want
    monkeypatch.setenv("GEOMESA_JOIN_DEVICE", "1")
    forced = store.query_join("zones", "events", predicate="contains")
    assert forced.stats["path"] == "device-join" and forced.pairs() == want


@pytest.mark.parametrize("fault", ["launch", "argument"])
def test_a_kernel_fault_raises_and_degrades_nothing(monkeypatch, fault):
    store, _x, _y = _port()

    def failing(*args, **kw):
        if fault == "launch":
            kernels._raise_on(700, "join_pip")
        kernels._check(torch.zeros(4, dtype=torch.int64), "px", torch.float32,
                       torch.device("cpu"))

    monkeypatch.setattr(kernels, "join_pip", failing)
    monkeypatch.setattr(kernels, "join_dwithin", failing)
    reg = robustness_metrics()
    d0 = reg.counter("degrade.device_to_host")
    want = kernels.KernelLaunchError if fault == "launch" else kernels.KernelArgumentError
    for pred in ("contains", "dwithin(1000)"):
        build = "zones" if pred == "contains" else "events"
        with pytest.raises(want):
            store.query_join(build, "events", predicate=pred)
    assert reg.counter("degrade.device_to_host") == d0
    assert store.executor.breaker.state == "closed"
    assert not getattr(store.executor, "_device_tripped", False)
