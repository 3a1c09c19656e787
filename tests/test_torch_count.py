"""The port's count push-down against the JAX package, on the CPU.

Mirrors ``tests/test_device_count.py`` case for case: the same stores (a
point table with null strings and ints, an extent table with rectangles,
triangles, lines and null geometries) go into the reference ``TpuDataStore``
on a one-device CPU mesh and into the port's ``TorchDataStore(device="cpu")``,
with ``GEOMESA_COUNT_DEVICE=1`` (and the reference's
``GEOMESA_EXACT_DEVICE=1``), as that file sets them. Counts are equal
integers, and the port's ``count_scan`` answers (is not None) exactly where
the reference's does. Where the reference deletes rows, the port's table
is written without them (``tests/test_torch_lifecycle.py`` deletes in both).
A failed device count degrades to the host count in both.

Kernel level: ``exact_count_plain`` (the plain edition of the count kernel)
with each attribute edition against the reference's ``_exact_count_fn``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from geomesa_tpu.geom import base as ref_geom
from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.ops import zkernels as ref_z
from geomesa_tpu.parallel import executor as ref_ex
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.geom import base as port_geom
from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops import zkernels as Z
from geomesa_tpu_torch.ops.filters import ATTR_KINDS
from geomesa_tpu_torch.parallel import executor as port_ex
from geomesa_tpu_torch.parallel import mesh as port_mesh
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.utils.config import properties

SPEC = "dtg:Date,kind:String,cnt:Int,*geom:Point:srid=4326"
BASE = int(np.datetime64("2026-01-01T00:00:00", "ms").astype("int64"))

CQLS = [
    "bbox(geom, -60, -40, 40, 30)",
    "bbox(geom, -100, -60, 80, 60) AND "
    "dtg DURING 2026-01-03T00:00:00Z/2026-01-12T00:00:00Z",
    "kind = 'k2' AND bbox(geom, -60, -40, 40, 30)",
    "kind IN ('k0', 'k3') AND bbox(geom, -100, -60, 80, 60)",
    "cnt BETWEEN 10 AND 30 AND bbox(geom, -60, -40, 40, 30)",
    "cnt IS NULL AND bbox(geom, -100, -60, 80, 60)",
    "kind LIKE 'k%' AND bbox(geom, -60, -40, 40, 30)",
]


@pytest.fixture(autouse=True)
def _force_device(monkeypatch):
    monkeypatch.setenv("GEOMESA_EXACT_DEVICE", "1")
    monkeypatch.setenv("GEOMESA_COUNT_DEVICE", "1")


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("shards",))


def _pair():
    return (TpuDataStore(executor=TpuScanExecutor(_mesh())),
            TorchDataStore(executor=TorchScanExecutor(device="cpu")))


def _rows(n, seed):
    """test_device_count's point rows: (fid, values with the reference's and
    the port's Point)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = int(BASE + rng.integers(0, 20 * 86400_000))
        kind = None if i % 17 == 0 else f"k{rng.integers(0, 5)}"
        cnt = None if i % 19 == 0 else int(rng.integers(0, 50))
        x, y = float(rng.uniform(-170, 170)), float(rng.uniform(-80, 80))
        out.append((f"f{i}", [t, kind, cnt], (x, y)))
    return out


def _store(n=25_000, seed=41, skip=()):
    """The reference's and the port's store of the same rows; ``skip`` fids
    go into the reference only (it deletes them after)."""
    ref, port = _pair()
    for ds, parse, geom in ((ref, ref_parse_spec, ref_geom), (port, parse_spec, port_geom)):
        ds.create_schema(parse("t", SPEC))
        with ds.writer("t") as w:
            for fid, vals, (x, y) in _rows(n, seed):
                if ds is port and fid in skip:
                    continue
                w.write(vals + [geom.Point(x, y)], fid=fid)
    return ref, port


def _scan(ds, cql, name="t"):
    q = ds._as_query(cql)
    plan = ds._plan_cached(name, q)
    return ds.executor.count_scan(ds._tables[name][plan.index.name], plan)


@pytest.fixture(scope="module")
def stores():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_EXACT_DEVICE", "1")
        mp.setenv("GEOMESA_COUNT_DEVICE", "1")
        return _store()


def test_count_parity_and_device_engaged(stores):
    ref, port = stores
    for cql in CQLS:
        want = len(ref.query("t", cql))
        direct = _scan(port, cql)
        assert direct is not None and _scan(ref, cql) is not None, cql
        assert direct == want, (cql, direct, want)
        assert port.count("t", cql) == ref.count("t", cql) == want, cql
        assert len(port.query("t", cql)) == want, cql


def test_count_after_delete():
    deleted = [f"f{i}" for i in range(0, 9000, 7)]
    ref, port = _store(n=9000, skip=set(deleted))
    ref.delete_features("t", deleted)
    for cql in CQLS[:3]:
        want = ref.count("t", cql)
        assert want == len(ref.query("t", cql))
        assert port.count("t", cql) == want, cql
    assert port.count("t") == ref.count("t") == 9000 - len(deleted)


def test_count_ineligible_shapes_fall_back():
    ref, port = _store(n=6000)
    for cql in [
        "kind = 'k1' OR kind = 'k2'",
        "kind LIKE '%1' AND bbox(geom, -60, -40, 40, 30)",
        "INCLUDE",
    ]:
        assert port.count("t", cql) == ref.count("t", cql) == len(ref.query("t", cql)), cql
        plan = port._plan_cached("t", Query.cql(cql))
        if plan.union is None and port._tables["t"].get(plan.index.name) is not None:
            assert (_scan(port, cql) is None) == (_scan(ref, cql) is None), cql


def test_count_respects_limit_and_failure_trip(monkeypatch):
    """A limit keeps len() semantics; a device count that fails degrades:
    the mirror is evicted (``degrade.mirror_rebuilds``),
    ``degrade.device_to_host`` counts the degrade, and the
    count answers from the host with the reference's number (the reference
    trips to the host the same way)."""
    from geomesa_tpu_torch.utils.audit import robustness_metrics

    ref, port = _store(n=6000)
    q = Query.cql("bbox(geom, -60, -40, 40, 30)", max_features=5)
    assert port.count("t", q) == ref.count(
        "t", RefQuery.cql("bbox(geom, -60, -40, 40, 30)", max_features=5)) == 5

    calls = {"n": 0}

    def boom(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("UNAVAILABLE")

    port.count("t", CQLS[0])  # the mirror
    assert port.executor._cache
    monkeypatch.setattr(port.executor, "count_scan", boom)
    reg = robustness_metrics()
    d0 = reg.counter("degrade.device_to_host")
    r0 = reg.counter("degrade.mirror_rebuilds")
    # the aggregate pyramid counts a spatial-only filter before the device
    # count (as the reference's does): off, the count reaches count_scan
    with properties(geomesa_agg_enabled="false"):
        assert port.count("t", CQLS[0]) == len(ref.query("t", CQLS[0]))
    assert calls["n"] == 1
    assert reg.counter("degrade.device_to_host") == d0 + 1
    # the failed count evicted the mirror (the host answer then rebuilt it)
    assert reg.counter("degrade.mirror_rebuilds") == r0 + 1
    monkeypatch.undo()  # the count_scan back; the gate on auto: the host counts
    assert port.count("t", CQLS[0]) == len(ref.query("t", CQLS[0]))


def _extent_store(n=6000, seed=47, skip=()):
    """test_device_count's extents (rectangles, triangles, lines, nulls,
    small squares) in both packages."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        x0 = float(rng.uniform(-170, 160))
        y0 = float(rng.uniform(-80, 70))
        t = int(BASE + rng.integers(0, 15 * 86400_000))
        rows.append((i, x0, y0, t))
    ref, port = _pair()
    for ds, parse, G in ((ref, ref_parse_spec, ref_geom), (port, parse_spec, port_geom)):
        ds.create_schema(parse("e", "dtg:Date,kind:String,*geom:Geometry:srid=4326"))
        with ds.writer("e") as w:
            for i, x0, y0, t in rows:
                if ds is port and f"e{i}" in skip:
                    continue
                k = i % 5
                if k == 0:
                    g = G.Polygon([[x0, y0], [x0 + 1, y0], [x0 + 1, y0 + 1], [x0, y0 + 1],
                                   [x0, y0]])
                elif k == 1:
                    g = G.Polygon([[x0, y0], [x0 + 2, y0], [x0 + 1, y0 + 2], [x0, y0]])
                elif k == 2:
                    g = G.LineString([(x0, y0), (x0 + 1.5, y0 + 0.7)])
                elif k == 3:
                    g = None
                else:
                    g = G.Polygon([[x0, y0], [x0 + 0.5, y0], [x0 + 0.5, y0 + 0.5],
                                   [x0, y0 + 0.5], [x0, y0]])
                w.write([t, f"k{i % 4}", g], fid=f"e{i}")
    return ref, port


EXTENT_CQLS = [
    "bbox(geom, -60, -40, 10, 20)",
    "bbox(geom, -100, -60, 80, 50)",
    "intersects(geom, POLYGON ((-40 -40, 30 -35, 10 30, -35 20, -40 -40)))",
    "bbox(geom, -30, -30, 40, 35) AND dtg DURING 2026-01-02T00:00:00Z/2026-01-08T00:00:00Z",
    "kind = 'k1' AND bbox(geom, -60, -40, 40, 30)",
    "kind <> 'k2' AND bbox(geom, -60, -40, 40, 30)",
    "bbox(geom, 179.0, 89.0, 179.9, 89.9)",  # ~empty
]


def test_extent_count_device_parity(monkeypatch):
    """The extent count: |decided| + the host-certified ring, with the
    attribute plane for the attribute queries; the reference's counts,
    the port's dual count answering wherever the reference's does."""
    ref, port = _extent_store()
    calls = {"n": 0}
    orig = port_ex.TorchScanExecutor._count_xz_scan

    def spy(self, table, plan):
        out = orig(self, table, plan)
        if out is not None:
            calls["n"] += 1
        return out

    monkeypatch.setattr(port_ex.TorchScanExecutor, "_count_xz_scan", spy)
    for cql in EXTENT_CQLS:
        assert port.count("e", cql) == ref.count("e", cql) == len(ref.query("e", cql)), cql
        assert (_scan(port, cql, "e") is None) == (_scan(ref, cql, "e") is None), cql
    assert calls["n"] >= 2 * (len(EXTENT_CQLS) - 1)


def test_extent_count_after_delete():
    gone = ("e7", "e100", "e2500")
    ref, port = _extent_store(n=3000, skip=set(gone))
    ref.delete_features("e", "IN ('e7', 'e100', 'e2500')")
    for cql in ("bbox(geom, -100, -60, 80, 50)", "bbox(geom, -60, -40, 10, 20)"):
        assert port.count("e", cql) == ref.count("e", cql) == len(ref.query("e", cql)), cql


POLY_CQLS = [
    "intersects(geom, POLYGON ((-40 -40, 30 -35, 10 30, -35 20, -40 -40)))",
    "intersects(geom, POLYGON ((-15 -50, 50 -40, 25 15, -15 -50)))",
    "intersects(geom, POLYGON ((-20 -20, 40 -10, 5 45, -20 -20))) "
    "AND dtg DURING 2026-01-02T00:00:00Z/2026-01-12T00:00:00Z",
    "kind = 'k1' AND intersects(geom, POLYGON ((-38 -38, 28 -33, 8 28, -33 18, -38 -38)))",
    "cnt > 20 AND intersects(geom, POLYGON ((-38 -38, 28 -33, 8 28, -33 18, -38 -38)))",
]


def test_poly_count_device_parity(monkeypatch):
    """The banded polygon count (|decided ray-cast hits| + the certified
    band), with the attribute plane (member and range) for a polygon AND an
    attribute predicate: the reference's counts, engaged where the
    reference's is."""
    ref, port = _store(n=15_000, seed=43)
    calls = {"n": 0}
    orig = port_ex.TorchScanExecutor._count_poly_scan

    def spy(self, table, plan):
        out = orig(self, table, plan)
        if out is not None:
            calls["n"] += 1
        return out

    monkeypatch.setattr(port_ex.TorchScanExecutor, "_count_poly_scan", spy)
    for cql in POLY_CQLS:
        want = len(ref.query("t", cql))
        assert port.count("t", cql) == want, cql
        assert (_scan(port, cql) is None) == (_scan(ref, cql) is None), cql
    assert calls["n"] >= 2 * (len(POLY_CQLS) - 1)


@pytest.mark.parametrize("mode", ["auto", "0"])
def test_count_declines_where_the_gate_says(stores, monkeypatch, mode):
    """GEOMESA_COUNT_DEVICE auto declines on a CPU device, 0 always: the
    host counts the rows (the reference's gate on its CPU backend)."""
    ref, port = stores
    monkeypatch.setenv("GEOMESA_COUNT_DEVICE", mode)
    assert port_mesh.device_auto_declines("GEOMESA_COUNT_DEVICE", device="cpu")
    for cql in CQLS[:3]:
        assert _scan(port, cql) is None and _scan(ref, cql) is None
        assert port.count("t", cql) == ref.count("t", cql), cql


def test_count_without_a_query_and_estimates(stores):
    ref, port = stores
    assert port.count("t") == ref.count("t") == 25_000
    est = port.count("t", CQLS[0], exact=False)
    assert isinstance(est, int) and 0 < est <= 25_000


# -- the plain edition of the count kernel against _exact_count_fn --------------


T0 = BASE
_N = 8192
_SHAPES = [
    (100.0, 100.0, 101.0, 101.0, T0, T0 + 20 * 86_400_000),
    (-10.0, -10.0, 10.0, 10.0, T0, T0 + 5 * 86_400_000),
    (-2.0, -2.0, 3.0, 3.0, None, T0 + 10 * 86_400_000),
]


def _qvec(kind, rng):
    if kind == "range":
        return np.asarray([[-1, -1], [3, 40], [5, 2]], dtype=np.int32)  # IS NULL, wide, empty
    if kind == "vocabmask":
        return (rng.random((3, 64)) < 0.3).astype(np.uint8)
    return np.asarray([[7, -2, 11, 3], [-1, 60, 61, 62], [0, 1, 2, -2]], dtype=np.int32)


@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("kind", (None,) + ATTR_KINDS)
def test_exact_count_plain_equals_the_reference(kind, has_time):
    rng = np.random.default_rng(21)
    x, y = rng.uniform(-10, 10, _N), rng.uniform(-10, 10, _N)
    t = T0 + rng.integers(0, 10 * 86_400_000, _N)
    valid = np.ones(_N, dtype=bool)
    valid[_N - 64:] = False
    tvalid = valid.copy()
    tvalid[100:120] = False
    codes = rng.integers(0, 60, _N).astype(np.int32)
    codes[rng.random(_N) < 0.1] = -1
    codes[_N - 64:] = -1
    qv = _qvec(kind, rng)

    def limbs(keys):
        hi, lo = ref_z.split_u64_to_limbs(keys)
        return jnp.asarray(hi), jnp.asarray(lo)

    xh, xl = limbs(ref_z.f64_sort_keys(x))
    yh, yl = limbs(ref_z.f64_sort_keys(y))
    th, tl = limbs(ref_z.i64_sort_keys(t))
    fn = ref_ex._exact_count_fn(has_time, "local", _mesh(), kind or False)
    for i, shape in enumerate(_SHAPES):
        shape = shape if has_time else shape[:4] + (None, None)
        rbox, rwin = TpuScanExecutor._shape_limbs(shape)
        args = [xh, xl, yh, yl] + ([th, tl, jnp.asarray(tvalid)] if has_time
                                   else [jnp.asarray(valid)])
        if kind:
            args.append(jnp.asarray(codes))
        args.append(jnp.asarray(rbox))
        if has_time:
            args.append(jnp.asarray(rwin))
        if kind:
            args.append(jnp.asarray(qv[i]))
        want = int(fn(*args))
        box, win = TorchScanExecutor._shape_keys(shape)
        got = kernels.exact_count(
            torch.from_numpy(Z.f64_keys(x)), torch.from_numpy(Z.f64_keys(y)),
            torch.from_numpy(t) if has_time else None,
            torch.from_numpy(tvalid if has_time else valid), torch.from_numpy(box),
            torch.from_numpy(win) if has_time else None,
            torch.from_numpy(codes) if kind else None,
            torch.from_numpy(qv[i:i + 1]) if kind else None, kind)
        assert got.dtype == torch.int32 and got.shape == (1,)
        assert int(got) == want, (kind, shape)
    assert want > 0 or kind is not None
