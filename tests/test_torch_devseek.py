"""The port's device-assisted seek (``GEOMESA_DEVSEEK=1``: ``_device_seek``,
``_device_seek_xz``, ``_DeviceSeekScan``, ``_DeviceSeekXZScan``) against the
JAX package, on the CPU.

Kernel level: ``devseek_plain`` / ``devseek_xz_plain`` (the editions the
wrappers take on CPU tensors) against the reference's ``_devseek_fn`` /
``_devseek_xz_fn``: the packed bytes equal bit for bit, with and without a
time window, with zero-length intervals among the candidates' and a
candidate space past their total. The reference's u32 key limbs become
the port's int64 keys (``limbs_to_keys``) and its limb descriptors
(``_shape_limbs``, ``_xz_query_limbs``) the port's key descriptors
(``_shape_keys``, ``_xz_desc``) of the same query.

Store level: port twins of ``tests/test_device_seek.py`` (each named after
its reference's line): fid sets equal the reference's under
``GEOMESA_DEVSEEK=1`` and the port's own host seek (``GEOMESA_DEVSEEK=0``),
routes ``device-seek`` / ``device-seek-xz``; and, on the port alone, a
labelled table and a table after an ``age_off`` sweep answer as the host
seek does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomesa_tpu.geom.base import Envelope as RefEnvelope
from geomesa_tpu.ops.zkernels import f64_sort_keys, i64_sort_keys, split_u64_to_limbs
from geomesa_tpu.parallel import TpuScanExecutor, default_mesh
from geomesa_tpu.parallel import executor as ref_ex
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.geom.base import Envelope, LineString, Point, Polygon
from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.filters import devseek_plain, devseek_xz_plain
from geomesa_tpu_torch.ops.zkernels import limbs_to_keys
from geomesa_tpu_torch.parallel.executor import (
    TorchScanExecutor,
    _DeviceSeekScan,
    _DeviceSeekXZScan,
)
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.utils.audit import robustness_metrics

DAY = 86_400_000


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("GEOMESA_SEEK", raising=False)
    monkeypatch.delenv("GEOMESA_DEVSEEK", raising=False)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- kernel editions ---------------------------------------------------------------


def _limbs(keys_u64):
    hi, lo = split_u64_to_limbs(keys_u64)
    return jnp.asarray(hi), jnp.asarray(lo)


def _intervals(n, seed):
    """Candidate intervals over n rows: some zero-length ones among them,
    zero-length pads to a pow2 of at least 64 and a candidate space past
    their total."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(n - 40, 20, replace=False)).astype(np.int32)
    lens = rng.integers(0, 30, 20).astype(np.int32)
    lens[[2, 7, 11]] = 0
    starts_p = np.zeros(64, np.int32)
    lens_p = np.zeros(64, np.int32)
    starts_p[:20] = starts
    lens_p[:20] = lens
    cand = 1024
    while cand < lens.sum():
        cand *= 2
    return starts_p, lens_p, cand * 2


@pytest.mark.parametrize("has_time", [False, True])
def test_devseek_plain_matches_devseek_fn_bit_for_bit(has_time):
    n = 4096
    rng = np.random.default_rng(3 + has_time)
    x = rng.uniform(-20, 20, n)
    y = rng.uniform(-10, 10, n)
    t = (1_700_000_000_000 + rng.integers(0, 10 * DAY, n)).astype(np.int64)
    x[5] = np.nan  # a missing coordinate fails every range test
    valid = rng.random(n) > 0.1
    starts_p, lens_p, cand = _intervals(n, 7)
    shape = (-8.0, -4.0, 12.0, 6.0) + ((1_700_000_000_000 + DAY, 1_700_000_000_000 + 6 * DAY)
                                       if has_time else (None, None))
    box_l, win_l = TpuScanExecutor._shape_limbs(shape)
    fn = ref_ex._devseek_fn(has_time, 64, cand)
    xh, xl = _limbs(f64_sort_keys(x))
    yh, yl = _limbs(f64_sort_keys(y))
    th, tl = _limbs(i64_sort_keys(t))
    want = np.asarray(fn(xh, xl, yh, yl, th, tl, jnp.asarray(valid), jnp.asarray(starts_p),
                         jnp.asarray(lens_p), jnp.asarray(box_l),
                         jnp.asarray(win_l if has_time else box_l)))
    box_k, win_k = TorchScanExecutor._shape_keys(shape)
    assert np.array_equal(box_k, limbs_to_keys(box_l[0::2], box_l[1::2]))
    keys = [torch.from_numpy(limbs_to_keys(*split_u64_to_limbs(f64_sort_keys(c)))) for c in (x, y)]
    got = devseek_plain(keys[0], keys[1], torch.from_numpy(t), torch.from_numpy(valid),
                        torch.from_numpy(starts_p), torch.from_numpy(np.cumsum(lens_p).astype(
                            np.int32)), torch.from_numpy(box_k),
                        torch.from_numpy(win_k) if has_time else None, cand)
    assert np.array_equal(got.numpy(), want)
    assert want.any() and not want[lens_p.sum() // 8 + 1:].any()


def _envs(n, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-30, 30, n)
    y0 = rng.uniform(-20, 20, n)
    w = rng.uniform(0, 4, n)
    h = rng.uniform(0, 3, n)
    env = np.stack([x0, y0, x0 + w, y0 + h], 1)
    env[::9] = 0.0  # null geometries: the all-zero placeholder envelope
    return env


@pytest.mark.parametrize("rect", [True, False])
@pytest.mark.parametrize("has_time", [False, True])
def test_devseek_xz_plain_matches_devseek_xz_fn_bit_for_bit(has_time, rect):
    n = 4096
    env = _envs(n, 11 + has_time)
    rng = np.random.default_rng(13)
    isrect = rng.random(n) > 0.5
    valid = rng.random(n) > 0.05
    t = (1_700_000_000_000 + rng.integers(0, 10 * DAY, n)).astype(np.int64)
    starts_p, lens_p, cand = _intervals(n, 17)
    t_lo, t_hi = (1_700_000_000_000 + DAY, 1_700_000_000_000 + 7 * DAY) if has_time \
        else (None, None)
    qbox12, win, _ht = ref_ex._xz_query_limbs(RefEnvelope(-10.0, -10.0, 10.0, 12.0), rect,
                                               t_lo, t_hi)
    fn = ref_ex._devseek_xz_fn(64, cand, has_time)
    limbs = []
    for j in range(4):
        limbs.extend(_limbs(f64_sort_keys(env[:, j])))
    th, tl = _limbs(i64_sort_keys(t))
    want = np.asarray(fn(tuple(limbs), jnp.asarray(isrect), jnp.asarray(valid),
                         jnp.asarray(starts_p), jnp.asarray(lens_p), jnp.asarray(qbox12[:10]),
                         jnp.asarray(bool(qbox12[10])), th, tl, jnp.asarray(win)))
    desc, ht = TorchScanExecutor._xz_desc(Envelope(-10.0, -10.0, 10.0, 12.0), rect, t_lo, t_hi)
    assert ht == has_time
    keys = [torch.from_numpy(limbs_to_keys(*split_u64_to_limbs(f64_sort_keys(env[:, j]))))
            for j in range(4)]
    got = devseek_xz_plain(*keys, torch.from_numpy(isrect), torch.from_numpy(valid),
                           torch.from_numpy(t), torch.from_numpy(starts_p),
                           torch.from_numpy(np.cumsum(lens_p).astype(np.int32)),
                           torch.from_numpy(desc), cand, has_time)
    assert np.array_equal(got.numpy(), want)
    half = cand // 8
    assert want[:half].any() and (want[half:].any() == rect)


def test_devseek_wrappers_take_the_plain_edition_on_the_cpu_and_refuse_others():
    n = 2048
    rng = np.random.default_rng(1)
    xk = torch.from_numpy(rng.integers(-50, 50, n).astype(np.int64))
    yk = torch.from_numpy(rng.integers(-50, 50, n).astype(np.int64))
    valid = torch.ones(n, dtype=torch.bool)
    starts = torch.tensor([0, 700, 0], dtype=torch.int32)
    ends = torch.tensor([500, 900, 900], dtype=torch.int32)
    box = torch.tensor([-10, 10, -20, 20], dtype=torch.int64)
    got = kernels.devseek(xk, yk, None, valid, starts, ends, box, None, 1024)
    assert torch.equal(got, devseek_plain(xk, yk, None, valid, starts, ends, box, None, 1024))
    meta = torch.device("meta")
    m64 = torch.empty(n, dtype=torch.int64, device=meta)
    mb = torch.empty(n, dtype=torch.bool, device=meta)
    m32 = torch.empty(3, dtype=torch.int32, device=meta)
    with pytest.raises(kernels.KernelArgumentError):
        kernels.devseek(m64, m64, None, mb, m32, m32, m64[:4], None, 1024)
    with pytest.raises(kernels.KernelArgumentError):
        kernels.devseek_xz(m64, m64, m64, m64, mb, mb, None, m32, m32, m64[:8], 1024, False)


# -- store twins of tests/test_device_seek.py -----------------------------------------

QUERIES = [
    "bbox(geom, -30, -20, 40, 35) AND dtg DURING 2026-03-02T00:00:00Z/2026-03-07T12:00:00Z",
    "bbox(geom, 10, 10, 11, 11)",
    "bbox(geom, -180, -90, 180, 90) AND dtg AFTER 2026-03-10T00:00:00Z",
    "bbox(geom, 0, 0, 90, 45) AND dtg BEFORE 2026-03-04T06:30:00Z",
]


def _point_columns(n, batches, with_null_dates, seed):
    rng = np.random.default_rng(seed)
    base = np.datetime64("2026-03-01", "ms").astype(np.int64)
    per = n // batches
    out = []
    for b in range(batches):
        x = rng.uniform(-180, 180, per)
        y = rng.uniform(-90, 90, per)
        t = base + rng.integers(0, 12 * DAY, per)
        cols = {"__fid__": np.array([f"f{b}_{i}" for i in range(per)]), "geom__x": x,
                "geom__y": y, "dtg": t}
        if with_null_dates and b == 0:
            nulls = np.zeros(per, dtype=bool)
            nulls[::50] = True
            cols["dtg"] = np.where(nulls, 0, t)
            cols["dtg__null"] = nulls
        out.append(cols)
    return out


def _point_stores(n=30_000, batches=3, with_null_dates=False, seed=11):
    batches_cols = _point_columns(n, batches, with_null_dates, seed)
    ref = TpuDataStore(executor=TpuScanExecutor(default_mesh()))
    port = TorchDataStore(device="cpu")
    for store, spec_fn in ((ref, ref_parse_spec), (port, parse_spec)):
        ft = spec_fn("t", "dtg:Date,*geom:Point:srid=4326")
        store.create_schema(ft)
        for cols in batches_cols:
            store._insert_columns(ft, {k: v.copy() for k, v in cols.items()})
    return ref, port


def _fids(res):
    return set(map(str, res.fids))


SEEK_ROUTES = {"device-seek", "device-seek-xz", "host-seek"}


def _both(monkeypatch, ref, port, name, queries):
    """{query: (ref fids, port fids, port route, port host-seek fids)}: the
    first three under GEOMESA_DEVSEEK=1, a seek route equal to the
    reference's, then the port's host seek's fids under 0."""
    monkeypatch.setenv("GEOMESA_DEVSEEK", "1")
    out = {}
    for q in queries:
        r = port.query(name, q)
        want = ref.query(name, q)
        if isinstance(ref, TpuDataStore) and {r.scan_path, want.plan.scan_path} & SEEK_ROUTES:
            # the seek choice is the reference's (the device routes past it
            # carry the port's recorded departures)
            assert r.scan_path == want.plan.scan_path, q
        out[q] = [_fids(want), _fids(r), r.scan_path]
    monkeypatch.setenv("GEOMESA_DEVSEEK", "0")
    for q in queries:
        out[q].append(_fids(port.query(name, q)))
    return out


def test_devseek_parity_vs_host(monkeypatch):  # test_device_seek.py:59
    ref, port = _point_stores()
    got = _both(monkeypatch, ref, port, "t", QUERIES)
    routes = {q: v[2] for q, v in got.items()}
    assert routes[QUERIES[0]] == "device-seek"
    for q, (want, dev, _route, host) in got.items():
        assert dev == want == host, q
    assert any(v[0] for v in got.values())


def test_devseek_tombstones(monkeypatch):  # test_device_seek.py:73
    monkeypatch.setenv("GEOMESA_DEVSEEK", "1")
    ref, port = _point_stores(batches=2)
    before = _fids(port.query("t", QUERIES[0]))
    assert before == _fids(ref.query("t", QUERIES[0]))
    victims = sorted(before)[: len(before) // 2]
    for store in (ref, port):
        store.delete_features("t", victims)
    res = port.query("t", QUERIES[0])
    assert res.scan_path == "device-seek"
    assert _fids(res) == before - set(victims) == _fids(ref.query("t", QUERIES[0]))


def test_devseek_null_dates_excluded_from_temporal(monkeypatch):  # test_device_seek.py:83
    ref, port = _point_stores(with_null_dates=True)
    q2 = "bbox(geom, -180, -90, 180, 90)"
    got = _both(monkeypatch, ref, port, "t", [QUERIES[0], q2])
    want, dev, route, host = got[QUERIES[0]]
    assert dev == want == host and want and route == "device-seek"
    assert got[q2][1] == got[q2][0] == got[q2][3]


def test_devseek_declines_on_residual(monkeypatch):  # test_device_seek.py:97
    rng = np.random.default_rng(2)
    base = np.datetime64("2026-03-01", "ms").astype(np.int64)
    rows = [(f"n{i % 7}", int(base + rng.integers(0, 5 * DAY)), float(rng.uniform(-180, 180)),
             float(rng.uniform(-90, 90)), f"f{i}") for i in range(5000)]
    ref = TpuDataStore(executor=TpuScanExecutor(default_mesh()))
    port = TorchDataStore(device="cpu")
    from geomesa_tpu.geom.base import Point as RefPoint

    for store, spec_fn, pt in ((ref, ref_parse_spec, RefPoint), (port, parse_spec, Point)):
        store.create_schema(spec_fn("t", "name:String,dtg:Date,*geom:Point:srid=4326"))
        with store.writer("t") as w:
            for name, t, x, y, fid in rows:
                w.write([name, t, pt(x, y)], fid=fid)
    q = "bbox(geom, -90, -45, 90, 45) AND name = 'n3'"
    got = _both(monkeypatch, ref, port, "t", [q])
    want, dev, route, host = got[q]
    assert dev == want == host and dev and route != "device-seek"
    assert all(int(f[1:]) % 7 == 3 for f in dev)


def _extent_rows(n, seed, timed=False, null_dates=False):
    rng = np.random.default_rng(seed)
    base = np.datetime64("2026-06-01", "ms").astype(np.int64)
    rows = []
    for i in range(n):
        x0 = float(rng.uniform(-170, 160))
        y0 = float(rng.uniform(-80, 70))
        k = i % (3 if timed else 4)
        if k == 0:
            g = ("poly", [[x0, y0], [x0 + 1, y0], [x0 + 1, y0 + 1], [x0, y0 + 1], [x0, y0]])
        elif k == 1:
            g = ("poly", [[x0, y0], [x0 + 2, y0], [x0 + 1, y0 + 2], [x0, y0]])
        elif k == 2:
            g = ("line", [(x0, y0), (x0 + 1.5, y0 + 0.7)])
        else:
            g = None
        t = None
        if timed:
            t = None if (null_dates and i % 37 == 0) else int(base + rng.integers(0, 12 * DAY))
        rows.append((g, t, f"w{i}"))
    return rows


def _extent_stores(name, spec, rows, flush):
    from geomesa_tpu.geom import base as ref_geom
    from geomesa_tpu_torch.geom import base as port_geom

    ref = TpuDataStore(executor=TpuScanExecutor(default_mesh()), flush_size=flush)
    port = TorchDataStore(device="cpu", flush_size=flush)
    for store, spec_fn, gm in ((ref, ref_parse_spec, ref_geom), (port, parse_spec, port_geom)):
        store.create_schema(spec_fn(name, spec))
        with store.writer(name) as w:
            for g, t, fid in rows:
                geom = None if g is None else (gm.Polygon(g[1]) if g[0] == "poly"
                                               else gm.LineString(g[1]))
                w.write([geom] if t is None and "dtg" not in spec else [t, geom], fid=fid)
    return ref, port


XZ_QUERIES = [
    "bbox(geom, 0, 0, 30, 20)",
    "bbox(geom, -170, -80, 160, 70)",
    "INTERSECTS(geom, POLYGON((-40 -30, 10 -30, 10 10, -40 10, -40 -30)))",
    "INTERSECTS(geom, POLYGON((-40 -30, 20 -30, -10 25, -40 -30)))",
]


def test_devseek_xz_parity(monkeypatch):  # test_device_seek.py:155
    ref, port = _extent_stores("ways", "*geom:Geometry:srid=4326", _extent_rows(6000, 5), 3001)
    got = _both(monkeypatch, ref, port, "ways", XZ_QUERIES)
    assert got[XZ_QUERIES[0]][2] == "device-seek-xz"
    for q, (want, dev, _route, host) in got.items():
        assert dev == want == host and want, q


def test_devseek_xz_tombstones(monkeypatch):  # test_device_seek.py:175
    monkeypatch.setenv("GEOMESA_DEVSEEK", "1")
    ref, port = _extent_stores("ways", "*geom:Geometry:srid=4326", _extent_rows(6000, 5), 3001)
    q = XZ_QUERIES[0]
    before = _fids(port.query("ways", q))
    victims = sorted(before)[::2]
    for store in (ref, port):
        store.delete_features("ways", victims)
    res = port.query("ways", q)
    assert res.scan_path == "device-seek-xz"
    assert _fids(res) == before - set(victims) == _fids(ref.query("ways", q))


XZ3_QUERIES = [
    "bbox(geom, -30, -20, 40, 30) AND dtg DURING 2026-06-02T00:00:00Z/2026-06-08T00:00:00Z",
    "INTERSECTS(geom, POLYGON((-40 -30, 10 -30, 10 10, -40 10, -40 -30))) "
    "AND dtg AFTER 2026-06-05T00:00:00Z",
    "bbox(geom, -170, -80, 160, 70) AND dtg BEFORE 2026-06-03T12:00:00Z",
]


@pytest.mark.parametrize("null_dates", [False, True])
def test_devseek_xz3_parity(monkeypatch, null_dates):  # test_device_seek.py:223
    rows = _extent_rows(5000, 9, timed=True, null_dates=null_dates)
    ref, port = _extent_stores("wt", "dtg:Date,*geom:Geometry:srid=4326", rows, 2501)
    got = _both(monkeypatch, ref, port, "wt", XZ3_QUERIES)
    assert got[XZ3_QUERIES[0]][2] == "device-seek-xz"
    for q, (want, dev, _route, host) in got.items():
        assert dev == want == host, q
    assert any(v[0] for v in got.values())


def test_devseek_xz3_tombstones_with_null_dates(monkeypatch):  # test_device_seek.py:240
    monkeypatch.setenv("GEOMESA_DEVSEEK", "1")
    rows = _extent_rows(5000, 9, timed=True, null_dates=True)
    ref, port = _extent_stores("wt", "dtg:Date,*geom:Geometry:srid=4326", rows, 2501)
    q = XZ3_QUERIES[0]
    before = _fids(port.query("wt", q))
    assert before
    victims = sorted(before)[::2]
    for store in (ref, port):
        store.delete_features("wt", victims)
    res = port.query("wt", q)
    assert res.scan_path == "device-seek-xz"
    assert _fids(res) == before - set(victims) == _fids(ref.query("wt", q))


# -- the port's own cases -------------------------------------------------------------

LABELS = ("", "a", "a&b", "a|c", "b")


def test_devseek_on_a_labelled_table_answers_as_the_host_seek(monkeypatch):
    rng = np.random.default_rng(21)
    n = 20_000
    cols = _point_columns(n, 1, False, 21)[0]
    cols["__vis__"] = rng.choice(np.array(LABELS, dtype=object), n)
    port = TorchDataStore(device="cpu", auths=["a", "b"])
    ft = parse_spec("t", "dtg:Date,*geom:Point:srid=4326")
    port.create_schema(ft)
    with port.writer("t") as w:
        w.write_columns(cols)
    readable = np.isin(cols["__vis__"], ["", "a", "a&b", "a|c", "b"])
    got = _both(monkeypatch, port, port, "t", QUERIES[:2])
    for q, (_same, dev, route, host) in got.items():
        assert route == "device-seek" and dev == host and dev, q
    # the oracle: box, window and readable labels
    t_lo = np.datetime64("2026-03-02", "ms").astype(np.int64)
    t_hi = np.datetime64("2026-03-07T12:00:00", "ms").astype(np.int64)
    m = ((cols["geom__x"] >= -30) & (cols["geom__x"] <= 40) & (cols["geom__y"] >= -20)
         & (cols["geom__y"] <= 35) & (cols["dtg"] > t_lo) & (cols["dtg"] < t_hi) & readable)
    assert got[QUERIES[0]][1] == set(cols["__fid__"][m])
    port.auths = ["a"]
    monkeypatch.setenv("GEOMESA_DEVSEEK", "1")
    narrow = _fids(port.query("t", QUERIES[0]))
    assert narrow < got[QUERIES[0]][1]


def test_devseek_after_an_age_off_sweep_answers_as_the_host_seek(monkeypatch):
    import time as _time

    now = int(_time.time() * 1000)
    rng = np.random.default_rng(31)
    n = 20_000
    x = rng.uniform(-60, 60, n)
    y = rng.uniform(-40, 40, n)
    t = now - rng.integers(0, 10 * DAY, n)
    port = TorchDataStore(device="cpu")
    ft = parse_spec("t", "dtg:Date,*geom:Point:srid=4326")
    port.create_schema(ft)
    port._insert_columns(ft, {"__fid__": np.array([f"f{i}" for i in range(n)]),
                              "geom__x": x, "geom__y": y, "dtg": t})
    lo = np.datetime64(now - 9 * DAY, "ms").astype(str)
    hi = np.datetime64(now, "ms").astype(str)
    q = f"bbox(geom, -20, -10, 20, 10) AND dtg DURING {lo}Z/{hi}Z"
    monkeypatch.setenv("GEOMESA_DEVSEEK", "1")
    before = port.query("t", q)
    assert before.scan_path == "device-seek"
    port.get_schema("t").user_data["geomesa.feature.expiry"] = "4 days"
    removed = port.age_off("t")
    assert removed > 0
    got = _both(monkeypatch, port, port, "t", [q])
    _same, dev, route, host = got[q]
    assert route == "device-seek" and dev == host and dev
    assert dev < _fids(before)
    alive = t >= now - 4 * DAY
    inbox = (x >= -20) & (x <= 20) & (y >= -10) & (y <= 10)
    assert dev <= {f"f{i}" for i in np.flatnonzero(alive & inbox)}


def test_devseek_declines_past_the_candidate_budget(monkeypatch):
    """More candidates than the bitmap budget: the host seek answers."""
    monkeypatch.setenv("GEOMESA_DEVSEEK", "1")
    monkeypatch.setenv("GEOMESA_SEEK", "1")
    monkeypatch.setattr(kernels, "DEVSEEK_MAX_CAND", 1024)
    _ref, port = _point_stores(n=9000, batches=1)
    res = port.query("t", "bbox(geom, -170, -80, 170, 80)")
    assert res.scan_path == "host-seek"


@pytest.mark.parametrize("fault", ["launch", "argument"])
def test_a_devseek_kernel_fault_raises_and_degrades_nothing(monkeypatch, fault):
    _ref, port = _point_stores(n=6000, batches=1)
    monkeypatch.setenv("GEOMESA_DEVSEEK", "1")

    def failing(*args, **kw):
        if fault == "launch":
            kernels._raise_on(700, "devseek")
        kernels._check(torch.zeros(4, dtype=torch.int32), "xk", torch.int64,
                       torch.device("cpu"))

    monkeypatch.setattr(kernels, "devseek", failing)
    want = kernels.KernelLaunchError if fault == "launch" else kernels.KernelArgumentError
    reg = robustness_metrics()
    d0 = reg.counter("degrade.device_to_host")
    with pytest.raises(want):
        port.query("t", QUERIES[0])
    with pytest.raises(want):
        port.query_many("t", QUERIES[:2])
    assert reg.counter("degrade.device_to_host") == d0
    assert port.executor.breaker.state == "closed"


def test_devseek_scan_classes_are_chosen(monkeypatch):
    monkeypatch.setenv("GEOMESA_DEVSEEK", "1")
    _ref, port = _point_stores(n=6000, batches=2)
    plan = port._plan_cached("t", Query.cql(QUERIES[0]))
    scan = port.executor._seek_scan(port._tables["t"][plan.index.name], plan)
    assert isinstance(scan, _DeviceSeekScan) and scan.exact
    _r, p2 = _extent_stores("ways", "*geom:Geometry:srid=4326", _extent_rows(3000, 5), 1501)
    plan = p2._plan_cached("ways", Query.cql(XZ_QUERIES[0]))
    scan = p2.executor._seek_scan(p2._tables["ways"][plan.index.name], plan)
    assert isinstance(scan, _DeviceSeekXZScan) and scan.exact
    monkeypatch.setenv("GEOMESA_DEVSEEK", "auto")
    assert not isinstance(p2.executor._seek_scan(p2._tables["ways"][plan.index.name], plan),
                          _DeviceSeekXZScan)
