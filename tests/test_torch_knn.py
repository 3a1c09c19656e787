"""The port's kNN (BASELINE config #5) and TubeSelect against the JAX package,
on the CPU.

The same numpy columns (bench_suite.py bench_knn's generator at a small
size: uniform points, 30 days of dates) go through the reference
``TpuDataStore(executor=TpuScanExecutor(...))`` on a one-device CPU mesh and
the port's ``TorchDataStore(device="cpu")``. Kernel level: the plain
edition of ``knn_topk`` on a segment carried by ``segment_from_reference``
against the reference's ``_knn_fn`` (equal index lists, invalid and pad
rows present, ties included); the f32 distances against the reference's
``dists`` (XLA's and torch's f32 ``sin`` / ``cos`` on the CPU differ by an
ulp or so, which ``asin`` magnifies near the antipode: the tolerance is
stated in the test). Store level: ``knn_search`` under
``GEOMESA_KNN_DEVICE`` 1 / 0 / auto and ``tube_select``, held against the
reference and against f64 brute force (equal fid lists; distances equal,
both packages computing them with the same numpy haversine).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from geomesa_tpu.parallel import executor as ref_ex
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.process import knn as ref_knn
from geomesa_tpu.process.tube import tube_select as ref_tube_select
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.parallel import executor as port_ex
from geomesa_tpu_torch.parallel.executor import segment_from_reference
from geomesa_tpu_torch.parallel.mesh import link_latency_ms
from geomesa_tpu_torch.process import knn as port_knn
from geomesa_tpu_torch.process.geodesy import haversine_m
from geomesa_tpu_torch.process.tube import tube_select
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore

N = 20_000
SPEC = "dtg:Date,*geom:Point:srid=4326"
T0 = int(np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64))
DAY = 86_400_000
# bench_knn's query, the antimeridian, the polar cap, and two more
POINTS = [(2.35, 48.85), (179.95, 10.0), (-179.9, -30.0), (0.0, 84.0), (-75.0, 38.0)]


@pytest.fixture(scope="module", autouse=True)
def _env():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_KNN_DEVICE", "1")
        mp.setenv("GEOMESA_SEEK", "0")
        yield
    torch.set_num_threads(old)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("shards",))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(8)
    x = rng.uniform(-180, 180, N)
    y = rng.uniform(-85, 85, N)
    t = T0 + rng.integers(0, 30 * DAY, N)
    fids = np.char.add("f", np.arange(N).astype(f"<U{len(str(N - 1))}"))
    return {"__fid__": fids, "geom__x": x, "geom__y": y, "dtg": t}


@pytest.fixture(scope="module")
def stores(data, _env):
    ref = TpuDataStore(executor=TpuScanExecutor(_mesh()))
    ref_ft = ref_parse_spec("pts", SPEC)
    ref.create_schema(ref_ft)
    ref._insert_columns(ref_ft, dict(data))
    port = TorchDataStore(device="cpu")
    ft = parse_spec("pts", SPEC)
    port.create_schema(ft)
    port._insert_columns(ft, dict(data))
    return ref, port


def _brute(data, x, y, k, max_radius_m=np.inf):
    d = haversine_m(data["geom__x"], data["geom__y"], x, y)
    order = np.argsort(d, kind="stable")[:k]
    return [(f"f{i}", float(d[i])) for i in order if d[i] <= max_radius_m]


# -- the kernel: knn_topk_plain against _knn_fn --------------------------------


@pytest.fixture(scope="module")
def carried(stores):
    """(reference segment arrays, port segment) of the z3 table, with every
    97th row made invalid in both (the reference's deleted rows)."""
    ref, _port = stores
    table = ref._tables["pts"]["z3"]
    seg = ref.executor.device_index(table).segments[0]
    seg.load_exact(table)
    seg.load_raw(table)
    names = ["xi", "yi", "bins", "ti", "valid", "xk_hi", "xk_lo", "yk_hi", "yk_lo",
             "tk_hi", "tk_lo", "tvalid", "xf", "yf", "t_ms"]
    arrays = {k: np.array(getattr(seg, k)) for k in names}
    arrays["valid"][::97] = False
    assert seg.n_padded > N and not arrays["valid"][N:].any()  # pad rows
    return arrays, segment_from_reference(arrays, "cpu")


def _ref_topk(arrays, x, y, k):
    kk = min(k, len(arrays["xf"]))
    fn = ref_ex._knn_fn(kk, "local", _mesh())
    return np.asarray(fn(arrays["xf"], arrays["yf"], arrays["valid"],
                         jnp.float32(x), jnp.float32(y)))


def _ref_dists(arrays, x, y):
    """The reference's ``dists`` (executor.py ``_knn_fn``) written out in jnp."""
    xf, yf, valid = (jnp.asarray(arrays[k]) for k in ("xf", "yf", "valid"))
    qx, qy = jnp.float32(x), jnp.float32(y)
    sdy = jnp.sin((jnp.radians(yf) - jnp.radians(qy)) * 0.5)
    sdx = jnp.sin((jnp.radians(xf) - jnp.radians(qx)) * 0.5)
    a = sdy * sdy + jnp.cos(jnp.radians(yf)) * jnp.cos(jnp.radians(qy)) * sdx * sdx
    return np.asarray(jnp.where(valid, jnp.arcsin(jnp.sqrt(jnp.clip(a, 0.0, 1.0))), jnp.inf))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("point", POINTS[:3])
def test_knn_topk_plain_matches_reference(carried, point, k):
    arrays, seg = carried
    want = _ref_topk(arrays, *point, k)
    got = kernels.knn_topk(seg.xf, seg.yf, seg.valid, *point, k)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("point", POINTS[:3])
def test_knn_topk_plain_past_the_valid_rows(carried, point):
    """k past every valid and pad row: the same rows, the invalid and pad
    rows last in row order. Over ~20k valid rows some pairs lie within the
    2 ulp by which XLA's and torch's f32 sin / asin differ on the CPU (see
    the distance test), so the valid prefix may order such a pair the other
    way; it is held in the reference's distance order within 2 ulp."""
    arrays, seg = carried
    n_valid = int(arrays["valid"].sum())
    k = seg.n_padded + 5
    want = _ref_topk(arrays, *point, k)
    got = kernels.knn_topk(seg.xf, seg.yf, seg.valid, *point, k).numpy()
    assert len(got) == seg.n_padded and np.array_equal(np.sort(got), np.sort(want))
    assert np.array_equal(got[n_valid:], want[n_valid:])
    assert np.array_equal(got[n_valid:], np.flatnonzero(~arrays["valid"]))
    d = _ref_dists(arrays, *point)[got[:n_valid]]
    back = np.flatnonzero(np.diff(d) < 0)
    assert (_ulps(d[back], d[back + 1]) <= 2).all()


def test_knn_topk_plain_few_valid_rows(carried):
    """300 valid rows among the segment's rows and pads, k past them all:
    equal index lists."""
    arrays, _seg = carried
    few = dict(arrays)
    few["valid"] = np.zeros_like(arrays["valid"])
    few["valid"][np.random.default_rng(2).choice(N, 300, replace=False)] = True
    seg = segment_from_reference(few, "cpu")
    for point in POINTS[:3]:
        want = _ref_topk(few, *point, 1000)
        got = kernels.knn_topk(seg.xf, seg.yf, seg.valid, *point, 1000).numpy()
        assert np.array_equal(got, want)
        assert few["valid"][got[:300]].all() and not few["valid"][got[300:]].any()


def test_knn_topk_ties_take_the_lower_row_first():
    """Equal distances (duplicate coordinates, and the +inf of invalid rows)
    come in row order, as lax.top_k gives them."""
    rng = np.random.default_rng(3)
    n = 4096
    xf = rng.uniform(-20, 20, n).astype(np.float32)
    yf = rng.uniform(-20, 20, n).astype(np.float32)
    dup = [3000, 7, 1500, 64]
    xf[dup], yf[dup] = np.float32(1.5), np.float32(-2.25)
    xf[[900, 20]], yf[[900, 20]] = np.float32(1.0), np.float32(1.0)
    valid = np.ones(n, dtype=bool)
    valid[[5, 2, 4000]] = False
    k = n
    want = np.asarray(ref_ex._knn_fn(k, "local", _mesh())(
        xf, yf, valid, jnp.float32(1.5), jnp.float32(-2.25)))
    got = kernels.knn_topk(torch.from_numpy(xf), torch.from_numpy(yf), torch.from_numpy(valid),
                           1.5, -2.25, k).numpy()
    assert np.array_equal(got, want)
    assert list(got[:4]) == sorted(dup)
    assert list(got[-3:]) == [2, 5, 4000]
    pos = {r: i for i, r in enumerate(got.tolist())}
    assert pos[20] < pos[900]


def _one_bucket_table(table: str, n: int):
    """Tables whose keys crowd one bucket of the card's distance histogram:
    every point at one place (away from the query, or at it: distance 0),
    two exact clusters, NaN coordinates among spread points (NaN distances
    rank after +inf, by row), no valid row."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-180, 180, n).astype(np.float32)
    y = rng.uniform(-85, 85, n).astype(np.float32)
    valid = rng.random(n) > 0.05
    if table == "identical":
        x[:], y[:], valid[:] = np.float32(12.5), np.float32(-33.25), True
    elif table == "at_the_query":
        x[:], y[:] = np.float32(2.35), np.float32(48.85)
    elif table == "two_clusters":
        half = rng.random(n) < 0.5
        x = np.where(half, 2.35, -70.0).astype(np.float32)
        y = np.where(half, 48.85, 41.0).astype(np.float32)
    elif table == "nan":
        nan = rng.choice(n, n // 10, replace=False)
        x[nan[: n // 20]] = np.float32(np.nan)
        y[nan[n // 20:]] = np.float32(np.nan)
    elif table == "invalid":
        valid[:] = False
    return x, y, valid


@pytest.mark.parametrize("table", ["identical", "at_the_query", "two_clusters", "nan", "invalid"])
@pytest.mark.parametrize("k", [1, 33, 1125, 4096])
def test_knn_topk_plain_one_bucket_tables_match_reference(table, k):
    """The card tests' one-bucket tables, k up to every row: the plain
    edition's index lists equal ``_knn_fn``'s (ties and +inf by row)."""
    x, y, valid = _one_bucket_table(table, 4096)
    want = np.asarray(ref_ex._knn_fn(k, "local", _mesh())(
        x, y, valid, jnp.float32(2.35), jnp.float32(48.85)))
    got = kernels.knn_topk(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(valid),
                           2.35, 48.85, k).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("point", POINTS)
def test_knn_distances_match_reference(carried, point):
    """The f32 distances against the reference's ``dists``: +inf exactly
    where a row is invalid; elsewhere within 4 ulp of d plus 8 ulp of the
    term a = sin^2(d) carried through asin(sqrt(a)) (d / da = 1 / sin 2d).
    torch's and XLA's f32 sin and cos on the CPU differ by an ulp or so
    each, so the two a terms differ by up to ~6 ulp, and near the antipode
    asin magnifies that; the kernel itself is held bit for bit to this
    plain edition on the card."""
    arrays, seg = carried
    want = _ref_dists(arrays, *point)
    got = kernels.knn_distances(seg.xf, seg.yf, seg.valid, *point).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(np.isinf(got), ~arrays["valid"])
    w = want[arrays["valid"]].astype(np.float64)
    g = got[arrays["valid"]].astype(np.float64)
    a = np.sin(w) ** 2
    tol = 4 * np.spacing(w.astype(np.float32)) + \
        8 * np.spacing(a.astype(np.float32)) / np.maximum(np.sin(2 * w), 1e-30)
    assert (np.abs(g - w) <= tol).all()
    near = w < 1.0  # away from the antipode: within a few ulp
    assert _ulps(g[near], w[near]).max() <= 8


# -- the store: knn_search ----------------------------------------------------


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("point", POINTS)
def test_knn_search_matches_reference_and_brute_force(stores, data, point, k):
    ref, port = stores
    got = port_knn.knn_search(port, "pts", *point, k=k)
    assert port_knn.last_knn_path() == "device-topk"
    want = ref_knn.knn_search(ref, "pts", *point, k=k)
    assert ref_knn.last_knn_path() == "device-topk"
    assert got == want == _brute(data, *point, k)


def test_knn_search_max_radius(stores, data):
    ref, port = stores
    got = port_knn.knn_search(port, "pts", 2.35, 48.85, k=50, max_radius_m=300_000.0)
    assert got == ref_knn.knn_search(ref, "pts", 2.35, 48.85, k=50, max_radius_m=300_000.0)
    assert got == _brute(data, 2.35, 48.85, 50, 300_000.0)
    assert 0 < len(got) < 50 and all(d <= 300_000.0 for _f, d in got)


def test_knn_search_paths(stores, data, monkeypatch):
    """``cql`` and GEOMESA_KNN_DEVICE=0 take the host expanding bbox; auto
    does on the CPU too; ``last_knn_path`` follows each call."""
    _ref, port = stores
    want = _brute(data, -75.0, 38.0, 10)
    assert port_knn.knn_search(port, "pts", -75.0, 38.0, k=10) == want
    assert port_knn.last_knn_path() == "device-topk"
    got = port_knn.knn_search(port, "pts", -75.0, 38.0, k=10, cql="dtg AFTER 1970-01-01T00:00:00Z")
    assert port_knn.last_knn_path() == "host-bbox"
    assert [f for f, _ in got] == [f for f, _ in want]
    monkeypatch.setenv("GEOMESA_KNN_DEVICE", "0")
    assert port_knn.knn_search(port, "pts", -75.0, 38.0, k=10) == want
    assert port_knn.last_knn_path() == "host-bbox"
    monkeypatch.setenv("GEOMESA_KNN_DEVICE", "auto")
    assert port_knn.knn_search(port, "pts", -75.0, 38.0, k=10) == want
    assert port_knn.last_knn_path() == "host-bbox"  # the executor runs on the CPU
    monkeypatch.setenv("GEOMESA_KNN_DEVICE", "1")
    port_knn.knn_search(port, "pts", -75.0, 38.0, k=10)
    assert port_knn.last_knn_path() == "device-topk"


def test_link_latency_on_the_cpu():
    assert link_latency_ms("cpu") == 0.0


def test_knn_candidates_certify_and_escalate(stores, data, monkeypatch):
    """With no margin (k rows a segment) the f64 certificate cannot hold,
    so the segment asks for twice the rows until it does: the answer is
    still the f64 k nearest. With the margin, one launch answers."""
    _ref, port = stores
    table = port._tables["pts"]["z3"]
    launches = []
    launch = port_ex.TorchScanExecutor._knn_launch

    def counting(seg, x, y, kk):
        launches.append(kk)
        return launch(seg, x, y, kk)

    monkeypatch.setattr(port_ex.TorchScanExecutor, "_knn_launch", staticmethod(counting))
    parts = port.executor.knn_candidates(table, 0.0, 84.0, 10)
    assert launches == [26] and sum(len(r) for _b, r in parts) == 26
    monkeypatch.setattr(port_ex, "KNN_MARGIN", 0)
    monkeypatch.setattr(port_ex, "KNN_MARGIN_DIV", 1 << 30)
    launches.clear()
    got = port_knn.knn_search(port, "pts", 0.0, 84.0, k=10)
    assert launches[:2] == [10, 20]
    assert got == _brute(data, 0.0, 84.0, 10)
    assert port.executor.knn_candidates(table, 0.0, 84.0, 0) == []


# -- the store: tube_select ---------------------------------------------------


@pytest.fixture(scope="module")
def tube_stores(_env):
    """A day of points around the track's corridor, in both packages."""
    rng = np.random.default_rng(6)
    n = 20_000
    cols = {"__fid__": np.char.add("t", np.arange(n).astype("<U5")),
            "geom__x": rng.uniform(-12, 14, n), "geom__y": rng.uniform(38, 48, n),
            "dtg": T0 + 5 * DAY + rng.integers(0, DAY, n)}
    ref = TpuDataStore(executor=TpuScanExecutor(_mesh()))
    ref.create_schema(ref_parse_spec("tube", SPEC))
    ref._insert_columns(ref.get_schema("tube"), dict(cols))
    port = TorchDataStore(device="cpu")
    port.create_schema(parse_spec("tube", SPEC))
    port._insert_columns(port.get_schema("tube"), dict(cols))
    return ref, port, cols


@pytest.mark.parametrize("time_buffer_ms", [600_000, 2 * 3600_000])
def test_tube_select_matches_reference(tube_stores, time_buffer_ms):
    """A track of 8 samples over 21 hours with a 50 km buffer and the
    reference's default time buffer, then a 2-hour one: the reference's fid
    set and a brute-force corridor test of the resampled track."""
    from geomesa_tpu_torch.process.tube import _resample

    ref, port, cols = tube_stores
    track = [(-10.0 + 3 * i, 40.0 + i, T0 + 5 * DAY + i * 3 * 3600_000) for i in range(8)]
    kw = dict(buffer_m=50_000.0, time_buffer_ms=time_buffer_ms)
    got = tube_select(port, "tube", track, **kw)
    want = ref_tube_select(ref, "tube", track, **kw)
    fids = set(got.fids.tolist())
    assert fids == set(want.fids.tolist())
    samples = np.asarray(_resample(track, 100_000.0))
    d = haversine_m(cols["geom__x"][:, None], cols["geom__y"][:, None],
                    samples[None, :, 0], samples[None, :, 1])
    dt = np.abs(cols["dtg"][:, None] - samples[None, :, 2])
    brute = ((d <= 50_000.0) & (dt <= time_buffer_ms)).any(1)
    assert fids == set(cols["__fid__"][brute].tolist()) and len(fids) > 0
    assert set(got.columns) >= {"__fid__", "geom__x", "geom__y", "dtg"}


def test_tube_select_without_dates():
    """A schema with no date: the spatial corridor alone, as the reference."""
    rng = np.random.default_rng(5)
    n = 5000
    cols = {"__fid__": np.char.add("g", np.arange(n).astype("<U4")),
            "geom__x": rng.uniform(-20, 20, n), "geom__y": rng.uniform(30, 60, n)}
    ref = TpuDataStore(executor=TpuScanExecutor(_mesh()))
    ref.create_schema(ref_parse_spec("p", "*geom:Point:srid=4326"))
    ref._insert_columns(ref.get_schema("p"), dict(cols))
    port = TorchDataStore(device="cpu")
    port.create_schema(parse_spec("p", "*geom:Point:srid=4326"))
    port._insert_columns(port.get_schema("p"), dict(cols))
    track = [(0.0, 40.0, 0), (5.0, 45.0, 1000), (10.0, 50.0, 2000)]
    got = tube_select(port, "p", track, buffer_m=200_000.0)
    want = ref_tube_select(ref, "p", track, buffer_m=200_000.0)
    assert set(got.fids.tolist()) == set(want.fids.tolist()) and len(got) > 0


def test_knn_over_several_segments_and_small_tables():
    """Three ingests make three device segments, each certified on its
    own; a k past the table's rows returns every row, nearest first."""
    rng = np.random.default_rng(12)
    port = TorchDataStore(device="cpu")
    port.create_schema(parse_spec("multi", SPEC))
    ft = port.get_schema("multi")
    xs, ys = [], []
    for part in range(3):
        n = 3000 + 1000 * part
        x, y = rng.uniform(-30, 30, n), rng.uniform(-30, 30, n)
        xs.append(x)
        ys.append(y)
        port._insert_columns(ft, {
            "__fid__": np.char.add(f"p{part}_", np.arange(n).astype("<U5")),
            "geom__x": x, "geom__y": y, "dtg": T0 + rng.integers(0, DAY, n)})
        port.executor.device_index(port._tables["multi"]["z3"])  # a segment a batch
    assert len(port.executor.device_index(port._tables["multi"]["z3"]).segments) == 3
    fids = np.concatenate([np.char.add(f"p{i}_", np.arange(len(x)).astype("<U5"))
                           for i, x in enumerate(xs)])
    d = haversine_m(np.concatenate(xs), np.concatenate(ys), 1.0, 2.0)
    order = np.argsort(d, kind="stable")
    for k in (1, 10, 200):
        got = port_knn.knn_search(port, "multi", 1.0, 2.0, k=k)
        assert [f for f, _ in got] == fids[order[:k]].tolist()
        assert port_knn.last_knn_path() == "device-topk"
    small = TorchDataStore(device="cpu")
    small.create_schema(parse_spec("s", SPEC))
    small._insert_columns(small.get_schema("s"), {
        "__fid__": np.array(["a", "b", "c"]), "geom__x": np.array([0.0, 1.0, 2.0]),
        "geom__y": np.array([0.0, 0.0, 0.0]), "dtg": np.full(3, T0)})
    got = port_knn.knn_search(small, "s", 1.9, 0.0, k=10)
    assert [f for f, _ in got] == ["c", "b", "a"]
