"""The port's density push-down against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its port:
``grid_snap_indices`` and ``density_band`` (at 64 x 32 and at the
non-power-of-two 100 x 60, with rows on cell edges, on box edges, at +-0.0,
NaN and inf), ``density_dual`` against ``make_sharded_density_dual`` on the
default CPU mesh in its ``pallas`` (the Pallas ``_density_kernel`` in
interpret mode) and ``xla`` editions, the raw device columns
(``load_raw``), and at the store level ``TorchDataStore(device="cpu")``
against ``TpuDataStore`` (device density forced on, as
tests/test_aggregations.py does) and against the reference's
``HostScanExecutor``: z2 and z3 density queries, the shapes the push-down
declines, a band overflow, an empty plan and a ``query_many`` mixing
density and row queries. Tolerance: exact (grids equal cell for cell, band
index sets and counts equal, scan paths equal).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from geomesa_tpu.index.planner import Query as RefQuery
from geomesa_tpu.ops import aggregations as ref_agg
from geomesa_tpu.parallel import default_mesh
from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import HostScanExecutor, TpuDataStore

from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.ops import aggregations as agg
from geomesa_tpu_torch.ops import filters as F
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.parallel.executor import (
    TorchScanExecutor,
    segment_from_reference,
)
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore

N = 4000
SPEC = "val:Double,dtg:Date,*geom:Point:srid=4326"
REF_ENV = {
    "GEOMESA_EXACT_DEVICE": "1",
    "GEOMESA_DEVBATCH": "1",
    "GEOMESA_BATCH_PROTO": "bitmap",
    "GEOMESA_SEEK": "0",
    "GEOMESA_DENSITY_DEVICE": "1",
    # no memoized grids: every reference query runs its push-down
    "GEOMESA_AGG_ENABLED": "false",
}
BASE = np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64)
DAY = 86_400_000
DURING = "dtg DURING 2026-01-03T00:00:00Z/2026-01-12T00:00:00Z"
BOX_A = (-10.0, -10.0, 10.0, 10.0)
BOX_B = (0.0, 0.0, 10.0, 10.0)


def _bbox(b) -> str:
    return f"bbox(geom, {b[0]!r}, {b[1]!r}, {b[2]!r}, {b[3]!r})"


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


def _edge_rows(rng, n):
    """Points in (-30, 30) x (-20, 20) over 20 days, the first rows on the
    cell edges of the 100 x 60 grid over BOX_A, on BOX_A's edges, at -0.0
    on BOX_B's edges, NaN (null geometries), and at the DURING bounds."""
    x = rng.uniform(-30, 30, n)
    y = rng.uniform(-20, 20, n)
    t = BASE + rng.integers(0, 20 * DAY, n)
    k = np.arange(101)
    x[:101] = -10.0 + 20.0 * k / 100
    y[:101] = rng.uniform(-10, 10, 101)
    y[101:162] = -10.0 + 20.0 * np.arange(61) / 60
    x[101:162] = rng.uniform(-10, 10, 61)
    x[162:170] = [-10.0, 10.0, -10.0, 10.0, 0.0, -0.0, -0.0, 5.0]
    y[162:170] = [-10.0, 10.0, 10.0, -10.0, -0.0, 0.0, 5.0, -0.0]
    x[170:176] = np.nan
    y[170:176] = np.nan
    lo = BASE + 2 * DAY
    hi = BASE + 11 * DAY
    t[176:182] = [lo - 1, lo, lo + 1, hi - 1, hi, hi + 1]
    x[176:182] = 1.0
    y[176:182] = 1.0
    return x, y, t


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    x, y, t = _edge_rows(rng, N)
    fids = np.char.add("f", np.arange(N).astype(str))
    return {"__fid__": fids, "val": rng.uniform(0, 10, N), "dtg": t,
            "geom__x": x, "geom__y": y}


@pytest.fixture(scope="module")
def stores(data, _env):
    ref = TpuDataStore(
        executor=TpuScanExecutor(Mesh(np.asarray(jax.devices()[:1]), ("shards",)))
    )
    host = TpuDataStore(executor=HostScanExecutor())
    for s in (ref, host):
        ft = ref_parse_spec("pts", SPEC)
        s.create_schema(ft)
        s._insert_columns(ft, dict(data))
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    ft = parse_spec("pts", SPEC)
    port.create_schema(ft)
    port._insert_columns(ft, dict(data))
    return ref, host, port


def _density(env, w, h, **extra):
    return {"density": {"envelope": env, "width": w, "height": h, **extra}}


def _run(stores, cql, hints):
    ref, host, port = stores
    want = ref.query("pts", RefQuery.cql(cql, hints=hints))
    oracle = host.query("pts", RefQuery.cql(cql, hints=hints))
    got = port.query("pts", Query.cql(cql, hints=hints))
    g = got.aggregate["density"]
    assert g.dtype == np.float64 and g.shape == want.aggregate["density"].shape
    assert np.array_equal(g, want.aggregate["density"])
    assert np.array_equal(g, oracle.aggregate["density"])
    # an empty plan is never scanned and carries no label in either package
    assert getattr(got.plan, "scan_path", None) == getattr(want.plan, "scan_path", None)
    assert len(got) == 0
    return got


# -- kernel-level: GridSnap, band, the dual pass --------------------------------


def _edge_inputs(width, height, seed):
    """float32 rows around ENV with cell-edge, box-edge, +-0.0, NaN and inf
    rows, and the padded boxes (one real box, three inverted pads)."""
    rng = np.random.default_rng(seed)
    env = np.array([-12.5, -7.25, 17.5, 9.75], dtype=np.float32)
    n = 4096
    x = rng.uniform(-20, 25, n).astype(np.float32)
    y = rng.uniform(-12, 14, n).astype(np.float32)
    dx = (env[2] - env[0]) / width
    dy = (env[3] - env[1]) / height
    x[:width + 1] = env[0] + np.arange(width + 1) * dx
    y[width + 1:width + height + 2] = env[1] + np.arange(height + 1) * dy
    box = np.array([-10.0, -5.0, 0.0, 6.0], dtype=np.float32)
    x[700:710] = box[0]
    x[710:720] = box[2]
    y[720:730] = box[1]
    y[730:740] = box[3]
    x[740:750] = -0.0
    y[750:760] = -0.0
    x[760:770] = np.nan
    y[765:775] = np.nan
    x[780], x[781], y[782] = np.inf, -np.inf, np.inf
    boxes = F.pad_boxes([tuple(box)], dtype=np.float32)
    return x, y, env, boxes


@pytest.mark.parametrize("width,height", [(64, 32), (100, 60)])
def test_grid_snap_and_band_match_reference(width, height):
    x, y, env, boxes = _edge_inputs(width, height, width)
    snap = jax.jit(ref_agg.grid_snap_indices, static_argnums=(3, 4))
    band = jax.jit(ref_agg.density_band, static_argnums=(3, 4))
    tx, ty, tenv, tboxes = (torch.from_numpy(a) for a in (x, y, env, boxes))
    for want, got in zip(snap(x, y, env, width, height),
                         agg.grid_snap_indices(tx, ty, tenv, width, height)):
        assert np.array_equal(np.asarray(want), got.numpy())
    want_band, want_near = (np.asarray(a) for a in band(x, y, env, width, height, boxes))
    got_band, got_near = agg.density_band(tx, ty, tenv, width, height, tboxes)
    assert np.array_equal(got_band.numpy(), want_band)
    assert np.array_equal(got_near.numpy(), want_near)
    # the edge rows do land in the band, the NaN rows never near
    assert want_band[:width + 1].any() and want_near[700:740].any()
    assert not want_near[760:775].any()


def _dual_inputs(width, height, seed, has_time):
    x, y, env, boxes = _edge_inputs(width, height, seed)
    rng = np.random.default_rng(seed + 1)
    n = x.shape[0] * 2
    x = np.concatenate([x, rng.uniform(-20, 25, n // 2).astype(np.float32)])
    y = np.concatenate([y, rng.uniform(-12, 14, n // 2).astype(np.float32)])
    valid = rng.random(n) > 0.05
    valid[-16:] = False
    bins = rng.integers(0, 4, n).astype(np.int32)
    offs = rng.integers(-1, 86_400_000, n).astype(np.int32)
    windows = F.pad_windows([(1, 0, 86_399_999), (2, 1000, 43_200_000)]) if has_time else None
    return x, y, bins, offs, valid, boxes, windows, env


@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_density_dual_matches_reference(mode, has_time):
    width, height = 100, 60
    x, y, bins, offs, valid, boxes, windows, env = _dual_inputs(width, height, 9, has_time)
    fns = ref_agg.make_sharded_density_dual(default_mesh(), width, height, mode)
    if has_time:
        rgrid, ridx, rcnt = fns[0](x, y, bins, offs, valid, boxes, windows, env)
    else:
        rgrid, ridx, rcnt = fns[1](x, y, valid, boxes, env)
    t = {k: torch.from_numpy(v) for k, v in dict(
        x=x, y=y, bins=bins, offs=offs, valid=valid, boxes=boxes, env=env).items()}
    tw = torch.from_numpy(windows) if has_time else None
    grid, idx, cnt = kernels.density_grid(
        t["x"], t["y"], t["bins"] if has_time else None, t["offs"] if has_time else None,
        t["valid"], t["boxes"], tw, t["env"], width, height, agg.DENSITY_BAND_CAP)
    assert grid.dtype == torch.int32 and grid.shape == (height, width)
    assert np.array_equal(grid.numpy(), np.asarray(rgrid).astype(np.int64))
    ridx = np.asarray(ridx)
    got = idx.numpy()
    assert int(cnt[0]) == int(np.asarray(rcnt).sum()) == int((got >= 0).sum()) > 0
    assert set(got[got >= 0].tolist()) == set(ridx[ridx >= 0].tolist())
    # the plain edition lists the first indices in ascending order
    assert np.array_equal(got[: int(cnt[0])], np.sort(got[: int(cnt[0])]))
    assert grid.sum() > 0


@pytest.mark.parametrize("real", [1, 2, 3])
@pytest.mark.parametrize("has_time", [True, False])
def test_dropping_pad_boxes_keeps_grid_and_band(real, has_time):
    """The card kernel stages only the boxes that can hold or band a row:
    it drops ``pad_boxes``' inverted pads (1, 1, 0, 0) when the envelope's
    margins are below 0.25 and a finite box is left. The dual pass over
    the real boxes alone gives the grid, band index set and count of the
    padded pass, and of the JAX package's (Pallas in interpret mode, and
    XLA), on rows at box and cell edges, at and around the pads' corners,
    at +-0.0, NaN and inf (one or both coordinates)."""
    width, height = 100, 60
    x, y, bins, offs, valid, _boxes, windows, env = _dual_inputs(width, height, 21, has_time)
    special = [(np.inf, np.inf), (-np.inf, np.inf), (np.inf, -np.inf), (-np.inf, -np.inf),
               (np.inf, 3.0), (2.0, -np.inf), (np.inf, np.nan), (np.nan, np.inf),
               (1.0, 1.0), (0.0, 0.0), (0.5, 0.5), (1.0, 0.0), (0.0, 1.0),
               (-0.0, -0.0), (0.0, -0.0), (-0.0, 0.0), (np.nan, np.nan)]
    for i, (sx, sy) in enumerate(special):
        x[800 + i], y[800 + i] = sx, sy
    valid[800:800 + len(special)] = True
    boxes_real = [(-10.0, -5.0, 0.0, 6.0), (0.0, 1.0, 1.0, 9.75), (-12.5, -7.25, -9.0, 0.0)]
    boxes_real = boxes_real[:real]
    padded = F.pad_boxes(boxes_real, dtype=np.float32)
    assert padded.shape[0] > real  # at least one pad
    ref = {}
    for mode in ("pallas", "xla"):
        fns = ref_agg.make_sharded_density_dual(default_mesh(), width, height, mode)
        if has_time:
            ref[mode] = fns[0](x, y, bins, offs, valid, padded, windows, env)
        else:
            ref[mode] = fns[1](x, y, valid, padded, env)
    t = {k: torch.from_numpy(v) for k, v in dict(x=x, y=y, bins=bins, offs=offs,
                                                  valid=valid, env=env).items()}
    tw = torch.from_numpy(windows) if has_time else None
    outs = []
    for boxes in (padded, padded[:real]):
        outs.append(agg.density_dual(
            t["x"], t["y"], t["bins"] if has_time else None, t["offs"] if has_time else None,
            t["valid"], torch.from_numpy(np.ascontiguousarray(boxes)), tw, t["env"],
            width, height, agg.DENSITY_BAND_CAP))
    (pgrid, pidx, pcnt), (grid, idx, cnt) = outs
    assert torch.equal(grid, pgrid) and int(grid.sum()) > 0
    assert torch.equal(idx, pidx) and int(cnt[0]) == int(pcnt[0]) > 0
    for rgrid, ridx, rcnt in ref.values():
        assert np.array_equal(grid.numpy(), np.asarray(rgrid).astype(np.int64))
        ridx = np.asarray(ridx)
        assert int(cnt[0]) == int(np.asarray(rcnt).sum())
        assert set(idx.numpy()[: int(cnt[0])].tolist()) == set(ridx[ridx >= 0].tolist())


def test_density_dual_band_overflow_keeps_true_count():
    width, height = 64, 32
    x, y, bins, offs, valid, boxes, windows, env = _dual_inputs(width, height, 3, True)
    t = [torch.from_numpy(a) for a in (x, y, bins, offs, valid, boxes, windows, env)]
    _g, full, count = agg.density_dual(*t, width, height, band_cap=4096)
    cap = 5
    g, idx, cnt = kernels.density_grid(*t, width, height, cap)
    assert int(cnt[0]) == int(count[0]) > cap
    assert np.array_equal(idx.numpy(), full.numpy()[:cap])
    assert torch.equal(g, _g.to(torch.int32))


# -- raw device columns ---------------------------------------------------------


@pytest.mark.parametrize("index", ["z3", "z2"])
def test_load_raw_and_segment_from_reference(stores, index):
    ref, _host, port = stores
    table = ref._tables["pts"][index]
    seg = ref.executor.device_index(table).segments[0]
    assert seg.load_raw(table)
    names = ["valid", "xi", "yi", "xf", "yf"] + (["bins", "ti", "t_ms"] if index == "z3" else [])
    arrays = {k: np.asarray(getattr(seg, k)) for k in names}
    ptable = port._tables["pts"][index]
    pseg = port.executor.device_index(ptable).segments[0]
    assert pseg.load_raw(ptable)
    n = pseg.n
    assert n == seg.n
    for k in ["xf", "yf"] + (["t_ms"] if index == "z3" else []):
        got = getattr(pseg, k).numpy()
        assert np.array_equal(got[:n], arrays[k][:n], equal_nan=True), k
    # one segment's state through both implementations
    qseg = segment_from_reference(arrays, "cpu")
    width, height = 100, 60
    boxes = F.pad_boxes([BOX_A], dtype=np.float32)
    env = np.asarray(BOX_A, dtype=np.float32)
    fns = ref_agg.make_sharded_density_dual(
        Mesh(np.asarray(jax.devices()[:1]), ("shards",)), width, height, "xla")
    has_time = index == "z3"
    windows = F.pad_windows([(int(arrays["bins"][0]), 0, 3 * DAY)]) if has_time else None
    if has_time:
        want = fns[0](seg.xf, seg.yf, seg.bins, seg.t_ms, seg.valid, boxes, windows, env)
    else:
        want = fns[1](seg.xf, seg.yf, seg.valid, boxes, env)
    got = kernels.density_grid(
        qseg.xf, qseg.yf, qseg.bins if has_time else None, qseg.t_ms if has_time else None,
        qseg.valid, torch.from_numpy(boxes), None if windows is None else torch.from_numpy(windows),
        torch.from_numpy(env), width, height, agg.DENSITY_BAND_CAP)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    ridx = np.asarray(want[1])
    assert set(got[1].numpy()[got[1].numpy() >= 0]) == set(ridx[ridx >= 0])
    assert int(got[2][0]) == int(np.asarray(want[2]).sum())



def test_z3_grid_leaves_out_null_dates(_env):
    """A null date is stored as 0 with a ``dtg__null`` mask; a DURING window
    over the epoch must not count it. The port's device grid equals its own
    row count and the reference's host reducer; the reference's device
    route counts the null-date rows in the box (a departure, on purpose:
    its docstring promises host parity)."""
    rng = np.random.default_rng(31)
    n, spec = 2000, "dtg:Date,*geom:Point:srid=4326"
    x, y = rng.uniform(-20, 20, n), rng.uniform(-20, 20, n)
    t = rng.integers(0, 2 * DAY, n)
    nulls = np.zeros(n, dtype=bool)
    nulls[rng.choice(n, 100, replace=False)] = True
    t[nulls] = 0
    cols = {"__fid__": np.char.add("f", np.arange(n).astype(str)), "dtg": t,
            "dtg__null": nulls, "geom__x": x, "geom__y": y}
    ref = TpuDataStore(
        executor=TpuScanExecutor(Mesh(np.asarray(jax.devices()[:1]), ("shards",)))
    )
    host = TpuDataStore(executor=HostScanExecutor())
    for s in (ref, host):
        ft = ref_parse_spec("nulls", spec)
        s.create_schema(ft)
        s._insert_columns(ft, dict(cols))
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    ft = parse_spec("nulls", spec)
    port.create_schema(ft)
    port._insert_columns(ft, dict(cols))

    box = (-10.0, -10.0, 10.0, 10.0)
    cql = f"{_bbox(box)} AND dtg DURING 1969-12-31T12:00:00Z/1970-01-01T12:00:00Z"
    hints = _density(box, 16, 16)
    got = port.query("nulls", Query.cql(cql, hints=hints))
    assert got.plan.scan_path == "device-density"
    rows = port.query("nulls", Query.cql(cql))
    inside = (x >= box[0]) & (x <= box[2]) & (y >= box[1]) & (y <= box[3])
    want = inside & ~nulls & (t < DAY // 2)
    assert len(rows) == int(want.sum())
    grid = got.aggregate["density"]
    assert grid.sum() == len(rows)
    assert np.array_equal(grid, host.query("nulls", RefQuery.cql(cql, hints=hints))
                          .aggregate["density"])
    ref_grid = ref.query("nulls", RefQuery.cql(cql, hints=hints)).aggregate["density"]
    assert ref_grid.sum() == grid.sum() + int((inside & nulls).sum())


# -- the store: push-down, declines, overflow, empty plan, query_many -----------

DEVICE_QUERIES = [
    (_bbox(BOX_A), BOX_A, 64, 32),
    (_bbox(BOX_A), BOX_A, 100, 60),
    (f"{_bbox(BOX_A)} AND {DURING}", BOX_A, 64, 32),
    (f"{_bbox(BOX_A)} AND {DURING}", (-12.0, -10.0, 10.0, 10.0), 100, 60),
    (_bbox(BOX_B), BOX_B, 100, 60),
    (f"{_bbox(BOX_B)} AND {DURING}", (-1.0, -1.0, 10.0, 10.0), 64, 32),
    (f"{_bbox(BOX_B)} OR {_bbox((-25.0, -15.0, -20.0, -12.0))}", (-30.0, -20.0, 30.0, 20.0), 100, 60),
]


@pytest.mark.parametrize("i", range(len(DEVICE_QUERIES)))
def test_density_push_down_matches_reference(stores, i):
    cql, env, w, h = DEVICE_QUERIES[i]
    got = _run(stores, cql, _density(env, w, h))
    assert got.plan.scan_path == "device-density"
    assert got.plan.index.name == ("z3" if "dtg" in cql else "z2")
    assert got.aggregate["density"].sum() > 0


def test_band_rows_are_certified_on_the_host(stores, monkeypatch):
    """The cell-edge rows of the 100 x 60 grid over BOX_A fall in the band:
    the device leaves them out of its grid and the host bins them."""
    seen = []
    certify = TorchScanExecutor._certify_density_band

    def spy(self, table, plan, spec, band, width, height):
        seen.append(sum(len(idx) for _seg, idx in band))
        return certify(self, table, plan, spec, band, width, height)

    monkeypatch.setattr(TorchScanExecutor, "_certify_density_band", spy)
    got = _run(stores, _bbox(BOX_A), _density(BOX_A, 100, 60))
    assert got.plan.scan_path == "device-density"
    assert seen and seen[0] >= 100


TRIANGLE = "POLYGON((-10 -10, 10 -10, 0 10, -10 -10))"
DECLINED = {
    "residual": (f"{_bbox(BOX_A)} AND val > 5", _density(BOX_A, 64, 32)),
    "non_rectangle": (f"INTERSECTS(geom, {TRIANGLE})", _density(BOX_A, 100, 60)),
    "weight": (f"{_bbox(BOX_A)} AND {DURING}", _density(BOX_A, 64, 32, weight="val")),
    "exact": (_bbox(BOX_A), _density(BOX_A, 64, 32, exact=True)),
    "two_intervals": (
        f"{_bbox(BOX_A)} AND (dtg DURING 2026-01-02T00:00:00Z/2026-01-04T00:00:00Z"
        " OR dtg DURING 2026-01-08T00:00:00Z/2026-01-10T00:00:00Z)",
        _density(BOX_A, 100, 60),
    ),
    # an open interval: the planner keeps the date as a residual on z2
    "open_interval": (f"{_bbox(BOX_A)} AND dtg AFTER 2026-01-02T00:00:00Z",
                      _density(BOX_A, 100, 60)),
}


@pytest.mark.parametrize("shape", sorted(DECLINED))
def test_declined_shapes_take_the_host_reducer(stores, shape):
    cql, hints = DECLINED[shape]
    got = _run(stores, cql, hints)
    assert got.plan.scan_path != "device-density"
    assert got.aggregate["density"].sum() > 0


def test_band_overflow_takes_the_host_reducer(stores, monkeypatch):
    monkeypatch.setattr(ref_agg, "DENSITY_BAND_CAP", 2)
    monkeypatch.setattr(agg, "DENSITY_BAND_CAP", 2)
    cql = f"{_bbox(BOX_A)} AND dtg BEFORE 2026-01-15T00:00:00Z"
    got = _run(stores, cql, _density(BOX_A, 100, 60))
    assert got.plan.scan_path not in ("device-density", "host-table")
    assert got.aggregate["density"].sum() > 0


def test_empty_plan_returns_a_zero_grid(stores):
    cql = f"{_bbox((0.0, 0.0, 1.0, 1.0))} AND {_bbox((5.0, 5.0, 6.0, 6.0))}"
    got = _run(stores, cql, _density(BOX_A, 64, 32))
    assert got.plan.is_empty
    assert not got.aggregate["density"].any()


def test_query_many_mixes_density_and_row_queries(stores):
    ref, host, port = stores
    box_c = (-5.0, -8.0, 7.0, 3.0)
    items = [
        (f"{_bbox(box_c)} AND {DURING}", _density(box_c, 100, 60)),
        (f"{_bbox(BOX_B)} AND {DURING}", {}),
        (_bbox(box_c), _density((-6.0, -8.0, 7.0, 4.0), 64, 32)),
        (_bbox(BOX_B), {}),
        (f"{_bbox(box_c)} AND val < 3", _density(box_c, 64, 32)),
    ]
    want = ref.query_many("pts", [RefQuery.cql(c, hints=h) for c, h in items])
    oracle = host.query_many("pts", [RefQuery.cql(c, hints=h) for c, h in items])
    got = port.query_many("pts", [Query.cql(c, hints=h) for c, h in items])
    for (cql, hints), g, w, o in zip(items, got, want, oracle):
        assert g.plan.scan_path == w.plan.scan_path, cql
        if hints:
            assert np.array_equal(g.aggregate["density"], w.aggregate["density"])
            assert np.array_equal(g.aggregate["density"], o.aggregate["density"])
        else:
            assert not g.aggregate
            assert np.array_equal(np.sort(g.fids.astype(str)), np.sort(w.fids.astype(str)))
    # plans are cached by filter: each query here has its own
    assert [g.plan.scan_path for g in got][:4] == [
        "device-density", "device-exact/runs", "device-density", "device-exact/runs"]
    assert got[4].plan.scan_path == "device-mask/runs"
