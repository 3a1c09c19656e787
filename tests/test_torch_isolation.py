"""The port stands alone: no JAX, nothing of the JAX package, no hidden CPU.

``import geomesa_tpu_torch`` and config #1, density (z3, z2), config #3
(xz2, xz3), config #4 (the attribute planes), counts and a stats query,
config #5 (a kNN search and a TubeSelect), a polygon stream, host-seek
queries, a coalesced wave of concurrent queries, a count and an
``aggregate()`` through the aggregate pyramid, a transform and a sampled
query through it, with the native range walks and decode, and the
pyramid, transform and converter modules, then a delete, an ``age_off``
sweep, a labelled query and a degraded query (the security, breaker and
fault modules), then an EXPLAIN ANALYZE, an audited ``query_many`` and a
timeline tick (the trace, audit, plans, tenants, timeline, SLO and
brownout modules), a ``contains`` and a ``dwithin`` join and a forced
device-assisted seek, then a file store written, reopened eagerly and
lazily, queried (points and extents), crashed mid-compaction and recovered,
with the process layer over it, must load neither ``jax`` nor any
``geomesa_tpu`` module.
conftest.py imports jax in every test process, so that check runs in a
subprocess. A source scan
holds every port module (and chip_smoke.py) to the same rule, and the
default executor must refuse to run without CUDA.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from geomesa_tpu_torch.parallel import mesh
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.store.datastore import TorchDataStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "geomesa_tpu_torch")

_SUBPROCESS = r"""
import os
import sys
# the device routes first: a selective plan would take the host seek
os.environ["GEOMESA_SEEK"] = "0"
import numpy as np
import torch
torch.set_num_threads(1)
import geomesa_tpu_torch
from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore

n = 4000
rng = np.random.default_rng(1)
x = rng.uniform(-90, -60, n)
y = rng.uniform(30, 45, n)
base = np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64)
t = base + rng.integers(0, 40 * 86400_000, n)
store = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
ft = parse_spec("gdelt", "dtg:Date,*geom:Point:srid=4326")
store.create_schema(ft)
fids = np.char.add("f", np.arange(n).astype(str))
store._insert_columns(ft, {"__fid__": fids, "geom__x": x, "geom__y": y, "dtg": t})
during = "dtg DURING 2026-01-05T00:00:00Z/2026-01-19T00:00:00Z"
cqls = [f"bbox(geom, {-80.0 + i}, 36.0, {-70.0 + i}, 41.0) AND {during}" for i in range(4)]
res = store.query_many("gdelt", [Query.cql(c, properties=[]) for c in cqls])
lo = np.datetime64("2026-01-05T00:00:00", "ms").astype(np.int64)
hi = np.datetime64("2026-01-19T00:00:00", "ms").astype(np.int64)
for i, r in enumerate(res):
    m = (x >= -80 + i) & (x <= -70 + i) & (y >= 36) & (y <= 41) & (t > lo) & (t < hi)
    assert set(r.fids) == {f"f{j}" for j in np.flatnonzero(m)}, i
    assert r.plan.scan_path == "device-exact/bitmap"
# density push-downs (z3 and z2) against a numpy GridSnap oracle
env = (-80.0, 36.0, -70.0, 41.0)
for cql, keep in ((cqls[0], (t > lo) & (t < hi)), ("bbox(geom, -80.0, 36.0, -70.0, 41.0)", True)):
    r = store.query("gdelt", Query.cql(cql, hints={"density": {"envelope": env, "width": 100, "height": 60}}))
    assert r.plan.scan_path == "device-density", r.plan.scan_path
    m = (x >= env[0]) & (x <= env[2]) & (y >= env[1]) & (y <= env[3]) & keep
    col = np.clip(np.floor((x[m] - env[0]) / ((env[2] - env[0]) / 100)).astype(int), 0, 99)
    row = np.clip(np.floor((y[m] - env[1]) / ((env[3] - env[1]) / 60)).astype(int), 0, 59)
    want = np.bincount(row * 100 + col, minlength=6000).reshape(60, 100)
    assert np.array_equal(r.aggregate["density"], want)
# an xz2 and an xz3 stream of config #3 (extent features)
import chip_smoke as cs
ways = cs.synthesize_ways(3000, seed=2, bounds=(-15.0, -15.0, 45.0, 35.0), clusters=4)
wft = parse_spec("ways", cs.WAYS_SPEC)
store.create_schema(wft)
store._insert_columns(wft, cs.ways_columns(ways))
streams = cs.xz_streams(reps=2, tris=1, resid=1)
for name in ("xz2_bbox", "xz3_bbox_during"):
    items = streams[name]
    res = store.query_many("ways", [Query.cql(c, properties=[]) for c, _ in items])
    for (c, spec), r in zip(items, res):
        assert set(r.fids) == {f"w{j}" for j in cs.oracle_rows(ways, *spec)}, c
        assert r.plan.index.name == name[:3], c
        assert r.plan.scan_path == "device-batch-dual/bitmap", c
# config #4: attribute-plane queries on the device (the member and range
# editions of exact_bitmap), then one through the host seek
data, rng = cs.synthesize_attr(4000)
attr_streams = cs.attr_streams(rng, reps=4)
aft = parse_spec("attr", cs.ATTR_SPEC)
store.create_schema(aft)
store._insert_columns(aft, cs.attr_columns(data, np.char.add("f", np.arange(4000).astype(str))))
res = store.query_many("attr", [c for c, _ in attr_streams["j"]])
for (c, spec), r in zip(attr_streams["j"], res):
    assert set(r.fids) == {f"f{j}" for j in cs.attr_oracle(data, spec)}, c
    assert r.plan.scan_path == "device-exact/bitmap", (c, r.plan.scan_path)
# the count and stats push-downs (exact_count, the dual count, exact_stat_hist)
os.environ["GEOMESA_COUNT_DEVICE"] = "1"
os.environ["GEOMESA_STATS_DEVICE"] = "1"
c, spec = attr_streams["j"][0]
assert store.count("attr", c) == len(cs.attr_oracle(data, spec)), c
c, spec = streams["xz2_bbox"][0]
assert store.count("ways", c) == len(cs.oracle_rows(ways, *spec)), c
r = store.query("attr", Query.cql(cs.bbox_cql(cs.ATTR_BOX),
                                  hints={"stats": "Count();MinMax(goldstein);TopK(actor1)"}))
assert r.plan.scan_path == "device-stats", r.plan.scan_path
m = cs.in_box(data["x"], data["y"], cs.ATTR_BOX)
seq = r.aggregate["stats"].stats
assert seq[0].count == int(m.sum())
assert (seq[1].min, seq[1].max) == (data["gold"][m].min(), data["gold"][m].max())
u, k = np.unique(data["actors"][m], return_counts=True)
assert dict(seq[2].topk(5)) == dict(zip(u.tolist(), k.tolist()))
os.environ["GEOMESA_SEEK"] = "auto"
lone, spec = attr_streams["lone"][0]
r = store.query("attr", lone)
assert set(r.fids) == {f"f{j}" for j in cs.attr_oracle(data, spec)}
assert r.plan.scan_path == "host-seek", r.plan.scan_path
os.environ["GEOMESA_SEEK"] = "0"
# config #5: a kNN search on the device top-k and a TubeSelect, then a
# polygon stream on the banded ray cast, each against chip_smoke's oracles
from geomesa_tpu_torch.process import knn_search, last_knn_path, tube_select
os.environ["GEOMESA_KNN_DEVICE"] = "1"
kx, ky, kt = cs.synthesize_knn(5000)
kft = parse_spec("knn", cs.KNN_SPEC)
store.create_schema(kft)
store._insert_columns(kft, {"__fid__": np.char.add("f", np.arange(5000).astype(str)),
                            "geom__x": kx, "geom__y": ky, "dtg": kt})
got = knn_search(store, "knn", 179.95, 10.0, k=10)
assert got == cs.knn_oracle(cs.haversine_np(kx, ky, 179.95, 10.0), 10), got
assert last_knn_path() == "device-topk"
track = cs.tube_track(int(kt.min()) + 5 * 86400_000)
r = tube_select(store, "knn", track, buffer_m=500_000.0, time_buffer_ms=2 * 86400_000)
assert set(r.fids) == {f"f{j}" for j in cs.tube_oracle(kx, ky, kt, track, 500_000.0,
                                                        2 * 86400_000)}
px, py = cs.synthesize_poly(5000)
pft = parse_spec("poly", cs.POLY_SPEC)
store.create_schema(pft)
store._insert_columns(pft, {"__fid__": np.char.add("f", np.arange(5000).astype(str)),
                            "geom__x": px, "geom__y": py})
items = cs.poly_streams()["l"][:4]
res = store.query_many("poly", [Query.cql(c, properties=[]) for c, _ in items])
for (c, rings), r in zip(items, res):
    assert set(r.fids) == {f"f{j}" for j in cs.pip(rings, px, py)}, c
    assert r.plan.scan_path == "device-batch-dual/bitmap", r.plan.scan_path
# the host-seek route, and the native libraries every route above ran
# (the z/xz range walks of planning, the span-window decode)
os.environ["GEOMESA_SEEK"] = "1"
res = store.query_many("gdelt", [Query.cql(c, properties=[]) for c in cqls])
for i, r in enumerate(res):
    m = (x >= -80 + i) & (x <= -70 + i) & (y >= 36) & (y <= 41) & (t > lo) & (t < hi)
    assert set(r.fids) == {f"f{j}" for j in np.flatnonzero(m)}, i
    assert r.plan.scan_path == "host-seek", r.plan.scan_path
# a coalesced wave: four concurrent queries, one admission slot held, the
# group closing on its last join; the mask sweep, no JAX
import contextvars
import threading
from geomesa_tpu_torch.utils.config import properties
os.environ["GEOMESA_SEEK"] = "0"
ctx = contextvars.Context()
held = store.admission.admit()
ctx.run(held.__enter__)
wave = [None] * 4
barrier = threading.Barrier(4)
def member(i):
    barrier.wait(30)
    wave[i] = store.query("gdelt", cqls[i])
with properties(geomesa_batch_window_ms="5000", geomesa_batch_max_queries="4"):
    threads = [threading.Thread(target=member, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
ctx.run(held.__exit__, None, None, None)
for i, r in enumerate(wave):
    m = (x >= -80 + i) & (x <= -70 + i) & (y >= 36) & (y <= 41) & (t > lo) & (t < hi)
    assert set(r.fids) == {f"f{j}" for j in np.flatnonzero(m)}, i
    assert r.scan_path == "device-exact/mask" and r.coalesced == 4, r.scan_path
# the aggregate pyramid: a count and an aggregate() through it (the build's
# kernel, its plain edition on the CPU), then a transform and a sampled query
import geomesa_tpu_torch.index.transforms
import geomesa_tpu_torch.ops.pyramid
import geomesa_tpu_torch.tools.convert
from geomesa_tpu_torch.utils import devstats
box = "bbox(geom, -85.0, 32.0, -65.0, 44.0)"
m = (x >= -85) & (x <= -65) & (y >= 32) & (y <= 44)
b0 = devstats.devstats_metrics().counter("agg.cache.builds")
assert store.count("gdelt", box) == int(m.sum())
assert devstats.devstats_metrics().counter("agg.cache.builds") == b0 + 1
q = store._as_query(box)
assert store._count_pyramid("gdelt", store.get_schema("gdelt"), q, store._plan_cached("gdelt", q))
got = store.aggregate("gdelt", box, columns=["dtg"])
assert got["count"] == int(m.sum()) and got["columns"]["dtg"]["sum"] == int(t[m].sum()), got
r = store.query("gdelt", Query.cql(box, properties=["geom", "d=dateToMillis($dtg)"]))
assert sorted(r.columns["d"].tolist()) == sorted(t[m].tolist())
r = store.query("gdelt", Query.cql(box, hints={"sampling": 0.5}))
assert len(r) == (int(m.sum()) + 1) // 2
# the write lifecycle and the labels: a delete (the device mirror's valid
# bits), an age_off sweep and a labelled query, then one device fault
# answered from the host
import time as _time
from geomesa_tpu_torch.utils import faults
os.environ["GEOMESA_SEEK"] = "0"
doomed = [f"f{j}" for j in range(0, n, 5)]
store.delete_features("gdelt", doomed)
res = store.query_many("gdelt", [Query.cql(c, properties=[]) for c in cqls])
for i, r in enumerate(res):
    m = (x >= -80 + i) & (x <= -70 + i) & (y >= 36) & (y <= 41) & (t > lo) & (t < hi)
    m &= np.arange(n) % 5 != 0
    assert set(r.fids) == {f"f{j}" for j in np.flatnonzero(m)}, i
    assert r.plan.scan_path == "device-exact/bitmap", r.plan.scan_path
cut = int(np.datetime64("2026-01-20T00:00:00", "ms").astype(np.int64))
os.environ["GEOMESA_FEATURE_EXPIRY"] = f"{int(_time.time() * 1000) - cut} ms"
aged = store.age_off("gdelt")
del os.environ["GEOMESA_FEATURE_EXPIRY"]
alive = (t >= cut) & (np.arange(n) % 5 != 0)
assert aged == int(((t < cut) & (np.arange(n) % 5 != 0)).sum())
assert store.count("gdelt", cqls[0]) == int((alive & (x >= -80) & (x <= -70) & (y >= 36)
                                            & (y <= 41) & (t > lo) & (t < hi)).sum())
vft = parse_spec("labelled", "dtg:Date,*geom:Point:srid=4326")
store.create_schema(vft)
labels = np.array(["", "USA", "USA&SECRET", None], dtype=object)[np.arange(n) % 4]
store.writer("labelled").write_columns({"__fid__": fids, "geom__x": x, "geom__y": y, "dtg": t,
                                        "__vis__": labels})
store.auths = ["USA"]
r = store.query("labelled", cqls[0])
m = (x >= -80) & (x <= -70) & (y >= 36) & (y <= 41) & (t > lo) & (t < hi) & (np.arange(n) % 4 != 2)
assert set(r.fids) == {f"f{j}" for j in np.flatnonzero(m)}
assert store.count("labelled", cqls[0]) == int(m.sum())
with faults.inject("device.fetch:error@0x1", seed=1):
    r = store.query("gdelt", cqls[1])
assert r.scan_path == "host-table-degraded", r.scan_path
# the telemetry modules: one EXPLAIN ANALYZE and one audited query_many,
# a timeline tick (the brownout ladder and the SLO engine read it)
from geomesa_tpu_torch.utils import audit, brownout, plans, slo, tenants, timeline, trace
store.audit_writer = audit.InMemoryAuditWriter()
store.metrics = audit.MetricsRegistry()
sampler = timeline.TimelineSampler(store=store, interval_s=1.0, window_s=60.0)
sampler.tick()
ea = store.explain_analyze("gdelt", cqls[2])
assert ea["actual"]["hits"] == len(store.query("gdelt", cqls[2])) and ea["stages"]["stage"] == "query"
assert ea["fingerprint"] in {r["fingerprint"] for r in store._plans_obj().rows(n=99)}
res = store.query_many("gdelt", [Query.cql(c, properties=[]) for c in cqls])
evs = store.audit_writer.events[-4:]
assert [e.hits for e in evs] == [len(r) for r in res]
assert [e.h2d_bytes for e in evs] == [r.receipt["h2d_bytes"] for r in res]
snap = sampler.tick()
assert snap["counters"]["queries"] >= 5 and snap["plans"] and snap["tenants"]
assert slo.SloEngine(sampler).evaluate()["violating"] == []
assert store._brownout.level == 0 and brownout.enabled() and tenants.enabled()
print(audit.prometheus_text([store.metrics, audit.robustness_metrics()])[:40])
# spatial joins, contains and dwithin (the join module, its kernels' plain
# editions), then a forced device-assisted seek, each against an oracle
os.environ["GEOMESA_SEEK"] = "0"
from geomesa_tpu_torch.geom.base import Point, Polygon
ring = cs.star(5.0, -5.0, 30.0)
pbox = "bbox(geom, -40.0, -40.0, 40.0, 40.0)"
store.create_schema(parse_spec("zones", "zname:String,*geom:Polygon:srid=4326"))
with store.writer("zones") as w:
    w.write(["z0", Polygon(ring.tolist())], fid="g0")
probe = store.query("poly", pbox)
pxs, pys, pf = probe.columns["geom__x"], probe.columns["geom__y"], probe.fids
j = store.query_join("zones", ("poly", pbox), predicate="contains")
assert j.stats["path"] == "device-join", j.stats
assert set(j.pairs()) == {("g0", str(pf[k])) for k in cs.pip([ring], pxs, pys)} and len(j)
store.create_schema(parse_spec("sites", "*geom:Point:srid=4326"))
sites = [(-30.0 + 5.0 * k, -20.0 + 3.5 * k) for k in range(12)]
with store.writer("sites") as w:
    for k, (sx, sy) in enumerate(sites):
        w.write([Point(sx, sy)], fid=f"s{k}")
j = store.query_join("sites", ("poly", pbox), predicate="dwithin(300000)")
assert j.stats["path"] == "device-join", j.stats
want = {(f"s{k}", str(pf[i])) for k, (sx, sy) in enumerate(sites)
        for i in np.flatnonzero(cs.haversine_np(pxs, pys, sx, sy) <= 300000.0)}
assert set(j.pairs()) == want and want
os.environ["GEOMESA_SEEK"] = "1"
os.environ["GEOMESA_DEVSEEK"] = "1"
r = store.query("poly", pbox)
assert r.scan_path == "device-seek", r.scan_path
assert set(r.fids) == set(pf) and len(pf)
os.environ["GEOMESA_SEEK"] = "0"
del os.environ["GEOMESA_DEVSEEK"]
# the file store: write config #1's rows and a few ways (geometry objects
# pickled under the reference's class names), reopen eagerly and lazily,
# query, crash a compaction and recover, and run the process layer
import shutil
import tempfile
from geomesa_tpu_torch.process import analytic, proximity_search
from geomesa_tpu_torch.store.fs import FsDataStore
froot = tempfile.mkdtemp()
fs = FsDataStore(froot, partition_scheme="daily", executor=TorchScanExecutor(device="cpu"))
fs.create_schema(parse_spec("gdelt", "dtg:Date,*geom:Point:srid=4326"))
fs._insert_columns(fs.get_schema("gdelt"), {"__fid__": fids, "geom__x": x, "geom__y": y, "dtg": t})
fs.create_schema(wft)
fs._insert_columns(fs.get_schema("ways"), cs.ways_columns(ways))
fs.stats.flush()
for lazy in (False, True):
    fs2 = FsDataStore(froot, lazy=lazy, executor=TorchScanExecutor(device="cpu"))
    res = fs2.query_many("gdelt", cqls)
    for i, r in enumerate(res):
        m = (x >= -80 + i) & (x <= -70 + i) & (y >= 36) & (y <= 41) & (t > lo) & (t < hi)
        assert set(r.fids) == {f"f{j}" for j in np.flatnonzero(m)}, i
        assert r.plan.scan_path == "device-exact/bitmap", r.plan.scan_path
    for c, spec in streams["xz2_bbox"] + streams["xz3_bbox_during"]:
        assert set(fs2.query("ways", c).fids) == {f"w{j}" for j in cs.oracle_rows(ways, *spec)}
    near = proximity_search(fs2, "gdelt", [(-75.0, 38.0)], 50_000.0)
    assert set(near.fids) == {f"f{j}" for j in np.flatnonzero(
        cs.haversine_np(x, y, -75.0, 38.0) <= 50_000.0)}
    grid = analytic.density_process(fs2, "gdelt", env, 100, 60, cqls[0])
    assert grid.sum() == len(res[0])
with faults.inject("fs.block_delete:crash"):
    try:
        fs2.compact("gdelt")
    except faults.SimulatedCrash:
        pass
fs3 = FsDataStore(froot, executor=TorchScanExecutor(device="cpu"))
assert fs3.last_recovery["intents"]["forward"] == 1 and fs3.count("gdelt") == n
shutil.rmtree(froot)
from geomesa_tpu_torch import native
st = native.status()
assert all(v["loaded"] for v in st.values()), st
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "geomesa_tpu"
             or m.startswith("geomesa_tpu."))
print("LOADED", bad)
assert not bad, bad
"""


def test_port_runs_config1_without_jax_or_the_reference():
    """Config #1 (z3), density (z3, z2), config #3 (xz2, xz3), config #4
    (device and host-seek routes), counts and a stats query, config #5 (kNN,
    TubeSelect), the polygon plane, host-seek queries, a coalesced wave, the
    aggregate pyramid (a count and an aggregate), a transform, a sampled
    query, a delete, an age_off sweep, a labelled query, a degraded query,
    an EXPLAIN ANALYZE, an audited query_many, a timeline tick with the SLO
    engine and the brownout ladder, a contains and a dwithin join, a forced
    device-assisted seek, a file store's write, eager and lazy reopens,
    crash recovery and processes, and the native libraries they run, load
    no JAX."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|geomesa_tpu)(?:\.|\s|,|$)", re.M)


def _port_sources():
    for d, dirs, files in os.walk(PORT):
        dirs[:] = [x for x in dirs if x != "_build"]  # kernel build outputs
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_port_source_imports_jax_or_the_reference():
    sources = list(_port_sources())
    assert len(sources) > 20
    offenders = []
    for path in sources:
        with open(path) as f:
            text = f.read()
        offenders += [f"{path}: {m.group(0).strip()}" for m in _FORBIDDEN.finditer(text)]
        if re.search(r"__import__\(|importlib", text):
            offenders.append(f"{path}: dynamic import")
    assert not offenders, offenders


def test_default_executor_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchScanExecutor()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchDataStore()
    assert TorchScanExecutor(device="cpu").device == torch.device("cpu")
    assert TorchDataStore(device="cpu").executor.device == torch.device("cpu")


def test_cuda_is_probed_in_one_place():
    hits = []
    for path in _port_sources():
        if path.startswith(PORT + os.sep):
            with open(path) as f:
                hits += [os.path.relpath(path, ROOT) for line in f if "cuda.is_available" in line]
    assert hits == [os.path.join("geomesa_tpu_torch", "parallel", "mesh.py")]
