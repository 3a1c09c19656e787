"""The port's device telemetry (``utils/devstats.py``) and the repairs of
the kernel layer under threads, on the CPU.

* the link counters equal the bytes the two counted helpers moved
  (``upload`` and ``fetch``, the executor's ``_np_local``) on config #1
  queries, the density push-down's grid copy included, and every query's
  receipt holds its own share;
* ``receipt_since`` deltas, ``record_pad`` and the ``kernel.build.*``
  counters with the compiler stubbed;
* the first build of a kernel from many threads runs once and publishes a
  whole library from a temporary file of its own; launch counts lose no
  increment under threads, and ``LAST_PASSES`` is per thread.
"""

import os
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

import bench
from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.parallel import executor as port_ex
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.utils import devstats

N = 20_000


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setenv("GEOMESA_SEEK", "0")
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _counters():
    reg = devstats.devstats_metrics()
    return reg.counter("device.h2d.bytes"), reg.counter("device.d2h.bytes")


@pytest.fixture
def spied(monkeypatch):
    """The executor's two boundary helpers, wrapped to add up the bytes
    they moved."""
    moved = {"h2d": 0, "d2h": 0, "fetches": 0}
    real_upload, real_fetch = port_ex.upload, port_ex.fetch

    def upload(arr, device):
        moved["h2d"] += np.ascontiguousarray(arr).nbytes
        return real_upload(arr, device)

    def fetch(t):
        out = real_fetch(t)
        moved["d2h"] += out.nbytes
        moved["fetches"] += 1
        return out

    monkeypatch.setattr(port_ex, "upload", upload)
    monkeypatch.setattr(port_ex, "fetch", fetch)
    return moved


def _store():
    x, y, t = bench.synthesize(N)
    store = TorchDataStore(executor=TorchScanExecutor(device="cpu"))
    ft = parse_spec("gdelt", "dtg:Date,*geom:Point:srid=4326")
    store.create_schema(ft)
    store._insert_columns(ft, {"__fid__": np.char.add("f", np.arange(N).astype(str)),
                               "geom__x": x, "geom__y": y, "dtg": t})
    return store


def test_link_counters_equal_the_bytes_the_helpers_moved(spied):
    store = _store()
    h0, d0 = _counters()
    first = store.query("gdelt", bench.QUERY)  # uploads the mirror, then the query
    _boxes, cqls = bench.make_queries(6)
    many = store.query_many("gdelt", [Query.cql(c) for c in cqls])
    grid = store.query("gdelt", Query.cql(bench.QUERY, hints={"density": {
        "envelope": (-80.0, 36.0, -70.0, 41.0), "width": 32, "height": 16}}))
    h1, d1 = _counters()
    assert spied["h2d"] > 0 and spied["d2h"] > 0
    assert (h1 - h0, d1 - d0) == (spied["h2d"], spied["d2h"])
    # the receipts hold every byte but query_many's shared dispatch (its
    # per-query receipts cover each resolve), and the density grid's copy
    # is counted like every other
    assert grid.scan_path == "device-density" and grid.receipt["d2h_bytes"] > 0
    assert first.receipt["h2d_bytes"] > N * 8  # the mirror's columns
    resolve = sum(r.receipt["d2h_bytes"] for r in many)
    assert first.receipt["d2h_bytes"] + resolve + grid.receipt["d2h_bytes"] == d1 - d0
    assert all(r.receipt["recompiles"] == 0 for r in [first, grid, *many])


def test_receipt_since_and_record_pad():
    before = devstats.receipt_snapshot()
    devstats.count_h2d(100)
    devstats.count_d2h(7)
    devstats.count_d2h(0)
    got = devstats.receipt_since(before)
    assert got == {"recompiles": 0, "h2d_bytes": 100, "d2h_bytes": 7, "pad_ratio": 0.0}
    reg = devstats.devstats_metrics()
    used0 = reg.counter("device.pad.rows_used_total")
    padded0 = reg.counter("device.pad.rows_padded_total")
    before = devstats.receipt_snapshot()
    with devstats.collecting() as own:
        devstats.record_pad(1000, 1024, "z3")
    assert own == {"pad_events": 1}
    assert devstats.receipt_since(before)["pad_ratio"] == round(1000 / 1024, 4)
    assert devstats.receipt_of(own)["pad_ratio"] == round(1000 / 1024, 4)
    assert reg.gauge("device.pad.rows_used") == 1000
    assert reg.gauge("device.pad.rows_capacity") == 1024
    assert reg.counter("device.pad.rows_used_total") - used0 == 1000
    assert reg.counter("device.pad.rows_padded_total") - padded0 == 24
    debug = devstats.device_debug()
    assert debug["pad"]["rows_capacity"] == 1024 and debug["hbm"]["bytes_in_use"] == 0


def test_a_segment_upload_records_its_padding():
    reg = devstats.devstats_metrics()
    e0 = reg.counter("device.pad.events")
    store = _store()
    res = store.query("gdelt", bench.QUERY)
    assert reg.counter("device.pad.events") - e0 == 1  # the z3 mirror
    n_padded = -(-N // port_ex.GRANULE) * port_ex.GRANULE
    assert reg.gauge("device.pad.rows_capacity") == n_padded
    assert res.receipt["pad_ratio"] == round(N / n_padded, 4)


def _fake_nvcc(calls, delay=0.0):
    def run(cmd, capture_output=True, text=True):
        out = cmd[cmd.index("-o") + 1]
        calls.append(out)
        time.sleep(delay)
        with open(out, "w") as f:
            f.write("lib of " + cmd[-1])
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info: 0 registers")
    return run


def test_kernel_builds_are_counted(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels.subprocess, "run", _fake_nvcc(calls))
    reg = devstats.devstats_metrics()
    b0, t0 = reg.counter("kernel.build.exact_bitmap"), reg.counter("kernel.build.total")
    with devstats.collecting() as own:
        path = kernels._compile("exact_bitmap")
        assert kernels._compile("exact_bitmap") == path  # present: no second build
    assert len(calls) == 1 and os.path.exists(path) and os.path.exists(path + ".ptxas")
    assert reg.counter("kernel.build.exact_bitmap") - b0 == 1
    assert reg.counter("kernel.build.total") - t0 == 1
    assert devstats.receipt_of(own)["recompiles"] == 1
    assert devstats.device_debug()["kernels"]["exact_bitmap"] >= 1


def test_concurrent_builds_use_their_own_temporary_files(tmp_path, monkeypatch):
    """Threads that build one source at once (``build_all`` beside a first
    launch, or two designs) never share a temporary file, and the published
    library is whole."""
    calls = []
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels.subprocess, "run", _fake_nvcc(calls, delay=0.05))
    barrier = threading.Barrier(4)
    paths = []

    def build():
        barrier.wait(10)
        paths.append(kernels._compile("knn_topk"))

    threads = [threading.Thread(target=build) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    assert len(set(calls)) == len(calls) == 4
    assert len(set(paths)) == 1
    with open(paths[0]) as f:
        assert f.read() == "lib of " + os.path.join(kernels.CSRC, "knn_topk.cu")
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_first_use_from_many_threads_builds_once(monkeypatch):
    """Fault 1: eight threads asking for a kernel nobody built build it
    once (a lock per source), and all get the one library."""
    builds, loads = [], []

    def compile_(name, src=None):
        builds.append(name)
        time.sleep(0.05)
        return f"/built/{name}.so"

    def load(name, path):
        loads.append(path)
        lib = object()
        kernels._LIBS[name] = lib
        return lib

    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "_BUILD_LOCKS", {})
    monkeypatch.setattr(kernels, "_compile", compile_)
    monkeypatch.setattr(kernels, "_load", load)
    barrier = threading.Barrier(8)
    got = []

    def first_use():
        barrier.wait(10)
        got.append(kernels._lib("exact_bitmap"))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    assert builds == ["exact_bitmap"] and loads == ["/built/exact_bitmap.so"]
    assert len(got) == 8 and len({id(g) for g in got}) == 1


def test_launch_counts_lose_no_increment_under_threads():
    """Fault 2: 8 threads x 2000 counted launches, every one counted, and
    the pass counts of a multi-pass wrapper are the calling thread's."""
    kernels.reset_launches()
    barrier = threading.Barrier(8)

    def count():
        barrier.wait(10)
        for _ in range(2000):
            kernels._count("exact_mask_batch_z3", "q=2")

    threads = [threading.Thread(target=count) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert kernels.LAUNCHES["exact_mask_batch_z3"] == 16_000
    assert kernels.LAUNCH_SHAPES[("exact_mask_batch_z3", "q=2")] == 16_000
    kernels.reset_launches()
    kernels.LAST_PASSES["knn_topk"] = 3
    seen = []
    th = threading.Thread(target=lambda: seen.append(kernels.LAST_PASSES.get("knn_topk")))
    th.start()
    th.join()
    assert seen == [None] and kernels.LAST_PASSES["knn_topk"] == 3


def test_concurrent_first_loads_of_one_table_upload_once(monkeypatch):
    """Concurrent first queries of one table share one mirror and load its
    exact columns once (the executor's cache lock, the segment's load
    lock)."""
    store = _store()
    uploads = []
    real_upload = port_ex.upload

    def upload(arr, device):
        uploads.append(np.asarray(arr).nbytes)
        return real_upload(arr, device)

    monkeypatch.setattr(port_ex, "upload", upload)
    barrier = threading.Barrier(6)
    errors = []

    def first():
        try:
            barrier.wait(10)
            store.query("gdelt", bench.QUERY)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    with monkeypatch.context() as mp:
        mp.setenv("GEOMESA_BATCH_ENABLED", "false")
        threads = [threading.Thread(target=first) for _ in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    assert not errors, errors
    table = store._tables["gdelt"]["z3"]
    seg = store.executor.device_index(table).segments[0]
    n_padded = seg.n_padded
    # xi, yi, ti (int32), bins (int32), valid (bool), then xk, yk, tk (int64)
    mirror = n_padded * (4 * 4 + 1) + n_padded * 8 * 3
    per_query = 4 * 8 + 2 * 8  # one box and one window
    assert sum(uploads) == mirror + 6 * per_query
