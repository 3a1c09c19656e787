"""The port's robustness layer against the JAX package, on the CPU.

Twins of the retry, CRC, quarantine and metadata tests of the reference's
``tests/test_robustness.py`` and its retry-budget tests
(``tests/test_brownout.py``): ``utils/retry.py``, ``store/integrity.py``
and ``store/metadata.py``. The same inputs go through both packages: the
retry ladders sleep the same seeded backoffs, the CRC footers and the
metadata registry are the same bytes, and a damaged store opens to the same
answers in either package (each working on its own copy of the files).
"""

import os
import random
import shutil

import numpy as np
import pytest

from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.store import integrity as ref_integrity
from geomesa_tpu.store.fs import FsDataStore as RefFsDataStore
from geomesa_tpu.store.metadata import FileMetadata as RefFileMetadata
from geomesa_tpu.store.metadata import InMemoryMetadata as RefInMemoryMetadata
from geomesa_tpu.utils.retry import RetryPolicy as RefRetryPolicy

import jax
from jax.sharding import Mesh

from geomesa_tpu_torch.geom.base import Point
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store import integrity
from geomesa_tpu_torch.store.fs import FsDataStore
from geomesa_tpu_torch.store.integrity import CorruptFileError, append_crc_footer, read_verified
from geomesa_tpu_torch.store.metadata import FileMetadata, InMemoryMetadata
from geomesa_tpu_torch.utils import faults
from geomesa_tpu_torch.utils import retry as retry_mod
from geomesa_tpu_torch.utils.audit import robustness_metrics
from geomesa_tpu_torch.utils.config import properties
from geomesa_tpu_torch.utils.retry import RetryPolicy

SPEC = "name:String,n:Int,dtg:Date,*geom:Point:srid=4326"
T0 = 1483228800000  # 2017-01-01T00:00:00Z
QUERIES = ["INCLUDE", "BBOX(geom, -20, -20, 20, 20)", "name = 'n3'"]


def counter(name):
    return robustness_metrics().report().get(name, 0)


def _rows(rows=120, seed=0):
    rs = np.random.RandomState(seed)
    return [
        ([f"n{i % 7}", int(rs.randint(0, 100)), T0 + int(rs.randint(0, 30 * 86400000))],
         (float(rs.uniform(-60, 60)), float(rs.uniform(-60, 60))), f"f{i:05d}")
        for i in range(rows)
    ]


def fill(store, rows=120, seed=0):
    ft = parse_spec("t", SPEC)
    store.create_schema(ft)
    with store.writer("t") as w:
        for vals, (x, y), fid in _rows(rows, seed):
            w.write(vals + [Point(x, y)], fid=fid)
    return ft


def port_open(root, **kw):
    return FsDataStore(root, device="cpu", **kw)


def ref_open(root, **kw):
    return RefFsDataStore(
        root, executor=TpuScanExecutor(Mesh(np.asarray(jax.devices()[:1]), ("shards",))), **kw)


def answers(store):
    return {q: sorted(store.query("t", q).fids) for q in QUERIES}


def both_open(root, tmp_path):
    """The port opens ``root`` and the reference a copy of it as it stood:
    each open repairs and quarantines on its own files."""
    copy = str(tmp_path / "refcopy")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(root, copy)
    return port_open(root), ref_open(copy)


# -- retry ---------------------------------------------------------------------


def _flaky(fails):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise OSError("transient")
        return "ok"

    return fn, calls


def test_retry_absorbs_transient_then_succeeds():
    outs = []
    for cls in (RetryPolicy, RefRetryPolicy):
        fn, calls = _flaky(2)
        sleeps = []
        p = cls(name="test", max_attempts=4, base_s=0.01, cap_s=0.05, sleep=sleeps.append,
                rng=random.Random(5))
        assert p.call(fn) == "ok"
        outs.append((len(calls), sleeps))
    assert outs[0] == outs[1]
    assert outs[0][0] == 3 and len(outs[0][1]) == 2
    assert all(0.0 <= s <= 0.05 for s in outs[0][1])
    before = counter("retry.test.retries")
    fn, _ = _flaky(2)
    RetryPolicy(name="test", max_attempts=4, base_s=0.0, cap_s=0.0, sleep=lambda s: None).call(fn)
    assert counter("retry.test.retries") == before + 2


def test_retry_gives_up_with_original_error():
    counts = []
    for cls in (RetryPolicy, RefRetryPolicy):
        calls = []

        def always():
            calls.append(1)
            raise ConnectionError("down")

        with pytest.raises(ConnectionError, match="down"):
            cls(name="test-giveup", max_attempts=3, sleep=lambda s: None).call(always)
        counts.append(len(calls))
    assert counts == [3, 3]
    before = counter("retry.test-giveup.giveup")
    with pytest.raises(ConnectionError):
        RetryPolicy(name="test-giveup", max_attempts=2, sleep=lambda s: None).call(
            lambda: (_ for _ in ()).throw(ConnectionError("down")))
    assert counter("retry.test-giveup.giveup") == before + 1


def test_retry_never_hammers_non_retryable():
    p = RetryPolicy(name="test-app", sleep=lambda s: None)
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("application bug")

    with pytest.raises(ValueError):
        p.call(boom)
    assert len(calls) == 1

    # CorruptFileError is deliberately not an OSError: never retried
    def corrupt():
        calls.append(1)
        raise CorruptFileError("bad crc")

    with pytest.raises(CorruptFileError):
        p.call(corrupt)
    assert len(calls) == 2
    assert not issubclass(CorruptFileError, OSError)
    assert not issubclass(ref_integrity.CorruptFileError, OSError)


def test_retry_deadline_bounds_total_time():
    for cls in (RetryPolicy, RefRetryPolicy):
        calls = []

        def always():
            calls.append(1)
            raise OSError("slow outage")

        with pytest.raises(OSError):
            cls(name="test-deadline", max_attempts=100, base_s=0.001, deadline_s=0.05).call(always)
        assert 1 < len(calls) < 100


def test_retry_budget_exhaustion_fails_crisply_with_original_error():
    with properties(geomesa_retry_budget_cap="2", geomesa_retry_budget_min="0",
                    geomesa_retry_budget_ratio="0"):
        retry_mod.reset_budgets()
        calls = []

        def boom():
            calls.append(1)
            raise OSError("dependency down")

        policy = RetryPolicy(name="bt_exhaust", max_attempts=10, base_s=0.0, cap_s=0.0,
                             sleep=lambda s: None)
        before = counter("retry.bt_exhaust.budget_exhausted")
        with pytest.raises(OSError, match="dependency down"):
            policy.call(boom)
        # cap 2, no refill: 1 call + exactly 2 retries
        assert len(calls) == 3
        assert counter("retry.bt_exhaust.budget_exhausted") == before + 1
        snap = retry_mod.budgets_snapshot()["bt_exhaust"]
        assert snap["tokens"] == 0.0 and snap["cap"] == 2.0
        # a second instance of the same name shares the spent bucket
        calls.clear()
        with pytest.raises(OSError):
            RetryPolicy(name="bt_exhaust", max_attempts=10, base_s=0.0, cap_s=0.0,
                        sleep=lambda s: None).call(boom)
        assert len(calls) == 1
    retry_mod.reset_budgets()


def test_retry_budget_refill_floor_and_disabled_path():
    calls = []

    def boom():
        calls.append(1)
        raise OSError("flap")

    with properties(geomesa_retry_budget_cap="1", geomesa_retry_budget_min="1000",
                    geomesa_retry_budget_ratio="0"):
        retry_mod.reset_budgets()
        with pytest.raises(OSError):
            RetryPolicy(name="bt_floor", max_attempts=4, base_s=0.001, cap_s=0.002).call(boom)
        assert len(calls) == 4
    with properties(geomesa_retry_budget_enabled="false"):
        retry_mod.reset_budgets()
        calls.clear()
        with pytest.raises(OSError):
            RetryPolicy(name="bt_off", max_attempts=4, base_s=0.0, cap_s=0.0,
                        sleep=lambda s: None).call(boom)
        assert len(calls) == 4
    retry_mod.reset_budgets()


# -- integrity: CRC, fsync, quarantine -----------------------------------------


def test_crc_footer_roundtrip_and_detection(tmp_path):
    p, r = str(tmp_path / "f.bin"), str(tmp_path / "r.bin")
    for path in (p, r):
        with open(path, "wb") as fh:
            fh.write(b"payload" * 100)
    append_crc_footer(p)
    ref_integrity.append_crc_footer(r)
    with open(p, "rb") as a, open(r, "rb") as b:
        assert a.read() == b.read()  # the reference's footer, byte for byte
    assert read_verified(p) == ref_integrity.read_verified(p) == b"payload" * 100
    assert integrity.verify_file_crc(p) is True
    # bit rot anywhere in the content is caught by both
    with open(p, "rb+") as fh:
        fh.seek(50)
        fh.write(b"\x00")
    with pytest.raises(CorruptFileError):
        read_verified(p)
    with pytest.raises(CorruptFileError):
        integrity.verify_file_crc(p)
    with pytest.raises(ref_integrity.CorruptFileError):
        ref_integrity.read_verified(p)
    # a legacy footer-less file reads unverified
    legacy = str(tmp_path / "legacy.bin")
    with open(legacy, "wb") as fh:
        fh.write(b"old" * 20)
    assert read_verified(legacy) == b"old" * 20
    assert integrity.verify_file_crc(legacy) is False


def test_durable_write_and_the_fsync_switch(tmp_path):
    assert integrity.fsync_enabled()
    for value, on in (("0", False), ("false", False), ("1", True)):
        with properties(geomesa_fs_fsync=value):
            assert integrity.fsync_enabled() is on
            path = str(tmp_path / f"d{value}.json")
            integrity.durable_write(path, b"{}", crc=True)
            assert read_verified(path) == b"{}"
            assert ref_integrity.read_verified(path) == b"{}"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_torn_block_quarantined_store_keeps_serving(tmp_path):
    root = str(tmp_path / "store")
    fill(port_open(root, flush_size=40), rows=120)
    d = os.path.join(root, "blocks", "t")
    blocks = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    assert len(blocks) == 3
    victim = os.path.join(d, blocks[1])
    with open(victim, "rb+") as fh:
        fh.truncate(os.path.getsize(victim) // 2)
    before = counter("quarantine.files")
    store, ref = both_open(root, tmp_path)
    assert len(store.query("t")) == 80  # the other two blocks still serve
    assert answers(store) == answers(ref)
    assert os.path.exists(victim + ".quarantine") and not os.path.exists(victim)
    assert counter("quarantine.files") == before + 1
    # a fresh open no longer even finds the quarantined file
    assert len(port_open(root).query("t")) == 80


def test_torn_metadata_quarantined_then_recoverable(tmp_path):
    root = str(tmp_path / "store")
    ft = fill(port_open(root, flush_size=40), rows=120)
    meta = os.path.join(root, "metadata.json")
    with open(meta, "rb+") as fh:
        fh.truncate(os.path.getsize(meta) // 2)
    before = counter("quarantine.files")
    store, ref = both_open(root, tmp_path)  # both open EMPTY, neither refuses
    assert store.type_names == ref.type_names == []
    assert os.path.exists(meta + ".quarantine")
    assert counter("quarantine.files") == before + 1
    # re-create the schema, reopen: the blocks replay
    store.create_schema(ft)
    assert len(port_open(root).query("t")) == 120


def test_injected_torn_write_is_caught_on_read(tmp_path):
    """A ``torn`` fault at ``fs.block_write`` publishes a truncated block (the
    pre-fsync crash window); the CRC and quarantine path absorbs it."""
    root = str(tmp_path / "store")
    before = counter("fault.fs.block_write.torn")
    with faults.inject(rules=[faults.FaultRule("fs.block_write", "torn", max_fires=1)]):
        fill(port_open(root, flush_size=40), rows=120)
    assert counter("fault.fs.block_write.torn") == before + 1
    store, ref = both_open(root, tmp_path)
    assert len(store.query("t")) == 80
    assert answers(store) == answers(ref)


def test_injected_block_write_errors_are_retried(tmp_path):
    root = str(tmp_path / "store")
    before = counter("retry.fs.block_write.retries")
    with faults.inject(rules=[faults.FaultRule("fs.block_write", "error", max_fires=2)]):
        fill(port_open(root, flush_size=40), rows=120)
    assert counter("retry.fs.block_write.retries") == before + 2
    store, ref = both_open(root, tmp_path)
    assert len(store.query("t")) == 120 and answers(store) == answers(ref)
    assert not [f for _d, _s, fs in os.walk(root) for f in fs if f.endswith(".tmp")]


def test_metadata_save_retries_injected_errors(tmp_path):
    m = FileMetadata(str(tmp_path / "metadata.json"))
    before = counter("retry.metadata.save.retries")
    with faults.inject(rules=[faults.FaultRule("metadata.save", "error", max_fires=2)]):
        m.insert("t", "k", "v")  # two failures absorbed by the retry
    assert counter("retry.metadata.save.retries") == before + 2
    assert FileMetadata(str(tmp_path / "metadata.json")).read("t", "k") == "v"
    # the registry is the reference's file, byte for byte
    r = RefFileMetadata(str(tmp_path / "ref.json"))
    r.insert("t", "k", "v")
    with open(tmp_path / "metadata.json", "rb") as a, open(tmp_path / "ref.json", "rb") as b:
        assert a.read() == b.read()
    assert RefFileMetadata(str(tmp_path / "metadata.json")).read("t", "k") == "v"


def test_metadata_torn_save_quarantines_at_the_next_open(tmp_path):
    path = str(tmp_path / "metadata.json")
    FileMetadata(path).insert("a", "k", "1")
    with faults.inject(rules=[faults.FaultRule("metadata.save", "torn", max_fires=1)]):
        FileMetadata(path).insert("b", "k", "2")
    m = FileMetadata(path)  # the torn registry moves aside; the open is empty
    assert m.scan_types() == []
    assert os.path.exists(path + ".quarantine")


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_metadata_semantics_match_the_reference(tmp_path, kind):
    if kind == "memory":
        port, ref = InMemoryMetadata(), RefInMemoryMetadata()
    else:
        port = FileMetadata(str(tmp_path / "p.json"))
        ref = RefFileMetadata(str(tmp_path / "r.json"))
    for m in (port, ref):
        m.insert("b", "attributes", "x:Int")
        m.insert("a", "attributes", "y:Int")
        m.insert("a", "stats", "{}")
        m.remove("a", "stats")
        m.insert("c", "k", "v")
        m.delete("c")
    assert port.scan_types() == ref.scan_types() == ["a", "b"]
    for t, k in (("a", "attributes"), ("a", "stats"), ("b", "attributes"), ("c", "k")):
        assert port.read(t, k) == ref.read(t, k)


def test_quarantine_lifecycle_skip_count_age(tmp_path):
    """A corrupt block moves aside, is SKIPPED on reload, COUNTED, kept
    through scrubs inside its TTL, then AGED OUT once older than
    ``geomesa.fs.quarantine.ttl``."""
    import time

    root = str(tmp_path / "store")
    fill(port_open(root, flush_size=40), rows=120)
    d = os.path.join(root, "blocks", "t")
    victim = os.path.join(d, sorted(f for f in os.listdir(d) if f.endswith(".npz"))[0])
    with open(victim, "rb+") as fh:
        fh.truncate(os.path.getsize(victim) // 2)
    before = counter("quarantine.files")
    store = port_open(root)
    assert len(store.query("t")) == 80
    q = victim + ".quarantine"
    assert os.path.exists(q) and not os.path.exists(victim)
    assert counter("quarantine.files") == before + 1
    # inside the TTL (7 days by default) the scrub counts it and keeps it
    reopened = port_open(root)
    assert reopened.last_recovery["scrub"]["quarantine_present"] == 1
    assert reopened.last_recovery["scrub"]["quarantine_aged"] == 0
    assert os.path.exists(q) and len(reopened.query("t")) == 80
    # beyond the TTL it is swept
    old = time.time() - 120.0
    os.utime(q, (old, old))
    aged_before = counter("recovery.quarantine.aged")
    with properties(geomesa_fs_quarantine_ttl="1 minute"):
        aged = port_open(root)
    assert not os.path.exists(q)
    assert counter("recovery.quarantine.aged") == aged_before + 1
    assert aged.last_recovery["scrub"]["quarantine_aged"] == 1
    assert len(aged.query("t")) == 80
