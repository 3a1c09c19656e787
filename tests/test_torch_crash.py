"""Crash consistency of the port's file store against the JAX package.

Twin of the reference's ``tests/test_crash.py`` (all but
``test_debug_recovery_endpoint``, whose web endpoint is not ported): kill
a journaled mutation at every named fault point, reopen the store from
disk, and hold it to EXACTLY the pre-op or the post-op answers, never a
partial one. The ``crash`` fault kind (``SimulatedCrash``, a
BaseException) unwinds past every ``except Exception`` and leaves the disk
as a SIGKILL would; ``skip=k`` walks the crash through the op, five
positions an (op x point), as the reference's schedules do.

The pre and post states are the reference's too: the reference opens the
port-written base and applies each op to a copy of it, and its answers
equal the port's; a store the port recovered reopens in the reference to
the same answers.
"""

import os
import shutil

import numpy as np
import pytest

from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.fs import FsDataStore as RefFsDataStore
from geomesa_tpu.utils.retry import RetryPolicy as RefRetryPolicy

from geomesa_tpu_torch.geom.base import Point
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.fs import FsDataStore
from geomesa_tpu_torch.store.journal import INTENT_SUFFIX, JOURNAL_DIR, IntentJournal
from geomesa_tpu_torch.utils import faults
from geomesa_tpu_torch.utils.audit import robustness_metrics
from geomesa_tpu_torch.utils.faults import FaultRule, SimulatedCrash
from geomesa_tpu_torch.utils.retry import RetryPolicy

pytestmark = pytest.mark.chaos

SPEC = "name:String,n:Int,dtg:Date,*geom:Point:srid=4326"
T0 = 1483228800000  # 2017-01-01T00:00:00Z
DAY = 86400000

QUERIES = [
    "INCLUDE",
    "BBOX(geom, -20, -20, 20, 20)",
    "name = 'n3'",
    "BBOX(geom, 0, 0, 60, 60) AND dtg DURING 2017-01-02T00:00:00Z/2017-01-05T00:00:00Z",
]

# every fault point a journaled mutation crosses
POINTS = ["journal.intent", "journal.commit", "fs.block_write", "fs.block_delete",
          "metadata.save"]

FLUSH = 9


@pytest.fixture(scope="module", autouse=True)
def _env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_SEEK", "0")
        yield


def rows(n=30, seed=0, start=0):
    rs = np.random.RandomState(seed)
    return [
        (f"f{start + i:05d}",
         [f"n{(start + i) % 7}", int(rs.randint(0, 100)), T0 + int(rs.randint(0, 5 * DAY)),
          Point(float(rs.uniform(-70, 70)), float(rs.uniform(-70, 70)))])
        for i in range(n)
    ]


def open_store(root):
    return FsDataStore(root, flush_size=FLUSH, partition_scheme="daily", device="cpu")


def seed_store(root):
    """The base state every op starts from: partitioned blocks on disk and a
    few durable tombstones (so that compact() has work)."""
    store = open_store(root)
    store.create_schema(parse_spec("t", SPEC))
    with store.writer("t") as w:
        for fid, values in rows():
            w.write(values, fid=fid)
    store.delete_features("t", [f"f{i:05d}" for i in (1, 8, 15)])
    return store


def _write_batch(store, point_cls=Point):
    with store.writer("t") as w:
        for fid, values in rows(n=8, seed=99, start=1000):
            w.write(values[:3] + [point_cls(values[3].x, values[3].y)], fid=fid)


# one journaled mutation each: the atomicity unit the contract covers
OPS = {
    # one write batch (< FLUSH rows: one flush, over several daily
    # partitions under ONE intent)
    "write": lambda s, P=Point: _write_batch(s, P),
    "delete_features": lambda s, P=Point: s.delete_features(
        "t", [f"f{i:05d}" for i in (0, 7, 14, 21)]),
    "compact": lambda s, P=Point: s.compact("t"),
    "delete_schema": lambda s, P=Point: s.delete_schema("t"),
    "create_schema": lambda s, P=Point: s.create_schema(
        (parse_spec if P is Point else ref_parse_spec)("u", SPEC)),
}


def _state(store):
    return {name: {q: tuple(sorted(str(f) for f in store.query(name, q).fids)) for q in QUERIES}
            for name in store.type_names}


def disk_state(root):
    """What a FRESH process sees: reopen from disk (recovery runs) and
    answer every query of every type."""
    return _state(FsDataStore(root, device="cpu"))


def ref_disk_state(root):
    return _state(RefFsDataStore(root))


def assert_no_leftovers(root):
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            assert not f.endswith((".tmp", ".tmp.npz")), os.path.join(dirpath, f)
    jd = os.path.join(root, JOURNAL_DIR)
    if os.path.isdir(jd):
        assert [f for f in os.listdir(jd) if f.endswith(INTENT_SUFFIX)] == []


@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    """Per op (base dir, pre state, post state), built once; the reference
    applies each op to its own copy of the port-written base and must land
    on the same post state."""
    from geomesa_tpu.geom.base import Point as RefPoint

    root = tmp_path_factory.mktemp("crash_base")
    base = str(root / "base")
    seed_store(base)
    pre = disk_state(base)
    assert ref_disk_state(base) == pre
    out = {}
    for opname, op in OPS.items():
        clean = str(root / f"post_{opname}")
        shutil.copytree(base, clean)
        op(open_store(clean))
        post = disk_state(clean)
        refd = str(root / f"ref_{opname}")
        shutil.copytree(base, refd)
        op(RefFsDataStore(refd, flush_size=FLUSH, partition_scheme="daily"), RefPoint)
        assert ref_disk_state(refd) == post == disk_state(refd), opname
        out[opname] = (base, pre, post)
    return out


@pytest.mark.parametrize("point", POINTS)
@pytest.mark.parametrize("opname", list(OPS))
def test_crash_schedule_recovers_pre_or_post(tmp_path, baselines, opname, point):
    """For every (fault point x journaled op), crash at the k-th hit of the
    point (k = 0..4), reopen, and hold pre-or-post parity and no leftovers;
    the reference reopens the last recovered store to the same answers."""
    base, pre, post = baselines[opname]
    for k in range(5):
        root = str(tmp_path / f"crash_{k}")
        shutil.copytree(base, root)
        store = open_store(root)
        crashed = False
        with faults.inject(rules=[FaultRule(point, "crash", max_fires=1, skip=k)]):
            try:
                OPS[opname](store)
            except SimulatedCrash:
                crashed = True
        del store  # the "process" is gone; only the disk survives
        got = disk_state(root)
        assert got == pre or got == post, (
            f"{opname} x {point} @k={k} (crashed={crashed}): partial state\n"
            f"got:  {got}\npre:  {pre}\npost: {post}")
        assert_no_leftovers(root)
    assert ref_disk_state(root) == got


def test_crash_during_recovery_is_idempotent(tmp_path, baselines):
    """Recovery itself may die and run again: crash a compaction at its
    commit (every publish landed, the intent pending), then crash the FIRST
    recovery mid-delete; the SECOND open still lands on pre or post."""
    base, pre, post = baselines["compact"]
    root = str(tmp_path / "store")
    shutil.copytree(base, root)
    store = open_store(root)
    with faults.inject(rules=[FaultRule("journal.commit", "crash")]):
        try:
            store.compact("t")
        except SimulatedCrash:
            pass
    del store
    assert IntentJournal(root).pending(), "expected a pending intent"
    with faults.inject(rules=[FaultRule("fs.block_delete", "crash", skip=1)]):
        try:
            FsDataStore(root, device="cpu")
        except SimulatedCrash:
            pass  # the recovery died mid-roll-forward
    got = disk_state(root)  # the second recovery finishes the job
    assert got == pre or got == post
    assert_no_leftovers(root)


def test_a_crash_the_reference_left_recovers_in_the_port(tmp_path, baselines):
    """The journal records are one format: a compaction the reference crashed
    at its commit rolls forward when the port opens the store."""
    from geomesa_tpu.utils import faults as ref_faults

    base, pre, post = baselines["compact"]
    root = str(tmp_path / "store")
    shutil.copytree(base, root)
    store = RefFsDataStore(root, flush_size=FLUSH, partition_scheme="daily")
    with ref_faults.inject(rules=[ref_faults.FaultRule("journal.commit", "crash")]):
        try:
            store.compact("t")
        except ref_faults.SimulatedCrash:
            pass
    del store
    assert IntentJournal(root).pending()
    reopened = FsDataStore(root, device="cpu")
    assert reopened.last_recovery["intents"]["forward"] == 1
    assert _state(reopened) == post
    assert_no_leftovers(root)


def test_recovery_rolls_back_partial_publish(tmp_path):
    """A hand-built torn mutation (the intent on disk, only some publishes
    landed) rolls BACK: the partial files go, the journal drains."""
    root = str(tmp_path / "store")
    store = seed_store(root)
    n_before = {q: len(store.query("t", q)) for q in QUERIES}
    td = os.path.join(root, "blocks", "t")
    journal = IntentJournal(root)
    landed = os.path.join(td, "partial0.npz")
    missing = os.path.join(td, "partial1.npz")
    # the landed half is a VALID block, so a bad rollback would change answers
    src = next(os.path.join(dp, f) for dp, _d, fs in os.walk(td) for f in fs if f.endswith(".npz"))
    shutil.copy(src, landed)
    journal._write_record(journal.intent("fs.write", publishes=[landed, missing])._record())
    del store
    before = robustness_metrics().counter("recovery.intent.back")
    reopened = FsDataStore(root, device="cpu")
    assert robustness_metrics().counter("recovery.intent.back") == before + 1
    assert not os.path.exists(landed)
    assert reopened.last_recovery["intents"]["back"] == 1
    assert {q: len(reopened.query("t", q)) for q in QUERIES} == n_before
    assert_no_leftovers(root)


def test_recovery_rolls_forward_complete_publish(tmp_path):
    """Every publish present and deletes pending: roll FORWARD."""
    root = str(tmp_path / "store")
    seed_store(root)
    td = os.path.join(root, "blocks", "t")
    victim = next(os.path.join(dp, f) for dp, _d, fs in os.walk(td) for f in fs
                  if f.endswith(".npz"))
    journal = IntentJournal(root)
    journal._write_record(journal.intent("fs.rewrite", deletes=[victim])._record())
    before = robustness_metrics().counter("recovery.intent.forward")
    reopened = FsDataStore(root, device="cpu")
    assert robustness_metrics().counter("recovery.intent.forward") == before + 1
    assert reopened.last_recovery["intents"] == {
        "forward": 1, "back": 0, "corrupt": 0, "kept": 0, "fanouts": 0}
    assert not os.path.exists(victim)
    assert_no_leftovers(root)


def test_corrupt_intent_quarantined_pre_state_kept(tmp_path):
    """A torn intent record (a crash inside RECORD): nothing was applied, the
    record quarantines, the store keeps its pre-state."""
    root = str(tmp_path / "store")
    store = seed_store(root)
    pre = disk_state(root)
    del store
    jd = os.path.join(root, JOURNAL_DIR)
    os.makedirs(jd, exist_ok=True)
    torn = os.path.join(jd, f"{0:016d}{INTENT_SUFFIX}")
    with open(torn, "w") as fh:
        fh.write('{"op": "fs.write", "publi')  # torn mid-record, no CRC
    before = robustness_metrics().counter("recovery.intent.corrupt")
    assert disk_state(root) == pre
    assert robustness_metrics().counter("recovery.intent.corrupt") == before + 1
    assert not os.path.exists(torn) and os.path.exists(torn + ".quarantine")


def test_scrub_sweeps_orphan_tmp_files(tmp_path):
    """Crash leftovers (*.tmp / *.tmp.npz) are swept at the open and never
    found as blocks."""
    root = str(tmp_path / "store")
    store = seed_store(root)
    pre = disk_state(root)
    del store
    td = os.path.join(root, "blocks", "t")
    strays = [os.path.join(td, ".00000099.npz.tmp"), os.path.join(td, ".00000099.npz.tmp.npz"),
              os.path.join(root, "metadata.json.12345.tmp")]
    for s in strays:
        with open(s, "wb") as fh:
            fh.write(b"half-written garbage")
    before = robustness_metrics().counter("recovery.tmp.swept")
    reopened = FsDataStore(root, device="cpu")
    assert robustness_metrics().counter("recovery.tmp.swept") == before + 3
    assert reopened.last_recovery["scrub"]["tmp_swept"] == 3
    assert not any(os.path.exists(s) for s in strays)
    assert disk_state(root) == pre


def test_crash_fault_kind_is_uncatchable_by_retry():
    """SimulatedCrash unwinds through RetryPolicy: a crash is no transient."""
    calls = []

    def op():
        calls.append(1)
        faults.fault_point("fs.block_write")

    with faults.inject(rules=[FaultRule("fs.block_write", "crash")]):
        with pytest.raises(SimulatedCrash):
            RetryPolicy(name="t", max_attempts=5, base_s=0.001).call(op)
        # nor does the reference's policy swallow the port's crash
        with pytest.raises(SimulatedCrash):
            RefRetryPolicy(name="t", max_attempts=5, base_s=0.001).call(op)
    assert len(calls) == 2  # no retry consumed either crash
    assert not issubclass(SimulatedCrash, Exception)


def test_fault_rule_skip_positions_the_crash():
    hits = []
    with faults.inject(rules=[FaultRule("fs.block_write", "crash", max_fires=1, skip=2)]):
        for i in range(5):
            try:
                faults.fault_point("fs.block_write")
                hits.append(i)
            except SimulatedCrash:
                hits.append(f"crash@{i}")
    assert hits == [0, 1, "crash@2", 3, 4]


def test_crash_during_a_lazy_load_unwinds_the_query(tmp_path):
    """A crash inside a partition load a query forced goes through the
    query, its admission slot and the breaker envelope; the store on disk is
    untouched and reopens whole."""
    root = str(tmp_path / "store")
    seed_store(root)
    pre = disk_state(root)
    lazy = FsDataStore(root, lazy=True, device="cpu")
    with faults.inject(rules=[FaultRule("fs.block_read", "crash")]):
        with pytest.raises(SimulatedCrash):
            lazy.query("t", QUERIES[3])
    assert lazy.admission.inflight == 0
    assert disk_state(root) == pre


def test_commit_failure_is_absorbed_after_full_apply(tmp_path):
    """A transient failure at journal.commit does NOT fail the mutation: the
    intent stays pending and the next open drains it."""
    root = str(tmp_path / "store")
    store = seed_store(root)
    before = robustness_metrics().counter("journal.commit.deferred")
    with faults.inject(rules=[FaultRule("journal.commit", "error")]):
        store.compact("t")  # no exception: the commit is deferred
    assert store.journal.pending()
    assert robustness_metrics().counter("journal.commit.deferred") > before
    n_live = len(store.query("t", "INCLUDE"))
    del store
    got = disk_state(root)
    assert len(got["t"]["INCLUDE"]) == n_live
    assert_no_leftovers(root)


def test_torn_tombstone_tail_is_ignored(tmp_path):
    """Only newline-terminated tombstone lines are committed: a torn tail
    never half-applies a batch (or deletes a prefix of a torn fid)."""
    root = str(tmp_path / "store")
    store = seed_store(root)
    n = len(store.query("t", "INCLUDE"))
    del store
    with open(os.path.join(root, "blocks", "t", "_tombstones.txt"), "a") as fh:
        fh.write("f00002\tf0000")  # torn mid-batch, no terminator
    assert len(FsDataStore(root, device="cpu").query("t", "INCLUDE")) == n
    assert len(RefFsDataStore(root).query("t", "INCLUDE")) == n


def test_tombstone_batch_framing_is_fid_safe(tmp_path):
    """Fid content (tabs, RS chars) never breaks the tombstone framing: a
    deleted odd fid STAYS deleted across a reopen (in either package), and
    no innocent prefix fid goes with it."""
    root = str(tmp_path / "store")
    store = open_store(root)
    store.create_schema(parse_spec("t", SPEC))
    weird = "weird\tfid\x1e"
    with store.writer("t") as w:
        for fid in (weird, "weird", "normal"):
            w.write(["n1", 1, T0, Point(1.0, 1.0)], fid=fid)
    store.delete_features("t", [weird])
    assert sorted(store.query("t", "INCLUDE").fids) == ["normal", "weird"]
    del store
    assert sorted(FsDataStore(root, device="cpu").query("t", "INCLUDE").fids) == [
        "normal", "weird"]
    assert sorted(RefFsDataStore(root).query("t", "INCLUDE").fids) == ["normal", "weird"]
