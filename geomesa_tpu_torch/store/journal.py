"""Write-ahead intent journal: crash-consistent multi-file mutations.

Port of ``geomesa_tpu/store/journal.py``; its records, their names and
their CRC footers are the reference's, so either package recovers a store
the other left. Every file is durable on its own (CRC footers and
fsync-before-rename, ``store/integrity.py``), but a multi-file mutation (a
partitioned write batch, a compaction rewrite, a schema delete) publishes
and deletes several files; without a transaction boundary a crash midway
would leave blocks without their siblings, metadata disagreeing with
blocks, or half-deleted types. The journal is that boundary, after the
write-ahead-intent discipline of LSM and Percolator-style multi-file
commits (Bigtable; ARIES-style redo/undo):

  1. RECORD: before any data file is touched, the mutation's full intent
     ({op, publishes, deletes, drop_type}) lands durably in the store's
     ``_journal/`` directory (CRC footer + fsync + rename).
  2. APPLY: each file lands through the atomic ``integrity.fsync_replace``
     (publishes) or ``os.remove`` (deletes, always AFTER every publish).
  3. COMMIT: the intent file is unlinked (+ a directory fsync).

A crash anywhere leaves a disk that startup recovery
(``IntentJournal.recover``, run by ``FsDataStore.__init__``) repairs
idempotently:

  * intent present, ALL publishes on disk  -> roll FORWARD: re-apply the
    deletes (idempotent), finish the metadata drop, commit.
  * intent present, ANY publish missing    -> roll BACK: unlink the
    publishes that landed (deletes only start after the last publish, so
    nothing was destroyed yet), drop the intent.
  * corrupt intent (a crash inside RECORD) -> nothing was applied:
    quarantine the record, keep the pre-state.

Either way the store reopens to exactly the pre-op or the post-op state,
never a partial one. Single-file atomic replaces (``metadata.save``, the
tombstone sidecar) journal with ``replaces=[...]`` only: the rename is
atomic already, so recovery just drops the intent, and every mutation
stays visible to recovery the same way.

Fault points (``journal.intent``, ``journal.commit``, ``fs.block_delete``,
``utils/faults.py``) instrument the protocol's crash windows; the ``crash``
fault kind (``SimulatedCrash``) and ``tests/test_torch_crash.py`` prove the
pre-or-post contract over every (fault point x mutation x position)
schedule.

The fan-out records (``fanout_begin`` / ``fanout_done`` /
``fanout_finish``) are the roll-forward obligations of a mutation across
several worker processes, kept for the fleet tier.

Concurrency: like FileMetadata, the journal assumes one writer a store:
recovery at open must not race a live writer on the same root.
"""

from __future__ import annotations

import json
import os
import sys
import time
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence

from geomesa_tpu_torch.store.integrity import (
    CorruptFileError,
    cleanup_tmp,
    durable_write,
    fsync_dir,
    fsync_enabled,
    quarantine,
    read_verified,
)
from geomesa_tpu_torch.utils import deadline, faults, trace
from geomesa_tpu_torch.utils.audit import robustness_metrics
from geomesa_tpu_torch.utils.config import QUARANTINE_TTL
from geomesa_tpu_torch.utils.retry import RetryPolicy

JOURNAL_DIR = "_journal"
INTENT_SUFFIX = ".intent"

# the intent record write is I/O like any other publish: transient
# failures (real EIO or injected OSError) get bounded retries
_INTENT_WRITE_RETRY = RetryPolicy(
    name="journal.intent", max_attempts=4, base_s=0.005, cap_s=0.1
)
# a vanished file is a completed delete, never retried
_DELETE_RETRY = RetryPolicy(
    name="fs.block_delete", max_attempts=4, base_s=0.005, cap_s=0.1,
    retryable=lambda e: isinstance(e, OSError)
    and not isinstance(e, FileNotFoundError),
)

# temp-file suffixes the scrub may sweep at store open: block tmps
# (".<name>.tmp" / savez's ".<name>.tmp.npz"), metadata/offset/scheme
# tmps ("<name>.<pid>[.<tid>].tmp"), journal-record tmps
_TMP_SUFFIXES = (".tmp", ".tmp.npz")


class IntentJournal:
    """Per-store write-ahead intent journal under ``<root>/_journal/``."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, JOURNAL_DIR)
        self._lock = threading.Lock()
        self._seq = 0

    # -- paths ---------------------------------------------------------------

    def _rel(self, path: str) -> str:
        return os.path.relpath(os.path.abspath(path), self.root)

    def _abs(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def pending(self) -> List[str]:
        """Absolute paths of uncommitted intent records, oldest first."""
        if not os.path.isdir(self.dir):
            return []
        return [
            os.path.join(self.dir, f)
            for f in sorted(os.listdir(self.dir))
            if f.endswith(INTENT_SUFFIX)
        ]

    def _next_path(self) -> str:
        os.makedirs(self.dir, exist_ok=True)
        with self._lock:
            for f in os.listdir(self.dir):
                stem = f.split(".", 1)[0]
                if stem.isdigit():
                    self._seq = max(self._seq, int(stem) + 1)
            seq = self._seq
            self._seq += 1
        return os.path.join(self.dir, f"{seq:016d}{INTENT_SUFFIX}")

    # -- record / commit -----------------------------------------------------

    def intent(
        self,
        op: str,
        publishes: Sequence[str] = (),
        deletes: Sequence[str] = (),
        replaces: Sequence[str] = (),
        drop_type: Optional[str] = None,
        rmdirs: Sequence[str] = (),
    ) -> "_Intent":
        """Open a journaled mutation scope::

            with journal.intent("fs.write", publishes=[...]):
                ... fsync_replace each publish ...

        The record lands durably on ``__enter__``; publishes happen in the
        body; deletes + rmdirs are applied on successful ``__exit__``
        (always after every publish), then the intent commits. A plain
        exception in the body rolls back inline (publishes unlinked,
        intent dropped, exception propagates); a BaseException — a
        simulated or real crash unwinding the process — leaves the intent
        on disk for startup recovery.
        """
        return _Intent(self, op, publishes, deletes, replaces, drop_type, rmdirs)

    def _write_record(self, record: Dict[str, Any]) -> str:
        path = self._next_path()
        _INTENT_WRITE_RETRY.call(self._write_record_once, path, record)
        return path

    def _write_record_once(self, path: str, record: Dict[str, Any]) -> None:
        deadline.check("journal.intent")
        faults.fault_point("journal.intent")
        durable_write(
            path, json.dumps(record, sort_keys=True).encode(), crc=True
        )

    def _commit(self, intent_path: str) -> None:
        """Drop a fully-applied intent. A plain failure here (transient
        EIO, an injected error, an expired deadline) is ABSORBED, not
        raised: the mutation already applied completely, so the caller
        must see success — the intent merely stays pending and the next
        open's recovery re-applies (idempotently) and drops it. Only a
        crash-like BaseException unwinds."""
        with trace.span("journal.commit", path=intent_path):
            try:
                deadline.check("journal.commit")
                faults.fault_point("journal.commit")
                try:
                    os.remove(intent_path)
                except FileNotFoundError:
                    pass  # already committed (recovery re-run)
                if fsync_enabled():
                    fsync_dir(self.dir)
            except Exception:  # noqa: BLE001 - recovery owns it now
                robustness_metrics().inc("journal.commit.deferred")

    def _delete_one(self, path: str) -> None:
        """Remove one file durably-by-protocol: retried on transient
        errors, a no-op when already gone (idempotent re-application
        during recovery)."""
        with trace.span("fs.block_delete", path=path):
            try:
                _DELETE_RETRY.call(self._delete_once, path)
            except FileNotFoundError:
                pass

    @staticmethod
    def _delete_once(path: str) -> None:
        deadline.check("fs.block_delete")
        faults.fault_point("fs.block_delete")
        os.remove(path)

    def _apply_deletes(self, rels: Iterable[str]) -> bool:
        """Best-effort delete application; True when every target is
        gone. A survivor (EACCES after retries) keeps the intent pending
        so the next open retries — never raises past the caller. Every
        touched parent directory is fsynced BEFORE the caller may commit:
        an unlink that hasn't reached disk when the intent is already
        durably gone would resurrect the file with no record left to
        re-delete it."""
        ok = True
        parents = set()
        for rel in rels:
            path = self._abs(rel)
            try:
                self._delete_one(path)
                parents.add(os.path.dirname(path))
            except Exception as e:  # noqa: BLE001 - survivors stay journaled
                robustness_metrics().inc("journal.delete.failed")
                sys.stderr.write(f"[journal] FAILED to delete {path}: {e}\n")
                ok = False
        if fsync_enabled():
            for d in parents:
                if os.path.isdir(d):
                    fsync_dir(d)
        return ok

    def _apply_rmdirs(self, rels: Iterable[str]) -> None:
        """Bottom-up removal of now-empty directories (schema deletes);
        purely cosmetic, never load-bearing — failures are ignored."""
        for rel in rels:
            top = self._abs(rel)
            if not os.path.isdir(top):
                continue
            for dirpath, _dirs, _files in sorted(
                os.walk(top), key=lambda w: -len(w[0])
            ):
                try:
                    os.rmdir(dirpath)
                except OSError:
                    pass

    # -- startup recovery ----------------------------------------------------

    def recover(self, metadata=None) -> Dict[str, int]:
        """Roll every pending intent forward or back (see module doc).
        Idempotent: a crash DURING recovery re-runs to the same state at
        the next open. ``metadata`` (when given) lets ``drop_type``
        intents finish their schema-registry deletion."""
        summary = {"forward": 0, "back": 0, "corrupt": 0, "kept": 0,
                   "fanouts": 0}
        pend = self.pending()
        if not pend:
            return summary
        m = robustness_metrics()
        with trace.span("recovery.journal", n_intents=len(pend)):
            for path in pend:
                try:
                    rec = json.loads(read_verified(path).decode())
                    publishes = list(rec.get("publishes", ()))
                    deletes = list(rec.get("deletes", ()))
                except (CorruptFileError, ValueError, UnicodeDecodeError,
                        AttributeError):
                    # crash inside RECORD: nothing was applied — keep the
                    # pre-state, move the torn record aside for inspection
                    quarantine(path)
                    m.inc("recovery.intent.corrupt")
                    summary["corrupt"] += 1
                    continue
                if rec.get("fanout"):
                    # a fan-out intent is a ROLL-FORWARD obligation whose
                    # remaining participants live outside this store's
                    # files: file-level recovery must neither commit nor
                    # roll it back (committing would silently drop the
                    # obligation — it has no publishes). The fleet
                    # coordinator replays it (_replay_fanouts) once its
                    # workers are reachable.
                    m.inc("recovery.fanout.pending")
                    summary["fanouts"] += 1
                    continue
                missing = [
                    p for p in publishes if not os.path.exists(self._abs(p))
                ]
                if missing:
                    # roll BACK: deletes only ever start after the last
                    # publish, so nothing is lost — unlink the partials
                    ok = self._apply_deletes(
                        p for p in publishes if os.path.exists(self._abs(p))
                    )
                    m.inc("recovery.intent.back")
                    summary["back"] += 1
                    trace.event(
                        "recovery.rollback", op=rec.get("op"),
                        missing=len(missing),
                    )
                else:
                    # roll FORWARD: finish the deletes + metadata drop
                    ok = self._apply_deletes(deletes)
                    if rec.get("drop_type") and metadata is not None:
                        metadata.delete(rec["drop_type"])
                    self._apply_rmdirs(rec.get("rmdirs", ()))
                    m.inc("recovery.intent.forward")
                    summary["forward"] += 1
                    trace.event("recovery.rollforward", op=rec.get("op"))
                if ok:
                    self._commit(path)
                else:
                    summary["kept"] += 1
        return summary

    # -- cross-worker fan-out intents ----------------------------------------
    #
    # A fleet mutation fan-out (delete/compact/delete_schema/age_off,
    # parallel/fleet.py) touches MANY worker processes with no shared
    # filesystem transaction to lean on, so its crash boundary is a
    # roll-forward record here: the full participant list lands durably
    # before the first worker is touched, each completed participant is
    # done-marked durably, and the record commits only after the last
    # one. A coordinator crash at any position leaves the record (and
    # its done-marks) for the takeover/restart coordinator to replay —
    # every participant op is idempotent, so replaying an
    # already-applied participant is safe.

    def fanout_begin(
        self,
        kind: str,
        name: str,
        participants: Sequence[str],
        payload: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Durably record a cross-worker fan-out intent; returns the
        record path used for done-marks and the final commit."""
        record: Dict[str, Any] = {
            "op": f"fleet.fanout.{kind}",
            "ts": time.time(),
            "fanout": {
                "kind": kind,
                "name": name,
                "participants": [str(p) for p in participants],
                "done": [],
                "payload": dict(payload or {}),
            },
        }
        return self._write_record(record)

    def fanout_done(self, path: str, participant: str) -> None:
        """Durably done-mark one participant (idempotent): the replay
        after a crash re-runs only the participants not marked here."""
        rec = json.loads(read_verified(path).decode())
        fan = rec.setdefault("fanout", {})
        done = fan.setdefault("done", [])
        if str(participant) not in done:
            done.append(str(participant))
            _INTENT_WRITE_RETRY.call(self._write_record_once, path, rec)

    def fanout_finish(self, path: str) -> None:
        """Commit a fully-applied fan-out intent (absorbs transient
        failures exactly like ``_commit`` — the mutation already
        applied, replay of a fully-done record is a no-op)."""
        self._commit(path)

    def pending_fanouts(self) -> List[Dict[str, Any]]:
        """Uncommitted fan-out intents, oldest first: ``[{path, ts,
        kind, name, participants, done, payload}]``. Corrupt records are
        left for ``recover()`` to quarantine."""
        out: List[Dict[str, Any]] = []
        for path in self.pending():
            try:
                rec = json.loads(read_verified(path).decode())
            except (CorruptFileError, ValueError, UnicodeDecodeError,
                    AttributeError):
                continue
            fan = rec.get("fanout")
            if fan:
                out.append({"path": path, "ts": rec.get("ts"), **fan})
        return out


class _Intent:
    """One journaled mutation scope (see ``IntentJournal.intent``)."""

    def __init__(self, journal, op, publishes, deletes, replaces, drop_type,
                 rmdirs):
        self._journal = journal
        self.op = op
        self.publishes = [journal._rel(p) for p in publishes]
        self.deletes = [journal._rel(p) for p in deletes]
        self.replaces = [journal._rel(p) for p in replaces]
        self.drop_type = drop_type
        self.rmdirs = [journal._rel(p) for p in rmdirs]
        self.path: Optional[str] = None

    def _record(self) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"op": self.op, "ts": time.time()}
        if self.publishes:
            rec["publishes"] = self.publishes
        if self.deletes:
            rec["deletes"] = self.deletes
        if self.replaces:
            rec["replaces"] = self.replaces
        if self.drop_type:
            rec["drop_type"] = self.drop_type
        if self.rmdirs:
            rec["rmdirs"] = self.rmdirs
        return rec

    def __enter__(self) -> "_Intent":
        with trace.span("journal.intent", op=self.op,
                        publishes=len(self.publishes),
                        deletes=len(self.deletes)):
            self.path = self._journal._write_record(self._record())
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is None:
            # APPLY deletes strictly after every publish, then COMMIT;
            # a survivor keeps the intent pending for the next open
            ok = self._journal._apply_deletes(self.deletes)
            self._journal._apply_rmdirs(self.rmdirs)
            if ok:
                self._journal._commit(self.path)
            else:
                robustness_metrics().inc("journal.commit.deferred")
            return False
        if isinstance(exc, Exception):
            # inline rollback on a plain failure: undo the publishes that
            # landed, drop the intent, let the original error propagate.
            # A publish that will not unlink keeps the intent pending —
            # dropping it would leave the partial visible with no record
            # — and startup recovery finishes the job.
            ok = self._journal._apply_deletes(
                p for p in self.publishes
                if os.path.exists(self._journal._abs(p))
            )
            if ok:
                self._journal._commit(self.path)
                robustness_metrics().inc("journal.rollback.inline")
            else:
                robustness_metrics().inc("journal.rollback.deferred")
            return False
        # BaseException (SimulatedCrash, KeyboardInterrupt, SystemExit):
        # the process is dying — leave the intent for startup recovery,
        # exactly the contract a real crash gets
        return False


# -- store-open recovery + scrub ----------------------------------------------


def scrub(root: str) -> Dict[str, int]:
    """Sweep crash leftovers under a store root: orphan ``*.tmp`` files
    (in-flight writes whose process died before publish) are unlinked,
    and ``*.quarantine`` files older than ``geomesa.fs.quarantine.ttl``
    are aged out (operators had their inspection window; the TTL bounds
    disk leakage). Counted under ``recovery.tmp.swept`` /
    ``recovery.quarantine.aged`` in ``robustness_metrics()``."""
    ttl_s = QUARANTINE_TTL.to_duration_s()
    now = time.time()
    m = robustness_metrics()
    out = {"tmp_swept": 0, "quarantine_aged": 0, "quarantine_present": 0}
    with trace.span("recovery.scrub", root=root):
        for dirpath, _dirs, files in os.walk(root):
            for f in files:
                path = os.path.join(dirpath, f)
                if f.endswith(_TMP_SUFFIXES):
                    cleanup_tmp(path)
                    m.inc("recovery.tmp.swept")
                    out["tmp_swept"] += 1
                elif f.endswith(".quarantine"):
                    try:
                        age = now - os.path.getmtime(path)
                    except OSError:
                        continue  # vanished mid-walk
                    if ttl_s is not None and age > ttl_s:
                        cleanup_tmp(path)
                        m.inc("recovery.quarantine.aged")
                        out["quarantine_aged"] += 1
                    else:
                        out["quarantine_present"] += 1
    return out


def recover_store(root: str, journal: IntentJournal, metadata=None) -> Dict[str, Any]:
    """Full store-open recovery: journal roll-forward/-back, then the
    orphan/quarantine scrub — all under ``recovery.*`` spans + counters.
    Returns the summary (``FsDataStore.last_recovery``)."""
    t0 = time.monotonic()
    with trace.span("recovery.open", root=root):
        intents = journal.recover(metadata)
        swept = scrub(root)
    return {
        "root": root,
        "intents": intents,
        "scrub": swept,
        "journal_pending": len(journal.pending()),
        "duration_ms": round((time.monotonic() - t0) * 1000.0, 3),
    }
