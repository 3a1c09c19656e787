"""FsDataStore: file-system persistence for columnar feature data.

Port of ``geomesa_tpu/store/fs.py`` over ``TorchDataStore``: the
geomesa-fs analog (FileSystemDataStore). Schemas and sketches live in a
JSON metadata file (``store/metadata.py``), feature columns land as one
``npz`` block a flushed batch (and partition), and the in-memory index
tables and device mirrors are derived state, rebuilt from the blocks at
open. The on-disk store is the reference's: the same layout, npz keys,
CRC footers, metadata JSON, scheme sidecar, tombstone sidecar and journal
records, so a store either package wrote opens in the other with the same
schemas, sketches and answers. Geometry objects of extent types are
pickled under the reference's class names (``_GeomPickler``) and read
back as the port's (``_GeomUnpickler``), so neither package imports the
other to read a block.

Partitioning (PartitionScheme.scala analogs, ``store/partitions.py``):
with a scheme, each write batch splits by partition path and lands under
``blocks/<type>/<partition...>/``. With ``lazy=True`` the store reads no
block at open; a query loads the partitions under its filter's covering
prefixes first (``_prepare_query``, inside the query's root span: the
``fs.load`` span and its ``fs.block_read`` children), so a partition
loaded after the device mirror exists joins it as a new segment at the
query's ``refresh``, and the write generation moves (``_note_write``), so
no cache answers from before the load.

Crash consistency (``store/journal.py``): a write batch, a compaction's
rewrite and a schema delete are each one journaled mutation, and the
store's open first rolls every pending intent forward or back and sweeps
the crash leftovers (``last_recovery``). Block reads and writes retry
transient failures (the ``fs.block_read`` / ``fs.block_write`` fault
points); a corrupt block is quarantined and the rest keeps serving.

Only the ``npz`` block format is ported: parquet blocks (and their
statistics push-down) wait for ``arrow/`` (ROADMAP Queue 1 item 19), and
a parquet block raises when read.

Layout:
    <root>/metadata.json
    <root>/_journal/<seq>.intent
    <root>/blocks/<type>/[_scheme.json] [_tombstones.txt]
    <root>/blocks/<type>/<partition...>/<seq>.npz
"""

from __future__ import annotations

import json
import os
import pickle
import threading
import zipfile
from typing import Dict, List, Optional, Sequence, Set, Union

import numpy as np

from geomesa_tpu_torch.schema.featuretype import FeatureType
from geomesa_tpu_torch.store.blocks import Columns, concat_columns, record_rows_decoded
from geomesa_tpu_torch.store.datastore import TorchDataStore
from geomesa_tpu_torch.store.integrity import (
    CorruptFileError,
    append_crc_footer,
    cleanup_tmp,
    fsync_dir,
    fsync_enabled,
    fsync_replace,
    quarantine,
    verify_file_crc,
)
from geomesa_tpu_torch.store.journal import IntentJournal, recover_store
from geomesa_tpu_torch.store.metadata import FileMetadata
from geomesa_tpu_torch.store.partitions import (
    PartitionScheme,
    load_scheme,
    parse_scheme,
    save_scheme,
)
from geomesa_tpu_torch.utils import deadline, faults, trace
from geomesa_tpu_torch.utils.retry import RetryPolicy

_EXTS = (".npz", ".parquet")

# tombstone-sidecar framing: a line starting with the RS control char is
# one delete batch as a JSON array (fids can contain anything); any other
# line is a single legacy-format fid
_TOMBSTONE_BATCH = "\x1e"

# transient I/O failures (real EIO or injected OSError) get bounded
# retries; CorruptFileError (not an OSError) and FileNotFoundError (a
# vanished block is deterministic) are never retried: corruption is
# quarantined instead
_BLOCK_READ_RETRY = RetryPolicy(
    name="fs.block_read", max_attempts=4, base_s=0.005, cap_s=0.1,
    retryable=lambda e: isinstance(e, OSError) and not isinstance(e, FileNotFoundError),
)
_BLOCK_WRITE_RETRY = RetryPolicy(name="fs.block_write", max_attempts=4, base_s=0.005,
                                 cap_s=0.1)


class FsDataStore(TorchDataStore):
    """A ``TorchDataStore`` kept under ``root``. ``partition_scheme`` (a
    ``PartitionScheme`` or the reference's shorthand, e.g. ``"daily"`` or
    ``"daily,z2-4bits"``) partitions the types created from now on;
    ``lazy`` defers every block read to the first query that needs it.
    The remaining keywords (``device``, ``executor``, ``query_timeout_s``,
    ...) are ``TorchDataStore``'s."""

    def __init__(
        self,
        root: str,
        executor=None,
        flush_size: Optional[int] = None,
        partition_scheme: Union[str, PartitionScheme, None] = None,
        lazy: bool = False,
        block_format: str = "npz",
        **kwargs,
    ):
        if block_format == "parquet":
            raise NotImplementedError(
                "parquet blocks are not ported: they wait for arrow/ (ROADMAP Queue 1 item 19)")
        if block_format != "npz":
            raise ValueError(f"unknown block format: {block_format!r}")
        self.root = os.path.abspath(root)
        if isinstance(partition_scheme, str):
            partition_scheme = parse_scheme(partition_scheme)
        self._default_scheme = partition_scheme
        self._schemes: Dict[str, Optional[PartitionScheme]] = {}
        self._files: Dict[str, List[str]] = {}  # type -> sorted relpaths
        self._loaded: Dict[str, Set[str]] = {}
        # one partition load at a time: concurrent queries of a lazy store
        # must not replay one block twice
        self._load_lock = threading.RLock()
        self._loading = True
        os.makedirs(os.path.join(self.root, "blocks"), exist_ok=True)
        if flush_size is not None:
            kwargs["flush_size"] = flush_size
        # the open repairs what a previous process left (pending intents
        # roll forward or back, orphan tmp files go, old quarantines age
        # out) BEFORE any state is read
        self.journal = IntentJournal(self.root)
        meta = FileMetadata(os.path.join(self.root, "metadata.json"), journal=self.journal)
        self.last_recovery = recover_store(self.root, self.journal, metadata=meta)
        super().__init__(executor=executor, metadata=meta, **kwargs)
        # the schemas came back in the base constructor; find their blocks
        # (and load them now unless lazy)
        for name in self.type_names:
            self._schemes[name] = self._read_scheme(name)
            self._files[name] = self._discover(name)
            self._loaded[name] = set()
            if not lazy:
                self._ensure_loaded(name, None)
        self._loading = False

    # -- layout ----------------------------------------------------------------

    def _type_dir(self, name: str) -> str:
        return os.path.join(self.root, "blocks", name)

    def _scheme_file(self, name: str) -> str:
        return os.path.join(self._type_dir(name), "_scheme.json")

    def _tombstone_file(self, name: str) -> str:
        return os.path.join(self._type_dir(name), "_tombstones.txt")

    def _read_scheme(self, name: str) -> Optional[PartitionScheme]:
        # a torn or corrupt sidecar quarantines and the type reads
        # unpartitioned: a bad config file never blocks the open
        return load_scheme(self._scheme_file(name))

    def _discover(self, name: str) -> List[str]:
        """Every committed block file of a type, as sorted relative paths."""
        root = self._type_dir(name)
        if not os.path.isdir(root):
            return []
        out = []
        for dirpath, _dirs, files in os.walk(root):
            rel = os.path.relpath(dirpath, root)
            for f in files:
                # dot-prefixed names are in-flight temp files (crash
                # leftovers); only committed blocks replay
                if f.endswith(_EXTS) and not f.startswith((".", "_")):
                    out.append(f if rel == "." else os.path.join(rel, f))
        return sorted(out)

    # -- lazy loading and pruning ------------------------------------------------

    def _covering_files(self, name: str, filt) -> List[str]:
        files = self._files.get(name, [])
        scheme = self._schemes.get(name)
        prefixes = None if scheme is None else scheme.covering(self.get_schema(name), filt)
        if prefixes is None:
            return files
        out = []
        for rel in files:
            d = os.path.dirname(rel)
            if any(d == p or d.startswith(p + "/") for p in prefixes):
                out.append(rel)
        return out

    def _ensure_loaded(self, name: str, filt) -> None:
        """Load the type's blocks under ``filt``'s covering partitions (every
        block: None) that are not loaded yet, then apply the stored
        tombstones to them."""
        if name not in self._files:
            return
        with self._load_lock:
            loaded = self._loaded.setdefault(name, set())
            todo = [f for f in self._covering_files(name, filt) if f not in loaded]
            if not todo:
                return
            ft = self.get_schema(name)
            # persisted sketches saw these rows when they were written
            observe = self.stats is None or not self.stats.has_persisted(name)
            was_loading = self._loading
            self._loading = True  # the replayed blocks are not written again
            try:
                with trace.span("fs.load", type=name, n_files=len(todo)):
                    for rel in todo:
                        loaded.add(rel)
                        path = os.path.join(self._type_dir(name), rel)
                        try:
                            cols = _read_block(path, ft)
                        except CorruptFileError:
                            # a torn or corrupt block moves aside and the
                            # rest of the store keeps serving (counted in
                            # robustness_metrics)
                            quarantine(path)
                            loaded.discard(rel)
                            self._files[name] = [f for f in self._files[name] if f != rel]
                            continue
                        if "__vis__" in cols and self.metadata.read(name, "geomesa.vis") != "true":
                            # a legacy store: visibility presence is learned
                            # during the replay
                            self.metadata.insert(name, "geomesa.vis", "true")
                        super()._insert_columns(ft, cols, observe_stats=observe)
                    # tombstones may cover rows of the blocks just loaded
                    fids = self._stored_tombstones(name)
                    if fids:
                        super().delete_features(name, fids)
            finally:
                self._loading = was_loading

    def _stored_tombstones(self, name: str) -> List[str]:
        out: List[str] = []
        # "tombstones.txt" is the pre-partitioning sidecar name: a store
        # written by older code must not resurrect its deletes
        for ts in (self._tombstone_file(name),
                   os.path.join(self._type_dir(name), "tombstones.txt")):
            if os.path.exists(ts):
                with open(ts) as fh:
                    data = fh.read()
                # only a NEWLINE-TERMINATED line is committed: a crash
                # mid-append leaves an unterminated tail, and honoring a
                # partial batch would half-apply the mutation. A line is
                # one delete BATCH (RS sentinel + a JSON array) or one
                # legacy fid.
                committed = data[: data.rfind("\n") + 1]
                for line in committed.split("\n"):
                    if not line:
                        continue
                    if line.startswith(_TOMBSTONE_BATCH):
                        try:
                            out.extend(json.loads(line[1:]))
                        except ValueError:
                            continue  # rot inside a committed line
                    else:
                        out.append(line)
        return out

    # -- the query surface (load before planning) --------------------------------

    def _prepare_query(self, name: str, query) -> None:
        # runs inside the query's (or the batch's) root span, so a lazy
        # load attributes to the query that forced it
        self._ensure_loaded(name, query.filter)

    def explain(self, name: str, query) -> str:
        q = self._as_query(query)
        self._ensure_loaded(name, q.filter)
        return super().explain(name, q)

    def count(self, name: str, query=None, exact: bool = True) -> int:
        if query is not None and exact:
            # counting through the filter touches only covering partitions
            self._ensure_loaded(name, self._as_query(query).filter)
            return super().count(name, query, exact)
        if (query is not None and not exact and self.stats is not None
                and self.stats.has_persisted(name)
                and self.metadata.read(name, "geomesa.vis") == "false"):
            # an estimate answers from the persisted sketches: loading every
            # block to then not read it would defeat lazy=True. A labelled
            # type (marked at write time) counts through the auth checks.
            est = self.stats.get_count(self.get_schema(name), self._as_query(query).filter)
            if est is not None:
                return int(est)
        self._ensure_loaded(name, None)
        return super().count(name, query, exact)

    # -- writes ------------------------------------------------------------------

    def create_schema(self, ft: FeatureType) -> None:
        if ft.name not in self._schemes and self._default_scheme is not None:
            # fail fast BEFORE the schema and its scheme are written
            self._default_scheme.validate(ft)
        super().create_schema(ft)
        if ft.name not in self._files:
            self._files[ft.name] = []
            self._loaded[ft.name] = set()
        if ft.name not in self._schemes:
            scheme = self._default_scheme
            self._schemes[ft.name] = scheme
            if scheme is not None and not self._loading:
                os.makedirs(self._type_dir(ft.name), exist_ok=True)
                save_scheme(self._scheme_file(ft.name), scheme, journal=self.journal)

    def _insert_columns(self, ft: FeatureType, columns: Columns, observe_stats: bool = True):
        super()._insert_columns(ft, columns, observe_stats)
        if self._loading:
            return
        # the durable marker: the count estimate must keep enforcing
        # visibility before any block of the type is loaded. No marker (a
        # legacy store) reads as "maybe": no shortcut.
        if "__vis__" in columns:
            if self.metadata.read(ft.name, "geomesa.vis") != "true":
                self.metadata.insert(ft.name, "geomesa.vis", "true")
        elif self.metadata.read(ft.name, "geomesa.vis") is None:
            self.metadata.insert(ft.name, "geomesa.vis", "false")
        self._write_partitioned(ft, columns)

    def _partition_groups(self, ft: FeatureType, columns: Columns):
        """One column batch split by partition: [(partition path, columns)]
        in path order, each group's rows in batch order (the reference's
        groups, found by one sort of integer partition codes instead of a
        string compare of every row a partition)."""
        scheme = self._schemes.get(ft.name)
        if scheme is None:
            return [("", columns)]
        labels, inv = scheme.partition_index(ft, columns)
        paths, remap = np.unique(np.asarray(labels, dtype=str), return_inverse=True)
        inv = remap[inv]
        order = np.argsort(inv, kind="stable")
        counts = np.bincount(inv, minlength=len(paths))
        groups = []
        for part, hi, n in zip(paths, np.cumsum(counts), counts):
            rows = order[hi - n:hi]
            groups.append((str(part), {k: v[rows] for k, v in columns.items()}))
        return groups

    def _reserve_block(self, name: str, partition: str, taken: Set[str]) -> str:
        """A fresh block relpath in a partition directory, never a name on
        disk or reserved earlier in the same mutation, so that a journaled
        publish always rolls back by unlink."""
        td = self._type_dir(name)
        d = os.path.join(td, partition) if partition else td
        os.makedirs(d, exist_ok=True)
        seq = len([f for f in os.listdir(d) if f.endswith(_EXTS) and not f.startswith(".")])
        while True:
            final = os.path.join(d, f"{seq:08d}.npz")
            rel = os.path.relpath(final, td)
            if rel not in taken and not os.path.exists(final):
                taken.add(rel)
                return rel
            seq += 1

    def _write_partitioned(self, ft: FeatureType, columns: Columns) -> None:
        """Persist one column batch, split by partition, as ONE journaled
        mutation: the intent, every block through fsync_replace, the
        commit. A crash mid-batch never leaves a subset of its partitions
        visible."""
        groups = self._partition_groups(ft, columns)
        td = self._type_dir(ft.name)
        taken: Set[str] = set()
        rels = [self._reserve_block(ft.name, part, taken) for part, _ in groups]
        with self.journal.intent("fs.write", publishes=[os.path.join(td, r) for r in rels]):
            for rel, (_part, sub) in zip(rels, groups):
                _write_block(os.path.join(td, rel), ft, sub)
        # bookkeeping only after the commit: a rolled-back batch leaves no
        # belief that its files exist
        for rel in rels:
            self._files[ft.name].append(rel)
            self._loaded[ft.name].add(rel)  # the batch is in memory already

    def delete_features(self, name: str, fids: Sequence[str]):
        """A delete appends ONE newline-terminated line (RS sentinel + the
        fids as a JSON array) to the durable tombstone sidecar: batch-atomic,
        since readers honor terminated lines only. Rewriting the blocks
        waits for ``compact``."""
        super().delete_features(name, fids)
        os.makedirs(self._type_dir(name), exist_ok=True)
        ts = self._tombstone_file(name)
        line = _TOMBSTONE_BATCH + json.dumps([str(f) for f in fids], separators=(",", ":")) + "\n"
        with self.journal.intent("fs.tombstones", replaces=[ts]):
            fresh = not os.path.exists(ts)
            with open(ts, "a") as fh:
                fh.write(line)
                fh.flush()
                if fsync_enabled():
                    os.fsync(fh.fileno())
            if fresh and fsync_enabled():
                fsync_dir(os.path.dirname(ts))

    def compact(self, name: str):
        self._ensure_loaded(name, None)
        super().compact(name)
        self._rewrite(name, drop_tombstones=True)

    def delete_schema(self, name: str) -> None:
        self.get_schema(name)  # an unknown type raises BEFORE any intent
        d = self._type_dir(name)
        targets: List[str] = []
        if os.path.isdir(d):
            for dirpath, _dirs, files in os.walk(d):
                targets.extend(os.path.join(dirpath, f) for f in files)
        # ONE intent covers the registry drop AND every data file: a crash
        # after the record rolls the whole deletion forward at the next open
        with self.journal.intent("fs.delete_schema", deletes=targets, drop_type=name,
                                 rmdirs=[d]):
            super().delete_schema(name)
        self._files.pop(name, None)
        self._loaded.pop(name, None)
        self._schemes.pop(name, None)

    def _rewrite(self, name: str, drop_tombstones: bool = False) -> None:
        """Persist the current state, re-partitioned, as ONE journaled
        mutation: the new blocks (fresh names) publish first, then the old
        blocks (and the consumed tombstone sidecars) go, then the commit. A
        crash mid-rewrite recovers to exactly the old or the new generation.
        Dictionary columns are decoded: values are the on-disk form."""
        ft = self.get_schema(name)
        table = next(iter(self._tables[name].values()))
        parts = []
        for b, rows in table.scan_all():
            src, rr = (b, rows) if b.record is None else (b.record, b.rowid[rows])
            parts.append(record_rows_decoded(src.columns, rr))
        td = self._type_dir(name)
        old_abs = [os.path.join(td, rel) for rel in self._files.get(name, [])]
        if drop_tombstones:
            old_abs.extend(
                ts for ts in (self._tombstone_file(name), os.path.join(td, "tombstones.txt"))
                if os.path.exists(ts))
        groups = self._partition_groups(ft, concat_columns(parts)) if parts else []
        taken: Set[str] = set()
        rels = [self._reserve_block(name, part, taken) for part, _ in groups]
        with self.journal.intent("fs.rewrite", publishes=[os.path.join(td, r) for r in rels],
                                 deletes=old_abs):
            for rel, (_part, sub) in zip(rels, groups):
                _write_block(os.path.join(td, rel), ft, sub)
        self._files[name] = sorted(rels)
        self._loaded[name] = set(rels)


# -- block codec -----------------------------------------------------------------

# the reference's geometry classes live in ``geomesa_tpu.geom``: an npz block
# pickles geometry objects under those names, whichever package wrote it
_REF_PKG = "geomesa_tpu"
_PORT_PKG = "geomesa_tpu_torch"


class _GeomPickler(pickle._Pickler):
    """Pickles the port's geometry classes under the reference's module
    names (``geomesa_tpu.geom.*``), as the reference's own blocks do; the
    pure-Python pickler, since only it lets a global's name be chosen."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", "") or ""
        if module.startswith(_PORT_PKG + ".geom."):
            qual = name or obj.__qualname__
            ref = _REF_PKG + module[len(_PORT_PKG):]
            self.write(pickle.GLOBAL + ref.encode() + b"\n" + qual.encode() + b"\n")
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _GeomUnpickler(pickle.Unpickler):
    """Reads the reference's geometry classes as the port's, and refuses
    every other class of the reference's package (the port never imports
    it)."""

    def find_class(self, module, name):
        if module.startswith(_REF_PKG + ".geom."):
            module = _PORT_PKG + module[len(_REF_PKG):]
        elif module == _REF_PKG or module.startswith(_REF_PKG + "."):
            raise pickle.UnpicklingError(f"a block refers to {module}.{name}")
        return super().find_class(module, name)


def _geom_attrs(ft: FeatureType) -> Set[str]:
    return {a.name for a in ft.attributes if a.type.is_geometry}


def _save_npz(path: str, ft: FeatureType, columns: Columns) -> None:
    """``np.savez``'s layout (one stored ``<key>.npy`` member a column), with
    the geometry object columns pickled by ``_GeomPickler`` (protocol 3,
    numpy's own)."""
    fmt = np.lib.format
    geoms = _geom_attrs(ft)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for k, v in columns.items():
            v = np.asanyarray(v)
            with zf.open(k + ".npy", "w", force_zip64=True) as fh:
                if v.dtype.hasobject and k in geoms:
                    fmt.write_array_header_1_0(fh, fmt.header_data_from_array_1_0(v))
                    _GeomPickler(fh, protocol=3).dump(v)
                else:
                    fmt.write_array(fh, v, allow_pickle=True)


def _load_npz(path: str) -> Columns:
    """Every column of an npz block; object columns unpickle through
    ``_GeomUnpickler``."""
    fmt = np.lib.format
    out: Columns = {}
    with np.load(path, allow_pickle=False) as data:
        keys = list(data.files)
        objs = []
        for k in keys:
            try:
                out[k] = data[k]
            except ValueError:  # an object column: pickled
                objs.append(k)
    if objs:
        with zipfile.ZipFile(path) as zf:
            for k in objs:
                with zf.open(k + ".npy") as fh:
                    version = fmt.read_magic(fh)
                    if version == (1, 0):
                        fmt.read_array_header_1_0(fh)
                    else:
                        fmt.read_array_header_2_0(fh)
                    out[k] = _GeomUnpickler(fh).load()
    return {k: out[k] for k in keys}


def _write_block(path: str, ft: FeatureType, columns: Columns) -> None:
    """Persist one block durably: tmp write + CRC footer + fsync + rename,
    a transient failure retrying the whole attempt; the span covers the
    retries."""
    with trace.span("fs.block_write", path=path):
        _BLOCK_WRITE_RETRY.call(_write_block_once, path, ft, columns)


def _write_block_once(path: str, ft: FeatureType, columns: Columns) -> None:
    deadline.check("fs.block_write")
    faults.fault_point("fs.block_write")
    tmp = os.path.join(os.path.dirname(path), "." + os.path.basename(path) + ".tmp")
    # cleanup is except-Exception, NOT finally: a failed attempt never leaks
    # its tmp, while a crash (a BaseException) leaves it for the scrub
    try:
        _save_npz(tmp, ft, columns)
        append_crc_footer(tmp)
        faults.maybe_tear("fs.block_write", tmp)
    except Exception:
        cleanup_tmp(tmp)
        raise
    fsync_replace(tmp, path)


def _read_block(path: str, ft: FeatureType) -> Columns:
    """One block's columns. A transient failure (OSError) retries;
    corruption (a CRC mismatch, undecodable content) raises
    CorruptFileError for the caller to quarantine."""
    with trace.span("fs.block_read", path=path):
        return _BLOCK_READ_RETRY.call(_read_block_once, path, ft)


def _read_block_once(path: str, ft: FeatureType) -> Columns:
    deadline.check("fs.block_read")
    faults.fault_point("fs.block_read")
    if path.endswith(".parquet"):
        raise NotImplementedError(
            f"{path}: parquet blocks are not ported (ROADMAP Queue 1 item 19)")
    # a streaming CRC pass, then the zip read straight off the file (the
    # zip reader tolerates the trailing footer)
    verify_file_crc(path)
    try:
        return _load_npz(path)
    except FileNotFoundError:
        raise
    except Exception as e:  # noqa: BLE001 - zip / pickle decode failures
        raise CorruptFileError(f"undecodable npz block {path}: {e}") from e
