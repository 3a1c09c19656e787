"""Columnar feature blocks: struct-of-arrays storage sorted by index key.

Port of ``geomesa_tpu/store/blocks.py``.

The TPU-native replacement for the reference's KV rows + Kryo values
(SURVEY.md section 7): each index keeps sealed immutable blocks whose columns
are numpy arrays row-aligned with sorted key columns. Binned indices (z3/xz3)
record per-bin row slices so a scan touches only matching bins; every block
carries key min/max for whole-block pruning. Blocks are the unit shipped to
device memory by the scan executor (geomesa_tpu_torch.parallel).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from geomesa_tpu_torch.index.keyspace import IndexKeySpace, ScanRange
from geomesa_tpu_torch.schema.feature import Feature
from geomesa_tpu_torch.schema.featuretype import AttributeType, FeatureType

Columns = Dict[str, np.ndarray]


def num_rows(columns: Columns) -> int:
    """Row count of a column dict, skipping dictionary vocab arrays
    (``*__vocab`` — per-batch sorted vocabs, NOT row-aligned)."""
    for k, v in columns.items():
        if not k.endswith("__vocab"):
            return len(v)
    return 0


def columns_from_features(ft: FeatureType, features: Sequence[Feature]) -> Columns:
    """Row features -> columnar arrays per the evaluate.py conventions."""
    n = len(features)
    out: Columns = {}
    # dtype inferred: all-str fids become fixed-width unicode directly
    # (U-array gathers are memcpy; see intern_fids), mixed/None stay object
    fid_list = [f.fid for f in features]
    out["__fid__"] = np.array(fid_list) if n and all(
        type(v) is str for v in fid_list
    ) else np.array(fid_list, dtype=object)
    vis = [
        (f.user_data or {}).get("visibility") if f.user_data is not None else None
        for f in features
    ]
    if any(v for v in vis):
        out["__vis__"] = np.array(vis, dtype=object)
    for idx, attr in enumerate(ft.attributes):
        vals = [f.values[idx] for f in features]
        if attr.type == AttributeType.POINT:
            x = np.full(n, np.nan)
            y = np.full(n, np.nan)
            for i, v in enumerate(vals):
                if v is not None:
                    x[i] = v.x
                    y[i] = v.y
            out[attr.name + "__x"] = x
            out[attr.name + "__y"] = y
        elif attr.type.is_geometry:
            out[attr.name] = np.array(vals, dtype=object)
        else:
            dtype = attr.type.numpy_dtype
            if dtype is None:
                out[attr.name] = np.array(vals, dtype=object)
            else:
                col = np.zeros(n, dtype=dtype)
                nulls = np.zeros(n, dtype=bool)
                for i, v in enumerate(vals):
                    if v is None:
                        nulls[i] = True
                    else:
                        col[i] = v
                out[attr.name] = col
                if nulls.any():
                    out[attr.name + "__null"] = nulls
    return out


def take_rows(columns: Columns, rows: np.ndarray) -> Columns:
    return {k: v[rows] for k, v in columns.items()}


def record_rows_decoded(columns: Columns, rows: np.ndarray) -> Columns:
    """``take_rows`` with dictionary columns DECODED to values (null -> ""
    plus the ``__null`` mask) and vocabs dropped: vocabs are not
    row-aligned and codes of different batches are not comparable, so
    compaction merges through values and re-interns afterwards."""
    out = {}
    for k, v in columns.items():
        if k.endswith("__vocab"):
            continue
        vocab = columns.get(k + "__vocab")
        out[k] = dict_decode(v[rows], vocab) if vocab is not None else v[rows]
    return out


def concat_columns(parts: Sequence[Columns]) -> Columns:
    """Row-concatenate column dicts. A part without a ``__null`` companion
    has no nulls, and one without ``__vis__`` no visibility labels."""
    if not parts:
        return {}
    if len(parts) == 1:
        return dict(parts[0])
    keys = set()
    for p in parts:
        keys.update(p.keys())
    n_parts = [num_rows(p) for p in parts]
    out: Columns = {}
    for k in keys:
        arrs = []
        for p, n in zip(parts, n_parts):
            if k in p:
                arrs.append(p[k])
            elif k.endswith("__null"):
                arrs.append(np.zeros(n, dtype=bool))
            elif k == "__vis__":
                arrs.append(np.full(n, None, dtype=object))
            else:
                raise KeyError(f"Column {k} missing from a part")
        out[k] = np.concatenate(arrs)
    return out


def intern_fids(columns: Columns) -> Columns:
    """Convert an object-dtype ``__fid__`` column to fixed-width unicode
    when every entry is a str: fancy-indexing a U-array is a memcpy, ~6x
    faster than object-pointer gather + refcounting (the fid gather is the
    hottest host op on the query path). Idempotent — call once per write
    batch so per-index table builds don't re-scan the column.

    The all-str scan is a short-circuiting Python pass; astype would
    silently coerce non-strings, so it cannot replace the check."""
    fid = columns.get("__fid__")
    if (
        fid is not None
        and fid.dtype == object
        and len(fid)
        and all(type(v) is str for v in fid)
    ):
        columns = dict(columns)
        columns["__fid__"] = fid.astype(np.str_)
    return columns


def intern_string_columns(ft: FeatureType, columns: Columns) -> Columns:
    """Encode STRING attribute columns for columnar storage. Idempotent;
    call once per write batch alongside intern_fids.

    Low-cardinality columns DICTIONARY-ENCODE: ``name`` becomes int32
    codes into a per-batch SORTED vocab stored as ``name__vocab`` (code
    order == value order, so range scans and sorts work in code space);
    null -> code -1 plus the usual ``__null`` mask. Equality/range/LIKE
    predicates then compare 4-byte ints instead of 4B-per-CHAR fixed-width
    text — the reference makes the same move on the wire with
    ArrowDictionary (geomesa-arrow-gt .../vector/SimpleFeatureVector.scala
    dictionary handling); here it is the at-rest layout.

    High-cardinality columns fall back to fixed-width unicode + ``__null``
    (C-speed compares, no vocab win); columns with a >128-char outlier or
    non-str values stay object."""
    out = None
    for a in ft.attributes:
        if a.type != AttributeType.STRING:
            continue
        col = columns.get(a.name)
        if col is None or not len(col):
            continue
        if a.name + "__vocab" in columns:
            continue  # already encoded (idempotence)
        n = len(col)
        if col.dtype.kind == "U":
            # pre-interned input (bulk ingest fast path / fs replay)
            nulls = columns.get(a.name + "__null")
            nulls = (
                nulls.copy() if nulls is not None else np.zeros(n, dtype=bool)
            )
            clean = col
        elif col.dtype == object:
            ok = True
            maxlen = 0
            for v in col:
                if v is None:
                    continue
                if type(v) is not str:
                    ok = False
                    break
                if len(v) > maxlen:
                    maxlen = len(v)
            # width cap: one long outlier would multiply a fixed-width
            # column's memory (and a dict vocab still pays it per distinct
            # value) — leave such columns object
            if not ok or maxlen > 128:
                continue
            nulls = np.array([v is None for v in col], dtype=bool)
            clean = np.where(nulls, "", col).astype(np.str_)
        else:
            continue
        if out is None:
            out = dict(columns)
        # cardinality probe on a strided sample first: np.unique is a full
        # lexicographic sort, wasted on per-row-unique columns (UUIDs,
        # notes) that will take the plain-U fallback anyway
        high_card = False
        if n > 8192:
            probe = clean[:: max(1, n // 2048)][:2048]
            pu = len(np.unique(probe))
            high_card = pu > 256 and 2 * pu > len(probe)
        if high_card:
            out[a.name] = clean
        else:
            vocab, codes = np.unique(clean, return_inverse=True)
            if len(vocab) <= 256 or 2 * len(vocab) <= n:
                codes = codes.astype(np.int32)
                codes[nulls] = -1
                out[a.name] = codes
                out[a.name + "__vocab"] = vocab
            else:
                out[a.name] = clean
        if nulls.any():
            out[a.name + "__null"] = nulls
    return out if out is not None else columns


def dict_decode(codes: np.ndarray, vocab: np.ndarray) -> np.ndarray:
    """Row-subset decode helper (codes may include -1 nulls -> "")."""
    vals = vocab[np.maximum(codes, 0)]
    neg = codes < 0
    if neg.any():
        vals = vals.copy()
        vals[neg] = ""
    return vals


def expand_intervals(
    starts: np.ndarray, ends: np.ndarray, flags: Optional[np.ndarray] = None
) -> np.ndarray:
    """[start, end) row intervals -> sorted deduped row indices.

    Disjoint sorted intervals (the common case: merged z-ranges seeked into
    a sorted key column) expand with vectorized run arithmetic; anything
    overlapping falls back to a unique pass.

    With per-interval ``flags`` (range ``contained`` markers) returns
    (rows, covered) where ``covered`` is the per-row expansion of the
    flags; the overlap fallback drops flags to all-False (safe: covered
    rows merely skip a post-filter they would pass)."""
    if not len(starts):
        rows = np.empty(0, dtype=np.int64)
        return rows if flags is None else (rows, np.empty(0, dtype=bool))
    lens = ends - starts
    keep = lens > 0
    if not keep.all():
        starts, ends, lens = starts[keep], ends[keep], lens[keep]
        if flags is not None:
            flags = flags[keep]
        if not len(starts):
            rows = np.empty(0, dtype=np.int64)
            return rows if flags is None else (rows, np.empty(0, dtype=bool))
    order = np.argsort(starts, kind="stable")
    starts, ends, lens = starts[order], ends[order], lens[order]
    out_starts = np.repeat(starts, lens)
    base = np.concatenate(([0], np.cumsum(lens[:-1])))
    rows = out_starts + (np.arange(len(out_starts), dtype=np.int64) - np.repeat(base, lens))
    if len(starts) > 1 and (ends[:-1] > starts[1:]).any():
        rows = np.unique(rows)  # overlapping intervals: dedup
        return rows if flags is None else (rows, np.zeros(len(rows), dtype=bool))
    if flags is None:
        return rows
    covered = np.repeat(flags[order].astype(bool), lens)
    return rows, covered


class RecordBlock:
    """Full feature columns for ONE write batch, in ingest order.

    The record-table analog (reference stores the full serialized feature
    once in the record/id table and joins from reduced index tables,
    geomesa-accumulo .../index/AttributeIndex.scala:42,392 JoinPlan;
    index/BaseFeatureIndex.scala:49-56): every index's FeatureBlock holds
    only its key + scan-hot columns plus a ``rowid`` array into this block,
    so attributes and fids are stored once per batch instead of once per
    index table."""

    __slots__ = ("columns", "n", "_nulls_memo", "_spilled", "__weakref__")

    def __init__(self, columns: Columns):
        self.columns = columns
        self.n = num_rows(columns)
        self._nulls_memo: Dict[str, bool] = {}
        self._spilled = False

    def has_nulls(self, name: str) -> bool:
        got = self._nulls_memo.get(name)
        if got is None:
            col = self.columns.get(name + "__null")
            got = bool(col.any()) if col is not None else False
            self._nulls_memo[name] = got
        return got

    def spill(self) -> None:
        """Cold-column spill (``geomesa.spill.dir``, the reference's
        ``RecordBlock.spill``): non-object columns of at least
        ``geomesa.spill.min.bytes`` are written as .npy files (fsynced, then
        dropped from the page cache) and reopened memory-mapped, so a wide
        schema's record columns become reclaimable page cache instead of
        heap. Reads (``gather`` through the rowid join) are unchanged: an
        ``np.memmap`` is an ndarray. The files go when the block is
        collected; a dead process's files are swept at a directory's first
        use. Called AFTER the batch's index tables and sketches read the
        columns (spilling first would write, evict and fault them back).
        Idempotent; off when the knob is unset."""
        from geomesa_tpu_torch.utils.config import SPILL_DIR, SPILL_MIN_BYTES

        d = SPILL_DIR.get()
        if not d or not self.n or self._spilled:
            return
        self._spilled = True
        import os
        import re
        import uuid
        import weakref

        os.makedirs(d, exist_ok=True)
        _sweep_stale_spill_files(d)
        min_bytes = SPILL_MIN_BYTES.to_bytes() or 0
        paths = []
        cols = dict(self.columns)
        tag = uuid.uuid4().hex[:12]
        for i, (k, v) in enumerate(cols.items()):
            if (not isinstance(v, np.ndarray) or v.dtype == object or v.nbytes < min_bytes
                    or isinstance(v, np.memmap)):
                continue
            # the index keeps sanitized names collision-proof
            safe = re.sub(r"[^A-Za-z0-9_.-]", "_", k)
            path = os.path.join(d, f"rb-{os.getpid()}-{tag}-{i}-{safe}.npy")
            np.save(path, v)
            # fsync BEFORE dropping: DONTNEED skips dirty pages
            try:
                fd = os.open(path, os.O_RDONLY)
                try:
                    os.fsync(fd)
                    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                finally:
                    os.close(fd)
            except (AttributeError, OSError):  # pragma: no cover
                pass
            cols[k] = np.load(path, mmap_mode="r")
            paths.append(path)
        if paths:
            self.columns = cols
            weakref.finalize(self, _remove_spill_files, paths)


def _remove_spill_files(paths: Sequence[str]) -> None:
    import os

    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


_SWEPT_SPILL_DIRS: set = set()


def _sweep_stale_spill_files(d: str) -> None:
    """Unlink the ``rb-<pid>-*`` files of dead processes (a crash never runs
    the finalizers); once a directory a process."""
    import os
    import re

    if d in _SWEPT_SPILL_DIRS:
        return
    _SWEPT_SPILL_DIRS.add(d)
    pat = re.compile(r"^rb-(\d+)-")
    try:
        names = os.listdir(d)
    except OSError:
        return
    for name in names:
        m = pat.match(name)
        if m is None:
            continue
        pid = int(m.group(1))
        if pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            try:
                os.unlink(os.path.join(d, name))
            except OSError:
                pass
        except OSError:
            pass  # alive but not ours (EPERM): leave it


# scan-hot columns each index family keeps physically sorted in its own
# blocks (everything else rides in the shared RecordBlock): the native
# seek-scan kernels (native/seekscan.cpp) and the device mirrors read these
# sequentially over candidate intervals, so they must stay contiguous in
# key order. ``{geom}``/``{dtg}`` are substituted per feature type.
_HOT_COLUMNS = {
    "z2": ("{geom}__x", "{geom}__y"),
    "z3": ("{geom}__x", "{geom}__y", "{dtg}", "{dtg}__null"),
    "xz2": (),  # envelope companions come from key_columns extras
    "xz3": ("{dtg}", "{dtg}__null"),
    "id": (),
    "attr": (),
}


def _hot_names(index: IndexKeySpace, ft: FeatureType) -> Tuple[str, ...]:
    fam = "attr" if index.name.startswith("attr") else index.name
    pats = _HOT_COLUMNS.get(fam, ())
    geom = ft.default_geometry.name if ft.default_geometry is not None else ""
    dtg = ft.default_date.name if ft.default_date is not None else ""
    names = (p.format(geom=geom, dtg=dtg) for p in pats)
    # an unbound role substitutes to "" / "__null": drop those
    return tuple(n for n in names if n and not n.startswith("__"))


class ColumnBuffer:
    """Mutable ingest buffer; seals into a FeatureBlock."""

    def __init__(self, ft: FeatureType):
        self.ft = ft
        self.features: List[Feature] = []

    def append(self, feature: Feature):
        self.features.append(feature)

    def __len__(self):
        return len(self.features)

    def to_columns(self) -> Columns:
        return columns_from_features(self.ft, self.features)

    def clear(self):
        self.features = []


class FeatureBlock:
    """One sealed, key-sorted block of features for one index.

    ``columns`` holds only this index's OWN (scan-hot) columns, physically
    sorted in key order; everything else lives once in the shared
    ``record`` block, addressed through the key-sorted ``rowid`` array
    (the reference's record-table/join-index layout,
    index/BaseFeatureIndex.scala:49-56, AttributeIndex.scala:42,392).
    ``gather`` is the one accessor scan paths use — it hits own columns
    zero-copy and falls through to a rowid gather otherwise."""

    def __init__(
        self,
        index: IndexKeySpace,
        columns: Columns,
        key: np.ndarray,
        bins: Optional[np.ndarray],
        tiebreak: Optional[np.ndarray] = None,
        record: Optional[RecordBlock] = None,
        rowid: Optional[np.ndarray] = None,
        key_vocab: Optional[np.ndarray] = None,
    ):
        self.index = index
        self.columns = columns
        self.key = key
        self.bins = bins
        # secondary z2 sort within equal keys (attribute index only)
        self.tiebreak = tiebreak
        self.record = record
        self.rowid = rowid
        # dictionary-encoded attr key: sorted value vocab for this block's
        # int32 code keys (scan ranges map value bounds -> code bounds)
        self.key_vocab = key_vocab
        self.n = len(key)
        # per-bin row slices (contiguous after the sort)
        self.bin_slices: Dict[int, Tuple[int, int]] = {}
        if bins is not None:
            uniq, starts = np.unique(bins, return_index=True)
            bounds = list(starts) + [self.n]
            for b, s, e in zip(uniq, bounds[:-1], bounds[1:]):
                self.bin_slices[int(b)] = (int(s), int(e))
        self.key_min = key[0] if self.n else None
        self.key_max = key[-1] if self.n else None
        self._nulls_memo: Dict[str, bool] = {}

    def has_nulls(self, name: str) -> bool:
        """Whether the attribute's __null mask has any set bit; memoized —
        blocks are immutable once sealed, so hot query paths (the native
        seek-scan eligibility check) pay the O(n) scan once per block."""
        got = self._nulls_memo.get(name)
        if got is None:
            col = self.columns.get(name + "__null")
            if col is not None:
                got = bool(col.any())
            elif self.record is not None:
                # rows here are a subset of the record's (valid filter), so
                # the record's memoized answer is a safe over-approximation
                got = self.record.has_nulls(name)
            else:
                got = False
            self._nulls_memo[name] = got
        return got

    def has_col(self, k: str) -> bool:
        return k in self.columns or (
            self.record is not None and k in self.record.columns
        )

    def all_keys(self) -> set:
        keys = set(self.columns)
        if self.record is not None:
            keys.update(self.record.columns)
        return keys

    def gather(
        self,
        k: str,
        rows: np.ndarray,
        record_rows: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Column values at block-local ``rows``: own columns directly,
        record columns through the rowid mapping; a missing ``__null``
        companion means "no nulls" and materializes as zeros.

        Callers reading SEVERAL record-backed columns for the same rows
        should pass ``record_rows=self.rowid[rows]`` (computed once) —
        this is the single column-resolution rule; don't reimplement the
        own -> record -> __null fallthrough elsewhere."""
        col = self.columns.get(k)
        if col is not None:
            return col[rows]
        if self.record is not None:
            col = self.record.columns.get(k)
            if col is not None:
                if record_rows is None:
                    record_rows = self.rowid[rows]
                return col[record_rows]
        if k.endswith("__null"):
            return np.zeros(len(rows), dtype=bool)
        raise KeyError(k)

    def full_col(self, k: str) -> np.ndarray:
        """Whole column in this block's key order (own zero-copy, record
        via one full gather — used by device mirror packing)."""
        col = self.columns.get(k)
        if col is not None:
            return col
        if self.record is not None:
            col = self.record.columns.get(k)
            if col is not None:
                return col[self.rowid]
        if k.endswith("__null"):
            return np.zeros(self.n, dtype=bool)
        raise KeyError(k)

    @classmethod
    def build(
        cls,
        index: IndexKeySpace,
        ft: FeatureType,
        columns: Union[Columns, RecordBlock],
        interned: bool = False,
    ) -> "FeatureBlock":
        local_record = not isinstance(columns, RecordBlock)
        if not local_record:
            record = columns
        else:
            if not interned:  # batch-level ingest interns once for all tables
                columns = intern_string_columns(ft, intern_fids(columns))
            record = RecordBlock(columns)
        key_cols = index.key_columns(ft, record.columns)
        key = key_cols["__key__"]
        bins = key_cols.get("__bin__")
        valid = key_cols.get("__valid__")
        tiebreak = key_cols.get("__tiebreak__")
        key_vocab = key_cols.get("__key_vocab__")
        own: Columns = {
            k: v
            for k, v in key_cols.items()
            if k not in ("__key__", "__bin__", "__valid__", "__tiebreak__", "__key_vocab__")
        }
        for name in _hot_names(index, ft):
            col = record.columns.get(name)
            if col is not None and name not in own:
                own[name] = col
        rowid = np.arange(record.n, dtype=np.int64)
        if valid is not None and not valid.all():
            rows = np.where(valid)[0]
            own = take_rows(own, rows)
            key = key[rows]
            rowid = rowid[rows]
            if bins is not None:
                bins = bins[rows]
            if tiebreak is not None:
                tiebreak = tiebreak[rows]
        if bins is not None:
            order = np.lexsort((key, bins))
            bins = bins[order]
            if tiebreak is not None:  # row-aligned, though no binned index
                tiebreak = tiebreak[order]  # emits one today
        elif tiebreak is not None:
            order = np.lexsort((tiebreak, key))
            tiebreak = tiebreak[order]
        else:
            order = np.argsort(key, kind="stable")
        key = key[order]
        sorted_cols = take_rows(own, order)
        return cls(index, sorted_cols, key, bins, tiebreak, record, rowid[order], key_vocab)

    def scan(self, ranges: Sequence[ScanRange]) -> np.ndarray:
        """Row indices whose keys fall in any range (sorted, deduped)."""
        starts, ends, _ = self.scan_intervals(ranges)
        return expand_intervals(starts, ends)

    def scan_intervals(
        self, ranges: Sequence[ScanRange]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Row-interval form of ``scan``: (starts, ends[, ), flags) arrays.
        The cheap seek product — callers that only need counts (the
        executor's host-seek cost probe) avoid materializing rows."""
        if self.n == 0 or not len(ranges):
            z = np.empty(0, dtype=np.int64)
            return z, z, np.empty(0, dtype=bool)
        from geomesa_tpu_torch.index.keyspace import RangeSet

        if isinstance(ranges, RangeSet) and self.key.dtype != object and self.tiebreak is None:
            return self._scan_intervals_arrays(ranges)
        pieces: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        if self.bins is not None:
            by_bin: Dict[int, List[ScanRange]] = {}
            for r in ranges:
                by_bin.setdefault(r.bin, []).append(r)
            for b in sorted(by_bin):
                if b not in self.bin_slices:
                    continue
                s, e = self.bin_slices[b]
                pieces.append(self._slice_intervals(s, e, by_bin[b]))
        else:
            pieces.append(self._slice_intervals(0, self.n, ranges))
        if not pieces:
            z = np.empty(0, dtype=np.int64)
            return z, z, np.empty(0, dtype=bool)
        starts = np.concatenate([p[0] for p in pieces])
        ends = np.concatenate([p[1] for p in pieces])
        flags = np.concatenate([p[2] for p in pieces])
        return starts, ends, flags

    def _scan_intervals_arrays(
        self, rs
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """RangeSet fast path: searchsorted straight off the backing arrays
        (closed-inclusive numeric ranges; no per-range tuples touched)."""
        key = self.key
        lo = rs.lower.astype(key.dtype, copy=False)
        hi = rs.upper.astype(key.dtype, copy=False)
        if self.bins is None:
            starts = np.searchsorted(key, lo, side="left").astype(np.int64)
            ends = np.searchsorted(key, hi, side="right").astype(np.int64)
            return starts, ends, rs.contained
        outs, oute, outf = [], [], []
        for b in np.unique(rs.bins):
            sl = self.bin_slices.get(int(b))
            if sl is None:
                continue
            s, e = sl
            sub = key[s:e]
            m = rs.bins == b
            outs.append(np.searchsorted(sub, lo[m], side="left").astype(np.int64) + s)
            oute.append(np.searchsorted(sub, hi[m], side="right").astype(np.int64) + s)
            outf.append(rs.contained[m])
        if not outs:
            z = np.empty(0, dtype=np.int64)
            return z, z, np.empty(0, dtype=bool)
        return np.concatenate(outs), np.concatenate(oute), np.concatenate(outf)

    def _to_code_ranges(self, ranges: Sequence[ScanRange]) -> List[ScanRange]:
        """VALUE-space scan ranges -> this block's CODE space (inclusive
        int bounds). The vocab is sorted, so order-preserving: a value
        bound maps by binary search; exclusive bounds shift by choosing
        the searchsorted side. ``contained`` flags carry over — codes
        represent exact values."""
        vocab = self.key_vocab
        out = []
        for r in ranges:
            if r.lower is None:
                lo = 0
            else:
                side = "left" if r.lower_inclusive else "right"
                lo = int(np.searchsorted(vocab, r.lower, side=side))
            if r.upper is None:
                hi = len(vocab) - 1
            else:
                side = "right" if r.upper_inclusive else "left"
                hi = int(np.searchsorted(vocab, r.upper, side=side)) - 1
            if hi < lo:
                continue
            out.append(
                ScanRange(r.bin, lo, hi, r.contained, True, True, r.tiebreak_ranges)
            )
        return out

    def _slice_intervals(
        self, s: int, e: int, ranges: Sequence[ScanRange]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        sub = self.key[s:e]
        if self.key_vocab is not None:
            ranges = self._to_code_ranges(ranges)
            if not ranges:
                z = np.empty(0, dtype=np.int64)
                return z, z, np.empty(0, dtype=bool)
        elif sub.dtype.kind == "S":
            # bytes keys (the id index, ASCII): encode str bounds the
            # same way — byte value == code point, so order is unchanged.
            # A non-ASCII bound cannot exist in an ASCII block: drop it.
            try:
                # one C pass over all bounds (the common all-str case)
                lo_b = np.asarray([r.lower for r in ranges]).astype("S")
                hi_b = np.asarray([r.upper for r in ranges]).astype("S")
                ranges = [
                    r._replace(lower=lo, upper=hi)
                    for r, lo, hi in zip(ranges, lo_b, hi_b)
                ]
            except (UnicodeEncodeError, TypeError):
                mapped = []
                for r in ranges:
                    try:
                        lo = (
                            r.lower.encode("ascii")
                            if isinstance(r.lower, str)
                            else r.lower
                        )
                        hi = (
                            r.upper.encode("ascii")
                            if isinstance(r.upper, str)
                            else r.upper
                        )
                    except UnicodeEncodeError:
                        continue
                    mapped.append(r._replace(lower=lo, upper=hi))
                ranges = mapped
        numeric = sub.dtype != object
        if self.tiebreak is not None and any(r.tiebreak_ranges for r in ranges):
            # attribute scans with a z2 tiebreak: within each equality span
            # rows are z-sorted, so spatial predicates reduce to z sub-spans
            # (the tiered-range scan of the reference's AttributeIndex).
            # Tiebreak sub-spans are spatial over-approximations, so their
            # covered flag is always False.
            outs, oute, outf = [], [], []
            for r in ranges:
                side = "left" if r.lower is None or r.lower_inclusive else "right"
                st = s if r.lower is None else int(np.searchsorted(sub, r.lower, side=side)) + s
                side = "right" if r.upper is None or r.upper_inclusive else "left"
                en = e if r.upper is None else int(np.searchsorted(sub, r.upper, side=side)) + s
                if en <= st:
                    continue
                if not r.tiebreak_ranges:
                    outs.append(st)
                    oute.append(en)
                    outf.append(r.contained)
                    continue
                tb = self.tiebreak[st:en]
                for zlo, zhi in r.tiebreak_ranges:
                    s2 = int(np.searchsorted(tb, zlo, side="left"))
                    e2 = int(np.searchsorted(tb, zhi, side="right"))
                    if e2 > s2:
                        outs.append(st + s2)
                        oute.append(st + e2)
                        outf.append(False)
            return (
                np.asarray(outs, dtype=np.int64),
                np.asarray(oute, dtype=np.int64),
                np.asarray(outf, dtype=bool),
            )
        if numeric and all(
            r.lower is not None
            and r.upper is not None
            and r.lower_inclusive
            and r.upper_inclusive
            for r in ranges
        ):
            if sub.dtype.kind in "US":
                # natural promotion: forcing dtype=sub.dtype would TRUNCATE
                # literals longer than the block's fixed string width and
                # match the truncated prefix (wrong rows, and contained
                # equality ranges skip the post-filter)
                los = np.asarray([r.lower for r in ranges])
                his = np.asarray([r.upper for r in ranges])
            else:
                los = np.asarray([r.lower for r in ranges], dtype=sub.dtype)
                his = np.asarray([r.upper for r in ranges], dtype=sub.dtype)
            starts = np.searchsorted(sub, los, side="left").astype(np.int64) + s
            ends = np.searchsorted(sub, his, side="right").astype(np.int64) + s
            flags = np.asarray([r.contained for r in ranges], dtype=bool)
            return starts, ends, flags
        outs, oute, outf = [], [], []
        for r in ranges:
            if r.lower is None:
                st = s
            else:
                side = "left" if r.lower_inclusive else "right"
                st = int(np.searchsorted(sub, r.lower, side=side)) + s
            if r.upper is None:
                en = e
            else:
                side = "right" if r.upper_inclusive else "left"
                en = int(np.searchsorted(sub, r.upper, side=side)) + s
            if en > st:
                outs.append(st)
                oute.append(en)
                outf.append(r.contained)
        return (
            np.asarray(outs, dtype=np.int64),
            np.asarray(oute, dtype=np.int64),
            np.asarray(outf, dtype=bool),
        )


def _unicode_hash(a: np.ndarray) -> np.ndarray:
    """A 64-bit polynomial hash of each fixed-width unicode string (its
    code points, trailing zeros included), vectorized over the array."""
    width = a.dtype.itemsize // 4
    cps = np.ascontiguousarray(a).view(np.uint32).reshape(len(a), width)
    h = np.zeros(len(a), dtype=np.uint64)
    mult = np.uint64(0x100000001B3)
    for j in range(width):
        h = (h * mult) ^ cps[:, j].astype(np.uint64)
    return h


class _UnicodeProbe:
    """A fixed-width unicode probe set, hashed and sorted once at each
    width it is asked at, for ``isin`` over many value arrays."""

    __slots__ = ("probe", "_at")

    def __init__(self, probe: np.ndarray):
        self.probe = probe
        self._at: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _sorted(self, dtype) -> Tuple[np.ndarray, np.ndarray]:
        width = dtype.itemsize // 4
        got = self._at.get(width)
        if got is None:
            # a probe longer than the column's width matches no value
            # (astype would truncate it into a false match)
            probe = self.probe[np.char.str_len(self.probe) <= width].astype(dtype)
            ph = _unicode_hash(probe)
            order = np.argsort(ph, kind="stable")
            got = self._at[width] = (ph[order], probe[order])
        return got

    def isin(self, values: np.ndarray) -> np.ndarray:
        """``np.isin(values, probe)`` without sorting ``values``: a binary
        search of the sorted probe hashes finds each value's candidate, an
        elementwise string compare settles it, and the few values whose
        hash matched another string (a collision) take ``np.isin``."""
        out = np.zeros(len(values), dtype=bool)
        ph, probe = self._sorted(values.dtype)
        if not len(ph) or not len(values):
            return out
        vh = _unicode_hash(values)
        pos = np.minimum(np.searchsorted(ph, vh), len(ph) - 1)
        cand = np.flatnonzero(ph[pos] == vh)
        if len(cand):
            same = values[cand] == probe[pos[cand]]
            out[cand[same]] = True
            rest = cand[~same]
            if len(rest):
                out[rest] = np.isin(values[rest], probe)
        return out


class IndexTable:
    """All sealed blocks for one index of one feature type.

    The analog of a reference index table: writes land in sealed sorted
    blocks (one per flush); scans prune by bin slice + key stats and
    searchsorted into each block. Deletes are fid tombstones applied at
    scan time (``tombstone_keep``, the one filter every host scan goes
    through); ``compact`` folds them in.
    """

    def __init__(self, index: IndexKeySpace, ft: FeatureType):
        self.index = index
        self.ft = ft
        self.blocks: List[FeatureBlock] = []
        self.tombstones: set = set()
        self._forget_tombstones()
        # bumped on every mutation; device-resident mirrors key off this
        self.version = 0

    def _forget_tombstones(self) -> None:
        """Drop what was derived from the tombstones: their array for
        np.isin and hashed probe, and the keep masks of ``source_keep``
        (new dicts, so that a scan that read the old tombstones stores
        its mask into the old one)."""
        self._tomb_arr: Optional[np.ndarray] = None
        self._tomb_probe: Optional[_UnicodeProbe] = None
        # id(fid source) -> (source, keep mask over all its rows)
        self._keep_masks: Dict[int, tuple] = {}
        # id(fid source) -> rows filtered one by one since the last delete
        self._keep_probed: Dict[int, int] = {}

    @property
    def num_rows(self) -> int:
        return sum(b.n for b in self.blocks)

    def insert(self, columns: Columns, interned: bool = False):
        if not columns or num_rows(columns) == 0:
            return
        if not interned:
            columns = intern_string_columns(self.ft, intern_fids(columns))
        self.insert_record(RecordBlock(columns))

    def insert_record(self, record: RecordBlock):
        """Seal one key-sorted block referencing a (possibly shared)
        record block — the datastore passes ONE RecordBlock per write
        batch to every index table."""
        if record.n == 0:
            return
        self.blocks.append(FeatureBlock.build(self.index, self.ft, record))
        self.version += 1

    def delete(self, fids: Sequence[str]):
        self.tombstones.update(fids)
        self._forget_tombstones()
        self.version += 1

    def tombstone_array(self) -> np.ndarray:
        """The tombstoned fids as one array (``np.isin``'s right side)."""
        arr = self._tomb_arr
        if arr is None:
            arr = self._tomb_arr = np.asarray(list(self.tombstones))
        return arr

    def fid_keep(self, fids: np.ndarray) -> np.ndarray:
        """Bool mask over ``fids``: True where the fid is not tombstoned
        (``np.isin`` semantics; fixed-width unicode fids go by hash first,
        see ``_UnicodeProbe``)."""
        if not self.tombstones:
            return np.ones(len(fids), dtype=bool)
        tomb = self.tombstone_array()
        if fids.dtype.kind == "U" and tomb.dtype.kind == "U":
            if self._tomb_probe is None:
                self._tomb_probe = _UnicodeProbe(tomb)
            return ~self._tomb_probe.isin(fids)
        return ~np.isin(fids, tomb)

    def source_keep(self, src: Union[RecordBlock, FeatureBlock]) -> np.ndarray:
        """``fid_keep`` over every row of ``src`` (a record block, or a
        feature block that holds its own ``__fid__``), kept until the next
        delete: the device mirror's tombstone sync and the scans after it
        share one pass over the fids."""
        masks = self._keep_masks
        got = masks.get(id(src))
        if got is None or got[0] is not src:
            got = masks[id(src)] = (src, self.fid_keep(src.columns["__fid__"]))
        return got[1]

    def scan(self, ranges: Sequence[ScanRange]) -> Iterator[Tuple[FeatureBlock, np.ndarray]]:
        for b in self.blocks:
            rows = self._strip_tombstones(b, b.scan(ranges))
            if len(rows):
                yield b, rows

    def scan_covered(
        self, ranges: Sequence[ScanRange]
    ) -> Iterator[Tuple[FeatureBlock, np.ndarray, np.ndarray]]:
        """Like ``scan`` but yields (block, rows, covered): ``covered`` rows
        came from ``contained`` ranges and satisfy the plan's primary
        predicate (no post-filter needed for them)."""
        for b in self.blocks:
            starts, ends, flags = b.scan_intervals(ranges)
            rows, covered = self.expand_covered(b, starts, ends, flags)
            if len(rows):
                yield b, rows, covered

    def expand_covered(
        self, block: FeatureBlock, starts, ends, flags
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, covered) from seek intervals, tombstones stripped: the
        expansion step of ``scan_covered`` and of the executor's host seek
        (which reuses its cost probe's intervals)."""
        rows, covered = expand_intervals(starts, ends, flags)
        keep = self.tombstone_keep(block, rows)
        if keep is not None:
            rows = rows[keep]
            covered = covered[keep]
        return rows, covered

    def scan_all(self) -> Iterator[Tuple[FeatureBlock, np.ndarray]]:
        for b in self.blocks:
            rows = self._strip_tombstones(b, np.arange(b.n, dtype=np.int64))
            if len(rows):
                yield b, rows

    def tombstone_keep(self, b: FeatureBlock, rows: np.ndarray) -> Optional[np.ndarray]:
        """Bool keep-mask over ``rows`` against this table's tombstones, or
        None when nothing is stripped: the ONE tombstone filter every host
        scan path (plain, covered, native seek) goes through."""
        if not self.tombstones or not len(rows):
            return None
        keep = self._rows_keep(b, rows)
        return None if keep.all() else keep

    def _rows_keep(self, b: FeatureBlock, rows: np.ndarray) -> np.ndarray:
        """``fid_keep`` of the fids at block-local ``rows``, read from the
        keep mask of the block's fid source (``gather``'s rule: its own
        ``__fid__``, else its record block's through ``rowid``) once that
        mask exists. The rows' own fids are probed until the rows probed
        since the last delete add up to the source's size; then the mask
        is made, so a scan pays at most twice what probing each row once
        costs."""
        src = b if "__fid__" in b.columns or b.record is None else b.record
        got = self._keep_masks.get(id(src))
        if got is None or got[0] is not src:
            probed = self._keep_probed.get(id(src), 0) + len(rows)
            if probed < src.n:
                self._keep_probed[id(src)] = probed
                return self.fid_keep(b.gather("__fid__", rows))
        mask = self.source_keep(src)
        return mask[rows] if src is b else mask[b.rowid[rows]]

    def _strip_tombstones(self, b: FeatureBlock, rows: np.ndarray) -> np.ndarray:
        keep = self.tombstone_keep(b, rows)
        return rows if keep is None else rows[keep]

    def compact(self, record: Optional[RecordBlock] = None):
        """Merge all blocks into one, dropping tombstoned rows. With
        ``record`` given, rebuild against that pre-merged shared record
        block (the datastore compacts all of a type's tables against ONE
        merged record, and spills it afterwards); otherwise merge this
        table's own record parts."""
        if record is None:
            if len(self.blocks) <= 1 and not self.tombstones:
                return
            record = self.merged_record()
        self.blocks = []
        self.tombstones = set()
        self._forget_tombstones()
        self.version += 1
        self.insert_record(record)

    def merged_record(self) -> RecordBlock:
        """Live rows of every record block, tombstones dropped, in record
        order: the input of a store-level compaction. Dictionary columns
        decode per part (vocabs are batch-relative) and the merged batch
        re-encodes with one vocab."""
        parts = []
        seen = set()
        for b in self.blocks:
            rb = b.record
            if rb is None or id(rb) in seen:
                continue
            seen.add(id(rb))
            rows = np.arange(rb.n, dtype=np.int64)
            if self.tombstones:
                rows = rows[self.source_keep(rb)]
            if len(rows):
                parts.append(record_rows_decoded(rb.columns, rows))
        merged = intern_string_columns(self.ft, intern_fids(concat_columns(parts)))
        return RecordBlock(merged)
