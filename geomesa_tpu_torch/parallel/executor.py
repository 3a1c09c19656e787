"""TorchScanExecutor: the index pre-filter of z2/z3/xz2/xz3 plans on one device.

Port of ``geomesa_tpu/parallel/executor.py`` limited to the point indices
(z3, z2), the extent indices (xz3, xz2) and to the device routes a query
stream takes there:

  * the EXACT route: a point plan whose full filter is one bbox(+window)
    test is answered by the device alone (no host post-filter). A stream of
    such plans on one table runs as ONE ``exact_bitmap`` kernel launch per
    segment; the per-query span windows of its packed bitmaps are sliced on
    the device and decoded on the host (the reference's bitmap protocol,
    ``_exact_bitmap_batch_fn`` / ``_BitmapBatch``). A lone query runs the
    same kernel with q = 1 and returns run-length encoded hits. A plan
    whose full filter is one box(+window) AND predicates on one attribute
    (``_attr_batch_desc``) takes the same route with the kernel's attribute
    plane: segment-wide rank codes of the attribute (``load_attr_codes``)
    tested against per-query code vectors (member, range, notmember,
    vocabmask), so the device also decides the attribute predicate (the
    reference's attribute batches, ``dispatch_exact_attr``).
  * the DUAL route: an extent plan whose full filter is one spatial
    predicate on the default geometry (+ xz3 time bounds) runs as ONE
    ``xz_dual_bitmap`` launch per segment, giving per query a HIT plane
    (exact f64 envelope overlap) and a DECIDED plane (rows the envelope
    alone answers); only the ring, hit minus decided, takes the host's
    per-geometry test (``_xz_bitmap_batch_fn`` / ``_XZBatchScan``). A lone
    query runs the kernel with q = 1 and returns both planes run-length
    encoded (the reference's ``_xz_runs_fn`` role). A plan that adds
    predicates on one attribute batches with the kernel's attribute
    editions (per attribute and edition, as the point plane's), ANDed into
    the hit plane; alone, it takes the candidate route, as in the
    reference.
  * the CANDIDATE route (plans with a residual the exact descriptors
    decline, e.g. an OR of boxes): the ``candidate_mask`` (points) or
    ``xz_mask`` (extents) kernel gives a conservative mask, run-length
    encoded on the device, and the host post-filters the candidates with
    the full filter.

  * the DENSITY push-down (``density_scan``): a z2/z3 plan whose full
    filter is precise rectangles (+ one precise interval over day or week
    bins) runs ONE ``density_grid`` launch per segment over the raw f32
    coordinates (``load_raw``), which returns the [H, W] grid of the rows
    the device certifies and the indices of the band rows; the host
    certifies the band from its f64 columns (``_certify_density_band``),
    so the grid equals the host reducer's cell for cell.

  * the banded POLYGON route: a point plan whose full filter is one
    non-rectangular INTERSECTS(polygon) (+ z3 window) runs, in a stream, as
    ONE ``poly_dual_bitmap`` launch per segment: an f32 even-odd ray cast
    whose HIT plane holds the envelope's rows that are inside or too near an
    edge for f32 to tell, and whose DECIDED plane holds those it certifies;
    the ring takes the host's exact test (the reference's
    ``_poly_bitmap_batch_fn`` / ``_XZBatchScan``); with predicates on one
    attribute, the kernel's attribute editions. A polygon alone takes the
    candidate route, as in the reference.

  * the COUNT push-down (``count_scan``): a point plan of one box(+window)
    (+ one attribute's predicates) launches ``exact_count`` per segment
    and reads every segment's int32 in one copy; an extent plan, or a
    polygon on a point table, counts the decided rows of the q = 1 dual
    planes plus the ring rows the host's test passes.

  * the STATS push-down (``stats_scan``): a point plan of one box(+window)
    launches ``exact_stat_hist`` per segment and attribute of the stat
    spec, and the host rebuilds the sketches from the per-value counts.

  * the device kNN (``knn_candidates``): one ``knn_topk`` launch per segment
    ranks every row by its f32 haversine distance to a point.

  * the aggregate pyramid's build (``pyramid_counts``): one
    ``pyramid_counts`` launch per z2 segment counts its valid, finite rows
    by pyramid cell (``agg_mask``); the grids sum on the host.

  * the COALESCED route (``dispatch_coalesced``, the seam of the
    cross-query coalescer, ``parallel/batch.py``): concurrent queries'
    exact point plans (with one attribute's predicates too), extent plans
    and polygons stack into ONE full-table mask sweep per segment and group
    (``exact_mask_batch`` / ``dual_mask_batch`` on the exact, extent and
    polygon kernels): one n/8-byte plane a query (two for the dual
    planes), no span framing, decoded on the host (``_decode_full_bitmap_
    rows``); the rest take ``dispatch_many``'s routes.

  * the HOST SEEK (``_seek_scan``, the reference's cost-based chooser): a
    plan whose ranges cover at most ``SEEK_FRAC`` (0.4) of the
    table's rows is answered on the host by a searchsorted seek of the
    sorted blocks (``_HostSeekScan``), through the C++ seek scans
    (``geomesa_tpu_torch/native`` ``seekscan.cpp``) when the query reduces
    to one exact box(+window) on a point index or one spatial predicate on
    an xz2 index. ``GEOMESA_SEEK`` = ``auto`` (the default) | ``0`` (never)
    | ``1`` (whenever the plan has ranges), read at each call; an attribute
    or id plan whose residual is one box(+window) also runs the C++ scan
    over its candidates. The reference's device-assisted seek
    (``GEOMESA_DEVSEEK``, off by default) is not in this slice.

Dispatch and fetch check the ambient query budget (``utils/deadline.py``:
``device.dispatch`` a plan and a segment, ``device.fetch`` a copy); every
copy over the link goes through ``mesh.upload`` / ``_np_local`` and counts
in ``utils/devstats.py``, and each is a fault point of the same name.

Deletes: the table's fid tombstones clear the rows' bits of each resident
segment's ``valid`` and of its temporal-valid columns (``valid & ~nulls``)
and pyramid mask, so every kernel leaves deleted rows out and no row
uploads again; a compaction rewrites the blocks and the mirror rebuilds.
The host seek strips tombstones through ``IndexTable.tombstone_keep``. A
table whose rows carry visibility labels takes no push-down that returns
no rows (count, stats, density, kNN): the host's auth check decides.

Failures: the device circuit breaker and the host degrade (see
``TorchScanExecutor``). A device failure evicts the table's mirror and the
store answers from the host table scan (``scan_path`` =
``host-table-degraded``); while the circuit is open, queries go to the host
at once (``host-table-breaker``). A segment's lazy column loads take a lock, so
concurrent first queries upload once. The exact path and batched dispatch
are always on. A lone extent query
takes the dual route (the reference sends it to the candidate route).
Unlike the reference, segment rows pad to the kernels' granule
(``GRANULE``) rather than to a power-of-two bucket, because PyTorch compiles
no per-shape programs. Span windows decode on the host through the C++
bitmap decode (``bitdecode.cpp``), numpy's unpack when it is unavailable.

The host steps of a scan carry ``torch.profiler`` ranges (``geomesa.fetch``,
``geomesa.decode``, ``geomesa.block_rows``, ``geomesa.ring``, ``geomesa.seek``
around each block's host-seek scan, ``geomesa.dispatch`` around the launches
of a count or stats push-down; the store adds
``geomesa.plan``, ``geomesa.dispatch``, ``geomesa.post_filter`` and
``geomesa.assemble``; a density query opens ``geomesa.density`` around its
launches, ``geomesa.fetch`` around its grid copy and ``geomesa.band``
around the host certification),
and the kNN opens ``geomesa.dispatch`` around its launches and
``geomesa.certify`` around its f64 certificate, so a profiler trace of a
query stream splits its host time by step.
"""

from __future__ import annotations

import json
import os
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from geomesa_tpu_torch.curve import time_to_binned, zorder
from geomesa_tpu_torch.curve.binnedtime import TimePeriod, binned_to_time
from geomesa_tpu_torch.index.planner import QueryPlan
from geomesa_tpu_torch.native import (
    bitmap_rows_native,
    env_seek_scan_native,
    load_seek,
    seek_scan_native,
)
from geomesa_tpu_torch.ops import aggregations, kernels
from geomesa_tpu_torch.ops.filters import pad_boxes, pad_windows
from geomesa_tpu_torch.ops.zkernels import (
    f64_keys,
    limbs_to_keys,
    pack_mask_rows,
    unpack_mask_rows,
)
from geomesa_tpu_torch.parallel.mesh import (
    Device,
    default_device,
    device_auto_declines,
    fetch,
    pad_to_multiple,
    upload,
)
from geomesa_tpu_torch.stats.parser import parse_stat
from geomesa_tpu_torch.stats.sketches import CountStat, SeqStat
from geomesa_tpu_torch.store.blocks import FeatureBlock, IndexTable, expand_intervals
from geomesa_tpu_torch.utils import audit, deadline, devstats, trace
from geomesa_tpu_torch.utils.audit import QueryTimeout, robustness_metrics
from geomesa_tpu_torch.utils.breaker import CircuitBreaker

# initial hit-run capacity: 4096 runs * 8B = 32 KiB per segment transfer
HIT_CAPACITY0 = 4096
# merge device segments once a query must touch more than this many
MAX_SEGMENTS = 8
# runs buffers bigger than n/DENSE_BITMAP_FACTOR rows' worth degrade to the
# packed N/8-byte bitmap (8B/run vs 1bit/row break-even at n/64 runs)
DENSE_BITMAP_FACTOR = 64
# segment row granule: a multiple of the candidate kernel's 4-row vectors
# and of the exact kernel's 32-row ballot words
GRANULE = 1024
# the host seek answers a plan whose ranges cover at most this share of the
# table's rows (the reference's default cutoff; PERF.md on the H100)
SEEK_FRAC = 0.4

_INT64_MIN = np.iinfo(np.int64).min
_INT64_MAX = np.iinfo(np.int64).max

# device candidate columns of each index kind (besides ``valid``)
_CANDIDATE_COLUMNS = {
    "z3": ("xi", "yi", "bins", "ti"),
    "z2": ("xi", "yi"),
    "xz3": ("bxmin", "bymin", "bxmax", "bymax", "bins", "ti"),
    "xz2": ("bxmin", "bymin", "bxmax", "bymax"),
}
_ENV_SUFFIXES = ("__bxmin", "__bymin", "__bxmax", "__bymax")


# the device kNN fetches this many candidates beyond k (at least KNN_MARGIN,
# else k / KNN_MARGIN_DIV) so that its f32 ranking can be certified in f64
KNN_MARGIN = 16
KNN_MARGIN_DIV = 8


def _knn_a64(x: np.ndarray, y: np.ndarray, qx: float, qy: float) -> np.ndarray:
    """The f64 haversine term a = sin^2(half the central angle)."""
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(v, dtype=np.float64)) for v in (x, y, qx, qy))
    return np.sin((lat2 - lat1) / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2


def _knn_a_err(a):
    """A bound of |a32 - a| for the f32 term of ``knn_topk`` (f32 inputs
    and query, one rounding per operation) against the f64 a of the f64
    coordinates: the coordinates' f32 rounding moves a by at most ~6e-7
    sqrt(a), each f32 operation by an ulp of a (measured on the CPU over
    world-wide points and queries at the poles and the antimeridian); the
    bound holds five times that."""
    return 4e-6 * np.sqrt(a) + 1e-6 * a + 1e-12


def _knn_d_lo(a):
    """Least f32 distance ``knn_topk`` can give a row whose f64 term is a
    (sqrtf and asinf each within a few ulps)."""
    s = np.sqrt(np.clip(a - _knn_a_err(a), 0.0, 1.0)) * (1 - 1e-6)
    return np.arcsin(np.minimum(s, 1.0)) * (1 - 1e-6)


def _knn_d_hi(a):
    """Greatest f32 distance ``knn_topk`` can give a row whose f64 term
    is a."""
    s = np.sqrt(np.clip(a + _knn_a_err(a), 0.0, 1.0)) * (1 + 1e-6)
    return np.arcsin(np.minimum(s, 1.0)) * (1 + 1e-6) + 1e-12


# IN-list / '<>'-chain cap of the attribute plane: values dedupe, then pad
# to a pow2 bucket {1, 2, 4, 8, 16, 32}; longer lists answer on the
# candidate route with the host post-filter (the reference's _ATTR_K_CAP)
_ATTR_K_CAP = 32


def _pow2_at_least(n: int, floor: int = 256) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _str_successor(s: str):
    """Smallest string greater than every string with prefix ``s`` (the
    LIKE-prefix upper bound): increment the last code point that can be,
    dropping trailing U+10FFFF. None = unbounded."""
    while s and ord(s[-1]) >= 0x10FFFF:
        s = s[:-1]
    if not s:
        return None
    return s[:-1] + chr(ord(s[-1]) + 1)


def _bounded_nonzero(m: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """First ``size`` indices of set rows, padded with ``fill`` (the
    reference's ``jnp.nonzero(m, size=size, fill_value=fill)``)."""
    return torch.nonzero_static(m, size=size, fill_value=fill).flatten()


def _runs_from_mask(m: torch.Tensor, rcap: int) -> torch.Tensor:
    """Bool mask -> fused RLE buffer int32[count, n_runs, starts*rcap,
    lens*rcap]; unused slots hold start = n and length 1, and the count
    and run count are uncapped (the reference's _runs_from_mask)."""
    n = m.shape[0]
    zero = m.new_zeros(1)
    prev = torch.cat([zero, m[:-1]])
    nxt = torch.cat([m[1:], zero])
    starts_m = m & ~prev
    head = torch.stack([m.sum(dtype=torch.int64), starts_m.sum(dtype=torch.int64)])
    starts = _bounded_nonzero(starts_m, rcap, n)
    ends = _bounded_nonzero(m & ~nxt, rcap, n)
    return torch.cat([head, starts, ends - starts + 1]).to(torch.int32)


def _np_local(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> host numpy: the executor's one device -> host copy
    (``mesh.fetch``: the ``device.fetch`` budget check and fault point,
    and the byte count)."""
    return fetch(t)


def _decode_bitmap_rows(bits: np.ndarray, start: int, max_out: int) -> np.ndarray:
    """Span-window bitmap -> global row indices: the C++ decode
    (``native/bitdecode.cpp``), numpy's unpack when the library is
    unavailable. ``max_out`` is the wire header's hit count (every set bit
    lies inside the span window by construction); a window with more set
    bits raises."""
    with record_function("geomesa.decode"):
        rows = bitmap_rows_native(bits, start, max_out)
        if rows is not None:
            return rows
        return start + np.flatnonzero(np.unpackbits(bits)).astype(np.int64)


def _expand_runs(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """RLE runs -> sorted row indices."""
    if not len(starts):
        return np.empty(0, dtype=np.int64)
    with record_function("geomesa.decode"):
        out = np.repeat(starts, lens)
        base = np.concatenate(([0], np.cumsum(lens[:-1])))
        return out + (np.arange(len(out), dtype=np.int64) - np.repeat(base, lens))


class DeviceSegment:
    """Device-resident mirror of a contiguous run of (non-empty) blocks of
    one index, rows padded to a multiple of GRANULE.

    Candidate columns (``_CANDIDATE_COLUMNS``) and ``valid``; pad rows are
    ``valid = False`` with ``bins = -1``:
      * z3/z2: int32 ``xi, yi`` (and ``bins, ti``) decoded from the z keys;
      * xz3/xz2: float32 stored envelopes ``bxmin .. bymax``, rounded
        outward one ulp so the cast never loses a true overlap, pad rows
        inverted (min 1, max 0); xz3 adds ``bins, ti`` binned from the
        dates.
    Attribute code columns of points (``load_attr_codes``): int32 ranks
    into the segment's sorted value space of one attribute, -1 for null,
    NaN and pad rows. Exact columns of points (``load_exact``): int64 sort
    keys ``xk, yk``
    (and ``tk``) plus ``tvalid``, the valid column with null dates cleared;
    pad keys are int64 max. Exact columns of extents (``load_exact_xz``):
    the four int64 envelope keys ``xz_keys``, ``xz_isrect`` and, for xz3,
    ``xz_tk`` and ``xz_tvalid``; pad keys are int64 min. Raw columns of
    points (``load_raw``, the density push-down): float32 ``xf, yf`` and,
    for z3, the int32 in-bin ms offset ``t_ms`` (and ``tvalid``); pads are
    0.0, 0.0, -1."""

    def __init__(self, kind: str, device: torch.device, n: int,
                 columns: Dict[str, np.ndarray],
                 blocks: Sequence[FeatureBlock] = ()):
        self.kind = kind  # "z3" | "z2" | "xz3" | "xz2"
        self.device = device
        self.blocks = list(blocks)
        self.block_ids = [id(b) for b in self.blocks]
        self.block_starts = [sum(b.n for b in self.blocks[:i]) for i in range(len(self.blocks))]
        self.n = n
        self.n_padded = len(columns["valid"])
        # the host copy of ``valid``'s real rows: tombstones clear bits of
        # it (``apply_tombstones``) and every temporal-valid column and the
        # pyramid's mask derive from it
        self._valid_host = np.array(columns["valid"][:n], dtype=bool)
        self.valid = upload(columns["valid"], device)
        self.xi = self.yi = self.bins = self.ti = None
        self.bxmin = self.bymin = self.bxmax = self.bymax = None
        for name in _CANDIDATE_COLUMNS[kind]:
            setattr(self, name, upload(columns[name], device))
        self.xk = self.yk = self.tk = self.tvalid = None
        # null dates of the rows, kept once a temporal-valid column is made
        self._t_nulls: Optional[np.ndarray] = None
        self._exact_loaded = False
        self.xz_keys = self.xz_isrect = self.xz_tk = self.xz_tvalid = None
        self._xz_t_nulls: Optional[np.ndarray] = None
        self._exact_xz_loaded = False
        self.xf = self.yf = self.t_ms = None
        self._raw_loaded = False
        # attribute -> (codes int32 on the device, sorted unified values) or
        # None when some block has no device-codable layout
        self._attr_codes: Dict[str, Optional[Tuple[torch.Tensor, np.ndarray]]] = {}
        # adaptive run capacity: grows on overflow, remembered per segment
        self._rcap = HIT_CAPACITY0
        # bitmap-batch span window (rows): starts at the full segment and
        # narrows to the widest observed query span
        self._span_cap = 0  # 0 = unlearned -> full segment
        # the lazy column loads: concurrent first loads upload once
        self._load_lock = threading.RLock()

    @classmethod
    def from_blocks(cls, table: IndexTable, blocks: Sequence[FeatureBlock],
                    device: torch.device) -> "DeviceSegment":
        kind = table.index.name
        ft = table.ft
        geom = ft.default_geometry.name
        xs, ys, ts, bins, envs = [], [], [], [], []
        for b in blocks:
            if kind == "z3":
                xi, yi, ti = zorder.z3_decode(b.key.astype(np.int64))
                ts.append(ti.astype(np.int32))
            elif kind == "z2":
                xi, yi = zorder.z2_decode(b.key.astype(np.int64))
            else:  # xz3 / xz2: the stored envelope companions
                e = np.stack([b.columns[geom + sfx] for sfx in _ENV_SUFFIXES],
                             axis=1).astype(np.float64)
                envs.append(_widened_f32(e))
                if kind == "xz3":
                    _, offs = time_to_binned(b.full_col(ft.default_date.name), ft.xz3_interval)
                    ts.append(offs.astype(np.int32))
            if kind in ("z3", "xz3"):
                bins.append(b.bins.astype(np.int32))
            if kind in ("z3", "z2"):
                xs.append(xi.astype(np.int32))
                ys.append(yi.astype(np.int32))
        n = sum(b.n for b in blocks)

        def pack(parts, dtype, fill):
            return pad_to_multiple(np.concatenate(parts).astype(dtype), GRANULE, fill)

        cols = {"valid": pack([np.ones(n, dtype=bool)], bool, False)}
        if kind in ("z3", "z2"):
            cols["xi"] = pack(xs, np.int32, 0)
            cols["yi"] = pack(ys, np.int32, 0)
        else:
            env = np.concatenate(envs)
            # inverted pad boxes (min > max) never overlap a query box
            for j, (name, fill) in enumerate(
                (("bxmin", 1.0), ("bymin", 1.0), ("bxmax", 0.0), ("bymax", 0.0))
            ):
                cols[name] = pack([env[:, j]], np.float32, fill)
        if kind in ("z3", "xz3"):
            cols["ti"] = pack(ts, np.int32, 0)
            cols["bins"] = pack(bins, np.int32, -1)
        devstats.record_pad(n, len(cols["valid"]), kind)
        return cls(kind, device, n, cols, blocks)

    def _pack_keys(self, keys: np.ndarray) -> torch.Tensor:
        # pad with the max key: never inside a finite range (valid also
        # masks pads, this is belt and braces)
        return upload(pad_to_multiple(keys, GRANULE, _INT64_MAX), self.device)

    def load_exact(self, table: IndexTable) -> None:
        """Pack int64 sort-key columns for the EXACT device predicate."""
        if self._exact_loaded:
            return
        with self._load_lock:
            if not self._exact_loaded:
                self._load_exact(table)

    def _load_exact(self, table: IndexTable) -> None:
        ft = table.ft
        geom = ft.default_geometry.name
        xs = np.concatenate([b.full_col(geom + "__x") for b in self.blocks])
        ys = np.concatenate([b.full_col(geom + "__y") for b in self.blocks])
        self.xk = self._pack_keys(f64_keys(xs))
        self.yk = self._pack_keys(f64_keys(ys))
        if self.kind == "z3":
            dtg = ft.default_date.name
            # an int64 time's key is the ms value itself
            self.tk = self._pack_keys(np.concatenate(
                [b.full_col(dtg).astype(np.int64) for b in self.blocks]
            ))
            self._load_tvalid(ft)
        self._exact_loaded = True

    def _load_tvalid(self, ft) -> None:
        """``tvalid``: null dates are stored as 0 + a __null mask, and the
        host evaluator rejects them for any temporal predicate, so a
        temporal device test (the exact mask, the density windows) needs
        its own valid column, ``valid & ~nulls`` (bbox-only queries keep
        them): tombstoned rows stay cleared in it."""
        if self.tvalid is not None:
            return
        dtg = ft.default_date.name
        nulls = np.concatenate([b.full_col(dtg + "__null") for b in self.blocks])
        self._t_nulls = nulls if nulls.any() else None
        self.tvalid = self._temporal_valid(self._t_nulls)

    def _temporal_valid(self, nulls: Optional[np.ndarray]) -> torch.Tensor:
        """``valid`` with the null-date rows cleared (``valid`` itself when
        there are none)."""
        if nulls is None:
            return self.valid
        return upload(pad_to_multiple(self._valid_host & ~nulls, GRANULE, False), self.device)

    def apply_tombstones(self, table: IndexTable) -> None:
        """Clear deleted rows in the device valid columns (the reference's
        ``apply_tombstones``): a delete flips valid bits, so the next
        device scan leaves the rows out; no row is re-packed. ``valid`` is
        uploaded anew (its identity re-keys ``agg_mask``'s cache) and the
        temporal-valid columns follow it. The keep mask is computed per
        record block from its fids, in record order, then gathered into
        the segment's key order."""
        if not self.n:
            return
        keep = np.concatenate([
            table.fid_keep(b.record.columns["__fid__"])[b.rowid] if b.record is not None
            else table.fid_keep(b.full_col("__fid__"))
            for b in self.blocks
        ])
        if np.array_equal(keep, self._valid_host):
            return
        with self._load_lock:
            self._valid_host = keep
            self.valid = upload(pad_to_multiple(keep, GRANULE, False), self.device)
            if self.tvalid is not None:
                self.tvalid = self._temporal_valid(self._t_nulls)
            if self.xz_tvalid is not None:
                self.xz_tvalid = self._temporal_valid(self._xz_t_nulls)

    def load_exact_xz(self, table: IndexTable) -> None:
        """Pack the int64 sort keys of the envelope companions, the isrect
        flags and, for xz3, the date keys and a temporal-valid column for
        the EXACT extent predicate."""
        if self._exact_xz_loaded:
            return
        with self._load_lock:
            if not self._exact_xz_loaded:
                self._load_exact_xz(table)

    def _load_exact_xz(self, table: IndexTable) -> None:
        ft = table.ft
        geom = ft.default_geometry.name
        # pad with the min key; pads are also valid = False
        self.xz_keys = tuple(
            upload(pad_to_multiple(
                f64_keys(np.concatenate([b.columns[geom + sfx] for b in self.blocks])),
                GRANULE, _INT64_MIN), self.device)
            for sfx in _ENV_SUFFIXES
        )
        irs = np.concatenate([
            np.asarray(b.columns.get(geom + "__isrect", np.zeros(b.n, np.uint8))).astype(bool)
            for b in self.blocks
        ])
        self.xz_isrect = upload(pad_to_multiple(irs, GRANULE, False), self.device)
        if self.kind == "xz3":
            dtg = ft.default_date.name
            self.xz_tk = upload(pad_to_multiple(
                np.concatenate([b.full_col(dtg).astype(np.int64) for b in self.blocks]),
                GRANULE, _INT64_MIN), self.device)
            # null dates: the temporal test rejects them (see _load_tvalid)
            nulls = np.concatenate([b.full_col(dtg + "__null") for b in self.blocks])
            self._xz_t_nulls = nulls if nulls.any() else None
            self.xz_tvalid = self._temporal_valid(self._xz_t_nulls)
        self._exact_xz_loaded = True

    def load_raw(self, table: IndexTable) -> bool:
        """Pack the raw f32 coordinates (+ the in-bin ms offsets of day/week
        z3 bins) for the density push-down. False when unsupported: month
        and year bins are not uniform and overflow int32 ms offsets."""
        if not self._raw_loaded:
            with self._load_lock:
                if not self._raw_loaded:
                    self._load_raw(table)
        return self.kind == "z2" or self.t_ms is not None

    def _load_raw(self, table: IndexTable) -> None:
        ft = table.ft
        geom = ft.default_geometry.name

        def pack(parts, dtype, fill):
            return upload(pad_to_multiple(np.concatenate(parts).astype(dtype), GRANULE, fill),
                          self.device)

        self.xf = pack([b.full_col(geom + "__x") for b in self.blocks], np.float32, 0.0)
        self.yf = pack([b.full_col(geom + "__y") for b in self.blocks], np.float32, 0.0)
        if self.kind == "z3" and ft.z3_interval in (TimePeriod.DAY, TimePeriod.WEEK):
            traw = []
            for b in self.blocks:
                t_ms = b.full_col(ft.default_date.name).astype(np.int64)
                starts = binned_to_time(
                    b.bins.astype(np.int64), np.zeros(b.n, np.int64), ft.z3_interval
                )
                traw.append(t_ms - starts)
            self.t_ms = pack(traw, np.int32, -1)
            self._load_tvalid(ft)
        # last: a reader past the flag sees every column
        self._raw_loaded = True

    def load_attr_codes(self, attr: str) -> bool:
        """Upload the unified rank-code column of one attribute (the
        reference's ``load_attr_codes``): every block's values re-encode
        into ONE segment-wide SORTED value space, so the device decides
        ``attr = literal`` with one int32 compare per row and range
        predicates with one interval test (code order is value order).

        Dictionary-coded string blocks remap their sorted vocab with one
        searchsorted pass; raw int / long / float / double / date-ms
        columns (and the fixed-width unicode fallback of high-cardinality
        strings) take ``np.unique`` of their live values, whose ranks are
        the codes. Null rows and float NaN carry -1, as do pad rows. False
        when some block holds the attribute as objects (host only)."""
        if attr not in self._attr_codes:
            with self._load_lock:
                if attr not in self._attr_codes:
                    self._load_attr_codes(attr)
        return self._attr_codes[attr] is not None

    def _load_attr_codes(self, attr: str) -> None:
        def raw_vocab(b):
            # vocabs are not row-aligned: bypass full_col's record gather
            v = b.columns.get(attr + "__vocab")
            if v is None and b.record is not None:
                v = b.record.columns.get(attr + "__vocab")
            return v

        per = []  # (kind, column, vocab | nulls)
        vocab_pool = []  # value arrays feeding the unified space
        try:
            for b in self.blocks:
                col = b.full_col(attr)
                vocab = raw_vocab(b)
                if vocab is not None and col.dtype.kind in "iu":
                    per.append(("dict", col, vocab))
                    vocab_pool.append(vocab)
                elif col.dtype.kind in "iufU":
                    nulls = b.full_col(attr + "__null")
                    if col.dtype.kind == "f":
                        nulls = nulls | np.isnan(col)
                    live = col[~nulls] if nulls.any() else col
                    per.append(("raw", col, nulls))
                    vocab_pool.append(np.unique(live))
                else:
                    raise KeyError(attr)  # object column: host only
        except KeyError:
            self._attr_codes[attr] = None
            return
        unified = (
            np.unique(np.concatenate(vocab_pool)) if vocab_pool else np.empty(0, dtype=object)
        )
        parts = []
        for kind, col, aux in per:
            if kind == "dict":
                remap = np.searchsorted(unified, aux).astype(np.int32)
                parts.append(
                    np.where(col >= 0, remap[np.maximum(col, 0)], np.int32(-1)).astype(np.int32)
                )
            else:
                # null / NaN rows rank arbitrarily here and become -1
                codes = np.searchsorted(unified, col).astype(np.int32)
                codes[aux] = -1
                parts.append(codes)
        packed = pad_to_multiple(
            np.concatenate(parts) if parts else np.empty(0, np.int32), GRANULE, np.int32(-1))
        self._attr_codes[attr] = (upload(packed, self.device), unified)

    def attr_qcode(self, attr: str, value) -> int:
        """Segment-local code of ``value``: -2 when absent or not comparable
        with the value space (matches no row, nulls at -1 included)."""
        unified = self._attr_codes[attr][1]
        try:
            i = int(np.searchsorted(unified, value))
        except (TypeError, ValueError):
            return -2
        if i < len(unified) and unified[i] == value:
            return i
        return -2

    def attr_qrange(self, attr: str, preds) -> np.ndarray:
        """int32[2] inclusive code interval: the intersection of ``preds``
        mapped into the sorted unified value space. Each pred is (op,
        literal): =, <, <=, >, >=, between (inclusive pair), the exclusive
        temporal forms during / before / after, prefix (LIKE with one
        trailing %), isnull ([-1, -1]: nulls and NaN rank -1) and notnull.
        Searchsorted sides give the evaluator's code-space semantics;
        incomparable literals give an empty interval (lo > hi), and every
        value op keeps lo >= 0 so nulls match no ordinary range."""
        unified = self._attr_codes[attr][1]
        u = len(unified)
        lo, hi = -1, u - 1  # -1 is reachable only through isnull
        for op, lit in preds:
            try:
                if op in ("between", "during"):
                    a_side, b_side = ("left", "right") if op == "between" else ("right", "left")
                    a = np.searchsorted(unified, lit[0], side=a_side)
                    b = np.searchsorted(unified, lit[1], side=b_side) - 1
                elif op == "=":
                    a = np.searchsorted(unified, lit, side="left")
                    b = np.searchsorted(unified, lit, side="right") - 1
                elif op == ">=":
                    a, b = np.searchsorted(unified, lit, side="left"), u - 1
                elif op in (">", "after"):
                    a, b = np.searchsorted(unified, lit, side="right"), u - 1
                elif op in ("<", "before"):
                    a, b = 0, np.searchsorted(unified, lit, side="left") - 1
                elif op == "<=":
                    a, b = 0, np.searchsorted(unified, lit, side="right") - 1
                elif op == "prefix":
                    a = np.searchsorted(unified, lit, side="left")
                    succ = _str_successor(lit)
                    b = (np.searchsorted(unified, succ, side="left") - 1
                         if succ is not None else u - 1)
                elif op == "isnull":
                    a, b = -1, -1
                elif op == "notnull":
                    a, b = 0, u - 1
                else:  # an unknown op claims nothing
                    a, b = 0, -1
            except (TypeError, ValueError):
                a, b = 0, -1
            lo, hi = max(lo, int(a)), min(hi, int(b))
        return np.array([lo, hi], dtype=np.int32)

    def attr_qcodes(self, attr: str, values, k: int) -> np.ndarray:
        """int32[k] codes of an IN list (equality is one value), padded with
        the match-nothing -2."""
        out = np.full(k, -2, dtype=np.int32)
        for j, v in enumerate(values[:k]):
            out[j] = self.attr_qcode(attr, v)
        return out

    # the vocabmask edition declines above this many distinct values (its
    # lookup table rides with every query, built by one host regex pass)
    ATTR_VOCAB_MASK_CAP = 1 << 16

    def attr_vocab_ok(self, attr: str) -> bool:
        """Codes loaded and a value space small enough for a per-query
        lookup table (the vocabmask edition)."""
        info = self._attr_codes.get(attr)
        return info is not None and len(info[1]) <= self.ATTR_VOCAB_MASK_CAP

    def attr_qmask(self, attr: str, payload) -> np.ndarray:
        """uint8[U_pad] lookup over the sorted unified value space for a
        LIKE / ILIKE pattern, built with the host evaluator's own matcher
        (``filter/evaluate.py`` ``like_regex``), so the device decides the
        host's answer. ``payload`` = (pattern, case_insensitive)."""
        from geomesa_tpu_torch.filter.evaluate import like_regex

        pattern, ci = payload
        unified = self._attr_codes[attr][1]
        rx = like_regex(pattern, ci)
        out = np.zeros(_pow2_at_least(max(len(unified), 1), 8), dtype=np.uint8)
        for i, v in enumerate(unified):
            if isinstance(v, (str, np.str_)) and rx.match(str(v)):
                out[i] = 1
        return out

    def _attr_batch_vectors(self, attr: str, attr_kind: str, payloads) -> np.ndarray:
        """The per-query attribute vectors of one batch in this segment's
        code space: [q, K] codes of the batch's pow2 bucket K (member,
        notmember), [q, 2] intervals (range) or [q, U_pad] lookup tables
        (vocabmask)."""
        if attr_kind == "range":
            rows = [self.attr_qrange(attr, p) for p in payloads]
        elif attr_kind == "vocabmask":
            rows = [self.attr_qmask(attr, p) for p in payloads]
        else:
            k = _pow2_at_least(max(len(p) for p in payloads), 1)
            rows = [self.attr_qcodes(attr, p, k) for p in payloads]
        return np.stack(rows)

    def _attr_plane_args(self, attr: str, payload, kind: str):
        """(codes, qcodes int32|uint8 [1, ...] on the device, kind) of one
        attribute-plane query."""
        return (self._attr_codes[attr][0],
                upload(self._attr_batch_vectors(attr, kind, [payload]), self.device), kind)

    def remember_rcap(self, nruns: int) -> None:
        """Adapt the run capacity to observed run counts: grow to 2x the
        need (pow2), decay gently when queries shrink, and never exceed the
        packed-bitmap break-even."""
        cap_hi = HIT_CAPACITY0
        limit = max(HIT_CAPACITY0, self.n_padded // (2 * DENSE_BITMAP_FACTOR))
        while cap_hi < limit:
            cap_hi *= 2
        want = HIT_CAPACITY0
        while want < 2 * nruns and want < cap_hi:
            want *= 2
        if want > self._rcap:
            self._rcap = want
        elif want < self._rcap:
            self._rcap = max(want, self._rcap // 2)

    def span_cap(self) -> int:
        """Current bitmap span window: learned pow2 bucket, clamped to the
        segment (both multiples of 8)."""
        if self._span_cap == 0:
            return self.n_padded
        return min(self._span_cap, self.n_padded)

    def remember_span(self, span: int) -> None:
        """Adapt the bitmap span window to the widest query span of a
        stream (called once per batch): grow immediately, decay gently."""
        want = min(_pow2_at_least(max(int(span * 1.25), 1), 1 << 16), self.n_padded)
        cur = self._span_cap or self.n_padded
        if want > cur:
            self._span_cap = want
        elif want < cur:
            self._span_cap = max(want, cur // 2)

    def seed_span(self, span: int) -> None:
        """Seed the span window from the plans before the first stream
        (only when unlearned): the planned z-ranges cover every hit row."""
        if self._span_cap == 0:
            self._span_cap = min(_pow2_at_least(max(int(span), 1), 1 << 16), self.n_padded)

    def _exact_cols(self, has_time: bool):
        if has_time:
            return self.xk, self.yk, self.tk, self.tvalid
        return self.xk, self.yk, None, self.valid

    def _xz_cols(self, has_time: bool):
        """(bxmin, bymin, bxmax, bymax, isrect, valid, tk | None) of the
        extent kernel: the temporal-valid column when the query has time."""
        if has_time:
            return (*self.xz_keys, self.xz_isrect, self.xz_tvalid, self.xz_tk)
        return (*self.xz_keys, self.xz_isrect, self.valid, None)

    def dispatch_hits(self, boxes_dev, windows_dev) -> "_PendingHits":
        """Candidate scan: the ``candidate_mask`` (points) or ``xz_mask``
        (extents) kernel, then the RLE runs on the device. Call ``.rows()``
        on the handle to fetch and decode."""
        if self.kind == "z3":
            mask = kernels.candidate_mask(
                self.xi, self.yi, self.valid, boxes_dev, self.bins, self.ti, windows_dev
            )
        elif self.kind == "z2":
            mask = kernels.candidate_mask(self.xi, self.yi, self.valid, boxes_dev)
        elif self.kind == "xz3":
            mask = kernels.xz_mask(
                self.bxmin, self.bymin, self.bxmax, self.bymax, self.valid, boxes_dev,
                self.bins, self.ti, windows_dev,
            )
        else:
            mask = kernels.xz_mask(
                self.bxmin, self.bymin, self.bxmax, self.bymax, self.valid, boxes_dev
            )
        rcap = self._rcap
        return _PendingHits(
            self, rcap, _runs_from_mask(mask, rcap),
            refetch=lambda rc: _runs_from_mask(mask, rc),
            packed=lambda: pack_mask_rows(mask),
        )

    def dispatch_exact(self, box_dev, win_dev, plane=None) -> "_PendingHits":
        """Exact predicate scan of one query: ``exact_bitmap`` with q = 1,
        run-length encoded from its bits on the device. ``plane`` = (codes,
        qcodes [1, ...], kind) adds the attribute test."""
        has_time = self.tk is not None and win_dev is not None
        xk, yk, tk, valid = self._exact_cols(has_time)
        codes, qcodes, kind = plane if plane is not None else (None, None, None)
        bits, _hdr = kernels.exact_bitmap(
            xk, yk, tk, valid, box_dev[None], win_dev[None] if has_time else None,
            codes, qcodes, kind,
        )
        mask = unpack_mask_rows(bits[0])
        rcap = self._rcap
        return _PendingHits(
            self, rcap, _runs_from_mask(mask, rcap),
            refetch=lambda rc: _runs_from_mask(mask, rc),
            packed=lambda: bits[0],
        )

    def dispatch_exact_attr(self, box_dev, win_dev, attr: str, payload,
                            kind: str = "member") -> "_PendingHits":
        """One query of the attribute plane (the reference's
        ``dispatch_exact_attr``): ``exact_bitmap`` with q = 1 and the
        attribute test, as runs. ``payload`` is the literal tuple (member,
        notmember), the (op, literal) tuple (range) or (pattern,
        case_insensitive) (vocabmask); ``load_attr_codes(attr)`` must have
        succeeded."""
        return self.dispatch_exact(box_dev, win_dev, self._attr_plane_args(attr, payload, kind))

    def dispatch_exact_batch(self, descs: Sequence[tuple], has_time: bool,
                             attr: Optional[str] = None, attr_kind: str = "member"
                             ) -> List["_PendingBitmapHits"]:
        """Q exact scans in ONE ``exact_bitmap`` launch. ``descs`` =
        [(box int64[4], win int64[2] | None)], or with ``attr``
        [(box, win, payload)]: the kernel then also decides the attribute
        predicate per row on the unified codes (``load_attr_codes``), the
        edition ``attr_kind`` (member, range, notmember, vocabmask; one per
        batch) mapping each payload to this segment's code space. The span
        windows are sliced on the device, so one fetch of (headers,
        windows) serves all q; a query whose span outgrows the window
        refetches alone as runs."""
        boxes_dev = upload(np.stack([d[0] for d in descs]), self.device)
        wins_dev = upload(np.stack([d[1] for d in descs]), self.device) if has_time else None
        xk, yk, tk, valid = self._exact_cols(has_time)
        codes = qcodes = None
        if attr is not None:
            codes = self._attr_codes[attr][0]
            qcodes = upload(self._attr_batch_vectors(attr, attr_kind, [d[2] for d in descs]),
                            self.device)
        bits, hdr = kernels.exact_bitmap(xk, yk, tk, valid, boxes_dev, wins_dev, codes, qcodes,
                                         attr_kind if attr is not None else None)
        span_cap = self.span_cap()
        header, window = kernels.frame_bitmaps(bits, hdr, span_cap)
        batch = _BitmapBatch(header, window, span_cap, seg=self)
        out = []
        for i in range(len(descs)):
            win_i = wins_dev[i] if has_time else None
            plane = None if attr is None else (codes, qcodes[i:i + 1], attr_kind)
            out.append(_PendingBitmapHits(
                self, batch, i,
                single=lambda b=boxes_dev[i], w=win_i, p=plane: self.dispatch_exact(b, w, p),
            ))
        return out

    def count_exact_start(self, box_dev, win_dev, attr: Optional[str] = None, payload=None,
                          kind: str = "member") -> torch.Tensor:
        """Dispatch a filtered count (the reference's ``count_exact_start``):
        ``exact_count`` of one box(+window) query, with the attribute plane
        of ``attr`` (its codes loaded; ``payload`` and ``kind`` as for
        ``dispatch_exact_attr``), summed on the device. Returns the
        in-flight int32[1]; the caller dispatches every segment before it
        reads them all in one copy."""
        has_time = self.tk is not None and win_dev is not None
        xk, yk, tk, valid = self._exact_cols(has_time)
        codes = qcodes = None
        if attr is not None:
            codes, qcodes, kind = self._attr_plane_args(attr, payload, kind)
        return kernels.exact_count(xk, yk, tk, valid, box_dev, win_dev if has_time else None,
                                   codes, qcodes, kind if attr is not None else None)

    def stat_hist_start(self, box_dev, win_dev, attr: str) -> Tuple[torch.Tensor, np.ndarray]:
        """Dispatch a filtered per-code hit histogram of ``attr`` (its codes
        loaded; the reference's ``stat_hist_start``): (in-flight int32[1 +
        u_pad], the sorted unified value space), word 0 the hit count
        (nulls included), word 1 + c the hits of value ``unified[c]``;
        ``u_pad`` is ``len(unified)`` padded to a power of two of at least 8,
        per segment."""
        has_time = self.tk is not None and win_dev is not None
        xk, yk, tk, valid = self._exact_cols(has_time)
        codes, unified = self._attr_codes[attr]
        u_pad = _pow2_at_least(len(unified), 8)
        return kernels.exact_stat_hist(xk, yk, tk, valid, box_dev,
                                       win_dev if has_time else None, codes, u_pad), unified

    def dispatch_exact_xz(self, desc_dev, has_time: bool, plane=None) -> "_PendingXZHits":
        """Exact extent scan of one query: ``xz_dual_bitmap`` with q = 1,
        both planes run-length encoded on the device (the reference's
        ``_xz_runs_fn`` role). ``desc_dev`` = int64[8] on the device;
        ``plane`` = (codes, qcodes [1, ...], kind) adds the attribute test
        (the reference's ``count_xz_start`` and lone attribute scans)."""
        cols = self._xz_cols(has_time)
        codes, qcodes, kind = plane if plane is not None else (None, None, None)
        hit_bits, dec_bits, _hdr = kernels.xz_dual_bitmap(
            *cols[:6], desc_dev[None], cols[6], codes, qcodes, kind)
        hit = unpack_mask_rows(hit_bits[0])
        dec = unpack_mask_rows(dec_bits[0])

        def dual_runs(rc: int) -> torch.Tensor:
            return torch.cat([_runs_from_mask(hit, rc), _runs_from_mask(dec, rc)])

        rcap = self._rcap
        return _PendingXZHits(
            self, rcap, dual_runs(rcap), refetch=dual_runs,
            packed=lambda: torch.cat([hit_bits[0], dec_bits[0]]),
        )

    def count_xz_start(self, desc_dev, has_time: bool, attr: Optional[str] = None,
                       payload=None, kind: str = "member") -> "_PendingXZHits":
        """Dispatch ONE extent scan's dual planes for a count (the
        reference's ``count_xz_start``): the q = 1 dual route, with the
        attribute plane of ``attr``; the executor counts the decided rows
        and the ring rows the host certifies."""
        plane = None if attr is None else self._attr_plane_args(attr, payload, kind)
        return self.dispatch_exact_xz(desc_dev, has_time, plane)

    def dispatch_exact_xz_batch(self, descs: np.ndarray, has_time: bool,
                                attr: Optional[str] = None, attr_kind: str = "member",
                                payloads=None) -> List["_PendingXZBitmapHits"]:
        """Q extent exact scans in ONE ``xz_dual_bitmap`` launch: per query
        the (hit, decided) span windows keyed on the hit span, sliced on
        the device and fetched once for all q; a query whose span outgrows
        the window refetches alone as dual runs. ``descs`` = int64[q, 8];
        with ``attr``, ``payloads`` one a query and the attribute test of
        the edition ``attr_kind`` ANDed into each hit plane (the
        reference's ``dispatch_exact_xz_batch(..., attr=)``)."""
        descs_dev = upload(descs, self.device)
        cols = self._xz_cols(has_time)
        codes = qcodes = None
        if attr is not None:
            codes = self._attr_codes[attr][0]
            qcodes = upload(self._attr_batch_vectors(attr, attr_kind, payloads), self.device)
        hit_bits, dec_bits, hdr = kernels.xz_dual_bitmap(
            *cols[:6], descs_dev, cols[6], codes, qcodes, attr_kind if attr is not None else None)
        span_cap = self.span_cap()
        header, window = kernels.frame_dual_bitmaps(hit_bits, dec_bits, hdr, span_cap)
        batch = _BitmapBatch(header, window, span_cap, seg=self)
        out = []
        for i in range(len(descs)):
            plane = None if attr is None else (codes, qcodes[i:i + 1], attr_kind)
            out.append(_PendingXZBitmapHits(
                self, batch, i,
                single=lambda d=descs_dev[i], p=plane: self.dispatch_exact_xz(d, has_time, p),
            ))
        return out

    def load_poly(self, table: IndexTable) -> bool:
        """The columns of the banded polygon ray cast (point indices only):
        the exact sort keys (``load_exact``) and the raw f32 coordinates
        (``load_raw``'s ``xf, yf``, packed whatever its time columns)."""
        if self.kind not in ("z2", "z3"):
            return False
        self.load_exact(table)
        if self.xf is None:
            self.load_raw(table)
        return self.xf is not None

    def _poly_cols(self, has_time: bool):
        """(xk, yk, valid, xf, yf, tk | None) of the polygon kernel: the
        temporal-valid column when the query has time."""
        xk, yk, tk, valid = self._exact_cols(has_time)
        return xk, yk, valid, self.xf, self.yf, tk

    def dispatch_poly(self, edges_dev, box_dev, win_dev, plane=None) -> "_PendingXZHits":
        """One banded polygon scan: ``poly_dual_bitmap`` with q = 1, both
        planes run-length encoded on the device (the reference's
        ``_poly_runs_fn`` role; ``_poly_packed_fn`` for the dense degrade).
        ``edges_dev`` f32[E, 4], ``box_dev`` int64[4], ``win_dev`` int64[2]
        or None; ``plane`` = (codes, qcodes [1, ...], kind) adds the
        attribute test."""
        has_time = win_dev is not None
        xk, yk, valid, xf, yf, tk = self._poly_cols(has_time)
        codes, qcodes, kind = plane if plane is not None else (None, None, None)
        hit_bits, dec_bits, _hdr = kernels.poly_dual_bitmap(
            xk, yk, valid, xf, yf, edges_dev[None], box_dev[None],
            win_dev[None] if has_time else None, tk, codes, qcodes, kind)
        hit = unpack_mask_rows(hit_bits[0])
        dec = unpack_mask_rows(dec_bits[0])

        def dual_runs(rc: int) -> torch.Tensor:
            return torch.cat([_runs_from_mask(hit, rc), _runs_from_mask(dec, rc)])

        rcap = self._rcap
        return _PendingXZHits(
            self, rcap, dual_runs(rcap), refetch=dual_runs,
            packed=lambda: torch.cat([hit_bits[0], dec_bits[0]]),
        )

    def count_poly_start(self, edges_dev, box_dev, win_dev, attr: Optional[str] = None,
                         payload=None, kind: str = "member") -> "_PendingXZHits":
        """Dispatch ONE banded polygon scan's dual planes for a count (the
        reference's ``count_poly_start``): ``dispatch_poly``, with the
        attribute plane of ``attr``."""
        plane = None if attr is None else self._attr_plane_args(attr, payload, kind)
        return self.dispatch_poly(edges_dev, box_dev, win_dev, plane)

    def dispatch_poly_batch(self, descs: Sequence[tuple], has_time: bool,
                            attr: Optional[str] = None, attr_kind: str = "member"
                            ) -> List["_PendingXZBitmapHits"]:
        """Q banded polygon scans in ONE ``poly_dual_bitmap`` launch (the
        reference's ``dispatch_poly_batch`` on the bitmap protocol):
        ``descs`` = [(edges f32[E, 4], box int64[4], win int64[2] | None)],
        with ``attr`` [(edges, box, win, payload)]: the attribute test of
        the edition ``attr_kind`` ANDs into each hit plane. Edge lists pad
        to the batch's shared pow2 bucket (at least 8) with degenerate zero
        edges and the batch to a multiple of 4 queries with copies of the
        last; per query the (hit, decided) span windows keyed on the hit
        span are sliced on the device and fetched once for all; a query
        whose span outgrows the window refetches alone
        (``dispatch_poly``)."""
        q = len(descs)
        qpad = (q + 3) // 4 * 4
        ecap = _pow2_at_least(max(len(d[0]) for d in descs), 8)
        padded = list(descs) + [descs[-1]] * (qpad - q)
        edges = np.zeros((qpad, ecap, 4), dtype=np.float32)
        for i, d in enumerate(padded):
            edges[i, :len(d[0])] = d[0]
        edges_dev = upload(edges, self.device)
        boxes_dev = upload(np.stack([d[1] for d in padded]), self.device)
        wins_dev = upload(np.stack([d[2] for d in padded]), self.device) if has_time else None
        xk, yk, valid, xf, yf, tk = self._poly_cols(has_time)
        codes = qcodes = None
        if attr is not None:
            codes = self._attr_codes[attr][0]
            qcodes = upload(self._attr_batch_vectors(attr, attr_kind, [d[3] for d in padded]),
                            self.device)
        hit_bits, dec_bits, hdr = kernels.poly_dual_bitmap(
            xk, yk, valid, xf, yf, edges_dev, boxes_dev, wins_dev, tk, codes, qcodes,
            attr_kind if attr is not None else None)
        span_cap = self.span_cap()
        header, window = kernels.frame_dual_bitmaps(hit_bits, dec_bits, hdr, span_cap)
        batch = _BitmapBatch(header, window, span_cap, seg=self)
        out = []
        for i in range(q):
            win_i = wins_dev[i] if has_time else None
            plane = None if attr is None else (codes, qcodes[i:i + 1], attr_kind)
            out.append(_PendingXZBitmapHits(
                self, batch, i,
                single=lambda e=edges_dev[i], b=boxes_dev[i], w=win_i, p=plane:
                    self.dispatch_poly(e, b, w, p),
            ))
        return out

    def dispatch_exact_mask_batch(self, descs: Sequence[tuple], has_time: bool,
                                  attr: Optional[str] = None, attr_kind: str = "member"
                                  ) -> List["_PendingMaskHits"]:
        """Q exact predicates in ONE ``exact_mask_batch`` launch: one
        full-table packed plane u8[q, n/8] back, no span framing and no
        capacity to outgrow (the coalescer's sweep, the reference's
        ``dispatch_exact_mask_batch``). ``descs`` as for
        ``dispatch_exact_batch``, with ``attr`` the attribute plane's
        payloads; the batch launches its real q (no pow2 padding)."""
        boxes_dev = upload(np.stack([d[0] for d in descs]), self.device)
        wins_dev = upload(np.stack([d[1] for d in descs]), self.device) if has_time else None
        xk, yk, tk, valid = self._exact_cols(has_time)
        codes = qcodes = None
        if attr is not None:
            codes = self._attr_codes[attr][0]
            qcodes = upload(self._attr_batch_vectors(attr, attr_kind, [d[2] for d in descs]),
                            self.device)
        bits = kernels.exact_mask_batch(xk, yk, tk, valid, boxes_dev, wins_dev, codes, qcodes,
                                        attr_kind if attr is not None else None)
        batch = _MaskBatch(bits, self.n)
        return [_PendingMaskHits(batch, i) for i in range(len(descs))]

    def dispatch_dual_mask_batch(self, kind: str, descs: Sequence[tuple], has_time: bool,
                                 attr: Optional[str] = None, attr_kind: str = "member"
                                 ) -> List["_PendingDualMaskHits"]:
        """The dual-plane edition of ``dispatch_exact_mask_batch`` for the
        extent (``kind`` "xz": ``descs`` = [(desc int64[8] [, payload])]) and
        banded polygon ("poly": [(edges f32[E, 4], box int64[4], win
        int64[2] | None [, payload])], edge lists padded to the batch's pow2
        of at least 8) folds: ONE ``dual_mask_batch`` launch, two full-table
        packed planes a query, resolved through ``_XZBatchScan`` (decided
        rows final, the ring tested on the host)."""
        payloads = [d[-1] for d in descs] if attr is not None else None
        codes = qcodes = None
        if attr is not None:
            codes = self._attr_codes[attr][0]
            qcodes = upload(self._attr_batch_vectors(attr, attr_kind, payloads), self.device)
        akind = attr_kind if attr is not None else None
        if kind == "xz":
            descs_dev = upload(np.stack([d[0] for d in descs]), self.device)
            cols = self._xz_cols(has_time)
            hit, dec = kernels.dual_mask_batch("xz", *cols[:6], descs_dev, cols[6], codes,
                                               qcodes, akind)
        else:
            ecap = _pow2_at_least(max(len(d[0]) for d in descs), 8)
            edges = np.zeros((len(descs), ecap, 4), dtype=np.float32)
            for i, d in enumerate(descs):
                edges[i, :len(d[0])] = d[0]
            edges_dev = upload(edges, self.device)
            boxes_dev = upload(np.stack([d[1] for d in descs]), self.device)
            wins_dev = upload(np.stack([d[2] for d in descs]), self.device) if has_time else None
            xk, yk, valid, xf, yf, tk = self._poly_cols(has_time)
            hit, dec = kernels.dual_mask_batch("poly", xk, yk, valid, xf, yf, edges_dev,
                                               boxes_dev, wins_dev, tk, codes, qcodes, akind)
        batch = _DualMaskBatch(hit, dec, self.n)
        return [_PendingDualMaskHits(batch, i) for i in range(len(descs))]

    @property
    def block_bounds(self) -> List[int]:
        """Row offsets of the segment's key-sorted blocks, then the end of
        the last one (the pad rows past it belong to no block)."""
        return self.block_starts + [self.n]

    def agg_mask(self, table: IndexTable) -> torch.Tensor:
        """The rows the aggregate pyramid's build counts (the reference's
        ``agg_mask``): ``valid`` (tombstones cleared) and a finite geometry
        (a null geometry's lenient key is clipped into a cell and must
        never count there). Cached per ``valid`` tensor: a delete uploads a
        new ``valid`` and so re-keys the cache."""
        got = getattr(self, "_agg_mask", None)
        if got is not None and got[0] is self.valid:
            return got[1]
        with self._load_lock:
            got = getattr(self, "_agg_mask", None)
            if got is not None and got[0] is self.valid:
                return got[1]
            geom = table.ft.default_geometry.name
            finite = np.concatenate(
                [np.isfinite(np.asarray(b.full_col(geom + "__x"), dtype=np.float64))
                 & np.isfinite(np.asarray(b.full_col(geom + "__y"), dtype=np.float64))
                 for b in self.blocks]
            ) if self.blocks else np.empty(0, dtype=bool)
            mask = upload(pad_to_multiple(self._valid_host & finite, GRANULE, False), self.device)
            self._agg_mask = (self.valid, mask)
            return mask

    def to_block_rows(self, rows: np.ndarray) -> List[Tuple[FeatureBlock, np.ndarray]]:
        """Segment-local candidate rows -> [(block, local rows)]."""
        if not len(rows):
            return []
        with record_function("geomesa.block_rows"):
            starts = np.asarray(self.block_starts + [self.n], dtype=np.int64)
            out = []
            which = np.searchsorted(starts, rows, side="right") - 1
            for blk in np.unique(which):
                local = rows[which == blk] - starts[blk]
                out.append((self.blocks[int(blk)], local))
            return out


def _widened_f32(env: np.ndarray) -> np.ndarray:
    """float64 [n, 4] (xmin, ymin, xmax, ymax) envelopes -> float32 rounded
    outward one ulp, so the cast can never shrink a box out of a true
    overlap (the reference's DeviceSegment envelope packing)."""
    out = np.empty(env.shape, dtype=np.float32)
    for j, toward in enumerate((-np.inf, -np.inf, np.inf, np.inf)):
        out[:, j] = np.nextafter(env[:, j].astype(np.float32), np.float32(toward))
    return out


def segment_from_reference(arrays: Dict[str, np.ndarray], device: Device) -> DeviceSegment:
    """A port segment holding the same state as a reference (JAX)
    ``DeviceSegment``: ``arrays`` are its host arrays ``valid`` and the
    candidate columns of its kind (``xi, yi`` or ``bxmin .. bymax``, +
    ``bins, ti`` when binned) and, when its exact columns are loaded, the
    ``*_hi`` / ``*_lo`` uint32 key limbs and ``tvalid`` (points) or
    ``xz_limbs`` (the eight envelope key limbs), ``xz_isrect`` and, for xz3,
    ``xz_tk`` (two limbs) and ``xz_tvalid`` (extents), and when its raw
    columns are loaded ``xf, yf`` (+ ``t_ms`` for z3). The limbs join into
    the port's int64 keys; rows keep the reference's padding and the
    envelopes and raw coordinates their float32 bits."""
    device = default_device(device)
    extent = "bxmin" in arrays
    kind = ("xz" if extent else "z") + ("3" if "bins" in arrays else "2")
    cols = {k: np.array(arrays[k]) for k in ("valid",) + _CANDIDATE_COLUMNS[kind]}
    seg = DeviceSegment(kind, device, len(cols["valid"]), cols)
    if "xz_limbs" in arrays:
        limbs = [np.array(a) for a in arrays["xz_limbs"]]
        seg.xz_keys = tuple(
            upload(limbs_to_keys(limbs[2 * j], limbs[2 * j + 1]), device) for j in range(4)
        )
        seg.xz_isrect = upload(np.array(arrays["xz_isrect"]), device)
        if "xz_tk" in arrays:
            seg.xz_tk = upload(limbs_to_keys(*(np.array(a) for a in arrays["xz_tk"])), device)
            seg.xz_tvalid = upload(np.array(arrays["xz_tvalid"]), device)
        seg._exact_xz_loaded = True
    if "xk_hi" in arrays:
        seg.xk = upload(limbs_to_keys(arrays["xk_hi"], arrays["xk_lo"]), device)
        seg.yk = upload(limbs_to_keys(arrays["yk_hi"], arrays["yk_lo"]), device)
        if "tk_hi" in arrays:
            seg.tk = upload(limbs_to_keys(arrays["tk_hi"], arrays["tk_lo"]), device)
            seg.tvalid = upload(np.array(arrays["tvalid"]), device)
        seg._exact_loaded = True
    if "xf" in arrays:
        seg.xf = upload(np.array(arrays["xf"]), device)
        seg.yf = upload(np.array(arrays["yf"]), device)
        if "t_ms" in arrays:
            seg.t_ms = upload(np.array(arrays["t_ms"]), device)
        seg._raw_loaded = True
    return seg


class _PendingHits:
    """A dispatched segment scan: one fused RLE buffer en route to host.

    rows() fetches and decodes; run-capacity overflow recomputes at the
    escalated pow2 capacity (remembered on the segment), and fragmented
    dense results degrade to the packed bitmap."""

    __slots__ = ("seg", "rcap", "buf", "_refetch", "_packed", "_rows")

    def __init__(self, seg: DeviceSegment, rcap: int, buf, refetch, packed):
        self.seg = seg
        self.rcap = rcap
        self.buf = buf
        self._refetch = refetch  # rcap -> new runs buffer (device)
        self._packed = packed  # () -> packed bitmap (device)
        self._rows: Optional[np.ndarray] = None

    def rows(self) -> np.ndarray:
        if self._rows is None:  # cached: shared pendings resolve once
            self._rows = self._resolve()
        return self._rows

    def _resolve(self) -> np.ndarray:
        seg = self.seg
        buf = _np_local(self.buf)
        cnt, nruns = int(buf[0]), int(buf[1])
        seg.remember_rcap(nruns)
        if cnt == 0:
            return np.empty(0, dtype=np.int64)
        rcap = self.rcap
        if nruns > rcap:
            if nruns > max(1, seg.n_padded // DENSE_BITMAP_FACTOR):
                # fragmented + dense: the bitmap is the smaller transfer
                mask = np.unpackbits(_np_local(self._packed()))[: seg.n].astype(bool)
                return np.flatnonzero(mask)
            while rcap < nruns:
                rcap *= 2
            buf = _np_local(self._refetch(rcap))
        starts = buf[2 : 2 + nruns].astype(np.int64)
        lens = buf[2 + rcap : 2 + rcap + nruns].astype(np.int64)
        return _expand_runs(starts, lens)


def _shared_fetch_span(q: int):
    """The span around the fetch of a batched buffer that serves ``q``
    queries (the reference's ``device.fetch.shared``): the whole wait lands
    on the query that resolves first, and ``shared_q`` lets a reader
    apportion it across the batch."""
    return trace.span("device.fetch.shared", shared_q=int(q))


class _BitmapBatch:
    """One bitmap batch (headers + span windows), fetched once. Remembers
    the stream's widest span on the segment (once per batch)."""

    __slots__ = ("hdr", "bits", "span_cap", "seg", "_np")

    def __init__(self, hdr, bits, span_cap: int, seg: DeviceSegment):
        self.hdr = hdr
        self.bits = bits
        self.span_cap = span_cap
        self.seg = seg
        self._np = None

    def _fetch(self):
        if self._np is None:
            with _shared_fetch_span(self.hdr.shape[0]):
                self._np = (_np_local(self.hdr), _np_local(self.bits))
            self.hdr = self.bits = None
            h = self._np[0]
            spans = np.where(h[:, 0] > 0, h[:, 2] - h[:, 3] + 1, 0)
            self.seg.remember_span(int(spans.max(initial=0)))
        return self._np

    def header(self, i: int) -> np.ndarray:
        return self._fetch()[0][i]

    def query_bits(self, i: int) -> np.ndarray:
        return self._fetch()[1][i]


class _PendingBitmapHits:
    """One query's slice of a bitmap batch: unpacks the span window host
    side; a span wider than the window falls back to a single-query scan."""

    __slots__ = ("seg", "batch", "i", "_single", "_rows")

    def __init__(self, seg: DeviceSegment, batch: _BitmapBatch, i: int, single):
        self.seg = seg
        self.batch = batch
        self.i = i
        self._single = single  # () -> _PendingHits of this query alone
        self._rows: Optional[np.ndarray] = None

    def rows(self) -> np.ndarray:
        if self._rows is None:
            self._rows = self._resolve()
        return self._rows

    def _resolve(self) -> np.ndarray:
        cnt, _lo, hi, start = (int(v) for v in self.batch.header(self.i))
        if cnt == 0:
            return np.empty(0, dtype=np.int64)
        if hi - start + 1 > self.batch.span_cap:
            return self._single().rows()
        return _decode_bitmap_rows(self.batch.query_bits(self.i), start, cnt)


class _PendingXZHits:
    """A dispatched extent segment scan: dual fused RLE buffers (hit +
    decided runs) en route to host. rows() -> (hit_rows, decided_rows),
    both sorted; decided_rows is a subset of hit_rows. Overflow of either
    run set escalates; fragmented dense results degrade to the two packed
    planes."""

    __slots__ = ("seg", "rcap", "buf", "_refetch", "_packed", "_rows")

    def __init__(self, seg: DeviceSegment, rcap: int, buf, refetch, packed):
        self.seg = seg
        self.rcap = rcap
        self.buf = buf
        self._refetch = refetch  # rcap -> new dual runs buffer (device)
        self._packed = packed  # () -> both packed planes (device)
        self._rows = None

    def rows(self):
        if self._rows is None:
            self._rows = self._resolve()
        return self._rows

    @staticmethod
    def _one(buf, rcap):
        nruns = int(buf[1])
        starts = buf[2 : 2 + nruns].astype(np.int64)
        lens = buf[2 + rcap : 2 + rcap + nruns].astype(np.int64)
        return _expand_runs(starts, lens)

    def _resolve(self):
        seg = self.seg
        buf = _np_local(self.buf)
        rcap = self.rcap
        half = 2 + 2 * rcap
        hit_b, dec_b = buf[:half], buf[half:]
        nruns = max(int(hit_b[1]), int(dec_b[1]))
        seg.remember_rcap(nruns)
        if int(hit_b[0]) == 0:
            empty = np.empty(0, dtype=np.int64)
            return empty, empty
        if nruns > rcap:
            if nruns > max(1, seg.n_padded // DENSE_BITMAP_FACTOR):
                # fragmented + dense: the two bitmaps are the smaller transfer
                both = _np_local(self._packed())
                h = len(both) // 2
                with record_function("geomesa.decode"):
                    hm = np.unpackbits(both[:h])[: seg.n].astype(bool)
                    dm = np.unpackbits(both[h:])[: seg.n].astype(bool)
                    return np.flatnonzero(hm), np.flatnonzero(dm)
            while rcap < nruns:
                rcap *= 2
            buf = _np_local(self._refetch(rcap))
            half = 2 + 2 * rcap
            hit_b, dec_b = buf[:half], buf[half:]
        return self._one(hit_b, rcap), self._one(dec_b, rcap)


class _PendingXZBitmapHits:
    """One extent query's slice of a dual bitmap batch: rows() ->
    (hit_rows, decided_rows) from its hit and decided windows; a span wider
    than the window falls back to a single-query dual scan."""

    __slots__ = ("seg", "batch", "i", "_single", "_rows")

    def __init__(self, seg: DeviceSegment, batch: _BitmapBatch, i: int, single):
        self.seg = seg
        self.batch = batch
        self.i = i
        self._single = single  # () -> _PendingXZHits of this query alone
        self._rows = None

    def rows(self):
        if self._rows is None:
            self._rows = self._resolve()
        return self._rows

    def _resolve(self):
        cnt, _lo, hi, start = (int(v) for v in self.batch.header(self.i))
        if cnt == 0:
            empty = np.empty(0, dtype=np.int64)
            return empty, empty
        if hi - start + 1 > self.batch.span_cap:
            return self._single().rows()
        both = self.batch.query_bits(self.i)
        h = len(both) // 2
        return (
            _decode_bitmap_rows(both[:h], start, cnt),
            _decode_bitmap_rows(both[h:], start, cnt),  # decided <= hit
        )


# set bits of each byte value
_POPCOUNT8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(
    axis=1, dtype=np.uint8)


def _decode_full_bitmap_rows(packed: np.ndarray, n: int) -> np.ndarray:
    """Full-table packed plane -> the row indices below ``n``: a popcount
    table sizes the native decode (``_decode_bitmap_rows``). Pad rows are
    never valid, so the bound check is belt and braces."""
    cnt = int(_POPCOUNT8[packed].sum(dtype=np.int64))
    rows = _decode_bitmap_rows(packed, 0, cnt)
    if len(rows) and rows[-1] >= n:
        rows = rows[rows < n]
    return rows


class _MaskBatch:
    """One coalesced mask batch: u8[q, n/8] full-table planes on the device,
    fetched once. ``prefetch``-able: the coalescer copies the shared buffer
    inside its own cost collector, so the bytes split across the members."""

    __slots__ = ("buf", "n_rows", "_np")

    def __init__(self, buf, n_rows: int):
        self.buf = buf
        self.n_rows = n_rows  # the segment's real rows
        self._np = None

    def _fetch(self) -> np.ndarray:
        if self._np is None:
            with _shared_fetch_span(self.buf.shape[0]):
                self._np = _np_local(self.buf)
            self.buf = None
        return self._np


class _PendingMaskHits:
    """One query's row of a mask batch: its full-table plane decoded (no
    span window, no refetch: the plane covers every row)."""

    __slots__ = ("batch", "i", "_rows")

    def __init__(self, batch: _MaskBatch, i: int):
        self.batch = batch
        self.i = i
        self._rows: Optional[np.ndarray] = None

    def prefetch(self) -> None:
        self.batch._fetch()

    def rows(self) -> np.ndarray:
        if self._rows is None:
            self._rows = _decode_full_bitmap_rows(self.batch._fetch()[self.i], self.batch.n_rows)
        return self._rows


class _DualMaskBatch:
    """One coalesced dual-plane batch: (hit, decided) u8[q, n/8] on the
    device, fetched once, ``prefetch``-able as ``_MaskBatch``."""

    __slots__ = ("hit", "dec", "n_rows", "_np")

    def __init__(self, hit, dec, n_rows: int):
        self.hit = hit
        self.dec = dec
        self.n_rows = n_rows
        self._np = None

    def _fetch(self):
        if self._np is None:
            with _shared_fetch_span(self.hit.shape[0]):
                self._np = (_np_local(self.hit), _np_local(self.dec))
            self.hit = self.dec = None
        return self._np


class _PendingDualMaskHits:
    """One extent or polygon query's planes of a dual mask batch: rows() ->
    (hit_rows, decided_rows), both sorted, decided a subset of hit (the
    ``_XZBatchScan`` contract)."""

    __slots__ = ("batch", "i", "_rows")

    def __init__(self, batch: _DualMaskBatch, i: int):
        self.batch = batch
        self.i = i
        self._rows = None

    def prefetch(self) -> None:
        self.batch._fetch()

    def rows(self):
        if self._rows is None:
            h, d = self.batch._fetch()
            n = self.batch.n_rows
            self._rows = (_decode_full_bitmap_rows(h[self.i], n),
                          _decode_full_bitmap_rows(d[self.i], n))
        return self._rows


def _ring_split(hit_rows: np.ndarray, dec_rows: np.ndarray) -> np.ndarray:
    """Ring = hits not device-decided (both inputs sorted): membership via
    one searchsorted merge."""
    if not len(hit_rows):
        return hit_rows
    in_dec = np.zeros(len(hit_rows), dtype=bool)
    if len(dec_rows):
        pos = np.searchsorted(dec_rows, hit_rows)
        pos = np.minimum(pos, len(dec_rows) - 1)
        in_dec = dec_rows[pos] == hit_rows
    return hit_rows[~in_dec]


def _extent_ring_test(node, geom):
    """The extent dual scans' ring test: the host's exact per-geometry
    test, a row at a time. -> test(block, local_rows) -> bool mask."""
    from geomesa_tpu_torch.filter.evaluate import _geom_predicate

    def test(block, local):
        geoms = block.gather(geom, local)
        return np.fromiter(
            (g is not None and _geom_predicate(node, g) for g in geoms), bool, len(local)
        )

    return test


def _point_ring_test(node, geom):
    """The polygon dual scans' ring test over points, whose schemas hold
    coordinates, not geometry objects: the host post-filter's vectorized
    point test, at once. -> test(block, local_rows) -> bool mask."""
    from geomesa_tpu_torch.geom.predicates import points_in_geometry

    def test(block, local):
        m = points_in_geometry(block.gather(geom + "__x", local),
                               block.gather(geom + "__y", local), node.geometry)
        m &= ~block.gather(geom + "__null", local).astype(bool)
        return m

    return test


def _yield_xz_rows(seg: DeviceSegment, dec_rows: np.ndarray, ring: np.ndarray, ring_test):
    """Tail of every dual-plane device scan: ring rows (hit but not
    decided) take the host's ``ring_test``, decided rows are final. Yields
    (block, local_rows)."""
    if len(ring):
        for block, local in seg.to_block_rows(np.sort(ring)):
            with record_function("geomesa.ring"):
                m = ring_test(block, local)
            if m.any():
                yield block, local[m]
    if len(dec_rows):
        yield from seg.to_block_rows(np.sort(dec_rows))


def _count_dual_resolve(pendings, ring_test) -> int:
    """The count of every dual-plane dispatch (extent envelopes and banded
    polygons; the reference's ``_count_dual_resolve``): the decided rows,
    decoded and counted, plus the ring rows (hit, not decided) that pass the
    host's ``ring_test``. ``pendings`` = [(segment, dual pending)]."""
    total = 0
    for seg, ph in pendings:
        hit_rows, dec_rows = ph.rows()
        total += len(dec_rows)
        ring = _ring_split(hit_rows, dec_rows)
        for _block, local in _yield_xz_rows(seg, dec_rows[:0], ring, ring_test):
            total += len(local)
    return total


class _XZBatchScan:
    """Extent (and banded polygon) scans resolved against the plan's own
    spatial node: decided rows are final; the ring (hit minus decided)
    takes the host's ``ring_test`` (``_extent_ring_test`` or
    ``_point_ring_test``). ``exact`` is True: the yielded rows ARE the
    result set (the valid columns carry the null dates)."""

    __slots__ = ("pending", "ring_test", "exact")

    def __init__(self, pending, ring_test):
        self.pending = pending  # [(seg, _PendingXZHits | _PendingXZBitmapHits)]
        self.ring_test = ring_test
        self.exact = True

    def __iter__(self):
        for seg, ph in self.pending:
            hit_rows, dec_rows = ph.rows()
            if not len(hit_rows):
                continue
            ring = _ring_split(hit_rows, dec_rows)
            yield from _yield_xz_rows(seg, dec_rows, ring, self.ring_test)


class _PendingScan:
    """All of one table's dispatched segment scans; iterating resolves them
    in order and maps segment-local rows back to (block, local rows).
    ``exact=True`` marks hits of the EXACT predicate: the caller skips its
    host post-filter."""

    __slots__ = ("pending", "exact")

    def __init__(self, pending, exact: bool = False):
        self.pending = pending
        self.exact = exact

    def __iter__(self):
        for seg, ph in self.pending:
            yield from seg.to_block_rows(ph.rows())


def _merge_overlapping_intervals(starts, ends, flags):
    """Coalesce overlapping [start, end) row intervals (flags AND-merge:
    False is safe in both seek modes, the row merely takes the test it
    would pass anyway). Disjoint inputs return unchanged."""
    if len(starts) <= 1:
        return starts, ends, flags
    order = np.argsort(starts, kind="stable")
    s, e, f = starts[order], ends[order], flags[order]
    run_end = np.maximum.accumulate(e)
    if (s[1:] >= run_end[:-1]).all():
        return s, e, f  # already disjoint (sorted)
    heads = np.flatnonzero(np.concatenate(([True], s[1:] >= run_end[:-1])))
    return (
        s[heads],
        np.maximum.reduceat(e, heads),
        np.minimum.reduceat(f.astype(np.int8), heads).astype(bool),
    )


class _HostSeekScan:
    """A host searchsorted block seek in the scan shape: the executor chose
    seeking over a device dispatch for a selective plan (the reference's
    ``_HostSeekScan``). It carries the per-block (starts, ends, flags)
    intervals the chooser's cost probe computed; rows expand at iteration.

    Without ``pred``, ``exact`` is False and iteration yields (block, rows,
    covered) triples: ``covered`` rows came from ``contained`` ranges and
    satisfy the plan's primary predicate, so the caller applies only the
    residual (secondary) filter to them. With ``pred`` (the query reduced
    to one exact box(+window) on a point index, or one spatial predicate on
    an xz2 index, and the C++ seek-scan library loaded) iteration runs the
    one-pass C++ scan, ``exact`` is True and the yielded (block, rows) ARE
    the result set."""

    __slots__ = ("table", "per_block", "pred", "exact")

    def __init__(self, table: IndexTable, per_block, pred=None):
        self.exact = pred is not None
        self.table = table
        self.per_block = per_block
        self.pred = pred

    def __iter__(self):
        """Each block's rows, tombstoned rows stripped (``table.
        tombstone_keep``, after every seek edition)."""
        if self.pred is None:
            ft = self.table.ft
            # a null date's key comes from its stored date: a contained
            # range of a temporal index may hold it, so it takes the full
            # filter (which rejects it for a temporal predicate)
            dtg = (ft.default_date.name if ft.default_date is not None
                   and self.table.index.name in ("z3", "xz3") else None)
            for block, starts, ends, flags in self.per_block:
                with record_function("geomesa.seek"):
                    rows, covered = self.table.expand_covered(block, starts, ends, flags)
                    if dtg is not None and block.has_nulls(dtg) and covered.any():
                        covered = covered & ~block.gather(dtg + "__null", rows)
                if len(rows):
                    yield block, rows, covered
            return
        found = self._iter_native_xz() if self.pred[0] == "xz" else self._iter_native()
        for block, rows in found:
            keep = self.table.tombstone_keep(block, rows)
            if keep is not None:
                rows = rows[keep]
            if len(rows):
                yield block, rows

    def _iter_native_xz(self):
        """Extent plans: the C++ envelope scan decides overlap and inside
        per candidate row; only the boundary ring takes the exact
        per-geometry test."""
        from geomesa_tpu_torch.filter.evaluate import _eval_spatial, _geom_predicate

        _, geom, node, qenv, rect = self.pred
        qbox = (qenv.xmin, qenv.ymin, qenv.xmax, qenv.ymax)
        for block, starts, ends, flags in self.per_block:
            bx = block.columns[geom + "__bxmin"]
            by = block.columns[geom + "__bymin"]
            cx = block.columns[geom + "__bxmax"]
            cy = block.columns[geom + "__bymax"]
            with record_function("geomesa.seek"):
                got = env_seek_scan_native(
                    bx, by, cx, cy, starts, ends, qbox, rect,
                    isrect=block.columns.get(geom + "__isrect"),
                )
            if got is None:
                # the library became unavailable (GEOMESA_TPU_NO_NATIVE):
                # the same rules through the host's vectorized prescreen
                cand, _cov = expand_intervals(starts, ends, flags)
                if not len(cand):
                    continue
                sub = {geom: block.gather(geom, cand)}
                for sfx, col in (("__bxmin", bx), ("__bymin", by), ("__bxmax", cx),
                                 ("__bymax", cy)):
                    sub[geom + sfx] = col[cand]
                final = cand[_eval_spatial(node, self.table.ft, sub)]
                if len(final):
                    yield block, final
                continue
            rows, decided = got
            if not len(rows):
                continue
            ring = rows[~decided]
            if len(ring):
                with record_function("geomesa.ring"):
                    geoms = block.gather(geom, ring)
                    keep = np.fromiter(
                        (g is not None and _geom_predicate(node, g) for g in geoms),
                        bool,
                        len(ring),
                    )
                final = np.sort(np.concatenate([rows[decided], ring[keep]]))
            else:
                final = rows[decided]
            if len(final):
                yield block, final

    def _iter_native(self):
        """Point plans: the C++ one-pass box(+window) test over the
        candidate intervals of the block's own sorted x/y(/t) columns; the
        blocks of an attribute or id plan (no coordinates of their own)
        gather their candidates' coordinates from the record first."""
        _z, geom, dtg, box, t_lo, t_hi, use_covered = self.pred
        want_t = t_lo is not None or t_hi is not None
        lo = _INT64_MIN + 1 if t_lo is None else t_lo
        hi = _INT64_MAX if t_hi is None else t_hi
        for block, starts, ends, flags in self.per_block:
            if not use_covered:
                flags = np.zeros(len(starts), dtype=bool)
            # the scan takes intervals verbatim: overlapping ones (z ranges
            # arrive disjoint, OR'd attribute ranges need not) would emit
            # shared rows once per interval
            starts, ends, flags = _merge_overlapping_intervals(starts, ends, flags)
            cand = None
            with record_function("geomesa.seek"):
                if geom + "__x" in block.columns:
                    xs = block.columns[geom + "__x"]
                    ys = block.columns[geom + "__y"]
                    t = block.full_col(dtg) if want_t else None
                    kstarts, kends, kflags = starts, ends, flags
                else:
                    cand, _cov = expand_intervals(starts, ends, flags)
                    if not len(cand):
                        continue
                    xs = block.gather(geom + "__x", cand)
                    ys = block.gather(geom + "__y", cand)
                    t = block.gather(dtg, cand) if want_t else None
                    kstarts = np.zeros(1, dtype=np.int64)
                    kends = np.full(1, len(cand), dtype=np.int64)
                    kflags = np.zeros(1, dtype=bool)
                rows = seek_scan_native(xs, ys, t, kstarts, kends, kflags, box, lo, hi)
                if rows is None:
                    # the library became unavailable (GEOMESA_TPU_NO_NATIVE):
                    # numpy edition of the same exact test
                    if cand is None:
                        cand, _cov = expand_intervals(starts, ends, flags)
                        xs, ys = xs[cand], ys[cand]
                        t = t[cand] if want_t else None
                    m = (xs >= box[0]) & (xs <= box[2]) & (ys >= box[1]) & (ys <= box[3])
                    if want_t:
                        m &= (t >= lo) & (t <= hi)
                    rows = cand[m]
                elif cand is not None:
                    rows = cand[rows]  # scan positions -> block rows
            if len(rows):
                yield block, rows


class DeviceIndex:
    """Segmented device-resident mirror of one index table: appended blocks
    become new segments, new tombstones flip valid bits of the resident
    segments (``DeviceSegment.apply_tombstones``), and past MAX_SEGMENTS
    (or after blocks were rewritten: a compaction) the mirror rebuilds as
    one merged segment."""

    def __init__(self, device: torch.device, table: IndexTable):
        self.device = device
        self.segments: List[DeviceSegment] = []
        self.version = -1
        self._n_tombstones = 0
        self.refresh(table)

    def refresh(self, table: IndexTable) -> None:
        if table.version == self.version:
            return
        synced = [i for s in self.segments for i in s.block_ids]
        if [id(b) for b in table.blocks[: len(synced)]] != synced:
            self.segments, synced = [], []
            self._n_tombstones = 0
        new_blocks = table.blocks[len(synced):]
        fresh = None
        if new_blocks and len(self.segments) >= MAX_SEGMENTS:
            fresh = DeviceSegment.from_blocks(table, table.blocks, self.device)
            self.segments = [fresh]
        elif new_blocks:
            fresh = DeviceSegment.from_blocks(table, new_blocks, self.device)
            self.segments.append(fresh)
        if fresh is not None and table.tombstones:
            fresh.apply_tombstones(table)
        if len(table.tombstones) != self._n_tombstones:
            for seg in self.segments:
                if seg is not fresh:
                    seg.apply_tombstones(table)
            self._n_tombstones = len(table.tombstones)
        self.version = table.version


class HostRoute:
    """What a guarded device call returns when the host must answer: the
    circuit is open (``HOST_BREAKER``) or the device call failed and
    degraded (``HOST_DEGRADED``). ``label`` is the scan route the store
    reports."""

    __slots__ = ("label",)

    def __init__(self, label: str):
        self.label = label

    def __repr__(self) -> str:
        return f"HostRoute({self.label!r})"


HOST_BREAKER = HostRoute("host-table-breaker")
HOST_DEGRADED = HostRoute("host-table-degraded")


class TorchScanExecutor:
    """Pluggable executor for TorchDataStore: device pre-filter for
    z2/z3/xz2/xz3 plans (None elsewhere: the store scans the host blocks);
    also evaluates the exact post-filter (numpy) on candidates.

    The device circuit breaker (``breaker``, ``utils/breaker.py``) guards
    every device call the store makes: ``scan_candidates``,
    ``dispatch_many``, ``dispatch_coalesced`` and, through ``push_down``,
    the count, stats, density, kNN and pyramid builds. A device failure
    degrades (``degrade``): the table's mirror is evicted, the breaker
    takes a strike and the host table scan answers; while the circuit is
    open no device work is attempted. A ``QueryTimeout`` or a fault of a
    hand kernel (``kernels.KernelError``: it failed to build, was called
    with arguments it does not take, or its launch failed) degrades
    nothing: it strikes no breaker, releases a half-open probe slot and
    raises."""

    # one batched launch answers at most this many queries
    BATCH_MAX = 64

    def __init__(self, device: Optional[Device] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.device = default_device(device)
        # id() keys can be recycled after GC, so each entry holds a weakref
        # to its table: identity is re-checked on hit
        self._cache: Dict[int, Tuple[weakref.ref, DeviceIndex]] = {}
        self._cache_lock = threading.RLock()
        self.breaker = breaker if breaker is not None else CircuitBreaker("device")

    def device_index(self, table: IndexTable) -> DeviceIndex:
        # one lock: concurrent queries of one table share one mirror
        with self._cache_lock:
            for k in [k for k, (ref, _) in self._cache.items() if ref() is None]:
                del self._cache[k]
            entry = self._cache.get(id(table))
            if entry is not None and entry[0]() is table:
                entry[1].refresh(table)
                return entry[1]
            dev = DeviceIndex(self.device, table)
            self._cache[id(table)] = (weakref.ref(table), dev)
            return dev

    def supports(self, table: IndexTable, plan: QueryPlan) -> bool:
        return (
            table.index.name in ("z3", "z2", "xz3", "xz2")
            and not plan.values.disjoint
            and bool(plan.values.spatial_envelopes)
        )

    @staticmethod
    def _has_visibilities(table: IndexTable) -> bool:
        """Whether a row of the table carries a visibility label: the
        push-downs that hand back no rows (count, stats, density, kNN)
        decline, since only the host's per-row auth check may decide what
        a caller sees."""
        return any(b.has_col("__vis__") for b in table.blocks)

    def _scan_eligible(self, table: IndexTable, plan: QueryPlan) -> bool:
        """Shared gate for any device dispatch: index family supported and
        binned (z3/xz3) plans have bins."""
        if not self.supports(table, plan):
            return False
        return not (table.index.name in ("z3", "xz3") and not plan.values.bins)

    _DESC_UNSET = object()  # sentinel: caller did not precompute desc

    def dispatch_candidates(self, table: IndexTable, plan: QueryPlan):
        """Start the scan of one plan; None -> the caller scans host ranges.
        A selective plan takes the host seek (``_seek_scan``); otherwise
        pure bbox(+interval) point filters take the EXACT route (no host
        post-filter), one spatial predicate on an extent table (+ xz3 time
        bounds) the DUAL route, everything else the candidate route."""
        seek = self._seek_scan(table, plan)
        if seek is not None:
            return seek
        return self._dispatch_nonseek(table, plan)

    def scan_candidates(self, table: IndexTable, plan: QueryPlan):
        """``dispatch_candidates`` under the breaker envelope (the
        reference's ``scan_candidates``): None or a host seek when the
        executor declines the device (a half-open probe slot is released),
        ``HOST_BREAKER`` while the circuit is open (no dispatch at all),
        ``HOST_DEGRADED`` after a dispatch failure (``degrade`` ran). The
        store answers the last two from the host table scan; a failure
        while the scan resolves degrades in the store the same way."""
        if not self.breaker.allow():
            trace.event("breaker.short_circuit", breaker=self.breaker.name)
            return HOST_BREAKER
        try:
            scan = self.dispatch_candidates(table, plan)
        except (QueryTimeout, kernels.KernelError):
            # no verdict on the link: no degrade, no strike, no eviction
            self.breaker.cancel_probe()
            raise
        except Exception as e:
            self.degrade(table, e)
            return HOST_DEGRADED
        if scan is None or isinstance(scan, _HostSeekScan):
            # no device boundary was crossed: the probe slot is released
            self.breaker.cancel_probe()
        return scan

    def push_down(self, table: Optional[IndexTable], fn, *args):
        """One device call that answers whole (a count, stats, density,
        kNN or pyramid build) under the breaker envelope: ``fn(*args)``,
        None when it declines, ``HOST_BREAKER`` while the circuit is open,
        ``HOST_DEGRADED`` after a failure (``degrade`` ran). A value other
        than None closes a half-open circuit."""
        if not self.breaker.allow():
            trace.event("breaker.short_circuit", breaker=self.breaker.name)
            return HOST_BREAKER
        try:
            got = fn(*args)
        except (QueryTimeout, kernels.KernelError):
            self.breaker.cancel_probe()
            raise
        except Exception as e:
            self.degrade(table, e)
            return HOST_DEGRADED
        if got is None:
            self.breaker.cancel_probe()
        else:
            self.record_device_success()
        return got

    def record_device_success(self) -> None:
        """A device scan resolved cleanly end to end (the store calls this
        after consuming one): closes a half-open circuit, whose probe query
        has just rebuilt the mirror it needed."""
        self.breaker.record_success()

    def _dispatch_nonseek(self, table: IndexTable, plan: QueryPlan, desc=_DESC_UNSET):
        """The device dispatch after the seek choice declined. ``desc`` lets
        dispatch_many pass an already-computed exact point descriptor."""
        if not self._scan_eligible(table, plan):
            return None
        if desc is TorchScanExecutor._DESC_UNSET:
            desc = self._exact_descriptor(table, plan)
        dev = self.device_index(table)
        if desc is not None:
            box_np, win_np = desc
            box_dev = upload(box_np, self.device)
            win_dev = None if win_np is None else upload(win_np, self.device)
            pending = []
            for seg in dev.segments:
                deadline.check("device.dispatch")
                seg.load_exact(table)
                pending.append((seg, seg.dispatch_exact(box_dev, win_dev)))
            return _PendingScan(pending, exact=True)
        xz = self._xz_batch_desc(table, plan)
        if xz is not None and xz[4] is None:
            # a lone extent query AND attribute predicates takes the
            # candidate route, as the reference's lone extent queries do
            return self._dispatch_xz_single(table, dev, *xz[:4])
        boxes_dev, windows_dev = self._query_descriptor(table, plan)
        pending = []
        for seg in dev.segments:
            deadline.check("device.dispatch")
            pending.append((seg, seg.dispatch_hits(boxes_dev, windows_dev)))
        return _PendingScan(pending)

    def _dispatch_xz_single(self, table: IndexTable, dev: DeviceIndex, qdesc: np.ndarray,
                            has_time: bool, geom: str, node) -> _XZBatchScan:
        """One extent query on the dual route: ``xz_dual_bitmap`` with q = 1
        per segment."""
        desc_dev = upload(qdesc, self.device)
        pending = []
        for seg in dev.segments:
            seg.load_exact_xz(table)
            pending.append((seg, seg.dispatch_exact_xz(desc_dev, has_time)))
        return _XZBatchScan(pending, _extent_ring_test(node, geom))

    @staticmethod
    def _attr_ready(table: IndexTable, dev: DeviceIndex, attr: Optional[str], kind: Optional[str],
                    xz: bool = False) -> bool:
        """Whether every segment can take the attribute plane of ``attr``
        in the edition ``kind`` (no attribute: no plane): its codes load
        (not an object column) and, for vocabmask, its value space fits the
        lookup. Loads the exact columns the plane rides on (``xz``: the
        extents')."""
        for seg in dev.segments:
            if xz:
                seg.load_exact_xz(table)
            else:
                seg.load_exact(table)
        if attr is None:
            return True
        return all(seg.load_attr_codes(attr) for seg in dev.segments) and (
            kind != "vocabmask" or all(seg.attr_vocab_ok(attr) for seg in dev.segments))

    def degrade(self, table: Optional[IndexTable], exc: BaseException) -> None:
        """Record a device -> host degradation (the reference's
        ``degrade``): evict the failed table's device mirror (None evicts
        every mirror: a batched dispatch failed mid-stream) so the next
        query that wants it rebuilds it from the host table, strike the
        breaker, count ``degrade.device_to_host`` (and
        ``degrade.mirror_rebuilds`` per mirror evicted) in
        ``robustness_metrics()``, record the decision and write one stderr
        line. The caller answers from the host table scan."""
        import sys

        with self._cache_lock:
            if table is None:
                evicted = len(self._cache)
                self._cache.clear()
            else:
                evicted = int(self._cache.pop(id(table), None) is not None)
        self.breaker.record_failure()
        m = robustness_metrics()
        m.inc("degrade.device_to_host")
        if evicted:
            m.inc("degrade.mirror_rebuilds", evicted)
        trace.event("degrade.device_to_host", reason=f"{type(exc).__name__}: {exc}",
                    mirrors_evicted=evicted)
        audit.decision("degrade", "device_to_host", error=type(exc).__name__,
                       mirrors_evicted=evicted)
        sys.stderr.write(f"[executor] device scan failed ({type(exc).__name__}: {exc}); "
                         "host path answers; mirror marked for rebuild\n")

    def dispatch_many(self, items: Sequence[Tuple[IndexTable, QueryPlan]]):
        """Dispatch a query stream; returns {id(plan): scan | None}.

        Each plan first meets the seek choice (``_seek_scan``). Of the
        rest, point plans whose full filter reduces to one exact
        box(+window) test on the same table fuse into ONE ``exact_bitmap``
        launch per segment, as do those that add predicates on one
        attribute (per attribute and edition: ``_drain_attr_batches``),
        extent plans with a dual descriptor into ONE ``xz_dual_bitmap``
        launch and point plans of one non-rectangular polygon (+ window)
        into ONE ``poly_dual_bitmap`` launch (chunks of BATCH_MAX), the dual
        groups also per attribute and edition of their attribute plane; the
        others dispatch as dispatch_candidates would."""
        out: Dict[int, object] = {}
        if not self.breaker.allow():
            # an open circuit: the whole batch takes the host path
            trace.event("breaker.short_circuit", breaker=self.breaker.name)
            return {id(plan): HOST_BREAKER for _table, plan in items}
        try:
            self._dispatch_many_batches(items, out)
        except (QueryTimeout, kernels.KernelError):
            self.breaker.cancel_probe()
            raise
        # any other failure reaches ``degrade`` in the caller, whose strike
        # settles a half-open probe
        return out

    def _dispatch_many_batches(self, items: Sequence[Tuple[IndexTable, QueryPlan]],
                               out: Dict[int, object], seek_declined=frozenset()) -> None:
        """``dispatch_many``'s body, into ``out``. ``seek_declined`` holds
        the ids of plans whose seek probe already ran and declined
        (``dispatch_coalesced``): they skip the probe here."""
        batchable: Dict[tuple, Tuple[IndexTable, bool, list]] = {}
        attr_batchable: Dict[tuple, Tuple[IndexTable, bool, str, str, list]] = {}
        xz_batchable: Dict[tuple, Tuple[IndexTable, bool, Optional[str], Optional[str], list]] = {}
        poly_batchable: Dict[tuple, Tuple[IndexTable, bool, Optional[str], Optional[str], list]] = {}
        for table, plan in items:
            if id(plan) in out:
                continue
            deadline.check("device.dispatch")
            seek = None if id(plan) in seek_declined else self._seek_scan(table, plan)
            if seek is not None:
                out[id(plan)] = seek
                continue
            eligible = self._scan_eligible(table, plan)
            desc = self._exact_descriptor(table, plan) if eligible else None
            adesc = self._attr_batch_desc(table, plan) if eligible and desc is None else None
            if adesc is not None:
                attr, akind, d = adesc
                has_time = d[1] is not None
                group = attr_batchable.setdefault(
                    (id(table), has_time, attr, akind), (table, has_time, attr, akind, []))
                group[4].append((id(plan), plan, d))
                out[id(plan)] = None  # placeholder, filled below
                continue
            if desc is None:
                poly = self._poly_batch_desc(table, plan) if eligible else None
                if poly is not None:
                    edges, box_np, win_np, has_time, geom, node, ainfo = poly
                    attr, akind = ainfo[:2] if ainfo else (None, None)
                    # the payload rides in the descriptor: dispatch_poly_batch reads it
                    d = (edges, box_np, win_np) + ((ainfo[2],) if ainfo else ())
                    group = poly_batchable.setdefault(
                        (id(table), has_time, attr, akind), (table, has_time, attr, akind, []))
                    group[4].append((id(plan), plan, d, geom, node))
                    out[id(plan)] = None  # placeholder, filled below
                    continue
                xz = self._xz_batch_desc(table, plan) if eligible else None
                if xz is not None:
                    qdesc, has_time, geom, node, ainfo = xz
                    attr, akind = ainfo[:2] if ainfo else (None, None)
                    group = xz_batchable.setdefault(
                        (id(table), has_time, attr, akind), (table, has_time, attr, akind, []))
                    group[4].append((id(plan), plan, qdesc, ainfo, geom, node))
                    out[id(plan)] = None  # placeholder, filled below
                    continue
                out[id(plan)] = self._dispatch_nonseek(table, plan, desc=None)
                continue
            has_time = desc[1] is not None
            group = batchable.setdefault((id(table), has_time), (table, has_time, []))
            group[2].append((id(plan), plan, desc))
            out[id(plan)] = None  # placeholder, filled below
        for table, has_time, lst in batchable.values():
            dev = self.device_index(table)
            for seg in dev.segments:
                seg.load_exact(table)
            # seed once from the WHOLE stream's plans (not per chunk)
            self._seed_spans(dev, [p for _pid, p, _d in lst])
            for i in range(0, len(lst), self.BATCH_MAX):
                chunk = lst[i : i + self.BATCH_MAX]
                if len(chunk) == 1:
                    pid, plan, d = chunk[0]
                    out[pid] = self._dispatch_nonseek(table, plan, desc=d)
                    continue
                descs = [d for _pid, _p, d in chunk]
                per_seg = [seg.dispatch_exact_batch(descs, has_time) for seg in dev.segments]
                for qi, (pid, _plan, _d) in enumerate(chunk):
                    out[pid] = _PendingScan(
                        [(seg, phs[qi]) for seg, phs in zip(dev.segments, per_seg)],
                        exact=True,
                    )
        self._drain_attr_batches(out, attr_batchable)
        self._drain_xz_batches(out, xz_batchable)
        self._drain_poly_batches(out, poly_batchable)

    def dispatch_coalesced(self, items: Sequence[Tuple[IndexTable, QueryPlan]]):
        """Dispatch a COALESCED query group (the reference's
        ``dispatch_coalesced``, the seam of ``parallel/batch.py``); returns
        {id(plan): scan | None}.

        Plans whose full filter the device evaluates stack into ONE
        full-table mask sweep per segment and group: box(+window) point
        plans and those with one attribute's predicates
        (``dispatch_exact_mask_batch``, per attribute and edition), extent
        plans and non-rectangular polygons on point tables
        (``dispatch_dual_mask_batch``, resolved through ``_XZBatchScan``).
        No span framing and no run capacity: one n/8-byte plane a query.

        A plan that cannot ride a stacked sweep declines with a reason
        (``audit.decision("coalesce", <reason>)``) and takes the path a
        ``query_many`` batch would (``_dispatch_many_batches``):

        * ``seek_cheaper``       the cost chooser picked the host seek
        * ``kernel_ineligible``  no mask edition takes the plan's shape
        * ``lone_member``        nothing shares its group
        * ``mirror_unloadable``  a segment lacks the columns the edition
                                 needs (an object attribute, a value space
                                 past the vocabmask lookup)

        ``batch.coalesce.plans.stacked`` and ``.rest`` count the split.
        Same breaker envelope as ``dispatch_many``: an open circuit answers
        the whole group from the host path, and a failure raises to the
        coalescer, which runs the members solo."""
        out: Dict[int, object] = {}
        if not self.breaker.allow():
            trace.event("breaker.short_circuit", breaker=self.breaker.name)
            return {id(plan): HOST_BREAKER for _table, plan in items}
        try:
            return self._dispatch_coalesced(items, out)
        except (QueryTimeout, kernels.KernelError):
            self.breaker.cancel_probe()
            raise

    def _dispatch_coalesced(self, items: Sequence[Tuple[IndexTable, QueryPlan]],
                            out: Dict[int, object]):
        """``dispatch_coalesced``'s body, into ``out``."""
        # (id(table), has_time, extra) -> (table, has_time, extra, [(pid, plan, desc)]);
        # extra = None | (attr, edition)
        mask_groups: Dict[tuple, tuple] = {}
        # (kind, id(table), has_time, extra) -> (kind, table, has_time, extra,
        # [(pid, plan, desc, ring_test)])
        dual_groups: Dict[tuple, tuple] = {}
        rest: List[Tuple[IndexTable, QueryPlan]] = []
        seen: set = set()
        seek_probed: set = set()
        for table, plan in items:
            if id(plan) in seen:
                continue
            seen.add(id(plan))
            deadline.check("device.dispatch")
            seek = self._seek_scan(table, plan)
            seek_probed.add(id(plan))
            if seek is not None:
                audit.decision("coalesce", "seek_cheaper", index=table.index.name)
                out[id(plan)] = seek
                continue
            if self._scan_eligible(table, plan):
                desc = self._exact_descriptor(table, plan)
                extra = None
                if desc is None:
                    adesc = self._attr_batch_desc(table, plan)
                    if adesc is not None:
                        extra, desc = adesc[:2], adesc[2]
                if desc is not None:
                    has_time = desc[1] is not None
                    group = mask_groups.setdefault((id(table), has_time, extra),
                                                   (table, has_time, extra, []))
                    group[3].append((id(plan), plan, desc))
                    continue
                poly = self._poly_batch_desc(table, plan)
                if poly is not None:
                    edges, box_np, win_np, has_time, geom, node, ainfo = poly
                    extra = None if ainfo is None else ainfo[:2]
                    desc = (edges, box_np, win_np) + (() if ainfo is None else (ainfo[2],))
                    group = dual_groups.setdefault(("poly", id(table), has_time, extra),
                                                   ("poly", table, has_time, extra, []))
                    group[4].append((id(plan), plan, desc, _point_ring_test(node, geom)))
                    continue
                xz = self._xz_batch_desc(table, plan)
                if xz is not None:
                    qdesc, has_time, geom, node, ainfo = xz
                    extra = None if ainfo is None else ainfo[:2]
                    desc = (qdesc,) + (() if ainfo is None else (ainfo[2],))
                    group = dual_groups.setdefault(("xz", id(table), has_time, extra),
                                                   ("xz", table, has_time, extra, []))
                    group[4].append((id(plan), plan, desc, _extent_ring_test(node, geom)))
                    continue
            audit.decision("coalesce", "kernel_ineligible", index=table.index.name)
            rest.append((table, plan))
        stacked = 0

        def decline(table, lst, reason: str) -> None:
            audit.decision("coalesce", reason, n=len(lst))
            rest.extend((table, item[1]) for item in lst)

        for table, has_time, extra, lst in mask_groups.values():
            attr, akind = extra if extra is not None else (None, "member")
            dev = self.device_index(table)
            if len(lst) < 2:
                decline(table, lst, "lone_member")
                continue
            if not dev.segments or not self._attr_ready(table, dev, attr, akind):
                decline(table, lst, "mirror_unloadable")
                continue
            for i in range(0, len(lst), self.BATCH_MAX):
                chunk = lst[i : i + self.BATCH_MAX]
                deadline.check("device.dispatch")
                descs = [d for _pid, _p, d in chunk]
                per_seg = [seg.dispatch_exact_mask_batch(descs, has_time, attr, akind)
                           for seg in dev.segments]
                for qi, (pid, _plan, _d) in enumerate(chunk):
                    out[pid] = _PendingScan(
                        [(seg, phs[qi]) for seg, phs in zip(dev.segments, per_seg)], exact=True)
                stacked += len(chunk)
        for kind, table, has_time, extra, lst in dual_groups.values():
            attr, akind = extra if extra is not None else (None, "member")
            dev = self.device_index(table)
            if len(lst) < 2:
                decline(table, lst, "lone_member")
                continue
            loaded = bool(dev.segments) and (
                all(seg.load_poly(table) for seg in dev.segments) if kind == "poly" else True)
            if not loaded or not self._attr_ready(table, dev, attr, akind, xz=kind == "xz"):
                decline(table, lst, "mirror_unloadable")
                continue
            for i in range(0, len(lst), self.BATCH_MAX):
                chunk = lst[i : i + self.BATCH_MAX]
                deadline.check("device.dispatch")
                descs = [item[2] for item in chunk]
                per_seg = [seg.dispatch_dual_mask_batch(kind, descs, has_time, attr, akind)
                           for seg in dev.segments]
                for qi, (pid, _plan, _d, ring_test) in enumerate(chunk):
                    out[pid] = _XZBatchScan(
                        [(seg, phs[qi]) for seg, phs in zip(dev.segments, per_seg)], ring_test)
                stacked += len(chunk)
        reg = devstats.devstats_metrics()
        if stacked:
            reg.inc("batch.coalesce.plans.stacked", stacked)
        if rest:
            reg.inc("batch.coalesce.plans.rest", len(rest))
            self._dispatch_many_batches(rest, out, seek_declined=seek_probed)
        return out

    def _drain_attr_batches(self, out: Dict[int, object], groups) -> None:
        """The attribute-plane groups of dispatch_many: per (table,
        has_time, attribute, edition), chunked ``exact_bitmap`` batches with
        the attribute test; a lone query takes ``dispatch_exact_attr``
        (q = 1, runs). When some segment cannot load the codes (an object
        column) or its value space is too large for the vocabmask lookup,
        the group takes the candidate route and the host post-filter."""
        for table, has_time, attr, akind, lst in groups.values():
            dev = self.device_index(table)
            if not self._attr_ready(table, dev, attr, akind):
                for pid, plan, _d in lst:
                    out[pid] = self._dispatch_nonseek(table, plan, desc=None)
                continue
            self._seed_spans(dev, [p for _pid, p, _d in lst])
            for i in range(0, len(lst), self.BATCH_MAX):
                chunk = lst[i : i + self.BATCH_MAX]
                if len(chunk) == 1:
                    pid, _plan, (box_np, win_np, payload) = chunk[0]
                    box_dev = upload(box_np, self.device)
                    win_dev = None if win_np is None else upload(win_np, self.device)
                    out[pid] = _PendingScan(
                        [(seg, seg.dispatch_exact_attr(box_dev, win_dev, attr, payload, akind))
                         for seg in dev.segments],
                        exact=True,
                    )
                    continue
                descs = [d for _pid, _p, d in chunk]
                per_seg = [seg.dispatch_exact_batch(descs, has_time, attr=attr, attr_kind=akind)
                           for seg in dev.segments]
                for qi, (pid, _plan, _d) in enumerate(chunk):
                    out[pid] = _PendingScan(
                        [(seg, phs[qi]) for seg, phs in zip(dev.segments, per_seg)],
                        exact=True,
                    )

    def _drain_xz_batches(self, out: Dict[int, object], groups) -> None:
        """The extent groups of dispatch_many (the reference's
        ``_drain_dual_batches``), per (table, has_time, attribute, edition):
        chunked ``xz_dual_bitmap`` batches per segment resolving through
        _XZBatchScan; a lone query takes the q = 1 dual scan, or with
        attribute predicates the candidate route and the host post-filter,
        as the reference's lone extent queries. When some segment cannot
        take the group's attribute plane, the group takes the candidate
        route too."""
        for table, has_time, attr, akind, lst in groups.values():
            dev = self.device_index(table)
            if not self._attr_ready(table, dev, attr, akind, xz=True):
                for pid, plan, *_rest in lst:
                    out[pid] = self._dispatch_nonseek(table, plan, desc=None)
                continue
            for i in range(0, len(lst), self.BATCH_MAX):
                chunk = lst[i : i + self.BATCH_MAX]
                if len(chunk) == 1:
                    out[chunk[0][0]] = self._dispatch_nonseek(table, chunk[0][1], desc=None)
                    continue
                descs = np.stack([item[2] for item in chunk])
                payloads = [item[3][2] for item in chunk] if attr is not None else None
                per_seg = [seg.dispatch_exact_xz_batch(descs, has_time, attr, akind or "member",
                                                       payloads)
                           for seg in dev.segments]
                for qi, (pid, _plan, _qdesc, _ainfo, geom, node) in enumerate(chunk):
                    out[pid] = _XZBatchScan(
                        [(seg, phs[qi]) for seg, phs in zip(dev.segments, per_seg)],
                        _extent_ring_test(node, geom),
                    )

    def _drain_poly_batches(self, out: Dict[int, object], groups) -> None:
        """The polygon groups of dispatch_many (the reference's
        ``_drain_dual_batches`` with ``dispatch_poly_batch``): chunked
        ``poly_dual_bitmap`` batches per segment resolving through
        _XZBatchScan (the ring: hit rows the f32 ray cast left undecided,
        tested on the host). A group of one, or a chunk of one, takes the
        reference's route for a query alone: the candidate mask and the
        host post-filter; so does a group whose attribute plane some segment
        cannot take."""
        for table, has_time, attr, akind, lst in groups.values():
            dev = self.device_index(table)
            ok = len(lst) > 1 and bool(dev.segments) and all(
                seg.load_poly(table) for seg in dev.segments) and self._attr_ready(
                    table, dev, attr, akind)
            if not ok:
                for pid, plan, _d, _geom, _node in lst:
                    out[pid] = self._dispatch_nonseek(table, plan, desc=None)
                continue
            for i in range(0, len(lst), self.BATCH_MAX):
                chunk = lst[i : i + self.BATCH_MAX]
                if len(chunk) == 1:
                    pid, plan, _d, _geom, _node = chunk[0]
                    out[pid] = self._dispatch_nonseek(table, plan, desc=None)
                    continue
                descs = [d for _pid, _plan, d, _geom, _node in chunk]
                per_seg = [seg.dispatch_poly_batch(descs, has_time, attr, akind or "member")
                           for seg in dev.segments]
                for qi, (pid, _plan, _d, geom, node) in enumerate(chunk):
                    out[pid] = _XZBatchScan(
                        [(seg, phs[qi]) for seg, phs in zip(dev.segments, per_seg)],
                        _point_ring_test(node, geom),
                    )

    @staticmethod
    def _seed_spans(dev: DeviceIndex, plans) -> None:
        """Plan-derived span seeding for unlearned segments: each plan's
        z-ranges searchsort into the sorted blocks, giving a conservative
        row-interval cover; the widest planned span across the stream seeds
        the segment's bitmap window."""
        for seg in dev.segments:
            if seg._span_cap != 0 or not seg.n:
                continue
            widest = 0
            ok = True
            for plan in plans:
                if not getattr(plan, "ranges", None):
                    ok = False  # no range cover -> cannot bound the span
                    break
                lo = hi = None
                for off, b in zip(seg.block_starts, seg.blocks):
                    starts, ends, _flags = b.scan_intervals(plan.ranges)
                    live = ends > starts
                    if live.any():
                        blo = int(off + starts[live].min())
                        bhi = int(off + ends[live].max() - 1)
                        lo = blo if lo is None else min(lo, blo)
                        hi = bhi if hi is None else max(hi, bhi)
                if lo is not None:
                    widest = max(widest, hi - lo + 1)
            if ok and widest:
                # +8: the window start aligns down to a byte boundary
                seg.seed_span(widest + 8)

    # -- the host-seek chooser -----------------------------------------------

    def _seek_scan(self, table: IndexTable, plan: QueryPlan) -> Optional[_HostSeekScan]:
        """Cost-based execution choice (the reference's ``_seek_scan``):
        when the plan's ranges cover a small fraction of the sorted blocks,
        a host searchsorted seek touches only candidate rows and beats a
        device full scan. ``GEOMESA_SEEK``: auto (default) | 0 (never) | 1
        (whenever ranges exist), read at each call; ``SEEK_FRAC`` is the
        cutoff of auto. The reference's device-assisted
        seek (``GEOMESA_DEVSEEK``, off by default) is not ported: this is
        its choice with that seek off."""
        mode = os.environ.get("GEOMESA_SEEK", "auto")
        if mode == "0" or not plan.ranges:
            return None
        nrows = table.num_rows
        if nrows == 0:
            return None
        # one searchsorted pass serves the cost probe and, if the seek wins,
        # the scan itself
        per_block = []
        total = 0
        for b in table.blocks:
            starts, ends, flags = b.scan_intervals(plan.ranges)
            if len(starts):
                total += int(np.maximum(ends - starts, 0).sum())
                per_block.append((b, starts, ends, flags))
        if mode != "1":
            if total > SEEK_FRAC * nrows:
                return None
        pred = self._native_seek_pred(table, plan)
        if pred is None:
            pred = self._xz_native_pred(table, plan)
        return _HostSeekScan(table, per_block, pred)

    def _native_seek_pred(self, table: IndexTable, plan: QueryPlan):
        """("z", geom, dtg, box, t_lo, t_hi, use_covered) for the one-pass
        C++ seek scan when the remaining per-row work is one exact
        bbox(+interval) test and the library is loaded; None -> the
        covered-split scan. Two plan shapes qualify:

          * a point z-index plan whose FULL filter is the box(+window)
            (``_exact_predicate_shape``): ``use_covered``, range
            ``contained`` flags mean "satisfies the whole predicate" and
            the scan passes those runs untested;
          * a value-exact attribute or id plan whose residual is the
            box(+window) (``_residual_shape``): the candidates satisfy the
            primary, and the scan tests every one of them."""
        shape = self._exact_predicate_shape(table, plan)
        use_covered = shape is not None
        if shape is None:
            shape = self._residual_shape(table, plan)
        if shape is None or load_seek() is None:
            return None
        xmin, ymin, xmax, ymax, t_lo, t_hi = shape
        ft = table.ft
        dtg = ft.default_date.name if ft.default_date is not None else None
        if t_lo is not None or t_hi is not None:
            # null dates are stored as 0 + a __null mask: the raw test would
            # admit them when the window holds the epoch
            if any(b.has_nulls(dtg) for b in table.blocks):
                return None
        return ("z", ft.default_geometry.name, dtg, (xmin, ymin, xmax, ymax), t_lo, t_hi,
                use_covered)

    def _residual_shape(self, table: IndexTable, plan: QueryPlan):
        """Box(+window) shape of a value-exact plan's residual: every range
        ``contained`` (attribute equality or id ranges, exact in value
        space, so every candidate satisfies the primary) and full filter =
        primary AND secondary, so testing the secondary alone gives the
        query's result set."""
        name = table.index.name
        if not (name == "id" or name.startswith("attr")):
            return None
        if plan.primary is None or plan.secondary is None:
            return None
        if not plan.ranges or not all(r.contained for r in plan.ranges):
            return None
        return self._box_window_shape(table.ft, plan.secondary)

    def _xz_native_pred(self, table: IndexTable, plan: QueryPlan):
        """("xz", geom, node, qenv, rect) for the C++ envelope seek scan
        (xz2 only: one spatial predicate, ``_xz_pred_shape``) when the
        blocks carry envelope companions and the library is loaded."""
        shape = self._xz_pred_shape(table, plan)
        if shape is None or table.index.name != "xz2":
            return None
        geom, node, qenv, rect, _t_lo, _t_hi = shape
        if not table.blocks or any(geom + "__bxmin" not in b.columns for b in table.blocks):
            return None
        if load_seek() is None:
            return None
        return ("xz", geom, node, qenv, rect)

    # -- exact descriptors ---------------------------------------------------

    @staticmethod
    def _box_window_shape(ft, f):
        """(xmin, ymin, xmax, ymax, t_lo, t_hi) raw f64 / inclusive-ms
        bounds when filter ``f`` is exactly one AND-combination of
        inclusive-envelope spatial tests on the default point geometry plus
        interval tests on the default date. None otherwise. t_lo/t_hi are
        None when the filter has no temporal part."""
        if f is None or ft.default_geometry is None or not ft.is_points:
            return None
        got = TorchScanExecutor._walk_boxes(ft, f)
        if got is None:
            return None
        (xmin, ymin, xmax, ymax), t_lo, t_hi = got
        return xmin, ymin, xmax, ymax, t_lo, t_hi

    @staticmethod
    def _exact_predicate_shape(table: IndexTable, plan: QueryPlan):
        """Box(+window) shape of the FULL filter for point z-index plans
        with no residual (see _box_window_shape)."""
        if table.index.name not in ("z2", "z3") or plan.secondary is not None:
            return None
        shape = TorchScanExecutor._box_window_shape(table.ft, plan.full_filter)
        if shape is None:
            return None
        if (shape[4] is not None or shape[5] is not None) and table.index.name != "z3":
            return None  # temporal test needs the time column (z3 tables)
        return shape

    @staticmethod
    def _and_walk_temporal(ft, f, match_spatial):
        """AND-only filter walker: temporal predicates on the default date
        clamp the (inclusive-ms) window with the exclusive-bound rules
        (DURING/AFTER/BEFORE are exclusive, TEQUALS is a point); every other
        node must be accepted by ``match_spatial``. Returns (ok, t_lo, t_hi)."""
        from geomesa_tpu_torch.filter import ast as A

        dtg = ft.default_date.name if ft.default_date is not None else None
        t_lo, t_hi = None, None  # inclusive ms, None = open

        def clamp_lo(v):
            nonlocal t_lo
            t_lo = v if t_lo is None else max(t_lo, v)

        def clamp_hi(v):
            nonlocal t_hi
            t_hi = v if t_hi is None else min(t_hi, v)

        def walk(node) -> bool:
            if isinstance(node, A.And):
                return all(walk(c) for c in node.children())
            if dtg is not None and isinstance(node, A.During) and node.prop == dtg:
                clamp_lo(node.lo_ms + 1)
                clamp_hi(node.hi_ms - 1)
                return True
            if dtg is not None and isinstance(node, A.After) and node.prop == dtg:
                clamp_lo(node.t_ms + 1)
                return True
            if dtg is not None and isinstance(node, A.Before) and node.prop == dtg:
                clamp_hi(node.t_ms - 1)
                return True
            if dtg is not None and isinstance(node, A.TEquals) and node.prop == dtg:
                clamp_lo(node.t_ms)
                clamp_hi(node.t_ms)
                return True
            return match_spatial(node)

        return walk(f), t_lo, t_hi

    @staticmethod
    def _walk_boxes(ft, f, extra_match=None):
        """AND-only walk collecting bbox / rect-INTERSECTS tests on the
        default geometry plus temporal clamps: the one home of the box
        rules of the plain exact and the attribute planes. ``extra_match``
        may claim more node shapes. Returns ((xmin, ymin, xmax, ymax), t_lo,
        t_hi) or None."""
        if f is None:
            return None
        from geomesa_tpu_torch.filter import ast as A

        geom = ft.default_geometry.name
        boxes: List = []

        def match(node) -> bool:
            if isinstance(node, A.BBox) and node.prop == geom:
                boxes.append(node.envelope)
                return True
            if isinstance(node, A.Intersects) and node.prop == geom:
                g = node.geometry
                if hasattr(g, "is_rectangle") and g.is_rectangle():
                    boxes.append(g.envelope)
                    return True
            return extra_match(node) if extra_match is not None else False

        ok, t_lo, t_hi = TorchScanExecutor._and_walk_temporal(ft, f, match)
        if not ok or not boxes:
            return None
        env = boxes[0]
        xmin, ymin, xmax, ymax = env.xmin, env.ymin, env.xmax, env.ymax
        for e in boxes[1:]:  # AND of boxes = envelope intersection
            xmin, ymin = max(xmin, e.xmin), max(ymin, e.ymin)
            xmax, ymax = min(xmax, e.xmax), min(ymax, e.ymax)
        return (xmin, ymin, xmax, ymax), t_lo, t_hi

    @staticmethod
    def _shape_keys(shape):
        """(box int64[4], window int64[2] | None) key descriptors from a
        _box_window_shape tuple: box = keys of (xmin, xmax, ymin, ymax),
        window = inclusive (lo, hi) ms (an int64 time is its own key)."""
        xmin, ymin, xmax, ymax, t_lo, t_hi = shape
        box = f64_keys(np.asarray([xmin, xmax, ymin, ymax]))
        win = None
        if t_lo is not None or t_hi is not None:
            lo_ms = _INT64_MIN + 1 if t_lo is None else t_lo
            hi_ms = _INT64_MAX if t_hi is None else t_hi
            win = np.asarray([lo_ms, hi_ms], dtype=np.int64)
        return box, win

    def _exact_descriptor(self, table: IndexTable, plan: QueryPlan):
        """(box keys, window keys | None) when the device can evaluate the
        query's own semantics; None otherwise (candidate mask + host
        post-filter)."""
        shape = self._exact_predicate_shape(table, plan)
        if shape is None:
            return None
        return self._shape_keys(shape)

    def _attr_batch_desc(self, table: IndexTable, plan: QueryPlan):
        """(attribute, edition, (box int64[4], win int64[2] | None, payload))
        when a z2/z3 plan's FULL filter is one box(+window) AND predicates
        on exactly one attribute that the unified code space can decide,
        so the device answers all of it (the reference's
        ``_attr_batch_desc``, the join attribute strategy evaluated at the
        data); None otherwise. Editions and payloads: ``_attr_pred_collector``."""
        if table.index.name not in ("z2", "z3"):
            return None
        ft = table.ft
        if ft.default_geometry is None or not ft.is_points:
            return None
        match_attr, finalize = self._attr_pred_collector(ft)
        got = self._walk_boxes(ft, plan.full_filter, extra_match=match_attr)
        found = finalize()
        if got is None or found is None:
            return None
        attr, kind, payload = found
        (xmin, ymin, xmax, ymax), t_lo, t_hi = got
        if (t_lo is not None or t_hi is not None) and table.index.name != "z3":
            return None
        box, win = self._shape_keys((xmin, ymin, xmax, ymax, t_lo, t_hi))
        return attr, kind, (box, win, payload)

    @staticmethod
    def _attr_pred_collector(ft):
        """(match, finalize): the recognizer of the attribute plane's
        predicates (the reference's ``_attr_pred_collector``).
        ``match(node)`` claims eligible predicates during an AND walk;
        ``finalize()`` returns None or (attribute, edition, payload):

          * member: ``a = x`` or ``a IN (...)`` of at most ``_ATTR_K_CAP``
            distinct values; payload the literal tuple;
          * notmember: a ``a <> x [AND a <> y ...]`` chain; payload the
            excluded literals;
          * range: any AND of <, <=, >, >=, =, BETWEEN, DURING / BEFORE /
            AFTER on a secondary date, a LIKE with one trailing % (a
            prefix), IS [NOT] NULL; payload the (op, coerced literal) tuple;
          * vocabmask: one other LIKE or an ILIKE; payload (pattern,
            case_insensitive).

        Eligible attributes: String (not json), Integer, Long, Float,
        Double, Date, other than the default date (the window's)."""
        from geomesa_tpu_torch.filter import ast as A
        from geomesa_tpu_torch.filter.evaluate import _coerce
        from geomesa_tpu_torch.schema.featuretype import AttributeType

        dtg = ft.default_date.name if ft.default_date is not None else None
        ok_types = (
            AttributeType.STRING, AttributeType.INT, AttributeType.LONG,
            AttributeType.FLOAT, AttributeType.DOUBLE, AttributeType.DATE,
        )
        inlists: List = []  # (prop, values)
        ranges: List = []  # (prop, op, coerced literal), '=' included
        excluded: List = []  # (prop, coerced literal) of '<>' chains
        likes: List = []  # (prop, pattern, case_insensitive)

        def eligible(prop) -> bool:
            return (not prop.startswith("$.") and prop != dtg and ft.has(prop)
                    and ft.attr(prop).type in ok_types and not ft.attr(prop).json)

        def coerced(prop, lit):
            # NaN sorts past the end but compares false; None never matches
            v = _coerce(ft, prop, lit)
            return None if v is None or (isinstance(v, float) and v != v) else v

        def match_attr(node) -> bool:
            if isinstance(node, A.Cmp) and node.op in ("=", "<", "<=", ">", ">=") \
                    and eligible(node.prop):
                lit = coerced(node.prop, node.literal)
                if lit is None:
                    return False
                ranges.append((node.prop, node.op, lit))
                return True
            if isinstance(node, A.Cmp) and node.op == "<>" and eligible(node.prop):
                lit = coerced(node.prop, node.literal)
                if lit is None:
                    return False
                excluded.append((node.prop, lit))
                return True
            if isinstance(node, A.Between) and eligible(node.prop):
                lo, hi = coerced(node.prop, node.lo), coerced(node.prop, node.hi)
                if lo is None or hi is None:
                    return False
                ranges.append((node.prop, "between", (lo, hi)))
                return True
            if isinstance(node, A.InList) and eligible(node.prop):
                # dedupe before the cap
                raw = [coerced(node.prop, v) for v in node.values]
                if any(v is None for v in raw):
                    return False
                vals = tuple(dict.fromkeys(raw))
                if 0 < len(vals) <= _ATTR_K_CAP:
                    inlists.append((node.prop, vals))
                    return True
                return False
            if isinstance(node, A.IsNull) and eligible(node.prop):
                ranges.append((node.prop, "notnull" if node.negate else "isnull", None))
                return True
            if isinstance(node, A.Like) and eligible(node.prop) \
                    and ft.attr(node.prop).type == AttributeType.STRING:
                pat = node.pattern
                if not node.case_insensitive and "_" not in pat and (
                        "%" not in pat or (pat.count("%") == 1 and pat.endswith("%"))):
                    # a prefix is a code range; no wildcard is equality
                    if pat.endswith("%"):
                        ranges.append((node.prop, "prefix", pat[:-1]))
                    else:
                        ranges.append((node.prop, "=", pat))
                else:
                    likes.append((node.prop, pat, node.case_insensitive))
                return True
            if isinstance(node, (A.During, A.Before, A.After)) and eligible(node.prop) \
                    and ft.attr(node.prop).type == AttributeType.DATE:
                if isinstance(node, A.During):
                    ranges.append((node.prop, "during", (node.lo_ms, node.hi_ms)))
                elif isinstance(node, A.Before):
                    ranges.append((node.prop, "before", node.t_ms))
                else:
                    ranges.append((node.prop, "after", node.t_ms))
                return True
            return False

        def finalize():
            if not (inlists or ranges or excluded or likes):
                return None
            props = ({p for p, *_ in inlists} | {p for p, *_ in ranges}
                     | {p for p, *_ in excluded} | {p for p, *_ in likes})
            if len(props) != 1:
                return None  # one codes column per batch
            if likes:
                if inlists or ranges or excluded or len(likes) > 1:
                    return None
                prop, pattern, ci = likes[0]
                return prop, "vocabmask", (pattern, ci)
            if excluded:
                if inlists or ranges:
                    return None
                vals = tuple(dict.fromkeys(lit for _p, lit in excluded))
                if len(vals) > _ATTR_K_CAP:
                    return None
                return props.pop(), "notmember", vals
            if inlists and (ranges or len(inlists) > 1):
                return None
            attr = props.pop()
            if inlists:
                return attr, "member", inlists[0][1]
            if len(ranges) == 1 and ranges[0][1] == "=":
                return attr, "member", (ranges[0][2],)  # a lone equality
            return attr, "range", tuple((op, lit) for _p, op, lit in ranges)

        return match_attr, finalize

    @staticmethod
    def _xz_pred_shape(table: IndexTable, plan: QueryPlan, extra_match=None):
        """(geom, node, qenv, rect, t_lo, t_hi) when the FULL filter of an
        xz2/xz3 plan is exactly one spatial predicate on the default
        geometry plus, for xz3, AND-combined temporal bounds on the default
        date; None otherwise. t_lo/t_hi are inclusive ms or None.

        Only a SINGLE spatial node qualifies: an AND of two boxes is not one
        test against their intersection for extent features (a geometry can
        straddle both boxes yet miss the intersection). ``extra_match`` may
        claim more node shapes (the attribute plane's predicates); the plan
        may then carry a secondary, the residual the device decides."""
        if table.index.name not in ("xz2", "xz3"):
            return None
        if extra_match is None and plan.secondary is not None:
            return None
        f = plan.full_filter
        if f is None:
            return None
        from geomesa_tpu_torch.filter import ast as A

        ft = table.ft
        geom = ft.default_geometry.name
        spatial: List = []

        def match(node) -> bool:
            if isinstance(node, (A.BBox, A.Intersects)) and node.prop == geom:
                spatial.append(node)
                return True
            return extra_match(node) if extra_match is not None else False

        ok, t_lo, t_hi = TorchScanExecutor._and_walk_temporal(ft, f, match)
        if not ok or len(spatial) != 1:
            return None
        if table.index.name == "xz2" and (t_lo is not None or t_hi is not None):
            return None  # xz2 segments carry no time column
        node = spatial[0]
        if isinstance(node, A.BBox):
            qenv, rect = node.envelope, True
        else:
            g = node.geometry
            qenv = g.envelope
            rect = hasattr(g, "is_rectangle") and g.is_rectangle()
        return geom, node, qenv, rect, t_lo, t_hi

    @staticmethod
    def _xz_desc(qenv, rect: bool, t_lo, t_hi) -> Tuple[np.ndarray, bool]:
        """(desc int64[8], has_time): the ONE place that encodes an extent
        query (the reference's ``_xz_query_limbs``): the keys of (xmin,
        ymin, xmax, ymax) and of 0.0 (the null-geometry placeholder), the
        rect flag, and the inclusive [lo, hi] ms window, an open side being
        int64 min + 1 or int64 max (zeros without time)."""
        desc = np.zeros(kernels.XZ_DESC, dtype=np.int64)
        desc[:5] = f64_keys(np.asarray([qenv.xmin, qenv.ymin, qenv.xmax, qenv.ymax, 0.0]))
        desc[5] = 1 if rect else 0
        has_time = t_lo is not None or t_hi is not None
        if has_time:
            desc[6] = _INT64_MIN + 1 if t_lo is None else t_lo
            desc[7] = _INT64_MAX if t_hi is None else t_hi
        return desc, has_time

    def _xz_batch_desc(self, table: IndexTable, plan: QueryPlan):
        """(desc int64[8], has_time, geom, node, attr_info) when this extent
        plan's full filter reduces to one spatial predicate (+ xz3 time
        bounds), optionally AND predicates on ONE attribute that the code
        space decides (the reference's ``_xz_batch_desc``): the dual
        route's descriptor; None otherwise. ``attr_info`` is None or
        (attribute, edition, payload) as ``_attr_pred_collector`` gives it:
        the attribute test ANDs into the hit plane, so decided rows are
        final and the ring needs only the host's geometry test."""
        shape = self._xz_pred_shape(table, plan)
        attr_info = None
        if shape is None:
            match_attr, finalize = self._attr_pred_collector(table.ft)
            shape = self._xz_pred_shape(table, plan, extra_match=match_attr)
            attr_info = finalize()
            if shape is None or attr_info is None:
                return None
        geom, node, qenv, rect, t_lo, t_hi = shape
        desc, has_time = self._xz_desc(qenv, rect, t_lo, t_hi)
        return desc, has_time, geom, node, attr_info

    def _poly_batch_desc(self, table: IndexTable, plan: QueryPlan):
        """(edges f32[E, 4], box int64[4], win int64[2] | None, has_time,
        geom, node, attr_info) when this point z-index plan's FULL filter is
        one non-rectangular INTERSECTS(polygon) on the default geometry (+
        z3 temporal bounds), optionally AND predicates on ONE attribute that
        the code space decides: the banded ray cast's descriptor (the
        reference's ``_poly_batch_desc``); None otherwise. A rectangle stays
        on the box path; a MultiPolygon qualifies only when its members'
        envelopes are disjoint (crossing parity holds for disjoint members
        only); the edges are every ring's, shells and holes; box and window
        are the polygon's envelope and the window as ``_shape_keys`` encodes
        them. ``attr_info`` is None or (attribute, edition, payload) as
        ``_attr_pred_collector`` gives it: the attribute test ANDs into the
        hit plane, so the band ring carries only rows that pass it."""
        if table.index.name not in ("z2", "z3"):
            return None
        ft = table.ft
        if ft.default_geometry is None or not ft.is_points:
            return None
        f = plan.full_filter
        if f is None:
            return None
        from geomesa_tpu_torch.filter import ast as A
        from geomesa_tpu_torch.geom.base import MultiPolygon, Polygon

        geom = ft.default_geometry.name
        spatial: List = []

        def match(node) -> bool:
            if isinstance(node, A.Intersects) and node.prop == geom:
                spatial.append(node)
                return True
            return False

        match_attr, finalize = self._attr_pred_collector(ft)
        ok, t_lo, t_hi = self._and_walk_temporal(ft, f, lambda n: match(n) or match_attr(n))
        attr_info = finalize()
        if not ok or len(spatial) != 1:
            return None
        if attr_info is None and plan.secondary is not None:
            return None  # a residual that is not one attribute's predicates
        has_time = t_lo is not None or t_hi is not None
        if has_time and table.index.name != "z3":
            return None
        node = spatial[0]
        g = node.geometry
        if hasattr(g, "is_rectangle") and g.is_rectangle():
            return None
        if isinstance(g, Polygon):
            polys = [g]
        elif isinstance(g, MultiPolygon):
            polys = list(g.geoms)
            envs = [p.envelope for p in polys]
            if any(envs[i].intersects(envs[j])
                   for i in range(len(envs)) for j in range(i + 1, len(envs))):
                return None
        else:
            return None
        segs = []
        for p in polys:
            for r in [p.shell, *p.holes]:
                r = np.asarray(r, np.float64)
                if len(r) < 3:
                    return None
                if not np.array_equal(r[0], r[-1]):
                    r = np.vstack([r, r[:1]])
                segs.append(np.stack([r[:-1, 0], r[:-1, 1], r[1:, 0], r[1:, 1]], axis=1))
        edges = np.concatenate(segs).astype(np.float32)
        e = g.envelope
        box, win = self._shape_keys((e.xmin, e.ymin, e.xmax, e.ymax, t_lo, t_hi))
        return edges, box, win, has_time, geom, node, attr_info

    def _query_descriptor(self, table: IndexTable, plan: QueryPlan):
        """(boxes, windows | None) device tensors of the candidate mask."""
        if table.index.name in ("xz2", "xz3"):
            return self._xz_query_descriptor(table, plan)
        sfc = table.index.sfc(table.ft)
        boxes = pad_boxes(
            [
                (
                    int(sfc.lon.normalize(env.xmin)[()]),
                    int(sfc.lat.normalize(env.ymin)[()]),
                    int(sfc.lon.normalize(env.xmax)[()]),
                    int(sfc.lat.normalize(env.ymax)[()]),
                )
                for env in plan.values.spatial_envelopes
            ]
        )
        windows = None
        if table.index.name == "z3":
            # plan.values.bins came from SECOND-rounded intervals (fine for
            # ranges, which loosen back into supersets), but a DIRECT window
            # mask would drop true matches inside the rounded-off second:
            # rebuild per-bin windows from the UNROUNDED intervals
            # (times_by_bin applies the exact ±1ms exclusive shift);
            # floor-normalization keeps both ends conservative.
            bins = plan.values.bins
            if plan.full_filter is not None and table.ft.default_date is not None:
                from geomesa_tpu_torch.filter.extract import extract_intervals
                from geomesa_tpu_torch.index.keyspace import times_by_bin

                iv = extract_intervals(plan.full_filter, table.ft.default_date.name)
                if iv is not None and iv.values and not iv.disjoint:
                    bins = times_by_bin(iv, table.ft.z3_interval)
            windows = pad_windows(
                [
                    (b, int(sfc.time.normalize(lo)[()]), int(sfc.time.normalize(hi)[()]))
                    for b, (lo, hi) in sorted(bins.items())
                ]
            )
        boxes_dev = upload(boxes, self.device)
        windows_dev = upload(windows, self.device) if windows is not None else None
        return boxes_dev, windows_dev

    def _xz_query_descriptor(self, table: IndexTable, plan: QueryPlan):
        """Extent candidate descriptors: raw-domain float32 boxes widened
        outward one ulp so the cast never excludes a true overlap, and for
        xz3 the plan's per-bin offset windows widened one unit each side."""
        neg, pos = np.float32(-np.inf), np.float32(np.inf)
        boxes = pad_boxes(
            [
                (
                    np.nextafter(np.float32(env.xmin), neg),
                    np.nextafter(np.float32(env.ymin), neg),
                    np.nextafter(np.float32(env.xmax), pos),
                    np.nextafter(np.float32(env.ymax), pos),
                )
                for env in plan.values.spatial_envelopes
            ],
            dtype=np.float32,
        )
        windows = None
        if table.index.name == "xz3":
            windows = pad_windows(
                [(b, max(0, lo - 1), hi + 1) for b, (lo, hi) in sorted(plan.values.bins.items())]
            )
        boxes_dev = upload(boxes, self.device)
        windows_dev = upload(windows, self.device) if windows is not None else None
        return boxes_dev, windows_dev

    def post_filter(self, ft, plan: QueryPlan, columns) -> np.ndarray:
        from geomesa_tpu_torch.filter.evaluate import evaluate

        return evaluate(plan.post_filter, ft, columns)

    # -- count and stats push-downs ---------------------------------------------

    def count_scan(self, table: IndexTable, plan: QueryPlan) -> Optional[int]:
        """The exact filtered count with no row extraction (the reference's
        ``count_scan``, the EXACT_COUNT edition of the exact scans), or None
        when the host must count (``len`` of the query). A z2/z3 plan whose
        FULL filter is one box(+window), optionally AND predicates on one
        attribute the code space decides, launches ``exact_count`` per
        segment and reads every segment's int32 in one copy; an extent plan
        counts on the dual route (``_count_xz_scan``), a non-rectangular
        polygon on a point table on the banded ray cast
        (``_count_poly_scan``). ``GEOMESA_COUNT_DEVICE``: auto (a CUDA
        device with a round trip of at most 10 ms) | 1 | 0
        (``mesh.device_auto_declines``)."""
        if device_auto_declines("GEOMESA_COUNT_DEVICE", device=self.device):
            return None
        if self._has_visibilities(table):
            return None  # per-row auth checks need the host path
        if table.index.name in ("xz2", "xz3"):
            return self._count_xz_scan(table, plan)
        if table.index.name not in ("z2", "z3") or not self._scan_eligible(table, plan):
            return None
        attr = akind = payload = None
        desc = self._exact_descriptor(table, plan)
        if desc is not None:
            box_np, win_np = desc
        else:
            got = self._attr_batch_desc(table, plan)
            if got is None:
                # a non-rectangular INTERSECTS on a point table: the ray
                # cast's dual planes count as the extent tables do
                return self._count_poly_scan(table, plan)
            attr, akind, (box_np, win_np, payload) = got
        dev = self.device_index(table)
        if not dev.segments or not self._attr_ready(table, dev, attr, akind):
            return None
        # upload once, dispatch every segment, then one copy of all counts
        with record_function("geomesa.dispatch"):
            box_dev = upload(box_np, self.device)
            win_dev = None if win_np is None else upload(win_np, self.device)
            pending = [seg.count_exact_start(box_dev, win_dev, attr, payload, akind or "member")
                       for seg in dev.segments]
        return int(_np_local(torch.cat(pending)).astype(np.int64).sum())

    def _count_xz_scan(self, table: IndexTable, plan: QueryPlan) -> Optional[int]:
        """The extent edition of ``count_scan`` (the reference's
        ``_count_xz_scan``): per segment the q = 1 dual planes, with the
        attribute plane of the plan's attribute predicates; the count is
        the decided rows plus the ring rows the host's geometry test
        passes. None -> the host counts."""
        if not self._scan_eligible(table, plan):
            return None
        got = self._xz_batch_desc(table, plan)
        if got is None:
            return None
        qdesc, has_time, geom, node, attr_info = got
        attr, akind, payload = attr_info or (None, "member", None)
        dev = self.device_index(table)
        if not dev.segments or not self._attr_ready(table, dev, attr, akind, xz=True):
            return None
        with record_function("geomesa.dispatch"):
            desc_dev = upload(qdesc, self.device)
            pendings = [(seg, seg.count_xz_start(desc_dev, has_time, attr, payload, akind))
                        for seg in dev.segments]
        return _count_dual_resolve(pendings, _extent_ring_test(node, geom))

    def _count_poly_scan(self, table: IndexTable, plan: QueryPlan) -> Optional[int]:
        """The banded polygon edition of ``count_scan`` (the reference's
        ``_count_poly_scan``: point z2/z3 tables, one non-rectangular
        INTERSECTS (+ window) (+ one attribute's predicates)): the decided
        ray-cast hits plus the band rows the host's point test passes."""
        got = self._poly_batch_desc(table, plan)
        if got is None:
            return None
        edges, box_np, win_np, has_time, geom, node, attr_info = got
        dev = self.device_index(table)
        attr, akind, payload = attr_info or (None, "member", None)
        if not dev.segments or not all(seg.load_poly(table) for seg in dev.segments):
            return None
        if not self._attr_ready(table, dev, attr, akind):
            return None
        padded = np.zeros((_pow2_at_least(len(edges), 8), 4), np.float32)
        padded[:len(edges)] = edges
        with record_function("geomesa.dispatch"):
            edges_dev = upload(padded, self.device)
            box_dev = upload(box_np, self.device)
            win_dev = None if win_np is None else upload(win_np, self.device)
            pendings = [(seg, seg.count_poly_start(edges_dev, box_dev, win_dev, attr, payload,
                                                   akind))
                        for seg in dev.segments]
        return _count_dual_resolve(pendings, _point_ring_test(node, geom))

    # value-distribution sketches that per-code counts rebuild exactly (the
    # observe_counts contract); GroupBy of any sub-stat but Count(), the z3
    # sketches, DescriptiveStats and geometry stats take the host reducer
    _STAT_HIST_KINDS = ("minmax", "enumeration", "topk", "histogram", "frequency")

    def stats_scan(self, table: IndexTable, plan: QueryPlan, spec: str):
        """The stats push-down (the reference's ``stats_scan``, the
        StatsScan / KryoLazyStatsIterator compute-at-data analog), or None
        when the host reducer must answer (rows extracted, ``run_stats``).
        When the plan's FULL filter is one box(+window) on a z2/z3 table and
        every stat of ``spec`` is Count() or a value-distribution sketch
        (or GroupBy(a, Count())) of an attribute the code space decides,
        each segment launches ``exact_stat_hist`` per attribute (a Count()
        alone: ``exact_count``) and the host rebuilds the sketches from the
        per-value counts (``observe_counts``): the state extraction and
        ``observe`` would give, MinMax's hyperloglog registers included.
        ``GEOMESA_STATS_DEVICE``: auto | 1 | 0, as ``count_scan``'s gate."""
        if device_auto_declines("GEOMESA_STATS_DEVICE", device=self.device):
            return None
        if table.index.name not in ("z2", "z3") or not self._scan_eligible(table, plan):
            return None
        if self._has_visibilities(table):
            return None
        desc = self._exact_descriptor(table, plan)
        if desc is None:
            return None  # attribute predicates or non-rectangular filters: the host
        try:
            stat = parse_stat(spec)
        except Exception:
            return None
        stats = stat.stats if isinstance(stat, SeqStat) else [stat]
        geom = table.ft.default_geometry.name if table.ft.default_geometry else None
        attrs = []
        for st in stats:
            if isinstance(st, CountStat):
                continue
            target = getattr(st, "attribute", None)
            if target is None or target == geom:
                return None
            if st.kind == "groupby":
                # GroupBy(a, Count()) is the per-code histogram itself: one
                # CountStat a present value; other sub-stats need joint counts
                if json.loads(st.example).get("kind") != "count":
                    return None
            elif st.kind not in self._STAT_HIST_KINDS:
                return None
            attrs.append(target)
        attrs = list(dict.fromkeys(attrs))
        dev = self.device_index(table)
        if not dev.segments:
            return None
        for a in attrs or [None]:
            # the histogram rides the vocabmask size gate: past it the
            # per-query bins stop being small
            if not self._attr_ready(table, dev, a, "vocabmask"):
                return None
        box_np, win_np = desc
        with record_function("geomesa.dispatch"):
            box_dev = upload(box_np, self.device)
            win_dev = None if win_np is None else upload(win_np, self.device)
            if attrs:
                pending = [(a, seg.stat_hist_start(box_dev, win_dev, a))
                           for a in attrs for seg in dev.segments]
                bufs = [buf for _a, (buf, _u) in pending]
            else:
                bufs = [seg.count_exact_start(box_dev, win_dev) for seg in dev.segments]
        # one copy of every segment's buffers
        flat = _np_local(torch.cat(bufs)).astype(np.int64)
        merged: Dict[str, tuple] = {}
        total = 0
        if attrs:
            at = 0
            parts: Dict[str, list] = {a: [] for a in attrs}
            for (a, (buf, unified)), b in zip(pending, bufs):
                out = flat[at:at + b.shape[0]]
                at += b.shape[0]
                if a == attrs[0]:  # every attribute's word 0 is the hit count
                    total += int(out[0])
                h = out[1:1 + len(unified)]
                present = h > 0
                if present.any():
                    parts[a].append((np.asarray(unified)[present], h[present]))
            for a in attrs:
                if parts[a]:
                    allv = np.concatenate([v for v, _c in parts[a]])
                    allc = np.concatenate([c for _v, c in parts[a]])
                    # segments merge by value: their codes are segment-local
                    uniq, inv = np.unique(allv, return_inverse=True)
                    summed = np.zeros(len(uniq), dtype=np.int64)
                    np.add.at(summed, inv, allc)
                    merged[a] = (uniq, summed)
                else:
                    merged[a] = (np.empty(0), np.empty(0, dtype=np.int64))
        else:
            total = int(flat.sum())
        for st in stats:
            if isinstance(st, CountStat):
                st.count = int(total)
                continue
            vals, cnts = merged[st.attribute]
            if st.kind == "groupby":
                for v, c in zip(vals, cnts):
                    sub = st._new()
                    sub.count = int(c)
                    st.groups[v.item() if isinstance(v, np.generic) else v] = sub
            elif len(vals):
                st.observe_counts(vals, cnts)
        return stat

    # -- the aggregate pyramid's build --------------------------------------------

    def pyramid_counts(self, table: IndexTable, bits: int) -> Optional[np.ndarray]:
        """[2^bits, 2^bits] int64 per-cell row counts of a z2 table for the
        aggregate pyramid (``ops/pyramid.py``; the reference's
        ``pyramid_counts``): one ``pyramid_counts`` launch per segment over
        its resident grid coordinates (``xi, yi``) and ``agg_mask``, with
        its block bounds (the kernel counts the key-sorted runs of the
        longest block), each grid fetched and the grids summed in int64 on
        the host. None (the
        host build answers) for any other table or a table with no rows."""
        if table.index.name != "z2":
            return None
        dev = self.device_index(table)
        if not dev.segments:
            return None
        n = 1 << bits
        total = np.zeros((n, n), dtype=np.int64)
        grids = []
        with record_function("geomesa.dispatch"):
            for seg in dev.segments:
                deadline.check("device.dispatch")
                grids.append(kernels.pyramid_counts(seg.xi, seg.yi, seg.agg_mask(table), bits,
                                                    starts=seg.block_bounds))
        for grid in grids:
            total += _np_local(grid).astype(np.int64)
        return total

    # -- device kNN ------------------------------------------------------------

    def knn_candidates(self, table: IndexTable, x: float, y: float, k: int):
        """Device top-k nearest candidates to (x, y) (the reference's
        ``knn_candidates``): one ``knn_topk`` launch per segment ranks every
        row by its f32 haversine distance and returns its nearest rows;
        pad and invalid rows are dropped. [(block, local rows)], rows
        sorted per segment; None when the index is not z2 / z3.

        Unlike the reference, which takes exactly k per segment, a segment
        returns ``k + max(KNN_MARGIN, k // KNN_MARGIN_DIV)`` rows and holds
        them to an f64 certificate: every row it did not return has an f32
        distance at least that of its last candidate, so a true (f64)
        distance above ``_knn_d_lo`` of that candidate's term; when the k-th
        smallest f64 term among the candidates stays below it
        (``_knn_d_hi``), the segment's share of the f64 k nearest is among
        its candidates, else the segment asks for twice the rows (all of
        them at the end). The caller's f64 re-rank then gives the f64 k
        nearest, which f32 ranking alone can miss at the k-th place."""
        if table.index.name not in ("z2", "z3"):
            return None
        if self._has_visibilities(table):
            return None  # per-row auth checks need the host path
        if k < 1:
            return []
        dev = self.device_index(table)
        geom = table.ft.default_geometry.name
        pend = []
        for seg in dev.segments:
            if not seg.n:
                continue
            if not seg.load_raw(table) and seg.xf is None:
                return None
            kk = min(k + max(KNN_MARGIN, k // KNN_MARGIN_DIV), seg.n)
            with record_function("geomesa.dispatch"):
                pend.append((seg, kk, self._knn_launch(seg, x, y, kk)))
        out = []
        for seg, kk, launched in pend:
            while True:
                idx, ok = (_np_local(t) for t in launched)
                rows = idx[ok]
                if kk >= seg.n or not ok[-1]:
                    break
                with record_function("geomesa.certify"):
                    if self._knn_certified(seg, geom, rows, x, y, k):
                        break
                kk = min(2 * kk, seg.n)
                with record_function("geomesa.dispatch"):
                    launched = self._knn_launch(seg, x, y, kk)
            out.extend(seg.to_block_rows(np.unique(rows[rows < seg.n])))
        return out

    @staticmethod
    def _knn_launch(seg: DeviceSegment, x: float, y: float, kk: int):
        """(rows int64[kk] by f32 distance, their valid flags) on the device."""
        idx = kernels.knn_topk(seg.xf, seg.yf, seg.valid, x, y, kk)
        return idx, seg.valid[idx]

    @staticmethod
    def _knn_certified(seg: DeviceSegment, geom: str, rows: np.ndarray, x: float, y: float,
                       k: int) -> bool:
        """Whether a segment's valid candidates ``rows``, in the kernel's
        order, hold every row of the segment that can be among the f64 k
        nearest (see ``knn_candidates``)."""
        if len(rows) < k:
            return False  # NaN distances rank past the invalid rows
        order = np.argsort(rows, kind="stable")
        xs, ys = [], []
        for block, local in seg.to_block_rows(rows[order]):
            xs.append(block.gather(geom + "__x", local))
            ys.append(block.gather(geom + "__y", local))
        a = np.empty(len(rows), dtype=np.float64)
        a[order] = _knn_a64(np.concatenate(xs), np.concatenate(ys), x, y)
        kth = np.partition(a, k - 1)[k - 1]
        return bool(_knn_d_hi(kth) < _knn_d_lo(a[-1]))

    # -- density push-down ---------------------------------------------------

    _BIN_MS = {TimePeriod.DAY: 86400000, TimePeriod.WEEK: 604800000}

    def _ms_windows(self, ft, plan: QueryPlan):
        """Per-bin inclusive ms windows [(bin, lo, hi)], exact against the
        query's ms semantics, or None when the device time test cannot be
        exact. Re-extracts the intervals from the full filter WITHOUT the
        exclusive-bound rounding of range planning, so the +-1 ms here
        matches the host filter; needs a single precise interval (several
        can merge into over-wide per-bin windows) and uniform day/week
        bins."""
        from geomesa_tpu_torch.filter.extract import extract_intervals

        if plan.full_filter is None:
            return None
        iv = extract_intervals(plan.full_filter, ft.default_date.name)
        if iv is None or not iv.precise or len(iv.values) != 1:
            return None
        bin_ms = self._BIN_MS.get(ft.z3_interval)
        if bin_ms is None:
            return None
        b = iv.values[0]
        lo_ms = None if b.lower.value is None else int(b.lower.value)
        hi_ms = None if b.upper.value is None else int(b.upper.value)
        if lo_ms is not None and not b.lower.inclusive:
            lo_ms += 1
        if hi_ms is not None and not b.upper.inclusive:
            hi_ms -= 1
        out = []
        for bn in sorted(plan.values.bins):
            start = int(binned_to_time(np.asarray([bn]), np.asarray([0]), ft.z3_interval)[0])
            wlo = 0 if lo_ms is None else max(lo_ms - start, 0)
            whi = bin_ms - 1 if hi_ms is None else min(hi_ms - start, bin_ms - 1)
            if whi >= wlo:
                out.append((bn, wlo, whi))
        return out

    def density_scan(self, table: IndexTable, plan: QueryPlan, spec) -> Optional[np.ndarray]:
        """The density push-down (the server-side KryoLazyDensityIterator
        analog): an f64 [H, W] grid, or None when the host reducer must
        answer. Declines unless the plan is z2/z3 with no residual, the
        spec has no weight and no ``exact``, the geometries are precise
        rectangles and, for z3, the time is one precise interval over
        day/week bins. The grid is exact: each segment's ``density_grid``
        launch counts the rows it certifies in f32 and returns the band
        rows, which the host decides from its f64 columns. A band beyond
        ``DENSITY_BAND_CAP`` rows in a segment, or a cell at 2^24 (the
        reference's f32 grid limit), also sends the query to the host."""
        if table.index.name not in ("z2", "z3") or not self.supports(table, plan):
            return None
        if plan.secondary is not None or spec.get("weight") or spec.get("exact"):
            return None
        if self._has_visibilities(table):
            return None  # per-row auth checks need the host reducer
        gv = plan.values.geometries
        if not gv.values or not gv.precise or not all(g.is_rectangle() for g in gv.values):
            return None
        dev = self.device_index(table)
        windows = None
        if table.index.name == "z3":
            if not plan.values.bins:
                return None
            windows = self._ms_windows(table.ft, plan)
            if windows is None:
                return None
        for seg in dev.segments:
            if not seg.load_raw(table):
                return None
        width, height = int(spec["width"]), int(spec["height"])
        # one read of the cap: the launch's buffer and the overflow check
        band_cap = aggregations.DENSITY_BAND_CAP
        with record_function("geomesa.density"):
            boxes = upload(pad_boxes(
                [(g.envelope.xmin, g.envelope.ymin, g.envelope.xmax, g.envelope.ymax)
                 for g in gv.values],
                dtype=np.float32,
            ), self.device)
            env = upload(np.asarray(spec["envelope"], dtype=np.float32), self.device)
            wins = None if windows is None else upload(pad_windows(windows), self.device)
            outs = []
            for seg in dev.segments:
                # with windows, the temporal-valid column: a null date is
                # stored as 0, a real in-bin offset, and must not count
                grid, idx, cnt = kernels.density_grid(
                    seg.xf, seg.yf, seg.bins if wins is not None else None,
                    seg.t_ms if wins is not None else None,
                    seg.tvalid if wins is not None else seg.valid, boxes, wins, env,
                    width, height, band_cap,
                )
                # one D2H copy per segment: count, band indices, grid
                outs.append((seg, torch.cat([cnt, idx, grid.reshape(-1)])))
        total = np.zeros((height, width), dtype=np.float64)
        band: List[Tuple[DeviceSegment, np.ndarray]] = []
        for seg, buf in outs:
            buf = _np_local(buf)
            cnt = int(buf[0])
            if cnt > band_cap:
                return None  # the band buffer truncated: the host answers
            grid = buf[1 + band_cap:].reshape(height, width)
            if int(grid.max()) >= 2**24:
                return None  # the reference's f32 grid is exact below 2^24 only
            total += grid
            if cnt:
                band.append((seg, np.sort(buf[1:1 + cnt].astype(np.int64))))
        if band:
            with record_function("geomesa.band"):
                total += self._certify_density_band(table, plan, spec, band, width, height)
        return total

    def _certify_density_band(self, table: IndexTable, plan: QueryPlan, spec,
                              band: List[Tuple[DeviceSegment, np.ndarray]],
                              width: int, height: int) -> np.ndarray:
        """Host-exact decisions for the band rows: the plan's post filter on
        their f64 block columns, then the f64 GridSnap of the rows that
        pass (``density_grid_numpy``), the arithmetic of the host reducer,
        so that the sum with the device grid equals the host's grid."""
        from geomesa_tpu_torch.filter import ast
        from geomesa_tpu_torch.index.aggregators import density_grid_numpy
        from geomesa_tpu_torch.store.datastore import _gather_filter_cols

        ft = table.ft
        geom = ft.default_geometry.name
        pf = plan.post_filter
        props = set(ast.properties(pf)) if pf is not None else set()
        env = tuple(spec["envelope"])
        add = np.zeros((height, width), dtype=np.float64)
        for seg, idx in band:
            idx = np.unique(idx[idx < seg.n])  # pad rows are never valid
            for block, rows in seg.to_block_rows(idx):
                if pf is not None:
                    m = self.post_filter(ft, plan, _gather_filter_cols(block, rows, props))
                    rows = rows[m]
                if len(rows):
                    add += density_grid_numpy(
                        np.asarray(block.gather(geom + "__x", rows), dtype=np.float64),
                        np.asarray(block.gather(geom + "__y", rows), dtype=np.float64),
                        None, env, width, height,
                    )
        return add
