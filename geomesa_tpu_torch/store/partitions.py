"""Partition schemes for the file-system datastore.

Port of ``geomesa_tpu/store/partitions.py`` (the same partition paths and
the same ``_scheme.json`` sidecar, so either package reads the other's
layout). The geomesa-fs analog of PartitionScheme.scala (geomesa-fs-storage-common,
DateTimeScheme :190-244, Z2Scheme :262-319, CompositeScheme :324-343):
features are bucketed into directory paths by time and/or space, and a
query's filter is converted into the list of bucket paths that can contain
matches so unrelated partitions are never read.

Partition assignment is VECTORIZED over a column batch
(one datetime64 truncation / one morton encode for the whole batch, then a
unique+format over the handful of distinct buckets) instead of the
reference's per-SimpleFeature virtual dispatch. Covering-partition
computation reuses the planner's filter-bounds extraction.
"""

from __future__ import annotations

import json
import math
import os
from datetime import datetime, timezone
from typing import Dict, List, Optional, Sequence

import numpy as np

from geomesa_tpu_torch.curve import zorder
from geomesa_tpu_torch.curve.normalized import NormalizedLat, NormalizedLon
from geomesa_tpu_torch.filter.extract import extract_geometries, extract_intervals
from geomesa_tpu_torch.schema.featuretype import FeatureType
from geomesa_tpu_torch.store.integrity import (
    CorruptFileError,
    durable_write,
    quarantine,
    read_verified,
)

# give up on pruning rather than enumerate absurd bucket counts
MAX_COVERING = 4096


class PartitionScheme:
    """Maps feature batches to partition paths and filters to path prefixes."""

    name = "base"

    def partition_names(self, ft: FeatureType, columns: Dict[str, np.ndarray]) -> np.ndarray:
        """Per-row partition path (object array of str)."""
        labels, inv = self.partition_index(ft, columns)
        return labels[inv]

    def partition_index(self, ft: FeatureType, columns: Dict[str, np.ndarray]):
        """(labels, inverse): the batch's distinct partition paths (an
        object array) and each row's index into them, computed on integer
        buckets, so that a caller groups a large batch without comparing
        its rows' path strings."""
        raise NotImplementedError

    def covering(self, ft: FeatureType, filt) -> Optional[List[str]]:
        """Partition-path PREFIXES that can contain matches for ``filt``;
        None means "cannot prune" (callers must read everything)."""
        raise NotImplementedError

    def validate(self, ft: FeatureType) -> None:
        """Raise ValueError if this scheme cannot partition ``ft`` — called
        before the scheme is durably attached to a type."""
        raise NotImplementedError

    def to_config(self) -> dict:
        raise NotImplementedError


class DateTimeScheme(PartitionScheme):
    """Time-bucketed partitions (DateTimeScheme.scala:190-244).

    Buckets truncate the default date attribute to ``unit`` (numpy datetime64
    truncation — vectorized) and format the bucket start with a strftime
    pattern, so the reference's named layouts map as:
      daily yyyy/MM/dd, monthly yyyy/MM, hourly yyyy/MM/dd/HH,
      minute .../mm, weekly yyyy/ww, julian-day yyyy/DDD (+hourly/minute).
    """

    name = "datetime"

    _NAMED = {
        "minute": ("m", "%Y/%m/%d/%H/%M"),
        "hourly": ("h", "%Y/%m/%d/%H"),
        "daily": ("D", "%Y/%m/%d"),
        "weekly": ("W", "%Y/%W"),
        "monthly": ("M", "%Y/%m"),
        "julian-day": ("D", "%Y/%j"),
        "julian-hourly": ("h", "%Y/%j/%H"),
        "julian-minute": ("m", "%Y/%j/%H/%M"),
    }

    _UNIT_MS = {"m": 60_000, "h": 3_600_000, "D": 86_400_000, "W": 604_800_000}

    def __init__(self, layout: str = "daily", dtg: Optional[str] = None):
        if layout not in self._NAMED:
            raise ValueError(f"unknown datetime partition layout: {layout!r}")
        self.layout = layout
        self.unit, self.fmt = self._NAMED[layout]
        self.dtg = dtg

    def _dtg(self, ft: FeatureType) -> str:
        return self.dtg or ft.default_date.name

    def validate(self, ft: FeatureType) -> None:
        if self.dtg is not None:
            attr = next((a for a in ft.attributes if a.name == self.dtg), None)
            if attr is None:
                raise ValueError(
                    f"{self.layout!r} partition scheme: no attribute {self.dtg!r} on {ft.name!r}"
                )
        elif ft.default_date is None:
            raise ValueError(
                f"{self.layout!r} partition scheme requires a Date attribute on {ft.name!r}"
            )

    def _format_ms(self, ms: int) -> str:
        return datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc).strftime(self.fmt)

    def _truncate(self, ms: np.ndarray) -> np.ndarray:
        """Bucket-start epoch ms for each input ms (vectorized)."""
        dt = ms.astype("datetime64[ms]")
        if self.unit == "M":
            trunc = dt.astype("datetime64[M]")
        elif self.unit == "W":
            # ISO-ish week bucket: truncate to day, then to the week's Monday
            days = dt.astype("datetime64[D]")
            dow = (days.astype(np.int64) + 3) % 7  # epoch day 0 was a Thursday
            trunc = days - dow.astype("timedelta64[D]")
        else:
            trunc = dt.astype(f"datetime64[{self.unit}]")
        return trunc.astype("datetime64[ms]").astype(np.int64)

    def partition_index(self, ft, columns):
        ms = np.asarray(columns[self._dtg(ft)], dtype=np.int64)
        bucket = self._truncate(ms)
        uniq, inv = np.unique(bucket, return_inverse=True)
        labels = np.array([self._format_ms(int(b)) for b in uniq], dtype=object)
        return labels, inv

    def covering(self, ft, filt):
        if filt is None:
            return None
        iv = extract_intervals(filt, self._dtg(ft))
        if iv is None or not iv.values:
            return None
        if iv.disjoint:
            return []
        out: List[str] = []
        for b in iv.values:
            if b.lower.value is None or b.upper.value is None:
                return None  # unbounded: enumerating to year 9999 is pruning nothing
            lo = int(self._truncate(np.asarray([int(b.lower.value)]))[0])
            hi = int(b.upper.value)
            step = self._UNIT_MS.get(self.unit)
            cur_ms = lo
            while True:
                out.append(self._format_ms(cur_ms))
                if len(out) > MAX_COVERING:
                    return None
                if step is None:  # calendar months: advance via datetime64
                    nxt = (
                        np.asarray([cur_ms], dtype="datetime64[ms]")
                        .astype("datetime64[M]")
                        + np.timedelta64(1, "M")
                    ).astype("datetime64[ms]").astype(np.int64)[0]
                    cur_ms = int(nxt)
                else:
                    cur_ms += step
                if cur_ms > hi:
                    break
        return sorted(set(out))

    def to_config(self):
        return {"name": self.name, "layout": self.layout, "dtg": self.dtg}


class Z2Scheme(PartitionScheme):
    """Space-bucketed partitions by low-resolution z2 of the point geometry
    (Z2Scheme.scala:262-319): ``bits`` total (even), zero-padded decimal
    partition names, bbox filters covered via z-range decomposition."""

    name = "z2"

    def __init__(self, bits: int = 4, geom: Optional[str] = None):
        if bits % 2 != 0 or not (0 < bits <= 30):
            raise ValueError("z2 partition bits must be even and in (0, 30]")
        self.bits = bits
        self.geom = geom
        self._lon = NormalizedLon(bits // 2)
        self._lat = NormalizedLat(bits // 2)
        self.digits = int(math.ceil(math.log10(2 ** bits)))

    def _geom(self, ft: FeatureType) -> str:
        return self.geom or ft.default_geometry.name

    def validate(self, ft: FeatureType) -> None:
        """Points only (Z2Scheme.scala:279 has the same restriction): an
        extent geometry is bucketed by its centroid but covered by the
        query bbox's z-cells, which would NOT be a conservative superset —
        lazily-pruned reads could miss matches."""
        from geomesa_tpu_torch.schema.featuretype import AttributeType

        name = self.geom or (
            ft.default_geometry.name if ft.default_geometry is not None else None
        )
        attr = next((a for a in ft.attributes if a.name == name), None)
        if attr is None:
            raise ValueError(
                f"z2 partition scheme requires a geometry attribute on {ft.name!r}"
            )
        if attr.type != AttributeType.POINT:
            raise ValueError(
                f"z2 partition scheme supports Point geometries only, not "
                f"{attr.type.value} ({ft.name}.{attr.name})"
            )

    def _xy(self, ft, columns):
        g = self._geom(ft)
        if g + "__x" in columns:
            return (
                np.asarray(columns[g + "__x"], dtype=np.float64),
                np.asarray(columns[g + "__y"], dtype=np.float64),
            )
        geoms = columns[g]
        xy = np.zeros((len(geoms), 2), dtype=np.float64)
        for i, geom in enumerate(geoms):
            if geom is not None:
                env = geom.envelope
                xy[i] = ((env.xmin + env.xmax) / 2.0, (env.ymin + env.ymax) / 2.0)
        return xy[:, 0], xy[:, 1]

    def partition_index(self, ft, columns):
        x, y = self._xy(ft, columns)
        z = zorder.z2_encode(
            np.asarray(self._lon.normalize(x), dtype=np.int64),
            np.asarray(self._lat.normalize(y), dtype=np.int64),
        )
        uniq, inv = np.unique(z, return_inverse=True)
        labels = np.array([f"{int(v):0{self.digits}d}" for v in uniq], dtype=object)
        return labels, inv

    def covering(self, ft, filt):
        if filt is None:
            return None
        gv = extract_geometries(filt, self._geom(ft))
        if not gv.values:
            return None
        if gv.disjoint:
            return []
        mins, maxs = [], []
        for g in gv.values:
            env = g.envelope
            mins.append(
                (int(self._lon.normalize(env.xmin)[()]), int(self._lat.normalize(env.ymin)[()]))
            )
            maxs.append(
                (int(self._lon.normalize(env.xmax)[()]), int(self._lat.normalize(env.ymax)[()]))
            )
        ranges = zorder.zranges(mins, maxs, self.bits // 2, 2)
        out: List[str] = []
        for r in ranges:
            for z in range(int(r.lower), int(r.upper) + 1):
                out.append(f"{z:0{self.digits}d}")
                if len(out) > MAX_COVERING:
                    return None
        return sorted(set(out))

    def to_config(self):
        return {"name": self.name, "bits": self.bits, "geom": self.geom}


class CompositeScheme(PartitionScheme):
    """Slash-joined sub-schemes (CompositeScheme.scala:324-343), e.g.
    daily/z2: pruning composes as path prefixes — if an inner scheme cannot
    prune, the outer scheme's buckets still cut the read set."""

    name = "composite"

    def __init__(self, children: Sequence[PartitionScheme]):
        if len(children) < 2:
            raise ValueError("composite scheme needs >= 2 children")
        self.children = list(children)

    def validate(self, ft):
        for c in self.children:
            c.validate(ft)

    def partition_index(self, ft, columns):
        labels, inv = self.children[0].partition_index(ft, columns)
        for child in self.children[1:]:
            lab, ci = child.partition_index(ft, columns)
            # one code a (outer, inner) pair; only the pairs present get a label
            uniq, inv = np.unique(inv.astype(np.int64) * len(lab) + ci, return_inverse=True)
            labels = np.array([f"{labels[c // len(lab)]}/{lab[c % len(lab)]}" for c in uniq],
                              dtype=object)
        return labels, inv

    def covering(self, ft, filt):
        prefixes: Optional[List[str]] = None
        for child in self.children:
            cov = child.covering(ft, filt)
            if cov is None:
                # this level can't prune: stop here, earlier levels' buckets
                # remain valid PREFIXES covering everything beneath them
                return prefixes
            if not cov:
                return []
            if prefixes is None:
                prefixes = cov
            else:
                if len(prefixes) * len(cov) > MAX_COVERING:
                    return prefixes
                prefixes = [f"{a}/{b}" for a in prefixes for b in cov]
        return prefixes

    def to_config(self):
        return {"name": self.name, "children": [c.to_config() for c in self.children]}


def from_config(cfg: dict) -> PartitionScheme:
    name = cfg["name"]
    if name == "datetime":
        return DateTimeScheme(cfg.get("layout", "daily"), cfg.get("dtg"))
    if name == "z2":
        return Z2Scheme(cfg.get("bits", 4), cfg.get("geom"))
    if name == "composite":
        return CompositeScheme([from_config(c) for c in cfg["children"]])
    raise ValueError(f"unknown partition scheme: {name!r}")


def parse_scheme(spec: str) -> PartitionScheme:
    """Parse the reference's common-scheme shorthand (CommonSchemeLoader
    PartitionScheme.scala:54-97): comma-joined names like
    ``daily,z2-4bits`` compose; ``z2-<n>bit[s]`` sets resolution."""
    children: List[PartitionScheme] = []
    for token in (t.strip() for t in spec.split(",")):
        if not token:
            continue
        if token.startswith("z2"):
            bits = 4
            if "-" in token:
                bits = int(token.split("-")[1].replace("bits", "").replace("bit", ""))
            children.append(Z2Scheme(bits))
        else:
            children.append(DateTimeScheme(token))
    if not children:
        raise ValueError(f"empty partition scheme spec: {spec!r}")
    return children[0] if len(children) == 1 else CompositeScheme(children)


# -- durable scheme persistence ------------------------------------------------
#
# The scheme sidecar (``blocks/<type>/_scheme.json``) is config the store
# CANNOT afford to tear: a half-written scheme file would make every
# partition path unparseable at the next open. It gets the full store
# durability discipline — CRC footer + fsync + rename on write (under a
# write-ahead intent, store/journal.py, so a crash mid-create rolls the
# sidecar forward or back with the rest of the mutation), quarantine on a
# corrupt read (the store falls back to unpartitioned layout and keeps
# serving).


def save_scheme(path: str, scheme: PartitionScheme, journal=None) -> None:
    """Durably publish a partition-scheme sidecar at ``path``; when a
    journal is given the write is recorded as a write-ahead intent — a
    FRESH sidecar as a publish (rolled back by unlink on a crash), an
    overwrite of an existing one as a replace (the rename is atomic, and
    journaling it as a publish would let rollback unlink the PREVIOUS
    valid version after a failed attempt)."""

    def _publish() -> None:
        durable_write(
            path, json.dumps(scheme.to_config(), sort_keys=True).encode(),
            crc=True,
        )

    if journal is not None:
        fresh = not os.path.exists(path)
        with journal.intent(
            "fs.scheme",
            publishes=[path] if fresh else (),
            replaces=() if fresh else [path],
        ):
            _publish()
    else:
        _publish()


def load_scheme(path: str) -> Optional[PartitionScheme]:
    """Read a scheme sidecar; a torn/corrupt file is quarantined (the
    type degrades to unpartitioned — still correct, just unpruned) and
    legacy footer-less files read unverified."""
    if not os.path.exists(path):
        return None
    try:
        return from_config(json.loads(read_verified(path).decode()))
    except (CorruptFileError, ValueError, UnicodeDecodeError, KeyError):
        quarantine(path)
        return None
