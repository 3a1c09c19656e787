"""Stats service: write-time sketches + query-time selectivity estimates.

Port of ``geomesa_tpu/stats/service.py``'s MetadataBackedStats and the
estimator the strategy choice reads (StatsBasedEstimator.scala:27-41): the
total count, the lon/lat/dtg histograms and bounds, the z3 histogram, a
MinMax per numeric or date attribute (+ an auto-ranging histogram when it
is indexed) and a TopK and a Frequency sketch per indexed string. With a
metadata store (``store/metadata.py``) the sketches persist as the
reference's JSON under the type's ``stats`` key (debounced:
``persist_every`` batches, or ``flush``), so a reopened file store reads
them back instead of observing its replayed rows twice.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.extract import extract_geometries, extract_intervals
from geomesa_tpu_torch.schema.featuretype import AttributeType, FeatureType
from geomesa_tpu_torch.stats import sketches
from geomesa_tpu_torch.stats.sketches import (
    CountStat,
    Frequency,
    Histogram,
    MinMax,
    TopK,
    Z3HistogramStat,
)

_HIST_BINS = 1000


class MetadataBackedStats:
    """Per-type sketches observed as columnar batches are written, kept in
    ``metadata`` when one is given (the reference's MetadataBackedStats)."""

    def __init__(self, metadata=None, persist_every: int = 50):
        self.metadata = metadata
        self._stats: Dict[str, Dict[str, object]] = {}
        self._unpersisted: Dict[str, int] = {}
        self._persist_every = persist_every

    def _init_for(self, ft: FeatureType) -> Dict[str, object]:
        stats: Dict[str, object] = {"count": CountStat()}
        geom = ft.default_geometry
        if geom is not None and geom.type == AttributeType.POINT:
            stats["lon"] = Histogram(geom.name + "__x", _HIST_BINS, -180.0, 180.0)
            stats["lat"] = Histogram(geom.name + "__y", _HIST_BINS, -90.0, 90.0)
            stats["minmax:lon"] = MinMax(geom.name + "__x", track_cardinality=False)
            stats["minmax:lat"] = MinMax(geom.name + "__y", track_cardinality=False)
        dtg = ft.default_date
        if dtg is not None:
            # ms-epoch histogram over 2000..2040 (clamped ends catch outliers)
            lo = np.datetime64("2000-01-01", "ms").astype(np.int64)
            hi = np.datetime64("2040-01-01", "ms").astype(np.int64)
            stats["dtg"] = Histogram(dtg.name, _HIST_BINS, float(lo), float(hi))
            stats["minmax:dtg"] = MinMax(dtg.name, track_cardinality=False)
        if geom is not None and dtg is not None and geom.type == AttributeType.POINT:
            stats["z3"] = Z3HistogramStat(geom.name, dtg.name, ft.z3_interval.value)
        for a in ft.attributes:
            if a is geom or a is dtg:
                continue
            if a.type in (AttributeType.INT, AttributeType.LONG, AttributeType.FLOAT,
                          AttributeType.DOUBLE, AttributeType.DATE):
                stats[f"minmax:{a.name}"] = MinMax(a.name)
                if a.indexed:
                    # range-scan selectivity of an indexed numeric
                    stats[f"hist:{a.name}"] = Histogram(a.name, _HIST_BINS)
            elif a.type == AttributeType.STRING and a.indexed:
                stats[f"topk:{a.name}"] = TopK(a.name)
                stats[f"freq:{a.name}"] = Frequency(a.name)
        return stats

    def stats_for(self, ft: FeatureType) -> Dict[str, object]:
        got = self._stats.get(ft.name)
        if got is None:
            got = self._load(ft.name)
            if got is not None:
                # a payload from before a sketch kind existed gains it
                # (empty, observing later writes)
                for k, v in self._init_for(ft).items():
                    got.setdefault(k, v)
            else:
                got = self._init_for(ft)
            got = self._stats.setdefault(ft.name, got)
        return got

    def observe_columns(self, ft: FeatureType, columns: Dict[str, np.ndarray],
                        z3_keys=None) -> None:
        """``z3_keys``: optional (keys, bins) of a just-sealed z3 block of the
        same rows, from which the z3 histogram takes its cells instead of
        encoding the batch again."""
        from geomesa_tpu_torch.store.blocks import num_rows

        stats = self.stats_for(ft)
        stats["count"].count += num_rows(columns)
        decoded: Dict[str, tuple] = {}
        for key, stat in stats.items():
            if key == "count":
                continue
            if isinstance(stat, Z3HistogramStat):
                if z3_keys is not None:
                    stat.observe_keys(*z3_keys)
                elif stat.geom + "__x" in columns and stat.dtg in columns:
                    stat.observe_xyt(columns[stat.geom + "__x"], columns[stat.geom + "__y"],
                                     columns[stat.dtg])
                continue
            attr = stat.attribute
            if attr not in columns:
                continue
            vocab = columns.get(attr + "__vocab")
            if vocab is not None:
                # dictionary column: (vocab values, bincount of codes), the
                # null codes (-1) dropping out of the bincount
                vc = decoded.get(attr)
                if vc is None:
                    codes = columns[attr]
                    cnt = np.bincount(codes[codes >= 0], minlength=len(vocab))
                    present = cnt > 0
                    vc = decoded[attr] = (vocab[present], cnt[present])
                stat.observe_counts(*vc)
                continue
            nulls = columns.get(attr.split("__")[0] + "__null")
            stat.observe(columns[attr], nulls)
        # debounced persistence: serializing every sketch a batch would tax
        # the write path, and the sketches are recomputable
        self._unpersisted[ft.name] = self._unpersisted.get(ft.name, 0) + 1
        if self._unpersisted[ft.name] >= self._persist_every:
            self.flush(ft.name)

    # -- persistence -----------------------------------------------------------

    def flush(self, name: Optional[str] = None) -> None:
        """Persist the sketches of ``name`` (of every type: None) now."""
        for n in [name] if name else list(self._stats):
            if n in self._stats:
                self._persist(n)
                self._unpersisted[n] = 0

    def _persist(self, name: str) -> None:
        if self.metadata is None:
            return
        payload = json.dumps({k: json.loads(v.to_json()) for k, v in self._stats[name].items()})
        self.metadata.insert(name, "stats", payload)

    def _load(self, name: str) -> Optional[Dict[str, object]]:
        if self.metadata is None:
            return None
        raw = self.metadata.read(name, "stats")
        if not raw:
            return None
        return {k: sketches._from_state(v) for k, v in json.loads(raw).items()}

    def has_persisted(self, name: str) -> bool:
        """Whether durable sketches exist: a store replaying persisted
        blocks must then NOT observe them again."""
        return self.metadata is not None and bool(self.metadata.read(name, "stats"))

    def get_count(self, ft: FeatureType, f: Optional[ast.Filter] = None) -> Optional[float]:
        stats = self.stats_for(ft)
        total = stats["count"].count
        if f is None or isinstance(f, ast.Include):
            return float(total)
        if total == 0:
            return 0.0
        sel = _selectivity(ft, f, stats, total)
        if sel is None:
            return None
        return max(0.0, min(1.0, sel)) * total


def _selectivity(ft, f, stats, total) -> Optional[float]:
    """Selectivity from the sketches (StatsBasedEstimator.scala:27-41): bbox
    -> product of lon/lat histogram selectivities; intervals -> dtg
    histogram; attribute equality -> the Frequency count, else
    1 / cardinality; attribute order predicates -> the attribute's
    histogram, else a linear guess over its MinMax; AND multiplies, OR adds
    (capped), NOT complements."""
    if isinstance(f, ast.Include):
        return 1.0
    if isinstance(f, ast.Exclude):
        return 0.0
    if isinstance(f, ast.And):
        sel = 1.0
        for c in f.children():
            s = _selectivity(ft, c, stats, total)
            if s is not None:
                sel *= s
        return sel
    if isinstance(f, ast.Or):
        sel = 0.0
        for c in f.children():
            s = _selectivity(ft, c, stats, total)
            sel += 1.0 if s is None else s
        return min(1.0, sel)
    if isinstance(f, ast.Not):
        s = _selectivity(ft, f.child, stats, total)
        return None if s is None else 1.0 - s

    geom = ft.default_geometry
    if geom is not None and isinstance(f, (ast.BBox, ast.Intersects, ast.Within, ast.Contains)):
        geoms = extract_geometries(f, geom.name)
        if not geoms.values:
            return None
        lon_h, lat_h = stats.get("lon"), stats.get("lat")
        if lon_h is None or lon_h.is_empty:
            return None
        sel = 0.0
        for g in geoms.values:
            env = g.envelope
            sx = lon_h.count_between(env.xmin, env.xmax) / max(1, total)
            sy = lat_h.count_between(env.ymin, env.ymax) / max(1, total)
            sel += sx * sy
        return min(1.0, sel)

    dtg = ft.default_date
    if dtg is not None and isinstance(
        f, (ast.During, ast.Before, ast.After, ast.TEquals, ast.Cmp, ast.Between)
    ):
        if getattr(f, "prop", None) == dtg.name:
            iv = extract_intervals(f, dtg.name)
            h = stats.get("dtg")
            if not iv.values or h is None or h.is_empty:
                return None
            sel = 0.0
            for b in iv.values:
                lo = float(b.lower.value) if b.lower.value is not None else h.lo
                hi = float(b.upper.value) if b.upper.value is not None else h.hi
                sel += h.count_between(lo, hi) / max(1, total)
            return min(1.0, sel)

    if isinstance(f, ast.Cmp) and f.op == "=":
        freq = stats.get(f"freq:{f.prop}")
        if freq is not None and not freq.is_empty:
            return freq.count(f.literal) / max(1, total)
        mm = stats.get(f"minmax:{f.prop}")
        if mm is not None and not mm.is_empty and mm.cardinality > 0:
            return 1.0 / mm.cardinality
    if isinstance(f, ast.Cmp) and f.op in ("<", "<=", ">", ">="):
        h = stats.get(f"hist:{f.prop}")
        if h is not None and not h.is_empty:
            try:
                v = float(f.literal)
            except (TypeError, ValueError):
                return None
            # normalized by the histogram's own mass
            mass = max(1.0, float(h.counts.sum()))
            if f.op in ("<", "<="):
                return h.count_between(h.lo, v) / mass
            return h.count_between(v, h.hi) / mass
        mm = stats.get(f"minmax:{f.prop}")
        if mm is not None and not mm.is_empty:
            try:
                lo, hi = float(mm.min), float(mm.max)
                v = float(f.literal)
                if hi <= lo:
                    return 1.0
                frac = max(0.0, min(1.0, (v - lo) / (hi - lo)))
                return frac if f.op in ("<", "<=") else 1.0 - frac
            except (TypeError, ValueError):
                return None
    if isinstance(f, ast.Between):
        h = stats.get(f"hist:{f.prop}")
        if h is not None and not h.is_empty:
            try:
                mass = max(1.0, float(h.counts.sum()))
                return h.count_between(float(f.lo), float(f.hi)) / mass
            except (TypeError, ValueError):
                return None
    return None
