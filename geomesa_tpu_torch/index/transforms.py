"""Query transforms: derived-attribute projections.

Port of ``geomesa_tpu/index/transforms.py``. The reference computes a
transform schema + per-attribute expressions at query time and projects
features through them (geomesa-index-api planning/QueryPlanner.scala:192-284,
TransformSimpleFeature.scala:1-118).
Here a query's ``properties`` may mix plain names ("dtg", "geom") with
definitions ``out=EXPR`` in the transform mini-language already used by the
converters (``tools/convert.py``), with ``$attr`` resolving to the
feature's attribute value:

    Query.cql("bbox(...)", properties=["geom", "who=uppercase($name)"])

The result's schema is the derived transform schema, so downstream exports
(and the aggregations) see the projected type exactly as in the reference.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.geom.base import Geometry, Point
from geomesa_tpu_torch.schema.featuretype import AttributeType, FeatureType, parse_spec
from geomesa_tpu_torch.tools.convert import _Call, _Expr, _Field, _Lit, parse_transform

# expression -> output attribute type inference (by outermost function)
_FN_TYPES = {
    "toint": AttributeType.INT,
    "tolong": AttributeType.LONG,
    "todouble": AttributeType.DOUBLE,
    "tostring": AttributeType.STRING,
    "trim": AttributeType.STRING,
    "lowercase": AttributeType.STRING,
    "uppercase": AttributeType.STRING,
    "concat": AttributeType.STRING,
    "regexreplace": AttributeType.STRING,
    "substr": AttributeType.STRING,
    "uuid": AttributeType.STRING,
    "date": AttributeType.DATE,
    # exposes raw epoch millis (the point of dateToMillis in the reference)
    "datetomillis": AttributeType.LONG,
    "point": AttributeType.POINT,
    "geometry": AttributeType.GEOMETRY,
}


def _infer_type(ft: FeatureType, expr: _Expr) -> AttributeType:
    if isinstance(expr, _Field):
        return ft.attr(expr.name).type if ft.has(expr.name) else AttributeType.STRING
    if isinstance(expr, _Lit):
        v = expr.v
        if isinstance(v, bool):
            return AttributeType.BOOLEAN
        if isinstance(v, int):
            return AttributeType.LONG
        if isinstance(v, float):
            return AttributeType.DOUBLE
        if isinstance(v, Geometry):
            return AttributeType.GEOMETRY
        return AttributeType.STRING
    if isinstance(expr, _Call):
        if expr.name == "withdefault" and expr.args:
            return _infer_type(ft, expr.args[0])
        return _FN_TYPES.get(expr.name, AttributeType.STRING)
    return AttributeType.STRING


class QueryTransforms:
    """Parsed transform definitions for one query's properties."""

    def __init__(self, ft: FeatureType, entries: List[Tuple[str, Optional[_Expr], AttributeType]]):
        self.ft = ft
        self.entries = entries

    @classmethod
    def parse(cls, ft: FeatureType, properties: Optional[Sequence[str]]) -> Optional["QueryTransforms"]:
        """None when properties are plain names (simple projection)."""
        if not properties or not any("=" in p for p in properties):
            return None
        entries: List[Tuple[str, Optional[_Expr], AttributeType]] = []
        for p in properties:
            if "=" in p:
                name, text = p.split("=", 1)
                expr = parse_transform(text.strip())
                entries.append((name.strip(), expr, _infer_type(ft, expr)))
            else:
                name = p.strip()
                entries.append((name, None, ft.attr(name).type))
        return cls(ft, entries)

    def schema(self) -> FeatureType:
        """The derived transform schema (QueryPlanner.scala:192-284)."""
        parts = []
        starred = False
        for name, _, atype in self.entries:
            tok = f"{name}:{atype.value}"
            if atype.is_geometry and not starred:
                tok = f"*{tok}:srid=4326"
                starred = True
            parts.append(tok)
        return parse_spec(self.ft.name, ",".join(parts))

    def apply(self, columns) -> "tuple[FeatureType, dict]":
        """Project candidate columns through the transform expressions.

        Passthrough entries are array copies (no per-row objects); only
        actual expressions pay the Python row loop.
        """
        out_ft = self.schema()
        fids = np.asarray(columns.get("__fid__", np.empty(0, dtype=object)), dtype=object)
        n = len(fids)
        out = {"__fid__": fids}
        for name, expr, atype in self.entries:
            if expr is None:
                for suffix in ("", "__x", "__y", "__null"):
                    key = name + suffix
                    if key in columns:
                        out[key] = columns[key]
                continue
            reader = self._reader(expr, columns)
            vals = [reader(i) for i in range(n)]
            if atype == AttributeType.POINT:
                x = np.full(n, np.nan)
                y = np.full(n, np.nan)
                for i, v in enumerate(vals):
                    if v is not None:
                        x[i] = v.x
                        y[i] = v.y
                out[name + "__x"] = x
                out[name + "__y"] = y
            elif atype.is_geometry or atype.numpy_dtype is None:
                out[name] = np.array(vals, dtype=object)
            else:
                col = np.zeros(n, dtype=atype.numpy_dtype)
                nulls = np.zeros(n, dtype=bool)
                for i, v in enumerate(vals):
                    if v is None:
                        nulls[i] = True
                    else:
                        col[i] = v
                out[name] = col
                if nulls.any():
                    out[name + "__null"] = nulls
        return out_ft, out

    def _reader(self, expr: _Expr, columns) -> Callable[[int], object]:
        accessors = {}

        def attr_value(aname: str, i: int):
            fn = accessors.get(aname)
            if fn is None:
                fn = self._accessor(aname, columns)
                accessors[aname] = fn
            return fn(i)

        def run(i: int):
            fields = _RowFields(attr_value, i)
            return expr([], fields)

        return run

    def _accessor(self, aname: str, columns) -> Callable[[int], object]:
        attr = self.ft.attr(aname)
        if attr.type == AttributeType.POINT:
            x = columns[aname + "__x"]
            y = columns[aname + "__y"]
            return lambda i: None if np.isnan(x[i]) else Point(float(x[i]), float(y[i]))
        col = columns[aname]
        nulls = columns.get(aname + "__null")
        if nulls is not None:
            return lambda i: None if nulls[i] else col[i].item() if hasattr(col[i], "item") else col[i]
        if col.dtype == object:
            return lambda i: col[i]
        return lambda i: col[i].item()


class _RowFields:
    """dict-like $attr resolver bound to one candidate row."""

    def __init__(self, attr_value, i):
        self._attr_value = attr_value
        self._i = i

    def __getitem__(self, name):
        return self._attr_value(name, self._i)
