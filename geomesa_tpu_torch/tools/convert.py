"""The transform expression language of the feature converters.

Port of ``geomesa_tpu/tools/convert.py`` trimmed to its expression language
(``_Expr`` through ``parse_transform``, lines 46-608, and the functions its
registry reaches): the geomesa-convert ``Transformers`` analog that query
transforms (``index/transforms.py``) evaluate. Expressions: ``$N`` (the
1-based input column; ``$0`` the whole record), ``$name`` (a field, for a
query transform the feature's attribute), string and number literals and
nested calls of the registry's functions (``toInt``, ``concat``,
``uppercase``, ``point``, ``date``, ``regexReplace``, ...; names are case
blind). The converter itself (``SimpleFeatureConverter``,
``infer_converter``) is not in this slice of the port (ROADMAP Queue 1
item 14).
"""

from __future__ import annotations

import base64
import hashlib
import json
import math
import re
import threading
import time
import uuid as uuidlib
from datetime import datetime, timezone
from typing import Any, Callable, Dict, List, Optional, Sequence

from geomesa_tpu_torch.geom.base import Point
from geomesa_tpu_torch.geom.wkt import parse_wkt

# ---------------------------------------------------------------------------
# expression language
# ---------------------------------------------------------------------------

class _Expr:
    def __call__(self, cols: Sequence[Any], fields: Dict[str, Any]) -> Any:
        raise NotImplementedError


class _Lit(_Expr):
    def __init__(self, v):
        self.v = v

    def __call__(self, cols, fields):
        return self.v


class _Col(_Expr):
    def __init__(self, idx: int):
        self.idx = idx

    def __call__(self, cols, fields):
        if self.idx == 0:
            # $0 = the whole record: for delimited rows the delimiter-joined
            # fields (stable across the row and vectorized ingest paths)
            return getattr(cols, "raw", cols)
        v = cols[self.idx - 1]
        return v


class _Field(_Expr):
    def __init__(self, name: str):
        self.name = name

    def __call__(self, cols, fields):
        return fields[self.name]


class _Call(_Expr):
    def __init__(self, fn: Callable, args: List[_Expr], name: str = ""):
        self.fn = fn
        self.args = args
        self.name = name  # lowercase function name (for type inference)

    def __call__(self, cols, fields):
        return self.fn(*[a(cols, fields) for a in self.args])


def java_date_format(fmt: str) -> str:
    """Translate a Java DateTimeFormatter pattern (what reference converter
    configs use, e.g. 'yyyyMMdd') to a strptime pattern. Patterns already
    containing '%' pass through untouched."""
    if "%" in fmt:
        return fmt
    out = []
    i = 0
    subs = [
        ("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"),
        ("HH", "%H"), ("mm", "%M"), ("ss", "%S"), ("SSS", "%f"),
        ("DDD", "%j"),
    ]
    while i < len(fmt):
        if fmt[i] == "'":  # quoted literal, e.g. 'T'
            j = fmt.index("'", i + 1)
            out.append(fmt[i + 1 : j])
            i = j + 1
            continue
        for pat, rep in subs:
            if fmt.startswith(pat, i):
                out.append(rep)
                i += len(pat)
                break
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


def _fn_date(fmt: str, v: Any) -> int:
    """Parse to epoch millis. fmt 'ISO' handles ISO-8601; else strptime
    (Java DateTimeFormatter patterns are translated automatically)."""
    if v is None or v == "":
        return None
    s = str(v).strip()
    if fmt.upper() in ("ISO", "ISO8601", "ISODATETIME"):
        s2 = s.replace("Z", "+00:00")
        dt = datetime.fromisoformat(s2)
    else:
        dt = datetime.strptime(s, java_date_format(fmt))
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return int(dt.timestamp() * 1000)


# single definitions shared by every alias key in _FUNCTIONS (datetime/
# isodatetime; millisToDate/toInt/toLong; secsToDate/secsToMillis)
_FN_ISO_DATETIME = lambda v: _fn_date("ISO", v)  # noqa: E731
_FN_MILLIS = lambda v: None if v in (None, "") else int(float(v))  # noqa: E731
_FN_SECS_TO_MILLIS = lambda v: None if v in (None, "") else int(float(v) * 1000)  # noqa: E731
_FN_CONCAT = lambda *a: "".join("" if x is None else str(x) for x in a)  # noqa: E731
_FN_STRLEN = lambda v: 0 if v is None else len(str(v))  # noqa: E731


def _fn_md5(v) -> Optional[str]:
    if v is None:
        return None
    raw = v if isinstance(v, (bytes, bytearray)) else str(v).encode()
    return hashlib.md5(raw).hexdigest()


def _murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86 32-bit (public-domain algorithm, Austin Appleby).
    Id-function analog of Transformers.scala IdFunctionFactory murmur3_32
    (Guava Hashing.murmur3_32 over the UTF-8 string)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data)
    rounded = n - (n % 4)
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _murmur3_128_h1(data: bytes, seed: int = 0) -> int:
    """First 64-bit half of MurmurHash3 x64 128-bit — what Guava's
    murmur3_128(...).asLong() returns (Transformers.scala murmur3_64).
    Returned as a SIGNED 64-bit int to match the JVM long."""
    m = 0xFFFFFFFFFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def fmix(k):
        k ^= k >> 33
        k = (k * 0xFF51AFD7ED558CCD) & m
        k ^= k >> 33
        k = (k * 0xC4CEB9FE1A85EC53) & m
        k ^= k >> 33
        return k

    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F
    h1 = h2 = seed & m
    n = len(data)
    nblocks = n // 16
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16 : i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8 : i * 16 + 16], "little")
        k1 = (k1 * c1) & m
        k1 = rotl(k1, 31)
        k1 = (k1 * c2) & m
        h1 ^= k1
        h1 = rotl(h1, 27)
        h1 = (h1 + h2) & m
        h1 = (h1 * 5 + 0x52DCE729) & m
        k2 = (k2 * c2) & m
        k2 = rotl(k2, 33)
        k2 = (k2 * c1) & m
        h2 ^= k2
        h2 = rotl(h2, 31)
        h2 = (h2 + h1) & m
        h2 = (h2 * 5 + 0x38495AB5) & m
    tail = data[nblocks * 16 :]
    k1 = k2 = 0
    for i in range(min(len(tail), 16) - 1, 7, -1):
        k2 ^= tail[i] << ((i - 8) * 8)
    if len(tail) > 8:
        k2 = (k2 * c2) & m
        k2 = rotl(k2, 33)
        k2 = (k2 * c1) & m
        h2 ^= k2
    for i in range(min(len(tail), 8) - 1, -1, -1):
        k1 ^= tail[i] << (i * 8)
    if len(tail) > 0:
        k1 = (k1 * c1) & m
        k1 = rotl(k1, 31)
        k1 = (k1 * c2) & m
        h1 ^= k1
    h1 ^= n
    h2 ^= n
    h1 = (h1 + h2) & m
    h2 = (h2 + h1) & m
    h1 = fmix(h1)
    h2 = fmix(h2)
    h1 = (h1 + h2) & m
    return h1 - (1 << 64) if h1 >= 1 << 63 else h1


def _fn_typed_geom(v, want: str):
    """linestring()/polygon()/multipoint()/... parsers: WKT string or
    geometry pass-through, type-checked (Transformers.scala
    GeometryFunctionFactory: each parser casts to its target JTS type)."""
    if v in (None, ""):
        return None
    g = parse_wkt(v) if isinstance(v, str) else v
    if want != "Geometry" and g.geom_type != want:
        raise ValueError(f"{want.lower()}(): got {g.geom_type} from {v!r}")
    return g


def _parse_int_exact(s: str) -> int:
    """Exact integer parse (Long.parseLong fidelity — int(float(s)) would
    corrupt values above 2^53), falling back to float for '2.0'/'1e2'."""
    try:
        return int(str(s).strip())
    except ValueError:
        return int(float(s))


_PARSE_INT = _parse_int_exact
_PARSE_BOOL = lambda s: s.strip().lower() in ("true", "1", "t", "yes")  # noqa: E731

_PARSE_TYPES: Dict[str, Callable[[str], Any]] = {
    # parseList/parseMap element types (Transformers.scala MapListParsing
    # determineClazz: string/int/long/double/float/boolean/bytes/uuid/date)
    "string": str, "str": str,
    "int": _PARSE_INT, "integer": _PARSE_INT, "long": _PARSE_INT,
    "double": float, "float": float,
    "bool": _PARSE_BOOL, "boolean": _PARSE_BOOL,
    "bytes": lambda s: s.encode(),
    "uuid": lambda s: str(uuidlib.UUID(s)),
    "date": lambda s: _fn_date("ISO", s),
}


def _parse_typed(value: str, typ: str) -> Any:
    fn = _PARSE_TYPES.get(str(typ).strip().lower())
    if fn is None:
        raise ValueError(f"unknown element type: {typ}")
    return fn(value)


def _fn_parse_list(typ, s, delim=",") -> List[Any]:
    if s in (None, ""):
        return []
    return [_parse_typed(x.strip(), typ) for x in str(s).split(str(delim))]


def _fn_parse_map(kvtypes, s, kv_delim="->", pair_delim=",") -> Dict[Any, Any]:
    kt, _, vt = str(kvtypes).partition("->")
    if not vt:
        raise ValueError(f"parseMap type spec must be 'ktype->vtype': {kvtypes!r}")
    out: Dict[Any, Any] = {}
    if s in (None, ""):
        return out
    for pair in str(s).split(str(pair_delim)):
        k, sep, v = pair.partition(str(kv_delim))
        if not sep:
            raise ValueError(f"parseMap pair missing {kv_delim!r}: {pair!r}")
        out[_parse_typed(k.strip(), kt)] = _parse_typed(v.strip(), vt)
    return out


def _fn_date_to_string(fmt, millis) -> Optional[str]:
    """dateToString(javaPattern, millis) — Transformers.scala DateToString.
    Java SSS is 3-digit millis; strftime %f would print 6-digit micros,
    so the millis field is substituted directly."""
    if millis in (None, ""):
        return None
    dt = datetime.fromtimestamp(int(millis) / 1000, tz=timezone.utc)
    pat = java_date_format(str(fmt)).replace("%f", "\x00")
    return dt.strftime(pat).replace("\x00", f"{dt.microsecond // 1000:03d}")


def _fn_compact_datetime(v, with_millis: bool):
    """basicDateTime / basicDateTimeNoMillis: compact yyyyMMdd'T'HHmmss
    forms (ISODateTimeFormat.basicDateTime*); lenient fallback to ISO."""
    if v in (None, ""):
        return None
    s = str(v).strip()
    for pat in (("%Y%m%dT%H%M%S.%f%z", "%Y%m%dT%H%M%S.%f") if with_millis
                else ("%Y%m%dT%H%M%S%z", "%Y%m%dT%H%M%S")):
        try:
            dt = datetime.strptime(s, pat)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=timezone.utc)
            return int(dt.timestamp() * 1000)
        except ValueError:
            continue
    return _fn_date("ISO", s)


# current input line number, readable by lineNo()/lineNumber() mid-transform
# (Transformers.scala LineNumberFn reads ctx.counter.getLineCount; the
# converter loop publishes it before evaluating each record's fields —
# thread-local so concurrent converters don't see each other's counter)
_CURRENT_LINENO = threading.local()


def _fn_lineno() -> int:
    return getattr(_CURRENT_LINENO, "value", 0)


def _bytes_arg(v) -> Optional[bytes]:
    if v is None:
        return None
    return bytes(v) if isinstance(v, (bytes, bytearray)) else str(v).encode()


def _fn_point(*args):
    """point(x, y) or point(wkt|geometry) — both reference arities.
    The two-arg form keeps the pre-existing null contract (either
    coordinate null -> null geometry), so the arity check must come
    before any WKT routing."""
    if len(args) == 2:
        x, y = args
        if x in (None, "") or y in (None, ""):
            return None
        return Point(float(x), float(y))
    if len(args) != 1:
        raise ValueError(f"point() takes 1 or 2 arguments, got {len(args)}")
    return _fn_typed_geom(args[0], "Point")


def _fn_string2bytes(v) -> Optional[bytes]:
    return None if v is None else str(v).encode("utf-8")


def _try_cast(convert: Callable[[str], Any]) -> Callable:
    """CastFunctionFactory.tryConvert: null/empty OR unparseable input
    returns the supplied default (None when absent) instead of raising."""

    def fn(v, d=None):
        if v in (None, ""):
            return d
        try:
            return convert(str(v))
        except (ValueError, TypeError):
            return d

    return fn


_FN_CAST_INT = _try_cast(_PARSE_INT)
_FN_CAST_DOUBLE = _try_cast(float)
_FN_CAST_BOOL = _try_cast(_PARSE_BOOL)


_FUNCTIONS: Dict[str, Callable] = {
    "toint": _FN_MILLIS,
    "tolong": _FN_MILLIS,
    "todouble": lambda v: None if v in (None, "") else float(v),
    "tostring": lambda v: None if v is None else str(v),
    "toboolean": lambda v: None if v in (None, "") else str(v).strip().lower() in ("true", "1", "t", "yes"),
    "trim": lambda v: None if v is None else str(v).strip(),
    "strlen": _FN_STRLEN,
    "lowercase": lambda v: None if v is None else str(v).lower(),
    "uppercase": lambda v: None if v is None else str(v).upper(),
    "concat": _FN_CONCAT,
    "concatenate": _FN_CONCAT,
    "date": _fn_date,
    # reference Transformers.scala date aliases: datetime/isodatetime parse
    # ISO-8601, isodate the compact yyyyMMdd form, millisToDate/secsToDate
    # epoch numbers (each behavior defined once; aliases share the lambda)
    "datetime": _FN_ISO_DATETIME,
    "isodatetime": _FN_ISO_DATETIME,
    "isodate": lambda v: _fn_date("yyyyMMdd", v) if v not in (None, "") and "-" not in str(v) else _fn_date("ISO", v),
    "millistodate": _FN_MILLIS,
    "secstodate": _FN_SECS_TO_MILLIS,
    "datetomillis": lambda v: None if v is None else int(v),
    "point": _fn_point,
    "geometry": lambda v: None if v in (None, "") else (v if not isinstance(v, str) else parse_wkt(v)),
    "linestring": lambda v: _fn_typed_geom(v, "LineString"),
    "polygon": lambda v: _fn_typed_geom(v, "Polygon"),
    "multipoint": lambda v: _fn_typed_geom(v, "MultiPoint"),
    "multilinestring": lambda v: _fn_typed_geom(v, "MultiLineString"),
    "multipolygon": lambda v: _fn_typed_geom(v, "MultiPolygon"),
    "geometrycollection": lambda v: _fn_typed_geom(v, "GeometryCollection"),
    "uuid": lambda: str(uuidlib.uuid4()),
    "withdefault": lambda v, d: d if v in (None, "") else v,
    "regexreplace": lambda pattern, repl, v: None if v is None else re.sub(pattern, repl, str(v)),
    "substr": lambda v, a, b: None if v is None else str(v)[int(a) : int(b)],
    "mapvalue": lambda m, k: None if m is None else m.get(k),
    "md5": _fn_md5,
    # arithmetic + string helpers (Transformers.scala math/string fns)
    "add": lambda *a: sum(float(x) for x in a if x not in (None, "")),
    "subtract": lambda a, b: None if None in (a, b) else float(a) - float(b),
    "multiply": lambda *a: math.prod(float(x) for x in a if x not in (None, "")),
    "divide": lambda a, b: None if None in (a, b) or float(b) == 0 else float(a) / float(b),
    "length": _FN_STRLEN,
    "emptytonull": lambda v: None if v in (None, "") else v,
    "capitalize": lambda v: None if v is None else str(v).capitalize(),
    "printf": lambda fmt, *a: str(fmt) % tuple(a),
    "stringtoint": _FN_CAST_INT,
    "stringtolong": _FN_CAST_INT,
    "stringtodouble": _FN_CAST_DOUBLE,
    "stringtofloat": _FN_CAST_DOUBLE,
    "stringtoboolean": _FN_CAST_BOOL,
    "now": lambda: int(time.time() * 1000),
    "secstomillis": _FN_SECS_TO_MILLIS,
    "millistosecs": lambda v: None if v in (None, "") else int(float(v) // 1000),
    # jsonPath('$.a.b[0]', $jsonfield): select within a JSON document
    # string (JsonPathFilterFunction analog; path is document-relative)
    "jsonpath": lambda path, v: _fn_jsonpath(path, v),
    "jsontostring": lambda v: None if v is None else (
        v if isinstance(v, str) else json.dumps(v)
    ),
    # string extras (Transformers.scala StringFunctionFactory)
    "stripquotes": lambda v: None if v is None else str(v).replace('"', ""),
    "mkstring": lambda sep, *a: str(sep).join(str(x) for x in a),
    "stringlength": _FN_STRLEN,
    # math extras (MathFunctionFactory mean/min/max over parseDouble'd args)
    "mean": lambda *a: sum(float(x) for x in a) / len(a),
    "min": lambda *a: min(float(x) for x in a),
    "max": lambda *a: max(float(x) for x in a),
    # id functions (IdFunctionFactory)
    "string2bytes": _fn_string2bytes,
    "stringtobytes": _fn_string2bytes,
    # URL-safe unpadded, matching Base64.encodeBase64URLSafeString
    "base64": lambda v: None if v is None else base64
    .urlsafe_b64encode(_bytes_arg(v)).rstrip(b"=").decode(),
    # hex like Guava HashCode.toString (little-endian byte order)
    "murmur3_32": lambda v: None if v is None
    else _murmur3_32(_bytes_arg(v)).to_bytes(4, "little").hex(),
    "murmur3_64": lambda v: None if v is None else _murmur3_128_h1(_bytes_arg(v)),
    # collections (CollectionFunctionFactory + StringMapListFunctionFactory)
    "list": lambda *a: list(a),
    "parselist": _fn_parse_list,
    "parsemap": _fn_parse_map,
    # date extras (DateFunctionFactory)
    "datetostring": _fn_date_to_string,
    "basicdate": lambda v: _fn_date("yyyyMMdd", v) if v not in (None, "") and "-" not in str(v) else _fn_date("ISO", v),
    "basicdatetime": lambda v: _fn_compact_datetime(v, with_millis=True),
    "basicdatetimenomillis": lambda v: _fn_compact_datetime(v, with_millis=False),
    "datehourminutesecondmillis": lambda v: _fn_date("ISO", v),
    # cast aliases (CastFunctionFactory names)
    "stringtointeger": _FN_CAST_INT,
    "stringtobool": _FN_CAST_BOOL,
    # current input line (LineNumberFunctionFactory lineNo/lineNumber)
    "lineno": _fn_lineno,
    "linenumber": _fn_lineno,
}


def _fn_jsonpath(path, v):
    from geomesa_tpu_torch.filter.jsonpath import extract, parse_path

    if v in (None, ""):
        return None
    path = str(path)
    if path != "$" and not path.startswith(("$.", "$[")):
        # '$foo.bar' would silently glue 'foo' onto the synthetic root;
        # '$[0]...' (root array) stays valid
        raise ValueError(f"jsonPath expects a '$.'-rooted path: {path!r}")
    # document-relative: "$.a.b" selects within v, so prepend a synthetic
    # root segment for the attribute-first parser (parse_path is cached —
    # one parse per distinct path, not per row)
    _, steps = parse_path("$.doc" + path[1:])
    try:
        doc = v if not isinstance(v, str) else json.loads(v)
    except ValueError:
        return None
    return extract(doc, steps)


class _Parser:
    """Recursive-descent parser for the transform mini-language."""

    _TOKEN = re.compile(
        r"\s*(?:(?P<num>-?\d+\.\d+|-?\d+)|(?P<str>'(?:[^'\\]|\\.)*')"
        r"|(?P<dollar>\$[A-Za-z_0-9]+)|(?P<ident>[A-Za-z_][A-Za-z_0-9]*)"
        r"|(?P<punct>[(),]))"
    )

    def __init__(self, text: str, extra: Optional[Dict[str, Callable]] = None):
        self.extra = extra or {}
        self.tokens = []
        pos = 0
        while pos < len(text):
            m = self._TOKEN.match(text, pos)
            if not m:
                if text[pos:].strip():
                    raise ValueError(f"bad transform syntax at: {text[pos:]!r}")
                break
            pos = m.end()
            self.tokens.append(m)
        self.i = 0

    def _peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def _next(self):
        t = self._peek()
        self.i += 1
        return t

    def parse(self) -> _Expr:
        e = self._expr()
        if self._peek() is not None:
            raise ValueError("trailing tokens in transform")
        return e

    def _expr(self) -> _Expr:
        t = self._next()
        if t is None:
            raise ValueError("empty transform")
        if t.group("num"):
            s = t.group("num")
            return _Lit(float(s) if "." in s else int(s))
        if t.group("str"):
            raw = t.group("str")[1:-1]
            return _Lit(raw.replace("\\'", "'").replace("\\\\", "\\"))
        if t.group("dollar"):
            name = t.group("dollar")[1:]
            if name.isdigit():
                return _Col(int(name))
            return _Field(name)
        if t.group("ident"):
            fname = t.group("ident").lower()
            if fname not in _FUNCTIONS and fname not in self.extra:
                raise ValueError(f"unknown transform function: {fname}")
            t2 = self._next()
            if t2 is None or t2.group("punct") != "(":
                raise ValueError(f"expected ( after {fname}")
            args: List[_Expr] = []
            if self._peek() is not None and self._peek().group("punct") == ")":
                self._next()
            else:
                while True:
                    args.append(self._expr())
                    t3 = self._next()
                    if t3 is None:
                        raise ValueError("unterminated call")
                    if t3.group("punct") == ")":
                        break
                    if t3.group("punct") != ",":
                        raise ValueError("expected , or )")
            fn = self.extra.get(fname) or _FUNCTIONS[fname]
            return _Call(fn, args, fname)
        raise ValueError(f"unexpected token {t.group(0)!r}")


def parse_transform(text: str, extra: Optional[Dict[str, Callable]] = None) -> _Expr:
    return _Parser(text, extra).parse()
