"""Native (C++) host kernels of the scan path, built at first use, bound via ctypes.

Port of ``geomesa_tpu/native/__init__.py``. The four sources in this
directory are copies of the reference's:

  bitdecode.cpp  span-window bitmap -> row indices (the host decode of the
                 bitmap wire format)
  zranges.cpp    z2/z3 quad/oct-tree range decomposition (+ skip boxes)
  xzranges.cpp   XZ sequence-interval BFS (extent indices)
  seekscan.cpp   one-pass candidate-interval filters (the host-seek scan)

Each source builds with the host ``g++`` on first use into
``geomesa_tpu_torch/_build/`` (``-O3 -march=native``, retried with ``-O2``
only when that fails to compile). A library's file name carries a hash of
its source, its flags and the host's CPU tag, so a library built for one CPU
is never loaded on another; a build writes a per-process temporary file and
renames it into place, so concurrent builds do not collide.

Every function has a plain Python or numpy edition at its call site, which
the tests hold the C++ against. A ``*_native`` function returns None only
when its library is unavailable: ``GEOMESA_TPU_NO_NATIVE=1`` (read at each
call), no compiler, or a failed build. ``status()`` says which, and why.
Any other failure raises; a corrupt bitmap count raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# flags tried in order; the next is tried only after a compile error
_FLAG_SETS = (("-O3", "-march=native"), ("-O2",))


def _host_tag() -> str:
    """Short fingerprint of this host's CPU (machine + ISA flags): a library
    built with -march=native on one host is never loaded on another
    (SIGILL)."""
    sig = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    sig += line
                    break
    except OSError:
        pass
    return hashlib.md5(sig.encode()).hexdigest()[:10]


def _disabled() -> bool:
    return bool(os.environ.get("GEOMESA_TPU_NO_NATIVE"))


class _NativeLib:
    """One lazily built, cached ctypes library of one source and its
    exported symbols (name -> (restype, argtypes)). ``load`` builds once
    per process; ``status`` records the outcome."""

    def __init__(self, name: str, src: str, symbols: Dict[str, tuple]):
        self.name = name
        self.src = os.path.join(_DIR, src)
        self.symbols = symbols
        self._lib = None
        self._tried = False
        self._lock = threading.Lock()
        self.path: Optional[str] = None
        self.flags: Optional[tuple] = None
        self.build_s = 0.0
        self.reason: Optional[str] = None  # why the library did not load

    def _out_path(self, flags) -> str:
        h = hashlib.sha256(" ".join(flags).encode() + b"\0" + _host_tag().encode())
        with open(self.src, "rb") as f:
            h.update(f.read())
        return os.path.join(BUILD_DIR, f"{self.name}.{h.hexdigest()[:12]}.so")

    def _build(self) -> Optional[str]:
        """Path of the built library, or None with ``reason`` set."""
        errors = []
        for flags in _FLAG_SETS:
            out = self._out_path(flags)
            if os.path.exists(out):
                self.flags = flags
                return out
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    ["g++", *flags, "-shared", "-fPIC", "-o", tmp, self.src],
                    capture_output=True, text=True, timeout=300,
                )
            except FileNotFoundError:
                self.reason = "g++ not found"
                return None
            except subprocess.TimeoutExpired:
                self.reason = f"g++ {' '.join(flags)} timed out"
                return None
            self.build_s += time.perf_counter() - t0
            if proc.returncode == 0:
                os.replace(tmp, out)
                self.flags = flags
                return out
            errors.append(f"g++ {' '.join(flags)}: {proc.stderr.strip()}")
            if os.path.exists(tmp):
                os.remove(tmp)
        self.reason = "build failed: " + " | ".join(errors)
        return None

    def load(self):
        """The ctypes library, or None when unavailable."""
        if _disabled():
            return None
        with self._lock:
            if not self._tried:
                self._tried = True
                path = self._build()
                try:
                    lib = None if path is None else ctypes.CDLL(path)
                except OSError as e:
                    self.reason = f"load failed: {e}"
                    lib = None
                if lib is not None:
                    for sym, (restype, argtypes) in self.symbols.items():
                        fn = getattr(lib, sym)
                        fn.restype = restype
                        fn.argtypes = argtypes
                    self.path = path
                    self._lib = lib
            return self._lib

    def status(self) -> dict:
        if _disabled():
            loaded, reason = False, "disabled by GEOMESA_TPU_NO_NATIVE"
        elif not self._tried:
            loaded, reason = False, "not loaded yet"
        else:
            loaded, reason = self._lib is not None, self.reason
        return {
            "loaded": loaded,
            "reason": None if loaded else reason,
            "source": os.path.relpath(self.src, os.path.dirname(os.path.dirname(_DIR))),
            "path": self.path,
            "flags": " ".join(self.flags) if self.flags else None,
            "build_s": self.build_s,
        }


_c_u32p = ctypes.POINTER(ctypes.c_uint32)
_c_u64p = ctypes.POINTER(ctypes.c_uint64)
_c_u8p = ctypes.POINTER(ctypes.c_uint8)
_c_i64p = ctypes.POINTER(ctypes.c_int64)
_c_f64p = ctypes.POINTER(ctypes.c_double)
_LL = ctypes.c_longlong
_D = ctypes.c_double

_BITDECODE = _NativeLib("bitdecode", "bitdecode.cpp", {
    "bitmap_rows": (_LL, [_c_u8p, _LL, _LL, _c_i64p, _LL]),
})
_ZRANGES = _NativeLib("zranges", "zranges.cpp", {
    "geomesa_zranges": (_LL, [
        _c_u32p, _c_u32p,  # mins, maxs
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nboxes, bits, dims
        _LL, ctypes.c_int,  # max_ranges, precision
        _c_u32p, _c_u32p, ctypes.c_int,  # skip_mins, skip_maxs, nskip
        _c_u64p, _c_u64p, _c_u8p, _LL,  # out lo/hi/cont, cap
    ]),
})
_XZRANGES = _NativeLib("xzranges", "xzranges.cpp", {
    "geomesa_xzranges": (_LL, [
        _c_f64p, _c_f64p,  # qmins, qmaxs (normalized)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nqueries, dims, g
        _LL,  # max_ranges
        _c_i64p, _c_i64p, _c_u8p, _LL,  # out lo/hi/cont, cap
    ]),
})
_SEEKSCAN = _NativeLib("seekscan", "seekscan.cpp", {
    "geomesa_seek_scan": (_LL, [
        _c_f64p, _c_f64p, _c_i64p,  # x, y, t (t nullable)
        _c_i64p, _c_i64p, _c_u8p, _LL,  # starts, ends, covered, nruns
        _D, _D, _D, _D,  # xmin, xmax, ymin, ymax
        ctypes.c_int64, ctypes.c_int64,  # tlo, thi
        _c_i64p, _LL,  # out_rows, cap
    ]),
    "geomesa_env_seek_scan": (_LL, [
        _c_f64p, _c_f64p, _c_f64p, _c_f64p,  # bxmin, bymin, bxmax, bymax
        _c_u8p,  # isrect flags (nullable)
        _c_i64p, _c_i64p, _LL,  # starts, ends, nruns
        _D, _D, _D, _D,  # query box
        ctypes.c_int,  # rect_query
        _c_i64p, _c_u8p, _LL,  # out_rows, out_decided, cap
    ]),
})
LIBRARIES = (_BITDECODE, _ZRANGES, _XZRANGES, _SEEKSCAN)


def load_bitdecode():
    """The bitmap-decode library; None when unavailable."""
    return _BITDECODE.load()


def load():
    """The zranges library; None when unavailable."""
    return _ZRANGES.load()


def load_xz():
    """The XZ-ranges library; None when unavailable."""
    return _XZRANGES.load()


def load_seek():
    """The seek-scan library (both symbols); None when unavailable."""
    return _SEEKSCAN.load()


def build_all() -> Dict[str, dict]:
    """Build and load every library at once (one g++ each, in parallel);
    returns ``status()``."""
    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        list(pool.map(lambda lib: lib.load(), LIBRARIES))
    return status()


def status() -> Dict[str, dict]:
    """Per library: loaded or not, and why not (``reason``: the compiler's
    error text, a missing compiler, GEOMESA_TPU_NO_NATIVE, or not loaded
    yet), its source, path, flags and build seconds."""
    return {lib.name: lib.status() for lib in LIBRARIES}


def bitmap_rows_native(bits, base: int, max_out: int):
    """Packed bitmap (np.packbits big bit order) -> int64 row indices (bit
    index + ``base``); None when the library is unavailable. ``max_out``
    bounds the output (callers know the set-bit count from the wire
    header); a popcount above it raises ``ValueError``: the header and
    the bitmap disagree."""
    lib = load_bitdecode()
    if lib is None:
        return None
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    out = np.empty(max(int(max_out), 0), dtype=np.int64)
    k = lib.bitmap_rows(
        bits.ctypes.data_as(_c_u8p), len(bits), int(base),
        out.ctypes.data_as(_c_i64p), len(out),
    )
    if k < 0:
        raise ValueError(
            f"corrupt bitmap wire data: popcount exceeds header count {max_out}"
        )
    return out[:k]


def zranges_native(mins, maxs, bits: int, dims: int, max_ranges: Optional[int],
                   precision: int, skip_mins=None, skip_maxs=None):
    """Native decomposition as (lower[], upper[], contained[]) uint64 /
    uint64 / bool arrays; None when the library is unavailable or ``dims``
    is outside its domain (1..3)."""
    if dims < 1 or dims > 3:
        return None
    lib = load()
    if lib is None:
        return None
    m = np.ascontiguousarray(np.asarray(mins, dtype=np.uint32).reshape(-1))
    x = np.ascontiguousarray(np.asarray(maxs, dtype=np.uint32).reshape(-1))
    nboxes = len(m) // dims
    if skip_mins is not None:
        sm = np.ascontiguousarray(np.asarray(skip_mins, dtype=np.uint32).reshape(-1))
        sx = np.ascontiguousarray(np.asarray(skip_maxs, dtype=np.uint32).reshape(-1))
        nskip = len(sm) // dims
        sm_p, sx_p = sm.ctypes.data_as(_c_u32p), sx.ctypes.data_as(_c_u32p)
    else:
        nskip = -1  # the cell-in-box meaning of ``contained``
        sm_p = sx_p = _c_u32p()
    cap = max(4 * (max_ranges or 0), 1 << 16)
    # a negative budget is an exhausted one (as in the Python walk), never
    # the C++ 'unbounded' sentinel
    budget = -1 if max_ranges is None else max(0, int(max_ranges))
    while True:
        lo = np.empty(cap, dtype=np.uint64)
        hi = np.empty(cap, dtype=np.uint64)
        cont = np.empty(cap, dtype=np.uint8)
        n = lib.geomesa_zranges(
            m.ctypes.data_as(_c_u32p), x.ctypes.data_as(_c_u32p), nboxes, bits, dims,
            budget, precision, sm_p, sx_p, nskip,
            lo.ctypes.data_as(_c_u64p), hi.ctypes.data_as(_c_u64p),
            cont.ctypes.data_as(_c_u8p), cap,
        )
        if n >= 0:
            # copies: cached plans must not hold the 64K-entry scratch buffers
            return lo[:n].copy(), hi[:n].copy(), cont[:n].astype(bool)
        cap = int(-n) + 16


def xzranges_native(qmins, qmaxs, dims: int, g: int, max_ranges: Optional[int]):
    """Native XZ BFS over normalized [0, 1] windows as [(lower, upper,
    contained)]; None when the library is unavailable or (dims, g) is
    outside its domain (2..3, 1..20): the Python walk answers then."""
    if dims < 2 or dims > 3 or g < 1 or g > 20:
        return None
    lib = load_xz()
    if lib is None:
        return None
    m = np.ascontiguousarray(np.asarray(qmins, dtype=np.float64).reshape(-1))
    x = np.ascontiguousarray(np.asarray(qmaxs, dtype=np.float64).reshape(-1))
    nq = len(m) // dims
    budget = -1 if max_ranges is None else max(0, int(max_ranges))
    cap = max(4 * (max_ranges or 0) + (1 << dims) * (g + 1), 1 << 16)
    while True:
        lo = np.empty(cap, dtype=np.int64)
        hi = np.empty(cap, dtype=np.int64)
        cont = np.empty(cap, dtype=np.uint8)
        n = lib.geomesa_xzranges(
            m.ctypes.data_as(_c_f64p), x.ctypes.data_as(_c_f64p), nq, dims, g, budget,
            lo.ctypes.data_as(_c_i64p), hi.ctypes.data_as(_c_i64p),
            cont.ctypes.data_as(_c_u8p), cap,
        )
        if n >= 0:
            return list(zip(lo[:n].tolist(), hi[:n].tolist(), cont[:n].astype(bool).tolist()))
        cap = int(-n) + 16


def _exact_cap(starts, ends) -> int:
    return int(np.maximum(np.asarray(ends) - np.asarray(starts), 0).sum())


def seek_scan_native(x, y, t, starts, ends, covered, box, tlo, thi):
    """One-pass candidate-interval filter (seekscan.cpp
    ``geomesa_seek_scan``): the rows of the [start, end) intervals inside
    ``box`` = (xmin, ymin, xmax, ymax) and, unless ``t`` is None, the
    inclusive ms window [tlo, thi]; rows of ``covered`` intervals pass
    untested. None when the library is unavailable."""
    lib = load_seek()
    if lib is None:
        return None
    xs = np.ascontiguousarray(x, dtype=np.float64)
    ys = np.ascontiguousarray(y, dtype=np.float64)
    st = np.ascontiguousarray(starts, dtype=np.int64)
    en = np.ascontiguousarray(ends, dtype=np.int64)
    cv = np.ascontiguousarray(covered, dtype=np.uint8)
    if t is not None:
        ts = np.ascontiguousarray(t, dtype=np.int64)
        t_p, lo, hi = ts.ctypes.data_as(_c_i64p), int(tlo), int(thi)
    else:
        t_p, lo, hi = _c_i64p(), 0, 0
    cap = _exact_cap(st, en)
    out = np.empty(max(cap, 1), dtype=np.int64)
    n = lib.geomesa_seek_scan(
        xs.ctypes.data_as(_c_f64p), ys.ctypes.data_as(_c_f64p), t_p,
        st.ctypes.data_as(_c_i64p), en.ctypes.data_as(_c_i64p), cv.ctypes.data_as(_c_u8p),
        len(st), float(box[0]), float(box[2]), float(box[1]), float(box[3]), lo, hi,
        out.ctypes.data_as(_c_i64p), cap,
    )
    if n < 0:
        raise RuntimeError("seek scan overflowed its exact capacity")
    return out[:n]


def env_seek_scan_native(bxmin, bymin, bxmax, bymax, starts, ends, qenv,
                         rect_query: bool, isrect=None):
    """Extent candidate filter (seekscan.cpp ``geomesa_env_seek_scan``):
    (rows, decided) of the rows whose envelope overlaps ``qenv`` = (xmin,
    ymin, xmax, ymax); ``decided`` marks rows the envelope alone answers
    for a rectangle query. ``isrect``: optional flags of rows whose
    geometry is its envelope. None when the library is unavailable."""
    lib = load_seek()
    if lib is None:
        return None
    cols = [np.ascontiguousarray(c, dtype=np.float64) for c in (bxmin, bymin, bxmax, bymax)]
    st = np.ascontiguousarray(starts, dtype=np.int64)
    en = np.ascontiguousarray(ends, dtype=np.int64)
    if isrect is not None:
        ir = np.ascontiguousarray(isrect, dtype=np.uint8)
        ir_p = ir.ctypes.data_as(_c_u8p)
    else:
        ir_p = _c_u8p()
    cap = _exact_cap(st, en)
    rows = np.empty(max(cap, 1), dtype=np.int64)
    dec = np.empty(max(cap, 1), dtype=np.uint8)
    n = lib.geomesa_env_seek_scan(
        *(c.ctypes.data_as(_c_f64p) for c in cols), ir_p,
        st.ctypes.data_as(_c_i64p), en.ctypes.data_as(_c_i64p), len(st),
        float(qenv[0]), float(qenv[1]), float(qenv[2]), float(qenv[3]),
        1 if rect_query else 0,
        rows.ctypes.data_as(_c_i64p), dec.ctypes.data_as(_c_u8p), cap,
    )
    if n < 0:
        raise RuntimeError("envelope seek scan overflowed its exact capacity")
    return rows[:n], dec[:n].astype(bool)
