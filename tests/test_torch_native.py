"""The port's native host libraries against their plain editions and the JAX package's.

``geomesa_tpu_torch/native`` builds copies of the reference's four C++
sources. Each function is held, on the same seeded inputs, against the
port's own Python or numpy edition (``GEOMESA_TPU_NO_NATIVE=1``) and against
``geomesa_tpu.native``'s function: the z and xz range walks (same bounds,
flags and order), the bitmap decode (same rows, in order; a count that is
too small raises) and both seek scans. The loader's status says why a
library did not load, and concurrent builds of one source do not collide.
"""

import os
import threading
import time

import numpy as np
import pytest

from geomesa_tpu import native as ref_native
from geomesa_tpu_torch import native
from geomesa_tpu_torch.curve import zorder
from geomesa_tpu_torch.curve.sfc import Z2SFC, Z3SFC
from geomesa_tpu_torch.curve.xz import XZ2SFC, XZ3SFC
from geomesa_tpu_torch.parallel.executor import _decode_bitmap_rows


# the reference's loaders: a library each, the two seek scans sharing one
_REF_LIBS = ("_BITDECODE", "_ZRANGES", "_XZRANGES", "_SEEKSCAN", "_ENVSCAN")
# how long a reference library may take to land (each retry may build it)
_REF_LOAD_S = 180.0


@pytest.fixture(autouse=True)
def _loaded():
    st = native.build_all()
    assert all(v["loaded"] for v in st.values()), st


@pytest.fixture(scope="module", autouse=True)
def _reference_loaded():
    """Every reference library loaded before a test compares with it.

    ``geomesa_tpu.native`` builds a library at first use into one file
    shared by every process (``<so>.tmp``, then a rename) and keeps a
    failed load as None for the life of the process. Under parallel test
    workers another worker's build of the same file can fail this
    worker's first load (``tests/test_native.py`` loads at import, in
    every worker at once), and a comparison would then be against None.
    So each loader is asked again, once a second, until the build that
    landed loads; its own retry flag is all that is reset."""
    if os.environ.get("GEOMESA_TPU_NO_NATIVE"):
        pytest.fail("GEOMESA_TPU_NO_NATIVE is set: the reference's libraries are disabled")
    for name in _REF_LIBS:
        lib = getattr(ref_native, name)
        deadline = time.monotonic() + _REF_LOAD_S
        while lib.load() is None:
            if time.monotonic() > deadline:
                state = "present" if os.path.exists(lib.so) else "missing"
                pytest.fail(f"the reference's {os.path.basename(lib.src)} did not load in "
                            f"{_REF_LOAD_S:.0f} s ({lib.so} {state}; g++ on PATH?)")
            time.sleep(1.0)
            lib._tried = False


def _plain(monkeypatch, fn, *args, **kw):
    """``fn`` with the native libraries disabled (the plain editions)."""
    with monkeypatch.context() as mp:
        mp.setenv("GEOMESA_TPU_NO_NATIVE", "1")
        return fn(*args, **kw)


def _tuples(arrays):
    lo, hi, cont = arrays
    return list(zip(lo.tolist(), hi.tolist(), cont.tolist()))


def _boxes(rng, bits, dims, k):
    top = (1 << bits) - 1
    mins, maxs = [], []
    for _ in range(k):
        lo = rng.integers(0, top, dims)
        mins.append(lo)
        maxs.append(np.minimum(lo + rng.integers(1, top // 4, dims), top))
    return mins, maxs


@pytest.mark.parametrize("dims,bits", [(2, 31), (3, 21), (2, 10), (3, 8)])
@pytest.mark.parametrize("max_ranges", [None, 10, 200, 2000])
@pytest.mark.parametrize("skip", [False, True])
def test_zranges_matches_python_and_reference(monkeypatch, dims, bits, max_ranges, skip):
    if max_ranges is None and bits > 10:
        max_ranges = 5000  # the unbounded full-depth Python walk is slow
    rng = np.random.default_rng(17 + dims * bits)
    mins, maxs = _boxes(rng, bits, dims, 3)
    skip_mins = [m + 1 for m in mins] if skip else None
    skip_maxs = [m - 1 for m in maxs] if skip else None
    args = (mins, maxs, bits, dims, max_ranges, 64, skip_mins, skip_maxs)
    got = _tuples(native.zranges_native(*args))
    pure = _plain(monkeypatch, zorder.zranges, *args)
    assert got == [(r.lower, r.upper, r.contained) for r in pure]
    assert got == _tuples(ref_native.zranges_native(*args))
    assert _tuples(zorder.zranges_arrays(*args)) == got  # the planner's entry
    assert _tuples(_plain(monkeypatch, zorder.zranges_arrays, *args)) == got


@pytest.mark.parametrize("budget", [0, -1])
def test_zranges_nonpositive_budget(monkeypatch, budget):
    """A zero or negative budget is an exhausted one, never unbounded."""
    args = ([(3, 2)], [(200, 180)], 8, 2, budget)
    assert _tuples(zorder.zranges_arrays(*args)) == \
        [(r.lower, r.upper, r.contained) for r in zorder.zranges(*args)]
    sfc = XZ2SFC.for_g(12)
    box = [(0.0, 0.0, 20.0, 15.0)]
    assert sfc.ranges(box, max_ranges=budget) == _plain(
        monkeypatch, sfc.ranges, box, max_ranges=budget)


def test_sfc_ranges_arrays_wired(monkeypatch):
    """Z2/Z3 ``ranges_arrays`` (the keyspace's entry) equal the Python
    walk, skip flags included, with the library and without it."""
    z2 = Z2SFC()
    boxes = [(-10.0, -10.0, 10.0, 10.0), (100.0, 40.0, 120.0, 60.0)]
    pure = _plain(monkeypatch, z2.ranges, boxes, max_ranges=500, exact_skip=True)
    arrs = z2.ranges_arrays(boxes, max_ranges=500, exact_skip=True)
    assert _tuples(arrs) == [(r.lower, r.upper, r.contained) for r in pure]
    assert any(r.contained for r in pure)
    z3 = Z3SFC.for_period("week")
    win = [(3600, 5 * 86400)]  # in-bin offsets (s)
    pure = _plain(monkeypatch, z3.ranges, boxes[:1], win, max_ranges=300, exact_skip=True)
    arrs = z3.ranges_arrays(boxes[:1], win, max_ranges=300, exact_skip=True)
    assert _tuples(arrs) == [(r.lower, r.upper, r.contained) for r in pure]
    pure = z2.ranges(boxes, max_ranges=10)
    arrs = _plain(monkeypatch, z2.ranges_arrays, boxes, max_ranges=10)
    assert _tuples(arrs) == [(r.lower, r.upper, r.contained) for r in pure]
    assert arrs[0].dtype == np.uint64 and arrs[2].dtype == bool


@pytest.mark.parametrize("budget", [None, 50, 500])
def test_xzranges_matches_python_and_reference(monkeypatch, budget):
    rng = np.random.default_rng(5)
    cases = []
    for _ in range(12):
        x0, y0 = rng.uniform(-170, 150), rng.uniform(-80, 60)
        cases.append((x0, y0, x0 + rng.uniform(0.01, 40), y0 + rng.uniform(0.01, 30)))
    if budget is None:  # the unbounded Python walk costs ~ box area
        cases = sorted(cases, key=lambda c: (c[2] - c[0]) * (c[3] - c[1]))[:4]
    sfc = XZ2SFC.for_g(12)
    for box in cases:
        got = sfc.ranges([box], max_ranges=budget)
        assert got == _plain(monkeypatch, sfc.ranges, [box], max_ranges=budget), box
        qmin, qmax = sfc._normalize(
            [np.asarray([box[0]]), np.asarray([box[1]])],
            [np.asarray([box[2]]), np.asarray([box[3]])], False)
        qmin, qmax = [float(v[0]) for v in qmin], [float(v[0]) for v in qmax]
        assert native.xzranges_native([qmin], [qmax], 2, 12, budget) == \
            ref_native.xzranges_native([qmin], [qmax], 2, 12, budget)
        assert [(r.lower, r.upper, r.contained) for r in got] == \
            native.xzranges_native([qmin], [qmax], 2, 12, budget)
    sfc3 = XZ3SFC.for_period(12, "week")
    q = [(-20.0, -10.0, 100000.0, 30.0, 25.0, 400000.0)]
    assert sfc3.ranges(q, max_ranges=200) == _plain(monkeypatch, sfc3.ranges, q, max_ranges=200)


def test_xzranges_out_of_domain_falls_back_to_python():
    """g > 20 is outside the C++ walk's domain: it declines and the Python
    walk answers, as the reference does."""
    assert native.xzranges_native([[0.1, 0.1]], [[0.2, 0.2]], 2, 21, 50) is None
    assert ref_native.xzranges_native([[0.1, 0.1]], [[0.2, 0.2]], 2, 21, 50) is None
    assert len(XZ2SFC.for_g(21).ranges([(-10.0, -10.0, 10.0, 10.0)], max_ranges=50)) > 0


@pytest.mark.parametrize("n_bytes,p", [(1, 0.5), (7, 0.9), (8, 0.0), (1024, 0.02),
                                       (100_003, 0.3)])
def test_bitmap_rows_matches_numpy_and_reference(monkeypatch, n_bytes, p):
    rng = np.random.default_rng(3 + n_bytes)
    bits = (rng.random(n_bytes * 8) < p).astype(np.uint8)
    packed = np.packbits(bits)
    want = 1000 + np.flatnonzero(bits)
    cnt = int(bits.sum())
    got = native.bitmap_rows_native(packed, 1000, cnt)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_native.bitmap_rows_native(packed, 1000, cnt))
    np.testing.assert_array_equal(_decode_bitmap_rows(packed, 1000, cnt), want)
    np.testing.assert_array_equal(
        _plain(monkeypatch, _decode_bitmap_rows, packed, 1000, cnt), want)


def test_bitmap_rows_raises_on_a_count_too_small():
    """A window with more set bits than its header's count is corrupt: the
    decode raises (None would mean 'library unavailable')."""
    packed = np.packbits(np.ones(64, np.uint8))
    with pytest.raises(ValueError, match="corrupt bitmap"):
        native.bitmap_rows_native(packed, 0, 63)
    with pytest.raises(ValueError, match="corrupt bitmap"):
        _decode_bitmap_rows(packed, 0, 63)
    with pytest.raises(ValueError, match="corrupt bitmap"):
        native.bitmap_rows_native(packed[:1], 0, 0)


def _intervals(rng, n, k):
    cuts = np.sort(rng.choice(n, 2 * k, replace=False))
    return cuts[0::2].astype(np.int64), cuts[1::2].astype(np.int64)


@pytest.mark.parametrize("with_time", [True, False])
def test_seek_scan_matches_numpy_and_reference(with_time):
    rng = np.random.default_rng(11)
    n = 20_000
    x = rng.uniform(-20, 20, n)
    y = rng.uniform(-20, 20, n)
    t = rng.integers(0, 10_000, n).astype(np.int64)
    x[:4] = [-5.0, 5.0, 0.0, 0.0]  # rows on the box's edges
    y[:4] = [0.0, 0.0, -4.0, 4.0]
    t[:4] = [100, 9000, 100, 9000]
    starts, ends = _intervals(rng, n, 40)
    starts[0] = 0
    covered = rng.random(len(starts)) < 0.2
    box, lo, hi = (-5.0, -4.0, 5.0, 4.0), 100, 9000
    tt = t if with_time else None
    got = native.seek_scan_native(x, y, tt, starts, ends, covered, box, lo, hi)
    want = ref_native.seek_scan_native(x, y, tt, starts, ends, covered, box, lo, hi)
    np.testing.assert_array_equal(got, want)
    rows = np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)])
    cov = np.repeat(covered, ends - starts)
    m = (x[rows] >= box[0]) & (x[rows] <= box[2]) & (y[rows] >= box[1]) & (y[rows] <= box[3])
    if with_time:
        m &= (t[rows] >= lo) & (t[rows] <= hi)
    np.testing.assert_array_equal(got, rows[m | cov])
    assert {0, 1, 2, 3} <= set(got.tolist())


@pytest.mark.parametrize("rect", [True, False])
def test_env_seek_scan_matches_numpy_and_reference(rect):
    rng = np.random.default_rng(12)
    n = 20_000
    x0 = rng.uniform(-30, 25, n)
    y0 = rng.uniform(-30, 25, n)
    w = rng.uniform(0.01, 5, n)
    env = [x0, y0, x0 + w, y0 + w]
    for c in env:
        c[:50] = 0.0  # null geometries: the all-zero placeholder envelope
    isrect = (rng.random(n) < 0.3).astype(np.uint8)
    starts, ends = _intervals(rng, n, 30)
    starts[0] = 0
    qenv = (-10.0, -8.0, 12.0, 9.0)
    got = native.env_seek_scan_native(*env, starts, ends, qenv, rect, isrect=isrect)
    want = ref_native.env_seek_scan_native(*env, starts, ends, qenv, rect, isrect=isrect)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    rows = np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)])
    bx, by, cx, cy = (c[rows] for c in env)
    over = (cx >= qenv[0]) & (bx <= qenv[2]) & (cy >= qenv[1]) & (by <= qenv[3])
    inside = (bx >= qenv[0]) & (cx <= qenv[2]) & (by >= qenv[1]) & (cy <= qenv[3])
    placeholder = (bx == 0) & (by == 0) & (cx == 0) & (cy == 0)
    dec = rect & ~placeholder & (inside | isrect[rows].astype(bool))
    np.testing.assert_array_equal(got[0], rows[over])
    np.testing.assert_array_equal(got[1], dec[over])
    assert got[1].any() == rect


def test_status_says_why_a_library_did_not_load(monkeypatch, tmp_path):
    st = native.status()
    assert set(st) == {"bitdecode", "zranges", "xzranges", "seekscan"}
    assert all(v["loaded"] and v["reason"] is None for v in st.values())
    monkeypatch.setenv("GEOMESA_TPU_NO_NATIVE", "1")
    assert native.load() is None
    assert native.zranges_native([[0, 0]], [[3, 3]], 4, 2, None, 64) is None
    assert native.status()["zranges"]["reason"] == "disabled by GEOMESA_TPU_NO_NATIVE"
    monkeypatch.delenv("GEOMESA_TPU_NO_NATIVE")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    lib = native._NativeLib("bad", str(bad), {})
    assert lib.load() is None
    assert lib.status()["reason"].startswith("build failed: g++ -O3 -march=native")
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))
    monkeypatch.setenv("PATH", str(tmp_path))
    lib = native._NativeLib("nocc", native._BITDECODE.src, {})
    assert lib.load() is None and lib.status()["reason"] == "g++ not found"


def test_concurrent_builds_of_one_source_do_not_collide(monkeypatch, tmp_path):
    """Parallel test workers may build the same library at once: each
    writes a temporary file of its own and renames it into place."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    libs = [native._NativeLib("bitdecode", native._BITDECODE.src,
                              native._BITDECODE.symbols) for _ in range(4)]
    threads = [threading.Thread(target=lib.load) for lib in libs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert all(lib.status()["loaded"] for lib in libs)
    assert len(list(tmp_path.glob("*.so"))) == 1 and not list(tmp_path.glob("*.tmp"))
    out = np.empty(8, np.int64)
    assert libs[0].load().bitmap_rows(
        np.packbits(np.ones(8, np.uint8)).ctypes.data_as(native._c_u8p), 1, 0,
        out.ctypes.data_as(native._c_i64p), 8) == 8
