"""The port's hand CUDA kernels against their plain PyTorch editions.

These tests need the card: they are marked ``cuda`` and skip without a
CUDA device. The module imports nothing of JAX, so it also runs where JAX
is not installed::

    python -m pytest tests/test_torch_cuda.py -m cuda

Kernel and plain edition must agree bitwise (all integer and boolean work;
the density kernel's f32 band arithmetic is the plain edition's operation
for operation), and the density band's indices as a set.
"""

import glob
import os

import numpy as np
import pytest
import torch

from geomesa_tpu_torch.ops import aggregations as agg
from geomesa_tpu_torch.ops import filters as F
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.zkernels import f64_keys, unpack_mask_rows
from geomesa_tpu_torch.parallel.executor import (
    TorchScanExecutor,
    _decode_bitmap_rows,
    _merge_overlapping_intervals,
)
from join_layouts import LAYOUTS as JOIN_LAYOUTS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rows(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return {
        "xi": rng.integers(0, 1 << 21, n).astype(np.int32),
        "yi": rng.integers(0, 1 << 21, n).astype(np.int32),
        "bins": rng.integers(-1, 4, n).astype(np.int32),
        "offs": rng.integers(0, 1 << 20, n).astype(np.int32),
        "valid": rng.random(n) > 0.1,
        "x": rng.uniform(-20, 20, n),
        "y": rng.uniform(-20, 20, n),
        "t": 1_767_225_600_000 + rng.integers(0, 10 * 86_400_000, n),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 3 * 1024 * 1024 + 4096])
def test_candidate_mask_matches_plain_on_the_card(cuda, n):
    r = {k: torch.from_numpy(v).to(cuda) for k, v in _rows(n, n).items()}
    boxes = torch.from_numpy(F.pad_boxes(
        [(100, 100, 1 << 20, 1 << 19), (5 << 18, 0, 6 << 18, 1 << 21)])).to(cuda)
    wins = torch.from_numpy(F.pad_windows([(1, 0, 1 << 19), (3, 100, 200000)])).to(cuda)
    got = kernels.candidate_mask(r["xi"], r["yi"], r["valid"], boxes, r["bins"], r["offs"], wins)
    want = F.z3_query_mask(r["xi"], r["yi"], r["bins"], r["offs"], r["valid"], boxes, wins)
    assert torch.equal(got, want) and want.any()
    got = kernels.candidate_mask(r["xi"], r["yi"], r["valid"], boxes)
    assert torch.equal(got, F.z2_query_mask(r["xi"], r["yi"], r["valid"], boxes))


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("n", [1024, 2 * 1024 * 1024])
def test_exact_bitmap_matches_plain_on_the_card(cuda, n, has_time):
    r = _rows(n, n + 1)
    t0 = 1_767_225_600_000
    shapes = [(-5.0, -5.0, 5.0, 5.0, t0, t0 + 86_400_000), (100.0, 0.0, 101.0, 1.0, t0, None),
              (-20.0, -20.0, 20.0, 20.0, None, t0 + 5 * 86_400_000)] * 3
    descs = [TorchScanExecutor._shape_keys(s) for s in shapes]
    xk, yk = (torch.from_numpy(f64_keys(r[k])).to(cuda) for k in ("x", "y"))
    tk = torch.from_numpy(r["t"]).to(cuda)
    valid = torch.from_numpy(r["valid"]).to(cuda)
    boxes = torch.from_numpy(np.stack([d[0] for d in descs])).to(cuda)
    wins = torch.from_numpy(np.stack([d[1] for d in descs])).to(cuda) if has_time else None
    tk = tk if has_time else None
    got = kernels.exact_bitmap(xk, yk, tk, valid, boxes, wins)
    want = kernels.exact_bitmap_plain(xk, yk, tk, valid, boxes, wins)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    header, window = kernels.frame_bitmaps(*got, span_cap=n // 2)
    assert torch.equal(header[:, :3], want[1])


def _xz_rows(n: int, seed: int):
    """float64 envelopes with placeholder rows, rectangles, NaN and inverted
    pad rows (as float32 and as int64 keys)."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-20, 20, n)
    y0 = rng.uniform(-20, 20, n)
    x1 = x0 + rng.uniform(0, 2, n)
    y1 = y0 + rng.uniform(0, 2, n)
    for r in range(0, n, 97):  # placeholders: the null-geometry envelope
        x0[r] = y0[r] = x1[r] = y1[r] = 0.0
    x0[5] = np.nan
    return (x0, y0, x1, y1), rng.random(n) < 0.2, rng.random(n) > 0.1



T0 = 1_767_225_600_000
DAY = 86_400_000
FAR = (150.0, 80.0)  # only the first and the last row lie there


def _exact_table(n: int, order: str, seed: int):
    """Points in (-20, 20)^2 over 10 days, in z-key order (so a chunk of
    consecutive rows covers a small envelope and the chunk reject fires) or
    shuffled (so it fires only for a query outside the data); whole chunks and a run across chunks with
    no valid row; NaN, +-0.0 and +-inf coordinates; the first and the last
    row alone at FAR."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-20, 20, n), rng.uniform(-20, 20, n)
    t = T0 + rng.integers(0, 10 * DAY, n)
    if order == "z":
        qx = ((x + 20) / 40 * 1023).astype(np.int64)
        qy = ((y + 20) / 40 * 1023).astype(np.int64)
        z = sum((((qx >> b) & 1) << (2 * b)) | (((qy >> b) & 1) << (2 * b + 1)) for b in range(10))
        idx = np.argsort(z, kind="stable")
    else:
        idx = rng.permutation(n)
    x, y, t = x[idx], y[idx], t[idx]
    valid = rng.random(n) > 0.05
    valid[128 * 3:128 * 6] = False
    valid[1000:1300] = False
    x[200:208] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1.0, -0.0, 0.0]
    y[200:208] = [1.0, np.nan, -np.inf, -0.0, 0.0, np.inf, -0.0, 0.0]
    x[0] = x[-1] = FAR[0]
    y[0] = y[-1] = FAR[1]
    t[0] = t[-1] = T0 + DAY
    valid[0] = valid[-1] = True
    return x, y, t, valid


def _exact_queries(q: int, seed: int):
    """(xmin, ymin, xmax, ymax, t_lo, t_hi) shapes: FAR's rows, an empty
    query, an all-hit query, boxes with +-0.0 edges, then small boxes."""
    rng = np.random.default_rng(seed)
    inf = np.inf
    shapes = [(FAR[0] - 0.5, FAR[1] - 0.5, FAR[0] + 0.5, FAR[1] + 0.5, T0, T0 + 2 * DAY),
              (100.0, 0.0, 101.0, 1.0, None, None),
              (-inf, -inf, inf, inf, None, None),
              (-0.0, -5.0, 5.0, 0.0, T0 + DAY, T0 + 4 * DAY),
              (-5.0, -0.0, 0.0, 5.0, None, T0 + 6 * DAY)]
    while len(shapes) < q:
        cx, cy = rng.uniform(-20, 20, 2)
        w, h = rng.uniform(0.2, 4.0, 2)
        lo = T0 + int(rng.integers(0, 8 * DAY))
        shapes.append((cx - w, cy - h, cx + w, cy + h, lo, lo + int(rng.integers(0, 3 * DAY))))
    boxes = np.stack([f64_keys(np.asarray([s[0], s[2], s[1], s[3]])) for s in shapes[:q]])
    wins = np.asarray([[np.iinfo(np.int64).min + 1 if s[4] is None else s[4],
                        np.iinfo(np.int64).max if s[5] is None else s[5]] for s in shapes[:q]],
                      dtype=np.int64)
    return boxes, wins


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("order", ["z", "shuffled"])
@pytest.mark.parametrize("q", [1, 20, kernels.EXACT_MAX_Q])
@pytest.mark.parametrize("n", [32 * (4 * 100 + 1), 32 * (4 * 100 + 3), 2 * 1024 * 1024 + 96])
def test_exact_bitmap_chunks_and_reject_on_the_card(cuda, n, q, order, has_time):
    """The chunked design with its chunk reject, bitwise against the plain
    edition: word counts that end inside a warp's chunk, q from 1 to
    EXACT_MAX_Q, rows in z-key order (the reject fires) and shuffled (it
    fires only for a query outside the data), the header's first and last row at 0 and n - 1, chunks
    with no valid row, NaN / +-0.0 / +-inf keys, an empty and an all-hit
    query."""
    x, y, t, valid = _exact_table(n, order, n + q)
    boxes, wins = _exact_queries(q, q)
    xk, yk = (torch.from_numpy(f64_keys(c)).to(cuda) for c in (x, y))
    tk = torch.from_numpy(t).to(cuda) if has_time else None
    valid = torch.from_numpy(valid).to(cuda)
    boxes = torch.from_numpy(boxes).to(cuda)
    wins = torch.from_numpy(wins).to(cuda) if has_time else None
    kernels.reset_launches()
    got = kernels.exact_bitmap(xk, yk, tk, valid, boxes, wins)
    want = kernels.exact_bitmap_plain(xk, yk, tk, valid, boxes, wins)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    name = "exact_bitmap_" + ("z3" if has_time else "z2")
    assert kernels.LAUNCH_SHAPES == {(name, f"q={q}"): 1}
    hdr = want[1].cpu().tolist()
    assert hdr[0] == [2, 0, n - 1]  # FAR: the first and the last row alone
    if q > 1:
        assert hdr[1] == [0, 0, n - 1]  # no hit
        assert hdr[2][0] > int(valid.sum()) // 2  # every valid finite row


def _attr_vectors(kind: str, q: int, width: int, rng):
    """Per-query vectors of one attribute edition: codes with -2 (a literal
    the segment lacks) and -1 (null) among them (member, notmember), an
    IS NULL interval [-1, -1], an empty and a wide interval (range), a
    lookup table of ``width`` entries (vocabmask)."""
    if kind == "range":
        lo = rng.integers(-1, 300, q)
        out = np.stack([lo, lo + rng.integers(0, 200, q)], 1)
        out[:3] = [(-1, -1), (9, 3), (0, 10**6)][:q]
        return out.astype(np.int32)
    if kind == "vocabmask":
        return (rng.random((q, width)) < 0.4).astype(np.uint8)
    out = rng.integers(-2, 300, (q, width)).astype(np.int32)
    out[0, -1] = -2
    if q > 1:
        out[1, 0] = -1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("kind", F.ATTR_KINDS)
@pytest.mark.parametrize("q", [1, 2, 12, 24])
@pytest.mark.parametrize("n", [32 * (4 * 100 + 1), 2 * 1024 * 1024 + 96])
def test_exact_bitmap_attr_editions_on_the_card(cuda, n, q, kind, has_time):
    """Each attribute edition bitwise against its plain edition: row counts
    that end inside a warp's chunk, q = 1 (no chunk reject) to 24, K = 1, 4,
    8 and 32 codes a query, lookup tables of 8 to 65536 entries (codes past
    the table clip to its last entry), null codes, the empty query's
    (0, 0, n - 1) header and the header of the combined mask."""
    x, y, t, valid = _exact_table(n, "z", n + q)
    boxes, wins = _exact_queries(q, q)
    rng = np.random.default_rng(q)
    codes = rng.integers(0, 300, n).astype(np.int32)
    codes[rng.random(n) < 0.1] = -1
    xk, yk = (torch.from_numpy(f64_keys(c)).to(cuda) for c in (x, y))
    tk = torch.from_numpy(t).to(cuda) if has_time else None
    valid = torch.from_numpy(valid).to(cuda)
    boxes = torch.from_numpy(boxes).to(cuda)
    wins = torch.from_numpy(wins).to(cuda) if has_time else None
    codes = torch.from_numpy(codes).to(cuda)
    widths = {"range": [2], "vocabmask": [8, 4096, kernels.ATTR_MAX_U]}.get(
        kind, [1, 4, 8, kernels.ATTR_MAX_K])
    name = "exact_bitmap_" + ("z3" if has_time else "z2") + "_" + kind
    for width in widths:
        qcodes = torch.from_numpy(_attr_vectors(kind, q, width, rng)).to(cuda)
        kernels.reset_launches()
        got = kernels.exact_bitmap(xk, yk, tk, valid, boxes, wins, codes, qcodes, kind)
        want = kernels.exact_bitmap_plain(xk, yk, tk, valid, boxes, wins, codes, qcodes, kind)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w), (kind, width)
        tag = "" if kind == "range" else (f" U={width}" if kind == "vocabmask" else f" K={width}")
        assert kernels.LAUNCH_SHAPES == {(name, f"q={q}{tag}"): 1}
        if q > 1:
            assert want[1][1].cpu().tolist() == [0, 0, n - 1]  # the empty query


@pytest.mark.cuda
def test_exact_bitmap_attr_header_follows_the_combined_mask(cuda):
    """A box that holds rows 0 and n - 1, with an attribute test that only
    row n - 1 passes: the header is (1, n - 1, n - 1), not the box's."""
    n = 32 * 1000
    x, y, t, valid = _exact_table(n, "z", 5)
    boxes, _wins = _exact_queries(1, 1)
    codes = np.full(n, 3, dtype=np.int32)
    codes[-1] = 7
    args = [torch.from_numpy(a).to(cuda)
            for a in (f64_keys(x), f64_keys(y), valid, boxes, codes)]
    for kind, qc in (("member", [[7]]), ("range", [[5, 9]]), ("notmember", [[3]])):
        qcodes = torch.tensor(qc, dtype=torch.int32, device=cuda)
        bits, hdr = kernels.exact_bitmap(args[0], args[1], None, args[2], args[3], None,
                                         args[4], qcodes, kind)
        assert hdr.cpu().tolist() == [[1, n - 1, n - 1]], kind
        assert torch.equal(bits, kernels.exact_bitmap_plain(
            args[0], args[1], None, args[2], args[3], None, args[4], qcodes, kind)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("n", [1024, 3 * 1024 * 1024 + 4096])
def test_xz_mask_matches_plain_on_the_card(cuda, n, has_time):
    (x0, y0, x1, y1), _isrect, valid = _xz_rows(n, n)
    r = _rows(n, n + 2)
    env = [torch.from_numpy(c.astype(np.float32)).to(cuda) for c in (x0, y0, x1, y1)]
    env[0][-8:], env[1][-8:], env[2][-8:], env[3][-8:] = 1.0, 1.0, 0.0, 0.0  # pads
    valid = torch.from_numpy(valid).to(cuda)
    boxes = torch.from_numpy(F.pad_boxes([(-5.0, -5.0, 5.0, 0.0), (10.0, 10.0, 12.0, 11.0)],
                                         dtype=np.float32)).to(cuda)
    args = []
    if has_time:
        args = [torch.from_numpy(r["bins"]).to(cuda), torch.from_numpy(r["offs"]).to(cuda),
                torch.from_numpy(F.pad_windows([(1, 0, 1 << 19), (3, 100, 200000)])).to(cuda)]
    got = kernels.xz_mask(*env, valid, boxes, *args)
    want = kernels.xz_mask_plain(*env, valid, boxes, *args)
    assert torch.equal(got, want) and want.any()


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("n", [1024, 2 * 1024 * 1024])
def test_xz_dual_bitmap_matches_plain_on_the_card(cuda, n, has_time):
    from geomesa_tpu_torch.geom.base import Envelope

    cols, isrect, valid = _xz_rows(n, n + 3)
    t = _rows(n, n + 4)["t"]
    t0 = 1_767_225_600_000
    shapes = [((-5.0, -5.0, 5.0, 5.0), True, t0, t0 + 86_400_000),
              ((-1.0, -1.0, 1.0, 1.0), False, t0, None),
              ((100.0, 0.0, 101.0, 1.0), True, None, t0 + 5 * 86_400_000),
              ((-20.0, -20.0, 20.0, 20.0), True, t0, t0 + 3 * 86_400_000)] * 3
    descs = torch.from_numpy(np.stack([
        TorchScanExecutor._xz_desc(Envelope(*b), rect, *((lo, hi) if has_time else (None, None)))[0]
        for b, rect, lo, hi in shapes])).to(cuda)
    keys = [torch.from_numpy(f64_keys(c)).to(cuda) for c in cols]
    isrect = torch.from_numpy(isrect).to(cuda)
    valid = torch.from_numpy(valid).to(cuda)
    tk = torch.from_numpy(t).to(cuda) if has_time else None
    got = kernels.xz_dual_bitmap(*keys, isrect, valid, descs, tk=tk)
    want = kernels.xz_dual_bitmap_plain(*keys, isrect, valid, descs, tk=tk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert want[0].any() and want[1].any()
    header, window = kernels.frame_dual_bitmaps(*got, span_cap=n // 2)
    assert torch.equal(header[:, :3], want[2]) and window.shape == (len(shapes), n // 8)


def _density_rows(n: int, seed: int, env):
    """float32 points around ``env`` with rows on its cell edges, NaN rows
    (null geometries) and invalid rows; bins and in-bin ms offsets."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(env[0] - 5, env[2] + 5, n).astype(np.float32)
    y = rng.uniform(env[1] - 5, env[3] + 5, n).astype(np.float32)
    x[:4096] = env[0] + (env[2] - env[0]) * np.float32(rng.integers(0, 257, 4096) / 256)
    x[5000:5100] = np.nan
    y[5050:5150] = np.nan
    return {
        "x": x, "y": y, "valid": rng.random(n) > 0.05,
        "bins": rng.integers(0, 4, n).astype(np.int32),
        "offs": rng.integers(-1, 604_800_000, n).astype(np.int32),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("width,height", [(256, 128), (64, 32), (512, 512), (256, 256)])
def test_density_grid_matches_plain_on_the_card(cuda, width, height, has_time):
    env = np.array([-60.0, -30.0, 60.0, 40.0], dtype=np.float32)
    n = 4 * 1024 * 1024 + 1000
    r = {k: torch.from_numpy(v).to(cuda) for k, v in _density_rows(n, width + height, env).items()}
    boxes = torch.from_numpy(F.pad_boxes(
        [(-50.0, -20.0, 10.0, 35.0), (0.0, -30.0, 60.0, 0.0)], dtype=np.float32)).to(cuda)
    windows = torch.from_numpy(F.pad_windows([(1, 0, 300_000_000), (3, 5, 604_799_999)])).to(cuda)
    args = (r["x"], r["y"], r["bins"] if has_time else None, r["offs"] if has_time else None,
            r["valid"], boxes, windows if has_time else None, torch.from_numpy(env).to(cuda),
            width, height, agg.DENSITY_BAND_CAP * 8)
    kernels.reset_launches()
    grid, idx, cnt = kernels.density_grid(*args)
    pgrid, pidx, pcnt = kernels.density_grid_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["density_grid_" + ("z3" if has_time else "z2")] == 1
    assert torch.equal(grid, pgrid) and int(grid.sum()) > 0
    c = int(pcnt[0])
    assert int(cnt[0]) == c and 0 < c <= agg.DENSITY_BAND_CAP * 8
    got = idx.cpu().numpy()
    assert (got[c:] == -1).all()
    assert set(got[:c].tolist()) == set(pidx.cpu().numpy()[:c].tolist())


@pytest.mark.cuda
def test_density_grid_band_overflow_on_the_card(cuda):
    """A fine grid over a tiny envelope puts every row in the band: the
    count stays true and the buffer keeps ``band_cap`` of the near rows."""
    env = np.array([100.0, 10.0, 100.0001, 10.0001], dtype=np.float32)
    n = 1 << 20
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(100.0, 100.0001, n).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.uniform(10.0, 10.0001, n).astype(np.float32)).to(cuda)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    boxes = torch.from_numpy(F.pad_boxes([tuple(env)], dtype=np.float32)).to(cuda)
    tenv = torch.from_numpy(env).to(cuda)
    cap = 1000
    grid, idx, cnt = kernels.density_grid(x, y, None, None, valid, boxes, None, tenv, 512, 512, cap)
    pgrid, full, pcnt = kernels.density_grid_plain(x, y, None, None, valid, boxes, None, tenv,
                                                   512, 512, n)
    assert int(cnt[0]) == int(pcnt[0]) > cap
    assert torch.equal(grid, pgrid)
    kept = idx.cpu().numpy()
    assert len(set(kept.tolist())) == cap and (kept >= 0).all()
    assert set(kept.tolist()) <= set(full.cpu().numpy().tolist())


def _sorted_density_rows(n: int, seed: int, env):
    """float32 points around ``env`` sorted by bin (as a z3 table is), with
    rows on the envelope's cell edges, at the pads' corners, at +-0.0, NaN
    and inf, and a run of invalid rows."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(env[0] - 5, env[2] + 5, n).astype(np.float32)
    y = rng.uniform(env[1] - 5, env[3] + 5, n).astype(np.float32)
    m = min(n // 4, 4096)
    x[:m] = env[0] + (env[2] - env[0]) * np.float32(rng.integers(0, 257, m) / 256)
    # every 16th row on a box edge: x = 10 (the first box), y = 0 (the second)
    x[m::16] = np.float32(10.0)
    y[m + 8::16] = np.float32(0.0)
    special = [(np.inf, np.inf), (-np.inf, 1.0), (np.nan, 0.0), (1.0, 1.0), (0.0, 0.0),
               (0.5, 0.5), (-0.0, -0.0), (0.0, -0.0)]
    for i, (sx, sy) in enumerate(special):
        x[m + i], y[m + i] = sx, sy
    valid = rng.random(n) > 0.05
    valid[m + 64:m + 320] = False
    return {
        "x": x, "y": y, "valid": valid,
        "bins": np.sort(rng.integers(0, 8, n)).astype(np.int32),
        "offs": rng.integers(-1, 604_800_000, n).astype(np.int32),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("real,width,height,n", [
    (1, 1, 1, 1024),
    (2, 512, 512, 1024),
    (3, 64, 32, 2 * 1024 * 1024 + 1024),
    (1, 512, 512, 2 * 1024 * 1024 + 1024),
    (2, 1, 1, 2 * 1024 * 1024 + 1024),
])
def test_density_grid_real_boxes_and_skipped_warps_on_the_card(cuda, real, width, height, n,
                                                                has_time):
    """1-3 real boxes among pads, 1x1 to 512x512 grids, rows sorted by bin
    with windows over two of eight bins (whole warps skip x and y), and the
    band at a cap just above its count and just below it."""
    env = np.array([-60.0, -30.0, 60.0, 40.0], dtype=np.float32)
    r = {k: torch.from_numpy(v).to(cuda)
         for k, v in _sorted_density_rows(n, n + real, env).items()}
    boxes = torch.from_numpy(F.pad_boxes(
        [(-50.0, -20.0, 10.0, 35.0), (0.0, -30.0, 60.0, 0.0), (-60.0, 30.0, -40.0, 40.0)][:real],
        dtype=np.float32)).to(cuda)
    windows = torch.from_numpy(F.pad_windows([(2, 0, 300_000_000), (5, 5, 604_799_999)])).to(cuda)
    tenv = torch.from_numpy(env).to(cuda)

    def args(cap):
        return (r["x"], r["y"], r["bins"] if has_time else None,
                r["offs"] if has_time else None, r["valid"], boxes,
                windows if has_time else None, tenv, width, height, cap)

    pgrid, full, pcnt = kernels.density_grid_plain(*args(n))
    c = int(pcnt[0])
    assert int(pgrid.sum()) > 0 and c > 1
    every = set(full.cpu().numpy()[:c].tolist())
    kernels.reset_launches()
    for cap in (c + 1, c - 1):
        grid, idx, cnt = kernels.density_grid(*args(cap))
        torch.cuda.synchronize()
        assert torch.equal(grid, pgrid) and int(cnt[0]) == c
        kept = idx.cpu().numpy()
        if cap > c:
            assert set(kept[:c].tolist()) == every and (kept[c:] == -1).all()
        else:
            assert len(set(kept.tolist())) == cap and set(kept.tolist()) <= every
    name = "density_grid_" + ("z3" if has_time else "z2")
    assert kernels.LAUNCH_SHAPES == {(name, f"{width}x{height}"): 2}


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("q", [1, 3, 24, 33, 256])
def test_xz_dual_bitmap_batch_sizes_on_the_card(cuda, q, has_time):
    """q from 1 to EXACT_MAX_Q, with queries that hit no row, on a row count
    that ends inside a warp's chunk of words."""
    from geomesa_tpu_torch.geom.base import Envelope

    n = 1024 * 1024 + 96
    cols, isrect, valid = _xz_rows(n, q + 7)
    t = _rows(n, q + 8)["t"]
    t0 = 1_767_225_600_000
    shapes = [((-5.0, -5.0, 5.0, 5.0), True, t0, t0 + 86_400_000),
              ((100.0, 0.0, 101.0, 1.0), True, None, None),  # no row
              ((-1.0, -1.0, 1.0, 1.0), False, t0, None),
              ((-20.0, -20.0, 20.0, 20.0), True, t0, t0 + 3 * 86_400_000),
              ((18.0, 18.0, 30.0, 30.0), True, t0 - 10, t0 - 1)]  # no row with time
    shapes = (shapes * (q // len(shapes) + 1))[:q]
    descs = torch.from_numpy(np.stack([
        TorchScanExecutor._xz_desc(Envelope(*b), rect, *((lo, hi) if has_time else (None, None)))[0]
        for b, rect, lo, hi in shapes])).to(cuda)
    keys = [torch.from_numpy(f64_keys(c)).to(cuda) for c in cols]
    isrect = torch.from_numpy(isrect).to(cuda)
    valid = torch.from_numpy(valid).to(cuda)
    tk = torch.from_numpy(t).to(cuda) if has_time else None
    kernels.reset_launches()
    got = kernels.xz_dual_bitmap(*keys, isrect, valid, descs, tk=tk)
    want = kernels.xz_dual_bitmap_plain(*keys, isrect, valid, descs, tk=tk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    name = "xz_dual_bitmap_" + ("xz3" if has_time else "xz2")
    assert kernels.LAUNCH_SHAPES == {(name, f"q={q}"): 1}
    assert want[0].any()
    if q > 1:
        assert (want[2][:, 0] == 0).any()  # a query with no hit: (0, 0, n - 1)


def _native_decode_agrees(header, window, half=None):
    """Each query's span window through the native decode (header count as
    its bound) equals numpy's unpack of the same window; ``half`` splits a
    dual window into its hit and decided planes."""
    from geomesa_tpu_torch import native

    assert native.build_all()["bitdecode"]["loaded"], native.status()["bitdecode"]
    decoded = 0
    for (cnt, _lo, _hi, start), w in zip(header.cpu().numpy(), window.cpu().numpy()):
        planes = [w] if half is None else [w[:half], w[half:]]
        for plane in planes:
            want = int(start) + np.flatnonzero(np.unpackbits(plane)).astype(np.int64)
            got = _decode_bitmap_rows(plane, int(start), int(cnt))
            assert got.dtype == np.int64 and np.array_equal(got, want)
            decoded += len(got)
    assert decoded


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
def test_native_decode_of_exact_bitmap_windows_on_the_card(cuda, has_time):
    """The C++ decode reads the exact kernel's MSB-first words as
    np.unpackbits does: on real span windows and on whole bitmaps."""
    n = 2 * 1024 * 1024 + 96
    x, y, t, valid = _exact_table(n, "z", 41)
    boxes, wins = _exact_queries(20, 42)
    dev = {k: torch.from_numpy(v).to(cuda) for k, v in
           (("xk", f64_keys(x)), ("yk", f64_keys(y)), ("tk", t), ("valid", valid))}
    bits, hdr = kernels.exact_bitmap(
        dev["xk"], dev["yk"], dev["tk"] if has_time else None, dev["valid"],
        torch.from_numpy(boxes).to(cuda), torch.from_numpy(wins).to(cuda) if has_time else None)
    header, window = kernels.frame_bitmaps(bits, hdr, span_cap=n // 4 // 8 * 8)
    spans = header[:, 2] - header[:, 3] + 1
    assert bool(((header[:, 0] > 0) & (spans <= n // 4)).any())
    fits = (header[:, 0] == 0) | (spans <= n // 4)
    _native_decode_agrees(header[fits], window[fits])
    for b, cnt in zip(bits.cpu().numpy(), hdr[:, 0].tolist()):
        want = np.flatnonzero(np.unpackbits(b))
        assert len(want) == cnt  # pad rows are clear
        assert np.array_equal(_decode_bitmap_rows(b, 0, cnt), want)


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
def test_native_decode_of_xz_dual_windows_on_the_card(cuda, has_time):
    """Hit and decided planes of the dual kernel's span windows: the C++
    decode with the hit count as bound (decided <= hit) equals numpy."""
    from geomesa_tpu_torch.geom.base import Envelope

    n = 1024 * 1024 + 96
    cols, isrect, valid = _xz_rows(n, 43)
    t = _rows(n, 44)["t"]
    shapes = [((-5.0, -5.0, 5.0, 5.0), True, T0, T0 + DAY),
              ((-1.0, -1.0, 1.0, 1.0), False, T0, None),
              ((100.0, 0.0, 101.0, 1.0), True, None, None),
              ((-20.0, -20.0, 20.0, 20.0), True, T0, T0 + 3 * DAY)] * 6
    descs = torch.from_numpy(np.stack([
        TorchScanExecutor._xz_desc(Envelope(*b), rect, *((lo, hi) if has_time else (None, None)))[0]
        for b, rect, lo, hi in shapes])).to(cuda)
    keys = [torch.from_numpy(f64_keys(c)).to(cuda) for c in cols]
    hit, dec, hdr = kernels.xz_dual_bitmap(
        *keys, torch.from_numpy(isrect).to(cuda), torch.from_numpy(valid).to(cuda), descs,
        tk=torch.from_numpy(t).to(cuda) if has_time else None)
    span_cap = (n // 8) * 8
    header, window = kernels.frame_dual_bitmaps(hit, dec, hdr, span_cap)
    _native_decode_agrees(header, window, half=span_cap // 8)


@pytest.mark.cuda
def test_host_seek_equals_the_device_route_on_the_card(cuda, monkeypatch):
    """A config-#1-shaped stream (GDELT-style points, jittered bbox AND
    DURING) under GEOMESA_SEEK=1 (the C++ seek scan) returns the device
    route's fid sets (GEOMESA_SEEK=0, ``exact_bitmap``)."""
    import chip_smoke as cs
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.schema.featuretype import parse_spec
    from geomesa_tpu_torch.store.datastore import TorchDataStore

    n = 400_000
    x, y, t = cs.synthesize(n, seed=45)
    store = TorchDataStore(device=cuda)
    ft = parse_spec("gdelt", "dtg:Date,*geom:Point:srid=4326")
    store.create_schema(ft)
    store._insert_columns(ft, {"__fid__": np.char.add("f", np.arange(n).astype(str)),
                               "geom__x": x, "geom__y": y, "dtg": t})
    boxes, cqls = cs.make_queries(8)
    got = {}
    for mode, path in (("0", "device-exact/bitmap"), ("1", "host-seek")):
        monkeypatch.setenv("GEOMESA_SEEK", mode)
        res = store.query_many("gdelt", [Query.cql(c, properties=[]) for c in cqls])
        assert {r.plan.scan_path for r in res} == {path}
        got[mode] = [set(r.fids.tolist()) for r in res]
    assert got["0"] == got["1"]
    for b, fids in zip(boxes, got["1"]):
        want = np.flatnonzero(cs.in_box(x, y, b) & (t > cs.T_LO) & (t < cs.T_HI))
        assert fids == {f"f{i}" for i in want} and fids


# -- knn_topk -------------------------------------------------------------------


def _knn_rows(n: int, seed: int, n_valid=None):
    """World-wide points with duplicates (ties) and invalid rows; with
    ``n_valid``, only that many valid rows."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n).astype(np.float32)
    y = rng.uniform(-85, 85, n).astype(np.float32)
    dup = rng.choice(n, min(n, 64), replace=False)
    x[dup], y[dup] = x[dup[0]], y[dup[0]]
    x[:16], y[:16] = np.float32(2.35), np.float32(48.85)  # at the query point
    valid = rng.random(n) > 0.05
    if n_valid is not None:
        valid[:] = False
        valid[rng.choice(n, n_valid, replace=False)] = True
    return x, y, valid


@pytest.mark.cuda
@pytest.mark.parametrize("point", [(2.35, 48.85), (179.95, 10.0), (0.0, 84.0)])
@pytest.mark.parametrize("k", [1, 10, 1000, 4096, 8192, 8193, 20000])
def test_knn_topk_matches_plain_on_the_card(cuda, k, point):
    """Index lists equal to the stable sort's, ties by row, at every k
    (one round of at most 8192 keys, and several)."""
    x, y, valid = (torch.from_numpy(a).to(cuda) for a in _knn_rows(1 << 20, k))
    got = kernels.knn_topk(x, y, valid, *point, k)
    want = kernels.knn_topk_plain(x, y, valid, *point, k)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    d = kernels.knn_distances(x, y, valid, *point)[got]
    assert bool((d[1:] >= d[:-1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2999, 3000, 5000, 1 << 16])
def test_knn_topk_past_the_valid_rows_on_the_card(cuda, k):
    """k at and past the 3000 valid rows: the invalid rows come after them,
    by row, as in the plain edition."""
    n = 1 << 16
    x, y, valid = (torch.from_numpy(a).to(cuda) for a in _knn_rows(n, 7, n_valid=3000))
    got = kernels.knn_topk(x, y, valid, 2.35, 48.85, k)
    want = kernels.knn_topk_plain(x, y, valid, 2.35, 48.85, k)
    assert torch.equal(got, want) and len(got) == min(k, n)
    if k > 3000:
        tail = got[3000:]
        assert not valid[tail].any() and bool((tail[1:] > tail[:-1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 1000, 4097, 300_000])
@pytest.mark.parametrize("k", [1, 26, 32, 33, 100])
def test_knn_topk_small_tables_on_the_card(cuda, n, k):
    """k around 32 over tables smaller than a warp's step, a block's tile
    and the grid, with 20 valid rows among the first 300k."""
    x, y, valid = _knn_rows(n, n + k, n_valid=min(n, 20) if n == 300_000 else None)
    x, y, valid = (torch.from_numpy(a).to(cuda) for a in (x, y, valid))
    got = kernels.knn_topk(x, y, valid, 2.35, 48.85, k)
    want = kernels.knn_topk_plain(x, y, valid, 2.35, 48.85, k)
    assert torch.equal(got, want) and len(got) == min(n, k)


def _adversarial_knn_rows(table: str, n: int, seed: int):
    """Tables that put many keys in one histogram bucket: every point at
    one place (the query's and another), two tight clusters, NaN
    coordinates among spread points (their NaN distances sort after
    +inf, by row), and no valid row at all."""
    rng = np.random.default_rng(seed)
    x, y, valid = _knn_rows(n, seed)
    if table == "identical":
        x[:], y[:] = np.float32(12.5), np.float32(-33.25)
        valid[:] = True
    elif table == "at_the_query":
        x[:], y[:] = np.float32(2.35), np.float32(48.85)
    elif table == "two_clusters":
        half = rng.random(n) < 0.5
        x = np.where(half, 2.35, -70.0).astype(np.float32) + \
            rng.normal(0, 1e-3, n).astype(np.float32)
        y = np.where(half, 48.85, 41.0).astype(np.float32) + \
            rng.normal(0, 1e-3, n).astype(np.float32)
    elif table == "nan":
        nan = rng.choice(n, n // 10, replace=False)
        x[nan[: n // 20]] = np.float32(np.nan)
        y[nan[n // 20:]] = np.float32(np.nan)
    elif table == "invalid":
        valid[:] = False
    return x, y, valid


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["identical", "at_the_query", "two_clusters", "nan",
                                   "invalid"])
@pytest.mark.parametrize("k", [1, 32, 33, 1125, 8193, 20000, 1 << 16])
def test_knn_topk_one_bucket_tables_on_the_card(cuda, table, k):
    """The threshold selection where one bucket holds many or all keys
    (candidates up to every row, through the tail's levels), at k = n
    included, bit for bit against the plain edition."""
    n = 1 << 16
    x, y, valid = (torch.from_numpy(a).to(cuda)
                   for a in _adversarial_knn_rows(table, n, k % 1000 + 5))
    got = kernels.knn_topk(x, y, valid, 2.35, 48.85, k)
    want = kernels.knn_topk_plain(x, y, valid, 2.35, 48.85, k)
    assert torch.equal(got, want) and len(got) == min(k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["identical", "two_clusters"])
@pytest.mark.parametrize("k", [26, 1125, 8193])
def test_knn_topk_every_row_a_candidate_on_the_card(cuda, table, k):
    """Over 2^20 + 3 rows whose boundary bucket holds half the table or all
    of it: the candidates take several tail levels, whose counts the
    levels read on the device."""
    n = (1 << 20) + 3
    x, y, valid = (torch.from_numpy(a).to(cuda) for a in _adversarial_knn_rows(table, n, 9))
    got = kernels.knn_topk(x, y, valid, 2.35, 48.85, k)
    assert torch.equal(got, kernels.knn_topk_plain(x, y, valid, 2.35, 48.85, k))


@pytest.mark.cuda
def test_knn_topk_counts_its_launches(cuda):
    x, y, valid = (torch.from_numpy(a).to(cuda) for a in _knn_rows(4096, 3))
    kernels.reset_launches()
    kernels.knn_topk(x, y, valid, 0.0, 0.0, 26)
    kernels.knn_topk(x, y, valid, 0.0, 0.0, 26)
    assert kernels.LAUNCHES["knn_topk"] == 2
    assert kernels.LAUNCH_SHAPES[("knn_topk", "k=26")] == 2
    # the launcher's own pass count: pass A (distances and histogram),
    # pass B (the candidates) and one tail level, since n = 4,096 keys fit
    # one 16,384-key tile
    assert kernels.LAST_PASSES["knn_topk"] == 3
    kernels.knn_topk(x, y, valid, 0.0, 0.0, 100)
    assert kernels.LAST_PASSES["knn_topk"] == 3
    # 2^20 rows: 64 tiles at the first level, 64 x 1,125 = 72,000 keys (5
    # tiles) at the second, 5 x 1,125 at the third (one tile): 2 + 3
    x, y, valid = (torch.from_numpy(a).to(cuda) for a in _knn_rows(1 << 20, 3))
    kernels.knn_topk(x, y, valid, 0.0, 0.0, 1125)
    assert kernels.LAST_PASSES["knn_topk"] == 5
    # k = 8,193: two rounds (8,192 keys, then 1), each of 64 tiles, then
    # 32 (64 x 8,192 keys), 16, 8, 4, 2, 1 at the first round and 64, 1
    # at the second: 2 + 7 + 2
    kernels.knn_topk(x, y, valid, 0.0, 0.0, 8193)
    assert kernels.LAST_PASSES["knn_topk"] == 11


# -- poly_dual_bitmap -------------------------------------------------------------


def _ring(cx, cy, r, m, rng):
    ang = np.sort(rng.uniform(0, 2 * np.pi, m))
    rad = r * rng.uniform(0.5, 1.0, m)
    pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], axis=1)
    return np.vstack([pts, pts[:1]])


def _poly_queries(q: int, e: int, seed: int):
    """q polygons of about ``e`` edges (a shell and, from 16 edges up, a
    hole) -> (edges f32[q, ecap, 4] padded with zero edges, boxes as
    (xmin, ymin, xmax, ymax), the vertices)."""
    rng = np.random.default_rng(seed)
    ecap = 8
    while ecap < e:
        ecap *= 2
    out, boxes, verts = np.zeros((q, ecap, 4), np.float32), [], []
    for i in range(q):
        cx, cy = rng.uniform(-15, 15, 2)
        r = rng.uniform(2, 6)
        rings = [_ring(cx, cy, r, max(3, e // 2 if e >= 16 else e), rng)]
        if e >= 16:
            rings.append(_ring(cx, cy, 0.3 * r, e - e // 2, rng)[::-1])
        segs = np.concatenate([np.stack([g[:-1, 0], g[:-1, 1], g[1:, 0], g[1:, 1]], 1)
                               for g in rings])[:ecap]
        out[i, :len(segs)] = segs
        boxes.append((rings[0][:, 0].min(), rings[0][:, 1].min(), rings[0][:, 0].max(),
                      rings[0][:, 1].max()))
        verts.append(rings[0][:-1])
    return out, boxes, np.concatenate(verts)


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("q,e", [(2, 8), (24, 12), (24, 16), (64, 16), (2, 4096), (64, 4000)])
def test_poly_dual_bitmap_matches_plain_on_the_card(cuda, q, e, has_time):
    """Hit and decided planes and headers bit for bit against the plain
    edition: rows in key order (the chunk reject), vertices among the rows
    (the band), a word count that is not a multiple of the warp's chunk,
    edges resident in shared memory and read from L2."""
    n = 32 * (4 * 1000 + 3) if e < 1000 else 32 * (4 * 300 + 1)
    rng = np.random.default_rng(q * 7 + e)
    edges, boxes, verts = _poly_queries(q, e, q + e)
    x = rng.uniform(-20, 20, n)
    y = rng.uniform(-20, 20, n)
    k = min(len(verts), n // 8)
    x[:k], y[:k] = verts[:k, 0].astype(np.float32), verts[:k, 1].astype(np.float32)
    t = 1_767_225_600_000 + rng.integers(0, 10 * 86_400_000, n)
    order = np.lexsort((x, np.floor(y)))  # rows in strips: chunks cover small areas
    x, y, t = x[order], y[order], t[order]
    valid = rng.random(n) > 0.05
    t0 = 1_767_225_600_000
    descs = [TorchScanExecutor._shape_keys(b + (t0 + i * 3_600_000, t0 + 6 * 86_400_000))
             for i, b in enumerate(boxes)]
    xk, yk = (torch.from_numpy(f64_keys(a)).to(cuda) for a in (x, y))
    xf, yf = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (x, y))
    tk = torch.from_numpy(t).to(cuda) if has_time else None
    v = torch.from_numpy(valid).to(cuda)
    box = torch.from_numpy(np.stack([d[0] for d in descs])).to(cuda)
    win = torch.from_numpy(np.stack([d[1] for d in descs])).to(cuda) if has_time else None
    ed = torch.from_numpy(edges).to(cuda)
    got = kernels.poly_dual_bitmap(xk, yk, v, xf, yf, ed, box, win, tk)
    want = kernels.poly_dual_bitmap_plain(xk, yk, v, xf, yf, ed, box, win, tk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[2][:, 0].sum()) > 0
    assert bool((want[0] != want[1]).any())  # a ring: hit rows left undecided
    kernels.reset_launches()
    kernels.poly_dual_bitmap(xk, yk, v, xf, yf, ed, box, win, tk)
    assert kernels.LAUNCH_SHAPES[("poly_dual_bitmap_" + ("z3" if has_time else "z2"),
                                  f"q={q} E={edges.shape[1]}")] == 1


def _poly_rows(n: int, seed: int, verts=None):
    """n rows over [-20, 20]^2 in strips (chunks cover small areas), the
    first of them on ``verts`` (the band)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-20, 20, n)
    y = rng.uniform(-20, 20, n)
    if verts is not None:
        k = min(len(verts), n // 8)
        x[:k], y[:k] = verts[:k, 0].astype(np.float32), verts[:k, 1].astype(np.float32)
    t = 1_767_225_600_000 + rng.integers(0, 10 * 86_400_000, n)
    order = np.lexsort((x, np.floor(y)))
    return x[order], y[order], t[order], rng.random(n) > 0.05


def _poly_check(cuda, x, y, t, valid, edges, boxes, has_time):
    t0 = 1_767_225_600_000
    descs = [TorchScanExecutor._shape_keys(tuple(b) + (t0 + i * 3_600_000, t0 + 6 * 86_400_000))
             for i, b in enumerate(boxes)]
    xk, yk = (torch.from_numpy(f64_keys(a)).to(cuda) for a in (x, y))
    xf, yf = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (x, y))
    tk = torch.from_numpy(t).to(cuda) if has_time else None
    v = torch.from_numpy(valid).to(cuda)
    box = torch.from_numpy(np.stack([d[0] for d in descs])).to(cuda)
    win = torch.from_numpy(np.stack([d[1] for d in descs])).to(cuda) if has_time else None
    ed = torch.from_numpy(np.ascontiguousarray(edges)).to(cuda)
    got = kernels.poly_dual_bitmap(xk, yk, v, xf, yf, ed, box, win, tk)
    want = kernels.poly_dual_bitmap_plain(xk, yk, v, xf, yf, ed, box, win, tk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("layout", ["same_chunks_q64", "whole_table_q64", "whole_table_e4096",
                                    "q1", "q1_e4096"])
def test_poly_dual_bitmap_worst_layouts_on_the_card(cuda, layout, has_time):
    """The layouts that load the cast most: 64 queries on the same chunks,
    envelopes covering the whole table (every (chunk, query) pair live: the
    most pairs a launch can hold), E = 4,096 (edges read from L2), q = 1;
    both planes and the header bit for bit against the plain edition."""
    n = 32 * (4 * 1000 + 3)
    q, e = {"same_chunks_q64": (64, 16), "whole_table_q64": (64, 16),
            "whole_table_e4096": (2, 4096), "q1": (1, 16), "q1_e4096": (1, 4096)}[layout]
    edges, boxes, verts = _poly_queries(q, e, q + e)
    if layout == "same_chunks_q64":
        # one star's jittered copies: every query on the same few chunks
        rng = np.random.default_rng(3)
        base = edges[0].copy()
        for i in range(q):
            shift = rng.uniform(-0.05, 0.05, 2).astype(np.float32)
            edges[i] = base + np.tile(shift, 2) * (base != 0).any(1, keepdims=True)
        real = [edges[i][(edges[i] != 0).any(1)] for i in range(q)]
        boxes = [(r[:, [0, 2]].min(), r[:, [1, 3]].min(), r[:, [0, 2]].max(),
                  r[:, [1, 3]].max()) for r in real]
    elif layout.startswith("whole_table"):
        # concave rings around the origin reaching past the rows' square
        rng = np.random.default_rng(4)
        m = e // 2 if e > 16 else e
        for i in range(q):
            ang = np.sort(rng.uniform(0, 2 * np.pi, m))
            rad = np.where(np.arange(m) % 2 == 0, 40.0, rng.uniform(5, 25, m))
            ring = np.stack([rad * np.cos(ang), rad * np.sin(ang)], 1)
            ring = np.vstack([ring, ring[:1]])
            segs = np.stack([ring[:-1, 0], ring[:-1, 1], ring[1:, 0], ring[1:, 1]], 1)
            edges[i] = 0.0
            edges[i, :len(segs)] = segs
            boxes[i] = (-40.0, -40.0, 40.0, 40.0)
    x, y, t, valid = _poly_rows(n, q * 7 + e, verts)
    want = _poly_check(cuda, x, y, t, valid, edges, boxes, has_time)
    assert int(want[2][:, 0].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 96, 32 * 4 * 3 + 32, 32 * (4 * 5000 + 1)])
def test_poly_dual_bitmap_ragged_tables_on_the_card(cuda, n):
    """Tables of one word, of fewer words than a chunk, and of a last chunk
    with one word: the sweep's and the cast's partial chunks."""
    edges, boxes, verts = _poly_queries(24, 16, n)
    x, y, t, valid = _poly_rows(n, n, verts)
    _poly_check(cuda, x, y, t, valid, edges, boxes, True)


# -- the count and histogram editions of exact_bitmap ----------------------------


def _one_query_args(cuda, n, has_time, seed, order="z"):
    x, y, t, valid = _exact_table(n, order, seed)
    boxes, wins = _exact_queries(4, seed)
    xk, yk = (torch.from_numpy(f64_keys(c)).to(cuda) for c in (x, y))
    tk = torch.from_numpy(t).to(cuda) if has_time else None
    # query 3: a box holding many rows, with a window
    box = torch.from_numpy(boxes[3]).to(cuda)
    win = torch.from_numpy(wins[3]).to(cuda) if has_time else None
    return xk, yk, tk, torch.from_numpy(valid).to(cuda), box, win


# a 20M-row table's shape: its grid strides over more chunks than it holds warps
_COUNT_ROWS = [32 * (4 * 100 + 1), 2 * 1024 * 1024 + 96, 20_000_768]


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("kind", (None,) + F.ATTR_KINDS)
@pytest.mark.parametrize("n", _COUNT_ROWS)
def test_exact_count_editions_on_the_card(cuda, n, kind, has_time):
    """The count edition of exact_bitmap, every attribute edition (K = 1
    and 32 codes, an IS NULL interval, a lookup of 8 and 65536 entries),
    equal to its plain edition and to the popcount of exact_bitmap's bits;
    one launch a call, counted under its edition's name."""
    xk, yk, tk, valid, box, win = _one_query_args(cuda, n, has_time, n + 1)
    rng = np.random.default_rng(n)
    codes = None
    vectors = [None]
    if kind is not None:
        c = rng.integers(0, 300, n).astype(np.int32)
        c[rng.random(n) < 0.1] = -1
        codes = torch.from_numpy(c).to(cuda)
        widths = {"range": [2], "vocabmask": [8, kernels.ATTR_MAX_U]}.get(kind, [1, 32])
        vectors = [torch.from_numpy(_attr_vectors(kind, 1, w, rng)).to(cuda) for w in widths]
        if kind == "range":
            vectors.append(torch.tensor([[-1, -1]], dtype=torch.int32, device=cuda))
    name = "exact_count_" + ("z3" if has_time else "z2") + (f"_{kind}" if kind else "")
    for qc in vectors:
        kernels.reset_launches()
        got = kernels.exact_count(xk, yk, tk, valid, box, win, codes, qc, kind)
        want = kernels.exact_count_plain(xk, yk, tk, valid, box, win, codes, qc, kind)
        assert got.dtype == torch.int32 and got.shape == (1,)
        assert torch.equal(got, want), (kind, qc)
        bits = kernels.exact_bitmap_plain(xk, yk, tk, valid, box[None],
                                          None if win is None else win[None], codes, qc, kind)[0]
        assert int(want) == int(unpack_mask_rows(bits[0]).sum())
        assert sum(kernels.LAUNCHES.values()) == 1 and kernels.LAUNCHES[name] == 1
    if kind is None:
        assert int(want) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("u_pad", [8, 256, 8192, 16384, 1 << 16])
@pytest.mark.parametrize("n", [32 * (4 * 100 + 1), 2 * 1024 * 1024 + 96])
def test_exact_stat_hist_on_the_card(cuda, n, u_pad, has_time):
    """The histogram edition on its shared-memory path (u_pad up to 8192)
    and its global path (past it, to 65,536): the total then the per-code
    hits, equal to its plain edition; null codes count in the total only;
    codes fill fewer bins than u_pad."""
    xk, yk, tk, valid, box, win = _one_query_args(cuda, n, has_time, n + 2)
    rng = np.random.default_rng(u_pad)
    vocab = max(1, u_pad - u_pad // 8 - 3)
    c = rng.integers(0, vocab, n).astype(np.int32)
    c[rng.random(n) < 0.07] = -1
    codes = torch.from_numpy(c).to(cuda)
    kernels.reset_launches()
    got = kernels.exact_stat_hist(xk, yk, tk, valid, box, win, codes, u_pad)
    want = kernels.exact_stat_hist_plain(xk, yk, tk, valid, box, win, codes, u_pad)
    assert got.shape == (1 + u_pad,) and torch.equal(got, want)
    assert int(want[0]) > int(want[1:].sum()) > 0  # nulls in the total only
    name = "exact_stat_hist_" + ("z3" if has_time else "z2")
    assert kernels.LAUNCH_SHAPES == {(name, f"q=1 U={u_pad}"): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["all_null", "one_code", "full_u"])
@pytest.mark.parametrize("u_pad", [8, 1 << 16])
def test_exact_stat_hist_edge_tables_on_the_card(cuda, table, u_pad):
    """Every row null (the histogram all zero, the total the hits), every
    row one code (one bin holds the total: a warp's rows all hit one shared
    bin), and codes over all of u_pad bins, on both paths; an empty box
    gives all zeros."""
    n = 2 * 1024 * 1024 + 96
    xk, yk, tk, valid, box, win = _one_query_args(cuda, n, True, 9)
    rng = np.random.default_rng(4)
    c = {"all_null": np.full(n, -1), "one_code": np.full(n, u_pad - 1),
         "full_u": rng.integers(0, u_pad, n)}[table].astype(np.int32)
    codes = torch.from_numpy(c).to(cuda)
    for b in (box, torch.from_numpy(_exact_queries(2, 1)[0][1]).to(cuda)):
        got = kernels.exact_stat_hist(xk, yk, tk, valid, b, win, codes, u_pad)
        want = kernels.exact_stat_hist_plain(xk, yk, tk, valid, b, win, codes, u_pad)
        assert torch.equal(got, want), table
    total = int(kernels.exact_stat_hist_plain(xk, yk, tk, valid, box, win, codes, u_pad)[0])
    assert total > 0
    if table == "one_code":
        assert int(want[0]) == 0  # the empty box
        got = kernels.exact_stat_hist(xk, yk, tk, valid, box, win, codes, u_pad)
        assert int(got[u_pad]) == total == int(got[0])


# -- the attribute editions of the dual planes -----------------------------------


def _dual_attr_vectors(kind: str, q: int, rng, pads: int):
    """q attribute vectors of one edition; the last ``pads`` match nothing
    (member: -2 codes; range: an empty interval; for notmember and vocabmask
    their query's box holds no row instead)."""
    width = {"range": 2, "vocabmask": 512}.get(kind, 4)
    out = _attr_vectors(kind, q, width, rng)
    if pads and kind == "member":
        out[q - pads:] = -2
    elif pads and kind == "range":
        out[q - pads:] = (5, 2)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("kind", F.ATTR_KINDS)
@pytest.mark.parametrize("q", [1, 24, 64])
def test_xz_dual_bitmap_attr_editions_on_the_card(cuda, q, kind, has_time):
    """Each attribute edition of xz_dual_bitmap bit for bit against its
    plain edition, pad queries that match nothing (an inverted box, or a
    vector no code meets) among them, on a row count that ends inside a
    warp's chunk; the decided plane is the attribute-passing part of the
    plain decided plane."""
    from geomesa_tpu_torch.geom.base import Envelope

    n = 1024 * 1024 + 96
    cols, isrect, valid = _xz_rows(n, q + 17)
    t = _rows(n, q + 18)["t"]
    t0 = 1_767_225_600_000
    shapes = [((-5.0, -5.0, 5.0, 5.0), True, t0, t0 + 86_400_000),
              ((-1.0, -1.0, 1.0, 1.0), False, t0, None),
              ((-20.0, -20.0, 20.0, 20.0), True, t0, t0 + 3 * 86_400_000),
              ((3.0, -8.0, 9.0, 2.0), True, None, None)]
    shapes = (shapes * (q // len(shapes) + 1))[:q]
    pads = q // 8
    if pads and kind in ("notmember", "vocabmask"):
        shapes[q - pads:] = [((150.0, 80.0, 151.0, 81.0), True, None, None)] * pads  # no row
    descs = torch.from_numpy(np.stack([
        TorchScanExecutor._xz_desc(Envelope(*b), rect, *((lo, hi) if has_time else (None, None)))[0]
        for b, rect, lo, hi in shapes])).to(cuda)
    keys = [torch.from_numpy(f64_keys(c)).to(cuda) for c in cols]
    isrect = torch.from_numpy(isrect).to(cuda)
    valid = torch.from_numpy(valid).to(cuda)
    tk = torch.from_numpy(t).to(cuda) if has_time else None
    rng = np.random.default_rng(q)
    c = rng.integers(0, 300, n).astype(np.int32)
    c[rng.random(n) < 0.1] = -1
    codes = torch.from_numpy(c).to(cuda)
    qcodes = torch.from_numpy(_dual_attr_vectors(kind, q, rng, pads)).to(cuda)
    kernels.reset_launches()
    got = kernels.xz_dual_bitmap(*keys, isrect, valid, descs, tk, codes, qcodes, kind)
    want = kernels.xz_dual_bitmap_plain(*keys, isrect, valid, descs, tk, codes, qcodes, kind)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    plain = kernels.xz_dual_bitmap_plain(*keys, isrect, valid, descs, tk)
    assert torch.equal(want[0] & plain[0], want[0]) and torch.equal(want[1] & plain[1], want[1])
    assert int(want[2][:, 0].sum()) > 0 and bool((want[0] != want[1]).any())
    if pads:
        assert not want[0][q - pads:].any()  # the pads match nothing
    width = qcodes.shape[1]
    tag = "" if kind == "range" else (f" U={width}" if kind == "vocabmask" else f" K={width}")
    name = "xz_dual_bitmap_" + ("xz3" if has_time else "xz2") + "_" + kind
    assert kernels.LAUNCH_SHAPES == {(name, f"q={q}{tag}"): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("kind", F.ATTR_KINDS)
@pytest.mark.parametrize("q", [1, 24, 64])
def test_poly_dual_bitmap_attr_editions_on_the_card(cuda, q, kind, has_time):
    """Each attribute edition of poly_dual_bitmap bit for bit against its
    plain edition (the sweep's test on the chunk's codes), pad queries that
    match nothing among them, vertices among the rows (the band), edges in
    shared memory."""
    n = 32 * (4 * 1000 + 3)
    edges, boxes, verts = _poly_queries(q, 16, q + 31)
    pads = q // 8
    if pads and kind in ("notmember", "vocabmask"):
        boxes[q - pads:] = [(150.0, 80.0, 151.0, 81.0)] * pads  # no row
    x, y, t, valid = _poly_rows(n, q + 32, verts)
    rng = np.random.default_rng(q + 1)
    c = rng.integers(0, 300, n).astype(np.int32)
    c[rng.random(n) < 0.1] = -1
    t0 = 1_767_225_600_000
    descs = [TorchScanExecutor._shape_keys(tuple(b) + (t0 + i * 3_600_000, t0 + 6 * 86_400_000))
             for i, b in enumerate(boxes)]
    xk, yk = (torch.from_numpy(f64_keys(a)).to(cuda) for a in (x, y))
    xf, yf = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (x, y))
    tk = torch.from_numpy(t).to(cuda) if has_time else None
    v = torch.from_numpy(valid).to(cuda)
    box = torch.from_numpy(np.stack([d[0] for d in descs])).to(cuda)
    win = torch.from_numpy(np.stack([d[1] for d in descs])).to(cuda) if has_time else None
    ed = torch.from_numpy(edges).to(cuda)
    codes = torch.from_numpy(c).to(cuda)
    qcodes = torch.from_numpy(_dual_attr_vectors(kind, q, rng, pads)).to(cuda)
    kernels.reset_launches()
    got = kernels.poly_dual_bitmap(xk, yk, v, xf, yf, ed, box, win, tk, codes, qcodes, kind)
    want = kernels.poly_dual_bitmap_plain(xk, yk, v, xf, yf, ed, box, win, tk, codes, qcodes,
                                          kind)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[2][:, 0].sum()) > 0
    if pads:
        assert not want[0][q - pads:].any()
    width = qcodes.shape[1]
    tag = "" if kind == "range" else (f" U={width}" if kind == "vocabmask" else f" K={width}")
    name = "poly_dual_bitmap_" + ("z3" if has_time else "z2") + "_" + kind
    assert kernels.LAUNCH_SHAPES == {(name, f"q={q} E={edges.shape[1]}{tag}"): 1}


# -- the coalescer's mask batches, and the wrappers under threads -----------------

MASK_EDITIONS = [None, *F.ATTR_KINDS]


def _mask_tag(kind, qcodes) -> str:
    if kind in (None, "range"):
        return ""
    return f" U={qcodes.shape[1]}" if kind == "vocabmask" else f" K={qcodes.shape[1]}"


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("kind", MASK_EDITIONS)
@pytest.mark.parametrize("q", [1, 4, 24, 64])
def test_exact_mask_batch_matches_plain_on_the_card(cuda, q, kind, has_time):
    """exact_mask_batch bit for bit against its plain edition (and equal to
    exact_bitmap's bits, the same kernel): every attribute edition, an
    empty query, an all-hit query and a repeated (pad) query among them, a
    row count that ends inside a warp's chunk; counted under its own name."""
    n = 32 * (4 * 1000 + 3)
    x, y, t, valid = _exact_table(n, "z", n + q)
    boxes, wins = _exact_queries(q, q + 5)
    if q > 4:
        boxes[-1], wins[-1] = boxes[0], wins[0]  # a pad query repeats another
    rng = np.random.default_rng(q + 6)
    xk, yk = (torch.from_numpy(f64_keys(c)).to(cuda) for c in (x, y))
    tk = torch.from_numpy(t).to(cuda) if has_time else None
    valid = torch.from_numpy(valid).to(cuda)
    boxes = torch.from_numpy(boxes).to(cuda)
    wins = torch.from_numpy(wins).to(cuda) if has_time else None
    codes = qcodes = None
    if kind is not None:
        c = rng.integers(0, 300, n).astype(np.int32)
        c[rng.random(n) < 0.1] = -1
        codes = torch.from_numpy(c).to(cuda)
        qcodes = torch.from_numpy(_dual_attr_vectors(kind, q, rng, 0)).to(cuda)
    kernels.reset_launches()
    got = kernels.exact_mask_batch(xk, yk, tk, valid, boxes, wins, codes, qcodes, kind)
    want = kernels.exact_mask_batch_plain(xk, yk, tk, valid, boxes, wins, codes, qcodes, kind)
    assert got.shape == want.shape == (q, n // 8) and torch.equal(got, want)
    assert q < 4 or want.any()
    name = "exact_mask_batch_" + ("z3" if has_time else "z2") + (f"_{kind}" if kind else "")
    assert kernels.LAUNCH_SHAPES == {(name, f"q={q}{_mask_tag(kind, qcodes)}"): 1}
    bits, _hdr = kernels.exact_bitmap(xk, yk, tk, valid, boxes, wins, codes, qcodes, kind)
    assert torch.equal(bits, got)


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("kind", MASK_EDITIONS)
@pytest.mark.parametrize("q", [1, 4, 24, 64])
def test_xz_mask_batch_matches_plain_on_the_card(cuda, q, kind, has_time):
    """dual_mask_batch("xz") bit for bit against its plain edition: both
    planes, every attribute edition, queries that match nothing (pads)."""
    from geomesa_tpu_torch.geom.base import Envelope

    n = 1024 * 1024 + 96
    cols, isrect, valid = _xz_rows(n, q + 41)
    t = _rows(n, q + 42)["t"]
    t0 = 1_767_225_600_000
    shapes = [((-5.0, -5.0, 5.0, 5.0), True, t0, t0 + 86_400_000),
              ((-1.0, -1.0, 1.0, 1.0), False, t0, None),
              ((-20.0, -20.0, 20.0, 20.0), True, t0, t0 + 3 * 86_400_000),
              ((150.0, 80.0, 151.0, 81.0), True, None, None)]  # no row
    shapes = (shapes * (q // len(shapes) + 1))[:q]
    descs = torch.from_numpy(np.stack([
        TorchScanExecutor._xz_desc(Envelope(*b), rect, *((lo, hi) if has_time else (None, None)))[0]
        for b, rect, lo, hi in shapes])).to(cuda)
    keys = [torch.from_numpy(f64_keys(c)).to(cuda) for c in cols]
    isrect = torch.from_numpy(isrect).to(cuda)
    valid = torch.from_numpy(valid).to(cuda)
    tk = torch.from_numpy(t).to(cuda) if has_time else None
    rng = np.random.default_rng(q + 43)
    codes = qcodes = None
    if kind is not None:
        c = rng.integers(0, 300, n).astype(np.int32)
        c[rng.random(n) < 0.1] = -1
        codes = torch.from_numpy(c).to(cuda)
        qcodes = torch.from_numpy(_dual_attr_vectors(kind, q, rng, q // 8)).to(cuda)
    kernels.reset_launches()
    got = kernels.dual_mask_batch("xz", *keys, isrect, valid, descs, tk, codes, qcodes, kind)
    want = kernels.dual_mask_batch_plain("xz", *keys, isrect, valid, descs, tk, codes, qcodes,
                                         kind)
    for g, w in zip(got, want):
        assert g.shape == (q, n // 8) and torch.equal(g, w)
    assert q < 4 or want[0].any()
    name = "xz_mask_batch_" + ("xz3" if has_time else "xz2") + (f"_{kind}" if kind else "")
    assert kernels.LAUNCH_SHAPES == {(name, f"q={q}{_mask_tag(kind, qcodes)}"): 1}
    hit, dec, _hdr = kernels.xz_dual_bitmap(*keys, isrect, valid, descs, tk, codes, qcodes, kind)
    assert torch.equal(hit, got[0]) and torch.equal(dec, got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [True, False])
@pytest.mark.parametrize("kind", MASK_EDITIONS)
@pytest.mark.parametrize("q", [1, 4, 24, 64])
def test_poly_mask_batch_matches_plain_on_the_card(cuda, q, kind, has_time):
    """dual_mask_batch("poly") bit for bit against its plain edition at the
    real q (no padding to a multiple of 4), every attribute edition, vertices
    among the rows (the band), queries whose box holds no row."""
    n = 32 * (4 * 1000 + 3)
    edges, boxes, verts = _poly_queries(q, 16, q + 51)
    if q > 4:
        boxes[-1] = (150.0, 80.0, 151.0, 81.0)  # no row
    x, y, t, valid = _poly_rows(n, q + 52, verts)
    t0 = 1_767_225_600_000
    descs = [TorchScanExecutor._shape_keys(tuple(b) + (t0 + i * 3_600_000, t0 + 6 * 86_400_000))
             for i, b in enumerate(boxes)]
    xk, yk = (torch.from_numpy(f64_keys(a)).to(cuda) for a in (x, y))
    xf, yf = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (x, y))
    tk = torch.from_numpy(t).to(cuda) if has_time else None
    v = torch.from_numpy(valid).to(cuda)
    box = torch.from_numpy(np.stack([d[0] for d in descs])).to(cuda)
    win = torch.from_numpy(np.stack([d[1] for d in descs])).to(cuda) if has_time else None
    ed = torch.from_numpy(edges).to(cuda)
    rng = np.random.default_rng(q + 53)
    codes = qcodes = None
    if kind is not None:
        c = rng.integers(0, 300, n).astype(np.int32)
        c[rng.random(n) < 0.1] = -1
        codes = torch.from_numpy(c).to(cuda)
        qcodes = torch.from_numpy(_dual_attr_vectors(kind, q, rng, 0)).to(cuda)
    kernels.reset_launches()
    got = kernels.dual_mask_batch("poly", xk, yk, v, xf, yf, ed, box, win, tk, codes, qcodes,
                                  kind)
    want = kernels.dual_mask_batch_plain("poly", xk, yk, v, xf, yf, ed, box, win, tk, codes,
                                         qcodes, kind)
    for g, w in zip(got, want):
        assert g.shape == (q, n // 8) and torch.equal(g, w)
    assert q < 4 or want[0].any()
    name = "poly_mask_batch_" + ("z3" if has_time else "z2") + (f"_{kind}" if kind else "")
    tag = f"q={q} E={edges.shape[1]}{_mask_tag(kind, qcodes)}"
    assert kernels.LAUNCH_SHAPES == {(name, tag): 1}


def _small_exact(cuda, q=4):
    n = 32 * 1000
    x, y, t, valid = _exact_table(n, "z", 77)
    boxes, wins = _exact_queries(q, 78)
    return [torch.from_numpy(a).to(cuda)
            for a in (f64_keys(x), f64_keys(y), t, valid, boxes, wins)]


@pytest.mark.cuda
def test_first_build_from_eight_threads_on_the_card(cuda, tmp_path, monkeypatch):
    """Eight threads launch a kernel never built, into an empty build
    directory: nvcc runs once, every thread gets the plain edition's bits."""
    import threading

    from geomesa_tpu_torch.utils import devstats

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "_BUILD_LOCKS", {})
    xk, yk, tk, valid, boxes, wins = _small_exact(cuda)
    want = kernels.exact_mask_batch_plain(xk, yk, tk, valid, boxes, wins)
    reg = devstats.devstats_metrics()
    b0 = reg.counter("kernel.build.exact_bitmap")
    barrier = threading.Barrier(8)
    got, errors = [None] * 8, []

    def launch(i):
        try:
            barrier.wait(30)
            got[i] = kernels.exact_mask_batch(xk, yk, tk, valid, boxes, wins)
            torch.cuda.current_stream().synchronize()
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    assert not errors, errors
    assert reg.counter("kernel.build.exact_bitmap") - b0 == 1
    assert sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "*"))
                  if p.endswith(".so")) == [os.path.basename(kernels._LIBS["exact_bitmap"]._name)]
    for g in got:
        assert torch.equal(g, want)


@pytest.mark.cuda
def test_launch_counts_exact_under_threads_on_the_card(cuda):
    """8 threads x 100 launches: LAUNCHES and LAUNCH_SHAPES count 800."""
    import threading

    xk, yk, tk, valid, boxes, wins = _small_exact(cuda, q=2)
    kernels.exact_mask_batch(xk, yk, tk, valid, boxes, wins)  # built
    kernels.reset_launches()
    barrier = threading.Barrier(8)

    def launch():
        barrier.wait(30)
        for _ in range(100):
            kernels.exact_mask_batch(xk, yk, tk, valid, boxes, wins)

    threads = [threading.Thread(target=launch) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["exact_mask_batch_z3"] == 800
    assert kernels.LAUNCH_SHAPES == {("exact_mask_batch_z3", "q=2"): 800}


def _pyramid_rows(n: int, seed: int, order: str):
    """Grid coordinates over the full 31-bit range (the corners and 2^31 - 1
    included), a mask with null-geometry rows cleared and the last 100 rows
    as pads, in z-like sorted order or shuffled."""
    rng = np.random.default_rng(seed)
    xi = rng.integers(0, 2**31, n, dtype=np.int64).astype(np.int32)
    yi = rng.integers(0, 2**31, n, dtype=np.int64).astype(np.int32)
    xi[:4] = [0, 2**31 - 1, 0, 2**31 - 1]
    yi[:4] = [0, 0, 2**31 - 1, 2**31 - 1]
    mask = rng.random(n) > 0.1
    mask[-100:] = False
    xi[-100:] = 0
    yi[-100:] = 0
    if order == "sorted":
        o = np.lexsort((xi, yi))
        xi, yi, mask = xi[o], yi[o], mask[o]
    return xi, yi, mask


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 8, 12])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("n", [1024, 1000, 3 * 1024 * 1024 + 77])
def test_pyramid_counts_matches_plain_on_the_card(cuda, n, order, bits):
    """Exact on sorted and shuffled rows, with pads and coordinates at
    2^31 - 1, at a row count that is not a multiple of the block."""
    xi, yi, mask = (torch.from_numpy(a).to(cuda) for a in _pyramid_rows(n, n + bits, order))
    before = kernels.LAUNCHES["pyramid_counts"]
    got = kernels.pyramid_counts(xi, yi, mask, bits)
    want = agg.pyramid_counts_plain(xi, yi, mask, bits)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1 << bits, 1 << bits)
    assert torch.equal(got, want)
    assert int(got.sum()) == int(mask.sum())
    assert kernels.LAUNCHES["pyramid_counts"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 8, 12])
def test_pyramid_counts_all_masked_and_empty_on_the_card(cuda, bits):
    xi, yi, _mask = (torch.from_numpy(a).to(cuda) for a in _pyramid_rows(4096, 5, "shuffled"))
    none = torch.zeros(4096, dtype=torch.bool, device=cuda)
    got = kernels.pyramid_counts(xi, yi, none, bits)
    assert torch.equal(got, agg.pyramid_counts_plain(xi, yi, none, bits))
    assert not got.any()
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    got = kernels.pyramid_counts(empty, empty, torch.empty(0, dtype=torch.bool, device=cuda),
                                 bits)
    assert not got.any() and tuple(got.shape) == (1 << bits, 1 << bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 8, 12])
def test_pyramid_counts_sum_over_segments_equals_their_union_on_the_card(cuda, bits):
    """The executor sums per-segment grids: two segments' grids add up to
    the grid of their rows together."""
    xi, yi, mask = (torch.from_numpy(a).to(cuda) for a in _pyramid_rows(300_001, bits, "sorted"))
    cut = 123_457
    parts = [kernels.pyramid_counts(xi[s], yi[s], mask[s].contiguous(), bits)
             for s in (slice(0, cut), slice(cut, None))]
    whole = kernels.pyramid_counts(xi, yi, mask, bits)
    assert torch.equal(parts[0] + parts[1], whole)
    assert torch.equal(whole, agg.pyramid_counts_plain(xi, yi, mask, bits))


_LAYOUTS_ON_CARD = {}


def _layout_on(cuda, name):
    """``pyramid_layouts.pyramid_layout(name)`` on the card, made once a module."""
    from pyramid_layouts import pyramid_layout

    if name not in _LAYOUTS_ON_CARD:
        xi, yi, mask, starts = pyramid_layout(name)
        _LAYOUTS_ON_CARD[name] = tuple(torch.from_numpy(a).to(cuda) for a in (xi, yi, mask)) + (
            starts,)
    return _LAYOUTS_ON_CARD[name]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 8, 12])
@pytest.mark.parametrize("layout", ["hot_cell", "long_run", "three_blocks", "shuffled",
                                    "pads_nulls", "gap", "n1", "n31", "n4097"])
def test_pyramid_counts_matches_plain_on_run_layouts_on_the_card(cuda, layout, bits):
    """Bitwise against the plain edition on the layouts that break a run
    design (``tests/pyramid_layouts.py``; the reference's answers in
    ``tests/test_torch_pyramid.py``), with the layout's block bounds and
    with none (the kernel then takes all n rows as one key-sorted block,
    and its fallbacks keep the grid exact where they are not), one launch
    each."""
    xi, yi, mask, starts = _layout_on(cuda, layout)
    want = agg.pyramid_counts_plain(xi, yi, mask, bits)
    for bounds in (starts, None):
        before = kernels.LAUNCHES["pyramid_counts"]
        got = kernels.pyramid_counts(xi, yi, mask, bits, starts=bounds)
        assert torch.equal(got, want), (layout, bits, bounds)
        assert kernels.LAUNCHES["pyramid_counts"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 8, 12])
@pytest.mark.parametrize("layout", ["hot_cell", "long_run", "three_blocks", "shuffled",
                                    "pads_nulls", "gap", "n1", "n31", "n4097"])
def test_pyramid_counts_with_holes_inside_runs_on_the_card(cuda, layout, bits):
    """The layouts with holes punched inside their key-sorted runs (what
    deletes leave in ``agg_mask``; ``pyramid_layouts.holed_in_runs``):
    bitwise against the plain edition, with the layout's block bounds."""
    from pyramid_layouts import holed_in_runs

    xi, yi, mask, starts = _layout_on(cuda, layout)
    holed = torch.from_numpy(holed_in_runs(xi.cpu().numpy(), yi.cpu().numpy(),
                                           mask.cpu().numpy())).to(cuda)
    want = agg.pyramid_counts_plain(xi, yi, holed, bits)
    got = kernels.pyramid_counts(xi, yi, holed, bits, starts=starts)
    assert torch.equal(got, want), (layout, bits)
    assert int(want.sum()) == int(holed.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 8, 12])
@pytest.mark.parametrize("offset", [1, 4, 16])
def test_pyramid_counts_on_unaligned_slices_on_the_card(cuda, offset, bits):
    """A slice whose data pointers are not 16-byte aligned (offset 1: no
    column is; 4: the mask is not) takes the row-by-row loader; offset 16
    keeps the vector loads. Each is exact, its bounds shifted with it."""
    xi, yi, mask, starts = _layout_on(cuda, "pads_nulls")
    xs, ys, ms = xi[offset:], yi[offset:], mask[offset:]
    bounds = [0] + [b - offset for b in starts[1:]]
    got = kernels.pyramid_counts(xs, ys, ms, bits, starts=bounds)
    assert torch.equal(got, agg.pyramid_counts_plain(xs, ys, ms, bits))


@pytest.mark.cuda
def test_pyramid_counts_rejects_bad_arguments_on_the_card(cuda):
    xi = torch.zeros(1024, dtype=torch.int32, device=cuda)
    mask = torch.ones(1024, dtype=torch.bool, device=cuda)
    for bits in (1, 13):
        with pytest.raises(ValueError):
            kernels.pyramid_counts(xi, xi, mask, bits)
    with pytest.raises(TypeError):
        kernels.pyramid_counts(xi.to(torch.int64), xi, mask, 8)
    with pytest.raises(ValueError):
        kernels.pyramid_counts(xi, xi, mask[:512], 8)
    with pytest.raises(ValueError):
        kernels.pyramid_counts(xi, xi, mask, 8, starts=[0, 2048])


# -- the spatial join's masks and the device-assisted seek ----------------------


def _join_chunk(cuda, seed, groups, c_cap, n_geoms):
    """One probe chunk's layout on the card: rows sorted by group (NaN rows
    among them), CSR offsets, each group's candidate row (-1 slots
    included), over ``n_geoms`` build geometries."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 300, groups)
    sizes[0] = max(sizes[0], 1)
    goff = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    px = rng.uniform(-1, 21, goff[-1]).astype(np.float32)
    py = rng.uniform(-1, 21, goff[-1]).astype(np.float32)
    px[::97] = np.nan
    py[::97] = np.nan
    cand = np.full((groups + 2, c_cap), -1, np.int32)
    for b in range(groups + 2):
        k = rng.integers(1, c_cap + 1)
        cand[b, :k] = rng.choice(n_geoms, k, replace=k > n_geoms)
    grow = rng.integers(0, groups + 2, groups).astype(np.int32)
    return [torch.from_numpy(a).to(cuda) for a in (px, py, goff, grow, cand)]


def _join_edges(cuda, n_geoms, seed, e_big=0):
    """Star rings (with a hole every third), one edgeless geometry, and with
    ``e_big`` one ring of that many edges (more than a shared-memory tile)."""
    rng = np.random.default_rng(seed)
    lists = []
    for g in range(n_geoms):
        cx, cy, r = rng.uniform(2, 18), rng.uniform(2, 18), rng.uniform(0.5, 4)
        k = e_big // 2 if (e_big and g == 1) else int(rng.integers(4, 32))
        ang = np.linspace(0, 2 * np.pi, 2 * k + 1)[:-1]
        rad = np.where(np.arange(2 * k) % 2 == 0, r, 0.5 * r)
        ring = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
        rings = [np.vstack([ring, ring[:1]])]
        if g % 3 == 0:
            hole = np.stack([cx + 0.3 * r * np.cos(ang), cy + 0.3 * r * np.sin(ang)], 1)[::-1]
            rings.append(np.vstack([hole, hole[:1]]))
        edges = np.concatenate([np.concatenate([rg[:-1], rg[1:]], 1) for rg in rings])
        lists.append(edges.astype(np.float32))
    lists[-1] = lists[-1][:0]  # no edges
    e_pad = 8
    while e_pad < max(len(e) for e in lists):
        e_pad *= 2
    edges = np.zeros((n_geoms, e_pad, 4), np.float32)
    ecnt = np.zeros(n_geoms, np.int32)
    for g, e in enumerate(lists):
        edges[g, :len(e)] = e
        ecnt[g] = len(e)
    return torch.from_numpy(edges).to(cuda), torch.from_numpy(ecnt).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("groups,c_cap,e_big", [(1, 8, 0), (5, 32, 0), (3, 16, 1200)])
def test_join_pip_matches_plain_on_the_card(cuda, groups, c_cap, e_big):
    n_geoms = 40
    chunk = _join_chunk(cuda, groups * c_cap, groups, c_cap, n_geoms)
    edges, ecnt = _join_edges(cuda, n_geoms, c_cap, e_big)
    eps = np.float32(1e-3)
    got = kernels.join_pip(*chunk, edges, ecnt, eps)
    want = kernels.join_pip_chunk_plain(*chunk, edges, ecnt, eps)
    assert torch.equal(got, want)
    assert bool((want & 1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [5000.0, 300_000.0])
def test_join_dwithin_matches_plain_on_the_card(cuda, radius):
    """Equal flags except pairs whose f32 distance lies within 4 ulps of
    r - eps or r + eps (``dwithin_threshold_band``): the kernel's sinf /
    cosf / asinf and torch's may round such a pair across the threshold."""
    from geomesa_tpu_torch.ops.geometry import dwithin_threshold_band, snap_epsilon_m

    n_geoms = 64
    chunk = _join_chunk(cuda, int(radius), 6, 32, n_geoms)
    rng = np.random.default_rng(5)
    bx = torch.from_numpy(rng.uniform(0, 20, n_geoms).astype(np.float32)).to(cuda)
    by = torch.from_numpy(rng.uniform(0, 20, n_geoms).astype(np.float32)).to(cuda)
    bx[7] = float("nan")
    eps = snap_epsilon_m(radius)
    px, py, goff, grow, cand = chunk
    rows_cand = kernels._group_candidates(px.shape[0], goff, grow, cand)
    # the first rows 0.02 degrees (about 2 km) from their first candidate
    first = rows_cand[:64, 0].long().clamp(min=0)
    px[:64] = bx[first] + 0.02
    py[:64] = by[first]
    got = kernels.join_dwithin(*chunk, bx, by, radius, eps)
    want = kernels.join_dwithin_chunk_plain(*chunk, bx, by, radius, eps)
    from geomesa_tpu_torch.ops.geometry import join_dwithin_distances

    band = dwithin_threshold_band(join_dwithin_distances(px, py, rows_cand, bx, by), radius,
                                  eps).t()
    assert not bool(((got != want) & ~band).any())
    assert bool((want & 1).any())


def _join_layout(cuda, name):
    """``join_layouts.layout(name)`` on the card: (px, py, goff, grow, cand)."""
    from join_layouts import layout

    return [torch.from_numpy(a).to(cuda) for a in layout(name)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(JOIN_LAYOUTS))
def test_join_pip_matches_plain_on_every_layout(cuda, name):
    """``join_pip`` bit for bit against its plain edition on the layouts a
    grid of row tiles x candidate slots can get wrong
    (``tests/join_layouts.py``: one group over a whole 2,048-row chunk,
    1-row groups, group boundaries inside a tile, an all -1 candidate row,
    128 slots with one live, NaN rows at tile edges, a polygon past one
    shared-memory tile, a row count no multiple of the tile); the CPU tests
    hold the plain edition to the reference's ``_pip_fn`` on the same
    layouts."""
    from join_layouts import LAYOUT_EPS_DEG, edge_table

    chunk = _join_layout(cuda, name)
    edges, ecnt = (torch.from_numpy(a).to(cuda) for a in edge_table(name))
    eps = np.float32(LAYOUT_EPS_DEG)
    got = kernels.join_pip(*chunk, edges, ecnt, eps)
    want = kernels.join_pip_chunk_plain(*chunk, edges, ecnt, eps)
    assert torch.equal(got, want)
    assert bool((want & 1).any()) and bool((want & 2).any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(JOIN_LAYOUTS))
def test_join_dwithin_matches_plain_on_every_layout(cuda, name):
    """``join_dwithin`` against its plain edition on the same layouts: equal
    outside 4 ulps of a threshold (``dwithin_threshold_band``)."""
    from join_layouts import LAYOUT_RADIUS_M, sites

    from geomesa_tpu_torch.ops.geometry import (
        dwithin_threshold_band,
        join_dwithin_distances,
        snap_epsilon_m,
    )

    chunk = _join_layout(cuda, name)
    bx, by = (torch.from_numpy(a).to(cuda) for a in sites())
    eps = snap_epsilon_m(LAYOUT_RADIUS_M)
    got = kernels.join_dwithin(*chunk, bx, by, LAYOUT_RADIUS_M, eps)
    want = kernels.join_dwithin_chunk_plain(*chunk, bx, by, LAYOUT_RADIUS_M, eps)
    px, py, goff, grow, cand = chunk
    rows_cand = kernels._group_candidates(px.shape[0], goff, grow, cand)
    band = dwithin_threshold_band(join_dwithin_distances(px, py, rows_cand, bx, by),
                                  LAYOUT_RADIUS_M, eps).t()
    assert not bool(((got != want) & ~band).any())
    assert bool((want & 1).any())


def _seek_inputs(cuda, n, seed, zero_len=True):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(n - 600, 300, replace=False)).astype(np.int64)
    lens = rng.integers(0, 500, 300)
    if zero_len:
        lens[::7] = 0
    ends = np.minimum(starts + lens, n)
    s, e, _f = _merge_overlapping_intervals(starts, ends, np.zeros(300, bool))
    lens = e - s
    n_iv = 512
    iv = np.zeros((2, n_iv), np.int32)
    iv[0, :len(s)] = s
    iv[1, :len(s)] = np.cumsum(lens)
    iv[1, len(s):] = lens.sum()
    cand = 1024
    while cand < lens.sum():
        cand *= 2
    return torch.from_numpy(iv).to(cuda), cand * 2


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [False, True])
def test_devseek_matches_plain_on_the_card(cuda, has_time):
    n = 1 << 18
    r = _rows(n, 77)
    xk, yk = (torch.from_numpy(f64_keys(r[k])).to(cuda) for k in ("x", "y"))
    tk = torch.from_numpy(r["t"]).to(cuda)
    valid = torch.from_numpy(r["valid"]).to(cuda)
    iv, cand = _seek_inputs(cuda, n, 78)
    box = torch.from_numpy(f64_keys(np.array([-10.0, 12.0, -8.0, 15.0]))).to(cuda)
    win = torch.tensor([1_767_225_600_000 + 86_400_000, 1_767_225_600_000 + 6 * 86_400_000],
                       dtype=torch.int64, device=cuda) if has_time else None
    got = kernels.devseek(xk, yk, tk if has_time else None, valid, iv[0], iv[1], box, win, cand)
    want = F.devseek_plain(xk, yk, tk if has_time else None, valid, iv[0], iv[1], box, win, cand)
    assert torch.equal(got, want) and bool(want.any())


@pytest.mark.cuda
@pytest.mark.parametrize("has_time", [False, True])
@pytest.mark.parametrize("rect", [False, True])
def test_devseek_xz_matches_plain_on_the_card(cuda, has_time, rect):
    n = 1 << 17
    rng = np.random.default_rng(91)
    x0, y0 = rng.uniform(-20, 20, n), rng.uniform(-20, 20, n)
    env = np.stack([x0, y0, x0 + rng.uniform(0, 3, n), y0 + rng.uniform(0, 3, n)], 1)
    env[::11] = 0.0  # null geometries
    keys = [torch.from_numpy(f64_keys(env[:, j])).to(cuda) for j in range(4)]
    isrect = torch.from_numpy(rng.random(n) > 0.5).to(cuda)
    valid = torch.from_numpy(rng.random(n) > 0.05).to(cuda)
    tk = torch.from_numpy(1_767_225_600_000 + rng.integers(0, 10 * 86_400_000, n)).to(cuda)
    iv, cand = _seek_inputs(cuda, n, 92)
    desc = np.zeros(kernels.XZ_DESC, np.int64)
    desc[:5] = f64_keys(np.array([-8.0, -6.0, 9.0, 11.0, 0.0]))
    desc[5] = int(rect)
    if has_time:
        desc[6:] = (1_767_225_600_000 + 86_400_000, 1_767_225_600_000 + 5 * 86_400_000)
    desc = torch.from_numpy(desc).to(cuda)
    got = kernels.devseek_xz(*keys, isrect, valid, tk if has_time else None, iv[0], iv[1], desc,
                             cand, has_time)
    want = F.devseek_xz_plain(*keys, isrect, valid, tk, iv[0], iv[1], desc, cand, has_time)
    assert torch.equal(got, want) and bool(want[:cand // 8].any())
    assert bool(want[cand // 8:].any()) == rect


@pytest.mark.cuda
def test_join_and_devseek_reject_bad_arguments_on_the_card(cuda):
    px = torch.zeros(16, dtype=torch.float32, device=cuda)
    goff = torch.tensor([0, 16], dtype=torch.int32, device=cuda)
    grow = torch.zeros(1, dtype=torch.int32, device=cuda)
    cand = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    edges = torch.zeros((1, 8, 4), dtype=torch.float32, device=cuda)
    ecnt = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kernels.join_pip(px.double(), px, goff, grow, cand, edges, ecnt, 1e-3)
    with pytest.raises(ValueError):
        kernels.join_pip(px, px, goff[:1], grow, cand, edges, ecnt, 1e-3)
    with pytest.raises(ValueError):
        kernels.join_dwithin(px, px, goff, grow, cand, px, px[:4], 10.0, 1.0)
    xk = torch.zeros(2048, dtype=torch.int64, device=cuda)
    valid = torch.ones(2048, dtype=torch.bool, device=cuda)
    iv = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    box = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        kernels.devseek(xk, xk, None, valid, iv[0], iv[1], box, None, 1000)
    with pytest.raises(ValueError):
        kernels.devseek(xk, xk, None, valid, iv[0], iv[1][:8], box, None, 1024)
