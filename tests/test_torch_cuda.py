"""The port's hand CUDA kernels against their plain PyTorch editions.

These tests need the card: they are marked ``cuda`` and skip without a
CUDA device. The module imports nothing of JAX, so it also runs where JAX
is not installed::

    python -m pytest tests/test_torch_cuda.py -m cuda

Kernel and plain edition must agree bitwise (all integer and boolean work).
"""

import numpy as np
import pytest
import torch

from geomesa_tpu_torch.ops import filters as F
from geomesa_tpu_torch.ops import kernels
from geomesa_tpu_torch.ops.zkernels import f64_keys
from geomesa_tpu_torch.parallel.executor import TorchScanExecutor


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
