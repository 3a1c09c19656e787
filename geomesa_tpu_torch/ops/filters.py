"""Query descriptors and the plain masks of the device predicates.

Port of ``geomesa_tpu/ops/filters.py``. ``pad_boxes`` / ``pad_windows`` pad
a query's boxes and time windows exactly as the reference does (inverted
boxes, ``bin = -1`` windows). The masks are the plain PyTorch editions of
the hand kernels in :mod:`geomesa_tpu_torch.ops.kernels`:

  * ``z3_query_mask`` / ``z2_query_mask``: the conservative candidate masks
    over normalized int32 coordinates (Z3Filter.scala:22-58,
    Z2Filter.scala:18-20), the work of the reference's Pallas
    ``_z3_mask_kernel`` / ``_z2_mask_kernel``;
  * ``bbox_overlap_mask``: the f32 extent-envelope candidate mask of the
    xz2 index (``& temporal_mask`` for xz3), the work of the Pallas
    ``_xz2_mask_kernel`` / ``_xz3_mask_kernel``;
  * ``bbox_mask_f32``: the raw f32 coordinate box mask of the density
    aggregation (the reference's ``bbox_mask_f32``);
  * ``exact_st_mask``: the query's own inclusive f64 bbox + ms window test
    over int64 sort keys (see :mod:`geomesa_tpu_torch.ops.zkernels`), and
    ``attr_combine``, the attribute-code test a point query ANDs onto it
    (the reference's ``_attr_combine`` in
    ``geomesa_tpu/parallel/executor.py``);
  * ``xz_exact_planes``: the extent query's exact (hit, decided) planes
    over int64 envelope keys (the reference's ``_xz_exact_mask_body`` in
    ``geomesa_tpu/parallel/executor.py``);
  * ``devseek_plain`` / ``devseek_xz_plain``: the device-assisted seek's
    candidate expansion, gather and exact test (``exact_st_mask``,
    ``xz_exact_planes``) packed over the candidate space (the reference's
    ``_devseek_fn`` / ``_devseek_xz_fn``);
  * ``poly_planes``: the banded f32 point-in-polygon (hit, decided) planes
    of a point query (the reference's ``_poly_mask_body``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _next_bucket(n: int, minimum: int = 4) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_boxes(
    boxes: Sequence[Tuple[float, float, float, float]],
    minimum: int = 4,
    dtype=np.int32,
) -> np.ndarray:
    """[(xlo, ylo, xhi, yhi)] boxes -> [K, 4] padded to a pow2 bucket.

    Padding uses inverted boxes (lo > hi) which can never contain a point.
    """
    k = _next_bucket(max(len(boxes), 1), minimum)
    out = np.empty((k, 4), dtype=dtype)
    out[:, 0] = 1
    out[:, 1] = 1
    out[:, 2] = 0
    out[:, 3] = 0
    for i, (xlo, ylo, xhi, yhi) in enumerate(boxes):
        out[i] = (xlo, ylo, xhi, yhi)
    return out


def pad_windows(windows: Sequence[Tuple[int, int, int]], minimum: int = 4) -> np.ndarray:
    """[(bin, lo, hi)] inclusive time windows -> [W, 3] int32 padded.

    Padding uses bin = -1 which never matches a stored (non-negative) bin.
    """
    w = _next_bucket(max(len(windows), 1), minimum)
    out = np.empty((w, 3), dtype=np.int32)
    out[:, 0] = -1
    out[:, 1] = 1
    out[:, 2] = 0
    for i, (b, lo, hi) in enumerate(windows):
        out[i] = (b, lo, hi)
    return out


def spatial_mask(xi: torch.Tensor, yi: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """[N] int coords vs [K, 4] int boxes -> [N] bool (any box contains)."""
    m = torch.zeros(xi.shape, dtype=torch.bool, device=xi.device)
    for xlo, ylo, xhi, yhi in boxes:
        m |= (xi >= xlo) & (xi <= xhi) & (yi >= ylo) & (yi <= yhi)
    return m


def temporal_mask(bins: torch.Tensor, offsets: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """[N] (bin, offset) vs [W, 3] (bin, lo, hi) -> [N] bool (any window)."""
    m = torch.zeros(bins.shape, dtype=torch.bool, device=bins.device)
    for wbin, wlo, whi in windows:
        m |= (bins == wbin) & (offsets >= wlo) & (offsets <= whi)
    return m


def z3_query_mask(xi, yi, bins, offsets, valid, boxes, windows) -> torch.Tensor:
    """The fused Z3Filter.inBounds pass (filters/Z3Filter.scala:22-58)."""
    return valid & spatial_mask(xi, yi, boxes) & temporal_mask(bins, offsets, windows)


def z2_query_mask(xi, yi, valid, boxes) -> torch.Tensor:
    """The Z2Filter analog (filters/Z2Filter.scala:18-20)."""
    return valid & spatial_mask(xi, yi, boxes)


def bbox_overlap_mask(bxmin, bymin, bxmax, bymax, valid, boxes) -> torch.Tensor:
    """Per-feature f32 envelopes vs [K, 4] (xlo, ylo, xhi, yhi) query boxes
    -> [N] bool any-overlap mask (the XZ2/XZ3 candidate test; the exact
    geometry intersection stays the host's job, XZ2IndexKeySpace.scala:26+).
    NaN fails every compare."""
    m = torch.zeros(bxmin.shape, dtype=torch.bool, device=bxmin.device)
    for xlo, ylo, xhi, yhi in boxes:
        m |= (bxmin <= xhi) & (bxmax >= xlo) & (bymin <= yhi) & (bymax >= ylo)
    return valid & m


def bbox_mask_f32(x: torch.Tensor, y: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Raw f32 coordinates vs [K, 4] f32 (xlo, ylo, xhi, yhi) boxes -> [N]
    bool any-box containment (inclusive edges; NaN fails every compare).
    Used by the density aggregation."""
    m = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for xlo, ylo, xhi, yhi in boxes:
        m |= (x >= xlo) & (x <= xhi) & (y >= ylo) & (y <= yhi)
    return m


def exact_st_mask(
    xk: torch.Tensor,
    yk: torch.Tensor,
    valid: torch.Tensor,
    box: torch.Tensor,
    tk: Optional[torch.Tensor] = None,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """EXACT spatio-temporal predicate over int64 sort keys.

    ``box`` = int64[4] keys of (xmin, xmax, ymin, ymax), ``window`` =
    int64[2] inclusive (t_lo, t_hi) ms. Rows passing this mask need no host
    post-filter for the primary predicate.
    """
    m = (xk >= box[0]) & (xk <= box[1]) & (yk >= box[2]) & (yk <= box[3])
    if window is not None:
        m &= (tk >= window[0]) & (tk <= window[1])
    return m & valid


# the editions of the attribute plane: a qcode of each is
#   member, notmember  int32[K]: codes (K a pow2 bucket, padded with -2)
#   range              int32[2]: the inclusive code interval [lo, hi]
#   vocabmask          uint8[U_pad]: a 0/1 lookup over the code space
ATTR_KINDS = ("member", "range", "notmember", "vocabmask")


def attr_combine(m: torch.Tensor, codes: torch.Tensor, qcode: torch.Tensor,
                 kind: str) -> torch.Tensor:
    """AND one query's attribute-code test onto the mask ``m``.

    ``codes`` int32[n] are ranks into the segment's sorted value space
    (null, NaN and pad rows rank -1). member: the code is one of the K;
    range: lo <= code <= hi, with no ``code >= 0`` guard, because IS NULL
    is the interval [-1, -1] (pad rows are out through ``valid`` in ``m``);
    notmember: a non-null code none of the K; vocabmask: a non-null code
    whose lookup entry is set (index clipped to the table)."""
    if kind == "range":
        return m & (codes >= qcode[0]) & (codes <= qcode[1])
    if kind == "notmember":
        return m & (codes >= 0) & ~(codes[:, None] == qcode[None, :]).any(-1)
    if kind == "vocabmask":
        lut = qcode[torch.clamp(codes, 0, qcode.shape[0] - 1).long()]
        return m & (codes >= 0) & (lut > 0)
    if kind != "member":
        raise ValueError(f"unknown attribute plane edition {kind!r}")
    return m & (codes[:, None] == qcode[None, :]).any(-1)


def xz_exact_planes(
    bxmin: torch.Tensor,
    bymin: torch.Tensor,
    bxmax: torch.Tensor,
    bymax: torch.Tensor,
    isrect: torch.Tensor,
    valid: torch.Tensor,
    desc: torch.Tensor,
    zero: torch.Tensor,
    tk: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EXACT extent predicate over int64 envelope sort keys -> (hit, decided).

    ``desc`` = int64[8] (xmin, ymin, xmax, ymax, zero, rect, t_lo, t_hi)
    keys (see ``TorchScanExecutor._xz_desc``); ``zero`` is the key of 0.0,
    the envelope of a null geometry (the placeholder). hit = the stored
    envelope overlaps the query envelope, ``& valid`` (and, with ``tk``,
    ``t_lo <= tk <= t_hi``); decided = hit & rect & ~placeholder & (inside |
    isrect): rows whose final answer the envelope alone gives. hit &
    ~decided is the ring the host tests geometry by geometry."""
    overlap = (desc[0] <= bxmax) & (bxmin <= desc[2]) & (desc[1] <= bymax) & (bymin <= desc[3])
    hit = overlap & valid
    if tk is not None:
        hit &= (tk >= desc[6]) & (tk <= desc[7])
    placeholder = (bxmin == zero) & (bymin == zero) & (bxmax == zero) & (bymax == zero)
    inside = (desc[0] <= bxmin) & (bxmax <= desc[2]) & (desc[1] <= bymin) & (bymax <= desc[3])
    decided = hit & (desc[5] != 0) & ~placeholder & (inside | isrect)
    return hit, decided


def devseek_rows(starts: torch.Tensor, ends: torch.Tensor, cand_cap: int):
    """(rows int64[cand_cap], ok bool[cand_cap]) of the device-assisted
    seek's candidate space: ``starts`` int32[n_iv] interval starts (segment
    rows) and ``ends`` int32[n_iv] the inclusive prefix sums of their
    lengths (zero-length pads at the end). Candidate j < ends[-1] lies in
    the interval ``searchsorted(ends, j, side="right")``, so zero-length
    intervals are never chosen; its row is 0 where ``ok`` is false."""
    dev = starts.device
    n_iv = starts.shape[0]
    j = torch.arange(cand_cap, dtype=torch.int64, device=dev)
    e = ends.to(torch.int64)
    seg = torch.clamp(torch.searchsorted(e, j, right=True), 0, n_iv - 1)
    prev = e[seg] - (e - torch.cat([e.new_zeros(1), e[:-1]]))[seg]
    ok = j < e[-1]
    rows = starts.to(torch.int64)[seg] + (j - prev)
    return torch.where(ok, rows, torch.zeros_like(rows)), ok


def devseek_plain(xk, yk, tk, valid, starts, ends, box, win, cand_cap: int) -> torch.Tensor:
    """The device-assisted seek of a point query -> u8[cand_cap / 8], MSB
    first: candidate j's bit is :func:`exact_st_mask` of its gathered keys
    (``box`` int64[4], ``win`` int64[2] or None; ``valid`` the temporal-valid
    column with a window), false past the candidates (:func:`devseek_rows`)."""
    from geomesa_tpu_torch.ops.zkernels import pack_mask_rows

    rows, ok = devseek_rows(starts, ends, cand_cap)
    m = exact_st_mask(xk[rows], yk[rows], valid[rows] & ok, box,
                      None if win is None else tk[rows], win)
    return pack_mask_rows(m)


def devseek_xz_plain(bxmin, bymin, bxmax, bymax, isrect, valid, tk, starts, ends, desc,
                     cand_cap: int, has_time: bool) -> torch.Tensor:
    """The device-assisted seek of an extent query -> u8[2 * cand_cap / 8]:
    the packed ``hit`` plane, then ``decided`` (:func:`xz_exact_planes` of
    the gathered envelope keys, ``desc`` int64[8]; ``tk`` and the window
    with ``has_time``), both false past the candidates."""
    from geomesa_tpu_torch.ops.zkernels import pack_mask_rows

    rows, ok = devseek_rows(starts, ends, cand_cap)
    hit, dec = xz_exact_planes(bxmin[rows], bymin[rows], bxmax[rows], bymax[rows],
                               isrect[rows], valid[rows] & ok, desc, desc[4],
                               tk[rows] if has_time else None)
    return torch.cat([pack_mask_rows(hit), pack_mask_rows(dec)])


# the banded polygon ray cast: rows within POLY_EPS of a ring vertex's
# latitude, or within POLY_XINT_K * POLY_EPS (scaled by the edge's slope) of a
# computed crossing, are BAND rows that f32 cannot certify: they stay hit but
# undecided and take the host's exact test. EPS covers f32 coordinate
# rounding (an ulp at |lon| <= 180 is ~1.5e-5) plus the crossing's arithmetic
# error with a wide margin. The f32 constants are those of the reference:
# f32(1e-4) and f32(1e-4 * 16.0), not f32(1e-4) * 16.
POLY_EPS = 1e-4
POLY_XINT_K = 16.0
# elements of one [edges, rows] block of poly_planes (its edges go in blocks)
_POLY_BLOCK = 1 << 24


def poly_planes(
    xk: torch.Tensor,
    yk: torch.Tensor,
    valid: torch.Tensor,
    box: torch.Tensor,
    xf: torch.Tensor,
    yf: torch.Tensor,
    edges: torch.Tensor,
    tk: Optional[torch.Tensor] = None,
    window: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded point-in-polygon planes of one query -> (hit, decided).

    ``env`` is the exact envelope (+ window) test on the sort keys
    (:func:`exact_st_mask`: ``box`` int64[4] keys of (xmin, xmax, ymin,
    ymax), ``window`` int64[2] inclusive ms); ``edges`` f32[E, 4] as (x1,
    y1, x2, y2) of every ring, degenerate (x1 == x2 and y1 == y2) pad edges
    adding nothing. Per edge and row, in f32 with one rounding per
    operation, as the reference's step:
    ``straddle = (y1 > yf) != (y2 > yf)``, ``dy = y2 - y1`` (1 when 0),
    ``xint = x1 + (yf - y1) / dy * (x2 - x1)``, ``cross = straddle & xf <
    xint``, ``near = |yf - y1| < eps | |yf - y2| < eps``, ``nearx =
    straddle & |xf - xint| < keps * (1 + |x2 - x1| / max(|dy|, eps))``,
    and ``band`` collects ``near | nearx``. ``hit = env & (odd crossings |
    band)``, ``decided = hit & ~band``. The edges run in blocks of
    ``[edges, rows]``; each element's arithmetic is the same."""
    env = exact_st_mask(xk, yk, valid, box, tk, window)
    eps = torch.tensor(np.float32(POLY_EPS), device=xf.device)
    keps = torch.tensor(np.float32(POLY_EPS * POLY_XINT_K), device=xf.device)
    one = torch.tensor(np.float32(1.0), device=xf.device)
    crossings = torch.zeros(xf.shape, dtype=torch.int32, device=xf.device)
    band = torch.zeros(xf.shape, dtype=torch.bool, device=xf.device)
    step = max(1, _POLY_BLOCK // max(1, xf.shape[0]))
    px, py = xf[None, :], yf[None, :]
    for e0 in range(0, edges.shape[0], step):
        e = edges[e0:e0 + step]
        x1, y1, x2, y2 = (e[:, j:j + 1] for j in range(4))
        degen = (x1 == x2) & (y1 == y2)
        straddle = (y1 > py) != (y2 > py)
        dy = torch.where(y2 == y1, one, y2 - y1)
        xint = x1 + (py - y1) / dy * (x2 - x1)
        cross = straddle & (px < xint) & ~degen
        near = ((py - y1).abs() < eps) | ((py - y2).abs() < eps)
        slope_tol = keps * (one + (x2 - x1).abs() / torch.maximum(dy.abs(), eps))
        nearx = straddle & ((px - xint).abs() < slope_tol)
        crossings += cross.sum(0, dtype=torch.int32)
        band |= ((near | nearx) & ~degen).any(0)
    odd = (crossings & 1) == 1
    hit = env & (odd | band)
    return hit, hit & ~band
