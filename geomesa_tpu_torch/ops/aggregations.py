"""Device density aggregation: the plain editions of the density push-down.

Port of ``geomesa_tpu/ops/aggregations.py`` limited to the exact (dual)
density grid of one device: ``grid_snap_indices`` (GridSnap),
``density_kernel`` (the masked scatter-add), ``density_band`` (rows whose
cell or box membership the f32 columns cannot decide) and ``density_dual``
(the grid of the rows the device certifies, plus the indices of the band
rows the host must certify from its f64 columns). ``density_dual`` is the
plain edition of the hand kernel ``density_grid``
(:mod:`geomesa_tpu_torch.ops.kernels`, ``csrc/density_grid.cu``), which
replaces the reference's Pallas ``_density_kernel`` and fuses the band, the
masks, GridSnap and the band's bounded nonzero around it.

Float semantics follow the reference as XLA compiles it: a divide by the
static grid width is lowered to a multiply by the f32 reciprocal of the
width, so ``dx = (xmax - xmin) * f32(1 / width)`` here, not the IEEE
quotient (the two differ in about half the envelopes when the width is not
a power of two); ``(x - xmin) / dx`` is a true IEEE divide; ``round`` is
half to even; the f32 -> int32 cell conversion saturates (NaN -> 0) before
the clip. One device is one shard: no psum, and the band cap is per
device segment.

``pyramid_counts_plain`` is the plain edition of the aggregate pyramid's
build (the reference's ``make_pyramid_counts``, span "agg.pyramid"): the
per-cell row counts of one z2 segment, whose hand kernel is
``pyramid_counts`` (``csrc/pyramid_counts.cu``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.ops.filters import bbox_mask_f32, temporal_mask

DENSITY_BAND_CAP = 8192  # band-candidate budget per segment (32 KB int32 D2H)
_BAND_ULPS = 16.0  # margin over the rigorous f32 quantization + rounding bound
_EPS = float(np.float32(_BAND_ULPS * 2.0 ** -23))


def reciprocal_f32(n: int) -> float:
    """f32(1 / n), rounded once: the constant XLA multiplies by in place of
    a divide by the static ``n``."""
    return float(np.float32(1.0) / np.float32(n))


def _cell_size(env: torch.Tensor, width: int, height: int):
    rw = torch.tensor(reciprocal_f32(width), dtype=torch.float32, device=env.device)
    rh = torch.tensor(reciprocal_f32(height), dtype=torch.float32, device=env.device)
    return (env[2] - env[0]) * rw, (env[3] - env[1]) * rh


def _snap(t: torch.Tensor, n: int) -> torch.Tensor:
    """floor -> saturating int32 convert (NaN -> 0) -> clip to [0, n - 1]."""
    f = torch.nan_to_num(torch.floor(t), nan=0.0)
    return torch.clamp(f, 0, n - 1).to(torch.int32)


def grid_snap_indices(x, y, env, width: int, height: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(col, row, in_env) with GridSnap semantics (GridSnap.scala:1-120):
    cell = floor((v - min) / d), clipped into the grid (the right edge
    snaps into the last cell). ``env`` is f32[4] (xmin, ymin, xmax, ymax)."""
    xmin, ymin, xmax, ymax = env[0], env[1], env[2], env[3]
    dx, dy = _cell_size(env, width, height)
    col = _snap((x - xmin) / dx, width)
    row = _snap((y - ymin) / dy, height)
    in_env = (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
    return col, row, in_env


def density_kernel(x, y, mask, env, width: int, height: int) -> torch.Tensor:
    """Masked scatter-add into an int64 [H, W] grid (the DensityScan
    analog); integer counts are exact in any order."""
    col, row, in_env = grid_snap_indices(x, y, env, width, height)
    keep = mask & in_env
    flat = (row[keep].to(torch.int64) * width + col[keep].to(torch.int64))
    return torch.bincount(flat, minlength=height * width).reshape(height, width)


def density_band(x, y, env, width: int, height: int, boxes
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(band, near): ``band`` = rows whose cell assignment or box
    membership could differ between the device's f32 columns and arithmetic
    and the host's f64 originals; ``near`` = band rows that also pass every
    test with band-widened edges (the candidates the host must certify).
    Inverted pad boxes satisfy neither the wide nor the strict test; NaN
    coordinates fail every compare and are never near."""
    xmin, ymin, xmax, ymax = env[0], env[1], env[2], env[3]
    dx, dy = _cell_size(env, width, height)
    eps = _EPS
    ex = eps * torch.maximum(torch.maximum(xmin.abs(), xmax.abs()), x.abs())
    ey = eps * torch.maximum(torch.maximum(ymin.abs(), ymax.abs()), y.abs())
    tx = (x - xmin) / dx
    ty = (y - ymin) / dy
    ttx = ex / dx.abs() + eps * tx.abs()
    tty = ey / dy.abs() + eps * ty.abs()
    cell_band = ((tx - torch.round(tx)).abs() <= ttx) | ((ty - torch.round(ty)).abs() <= tty)
    any_wide = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    any_strict = torch.zeros_like(any_wide)
    any_ring = torch.zeros_like(any_wide)
    for bx0, by0, bx1, by1 in boxes:
        exk = torch.maximum(ex, eps * torch.maximum(bx0.abs(), bx1.abs()))
        eyk = torch.maximum(ey, eps * torch.maximum(by0.abs(), by1.abs()))
        wide = (x >= bx0 - exk) & (x <= bx1 + exk) & (y >= by0 - eyk) & (y <= by1 + eyk)
        strict = (x >= bx0 + exk) & (x <= bx1 - exk) & (y >= by0 + eyk) & (y <= by1 - eyk)
        any_wide |= wide
        any_strict |= strict
        any_ring |= wide & ~strict
    band = cell_band | (any_ring & ~any_strict)
    near = (
        band & any_wide
        & (tx >= -ttx) & (tx <= width + ttx)
        & (ty >= -tty) & (ty <= height + tty)
    )
    return band, near


def density_dual(x, y, bins: Optional[torch.Tensor], offs: Optional[torch.Tensor],
                 valid, boxes, windows: Optional[torch.Tensor], env,
                 width: int, height: int, band_cap: int = DENSITY_BAND_CAP):
    """One segment's exact density pass -> (grid int64[H, W], band_idx
    int32[band_cap], band_count int32[1]).

    The grid counts ``valid & any box contains & window & ~band & in_env``
    rows (the reference's ``make_sharded_density_dual`` step on one
    shard); ``band_idx`` holds the first ``band_cap`` ascending indices of
    the ``near & valid & window`` rows, padded with -1, and ``band_count``
    their true number (above ``band_cap`` the buffer truncated: the caller
    answers from the host). ``bins, offs, windows`` are None for z2."""
    band, near = density_band(x, y, env, width, height, boxes)
    m = valid & bbox_mask_f32(x, y, boxes)
    cand = near & valid
    if windows is not None:
        tm = temporal_mask(bins, offs, windows)
        m &= tm
        cand &= tm
    grid = density_kernel(x, y, m & ~band, env, width, height)
    count = cand.sum(dtype=torch.int32).reshape(1)
    idx = torch.nonzero_static(cand, size=band_cap, fill_value=-1).flatten()
    return grid, idx.to(torch.int32), count


def pyramid_counts_plain(xi: torch.Tensor, yi: torch.Tensor, mask: torch.Tensor,
                         bits: int) -> torch.Tensor:
    """One segment's pyramid count grid -> int32 [2^bits, 2^bits]: each row
    of ``mask`` counts in cell ``(yi >> s) << bits | (xi >> s)``, ``s = 31 -
    bits``, from its int32 z2 grid coordinates ``xi, yi`` (0 .. 2^31 - 1).
    Integer counts: equal to the reference's sort-and-search in any order."""
    n = 1 << bits
    shift = 31 - bits
    flat = ((yi >> shift).to(torch.int64) << bits) | (xi >> shift).to(torch.int64)
    return torch.bincount(flat[mask], minlength=n * n).to(torch.int32).reshape(n, n)
