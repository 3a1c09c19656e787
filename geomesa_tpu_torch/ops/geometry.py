"""Device geometry predicates: point-in-polygon and distance masks.

Port of ``geomesa_tpu/ops/geometry.py``. The constants and the edge lists
(``GRID_BITS``, ``METERS_PER_DEGREE``, ``snap_epsilon_deg``,
``snap_epsilon_m``, ``polygon_edges``) are copies; the f32 predicates
(``points_in_polygon_f32``, ``haversine_m_f32``, ``dwithin_mask_f32``) are
torch editions with the reference's operation order, one rounding per
operation. The plain editions of the spatial join's kernels live here too
(``join_pip_plain``, ``join_dwithin_plain``: the reference's ``_pip_fn`` and
``_dwithin_fn`` in ``geomesa_tpu/ops/join.py``), so that
:mod:`geomesa_tpu_torch.ops.kernels` imports them without a cycle through
:mod:`geomesa_tpu_torch.ops.join`. Results are float32 pre-filters; the
exact f64 semantics stay with the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from geomesa_tpu_torch.geom.base import Polygon

# z2 normalization resolution (curve/zorder: 2 dims x 31 bits). The curve
# layer snaps every coordinate to this grid before keys are built, so any
# device predicate evaluated against index-derived coordinates is off by
# at most one cell from the f64 truth.
GRID_BITS = 31
# the planner's meters->degrees conversion constant (filter/ast.DWithin):
# radii must mean the same thing in planner pruning and kernel evaluation
METERS_PER_DEGREE = 111320.0
# the f32 earth radius and degree -> radian factor of the f32 haversine
EARTH_RADIUS_F32 = np.float32(6371008.8)
RAD_F32 = np.float32(np.pi / 180.0)
# rows of one [rows, candidates, edges] block of join_pip_plain
_PIP_BLOCK = 1 << 22


def snap_epsilon_deg(bits: int = GRID_BITS) -> float:
    """The curve layer's GridSnap quantum in degrees: one normalization
    cell of the wider (longitude) dimension. The largest displacement
    snapping to the z2/z3 grid can introduce per axis — any
    distance-derived pruning or device mask must widen by at least this
    much or boundary rows disagree between the planner's int-domain
    pruning and the kernel's coordinate-domain evaluation."""
    return 360.0 / (1 << bits)


def snap_epsilon_m(radius_m: float = 0.0, bits: int = GRID_BITS) -> float:
    """``snap_epsilon_deg`` in meters (planner conversion scale), plus the
    f32 evaluation slack for a radius of ``radius_m``: float32 carries
    ~7 significant digits, so a great-circle distance near ``radius_m``
    (or near the earth-scale intermediate terms) can round by a few
    meters. The sum is the widening that makes an f32 device dwithin
    mask a guaranteed SUPERSET of the f64 host predicate — the contract
    every device pre-filter in this repo honors."""
    f32_slack = max(16.0, abs(radius_m) * 4e-6)
    return snap_epsilon_deg(bits) * METERS_PER_DEGREE + f32_slack


def polygon_edges(polygon: Polygon) -> np.ndarray:
    """[(x0, y0, x1, y1)] for all rings (shell + holes), f32.

    With the even-odd rule, hole edges flip containment automatically.
    """
    rings = [polygon.shell] + list(getattr(polygon, "holes", []) or [])
    out = []
    for ring in rings:
        coords = np.asarray(ring, dtype=np.float32)
        if len(coords) and not np.array_equal(coords[0], coords[-1]):
            coords = np.vstack([coords, coords[:1]])
        for i in range(len(coords) - 1):
            out.append((coords[i, 0], coords[i, 1], coords[i + 1, 0], coords[i + 1, 1]))
    return np.asarray(out, dtype=np.float32)


def points_in_polygon_f32(x: torch.Tensor, y: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Even-odd ray cast: [N] points vs [E, 4] edges -> [N] bool.

    A horizontal ray to +x from each point; crossing parity = containment.
    """
    x0, y0, x1, y1 = edges[:, 0], edges[:, 1], edges[:, 2], edges[:, 3]
    px = x[:, None]
    py = y[:, None]
    # edge straddles the ray's y (half-open to avoid double-count at vertices)
    straddles = (y0[None, :] > py) != (y1[None, :] > py)
    dy = y1 - y0
    denom = torch.where(dy == 0, torch.ones_like(dy), dy)[None, :]
    xint = x0[None, :] + (py - y0[None, :]) * (x1 - x0)[None, :] / denom
    crossings = (straddles & (xint > px)).sum(dim=1, dtype=torch.int32)
    return (crossings % 2) == 1


def haversine_m_f32(x: torch.Tensor, y: torch.Tensor, cx: torch.Tensor,
                    cy: torch.Tensor) -> torch.Tensor:
    """Great-circle distance (meters), f32, broadcasting: ``radians`` as a
    multiply by the f32 factor, ``R = 6371008.8``, ``2 R asin(min(1,
    sqrt(a)))`` with NaN passing through the ``min`` (``jnp.minimum``)."""
    rad = torch.tensor(RAD_F32, device=x.device)
    lon1, lat1 = x * rad, y * rad
    lon2, lat2 = cx * rad, cy * rad
    s1 = torch.sin((lat2 - lat1) / 2)
    s2 = torch.sin((lon2 - lon1) / 2)
    a = s1 * s1 + torch.cos(lat1) * torch.cos(lat2) * (s2 * s2)
    two_r = torch.tensor(np.float32(2 * EARTH_RADIUS_F32), device=x.device)
    return two_r * torch.asin(torch.clamp(torch.sqrt(a), max=1.0))


def dwithin_mask_f32(x: torch.Tensor, y: torch.Tensor, cx: float, cy: float,
                     radius_m: float, snap_m: float = None) -> torch.Tensor:
    """Haversine distance mask (meters), f32.

    The mask is a candidate PRE-filter, so it must never be stricter than
    the host predicate it screens for: the radius widens by the curve
    layer's GridSnap/normalization epsilon plus the f32 rounding slack
    (``snap_epsilon_m``) so a point exactly on the radius — or displaced by
    one grid cell of index snapping — always survives to the exact f64
    post-filter. ``snap_m=0.0`` restores the raw mask for callers that do
    their own widening."""
    if snap_m is None:
        snap_m = snap_epsilon_m(radius_m)
    dev = x.device
    d = haversine_m_f32(x, y, torch.tensor(np.float32(cx), device=dev),
                        torch.tensor(np.float32(cy), device=dev))
    return d <= torch.tensor(np.float32(radius_m), device=dev) + torch.tensor(
        np.float32(snap_m), device=dev)


def join_pip_plain(px: torch.Tensor, py: torch.Tensor, cand: torch.Tensor,
                   edges: torch.Tensor, ecnt: torch.Tensor,
                   eps_deg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contains join's dual mask of one probe group (the reference's
    ``_pip_fn``): ``px, py`` f32[N] (NaN pads), ``cand`` int32[C] build
    geometries (-1 pads; or int32[N, C], a candidate row per probe row),
    ``edges`` f32[G, E, 4] and ``ecnt`` int32[G] the resident edge lists,
    ``eps_deg`` the f32 boundary band. Per (row, candidate), in f32 with one
    rounding per operation: the even-odd crossing parity over the
    candidate's live edges, and ``near`` = some live edge within
    ``eps_deg`` (``min d2 <= eps^2``; a NaN row is near nothing). Returns
    (accept = inside & ~near & valid, check = near & valid), bool[N, C];
    ``valid`` = the slot holds a candidate. The rows run in blocks of [rows,
    C, E]; each element's arithmetic is the same."""
    dev = px.device
    per_row = cand.dim() == 2
    n, c = px.shape[0], cand.shape[-1]
    e_cap = edges.shape[1]
    one = torch.tensor(np.float32(1.0), device=dev)
    zero = torch.tensor(np.float32(0.0), device=dev)
    eps = torch.tensor(np.float32(eps_deg), device=dev)
    eps2 = eps * eps
    accept = torch.zeros((n, c), dtype=torch.bool, device=dev)
    check = torch.zeros((n, c), dtype=torch.bool, device=dev)
    lanes = torch.arange(e_cap, device=dev)
    step = max(1, _PIP_BLOCK // max(1, c * e_cap))
    for r0 in range(0, n, step):
        cb = cand[r0:r0 + step] if per_row else cand[None]   # [n|1, C]
        idx = torch.clamp(cb, min=0).long()
        e = edges[idx]                                       # [n|1, C, E, 4]
        emask = lanes < ecnt[idx][..., None]                 # [n|1, C, E]
        x0, y0, x1, y1 = e[..., 0], e[..., 1], e[..., 2], e[..., 3]
        abx = x1 - x0
        aby = y1 - y0
        denom = torch.where(aby == 0, one, aby)
        den = abx * abx + aby * aby
        den = torch.where(den == 0, one, den)
        pxb = px[r0:r0 + step, None, None]
        pyb = py[r0:r0 + step, None, None]
        straddles = ((y0 > pyb) != (y1 > pyb)) & emask
        xint = x0 + (pyb - y0) * abx / denom
        crossings = (straddles & (xint > pxb)).sum(dim=2, dtype=torch.int32)
        inside = (crossings % 2) == 1
        t = torch.clamp(((pxb - x0) * abx + (pyb - y0) * aby) / den, zero, one)
        dx = pxb - (x0 + t * abx)
        dy = pyb - (y0 + t * aby)
        d2 = dx * dx + dy * dy
        near = ((d2 <= eps2) & emask).any(dim=2)
        valid = cb >= 0
        accept[r0:r0 + step] = inside & ~near & valid
        check[r0:r0 + step] = near & valid
    return accept, check


def join_dwithin_distances(px: torch.Tensor, py: torch.Tensor, cand: torch.Tensor,
                           bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
    """The f32 haversine distance of every (row, candidate) pair, f32[N, C]
    (``haversine_m_f32``; ``cand`` int32[C] or int32[N, C] as for
    :func:`join_pip_plain`; a -1 slot reads geometry 0)."""
    idx = torch.clamp(cand, min=0).long()
    if idx.dim() == 1:
        idx = idx[None]
    return haversine_m_f32(px[:, None], py[:, None], bx[idx], by[idx])


def join_dwithin_plain(px: torch.Tensor, py: torch.Tensor, cand: torch.Tensor,
                       bx: torch.Tensor, by: torch.Tensor, r_m,
                       eps_m) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dwithin join's dual mask of one probe group (the reference's
    ``_dwithin_fn``): ``cand`` as for :func:`join_pip_plain`, ``bx, by``
    f32[G] the resident build points (NaN for a null geometry), ``r_m`` and
    ``eps_m`` f32. With ``d`` the f32 haversine
    (``join_dwithin_distances``), ``lo = r_m - eps_m`` and ``hi = r_m +
    eps_m`` in f32: accept = d <= lo, check = lo < d <= hi, each & the slot
    holds a candidate & d is not NaN. bool[N, C] each."""
    dev = px.device
    d = join_dwithin_distances(px, py, cand, bx, by)
    r = torch.tensor(np.float32(r_m), device=dev)
    eps = torch.tensor(np.float32(eps_m), device=dev)
    lo, hi = r - eps, r + eps
    valid = (cand >= 0) & ~torch.isnan(d)
    return (d <= lo) & valid, (d > lo) & (d <= hi) & valid


def dwithin_threshold_band(d: torch.Tensor, r_m, eps_m, ulps: int = 4) -> torch.Tensor:
    """bool[...]: the pairs whose f32 distance ``d`` lies within ``ulps``
    ulps of ``r - eps`` or ``r + eps`` (f32): where two editions of the f32
    haversine whose ``sin`` / ``cos`` / ``asin`` differ by ulps may place a
    pair on either side of a threshold (accept or check, check or none).
    The host decides every check pair in f64, so such a move never changes
    a join's pairs."""
    r = np.float32(r_m)
    eps = np.float32(eps_m)
    dd = d.double()
    # one ulp of |d| in f32: |d| = m 2^e, m in [0.5, 1), ulp = 2^(e - 24)
    ulp = torch.ldexp(torch.ones_like(dd), (torch.frexp(d.abs())[1] - 24).to(dd.dtype))
    lo, hi = float(r - eps), float(r + eps)
    return ((dd - lo).abs() <= ulps * ulp) | ((dd - hi).abs() <= ulps * ulp)
