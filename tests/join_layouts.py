"""Probe-chunk layouts of the spatial join's masks (``kernels.join_pip`` /
``join_dwithin``), pure numpy, shared by the card tests
(``tests/test_torch_cuda.py``) and the CPU tests against the reference
(``tests/test_torch_join.py``).

A layout is the launch input of one chunk: rows sorted by group with CSR
offsets ``goff``, each group's row ``grow`` of the candidate matrix
``cand`` (-1 pads). The layouts are the ones a grid of row tiles x
candidate slots can get wrong: a tile wholly inside one group, tiles
straddling group boundaries, dead slots, a polygon longer than a
shared-memory tile of edges, a row count that is no multiple of the tile.
"""

import numpy as np

# the kernels' row tile (csrc/join.cu kPipRows, kRows)
TILE_ROWS = 128
N_GEOMS = 40
# geometry 1's ring in the "big_polygon" layout: more edges than the
# kernel's shared-memory tile (kTile, 512)
E_BIG = 1200

# join_pip's boundary band on the layouts (degrees): wide enough that
# every layout has check flags as well as accepts
LAYOUT_EPS_DEG = 0.05
# the dwithin radius (metres) on the layouts
LAYOUT_RADIUS_M = 300_000.0

# name -> (group sizes, candidate slots a row, options)
LAYOUTS = {
    "whole_chunk": ([2048], 8, {}),
    "one_row_groups": ([1] * 300, 8, {}),
    "boundary_in_tile": ([100, 60, 200, 37, 1, 250], 8, {}),
    "dead_candidate_row": ([130, 70, 128, 90], 8, {"dead_row": True}),
    "cap128_one_live": ([100, 156, 90], 128, {"one_live": True}),
    "nan_at_tile_edges": ([300, 212], 8, {"nan_rows": tuple(
        r for k in range(1, 4) for r in (k * TILE_ROWS - 1, k * TILE_ROWS)) + (0, 511)}),
    "big_polygon": ([90, 130, 80], 4, {"e_big": E_BIG}),
    "ragged_rows": ([333, 250, 417], 8, {}),
}


def layout(name: str, seed: int = 0):
    """(px, py, goff, grow, cand) of layout ``name``: f32 rows in the
    stars' region (NaN rows every 97th and where the layout says), int32
    offsets, group rows and candidate matrix over N_GEOMS geometries (the
    last edgeless). Every candidate row but a dead one holds geometry 0,
    so each group meets a star."""
    sizes, c_cap, opt = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    groups = len(sizes)
    goff = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    rows = int(goff[-1])
    px = rng.uniform(-1, 21, rows).astype(np.float32)
    py = rng.uniform(-1, 21, rows).astype(np.float32)
    nan = list(range(0, rows, 97)) + [r for r in opt.get("nan_rows", ()) if r < rows]
    px[nan] = np.nan
    py[nan] = np.nan
    n_cand = groups + 2
    cand = np.full((n_cand, c_cap), -1, np.int32)
    for b in range(n_cand):
        if opt.get("one_live"):
            cand[b, rng.integers(0, c_cap)] = 0
            continue
        k = int(rng.integers(2, c_cap + 1))
        cand[b, :k] = rng.choice(N_GEOMS, k, replace=False)
        cand[b, 0] = 0
        cand[b, k - 1] = N_GEOMS - 1  # the edgeless geometry
        if opt.get("e_big"):
            cand[b, 1] = 1
    grow = rng.integers(0, n_cand, groups).astype(np.int32)
    if opt.get("dead_row"):
        cand[-1] = -1
        grow[1] = n_cand - 1
    return px, py, goff, grow, cand


def edge_table(name: str, seed: int = 0):
    """(edges f32[N_GEOMS, E, 4], ecnt int32[N_GEOMS]): star rings with a
    hole every third, the last geometry edgeless and, where the layout
    says, geometry 1 a ring of E_BIG edges; E the next power of two of the
    longest list, at least 8."""
    e_big = LAYOUTS[name][2].get("e_big", 0)
    rng = np.random.default_rng(seed + 1000)
    lists = []
    for g in range(N_GEOMS):
        cx, cy, r = rng.uniform(2, 18), rng.uniform(2, 18), rng.uniform(0.5, 4)
        k = e_big // 2 if (e_big and g == 1) else int(rng.integers(4, 32))
        ang = np.linspace(0, 2 * np.pi, 2 * k + 1)[:-1]
        rad = np.where(np.arange(2 * k) % 2 == 0, r, 0.5 * r)
        ring = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
        rings = [np.vstack([ring, ring[:1]])]
        if g % 3 == 0:
            hole = np.stack([cx + 0.3 * r * np.cos(ang), cy + 0.3 * r * np.sin(ang)], 1)[::-1]
            rings.append(np.vstack([hole, hole[:1]]))
        lists.append(np.concatenate([np.concatenate([rg[:-1], rg[1:]], 1) for rg in rings])
                     .astype(np.float32))
    lists[-1] = lists[-1][:0]
    e_pad = 8
    while e_pad < max(len(e) for e in lists):
        e_pad *= 2
    edges = np.zeros((N_GEOMS, e_pad, 4), np.float32)
    ecnt = np.zeros(N_GEOMS, np.int32)
    for g, e in enumerate(lists):
        edges[g, :len(e)] = e
        ecnt[g] = len(e)
    return edges, ecnt


def sites(seed: int = 0):
    """(bx, by) f32[N_GEOMS]: build points in the rows' region, the one at
    index 7 null (NaN)."""
    rng = np.random.default_rng(seed + 2000)
    bx = rng.uniform(0, 20, N_GEOMS).astype(np.float32)
    by = rng.uniform(0, 20, N_GEOMS).astype(np.float32)
    bx[7] = by[7] = np.nan
    return bx, by
