"""The layouts of z2 grid coordinates that break a run design of the
``pyramid_counts`` kernel, shared by the CPU cases
(``tests/test_torch_pyramid.py``: the plain edition against the
reference) and the card cases (``tests/test_torch_cuda.py``: the kernel
against the plain edition)."""

import numpy as np

# the layouts that break a run design (``pyramid_layout``), with their row
# counts; the hot cell holds more than 4M rows
PYRAMID_LAYOUTS = {
    "hot_cell": 4_195_001, "long_run": 300_000, "three_blocks": 320_001,
    "shuffled": 250_000, "pads_nulls": 200_000, "gap": 150_000,
    "n1": 1, "n31": 31, "n4097": 4097,
}


def pyramid_layout(name: str, n: int = 0, seed: int = 5):
    """One test layout of z2 grid coordinates for ``pyramid_counts``:
    (xi, yi, mask, starts) as numpy arrays and the block bounds the kernel
    takes (see ``kernels.pyramid_block``). Rows are in z2 key order unless
    the layout says otherwise; about 1% of rows are masked out.

    ``hot_cell``: every row in one cell at 12 bits (so at every coarser
    bits); ``long_run``: a uniform background with one cell of n / 3 rows
    in its middle (a run over many tiles); ``three_blocks``: three
    key-sorted blocks, each over the whole grid, with their bounds;
    ``shuffled``: uniform rows in no order, claimed as one block;
    ``pads_nulls``: a masked null-geometry row inside a run of one cell and
    1000 masked pad rows (0, 0) past the block's end; ``gap``: two
    clusters at opposite corners; ``n1``, ``n31``, ``n4097``: uniform rows
    of those counts."""
    from geomesa_tpu_torch.curve.zorder import z2_encode

    n = n or PYRAMID_LAYOUTS[name]
    rng = np.random.default_rng(seed)
    top = 2**31

    def uniform(k):
        return (rng.integers(0, top, k, dtype=np.int64), rng.integers(0, top, k, dtype=np.int64))

    def cell(k, cx, cy):  # k rows inside one 12-bit cell
        w = 1 << 19
        return (cx * w + rng.integers(0, w, k), cy * w + rng.integers(0, w, k))

    def keyed(x, y):
        o = np.argsort(z2_encode(x, y), kind="stable")
        return x[o], y[o]

    blocks = None
    if name == "hot_cell":
        x, y = keyed(*cell(n, 1234, 2345))
    elif name == "long_run":
        bx, by = uniform(n - n // 3)
        hx, hy = cell(n // 3, 2048, 1024)
        x, y = keyed(np.concatenate([bx, hx]), np.concatenate([by, hy]))
    elif name == "three_blocks":
        sizes = (n // 2, n // 3, n - n // 2 - n // 3)
        parts = [keyed(*uniform(k)) for k in sizes]
        x = np.concatenate([p[0] for p in parts])
        y = np.concatenate([p[1] for p in parts])
        blocks = [0, sizes[0], sizes[0] + sizes[1], n]
    elif name == "shuffled":
        x, y = uniform(n)
    elif name == "pads_nulls":
        bx, by = uniform(n - 1000 - 5000)
        hx, hy = cell(5000, 300, 3000)
        x, y = keyed(np.concatenate([bx, hx]), np.concatenate([by, hy]))
        x = np.concatenate([x, np.zeros(1000, np.int64)])
        y = np.concatenate([y, np.zeros(1000, np.int64)])
        blocks = [0, n - 1000]
    elif name == "gap":
        a = cell(n // 2, 5, 7)
        b = cell(n - n // 2, 4090, 4088)
        x, y = keyed(np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]]))
    else:
        x, y = keyed(*uniform(n))
    mask = rng.random(n) > 0.01
    if name == "pads_nulls":
        mask[-1000:] = False
        run = np.flatnonzero((x >> 19 == 300) & (y >> 19 == 3000))
        mask[run[len(run) // 2]] = False
    return (x.astype(np.int32), y.astype(np.int32), mask,
            blocks if blocks is not None else [0, n])


def holed_in_runs(xi, yi, mask):
    """``mask`` with holes inside the key-sorted runs of one 12-bit cell
    (what deletes leave): each run's first and last row and every third
    row cleared. Returns a new mask."""
    mask = mask.copy()
    cell = ((yi.astype(np.int64) >> 19) << 12) | (xi.astype(np.int64) >> 19)
    if len(cell) > 1:
        edge = np.flatnonzero(np.diff(cell) != 0)
        mask[np.concatenate([[0], edge + 1])] = False
        mask[np.concatenate([edge, [len(cell) - 1]])] = False
        mask[::3] = False
    return mask
