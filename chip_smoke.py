"""Chip smoke test of the PyTorch/CUDA port on one GPU.

Drives the port's main paths on the card and holds every hand kernel
against its plain PyTorch edition:

  * BASELINE config #1: GDELT-style points, a bbox + DURING query stream
    through ``TorchDataStore.query`` / ``query_many`` (z3/z2: the
    ``candidate_mask`` and ``exact_bitmap`` kernels);
  * BASELINE config #3: OSM-way-shaped extents (LineStrings, rotated
    polygons, rectangles, null geometries) in one ``ways`` schema
    (``*geom:Geometry:srid=4326,dtg:Date``: xz3, xz2, id), five streams:
    (a) bench_suite.py bench_xz2's 24 jittered bboxes (xz2, dual route),
    (b) the same boxes AND a 3-week DURING (xz3, dual route), (c) 4
    INTERSECTS with a triangle (every hit in the ring), (d) 8 bbox A OR
    bbox B (xz2 candidate route) and (e) 8 (A OR B) AND DURING (xz3
    candidate route): the ``xz_mask`` and ``xz_dual_bitmap`` kernels;
  * the density push-down (``hints={"density": {"envelope", "width",
    "height"}}``, the ``density_grid`` kernel): BASELINE config #6
    (bench_suite.py bench_density: 8M uniform points, schema ``dens`` =
    ``*geom:Point:srid=4326``, z2), stream (f) 16 bbox heatmaps at 256x128
    (bench_density's box, then 15 shifted +-5 deg), (g) 4 of them at
    512x512 (a 1 MiB grid); on config #1's table,
    (h) its 20 jittered boxes AND its DURING at 64x32 (z3), (i) its base
    box AND DURING at 256x256, whose band overflows: the host reducer;
  * BASELINE config #4, the attribute planes (bench_suite.py
    bench_attr_bbox: 8M points from default_rng(7), schema ``gdelt_attr`` =
    ``actor1:String:index=true,goldstein:Double,dtg:Date,*geom:Point``: z3,
    z2, id, attr:actor1): the lone query ``actor1 = 'USA' AND bbox``, stream
    (j) bench_attr_bbox's 24 interleaved ``actor1 = X AND bbox`` and
    ``goldstein > lo AND goldstein <= hi AND bbox`` and stream (k) 16
    queries reaching the other editions (IN, a ``<>`` chain, LIKE '%R%',
    ILIKE, LIKE prefixes; half of them with a DURING, on z3): the attribute
    editions of ``exact_bitmap`` (member, range, notmember, vocabmask);
  * BASELINE config #5, kNN and TubeSelect (bench_suite.py bench_knn: 8M
    points from default_rng(8), 30 days, schema ``knn`` =
    ``dtg:Date,*geom:Point:srid=4326``: z3, z2, id) through
    ``geomesa_tpu_torch.process``: (n) bench_knn's query (2.35, 48.85), k =
    10, KNN_REPS calls; (o) 16 seeded query points (lon 179.95 and lat 84
    among them) at k = 1, 10 and 1000; (p) TubeSelect of one track of 8
    samples over a day with the reference's default buffers (1000 m, 10
    min), then wide ones: the ``knn_topk`` kernel (and ``candidate_mask``
    under the tube's query);
  * the banded polygon plane (bench_suite.py bench_poly: 8M points from
    default_rng(9), schema ``poly`` = ``*geom:Point:srid=4326``: z2, id): its
    star alone through ``store.query`` under ``GEOMESA_SEEK=auto`` (the host
    seek) and ``0`` (the candidate mask), (l) its 24 jittered stars through
    ``query_many``, (m) 8 jittered stars (one with a hole, one a disjoint
    MultiPolygon) AND a 7-day DURING on config #5's table (z3): the
    ``poly_dual_bitmap`` kernel;
  * the count and stats push-downs and the attribute editions of the dual
    planes: ``store.count`` under ``GEOMESA_COUNT_DEVICE=1`` of config #1's
    20 queries (``exact_count`` z3), bench_xz2's count and the same box AND
    ``kind >= 'polygon'`` on config #3's table (the q = 1 dual planes and
    their range edition), bench_poly's star (the q = 1 ray cast), and on
    config #4's table ``actor1 = 'USA' AND bbox``, a goldstein range AND
    bbox (``exact_count`` z2 member, range) and the star AND the range
    (the ray cast's range edition); bench_attr_bbox's stats query
    ``Count();MinMax(goldstein);TopK(actor1)`` under
    ``GEOMESA_STATS_DEVICE=1`` and ``auto`` (``exact_stat_hist``); stream
    (a') 8 jittered boxes AND ``kind = X`` on config #3's table (whose
    schema adds the way's kind to bench_xz2's) and (l') 8 jittered stars
    AND ``actor1 = X`` on config #4's table, on the dual planes' member
    editions;
  * concurrent serving (the reference's scripts/bench_gate.py
    ``run_concurrent_stream`` and ``_receipt_probe``): 8 barrier-started
    client threads of 2 ``store.query`` calls each on four streams, config
    #1's jittered ``bbox AND DURING``, config #3's (a) boxes, the polygon
    plane's (l) stars and config #4's (j), once with the cross-query
    coalescer on (the defaults) and once with ``geomesa.batch.enabled=false``:
    the coalescer's stacked mask batches (``exact_mask_batch``,
    ``dual_mask_batch`` "xz" and "poly" on the ``exact_bitmap``,
    ``xz_dual_bitmap`` and ``poly_dual_bitmap`` kernels);
  * the aggregate pyramid cache (the reference's GeoBlocks cache,
    ``ops/pyramid.py``): cold builds of config #1's z2 table and the
    polygon table at 12 and 8 cell bits, config #1's 8 bbox-only counts and
    stream (l)'s 24 star counts with the cache on and off in turns,
    ``store.aggregate`` of config #4's box over goldstein, stream (f) again
    from the density memo, and a transform, sampled and ``bin`` query: the
    ``pyramid_counts`` kernel;
  * the write lifecycle and labels (the reference's ``delete_features``,
    ``compact``, age-off and visibility): 1% of config #1's fids drawn by
    seed plus every row of one stream box deleted, then its 20 queries,
    their counts (the device count, and the rebuilt pyramid at 8 and 12
    bits) and the (h) heatmaps; ``geomesa.feature.expiry`` over about 30%
    of its rows, then ``age_off()``; 1% of config #3's ways deleted,
    streams (a)-(e) before and after ``compact``; an 8M-row GDELT-style
    table with a ``__vis__`` column of eight label expressions under three
    authorization sets: ``exact_bitmap_z3``, ``exact_count_z3``,
    ``density_grid_z3``, ``xz_dual_bitmap_xz2`` / ``_xz3`` and
    ``pyramid_counts`` on holed masks;
  * the faults: config #1's stream and stream (a) under a seeded
    ``device.dispatch`` / ``device.fetch`` schedule until the device
    circuit breaker opens, the open circuit, the probe that closes it, and
    one failed device kNN.

The aggregate cache (``geomesa.agg.enabled``) is off for every phase but
the pyramid phase: with it on, the density streams' repeated queries would
answer from the memo and the count path's star from the pyramid, not from
the kernels those phases measure.

Every stream above runs under ``GEOMESA_SEEK=0`` (the device routes, as
bench.py pins for the reference's device figures). Beside them, the host
layer (the C++ libraries of ``geomesa_tpu_torch/native``) and the host-seek
route: config #1's 20 queries under ``GEOMESA_SEEK=auto``, the chooser's
default.

Run from the repository root with one CUDA device:

    python3 chip_smoke.py [--rows N] [--ways N] [--dens N] [--attr N] [--knn N]
                          [--poly N] [--labels N] [--seed S] [--out DIR]
                          [--ab DIR [DIR ...]]

Phases (any failure raises and the script exits non-zero):
  1. header: card name and power limit, torch / CUDA versions, the kernels'
     nvcc build time (one nvcc per source, all at once, beside one g++ per
     native host library) and what ``-Xptxas -v`` reports of each kernel
     (registers, spills); the run fails unless all four native libraries
     load;
  2. config #1: ingest N points (20M by default), upload the z3/z2 device
     columns; config #3: make N ways (8M by default) from the seed, ingest
     them with precomputed envelope companions, upload the xz3/xz2 device
     columns, plan every stream and answer it with the numpy oracle
     (``oracle_rows``, which shares no code with the port's geometry);
     config #6: ingest N points (8M by default), upload the raw f32 columns
     of its z2 table and of config #1's z3 table, and answer (f)-(i) with a
     numpy f64 GridSnap oracle (``density_oracle``); config #4: ingest N
     rows (8M by default; each table's build timed), upload the z3 / z2
     exact columns and the actor1 and goldstein code columns, and answer
     its streams by numpy brute force over the generator's arrays
     (``attr_oracle``); config #5 and the polygon table: ingest N points
     each (8M by default), upload the f32 coordinates and sort keys, and
     answer every kNN, tube and polygon query by f64 brute force
     (``knn_oracle``, ``tube_oracle``, bench_poly's even-odd ``pip``);
  3. every kernel instantiation against its plain edition at each shape
     its paths launch it at (bitwise equality), timed beside its plain
     edition and its bound: ``ms`` is the kernel's own device time per
     launch, read by name in two torch.profiler windows of 50 calls each
     and the larger reading kept (``ms_windows``; an entry whose windows
     differ by more than 5%, or one of which is below the bound, is
     flagged, logged and counted), ``call_ms`` the CUDA-event time of 50
     back-to-back calls over 50 (the wrapper's cost), which also stands in
     for ``ms`` where the profiler shows no device time or a time below the
     bound (``ms_source``); with ``--ab DIR [DIR ...]``, each kernel whose
     source has another design in a DIR (same C interface) is also timed
     from it, in turns with its own;
  4. each main path with the launch counts reset just before and read just
     after: config #1 (one sync query, then 20 jittered queries through
     query_many, a bbox-only stream (z2 exact), the residual streams) and
     config #3 (streams (a)-(e): a warm and a timed query_many each, then
     each query alone through store.query, checked and timed), every query
     checked for fid-set parity; the density streams (f)-(i) (each query
     alone through store.query, then the stream through query_many), every
     grid equal to the oracle and every query on its stream's route (each
     density stream is a path of its own); then, outside the counted
     paths, a small z3 table with null dates: a heatmap whose DURING
     window holds the epoch, where the nulls are stored, must leave them
     out (its grid sums to the row query's count and equals its oracle);
     config #4 (the lone query under ``GEOMESA_SEEK=auto``, then alone
     through store.query and through query_many, then streams (j) and
     (k), warm, timed with fids unread and read, every query on the device
     attribute plane), then its kernel phase: each attribute edition at
     each shape the path launched it at (q = 1 refetches of a query whose
     span outgrew the learned window included) against its plain edition
     and timed, as in phase 3; then, outside the counted paths, a small
     table with null actors and NaN goldstein (``attr_nulls_check``: IS
     [NOT] NULL, ``<>``, a literal the segment lacks) against numpy;
     config #5 ((n), (o), (p), every kNN call on ``device-topk``) and the
     polygon path (the lone star under auto and 0, (l) and (m) on
     ``device-batch-dual/bitmap``), each a path of its own, then their
     kernel phase: ``knn_topk`` at each k the path launched (k plus the
     certificate's margin; beside it ``torch.topk`` of the same distances,
     the selection alone) and ``poly_dual_bitmap`` at each shape (a q = 1
     refetch included where the data made one), as in phase 3; then the
     count path (every count equal to its numpy oracle and answered by
     ``count_scan``, timed sync), the stats path (bench_attr_bbox's
     parity) and the dual-attribute path ((a') and (l') on
     ``device-batch-dual/bitmap``, each query equal to its oracle), each a
     path of its own, then their kernel phase at every shape they
     launched that no earlier phase timed (``torch.bincount`` of the
     histogram's pre-masked codes timed beside ``exact_stat_hist``);
  4b. the concurrent phase, a path of its own: per stream a warm pass in
     each mode (hit counts checked), a timed pass in each (every answer's
     fid rows equal to the stream's oracle; wall, features/s as n x queries
     / wall, p50 / p99 by the threads' clocks, the routes, the group sizes,
     the coalescer's counters and each query's receipt), then the receipt
     probe: one admission slot held, a 100 ms window and
     ``geomesa.batch.max.queries`` = 8, one wave of 8 queries forming one
     group on the stacked route, whose members' receipts must sum exactly
     to the wave's device.d2h.bytes and device.h2d.bytes; then its kernel
     phase: each mask batch at each shape the phase launched, against its
     plain edition and timed, as in phase 3;
  4c. the pyramid phase, a path of its own (``pyramid_path``): the cold
     builds (build ms from the ``agg.build`` timer, ``agg.cache.builds``
     and ``pyramid_counts`` launches, more than 0), the counts in turns
     (on, off, on, off; each equal to its oracle, with its route and its
     interior and boundary rows), ``aggregate`` against numpy (count, min
     and max exact, the f64 sum to rtol 1e-12), stream (f)'s memo hits
     (each grid equal to the oracle) and the projection checks; then its
     kernel phase: ``pyramid_counts`` at each (bits, segment) it launched
     against ``pyramid_counts_plain`` (``torch.bincount`` of the flat cell
     ids timed as its library call), and the device counts of the turns
     with the cache off where no earlier phase timed their shape; after
     the path's launches are read, config #1's build at 8 and 12 bits split
     into its steps on host clocks around a synchronised device
     (``build_split``: the mask upload, kernel, grid fetch, int64 sum,
     levels, stats and uploads), whose launches no path counts;
  5. (after phase 8) every kernel must have launched during its path's
     run, at every shape that phase 3 timed, and every shape a path
     launched must be timed; the ranking, per kernel, sums launches x
     (ms - bound) over its shapes;
  6. the host-seek stream: config #1's 20 queries under
     ``GEOMESA_SEEK=auto`` (one sync query timed, the stream pipelined with
     fids unread and read), every query checked against brute force, its
     routes and its launches recorded; the chooser's cutoff swept
     (``seek_crossover``: four wider selectivities, each under the seek
     and the device route, checked against brute force, pipelined with
     fids unread and read); the native host libraries at the
     main path's shapes, each against its plain edition on the same
     inputs (equal results required) and timed: the decode of config #1's
     and stream (a)'s span windows, the z range walks of config #1's plans,
     the xz walks of config #3's plans, the seek scans of config #1's
     plans;
  7. torch.profiler traces of the config #1 stream and of stream (a): the
     host time of each step (the ``geomesa.*`` ranges of the store and
     executor, ``geomesa.ring`` for the per-geometry test) and the device's
     busy and idle shares; the rows per query the host tests after the
     device (the ring, or the candidates of the mask route); per density
     stream the same split (``geomesa.density``: launches + the grid's D2H
     copy; ``geomesa.band``: the host certification) and the band rows
     per query; the same trace of config #4's streams (j) and (k), of
     config #5's (n) and of its 16 points of (o) at k = 1000
     (``geomesa.dispatch``, ``fetch``, ``certify``, ``block_rows``,
     ``rerank``) and of the polygon stream (l), with the ring rows per
     query of (l) and (m);
  7b. the telemetry phase, a path of its own, on config #1's and config
     #3's tables before phase 8 mutates them: ``explain_analyze`` of config
     #1's device query and of stream (a)'s first query, each planned afresh
     and best of EXPLAIN_REPS by attribution (at least ATTRIBUTION_MIN of
     its wall in named stages, the stages ``query``, ``plan``, ``scan``,
     ``scan.block``, its hits equal to the oracle, rows scanned, its
     receipt equal to the link counters' delta of the call, its launches
     to the launch counter's, its fingerprint among the registry's rows);
     an ``InMemoryAuditWriter`` on config #1's 20-query ``query_many`` (one
     event a query, its bytes its receipt); the brownout ladder forced by
     injected ticks of the store's timeline sampler (a ``batch`` query
     shed at level 2, an interactive one and a count whose cold pyramid
     build defers equal to their oracles, then the exit, answers equal);
     config #1's stream pipelined and sync with plan telemetry and tenant
     metering at their defaults and off, TELEMETRY_ROUNDS alternating
     rounds, every answer the same size in every round and the first
     round's answers equal fid for fid;
  8. the lifecycle and fault phases, each a path of its own (their
     launches read with the counts reset just before). Their shapes are
     timed as entries of their own, tagged with the table's state: `` holes``
     (rows tombstoned: config #1's table after the deletes, the ways
     before the compaction), `` compacted`` (the ways rebuilt by
     ``compact``, 1% fewer rows) and `` labelled`` (the labelled table).
     ``lifecycle`` (config #1's deletes), ``ageoff`` (each answer the
     rows at or after one cut inside the clock's drift over the phase; its
     shapes are the lifecycle's holed ones), ``compaction`` (holed dual
     planes), ``compaction_mask`` (holed masks) and ``compacted``,
     ``labels`` (every answer equal to the numpy oracle of box AND label,
     the count and the density push-down declined), then ``faults``,
     ``faults_ways`` and ``faults_knn`` (every answer equal to the
     fault-free one, one ``degrade.device_to_host`` a fired fault, no
     launch while the breaker is open, the probe's receipt with the
     rebuilt mirror's host -> device bytes, the kNN's identical list on
     ``host-bbox``). The run fails if a degrade, a breaker opening or a
     kNN trip appears before the fault phase.

Prints a ``{"native": {...}}`` line (each host library's load status and
its host ms per call beside its plain edition's), a metrics line (with
``script_s``, the phases' seconds, and the flagged kernel entries), a
``{"kernels": [...]}`` line (one entry per kernel and shape), the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. Pipelined
times leave the fid gather out, as bench.py's do (it reads ``res.fids``
after its timed window); ``*_fids_read`` figures read every result's fids
inside the window.
"""

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import threading
import time

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM HBM bandwidth (NVIDIA data sheet). The kernels' work is mostly
# integer compares, so their operation ceiling is the card's INT32 rate:
# Hopper SMs issue 64 INT32 lane-operations per clock (the Hopper
# architecture whitepaper), times the SM count and the maximum SM clock this
# card reports (lane_ops_per_s); 132 SMs at 1980 MHz give 16.7e12 per second.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# float32 compares issue on the FP32 pipes: 128 lanes per SM per clock
FP32_LANES_PER_SM = 128

# config #1 stream length (bench.py's 20 queries) and residual stream length
REPS = 20
# the script's start, for the elapsed seconds of each log line
_T0 = time.perf_counter()
RESIDUAL_REPS = 8


# -- data and queries: copies of bench.py's synthesize / make_queries /
# brute_force (bench.py imports jax, so it is not imported here) -----------


def synthesize(n: int, seed: int = 13):
    """GDELT-ish: world-wide points clustered around hot spots + 40 days."""
    rng = np.random.default_rng(seed)
    k = n // 4
    x = np.concatenate(
        [
            rng.uniform(-180, 180, n - 3 * k),
            rng.normal(-77.0, 3.0, k),
            rng.normal(2.35, 3.0, k),
            rng.normal(116.4, 3.0, k),
        ]
    )
    y = np.concatenate(
        [
            rng.uniform(-90, 90, n - 3 * k),
            rng.normal(38.9, 2.0, k),
            rng.normal(48.85, 2.0, k),
            rng.normal(39.9, 2.0, k),
        ]
    )
    x = np.clip(x, -180.0, 180.0)
    y = np.clip(y, -90.0, 90.0)
    base = np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64)
    t = base + rng.integers(0, 40 * 86400_000, n)
    order = rng.permutation(n)
    return x[order], y[order], t[order]


BOX = (-80.0, 36.0, -70.0, 41.0)
T_LO = np.datetime64("2026-01-05T00:00:00", "ms").astype(np.int64)
T_HI = np.datetime64("2026-01-19T00:00:00", "ms").astype(np.int64)
DURING = "dtg DURING 2026-01-05T00:00:00Z/2026-01-19T00:00:00Z"


def jittered_boxes(reps: int, box=BOX, seed: int = 7):
    """The base box plus jittered variants (bench.py make_queries)."""
    rng = np.random.default_rng(seed)
    boxes = [box]
    for _ in range(reps - 1):
        dx = round(rng.uniform(-2.0, 2.0), 3)
        dy = round(rng.uniform(-1.0, 1.0), 3)
        boxes.append(
            (round(box[0] + dx, 3), round(box[1] + dy, 3),
             round(box[2] + dx, 3), round(box[3] + dy, 3))
        )
    return boxes


def bbox_cql(b) -> str:
    return f"bbox(geom, {b[0]!r}, {b[1]!r}, {b[2]!r}, {b[3]!r})"


def make_queries(reps: int):
    boxes = jittered_boxes(reps)
    return boxes, [f"{bbox_cql(b)} AND {DURING}" for b in boxes]


QUERY = make_queries(1)[1][0]
# the second box of the residual (OR) queries: around the Paris cluster
BOX_B = (0.0, 46.0, 5.0, 50.0)


def in_box(x, y, box):
    return (x >= box[0]) & (x <= box[2]) & (y >= box[1]) & (y <= box[3])


def brute_force(x, y, t, box=BOX):
    """The CPU reference: vectorized full-scan predicate (bench.py)."""
    return np.flatnonzero(in_box(x, y, box) & (t > T_LO) & (t < T_HI))


# -- config #3: OSM-way-shaped extents (bench_suite.py bench_xz2's table at
# its size, with lines, rotated polygons, rectangles and null geometries) --

WAYS_ROWS = 8_000_000
# bench_xz2's schema and one more column, the way's kind (line, polygon or
# rect), that the attribute edition of the dual plane reads (stream (a'))
WAYS_SPEC = "*geom:Geometry:srid=4326,dtg:Date,kind:String"
YEAR_LO = np.datetime64("2025-01-01T00:00:00", "ms").astype(np.int64)
YEAR_HI = np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64)
XZ2_BOX = (0.0, 0.0, 20.0, 15.0)  # bench_xz2's base box
WORLD = (-180.0, -90.0, 180.0, 90.0)
LINE, POLY, RECT, NULL = 0, 1, 2, -1
# the ways' kind column by kind + 1 (a null geometry's kind is null)
KIND_NAMES = np.array([None, "line", "polygon", "rect"], dtype=object)
WAYS_STREAM = 24  # bench_xz2's jittered stream
TRIANGLES = 4
XZ_RESIDUAL = 8


def synthesize_ways(n: int, seed: int = 66, bounds=WORLD, clusters: int = 64):
    """OSM-way-shaped features as flat numpy arrays: 70% LineStrings of 2-10
    vertices (a random walk whose extent runs 1e-3..5e-2 deg), 20% rotated
    polygons of 4-8 vertices (extent 1e-4..1e-2 deg), 10% axis-aligned
    rectangles, 0.1% null geometries; positions a mixture of ``clusters``
    Gaussian cities and a uniform background inside ``bounds``; dtg uniform
    ms over one year. Returns dict(kind int8[n], off int64[n+1], xy
    float64[V, 2], env float64[n, 4], dtg int64[n]); a feature's vertices
    are xy[off[i]:off[i+1]] (polygon rings closed, null rows empty)."""
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = bounds
    kind = rng.choice(np.array([LINE, POLY, RECT], dtype=np.int8), n, p=[0.7, 0.2, 0.1])
    kind[rng.random(n) < 0.001] = NULL
    centers = np.stack([rng.uniform(x0 + 2, x1 - 2, clusters),
                        rng.uniform(y0 + 2, y1 - 2, clusters)], axis=1)
    sigma = rng.uniform(0.3, 3.0, clusters)
    city = rng.random(n) < 0.7
    which = rng.integers(0, clusters, n)
    cx = np.where(city, centers[which, 0] + rng.normal(0, 1, n) * sigma[which],
                  rng.uniform(x0, x1, n))
    cy = np.where(city, centers[which, 1] + rng.normal(0, 1, n) * sigma[which],
                  rng.uniform(y0, y1, n))
    cx = np.clip(cx, x0 + 0.1, x1 - 0.1)
    cy = np.clip(cy, y0 + 0.1, y1 - 0.1)
    nv = np.zeros(n, dtype=np.int64)
    nv[kind == LINE] = rng.integers(2, 11, int((kind == LINE).sum()))
    nv[kind == POLY] = rng.integers(4, 9, int((kind == POLY).sum())) + 1  # closed
    nv[kind == RECT] = 5
    off = np.concatenate([[0], np.cumsum(nv)])
    feat = np.repeat(np.arange(n), nv)  # owner of each vertex
    j = np.arange(off[-1]) - off[feat]  # vertex index inside its feature
    k = nv[feat]
    ext = np.where(kind == LINE, np.exp(rng.uniform(np.log(1e-3), np.log(5e-2), n)),
                   np.exp(rng.uniform(np.log(1e-4), np.log(1e-2), n)))
    xy = np.empty((off[-1], 2))
    # lines: a random walk of k - 1 steps of ext / (k - 1)
    step = rng.uniform(0, 2 * np.pi, off[-1])
    length = (ext / np.maximum(nv - 1, 1))[feat]
    walk_x = np.where(j > 0, np.cos(step) * length, 0.0)
    walk_y = np.where(j > 0, np.sin(step) * length, 0.0)
    # cumulative sum restarted at every feature
    first = off[feat]  # each vertex's feature's first vertex
    wx = np.cumsum(walk_x)
    wy = np.cumsum(walk_y)
    wx -= wx[first]
    wy -= wy[first]
    # polygons: sorted angles on a circle of radius ext / 2, rotated, closed
    ang = np.where(j < k - 1, (j + rng.uniform(0.1, 0.9, off[-1])) * 2 * np.pi / np.maximum(k - 1, 1),
                   0.0) + rng.uniform(0, 2 * np.pi, n)[feat]
    ang = np.where(j == k - 1, ang[first], ang)  # close the ring
    px = np.cos(ang) * (ext / 2)[feat]
    py = np.sin(ang) * (ext / 2)[feat]
    # rectangles: (x0, y0) (x1, y0) (x1, y1) (x0, y1) (x0, y0)
    w = np.exp(rng.uniform(np.log(1e-4), np.log(1e-2), n))[feat]
    h = np.exp(rng.uniform(np.log(1e-4), np.log(1e-2), n))[feat]
    rx = np.where((j == 1) | (j == 2), w, 0.0)
    ry = np.where((j == 2) | (j == 3), h, 0.0)
    kv = kind[feat]
    xy[:, 0] = cx[feat] + np.where(kv == LINE, wx, np.where(kv == POLY, px, rx))
    xy[:, 1] = cy[feat] + np.where(kv == LINE, wy, np.where(kv == POLY, py, ry))
    env = np.zeros((n, 4))
    live = nv > 0
    starts = off[:-1][live]
    env[live, 0] = np.minimum.reduceat(xy[:, 0], starts)
    env[live, 1] = np.minimum.reduceat(xy[:, 1], starts)
    env[live, 2] = np.maximum.reduceat(xy[:, 0], starts)
    env[live, 3] = np.maximum.reduceat(xy[:, 1], starts)
    dtg = YEAR_LO + rng.integers(0, YEAR_HI - YEAR_LO, n)
    return {"kind": kind, "off": off, "xy": xy, "env": env, "dtg": dtg}


def ways_columns(ways, classes=None):
    """The store's ingest columns: one geometry OBJECT per row over views of
    the flat vertex array, with the envelope and isrect companions
    precomputed columnar (what bench_xz2 ingests), and the way's kind as a
    string (null for a null geometry). ``classes`` = (LineString, Polygon),
    the port's by default."""
    if classes is None:
        from geomesa_tpu_torch.geom.base import LineString, Polygon
    else:
        LineString, Polygon = classes
    kind, off, xy, env = ways["kind"], ways["off"], ways["xy"], ways["env"]
    n = len(kind)
    geoms = np.empty(n, dtype=object)
    for i, (k, a, b) in enumerate(zip(kind.tolist(), off[:-1].tolist(), off[1:].tolist())):
        if k == LINE:
            geoms[i] = LineString(xy[a:b])
        elif k != NULL:
            geoms[i] = Polygon(xy[a:b])
    fids = np.char.add("w", np.arange(n).astype(f"<U{len(str(n - 1))}"))
    return {
        "__fid__": fids, "geom": geoms, "dtg": ways["dtg"],
        "kind": KIND_NAMES[kind.astype(np.int64) + 1],
        "geom__bxmin": env[:, 0], "geom__bymin": env[:, 1],
        "geom__bxmax": env[:, 2], "geom__bymax": env[:, 3],
        "geom__isrect": (kind == RECT).astype(np.uint8),
    }


def xz2_boxes(reps: int = WAYS_STREAM, seed: int = 66, box=XZ2_BOX):
    """bench_xz2's jittered stream: the base box shifted +-10 deg."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(reps):
        dx, dy = rng.uniform(-10, 10, 2)
        out.append((box[0] + dx, box[1] + dy, box[2] + dx, box[3] + dy))
    return out


def xz_bbox_cql(b) -> str:
    return f"bbox(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"


def iso(ms: int) -> str:
    return str(np.datetime64(int(ms), "ms").astype("datetime64[s]")) + "Z"


def three_week_windows(reps: int, seed: int = 67):
    """(lo, hi) exclusive DURING bounds: three weeks at a whole second
    jittered inside the year."""
    rng = np.random.default_rng(seed)
    span = 21 * 86_400_000
    starts = YEAR_LO + rng.integers(0, (YEAR_HI - YEAR_LO - span) // 1000, reps) * 1000
    return [(int(s), int(s) + span) for s in starts]


def during_cql(w) -> str:
    return f"dtg DURING {iso(w[0])}/{iso(w[1])}"


def triangles(reps: int = TRIANGLES, seed: int = 69, box=XZ2_BOX, size: float = 3.0):
    """Non-rectangular query triangles (rect = false: every hit is ring)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(reps):
        cx = rng.uniform(box[0], box[2])
        cy = rng.uniform(box[1], box[3])
        out.append(np.array([[cx - size / 2, cy - size / 3], [cx + size / 2, cy - size / 2],
                             [cx + size / 5, cy + size / 2]]))
    return out


def triangle_cql(tri) -> str:
    ring = [*tri, tri[0]]
    return "INTERSECTS(geom, POLYGON((" + ", ".join(f"{x} {y}" for x, y in ring) + ")))"


def xz_streams(reps: int = WAYS_STREAM, tris: int = TRIANGLES, resid: int = XZ_RESIDUAL):
    """Streams (a)-(e) of config #3: name -> [(cql, oracle spec)]; a spec is
    (boxes OR-ed, triangle or None, DURING window or None)."""
    boxes = xz2_boxes(reps)
    wins = three_week_windows(reps)
    a_boxes = xz2_boxes(resid, seed=68)
    b_boxes = xz2_boxes(resid, seed=70, box=(25.0, 20.0, 35.0, 28.0))
    rwins = three_week_windows(resid, seed=71)
    tri = triangles(tris)
    return {
        "xz2_bbox": [(xz_bbox_cql(b), ([b], None, None)) for b in boxes],
        "xz3_bbox_during": [(f"{xz_bbox_cql(b)} AND {during_cql(w)}", ([b], None, w))
                            for b, w in zip(boxes, wins)],
        "xz2_triangle": [(triangle_cql(t), ([], t, None)) for t in tri],
        "xz2_or": [(f"{xz_bbox_cql(a)} OR {xz_bbox_cql(b)}", ([a, b], None, None))
                   for a, b in zip(a_boxes, b_boxes)],
        "xz3_or_during": [(f"({xz_bbox_cql(a)} OR {xz_bbox_cql(b)}) AND {during_cql(w)}",
                           ([a, b], None, w)) for a, b, w in zip(a_boxes, b_boxes, rwins)],
    }


# -- the numpy oracle of config #3 (independent of the port's geometry code)


def _vertex_rows(off, feats):
    """(feature position, vertex index) of every vertex of ``feats``."""
    nv = off[feats + 1] - off[feats]
    pos = np.repeat(np.arange(len(feats)), nv)
    first = np.repeat(np.cumsum(nv) - nv, nv)
    return pos, np.repeat(off[feats], nv) + np.arange(int(nv.sum())) - first


def _segments(off, feats):
    """(feature position, start vertex, end vertex) of every segment."""
    pos, v = _vertex_rows(off, feats)
    keep = v + 1 < np.repeat(off[feats + 1], off[feats + 1] - off[feats])
    return pos[keep], v[keep], v[keep] + 1


def _any_by(pos, flag, n):
    out = np.zeros(n, dtype=bool)
    out[pos[flag]] = True
    return out


def _segments_cross_box(p, q, box):
    """Liang-Barsky: does segment p->q meet the closed box?"""
    dx, dy = q[:, 0] - p[:, 0], q[:, 1] - p[:, 1]
    t0 = np.zeros(len(p))
    t1 = np.ones(len(p))
    ok = np.ones(len(p), dtype=bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        for pp, qq in ((-dx, p[:, 0] - box[0]), (dx, box[2] - p[:, 0]),
                       (-dy, p[:, 1] - box[1]), (dy, box[3] - p[:, 1])):
            r = qq / pp
            ok &= ~((pp == 0) & (qq < 0))
            t0 = np.where(pp < 0, np.maximum(t0, r), t0)
            t1 = np.where(pp > 0, np.minimum(t1, r), t1)
    return ok & (t0 <= t1)


def _orient(a, b, c):
    return np.sign((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
                   - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def _segments_cross(p, q, a, b):
    """Closed segment p->q against segment a->b (a, b one segment)."""
    a = np.broadcast_to(a, p.shape)
    b = np.broadcast_to(b, p.shape)
    o1, o2 = _orient(p, q, a), _orient(p, q, b)
    o3, o4 = _orient(a, b, p), _orient(a, b, q)

    def on(s, e, r):
        return ((np.minimum(s[:, 0], e[:, 0]) <= r[:, 0]) & (r[:, 0] <= np.maximum(s[:, 0], e[:, 0]))
                & (np.minimum(s[:, 1], e[:, 1]) <= r[:, 1]) & (r[:, 1] <= np.maximum(s[:, 1], e[:, 1])))

    return (((o1 != o2) & (o3 != o4)) | ((o1 == 0) & on(p, q, a)) | ((o2 == 0) & on(p, q, b))
            | ((o3 == 0) & on(a, b, p)) | ((o4 == 0) & on(a, b, q)))


def _point_in_rings(off, feats, pt, xy):
    """Even-odd test of one point against each feature's closed ring."""
    pos, s, e = _segments(off, feats)
    y1, y2 = xy[s, 1], xy[e, 1]
    x1, x2 = xy[s, 0], xy[e, 0]
    straddle = (y1 > pt[1]) != (y2 > pt[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x1 + (pt[1] - y1) * (x2 - x1) / (y2 - y1)
    cross = straddle & (pt[0] < xint)
    return (np.bincount(pos[cross], minlength=len(feats)) & 1) == 1


def oracle_rows(ways, boxes, tri=None, window=None) -> np.ndarray:
    """Rows whose geometry intersects any of ``boxes`` (or the triangle
    ``tri``), with the date inside the exclusive DURING ``window``."""
    kind, off, xy, env = ways["kind"], ways["off"], ways["xy"], ways["env"]
    live = kind != NULL
    if window is not None:
        live &= (ways["dtg"] > window[0]) & (ways["dtg"] < window[1])
    hit = np.zeros(len(kind), dtype=bool)
    shapes = [(b, None) for b in boxes] + ([] if tri is None else [(None, tri)])
    for box, t in shapes:
        qb = box if t is None else (t[:, 0].min(), t[:, 1].min(), t[:, 0].max(), t[:, 1].max())
        cand = np.flatnonzero(live & (env[:, 0] <= qb[2]) & (env[:, 2] >= qb[0])
                              & (env[:, 1] <= qb[3]) & (env[:, 3] >= qb[1]))
        if t is None:
            done = kind[cand] == RECT  # a rectangle meets the box iff its envelope does
            rest = cand[~done]
            pos, v = _vertex_rows(off, rest)
            px, py = xy[v, 0], xy[v, 1]
            got = _any_by(pos, (px >= box[0]) & (px <= box[2]) & (py >= box[1]) & (py <= box[3]),
                          len(rest))
            spos, s, e = _segments(off, rest)
            got |= _any_by(spos, _segments_cross_box(xy[s], xy[e], box), len(rest))
            polys = rest[(kind[rest] == POLY) & ~got]
            corner_in = _point_in_rings(off, polys, (box[0], box[1]), xy)
            hit[cand[done]] = True
            hit[rest[got]] = True
            hit[polys[corner_in]] = True
        else:
            pos, v = _vertex_rows(off, cand)
            o = [_orient(t[i], t[(i + 1) % 3], xy[v]) for i in range(3)]
            inside = ((o[0] >= 0) & (o[1] >= 0) & (o[2] >= 0)) | ((o[0] <= 0) & (o[1] <= 0) & (o[2] <= 0))
            got = _any_by(pos, inside, len(cand))
            spos, s, e = _segments(off, cand)
            for i in range(3):
                got |= _any_by(spos, _segments_cross(xy[s], xy[e], t[i], t[(i + 1) % 3]), len(cand))
            polys = cand[(kind[cand] != LINE) & ~got]
            got_poly = _point_in_rings(off, polys, t[0], xy)
            hit[cand[got]] = True
            hit[polys[got_poly]] = True
    return np.flatnonzero(hit)


# -- config #6 and the GDELT heatmap: density push-downs --------------------

DENS_ROWS = 8_000_000  # bench_suite.py bench_density's default size
DENS_SPEC = "*geom:Point:srid=4326"
DENS_BOX = (-60.0, -30.0, 60.0, 40.0)  # bench_density's box
DENS_STREAM = 16
DENS_WIDE = 4


def synthesize_dens(n: int):
    """bench_density's table: uniform points, x in (-180, 180), y in
    (-85, 85), from default_rng(12)."""
    rng = np.random.default_rng(12)
    return rng.uniform(-180, 180, n), rng.uniform(-85, 85, n)


def density_boxes(reps: int = DENS_STREAM, seed: int = 612):
    """bench_density's box, then boxes shifted by a seeded uniform +-5 deg
    in x and y."""
    rng = np.random.default_rng(seed)
    out = [DENS_BOX]
    for _ in range(reps - 1):
        dx, dy = (float(v) for v in rng.uniform(-5.0, 5.0, 2))
        out.append((DENS_BOX[0] + dx, DENS_BOX[1] + dy, DENS_BOX[2] + dx, DENS_BOX[3] + dy))
    return out


def density_hint(env, width, height):
    return {"density": {"envelope": tuple(env), "width": width, "height": height}}


def density_streams(full: bool = True):
    """Streams (f)-(i): name -> (type name, [(cql, box, during, (W, H))],
    expected route). The envelope of every query is its box. Stream (i)'s
    band overflows at config #1's full 20M rows and it must then take the
    host route (None); on a cut table either route ("any") may answer."""
    boxes = density_boxes()
    gdelt = jittered_boxes(REPS)
    return {
        "f_dens_256x128": ("dens", [(bbox_cql(b), b, False, (256, 128)) for b in boxes],
                           "device-density"),
        "g_dens_512x512": ("dens", [(bbox_cql(b), b, False, (512, 512))
                                    for b in boxes[:DENS_WIDE]], "device-density"),
        "h_gdelt_64x32": ("gdelt", [(f"{bbox_cql(b)} AND {DURING}", b, True, (64, 32))
                                    for b in gdelt], "device-density"),
        # its band (~19k rows) overflows the 8,192-row cap: the host reducer
        "i_gdelt_256x256": ("gdelt", [(QUERY, BOX, True, (256, 256))], None if full else "any"),
    }


def density_oracle(x, y, t, box, during: bool, width: int, height: int) -> np.ndarray:
    """The numpy f64 oracle of a density query whose envelope is its box:
    brute-force box (+ DURING) hits, GridSnap floor((v - min) / ((max - min)
    / n)) clipped into the grid, then a bincount."""
    m = in_box(x, y, box)
    if during:
        m &= (t > T_LO) & (t < T_HI)
    dx = (box[2] - box[0]) / width
    dy = (box[3] - box[1]) / height
    col = np.clip(np.floor((x[m] - box[0]) / dx).astype(np.int64), 0, width - 1)
    row = np.clip(np.floor((y[m] - box[1]) / dy).astype(np.int64), 0, height - 1)
    grid = np.bincount(row * width + col, minlength=width * height)
    return grid.reshape(height, width).astype(np.float64)


# -- config #4: the attribute planes (bench_suite.py bench_attr_bbox: GDELT
# points with an indexed actor1 and a goldstein score) -----------------------

ATTR_ROWS = 8_000_000  # bench_suite.py main()'s default size
ATTR_SPEC = "actor1:String:index=true,goldstein:Double,dtg:Date,*geom:Point:srid=4326"
ATTR_BOX = (-30.0, 0.0, 10.0, 30.0)  # bench_attr_bbox's box
ATTR_ACTORS = ("USA", "CHN", "RUS", "FRA", "BRA")
ATTR_STREAM = 24  # bench_attr_bbox's interleaved stream (j)
ATTR_DURING = "dtg DURING 2026-01-05T00:00:00Z/2026-01-12T00:00:00Z"
ATTR_T_LO = np.datetime64("2026-01-05T00:00:00", "ms").astype(np.int64)
ATTR_T_HI = np.datetime64("2026-01-12T00:00:00", "ms").astype(np.int64)
# stream (k): predicates reaching the other editions, each with the set of
# actors it selects on this table (member K = 4, notmember, vocabmask, the
# range edition through the LIKE prefix rule)
ATTR_OTHER = (
    ("actor1 IN ('USA', 'CHN', 'RUS')", ("USA", "CHN", "RUS")),
    ("actor1 IN ('FRA', 'BRA', 'XYZ')", ("FRA", "BRA")),
    ("actor1 <> 'USA' AND actor1 <> 'RUS'", ("CHN", "FRA", "BRA")),
    ("actor1 <> 'CHN'", ("USA", "RUS", "FRA", "BRA")),
    ("actor1 LIKE '%R%'", ("RUS", "FRA", "BRA")),
    ("actor1 ILIKE 'usa'", ("USA",)),
    ("actor1 LIKE 'U%'", ("USA",)),
    ("actor1 LIKE 'C%'", ("CHN",)),
)


def synthesize_attr(n: int):
    """bench_attr_bbox's table from default_rng(7): uniform points, 30 days
    of dtg, five actors (as objects, as the bench writes them) and goldstein
    rounded to 0.1. Returns the columns, the actors' indices (for the
    oracle) and the generator, whose next draws make stream (j)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-85, 85, n)
    base_ms = np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64)
    t = base_ms + rng.integers(0, 30 * 86400_000, n)
    who = rng.integers(0, 5, n)
    actors = np.array(ATTR_ACTORS, dtype=object)[who]
    gold = np.round(rng.uniform(-10, 10, n), 1)
    return {"x": x, "y": y, "t": t, "actors": actors, "who": who, "gold": gold}, rng


def attr_columns(data, fids):
    return {"__fid__": fids, "actor1": data["actors"], "goldstein": data["gold"],
            "geom__x": data["x"], "geom__y": data["y"], "dtg": data["t"]}


def attr_streams(rng, reps: int = ATTR_STREAM, seed: int = 71):
    """Streams (j) and (k) and the lone query: name -> [(cql, spec)], a spec
    being (box, actors or None, (lo, hi) goldstein bounds or None, during).
    (j) is bench_attr_bbox's: with ``rng`` its generator after the table,
    ``reps`` interleaved queries on jittered boxes, ``actor1 = X AND bbox``
    (the member edition) and ``goldstein > lo AND goldstein <= hi AND
    bbox`` (the range edition). (k) ANDs each ATTR_OTHER predicate with a
    box jittered from ``seed``, once alone (z2) and once with ATTR_DURING
    (z3)."""
    box = ATTR_BOX
    lone = f"actor1 = 'USA' AND {bbox_cql(box)}"
    j = []
    for k in range(reps):
        dx = round(float(rng.uniform(-5, 5)), 3)
        b = (box[0] + dx, box[1], box[2] + dx, box[3])
        if k % 2 == 0:
            actor = ["USA", "CHN", "RUS"][(k // 2) % 3]
            j.append((f"actor1 = '{actor}' AND {bbox_cql(b)}", (b, (actor,), None, False)))
        else:
            lo = round(float(rng.uniform(-8, 0)), 1)
            hi = round(lo + float(rng.uniform(2, 10)), 1)
            j.append((f"goldstein > {lo} AND goldstein <= {hi} AND {bbox_cql(b)}",
                      (b, None, (lo, hi), False)))
    jitter = np.random.default_rng(seed)
    k = []
    for during in (False, True):
        for pred, actors in ATTR_OTHER:
            dx, dy = (round(float(v), 3) for v in jitter.uniform(-5, 5, 2))
            b = (box[0] + dx, box[1] + dy, box[2] + dx, box[3] + dy)
            cql = f"{pred} AND {bbox_cql(b)}" + (f" AND {ATTR_DURING}" if during else "")
            k.append((cql, (b, actors, None, during)))
    return {"lone": [(lone, (box, ("USA",), None, False))], "j": j, "k": k}


def attr_oracle(data, spec) -> np.ndarray:
    """Rows of one config #4 query by numpy brute force over the
    generator's arrays (no code shared with the port)."""
    box, actors, gold, during = spec
    m = in_box(data["x"], data["y"], box)
    if actors is not None:
        m &= np.isin(data["who"], [ATTR_ACTORS.index(a) for a in actors])
    if gold is not None:
        m &= (data["gold"] > gold[0]) & (data["gold"] <= gold[1])
    if during:
        m &= (data["t"] > ATTR_T_LO) & (data["t"] < ATTR_T_HI)
    return np.flatnonzero(m)


def attr_null_table(n: int, seed: int = 41):
    """A small table of ATTR_SPEC with null actors (every 7th row) and NaN
    goldstein (every 11th): (data, columns of fids "n<row>")."""
    rng = np.random.default_rng(seed)
    data = {"x": rng.uniform(-60, 60, n), "y": rng.uniform(-40, 40, n),
            "t": np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64)
            + rng.integers(0, 30 * 86400_000, n),
            "who": rng.integers(0, 5, n), "gold": np.round(rng.uniform(-10, 10, n), 1)}
    data["who"][::7] = -1
    data["gold"][::11] = np.nan
    actors = np.array(ATTR_ACTORS, dtype=object)[data["who"]]
    actors[data["who"] < 0] = None
    data["actors"] = actors
    return data, attr_columns(data, np.char.add("n", np.arange(n).astype(str)))


# attr_null_table's queries: predicate -> (oracle over (who, gold), whether
# the plan takes the device plane under GEOMESA_SEEK=0). 'ZZZ' is a literal
# the segment lacks: alone its sketch estimate (0 rows) plans it on
# attr:actor1, the host's; in an IN list it is the code -2 on the device.
ATTR_NULL_QUERIES = {
    "goldstein IS NULL": (lambda who, gold: np.isnan(gold), True),
    "goldstein IS NOT NULL": (lambda who, gold: ~np.isnan(gold), True),
    "actor1 <> 'USA'": (lambda who, gold: (who >= 0) & (who != 0), True),
    "actor1 IN ('ZZZ', 'RUS')": (lambda who, gold: who == 2, True),
    "actor1 = 'ZZZ'": (lambda who, gold: np.zeros(len(who), dtype=bool), False),
}
ATTR_NULL_BOX = (-10.0, -10.0, 10.0, 10.0)


def attr_null_queries():
    return [f"{pred} AND {bbox_cql(ATTR_NULL_BOX)}" for pred in ATTR_NULL_QUERIES]


def attr_null_oracle(data, cql: str) -> np.ndarray:
    """Rows of ``<pred> AND bbox(ATTR_NULL_BOX)`` on attr_null_table."""
    pred = cql.split(" AND bbox", 1)[0]
    m = ATTR_NULL_QUERIES[pred][0](data["who"], data["gold"])
    return np.flatnonzero(m & in_box(data["x"], data["y"], ATTR_NULL_BOX))


# -- config #5 (kNN, TubeSelect) and the polygon plane: copies of bench_suite.py
# bench_knn's and bench_poly's generators and oracles ----------------------

KNN_ROWS = 8_000_000  # bench_suite.py main()'s default size
KNN_SPEC = "dtg:Date,*geom:Point:srid=4326"
KNN_TABLE = "knn"
KNN_QUERY = (2.35, 48.85)  # bench_knn's query point and k
KNN_K = 10
KNN_REPS = 10
KNN_KS = (1, 10, 1000)
EARTH_RADIUS_M = 6371008.8
TUBE_BUFFERS = ((1000.0, 600_000), (50_000.0, 86_400_000))  # the default, then wide
POLY_ROWS = 8_000_000
POLY_SPEC = "*geom:Point:srid=4326"
POLY_TABLE = "poly"
POLY_STREAM = 24  # bench_poly's jittered stream (l)
POLY_TIMED = 8  # stream (m): stars AND a 7-day DURING on config #5's table
POLY_DURING = "dtg DURING 2026-01-08T00:00:00Z/2026-01-15T00:00:00Z"
POLY_T_LO = np.datetime64("2026-01-08T00:00:00", "ms").astype(np.int64)
POLY_T_HI = np.datetime64("2026-01-15T00:00:00", "ms").astype(np.int64)


def synthesize_knn(n: int):
    """bench_knn's table from default_rng(8): uniform points and 30 days."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-85, 85, n)
    base_ms = np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64)
    t = base_ms + rng.integers(0, 30 * 86400_000, n)
    return x, y, t


def knn_points(k: int = 16, seed: int = 81):
    """Stream (o)'s query points: bench_knn's, one at lon 179.95 (the
    antimeridian), one at lat 84 (the polar cap), the rest uniform."""
    rng = np.random.default_rng(seed)
    pts = [KNN_QUERY, (179.95, float(rng.uniform(-60, 60))), (float(rng.uniform(-180, 180)), 84.0)]
    while len(pts) < k:
        pts.append((float(rng.uniform(-180, 180)), float(rng.uniform(-85, 85))))
    return pts


def haversine_np(lon1, lat1, lon2, lat2) -> np.ndarray:
    """f64 great-circle metres on the WGS84 mean sphere."""
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(v, dtype=np.float64))
                              for v in (lon1, lat1, lon2, lat2))
    a = np.sin((lat2 - lat1) / 2) ** 2 + \
        np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.minimum(1.0, np.sqrt(a)))


def knn_oracle(d: np.ndarray, k: int, max_radius_m: float = 2_000_000.0):
    """[(fid, metres)] of the k nearest rows by f64 brute force over the
    rows' distances ``d`` (``haversine_np``), ascending (equal distances by
    row), none beyond ``max_radius_m`` (knn_search's default)."""
    kth = np.partition(d, k - 1)[k - 1]
    cand = np.flatnonzero(d <= kth)
    order = cand[np.lexsort((cand, d[cand]))][:k]
    return [(f"f{i}", float(d[i])) for i in order if d[i] <= max_radius_m]


def tube_track(t0: int, seed: int = 82):
    """Stream (p)'s track: 8 samples over a day, ~25 km apart."""
    rng = np.random.default_rng(seed)
    x0, y0 = float(rng.uniform(-60, 60)), float(rng.uniform(-40, 40))
    return [(x0 + 0.25 * i, y0 + 0.1 * i, t0 + i * 3 * 3600_000) for i in range(8)]


def tube_oracle(x, y, t, track, buffer_m: float, time_buffer_ms: int) -> np.ndarray:
    """Rows within ``buffer_m`` of a sample of the track resampled to gaps
    of at most 2 ``buffer_m`` (TubeBuilder's interpolated gaps) and within
    ``time_buffer_ms`` of its time."""
    gap = max(buffer_m * 2, 1.0)
    samples = [track[0]]
    for (x0, y0, t0), (x1, y1, t1) in zip(track, track[1:]):
        steps = max(1, int(np.ceil(float(haversine_np(x0, y0, x1, y1)) / gap)))
        for s in range(1, steps + 1):
            f = s / steps
            samples.append((x0 + (x1 - x0) * f, y0 + (y1 - y0) * f, t0 + (t1 - t0) * f))
    keep = np.zeros(len(x), dtype=bool)
    for sx, sy, st in samples:
        near = np.abs(t.astype(np.float64) - st) <= time_buffer_ms
        idx = np.flatnonzero(near)
        keep[idx[haversine_np(x[idx], y[idx], sx, sy) <= buffer_m]] = True
    return np.flatnonzero(keep)


def synthesize_poly(n: int):
    """bench_poly's table from default_rng(9): uniform points."""
    rng = np.random.default_rng(9)
    return rng.uniform(-180, 180, n), rng.uniform(-85, 85, n)


def star(cx: float, cy: float, r: float) -> np.ndarray:
    """bench_poly's 12-point star, a closed ring, snapped to its WKT text."""
    ang = np.linspace(0, 2 * np.pi, 13)[:-1]
    rad = np.where(np.arange(12) % 2 == 0, r, 0.45 * r)
    pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], axis=1)
    return snapped(np.vstack([pts, pts[:1]]))


def ring_wkt(ring) -> str:
    return "(" + ", ".join(f"{a:.6f} {b:.6f}" for a, b in ring) + ")"


def snapped(ring) -> np.ndarray:
    """The ring's vertices as its WKT text (``ring_wkt``) gives them, so
    that the oracle tests the polygon the query carries."""
    return np.array([[float(f"{a:.6f}"), float(f"{b:.6f}")] for a, b in ring])


def pip(rings, px, py) -> np.ndarray:
    """bench_poly's f64 even-odd test over every ring (shells and holes of
    one polygon or of disjoint members), rows outside the rings' envelope
    left out first."""
    allpts = np.concatenate(rings)
    lo, hi = allpts.min(0), allpts.max(0)
    idx = np.flatnonzero((px >= lo[0]) & (px <= hi[0]) & (py >= lo[1]) & (py <= hi[1]))
    qx, qy = px[idx], py[idx]
    inside = np.zeros(len(idx), bool)
    for ring in rings:
        for (x1, y1), (x2, y2) in zip(ring[:-1], ring[1:]):
            cond = (y1 > qy) != (y2 > qy)
            if y1 != y2:
                xint = x1 + (qy - y1) * (x2 - x1) / (y2 - y1)
                inside ^= cond & (qx < xint)
    return idx[inside]


def poly_streams():
    """The polygon queries: name -> [(cql, rings)]. "lone" is bench_poly's
    star; (l) its 24 jittered stars (default_rng(99), +-6 deg); (m) 8 more
    jittered stars (default_rng(98)) AND POLY_DURING, on config #5's table,
    the third with a hole (a reversed star at 40% of the size) and the
    sixth a MultiPolygon of two disjoint stars."""
    lone = star(2.0, 10.0, 14.0)
    out = {"lone": [(f"intersects(geom, POLYGON ({ring_wkt(lone)}))", [lone])]}
    jit = np.random.default_rng(99)
    out["l"] = []
    for _ in range(POLY_STREAM):
        dx, dy = jit.uniform(-6, 6, 2)
        ring = star(2.0 + dx, 10.0 + dy, 14.0)
        out["l"].append((f"intersects(geom, POLYGON ({ring_wkt(ring)}))", [ring]))
    jit = np.random.default_rng(98)
    out["m"] = []
    for i in range(POLY_TIMED):
        dx, dy = jit.uniform(-6, 6, 2)
        ring = star(2.0 + dx, 10.0 + dy, 14.0)
        if i == 2:
            hole = star(2.0 + dx, 10.0 + dy, 5.6)[::-1]
            rings, geom = [ring, hole], f"POLYGON ({ring_wkt(ring)}, {ring_wkt(hole)})"
        elif i == 5:
            other = star(40.0 + dx, -20.0 + dy, 8.0)
            rings = [ring, other]
            geom = f"MULTIPOLYGON (({ring_wkt(ring)}), ({ring_wkt(other)}))"
        else:
            rings, geom = [ring], f"POLYGON ({ring_wkt(ring)})"
        out["m"].append((f"intersects(geom, {geom}) AND {POLY_DURING}", rings))
    return out


def poly_oracle(x, y, t, rings, timed: bool) -> np.ndarray:
    rows = pip(rings, x, y)
    if timed:
        rows = rows[(t[rows] > POLY_T_LO) & (t[rows] < POLY_T_HI)]
    return rows


# -- helpers ----------------------------------------------------------------


def log(msg: str) -> None:
    sys.stderr.write(f"[chip_smoke +{time.perf_counter() - _T0:.1f}s] {msg}\n")
    sys.stderr.flush()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def lane_ops_per_s(lanes_per_sm: int) -> float:
    """Per-lane instructions per second of the card: SM count x lanes per
    SM per clock x the maximum SM clock this card reports."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * lanes_per_sm * mhz * 1e6


def event_ms(fn, reps: int, warmup: int = 3) -> float:
    """Time per call of ``fn`` in ms: CUDA events around ``reps``
    back-to-back calls, no synchronise between them, over ``reps``. With
    a hand kernel's wrapper this is the wrapper's cost: the card waits for
    whatever the host does before each launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# profiler windows a kernel is read in, and the spread between them past
# which its entry is flagged
PROFILE_WINDOWS = 2
WINDOW_SPREAD = 0.05


def profiled_ms(fn, symbol: str, reps: int, per_call=None):
    """(ms, launches seen, pass_ms) of one torch.profiler window over
    ``reps`` calls of ``fn``: the CUDA time of the kernels whose name holds
    ``symbol``, over the calls their events cover: ``per_call`` kernels a
    call (a launcher that runs a data-dependent number of passes), or else
    the events of the kernel seen most often (each of the launcher's
    kernels runs once a call); ``pass_ms`` splits it by kernel (its name
    and template arguments). (None, 0, {}) when the window shows no device
    time for it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.key
            and e.self_device_time_total]
    seen = sum(e.count for e in hits)
    if not seen:
        return None, 0, {}
    calls = seen / per_call if per_call else max(e.count for e in hits)
    pass_ms = {}
    for e in hits:
        m = re.search(r"(\w+_kernel)(<[^>(]*>)?", e.key)
        name = m.group(0) if m else e.key[:80]
        pass_ms[name] = pass_ms.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    return sum(pass_ms.values()), seen, pass_ms


def kernel_ms(fn, symbol: str, reps: int = 50, per_call=None):
    """(ms, call_ms, launches seen, source, pass_ms, windows) of a hand
    kernel: ``call_ms`` from ``event_ms``; ``ms`` is the kernel's own
    device time per call of ``fn``, read in PROFILE_WINDOWS profiler
    windows of ``reps`` calls each (``profiled_ms``) and the larger reading
    kept, since the card's trace shortens and drops events but never
    lengthens them; ``windows`` lists every reading. Where no window shows
    device time for it, ``ms`` is ``call_ms`` and the source says
    "events"."""
    call_ms = event_ms(fn, reps)
    windows, best = [], (None, 0, {})
    for _ in range(PROFILE_WINDOWS):
        got = profiled_ms(fn, symbol, reps, per_call)
        windows.append(got[0])
        if got[0] is not None and (best[0] is None or got[0] > best[0]):
            best = got
    ms, seen, pass_ms = best
    if ms is None:
        return call_ms, call_ms, 0, "events", {}, windows
    return ms, call_ms, seen, "profiler", pass_ms, windows


def max_abs_err(got, want) -> int:
    return max(
        int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()) if g.numel() else 0
        for g, w in zip(got, want)
    )


def expect_fids(res, want_rows, what: str, prefix: str = "f") -> None:
    """The result's fids are exactly ``prefix<row>`` of ``want_rows``, each
    once: compared as row numbers read from the code points
    (``fid_rows``) where the fids are fixed-width unicode with that
    one-character prefix, else as sets of strings."""
    fids = np.asarray(res.fids)
    want = np.unique(np.asarray(want_rows, dtype=np.int64))
    if fids.dtype.kind == "U" and len(prefix) == 1 and len(fids):
        cps = np.ascontiguousarray(fids).view(np.uint32).reshape(len(fids), -1)
        if (cps[:, 0] == ord(prefix)).all():
            got = fid_rows(fids)
            if len(got) != len(want) or not np.array_equal(got, want):
                raise AssertionError(f"{what}: fid-set parity failed ({len(got)} device vs "
                                     f"{len(want)} brute force)")
            return
    got = set(fids.tolist())
    if len(got) != len(fids) or got != {f"{prefix}{i}" for i in want}:
        raise AssertionError(
            f"{what}: fid-set parity failed ({len(got)} device vs {len(want)} brute force)"
        )


def fid_rows(fids: np.ndarray) -> np.ndarray:
    """Sorted row numbers of fids "f<row>" (a fixed-width unicode array),
    read from the code points, for result sets too large for a set of
    strings."""
    a = np.ascontiguousarray(fids)
    width = a.dtype.itemsize // 4
    c = a.view(np.uint32).reshape(-1, width)[:, 1:].astype(np.int64)
    digit = c > 0
    power = digit.sum(1)[:, None] - 1 - np.arange(width - 1)[None, :]
    val = (np.where(digit, c - 48, 0) * 10 ** np.clip(power, 0, None)).sum(1)
    return np.sort(val)


# -- phases -----------------------------------------------------------------


# rows of one warp chunk of csrc/exact_bitmap.cu (kR = 8 words of 32 rows)
EXACT_CHUNK_ROWS = 256


def envelope_skip_share(xk, yk, tk, boxes, wins) -> float:
    """Share of (chunk, query) pairs whose chunk envelope (the int64 min and
    max of each key over EXACT_CHUNK_ROWS consecutive rows, invalid rows
    included) misses the query's box or window: the pairs the chunk reject
    of ``exact_bitmap`` skips where it runs."""
    cols = [(xk, boxes[:, 0], boxes[:, 1]), (yk, boxes[:, 2], boxes[:, 3])]
    if wins is not None:
        cols.append((tk, wins[:, 0], wins[:, 1]))
    miss = None
    for col, lo, hi in cols:
        chunks = col.view(-1, EXACT_CHUNK_ROWS)
        m = (chunks.amax(1)[None, :] < lo[:, None]) | (chunks.amin(1)[None, :] > hi[:, None])
        miss = m if miss is None else miss | m
    return float(miss.float().mean())


def exact_bitmap_caller_header(xk, yk, tk, valid, boxes, wins):
    """The ``exact_bitmap`` library called as a design whose launcher left
    the header to its caller was: the header preset to (0, n, -1), the
    empty rule applied after the launch. A launcher that initialises and
    decodes the header itself overwrites the preset, so any design runs
    through this (for ``--ab``)."""
    from geomesa_tpu_torch.ops import kernels

    n, q = xk.shape[0], boxes.shape[0]
    has_time = wins is not None
    bits = torch.empty((q, n // 8), dtype=torch.uint8, device=xk.device)
    buf = torch.empty(3 * q + 1, dtype=torch.int32, device=xk.device)
    hdr = buf[:3 * q].view(q, 3)
    hdr[:, 0] = 0
    hdr[:, 1] = n
    hdr[:, 2] = -1
    err = kernels._lib("exact_bitmap").exact_bitmap(
        int(has_time), xk.data_ptr(), yk.data_ptr(), tk.data_ptr() if has_time else None,
        valid.data_ptr(), boxes.data_ptr(), wins.data_ptr() if has_time else None, q,
        0, None, None, 0, bits.data_ptr(), buf.data_ptr(), n, kernels._stream(xk.device))
    if err:
        raise RuntimeError(f"exact_bitmap launch failed: CUDA error {err}")
    empty = hdr[:, 0] == 0
    hdr[:, 1] = torch.where(empty, 0, hdr[:, 1])
    hdr[:, 2] = torch.where(empty, n - 1, hdr[:, 2])
    return bits, hdr


# per-row instructions of the attribute test (point_cases's rule: an int32
# compare is one): member K compares, notmember K + 1, range 2, vocabmask
# the null test and the lookup
ATTR_TEST_OPS = {"member": lambda k: k, "notmember": lambda k: k + 1,
                 "range": lambda k: 2, "vocabmask": lambda k: 2}


def exact_case(name, seg, boxes, wins, path, plane=None, mask=False):
    """One ``exact_bitmap`` shape: q = the descriptors given; ``plane`` =
    (codes, qcodes, edition) adds the attribute test; ``mask`` times the
    coalescer's ``exact_mask_batch`` (the same kernel, its bits alone)
    against its own plain edition instead.

    Bound: a floor for any exact implementation on this run's data. Bytes:
    the key columns and valid read once, the bits written once; with the
    attribute test, the 4 B code of every row of a 32-row word where the
    box test of some query holds a row (no other code can change a bit)
    and the queries' vectors (the lookup tables of vocabmask). Operations
    by ``point_cases``'s rule, counted from the plain edition's box-only
    bits (not from the kernel's path): every 32-row word of every query
    needs its ballot and its store (2 per row and query); only a word that
    holds a box hit of the query needs the compare chain, 6 int64 compares
    (12) per row with the window, 4 (8) without, and the attribute test
    (``ATTR_TEST_OPS``) per row. A word with no box hit can be decided
    without it (a chunk reject does exactly that)."""
    from geomesa_tpu_torch.ops import kernels

    n, q = seg.n_padded, boxes.shape[0]
    xk, yk, tk, valid = seg._exact_cols(wins is not None)
    codes, qcodes, kind = plane if plane is not None else (None, None, None)
    key = 8 * (3 if wins is not None else 2)
    box_bits = kernels.exact_bitmap_plain(xk, yk, tk, valid, boxes, wins)[0]
    box_words = box_bits.view(q, n // 32, 4) != 0
    hit_words = int(box_words.any(-1).sum())
    chain = 2 * (6 if wins is not None else 4)
    extra = {"hit_words": hit_words}
    attr_bytes = attr_ops = 0
    if plane is not None:
        code_words = int(box_words.any(-1).any(0).sum())
        attr_bytes = 4 * 32 * code_words + qcodes.numel() * qcodes.element_size()
        attr_ops = ATTR_TEST_OPS[kind](qcodes.shape[1])
        extra["code_words"] = code_words
    skip = envelope_skip_share(xk, yk, tk, boxes, wins)
    extra["envelope_skip_share"] = skip
    tag = f"q={q}" + ("" if kind in (None, "range") else
                      f" U={qcodes.shape[1]}" if kind == "vocabmask" else f" K={qcodes.shape[1]}")
    if mask:
        kernel = lambda: (kernels.exact_mask_batch(  # noqa: E731
            xk, yk, tk, valid, boxes, wins, codes, qcodes, kind),)
        plain = lambda: (kernels.exact_mask_batch_plain(  # noqa: E731
            xk, yk, tk, valid, boxes, wins, codes, qcodes, kind),)
    else:
        kernel = lambda: kernels.exact_bitmap(  # noqa: E731
            xk, yk, tk, valid, boxes, wins, codes, qcodes, kind)
        plain = lambda: kernels.exact_bitmap_plain(  # noqa: E731
            xk, yk, tk, valid, boxes, wins, codes, qcodes, kind)
    return dict(
        name=name,
        path=path,
        tag=tag,
        symbol="exact_bitmap_kernel",
        replaces="geomesa_tpu/parallel/executor.py:" + ("495" if mask else "840"),
        source="geomesa_tpu_torch/csrc/exact_bitmap.cu",
        kernel=kernel,
        plain=plain,
        ab_kernel=lambda: exact_bitmap_caller_header(xk, yk, tk, valid, boxes, wins),
        # an earlier design has no attribute editions (nor mask batches) to
        # time in turns
        no_ab=plane is not None or mask,
        bytes=n * (key + 1) + q * n // 8 + q * (2 * key + 12) + attr_bytes,
        ops=q * n * 2 + 32 * hit_words * (chain + attr_ops),
        extra=extra,
        shape=f"rows={n} q={q} hit_words={hit_words} envelope_skip={skip:.4f}"
              + (" time" if wins is not None else "") + (f" {kind} {tag}" if plane else ""),
    )


def point_cases(store, plans):
    """The config #1 kernels on the z3/z2 segments' own columns with the
    main path's descriptors, ``exact_bitmap`` at each q its path launches:
    q = 1 (a lone query: the first of its stream) and the stream's batch.

    Operation counts are per-lane instructions, counted from the source
    with one rule for every exact kernel: an int32 compare is one
    instruction, an int64 compare two (a compare of each half; the ANDs
    between compares chain into the predicates and are not counted), and
    each bitmap plane adds per 32 rows and query one ballot and one store,
    warp instructions that take the issue slot of all 32 rows (one each per
    row and query)."""
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.filters import z2_query_mask, z3_query_mask

    ex = store.executor
    tables = store._tables["gdelt"]
    seg3 = ex.device_index(tables["z3"]).segments[0]
    seg2 = ex.device_index(tables["z2"]).segments[0]
    dev = ex.device

    boxes3, wins3 = ex._query_descriptor(tables["z3"], plans["resid_z3"])
    boxes2, _ = ex._query_descriptor(tables["z2"], plans["resid_z2"])
    ex_descs = [ex._exact_descriptor(tables["z3"], p) for p in plans["config1"]]
    bx_descs = [ex._exact_descriptor(tables["z2"], p) for p in plans["bbox"]]
    ebox3 = torch.as_tensor(np.stack([d[0] for d in ex_descs]), device=dev)
    ewin3 = torch.as_tensor(np.stack([d[1] for d in ex_descs]), device=dev)
    ebox2 = torch.as_tensor(np.stack([d[0] for d in bx_descs]), device=dev)

    n3, n2 = seg3.n_padded, seg2.n_padded
    k3, w3, k2 = boxes3.shape[0], wins3.shape[0], boxes2.shape[0]
    return [
        dict(
            name="candidate_mask_z3",
            path="config1",
            tag=f"K={k3} W={w3}",
            symbol="candidate_mask_kernel",
            replaces="geomesa_tpu/ops/pallas_kernels.py:84",
            source="geomesa_tpu_torch/csrc/candidate_mask.cu",
            kernel=lambda: (kernels.candidate_mask(
                seg3.xi, seg3.yi, seg3.valid, boxes3, seg3.bins, seg3.ti, wins3),),
            plain=lambda: (z3_query_mask(
                seg3.xi, seg3.yi, seg3.bins, seg3.ti, seg3.valid, boxes3, wins3),),
            bytes=n3 * (4 * 4 + 1) + n3,
            # 4 compares + 1 OR per box, 3 compares + 1 OR per window, 2 ANDs
            ops=n3 * (5 * k3 + 4 * w3 + 2),
            shape=f"rows={n3} K={k3} W={w3}",
        ),
        dict(
            name="candidate_mask_z2",
            path="config1",
            tag=f"K={k2} W=0",
            symbol="candidate_mask_kernel",
            replaces="geomesa_tpu/ops/pallas_kernels.py:91",
            source="geomesa_tpu_torch/csrc/candidate_mask.cu",
            kernel=lambda: (kernels.candidate_mask(seg2.xi, seg2.yi, seg2.valid, boxes2),),
            plain=lambda: (z2_query_mask(seg2.xi, seg2.yi, seg2.valid, boxes2),),
            bytes=n2 * (2 * 4 + 1) + n2,
            ops=n2 * (5 * k2 + 1),
            shape=f"rows={n2} K={k2}",
        ),
        exact_case("exact_bitmap_z3", seg3, ebox3[:1], ewin3[:1], "config1"),
        exact_case("exact_bitmap_z3", seg3, ebox3, ewin3, "config1"),
        exact_case("exact_bitmap_z2", seg2, ebox2[:1], None, "config1"),
        exact_case("exact_bitmap_z2", seg2, ebox2, None, "config1"),
    ]


def _attr_tag(kind, qcodes) -> str:
    """The shape tag suffix of an attribute plane's vectors."""
    if kind in (None, "range"):
        return ""
    return f" U={qcodes.shape[1]}" if kind == "vocabmask" else f" K={qcodes.shape[1]}"


def dual_case(name, seg, descs, has_time, path, plane=None, mask=False):
    """One ``xz_dual_bitmap`` shape: q = the descriptors given; ``plane`` =
    (codes, qcodes, edition) adds the attribute test; ``mask`` times the
    coalescer's ``dual_mask_batch("xz")`` (the same kernel, its planes
    alone) against its own plain edition instead. Operations by
    ``point_cases``'s rule, counted as this run's data needs them: per row
    and query the overlap test, 4 int64 compares (6 with the window), two
    instructions each, plus the hit plane's ballot and store and the
    decided plane's store, 3; the inside test (4 int64 compares) and the
    decided ballot, 9, only per hit row of a rectangle query (the decided
    plane is 0 wherever no row hits); plus 8 per row for the hoisted
    placeholder test (4 int64 equalities). The attribute test adds its
    ``ATTR_TEST_OPS`` per row of a 32-row word that holds an envelope hit
    of the query, and the bytes of the codes of the words where some
    query's envelope test hits, and of the queries' vectors."""
    from geomesa_tpu_torch.ops import kernels

    cols = seg._xz_cols(has_time)
    n, q = seg.n_padded, descs.shape[0]
    codes, qcodes, kind = plane if plane is not None else (None, None, None)
    box_hit, _dec, hdr = kernels.xz_dual_bitmap_plain(*cols[:6], descs, cols[6])
    rect_hits = int(hdr[:, 0][descs[:, 5] != 0].sum())
    attr_bytes = attr_ops = 0
    extra = {}
    if plane is not None:
        words = box_hit.view(q, n // 32, 4) != 0
        hit_words = words.any(-1)
        code_words = int(hit_words.any(0).sum())
        attr_bytes = 4 * 32 * code_words + qcodes.numel() * qcodes.element_size()
        attr_ops = 32 * int(hit_words.sum()) * ATTR_TEST_OPS[kind](qcodes.shape[1])
        extra = {"code_words": code_words}
    if mask:
        kernel = lambda: kernels.dual_mask_batch(  # noqa: E731
            "xz", *cols[:6], descs, cols[6], codes, qcodes, kind)
        plain = lambda: kernels.dual_mask_batch_plain(  # noqa: E731
            "xz", *cols[:6], descs, cols[6], codes, qcodes, kind)
    else:
        kernel = lambda: kernels.xz_dual_bitmap(  # noqa: E731
            *cols[:6], descs, cols[6], codes, qcodes, kind)
        plain = lambda: kernels.xz_dual_bitmap_plain(  # noqa: E731
            *cols[:6], descs, cols[6], codes, qcodes, kind)
    return dict(
        name=name,
        path=path,
        tag=f"q={q}{_attr_tag(kind, qcodes)}",
        symbol="xz_dual_bitmap_kernel",
        replaces="geomesa_tpu/parallel/executor.py:" + ("569" if mask else "1748"),
        source="geomesa_tpu_torch/csrc/xz_dual_bitmap.cu",
        kernel=kernel,
        plain=plain,
        no_ab=plane is not None or mask,
        bytes=n * ((5 if has_time else 4) * 8 + 2) + 2 * q * n // 8 + q * (64 + 12) + attr_bytes,
        ops=q * n * (2 * (6 if has_time else 4) + 3) + rect_hits * (2 * 4 + 1) + n * 2 * 4
            + attr_ops,
        extra=extra,
        shape=f"rows={n} q={q} rect_hits={rect_hits}" + (" time" if has_time else "")
              + (f" {kind}{_attr_tag(kind, qcodes)}" if plane is not None else ""),
    )


def xz_cases(store, plans):
    """The config #3 kernels on the xz3/xz2 segments' own columns with the
    main path's descriptors: the masks with the first residual query's
    boxes and windows; ``xz_dual_bitmap`` at each q its path launches: q =
    1 (a lone query, the first of stream (a) or (b)), the bbox streams as
    one batch each (q = 24) and, for xz2, the triangle stream (c) (q = 4).

    Operations: ``xz_mask`` does 4 float32 compares per box and row
    (counted at the card's FP32 rate) plus 1 OR per box, 3 int32 compares
    and 1 OR per window and 2 ANDs (INT32 rate)."""
    from geomesa_tpu_torch.ops import kernels

    ex = store.executor
    tables = store._tables["ways"]
    seg3 = ex.device_index(tables["xz3"]).segments[0]
    seg2 = ex.device_index(tables["xz2"]).segments[0]
    dev = ex.device
    boxes3, wins3 = ex._query_descriptor(tables["xz3"], plans["xz3_or_during"][0])
    boxes2, _ = ex._query_descriptor(tables["xz2"], plans["xz2_or"][0])

    def descs(index, stream):
        return torch.as_tensor(np.stack(
            [ex._xz_batch_desc(tables[index], p)[0] for p in plans[stream]]), device=dev)

    d3, d2, tri = descs("xz3", "xz3_bbox_during"), descs("xz2", "xz2_bbox"), \
        descs("xz2", "xz2_triangle")
    env3 = (seg3.bxmin, seg3.bymin, seg3.bxmax, seg3.bymax, seg3.valid, boxes3)
    env2 = (seg2.bxmin, seg2.bymin, seg2.bxmax, seg2.bymax, seg2.valid, boxes2)
    n3, n2 = seg3.n_padded, seg2.n_padded
    k3, w3, k2 = boxes3.shape[0], wins3.shape[0], boxes2.shape[0]
    return [
        dict(
            name="xz_mask_xz3",
            path="config3",
            tag=f"K={k3} W={w3}",
            symbol="xz_mask_kernel",
            replaces="geomesa_tpu/ops/pallas_kernels.py:102",
            source="geomesa_tpu_torch/csrc/xz_mask.cu",
            kernel=lambda: (kernels.xz_mask(*env3, seg3.bins, seg3.ti, wins3),),
            plain=lambda: (kernels.xz_mask_plain(*env3, seg3.bins, seg3.ti, wins3),),
            bytes=n3 * (4 * 4 + 1 + 2 * 4) + n3,
            ops=n3 * (k3 + 4 * w3 + 2),
            fops=n3 * 4 * k3,
            shape=f"rows={n3} K={k3} W={w3}",
        ),
        dict(
            name="xz_mask_xz2",
            path="config3",
            tag=f"K={k2} W=0",
            symbol="xz_mask_kernel",
            replaces="geomesa_tpu/ops/pallas_kernels.py:95",
            source="geomesa_tpu_torch/csrc/xz_mask.cu",
            kernel=lambda: (kernels.xz_mask(*env2),),
            plain=lambda: (kernels.xz_mask_plain(*env2),),
            bytes=n2 * (4 * 4 + 1) + n2,
            ops=n2 * (k2 + 1),
            fops=n2 * 4 * k2,
            shape=f"rows={n2} K={k2}",
        ),
        dual_case("xz_dual_bitmap_xz3", seg3, d3[:1], True, "config3"),
        dual_case("xz_dual_bitmap_xz3", seg3, d3, True, "config3"),
        dual_case("xz_dual_bitmap_xz2", seg2, d2[:1], False, "config3"),
        dual_case("xz_dual_bitmap_xz2", seg2, tri, False, "config3"),
        dual_case("xz_dual_bitmap_xz2", seg2, d2, False, "config3"),
    ]


def density_check(cap, full):
    """Kernel vs plain edition of ``density_grid``: the grid bitwise, the
    true band count equal, the band indices equal as a set; past the cap
    the kernel keeps ``cap`` distinct near rows (``full()`` lists them all)."""

    def check(got, want):
        (grid, idx, cnt), (pgrid, pidx, pcnt) = got, want
        err = int((grid.to(torch.int64) - pgrid.to(torch.int64)).abs().max().item())
        c = int(pcnt[0])
        kept = idx.cpu().numpy()
        ok = torch.equal(grid, pgrid) and int(cnt[0]) == c
        if c <= cap:
            ok = ok and (kept[c:] == -1).all() and \
                set(kept[:c].tolist()) == set(pidx.cpu().numpy()[:c].tolist())
        else:
            every = set(full()[1].cpu().numpy()[:c].tolist())
            ok = ok and len(set(kept.tolist())) == cap and set(kept.tolist()) <= every
        return bool(ok), err

    return check


def density_work(args):
    """What this run's data asks of the density function, stage by stage:
    (valid rows, rows passing valid and the window, rows of those inside a
    band-widened box, the real (not padding) boxes and windows, the certain
    rows' flat cell ids). Padding boxes are inverted and padding windows
    have bin -1: neither can hold a row, so no stage counts them."""
    from geomesa_tpu_torch.ops import aggregations as agg
    from geomesa_tpu_torch.ops.filters import bbox_mask_f32, temporal_mask

    x, y, bins, offs, valid, boxes, wins, env, width, height, _cap = args
    live = valid.clone()
    if wins is not None:
        live &= temporal_mask(bins, offs, wins)
    real = [b for b in boxes if bool(b[0] <= b[2]) and bool(b[1] <= b[3])]
    n_win = 0 if wins is None else int(((wins[:, 0] >= 0) & (wins[:, 1] <= wins[:, 2])).sum())
    eps = agg._EPS
    ex = eps * torch.maximum(torch.maximum(env[0].abs(), env[2].abs()), x.abs())
    ey = eps * torch.maximum(torch.maximum(env[1].abs(), env[3].abs()), y.abs())
    wide = torch.zeros_like(live)
    for bx0, by0, bx1, by1 in real:
        exk = torch.maximum(ex, eps * torch.maximum(bx0.abs(), bx1.abs()))
        eyk = torch.maximum(ey, eps * torch.maximum(by0.abs(), by1.abs()))
        wide |= (x >= bx0 - exk) & (x <= bx1 + exk) & (y >= by0 - eyk) & (y <= by1 + eyk)
    col, row, in_env = agg.grid_snap_indices(x, y, env, width, height)
    band, _near = agg.density_band(x, y, env, width, height, boxes)
    certain = live & bbox_mask_f32(x, y, boxes) & ~band & in_env
    ids = (row.to(torch.int64) * width + col.to(torch.int64))[certain]
    return (int(valid.sum()), int(live.sum()), int((wide & live).sum()), len(real), n_win,
            ids)


def density_cases(store, streams):
    """The density kernel on the dens z2 and gdelt z3 segments' own
    columns with the first query of each stream: (f) 256 x 128 and (g)
    512 x 512 on config #6, (h) 64 x 32 and (i) 256 x 256 (its band
    overflows) on config #1.

    The bound counts what the function needs on this run's data, not what
    the kernel happens to do. Bytes: the valid flag of every row; with
    time, bins and the ms offset of the valid rows; x and y of the rows
    that pass valid and the window (the grid and the band do not depend
    on the others' coordinates); the grid written once; the kept band
    indices and the count. Operations, counted from the source: an INT32
    valid test per row and, with time, 3 compares and an OR per real
    window and valid row; per row that passes both, 6 FP32 operations (ex,
    ey) and 22 per real box (2 max, 8 add/sub, 12 compares); per row
    inside a widened box, 36 more (the cell, the band, in_env and near; a
    divide counted as one). Padding boxes and windows hold no row and are
    not counted. ``bincount_ms`` times one torch.bincount over the certain
    rows' cell ids (library: none, no single PyTorch call computes the
    fused mask, band and grid). Each entry's launches are its own
    stream's (``path``)."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.ops import aggregations as agg
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.filters import pad_boxes, pad_windows

    ex = store.executor
    dev = ex.device
    cap = agg.DENSITY_BAND_CAP
    out = []
    for name, (tname, items, _route) in streams.items():
        cql, box, during, (width, height) = items[0]
        table = store._tables[tname]["z3" if during else "z2"]
        seg = ex.device_index(table).segments[0]
        boxes = torch.as_tensor(pad_boxes([box], dtype=np.float32), device=dev)
        env = torch.as_tensor(np.asarray(box, dtype=np.float32), device=dev)
        wins = None
        if during:
            plan = store._plan_cached(tname, Query.cql(cql))
            wins = torch.as_tensor(pad_windows(ex._ms_windows(table.ft, plan)), device=dev)
        # the temporal-valid column with windows, as density_scan passes it
        valid = seg.tvalid if during and seg.tvalid is not None else seg.valid
        args = (seg.xf, seg.yf, seg.bins if during else None, seg.t_ms if during else None,
                valid, boxes, wins, env, width, height, cap)
        n = seg.n_padded
        n_valid, live, wide, k, w, ids = density_work(args)
        cnt = int(kernels.density_grid_plain(*args)[2][0])
        out.append(dict(
            name="density_grid_" + ("z3" if during else "z2"),
            path=name,
            tag=f"{width}x{height}",
            symbol="density_grid_kernel",
            replaces="geomesa_tpu/ops/pallas_kernels.py:222",
            source="geomesa_tpu_torch/csrc/density_grid.cu",
            kernel=lambda a=args: kernels.density_grid(*a),
            plain=lambda a=args: kernels.density_grid_plain(*a),
            check=density_check(cap, lambda a=args, c=cnt: kernels.density_grid_plain(
                *a[:-1], max(c, 1))),
            bytes=n + (8 * n_valid if during else 0) + 8 * live + 4 * width * height
            + 4 * min(cnt, cap) + 4,
            ops=n + n_valid * 4 * w,
            fops=live * (6 + 22 * k) + wide * 36,
            aside={"bincount_ms": lambda i=ids, m=width * height: torch.bincount(i, minlength=m)},
            shape=f"rows={n} live={live} {width}x{height} K={k} W={w} band={cnt} stream={name}",
        ))
    return out


def kernel_checks(cases, int32_per_s, fp32_per_s, ab=None):
    """Each kernel against its plain edition (bitwise), then timed at its
    shape beside its plain edition (``kernel_ms``, ``event_ms``). Returns
    the kernels-line entries (their launch counts are filled in from the
    main path's run). The bound is the larger of the bytes over HBM
    bandwidth and the counted instructions over the card's rate for their
    type. ``ab`` maps a kernel source's name to other sources with the
    same C interface: that kernel is then also timed from each, in turns
    with its own (own, other, other, own), under ``ab_ms`` by source."""
    from geomesa_tpu_torch.ops import kernels

    out = []
    for c in cases:
        got = c["kernel"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        if "check" in c:
            equal, err = c["check"](got, want)
        else:
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
            err = max_abs_err(got, want)
        if not equal:
            raise AssertionError(
                f"{c['name']} {c['tag']}: kernel differs from its plain edition "
                f"(max abs err {err})"
            )
        per_call = c.get("launches", lambda: None)()
        ms, call_ms, seen, ms_source, pass_ms, windows = kernel_ms(c["kernel"], c["symbol"],
                                                                   per_call=per_call)
        plain_ms = event_ms(c["plain"], reps=10, warmup=1)
        t_bytes = c["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = (c["ops"] / int32_per_s + c.get("fops", 0) / fp32_per_s) * 1e3
        bound = max(t_bytes, t_ops)
        # the PyTorch calls timed beside the kernel; ``library`` names the one
        # that computes the same function (the entry's library_ms)
        aside = {k: event_ms(fn, reps=50) for k, fn in c.get("aside", {}).items()}
        read = [w for w in windows if w is not None]
        flags = []
        if len(read) < len(windows):
            flags.append("a window without device time")
        if read and max(read) > (1 + WINDOW_SPREAD) * min(read):
            flags.append(f"windows differ by {100 * (max(read) / min(read) - 1):.1f}%")
        if any(w < bound for w in read):
            flags.append("a window below the bound")
        if ms < bound:
            # below the least time the card can take in every window: the
            # profiler's reading is wrong (it drops and shortens events late
            # in a long run), and the wrapper's event time, a ceiling of the
            # kernel's, stands in
            ms, ms_source = call_ms, "events (profiler below the bound)"
        if flags:
            log(f"{c['name']} {c['tag']}: profiler windows {windows} ms, bound {bound:.4f} ms, "
                f"events {call_ms:.4f} ms: {'; '.join(flags)}")
            ms_source += f" (flagged: {'; '.join(flags)})"
        out.append({
            "name": c["name"],
            "route": "cuda",
            "source": c["source"],
            "replaces": c["replaces"],
            "launches": None,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": aside[c["library"]] if "library" in c else None,
            "call_ms": call_ms,
            "ms_source": ms_source,
            "ms_windows": windows,
            "flagged": bool(flags),
            "profiled_launches": seen,
            "pass_ms": pass_ms,
            **({"launches_per_call": per_call} if "launches" in c else {}),
            "bitwise_equal": equal,
            "shape_tag": c["tag"],
            "shape": c["shape"],
            "path": c["path"],
            **c.get("extra", {}),
            **aside,
        })
        srcs = (ab or {}).get(c["source"].rsplit("/", 1)[1][:-3])
        if srcs and not c.get("no_ab"):
            out[-1]["ab_ms"] = {src: ab_times(c, src) for src in srcs}
        log(f"{c['name']} {c['tag']}: {ms:.4f} ms device ({ms_source}), {call_ms:.4f} ms "
            f"per call (plain {plain_ms:.4f} ms, bound {out[-1]['bound_ms']:.4f} ms) "
            f"{c['shape']}; by kernel {json.dumps(pass_ms)}")
    return out


def ab_times(case, src):
    """Device ms per launch of ``case``'s kernel built from its own source
    and from ``src``, in turns (own, other, other, own), each checked
    against the plain edition first, with each turn's split by kernel
    (``own_pass_ms``, ``other_pass_ms``); the other design is called
    through ``case["ab_kernel"]`` where the case has one."""
    from geomesa_tpu_torch.ops import kernels

    lib = case["source"].rsplit("/", 1)[1][:-3]
    want = case["plain"]()
    times = {"own": [], "other": [], "own_pass_ms": [], "other_pass_ms": []}
    for which in ("own", "other", "other", "own"):
        per_call = case.get("launches", lambda: None)
        if which == "own":
            got = kernel_ms(case["kernel"], case["symbol"], per_call=per_call())
            times[which].append(got[0])
            times["own_pass_ms"].append(got[4])
            continue
        other = case.get("ab_kernel", case["kernel"])
        with kernels.using_source(lib, src):
            got = other()
            torch.cuda.synchronize()
            ok = case["check"](got, want)[0] if "check" in case else \
                all(torch.equal(g, w) for g, w in zip(got, want))
            if not ok:
                raise AssertionError(f"{case['name']} from {src} differs from its plain edition")
            got = kernel_ms(other, case["symbol"], per_call=per_call())
            times[which].append(got[0])
            times["other_pass_ms"].append(got[4])
    log(f"{case['name']} {case['tag']} A/B vs {src}: own {times['own']} other {times['other']} ms")
    return times


TRACE_LEADS_S = (0.2, 1.0, 3.0, 8.0)


def breakdown(store, name, queries, run=None):
    """Where one pipelined stream spends its time, from one torch.profiler
    trace of ``store.query_many``: the host time of each step, read from
    the ``geomesa.*`` ranges the store and the executor open, and the
    device's busy share (device kernel and copy time over the traced
    wall). Then, untraced, the lazy fid gather of the results; and the
    cost of one range with no profiler running.

    A trace must hold a device event of every hand kernel the stream
    launched (``kernels.LAUNCHES``). Late in a long run the card's trace
    can drop the device events of a session's first moments, where the
    stream's launches and copies fall, so each session runs a spin kernel
    and waits ``lead`` seconds before the stream; a trace
    that still misses a launched kernel is taken again with the next,
    longer lead, and the busy and idle figures are null when every lead
    missed one. ``run``, when given, is traced in place of the stream and
    returns (results, routes): one result per entry of ``queries``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from geomesa_tpu_torch.ops import kernels

    clock = time.perf_counter
    n = len(queries)
    for lead in TRACE_LEADS_S:
        before = dict(kernels.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)  # the spin kernel, left out below
            torch.cuda.synchronize()
            time.sleep(lead)
            t0 = clock()
            if run is None:
                results = store.query_many(name, queries)
            else:
                results, routes = run()
            torch.cuda.synchronize()
            wall_ms = (clock() - t0) * 1e3
        events = prof.key_averages()
        # device-side events only (kernels and copies): the CPU-side aten
        # ops carry their kernels' time too and would count it twice, and
        # the ranges' device-side mirrors span the idle gaps
        device_us = {
            e.key: e.self_device_time_total
            for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total
            and not e.key.startswith("geomesa.") and "spin_kernel" not in e.key
        }
        # by kernel source: its device kernel's name holds the source's name
        launched = {src for k, v in kernels.LAUNCHES.items() if v > before.get(k, 0)
                    for src in kernels.SOURCES if k.startswith(src)}
        missing = sorted(k for k in launched if not any(k in key for key in device_us))
        if not missing:
            break
        log(f"{name} trace with a {lead} s lead: no device event of {missing} "
            f"({len(device_us)} device ops traced)")
    t0 = clock()
    if run is None:
        for r in results:
            r.fids  # noqa: B018 - the lazy fid gather, outside the trace
        routes = sorted({str(getattr(r.plan, "scan_path", None)) for r in results})
    gather_ms = (clock() - t0) * 1e3
    # the geomesa.* ranges are disjoint; their CPU totals include the aten
    # ops they run
    host_ms = {
        e.key.split(".", 1)[1] + "_ms": e.cpu_time_total / 1e3 / n
        for e in events
        if e.key.startswith("geomesa.") and e.device_type == torch.autograd.DeviceType.CPU
    }
    busy_ms = None if missing else sum(device_us.values()) / 1e3
    # the first 100 characters of a kernel's name (templated names run long)
    top = [(k[:100], v) for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:6]]
    reps = 20_000
    t0 = clock()
    for _ in range(reps):
        with record_function("geomesa.noop"):
            pass
    span_us = (clock() - t0) / reps * 1e6
    return {
        "traced_wall_ms_per_query": wall_ms / n,
        "fid_gather_ms_per_query": gather_ms / n,
        "host_step_ms_per_query": host_ms,
        "hits_per_query": sum(len(r) for r in results) / n,
        "routes": routes,
        "kernels_launched": sorted(launched),
        "trace_lead_s": lead,
        "device_busy_ms_per_query": None if busy_ms is None else busy_ms / n,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
        "top_device_ops_ms": {k: v / 1e3 for k, v in top},
        "span_cost_us_unprofiled": span_us,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=20_000_000, help="config #1 points")
    ap.add_argument("--ways", type=int, default=WAYS_ROWS, help="config #3 extents")
    ap.add_argument("--dens", type=int, default=DENS_ROWS, help="config #6 points")
    ap.add_argument("--attr", type=int, default=ATTR_ROWS, help="config #4 points")
    ap.add_argument("--knn", type=int, default=KNN_ROWS, help="config #5 points")
    ap.add_argument("--poly", type=int, default=POLY_ROWS, help="polygon-plane points")
    ap.add_argument("--labels", type=int, default=LABEL_ROWS, help="labelled-table points")
    ap.add_argument("--seed", type=int, default=66, help="seed of the config #3 ways")
    ap.add_argument("--out", default="chiprun_out", help="directory for the JSON record")
    ap.add_argument("--ab", nargs="+", default=[], metavar="DIR",
                    help="time each kernel whose source DIR/<name>.cu holds another design "
                         "(same C interface) in turns with its own, for each DIR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is false: this script needs a CUDA device")
        return 2
    # the device routes: every path below but the seek stream; the kNN's
    # path choice on auto
    os.environ["GEOMESA_SEEK"] = "0"
    os.environ.pop("GEOMESA_KNN_DEVICE", None)

    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.store.datastore import TorchDataStore
    from geomesa_tpu_torch.utils.config import set_property

    # the aggregate cache off everywhere but the pyramid phase: with it on,
    # the density streams' repeated queries would answer from the memo and
    # the count path's star from the pyramid, not from the kernels those
    # phases measure
    set_property("geomesa.agg.enabled", "false")

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        built = pool.submit(kernels.build_all)
        native_status = pool.submit(native_build).result()
        built.result()
    build_s = time.perf_counter() - t0
    log(f"kernels and native libraries built in {build_s:.2f} s: "
        f"{json.dumps({k: (v['flags'], round(v['build_s'], 2)) for k, v in native_status.items()})}")
    for name, text in kernels.ptxas_report().items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    ab = {}
    for d in args.ab:
        for f in sorted(os.listdir(d)):
            if f.endswith(".cu") and f[:-3] in kernels.SOURCES:
                ab.setdefault(f[:-3], []).append(os.path.join(d, f))

    # -- phase 2: data, ingest, device columns --------------------------------
    store = TorchDataStore()  # the default executor: TorchScanExecutor on cuda:0
    walks = {}
    with recording_range_walks(walks):
        data1, plans1, streams1, setup1 = config1(store, args.rows)
        ways3, streams3, plans3, oracle3, setup3 = config3(store, args.ways, args.seed)
    streams6, oracle6, setup6 = config6(store, args.dens, data1, args.rows >= 20_000_000)
    data4, streams4, plans4, oracle4, setup4 = config4(store, args.attr)
    _data5, track5, oracle5, plans_m, setup5 = config5(store, args.knn)
    streams_p, plans_p, oracle_p, setup_p = config_poly(store, args.poly, plans_m)
    oracle_p["m"] = oracle5["m"]
    log(f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    # -- phase 3: kernels against their plain editions ------------------------
    int32_per_s = lane_ops_per_s(INT32_LANES_PER_SM)
    fp32_per_s = lane_ops_per_s(FP32_LANES_PER_SM)
    log(f"INT32 peak: {int32_per_s:.4g} ops/s; FP32 {fp32_per_s:.4g} ops/s")
    entries = kernel_checks(
        point_cases(store, plans1) + xz_cases(store, plans3) + density_cases(store, streams6),
        int32_per_s, fp32_per_s, ab)

    # -- phase 4: each main path through the entry points, launches counted ---
    launched = {}
    kernels.reset_launches()
    metrics1 = config1_path(store, data1, streams1)
    launched["config1"] = (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))
    kernels.reset_launches()
    metrics3 = config3_path(store, streams3, oracle3)
    launched["config3"] = (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))
    metrics6 = density_path(store, streams6, oracle6, launched)
    kernels.reset_launches()
    metrics4 = config4_path(store, streams4, oracle4)
    launched["config4"] = (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))
    # config #4's kernel phase follows its path: a query whose span outgrew
    # the learned window refetched alone, at a q = 1 shape the data decides
    entries += kernel_checks(attr_cases(store, plans4, launched["config4"][1]),
                             int32_per_s, fp32_per_s, ab)
    kernels.reset_launches()
    metrics5 = config5_path(store, track5, oracle5)
    launched["config5"] = (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))
    kernels.reset_launches()
    metrics_p = poly_path(store, streams_p, oracle_p)
    launched["poly"] = (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))
    # their kernel phase follows the paths: the top-k's k carries the
    # certificate's margin, and a polygon refetch's q = 1 shape is the data's
    entries += kernel_checks(knn_cases(store, launched["config5"][1])
                             + poly_cases(store, plans_p, launched["poly"][1]),
                             int32_per_s, fp32_per_s, ab)
    # the count and stats push-downs and the attribute editions of the dual
    # planes, each a path of its own, then their kernel phase
    t_push = time.perf_counter()
    items = count_items(data1, streams1, ways3, streams_p["lone"][0], oracle_p["lone"][0], data4)
    kernels.reset_launches()
    metrics_count = count_path(store, items)
    launched["count"] = (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))
    kernels.reset_launches()
    metrics_stats = stats_path(store, data4)
    launched["stats"] = (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))
    kernels.reset_launches()
    metrics_dual = dual_attr_path(store, ways3, data4)
    launched["dual_attr"] = (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))
    entries += kernel_checks(
        push_down_cases(store, items, {p: launched[p][1] for p in ("count", "stats", "dual_attr")},
                        {(e["name"], e["shape_tag"]) for e in entries}),
        int32_per_s, fp32_per_s, ab)
    push_s = time.perf_counter() - t_push
    # the concurrent phase: many callers through store.query, coalesced and
    # solo, then its kernel phase at the shapes the coalescer launched
    t_conc = time.perf_counter()
    conc_items = concurrent_items(data1, streams1, streams3, oracle3, streams_p, oracle_p,
                                  streams4, oracle4)
    kernels.reset_launches()
    metrics_conc = concurrent_path(store, conc_items)
    launched["concurrent"] = (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))
    conc_plans = {"config1": plans1["config1"], "attr_j": plans4["j"],
                  "xz2_bbox": plans3["xz2_bbox"], "poly_l": plans_p["l"]}
    entries += kernel_checks(mask_cases(store, conc_plans, launched["concurrent"][1]),
                             int32_per_s, fp32_per_s, ab)
    concurrent_s = time.perf_counter() - t_conc
    # the aggregate pyramid phase, then its kernel phase at the shapes it
    # launched
    t_pyr = time.perf_counter()
    pyr_items = pyramid_items(data1, streams1, streams_p, oracle_p)
    kernels.reset_launches()
    metrics_pyr = pyramid_path(store, pyr_items, data1, data4, streams6, oracle6)
    launched["pyramid"] = (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))
    # after the launches are read: the split's own launches are not the path's
    metrics_pyr["build_split"] = {f"config1_bits{bits}": build_split(store, "gdelt", bits)
                                  for bits in sorted(PYR_BITS)}
    log(f"pyramid build split: {json.dumps(metrics_pyr['build_split'])}")
    pyramid_s = time.perf_counter() - t_pyr
    entries += kernel_checks(
        pyramid_cases(store, pyr_items, launched["pyramid"][1],
                      {(e["name"], e["shape_tag"]) for e in entries}),
        int32_per_s, fp32_per_s, ab)
    nulls = null_dates_check(store)
    attr_nulls = attr_nulls_check(store)
    log(f"main-path launches: { {p: s for p, (_n, s) in launched.items()} }")

    # -- phase 6: the host-seek route and the native host libraries -------------
    seek = seek_stream(store, data1, streams1)
    seek["crossover"] = seek_crossover(store, data1)
    host = native_timings(store, data1, plans1, plans3, walks)
    host["libraries"] = native_status
    host["plan_config1_ms_per_query"] = setup1["plan_ms_per_query"]
    host["plan_config3_s"] = setup3["first_plan_s"]

    # -- phase 7: host splits and the host-tested rows --------------------------
    split1 = breakdown(store, "gdelt", [Query.cql(c, properties=[]) for c in streams1["config1"][1]])
    log(f"config #1 stream breakdown: {json.dumps(split1)}")
    os.environ["GEOMESA_SEEK"] = "auto"
    try:
        seek["breakdown"] = breakdown(
            store, "gdelt", [Query.cql(c, properties=[]) for c in streams1["config1"][1]])
    finally:
        os.environ["GEOMESA_SEEK"] = "0"
    log(f"config #1 host-seek breakdown: {json.dumps(seek['breakdown'])}")
    split3 = breakdown(store, "ways", [Query.cql(c, properties=[]) for c, _ in streams3["xz2_bbox"]])
    log(f"config #3 xz2 stream breakdown: {json.dumps(split3)}")
    for name, rows in host_tested_rows(store, plans3).items():
        metrics3[name]["host_tested_rows_per_query"] = rows
    for name, rows in density_band_rows(store, streams6).items():
        metrics6[name]["band_rows_per_query"] = rows
    for name, (tname, items, _route) in streams6.items():
        metrics6[name]["breakdown"] = breakdown(store, tname, density_queries(items))
        log(f"{name} breakdown: {json.dumps(metrics6[name]['breakdown'])}")
    for stream in ("j", "k"):
        metrics4[f"stream_{stream}"]["breakdown"] = breakdown(
            store, ATTR_TABLE, [Query.cql(c, properties=[]) for c, _ in streams4[stream]])
        log(f"config #4 ({stream}) breakdown: "
            f"{json.dumps(metrics4[f'stream_{stream}']['breakdown'])}")
    metrics5["breakdown_n"] = breakdown(store, KNN_TABLE, [None] * KNN_REPS,
                                      run=lambda: knn_stream(store))
    log(f"config #5 (n) breakdown: {json.dumps(metrics5['breakdown_n'])}")
    o_points = knn_points()
    metrics5["breakdown_o_k1000"] = breakdown(
        store, KNN_TABLE, [None] * len(o_points), run=lambda: knn_stream(store, o_points, 1000))
    log(f"config #5 (o) k = 1000 breakdown: {json.dumps(metrics5['breakdown_o_k1000'])}")
    metrics_p["stream_l"]["breakdown"] = breakdown(
        store, POLY_TABLE, [Query.cql(c, properties=[]) for c, _ in streams_p["l"]])
    log(f"polygon (l) breakdown: {json.dumps(metrics_p['stream_l']['breakdown'])}")
    for name, table_name in (("l", POLY_TABLE), ("m", KNN_TABLE)):
        rows = host_tested_rows(store, {name: plans_p[name]}, table_name)[name]
        metrics_p[f"stream_{name}"]["host_tested_rows_per_query"] = rows

    # -- phase 7b: telemetry (before the lifecycle phases mutate the tables) ----
    t_tel = time.perf_counter()
    kernels.reset_launches()
    metrics_tel = telemetry_path(store, data1, streams1, oracle3, streams3)
    launched["telemetry"] = (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))
    telemetry_s = time.perf_counter() - t_tel
    log(f"telemetry phase {telemetry_s:.1f} s")

    # -- phase 8: deletes, age-off, compaction, labels, then the faults -------
    t_life = time.perf_counter()
    ints = (int32_per_s, fp32_per_s)
    kernels.reset_launches()
    metrics_life, alive1 = lifecycle_path(store, data1, streams1, streams6)
    launched["lifecycle"] = (dict(kernels.LAUNCHES), relabel(kernels.LAUNCH_SHAPES, HOLES))
    entries += kernel_checks(lifecycle_cases(store, plans1, streams1, streams6,
                                             launched["lifecycle"][1]), *ints)
    kernels.reset_launches()
    metrics_life["ageoff"], alive1 = ageoff_path(store, data1, streams1, alive1)
    # config #1's table, holed further: timed by the lifecycle's holed entries
    launched["ageoff"] = (dict(kernels.LAUNCHES), relabel(kernels.LAUNCH_SHAPES, HOLES))
    metrics_life["compaction"], compact_launched = compaction_path(
        store, ways3, streams3, oracle3, entries, ints)
    ways_dead = metrics_life["compaction"].pop("dead")
    launched.update(compact_launched)
    kernels.reset_launches()
    metrics_life["labels"] = labels_path(store, args.labels, streams1)
    launched["labels"] = (dict(kernels.LAUNCHES), relabel(kernels.LAUNCH_SHAPES, LABELLED))
    entries += kernel_checks(labels_cases(store, streams1, launched["labels"][1]), *ints)
    lifecycle_s = time.perf_counter() - t_life
    # no phase but the fault phase may degrade, open the breaker or trip the kNN
    before = robustness_counters()
    if any(before.values()) or getattr(store.executor, "_device_tripped", False):
        raise AssertionError(f"degrades outside the fault phase: {before}")
    t_fault = time.perf_counter()
    metrics_faults, fault_launched = fault_path(store, data1, streams1, alive1, streams3, oracle3,
                                                ways_dead)
    launched.update(fault_launched)
    entries += kernel_checks(knn_host_cases(store, launched["faults_knn"][1]), *ints)
    fault_s = time.perf_counter() - t_fault
    log(f"lifecycle phases {lifecycle_s:.1f} s, fault phase {fault_s:.1f} s")

    # -- phase 5: each path went through its kernels, at every timed shape ----
    ranking = check_launches(entries, launched, set(kernels.LAUNCHES))
    log(f"launches x (ms - bound) per smoke run: {json.dumps(ranking)}")
    flagged = [e for e in entries if e["flagged"]]
    log(f"{len(flagged)} of {len(entries)} kernel entries flagged by their profiler windows: "
        f"{[(e['name'], e['shape_tag'], e['ms_windows']) for e in flagged]}")

    metrics = {
        "rows": args.rows,
        "card": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        **metrics1,
        **setup1,
        "kernel_build_s": build_s,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "int32_ops_per_s": int32_per_s,
        "fp32_ops_per_s": fp32_per_s,
        "breakdown": split1,
        "seek_stream": seek,
        "ranking_ms": ranking,
        "config3": {**setup3, "streams": metrics3, "breakdown_xz2_bbox": split3},
        "density": {**setup6, "streams": metrics6, "null_dates": nulls},
        "config4": {**setup4, **metrics4, "nulls": attr_nulls},
        "config5": {**setup5, **metrics5},
        "poly": {**setup_p, **metrics_p},
        "count": metrics_count,
        "stats": metrics_stats,
        "dual_attr": metrics_dual,
        "push_down_phases_s": push_s,
        "concurrent": metrics_conc,
        "concurrent_phase_s": concurrent_s,
        "pyramid": metrics_pyr,
        "pyramid_phase_s": pyramid_s,
        "telemetry": metrics_tel,
        "telemetry_phase_s": telemetry_s,
        "lifecycle": metrics_life,
        "lifecycle_phases_s": lifecycle_s,
        "faults": metrics_faults,
        "fault_phase_s": fault_s,
        "flagged_kernel_entries": [f"{e['name']} {e['shape_tag']}" for e in entries
                                   if e["flagged"]],
        "script_s": time.perf_counter() - t_start,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"kernels": entries, "metrics": metrics, "native": host}, f, indent=1)
    print(json.dumps({"native": host}))
    print(json.dumps({"metrics": metrics}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0



def check_launches(entries, launched, names):
    """Fill each entry's ``launches``: the launches at its kernel and shape
    over every path (stream (i)'s host route runs config #1's lone exact
    query). Fail unless every entry's own path launched it, every shape a
    path launched is timed (so the shapes' launches add up to the paths'
    count per kernel) and every kernel has an entry. Returns the ranking:
    per kernel, the sum over its shapes of launches x (ms - bound),
    largest first."""
    total = {}
    for _counts, shapes in launched.values():
        for key, count in shapes.items():
            total[key] = total.get(key, 0) + count
    missing = []
    for e in entries:
        path = e.pop("path")
        key = (e["name"], e["shape_tag"])
        e["launches"] = total.get(key, 0)
        if not launched[path][1].get(key):
            missing.append(f"{path}: {key[0]} {key[1]}")
    timed = {(e["name"], e["shape_tag"]) for e in entries}
    untimed = [f"{name} {tag}" for (name, tag), count in total.items()
               if count and (name, tag) not in timed]
    if missing or untimed or {e["name"] for e in entries} != names:
        raise AssertionError(f"kernel shapes never launched on their main path: {missing}; "
                             f"launched but not timed: {untimed}")
    ranking = {}
    for e in entries:
        ranking[e["name"]] = ranking.get(e["name"], 0.0) + e["launches"] * (e["ms"] - e["bound_ms"])
    return dict(sorted(ranking.items(), key=lambda kv: -kv[1]))


def config1(store, n):
    """Config #1: ingest N GDELT-style points, upload the z3/z2 device
    columns. Returns (data, plans, streams)."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.schema.featuretype import parse_spec

    x, y, t = synthesize(n)
    boxes, cqls = make_queries(REPS)
    ft = parse_spec("gdelt", "dtg:Date,*geom:Point:srid=4326")
    store.create_schema(ft)
    fids = np.char.add("f", np.arange(n).astype(f"<U{len(str(n - 1))}"))
    t0 = time.perf_counter()
    store._insert_columns(ft, {"__fid__": fids, "geom__x": x, "geom__y": y, "dtg": t})
    ingest_s = time.perf_counter() - t0
    log(f"config #1 ingest: {n / ingest_s:,.0f} rec/s ({ingest_s:.1f} s)")

    bbox_boxes = jittered_boxes(RESIDUAL_REPS, seed=17)
    resid = list(zip(jittered_boxes(RESIDUAL_REPS, seed=23),
                     jittered_boxes(RESIDUAL_REPS, box=BOX_B, seed=29)))
    streams = {
        "config1": (boxes, cqls),
        "bbox": (bbox_boxes, [bbox_cql(b) for b in bbox_boxes]),
        "resid_z3": (resid, [f"({bbox_cql(a)} OR {bbox_cql(b)}) AND {DURING}" for a, b in resid]),
        "resid_z2": (resid, [f"{bbox_cql(a)} OR {bbox_cql(b)}" for a, b in resid]),
    }
    t0 = time.perf_counter()
    plans = {
        "config1": [store._plan_cached("gdelt", Query.cql(c)) for c in cqls],
    }
    plan_ms = (time.perf_counter() - t0) * 1e3 / len(cqls)
    plans.update({
        "bbox": [store._plan_cached("gdelt", Query.cql(c)) for c in streams["bbox"][1]],
        "resid_z3": store._plan_cached("gdelt", Query.cql(streams["resid_z3"][1][0])),
        "resid_z2": store._plan_cached("gdelt", Query.cql(streams["resid_z2"][1][0])),
    })
    idx = {p.index.name for p in plans["config1"]}, {p.index.name for p in plans["bbox"]}
    if idx != ({"z3"}, {"z2"}) or plans["resid_z3"].index.name != "z3" \
            or plans["resid_z2"].index.name != "z2":
        raise AssertionError(f"unexpected plan indices: {idx}")
    t0 = time.perf_counter()
    for name in ("z3", "z2"):
        table = store._tables["gdelt"][name]
        for seg in store.executor.device_index(table).segments:
            seg.load_exact(table)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    log(f"config #1 device columns uploaded in {upload_s:.1f} s")
    return (x, y, t), plans, streams, {"ingest_rec_per_s": n / ingest_s, "upload_s": upload_s,
                                       "plan_ms_per_query": plan_ms}


def config1_path(store, data, streams):
    """Config #1's main path through the entry points, parity-checked."""
    from geomesa_tpu_torch.index.planner import Query

    x, y, t = data
    boxes, cqls = streams["config1"]
    t0 = time.perf_counter()
    res = store.query("gdelt", QUERY)
    warm_s = time.perf_counter() - t0
    expect_fids(res, brute_force(x, y, t), "config #1 sync query")
    if res.plan.scan_path != "device-exact/runs":
        raise AssertionError(f"config #1 took {res.plan.scan_path}")
    lat_reps = 3
    t0 = time.perf_counter()
    for _ in range(lat_reps):
        store.query("gdelt", QUERY)
    sync_s = (time.perf_counter() - t0) / lat_reps

    queries = [Query.cql(c, properties=[]) for c in cqls]
    store.query_many("gdelt", queries)  # warm: span window learning
    t0 = time.perf_counter()
    results = store.query_many("gdelt", queries)
    pipe_s = (time.perf_counter() - t0) / len(queries)
    for i, (r, b) in enumerate(zip(results, boxes)):
        expect_fids(r, brute_force(x, y, t, b), f"config #1 stream query {i}")
    read_s = timed_fids_read(store, "gdelt", queries)

    bbox_boxes, bbox_cqls = streams["bbox"]
    res = store.query("gdelt", bbox_cqls[0])  # a lone bbox-only query (z2 exact, q = 1)
    expect_fids(res, np.flatnonzero(in_box(x, y, bbox_boxes[0])), "bbox-only lone query")
    t0 = time.perf_counter()
    results = store.query_many("gdelt", [Query.cql(c, properties=[]) for c in bbox_cqls])
    bbox_s = (time.perf_counter() - t0) / len(bbox_cqls)
    for i, (r, b) in enumerate(zip(results, bbox_boxes)):
        expect_fids(r, np.flatnonzero(in_box(x, y, b)), f"bbox-only query {i}")

    resid, resid_z3 = streams["resid_z3"]
    t0 = time.perf_counter()
    results = store.query_many("gdelt", [Query.cql(c, properties=[]) for c in resid_z3])
    resid3_s = (time.perf_counter() - t0) / len(resid_z3)
    for i, (r, (a, b)) in enumerate(zip(results, resid)):
        m = (in_box(x, y, a) | in_box(x, y, b)) & (t > T_LO) & (t < T_HI)
        expect_fids(r, np.flatnonzero(m), f"residual z3 query {i}")

    resid_z2 = streams["resid_z2"][1]
    t0 = time.perf_counter()
    results = store.query_many("gdelt", [Query.cql(c, properties=[]) for c in resid_z2])
    resid2_s = (time.perf_counter() - t0) / len(resid_z2)
    for i, (r, (a, b)) in enumerate(zip(results, resid)):
        expect_fids(r, np.flatnonzero(in_box(x, y, a) | in_box(x, y, b)), f"residual z2 query {i}")
    torch.cuda.synchronize()
    log(f"config #1 path: {pipe_s * 1e3:.2f} ms/query pipelined, {sync_s * 1e3:.2f} ms sync")
    return {
        "features_per_s": len(x) / pipe_s,
        "query_ms_sync": sync_s * 1e3,
        "query_ms_pipelined": pipe_s * 1e3,
        "query_ms_pipelined_fids_read": read_s * 1e3,
        "bbox_query_ms_pipelined": bbox_s * 1e3,
        "residual_z3_query_ms_pipelined": resid3_s * 1e3,
        "residual_z2_query_ms_pipelined": resid2_s * 1e3,
        "warm_query_s": warm_s,
        "hits_query0": int(len(res.fids)),
    }


# stream -> (index, scan path in a stream, scan path of a lone query)
XZ_PATHS = {
    "xz2_bbox": ("xz2", "device-batch-dual/bitmap", "device-batch-dual/runs"),
    "xz3_bbox_during": ("xz3", "device-batch-dual/bitmap", "device-batch-dual/runs"),
    "xz2_triangle": ("xz2", "device-batch-dual/bitmap", "device-batch-dual/runs"),
    "xz2_or": ("xz2", "device-mask/runs", "device-mask/runs"),
    "xz3_or_during": ("xz3", "device-mask/runs", "device-mask/runs"),
}


def config3(store, n, seed):
    """Config #3: N OSM-way-shaped features through ``_insert_columns``
    with precomputed envelope companions, the xz3/xz2 device columns
    uploaded, and each stream's plans and numpy-oracle answers."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.schema.featuretype import parse_spec

    t0 = time.perf_counter()
    ways = synthesize_ways(n, seed=seed)
    cols = ways_columns(ways)
    gen_s = time.perf_counter() - t0
    ft = parse_spec("ways", WAYS_SPEC)
    store.create_schema(ft)
    if [i.name for i in store._indices["ways"]] != ["xz3", "xz2", "id"]:
        raise AssertionError(f"ways indices: {[i.name for i in store._indices['ways']]}")
    t0 = time.perf_counter()
    store._insert_columns(ft, cols)
    ingest_s = time.perf_counter() - t0
    log(f"config #3: {n} ways made in {gen_s:.1f} s, ingest {n / ingest_s:,.0f} rec/s "
        f"({ingest_s:.1f} s)")
    t0 = time.perf_counter()
    for name in ("xz3", "xz2"):
        table = store._tables["ways"][name]
        for seg in store.executor.device_index(table).segments:
            seg.load_exact_xz(table)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    streams = xz_streams()
    t0 = time.perf_counter()
    plans = {k: [store._plan_cached("ways", Query.cql(c)) for c, _ in items]
             for k, items in streams.items()}
    plan_s = time.perf_counter() - t0
    for k, ps in plans.items():
        got = {p.index.name for p in ps}
        if got != {XZ_PATHS[k][0]}:
            raise AssertionError(f"{k}: planned on {got}")
    t0 = time.perf_counter()
    oracle = {k: [oracle_rows(ways, *spec) for _c, spec in items] for k, items in streams.items()}
    oracle_s = time.perf_counter() - t0
    log(f"config #3 device columns uploaded in {upload_s:.1f} s; plans {plan_s:.1f} s; "
        f"oracle {oracle_s:.1f} s")
    return ways, streams, plans, oracle, {
        "ways": n, "ways_made_s": gen_s, "ingest_rec_per_s": n / ingest_s,
        "upload_s": upload_s, "first_plan_s": plan_s, "oracle_s": oracle_s,
    }


def config3_path(store, streams, oracle):
    """Config #3's main path through the entry points: per stream a warm
    ``query_many`` (span window learning) and a timed one, then every
    query of the stream alone through ``store.query``, once checked and
    once timed, so that both routes' ms per query cover the same queries;
    every answer parity-checked."""
    from geomesa_tpu_torch.index.planner import Query

    out = {}
    for name, items in streams.items():
        index, path, lone_path = XZ_PATHS[name]
        queries = [Query.cql(c, properties=[]) for c, _ in items]
        store.query_many("ways", queries)
        t0 = time.perf_counter()
        results = store.query_many("ways", queries)
        pipe_s = (time.perf_counter() - t0) / len(queries)
        for i, r in enumerate(results):
            expect_fids(r, oracle[name][i], f"{name} query {i}", prefix="w")
            if (r.plan.index.name, r.plan.scan_path) != (index, path):
                raise AssertionError(f"{name} query {i}: {r.plan.index.name} {r.plan.scan_path}")
        read_s = timed_fids_read(store, "ways", queries)
        for i, (cql, _spec) in enumerate(items):
            res = store.query("ways", cql)
            expect_fids(res, oracle[name][i], f"{name} lone query {i}", prefix="w")
            if res.plan.scan_path != lone_path:
                raise AssertionError(f"{name} lone query {i} took {res.plan.scan_path}")
        t0 = time.perf_counter()
        for cql, _spec in items:
            store.query("ways", cql)
        sync_s = (time.perf_counter() - t0) / len(items)
        out[name] = {
            "queries": len(items),
            "query_ms_pipelined": pipe_s * 1e3,
            "query_ms_pipelined_fids_read": read_s * 1e3,
            "query_ms_sync": sync_s * 1e3,
            "hits_per_query": sum(len(r) for r in results) / len(results),
        }
        log(f"{name}: {pipe_s * 1e3:.2f} ms/query pipelined, {sync_s * 1e3:.2f} ms sync, "
            f"{out[name]['hits_per_query']:.0f} hits/query")
    torch.cuda.synchronize()
    return out


def host_tested_rows(store, plans, table_name="ways"):
    """Per stream, the rows per query the host tests after the device: the
    ring (hit minus decided) of the dual route (extents, or polygons over
    points), the candidates of the mask route (all post-filtered)."""
    from geomesa_tpu_torch.parallel.executor import _XZBatchScan

    tables = store._tables[table_name]
    out = {}
    for name, ps in plans.items():
        scans = store.executor.dispatch_many([(tables[p.index.name], p) for p in ps])
        sizes = []
        for p in ps:
            scan = scans[id(p)]
            if isinstance(scan, _XZBatchScan):
                sizes.append(sum(len(h) - len(d) for _seg, ph in scan.pending
                                 for h, d in [ph.rows()]))
            else:
                sizes.append(sum(len(rows) for _block, rows in scan))
        out[name] = sum(sizes) / len(sizes)
    return out


def config6(store, n, gdelt, full: bool):
    """Config #6: bench_density's N uniform points in the ``dens`` schema
    (z2, id), the raw f32 device columns of its z2 table and of config #1's
    z3 table, and each density stream's plans and numpy-oracle grids
    (``gdelt`` = config #1's (x, y, t))."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.schema.featuretype import parse_spec

    x, y = synthesize_dens(n)
    ft = parse_spec("dens", DENS_SPEC)
    store.create_schema(ft)
    if [i.name for i in store._indices["dens"]] != ["z2", "id"]:
        raise AssertionError(f"dens indices: {[i.name for i in store._indices['dens']]}")
    fids = np.char.add("f", np.arange(n).astype(f"<U{len(str(n - 1))}"))
    t0 = time.perf_counter()
    store._insert_columns(ft, {"__fid__": fids, "geom__x": x, "geom__y": y})
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for tname, index in (("dens", "z2"), ("gdelt", "z3")):
        table = store._tables[tname][index]
        for seg in store.executor.device_index(table).segments:
            if not seg.load_raw(table):
                raise AssertionError(f"{tname}/{index}: no raw device columns")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    streams = density_streams(full)
    data = {"dens": (x, y, None), "gdelt": gdelt}
    t0 = time.perf_counter()
    oracle = {}
    for name, (tname, items, _route) in streams.items():
        for cql, box, during, _wh in items:
            plan = store._plan_cached(tname, Query.cql(cql))
            if plan.index.name != ("z3" if during else "z2"):
                raise AssertionError(f"{name}: {cql} planned on {plan.index.name}")
        oracle[name] = [density_oracle(*data[tname], box, during, w, h)
                        for _c, box, during, (w, h) in items]
    oracle_s = time.perf_counter() - t0
    log(f"config #6: {n} points, ingest {n / ingest_s:,.0f} rec/s; raw columns uploaded in "
        f"{upload_s:.1f} s; density oracle {oracle_s:.1f} s")
    return streams, oracle, {"dens_rows": n, "ingest_rec_per_s": n / ingest_s,
                             "raw_upload_s": upload_s, "oracle_s": oracle_s}


def density_queries(items):
    from geomesa_tpu_torch.index.planner import Query

    return [Query.cql(c, hints=density_hint(box, w, h)) for c, box, _d, (w, h) in items]


def expect_grid(res, want, route, what: str) -> None:
    got = res.aggregate.get("density")
    if got is None or got.shape != want.shape or not np.array_equal(got, want):
        diff = -1 if got is None or got.shape != want.shape else int(np.abs(got - want).sum())
        raise AssertionError(f"{what}: grid differs from the numpy oracle (L1 {diff})")
    path = res.plan.scan_path
    if route == "any":
        return
    if (route is not None and path != route) or (route is None and path == "device-density"):
        raise AssertionError(f"{what}: took {path}")


def density_path(store, streams, oracle, launched):
    """The density streams through the entry points: every query alone
    through ``store.query`` (checked, then timed over the whole stream),
    then the stream through ``query_many`` (timed, checked); every grid
    must equal the numpy oracle and take its stream's route. Each stream
    is a path of its own: the launch counts are zeroed before it and
    read into ``launched[stream]`` after it."""
    from geomesa_tpu_torch.ops import kernels

    out = {}
    for name, (tname, items, route) in streams.items():
        queries = density_queries(items)
        kernels.reset_launches()
        routes = {}
        for i, q in enumerate(queries):
            res = store.query(tname, q)
            expect_grid(res, oracle[name][i], route, f"{name} query {i}")
            routes[res.plan.scan_path] = routes.get(res.plan.scan_path, 0) + 1
        t0 = time.perf_counter()
        for q in queries:
            store.query(tname, q)
        sync_s = (time.perf_counter() - t0) / len(queries)
        t0 = time.perf_counter()
        results = store.query_many(tname, queries)
        pipe_s = (time.perf_counter() - t0) / len(queries)
        for i, res in enumerate(results):
            expect_grid(res, oracle[name][i], route, f"{name} pipelined query {i}")
        launched[name] = (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))
        out[name] = {
            "queries": len(queries),
            "grid": list(items[0][3]),
            "query_ms_sync": sync_s * 1e3,
            "query_ms_pipelined": pipe_s * 1e3,
            "routes": routes,
            "features_in_grid_per_query": float(np.mean([g.sum() for g in oracle[name]])),
        }
        log(f"{name}: {sync_s * 1e3:.3f} ms/query sync, {pipe_s * 1e3:.3f} ms pipelined, "
            f"routes {routes}")
    torch.cuda.synchronize()
    return out


NULL_ROWS, NULL_DATES = 2000, 100
NULL_BOX = (-10.0, -10.0, 10.0, 10.0)
NULL_DURING = "dtg DURING 1969-12-31T12:00:00Z/1970-01-01T12:00:00Z"


def null_dates_check(store) -> dict:
    """A z3 density grid over a table with null dates (stored as 0, the
    epoch, with a ``dtg__null`` mask): a DURING window over the epoch must
    not count them. The grid must take the device route, sum to the row
    query's count and equal a numpy oracle that drops the null dates."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.schema.featuretype import parse_spec

    rng = np.random.default_rng(31)
    n = NULL_ROWS
    x, y = rng.uniform(-20, 20, n), rng.uniform(-20, 20, n)
    t = rng.integers(0, 2 * 86_400_000, n)
    nulls = np.zeros(n, dtype=bool)
    nulls[rng.choice(n, NULL_DATES, replace=False)] = True
    t[nulls] = 0
    ft = parse_spec("nulls", "dtg:Date,*geom:Point:srid=4326")
    store.create_schema(ft)
    store._insert_columns(ft, {"__fid__": np.char.add("f", np.arange(n).astype(str)),
                               "dtg": t, "dtg__null": nulls, "geom__x": x, "geom__y": y})
    cql = f"{bbox_cql(NULL_BOX)} AND {NULL_DURING}"
    m = in_box(x, y, NULL_BOX) & ~nulls & (t < 43_200_000)
    w = (NULL_BOX[2] - NULL_BOX[0]) / 16
    col = np.clip(np.floor((x[m] - NULL_BOX[0]) / w).astype(np.int64), 0, 15)
    row = np.clip(np.floor((y[m] - NULL_BOX[1]) / w).astype(np.int64), 0, 15)
    want = np.bincount(row * 16 + col, minlength=256).reshape(16, 16).astype(np.float64)
    # the route is read off the plan before the row query, which shares it
    res = store.query("nulls", Query.cql(cql, hints=density_hint(NULL_BOX, 16, 16)))
    expect_grid(res, want, "device-density", "null-date heatmap")
    rows = store.query("nulls", Query.cql(cql))
    expect_fids(rows, np.flatnonzero(m), "null-date row query")
    out = {"rows": int(m.sum()), "grid_sum": float(res.aggregate["density"].sum()),
           "null_dates_in_box": int((in_box(x, y, NULL_BOX) & nulls).sum())}
    log(f"null-date heatmap: {out}")
    return out


def density_band_rows(store, streams):
    """Band rows per query the host certifies, per stream (over the queries
    that took the device route)."""
    ex = store.executor
    seen = []
    certify = ex._certify_density_band

    def recorder(table, plan, spec, band, width, height):
        seen.append(sum(len(idx) for _seg, idx in band))
        return certify(table, plan, spec, band, width, height)

    out = {}
    ex._certify_density_band = recorder
    try:
        for name, (tname, items, _route) in streams.items():
            seen.clear()
            results = store.query_many(tname, density_queries(items))
            device = sum(r.plan.scan_path == "device-density" for r in results)
            out[name] = sum(seen) / device if device else None
    finally:
        del ex._certify_density_band
    return out


# -- config #4: the attribute planes -----------------------------------------

ATTR_TABLE = "gdelt_attr"
ATTR_NULL_ROWS = 100_000
# the index each config #4 stream plans on (the reference's choice on the
# same table: tests/test_torch_attr.py): stream (k)'s second half carries
# a DURING, and z3 takes it
ATTR_PLAN_INDEX = {"lone": ["z2"], "j": ["z2"] * ATTR_STREAM, "k": ["z2"] * 8 + ["z3"] * 8}


@contextlib.contextmanager
def timed_table_builds(out):
    """Seconds of each index table's block build during the block
    (``IndexTable.insert_record``: key encode and sort), by index name."""
    from geomesa_tpu_torch.store.blocks import IndexTable

    build = IndexTable.insert_record

    def timed(self, record):
        t0 = time.perf_counter()
        build(self, record)
        out[self.index.name] = out.get(self.index.name, 0.0) + time.perf_counter() - t0

    IndexTable.insert_record = timed
    try:
        yield out
    finally:
        IndexTable.insert_record = build


def config4(store, n):
    """Config #4: ingest N rows of bench_attr_bbox's table (its z3, z2, id
    and attr:actor1 tables, each table's build timed: the attribute table
    adds a lexsort of the rows by (code, z2)), upload the z3 and z2 exact
    columns and the actor1 and goldstein code columns, plan the streams
    (each on the reference's index) and answer them with the numpy
    oracle."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.schema.featuretype import parse_spec

    t0 = time.perf_counter()
    data, rng = synthesize_attr(n)
    streams = attr_streams(rng)
    gen_s = time.perf_counter() - t0
    ft = parse_spec(ATTR_TABLE, ATTR_SPEC)
    store.create_schema(ft)
    if [i.name for i in store._indices[ATTR_TABLE]] != ["z3", "z2", "id", "attr:actor1"]:
        raise AssertionError(f"config #4 indices: {[i.name for i in store._indices[ATTR_TABLE]]}")
    fids = np.char.add("f", np.arange(n).astype(f"<U{len(str(n - 1))}"))
    builds = {}
    t0 = time.perf_counter()
    with timed_table_builds(builds):
        store._insert_columns(ft, attr_columns(data, fids))
    ingest_s = time.perf_counter() - t0
    log(f"config #4 ingest: {n / ingest_s:,.0f} rec/s ({ingest_s:.1f} s; table builds "
        f"{json.dumps({k: round(v, 2) for k, v in builds.items()})} s)")
    t0 = time.perf_counter()
    for name in ("z3", "z2"):
        table = store._tables[ATTR_TABLE][name]
        segs = store.executor.device_index(table).segments
        if len(segs) != 1:
            raise AssertionError(f"config #4 {name}: {len(segs)} segments")
        segs[0].load_exact(table)
        for attr in ("actor1", "goldstein"):
            if not segs[0].load_attr_codes(attr):
                raise AssertionError(f"config #4 {name}: no device codes for {attr}")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    plans = {k: [store._plan_cached(ATTR_TABLE, Query.cql(c)) for c, _ in items]
             for k, items in streams.items()}
    got = {k: [p.index.name for p in ps] for k, ps in plans.items()}
    if got != ATTR_PLAN_INDEX:
        raise AssertionError(f"config #4 plan indices: {got}")
    t0 = time.perf_counter()
    oracle = {k: [attr_oracle(data, spec) for _c, spec in items] for k, items in streams.items()}
    oracle_s = time.perf_counter() - t0
    log(f"config #4 device columns uploaded in {upload_s:.1f} s; oracle {oracle_s:.1f} s")
    return data, streams, plans, oracle, {
        "rows": n, "made_s": gen_s, "ingest_rec_per_s": n / ingest_s, "ingest_s": ingest_s,
        "table_build_s": builds, "upload_s": upload_s, "oracle_s": oracle_s,
    }


def attr_cases(store, plans, launched_shapes):
    """The attribute editions of ``exact_bitmap`` on config #4's z2 / z3
    segments at each shape its path launched them at, with the descriptors
    and code vectors the executor builds: per (stream, index, attribute,
    edition) group the batch and, where a query of it refetched alone (its
    span outgrew the learned window: which ones depends on the data), the
    group's first query at q = 1 with the batch's vector width; and the lone
    query. ``launched_shapes`` = the path's ``LAUNCH_SHAPES``."""
    ex = store.executor
    tables = store._tables[ATTR_TABLE]
    groups = {}  # each stream is its own query_many: its own batches
    for stream in ("lone", "j", "k"):
        for plan in plans[stream]:
            attr, kind, d = ex._attr_batch_desc(tables[plan.index.name], plan)
            groups.setdefault((stream, plan.index.name, attr, kind), []).append(d)
    out, seen = [], set()
    for (_stream, index, attr, kind), descs in groups.items():
        seg = ex.device_index(tables[index]).segments[0]
        vectors = torch.as_tensor(seg._attr_batch_vectors(attr, kind, [x[2] for x in descs]),
                                  device=ex.device)
        for q in dict.fromkeys((len(descs), 1)):
            boxes = torch.as_tensor(np.stack([x[0] for x in descs[:q]]), device=ex.device)
            wins = (torch.as_tensor(np.stack([x[1] for x in descs[:q]]), device=ex.device)
                    if index == "z3" else None)
            case = exact_case(f"exact_bitmap_{index}_{kind}", seg, boxes, wins, "config4",
                              (seg._attr_codes[attr][0], vectors[:q].contiguous(), kind))
            key = (case["name"], case["tag"])
            if key in launched_shapes and key not in seen:
                seen.add(key)
                out.append(case)
    return out


def config4_path(store, streams, oracle):
    """Config #4's main path through the entry points, every query checked
    against the numpy oracle: the lone query ``actor1 = 'USA' AND bbox``
    under ``GEOMESA_SEEK=auto`` (the host seek), then under ``0`` alone
    through ``store.query`` (the candidate mask and the host post-filter,
    the reference's route for a query alone) and through ``query_many``
    (the lone attribute route: ``exact_bitmap`` at q = 1, runs), each
    checked and timed; then streams (j) and (k) through ``query_many``
    (warm, timed with fids unread and read), every query of them on the
    device attribute plane."""
    from collections import Counter

    from geomesa_tpu_torch.index.planner import Query

    lone = streams["lone"][0][0]
    want = oracle["lone"][0]
    out = {"hits_lone": int(len(want))}

    def timed(fn, route, what):
        res = fn()
        expect_fids(res, want, what)
        if res.plan.scan_path != route:
            raise AssertionError(f"{what} took {res.plan.scan_path}, not {route}")
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        return (time.perf_counter() - t0) / 3 * 1e3

    os.environ["GEOMESA_SEEK"] = "auto"
    try:
        out["lone_ms_sync_auto"] = timed(lambda: store.query(ATTR_TABLE, lone), "host-seek",
                                         "config #4 lone query (auto)")
    finally:
        os.environ["GEOMESA_SEEK"] = "0"
    out["lone_ms_sync_mask"] = timed(lambda: store.query(ATTR_TABLE, lone), "device-mask/runs",
                                     "config #4 lone query (store.query)")
    out["lone_ms_attr_route"] = timed(
        lambda: store.query_many(ATTR_TABLE, [Query.cql(lone, properties=[])])[0],
        "device-exact/runs", "config #4 lone query (query_many)")
    for stream in ("j", "k"):
        queries = [Query.cql(c, properties=[]) for c, _ in streams[stream]]
        store.query_many(ATTR_TABLE, queries)  # warm: span window learning
        t0 = time.perf_counter()
        results = store.query_many(ATTR_TABLE, queries)
        pipe_s = (time.perf_counter() - t0) / len(queries)
        routes = Counter(r.plan.scan_path for r in results)
        for i, (r, rows) in enumerate(zip(results, oracle[stream])):
            expect_fids(r, rows, f"config #4 stream ({stream}) query {i}")
        if set(routes) != {"device-exact/bitmap"}:
            raise AssertionError(f"config #4 stream ({stream}) left the attribute plane: {routes}")
        out[f"stream_{stream}"] = {
            "queries": len(queries),
            "query_ms_pipelined": pipe_s * 1e3,
            "query_ms_pipelined_fids_read": timed_fids_read(store, ATTR_TABLE, queries) * 1e3,
            "hits_per_query": sum(len(r) for r in results) / len(results),
            "routes": dict(routes),
        }
    log(f"config #4 path: {json.dumps(out)}")
    return out


def attr_nulls_check(store) -> dict:
    """A small table with null actors and NaN goldstein on the card, under
    ``GEOMESA_SEEK=0``: ``goldstein IS [NOT] NULL``, ``actor1 <> 'USA'`` and
    ``actor1 IN ('ZZZ', 'RUS')`` (a literal the segment lacks: the code -2)
    AND a box on the device attribute plane, ``actor1 = 'ZZZ'`` on the
    host's attr:actor1 route (its estimate is 0 rows), each equal to
    numpy."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.schema.featuretype import parse_spec

    data, cols = attr_null_table(ATTR_NULL_ROWS)
    ft = parse_spec("attr_nulls", ATTR_SPEC)
    store.create_schema(ft)
    store._insert_columns(ft, cols)
    cqls = attr_null_queries()
    results = store.query_many("attr_nulls", [Query.cql(c, properties=[]) for c in cqls])
    out = {}
    for cql, r, (_oracle, device) in zip(cqls, results, ATTR_NULL_QUERIES.values()):
        rows = attr_null_oracle(data, cql)
        expect_fids(r, rows, f"attr nulls: {cql}", prefix="n")
        if r.plan.scan_path.startswith("device-exact/") != device:
            raise AssertionError(f"attr nulls: {cql} took {r.plan.scan_path}")
        out[cql.split(" AND bbox", 1)[0]] = {"rows": int(len(rows)), "route": r.plan.scan_path}
    log(f"attr nulls: {json.dumps(out)}")
    return out


# -- config #5: kNN and TubeSelect; the polygon plane ------------------------

# lane operations of the kNN distance a row (knn_topk.cu dist_bits), counted
# from ``cuobjdump -sass`` of the pass that evaluates it, built for sm_90a:
# the distance's fast path is 153 instructions (176 with the earlier tile
# design's key and loop), 92 of them on the FP32 pipe (the two sinf, the cosf, the sqrtf and
# the asinf, the multiplies, adds and the clamp: 38 FFMA, 21 FMUL, 12 FSEL,
# 9 FSETP, 3 FADD, 1 FMNMX, 3 F2I, 3 I2FP, 2 MUFU); the bound counts those
# 92 at the FP32 rate and a key's packing (6) at the INT32 rate, and leaves
# out addressing and the loop
KNN_ROW_FOPS = 92
KNN_ROW_IOPS = 6
# per enveloped row and non-degenerate edge (poly_dual_bitmap.cu ray_cast),
# counted the same way from its cast kernel: the straddle and vertex-band
# tests, 6 on the FP32 pipe (two subtractions, four compares); and per
# enveloped row and edge it straddles, the crossing: 12 more (the IEEE
# division's reciprocal, check and five Newton FFMAs, xint's multiply and
# add, the subtraction and two compares of the crossing and the x band).
# The bound counts those at the FP32 rate and the crossing count and band
# updates (4 a row and edge) at the INT32 rate
POLY_EDGE_FOPS = 6
POLY_STRADDLE_FOPS = 12
POLY_EDGE_IOPS = 4


def config5(store, n):
    """Config #5: bench_knn's N points in KNN_TABLE (z3, z2, id), the
    device columns of its z3 table (the kNN's f32 coordinates, the sort
    keys of stream (m)), and the f64 oracle's answers of (n), (o), (p) and
    (m)."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.schema.featuretype import parse_spec

    x, y, t = synthesize_knn(n)
    ft = parse_spec(KNN_TABLE, KNN_SPEC)
    store.create_schema(ft)
    fids = np.char.add("f", np.arange(n).astype(f"<U{len(str(n - 1))}"))
    t0 = time.perf_counter()
    store._insert_columns(ft, {"__fid__": fids, "geom__x": x, "geom__y": y, "dtg": t})
    ingest_s = time.perf_counter() - t0
    log(f"config #5 ingest: {n / ingest_s:,.0f} rec/s ({ingest_s:.1f} s)")
    table = store._tables[KNN_TABLE]["z3"]
    t0 = time.perf_counter()
    for seg in store.executor.device_index(table).segments:
        if not seg.load_poly(table):
            raise AssertionError("config #5: no polygon columns on z3")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    base_ms = np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64)
    track = tube_track(int(base_ms) + 10 * 86400_000)
    oracle = {"n": knn_oracle(haversine_np(x, y, *KNN_QUERY), KNN_K), "o": {}}
    for pt in knn_points():
        d = haversine_np(x, y, *pt)
        for k in KNN_KS:
            oracle["o"][(pt, k)] = knn_oracle(d, k)
    oracle["p"] = [tube_oracle(x, y, t, track, b, tb) for b, tb in TUBE_BUFFERS]
    streams = poly_streams()
    oracle["m"] = [poly_oracle(x, y, t, rings, True) for _c, rings in streams["m"]]
    plans = [store._plan_cached(KNN_TABLE, Query.cql(c)) for c, _r in streams["m"]]
    if {p.index.name for p in plans} != {"z3"}:
        raise AssertionError(f"stream (m) planned on {[p.index.name for p in plans]}")
    oracle_s = time.perf_counter() - t0
    log(f"config #5 device columns uploaded in {upload_s:.1f} s; oracle {oracle_s:.1f} s; "
        f"tube hits {[len(r) for r in oracle['p']]}")
    return (x, y, t), track, oracle, plans, {
        "rows": n, "ingest_rec_per_s": n / ingest_s, "ingest_s": ingest_s,
        "upload_s": upload_s, "oracle_s": oracle_s,
        "indices": [i.name for i in store._indices[KNN_TABLE]],
    }


def expect_knn(got, want, what: str) -> None:
    """A kNN answer equal to the oracle's: the same fids in the same order,
    the same distances (both f64 haversines of the same coordinates), and
    on the device top-k."""
    from geomesa_tpu_torch.process import last_knn_path

    if [f for f, _ in got] != [f for f, _ in want] or any(
            abs(a - b) > 1e-9 * max(1.0, b) for (_f, a), (_g, b) in zip(got, want)):
        raise AssertionError(f"{what}: differs from f64 brute force ({len(got)} vs {len(want)})")
    if last_knn_path() != "device-topk":
        raise AssertionError(f"{what} took {last_knn_path()}")


def config5_path(store, track, oracle):
    """Config #5's main path through the entry points under
    ``GEOMESA_KNN_DEVICE`` auto (the device, on a CUDA card with a local
    link): (n) bench_knn's query, KNN_REPS calls timed; (o) the 16 query
    points at each k in KNN_KS; (p) TubeSelect of one track with the
    reference's default buffers, then wide ones. Every answer equals the
    f64 oracle's and every kNN call reports ``device-topk``."""
    from geomesa_tpu_torch.process import knn_search, tube_select

    out = {}
    expect_knn(knn_search(store, KNN_TABLE, *KNN_QUERY, k=KNN_K), oracle["n"], "(n) warm")
    times = []
    for i in range(KNN_REPS):
        t0 = time.perf_counter()
        got = knn_search(store, KNN_TABLE, *KNN_QUERY, k=KNN_K)
        times.append(time.perf_counter() - t0)
        expect_knn(got, oracle["n"], f"(n) call {i}")
    out["n_ms_per_query"] = sum(times) / len(times) * 1e3
    out["n_ms_min"] = min(times) * 1e3
    out["n_features_per_s"] = store._tables[KNN_TABLE]["z3"].num_rows / (sum(times) / len(times))
    per_k = {k: [] for k in KNN_KS}
    for pt in knn_points():
        for k in KNN_KS:
            t0 = time.perf_counter()
            got = knn_search(store, KNN_TABLE, *pt, k=k)
            per_k[k].append(time.perf_counter() - t0)
            expect_knn(got, oracle["o"][(pt, k)], f"(o) {pt} k={k}")
    out["o_ms_per_query"] = {k: sum(v) / len(v) * 1e3 for k, v in per_k.items()}
    out["p"] = []
    for (buf, tbuf), want in zip(TUBE_BUFFERS, oracle["p"]):
        t0 = time.perf_counter()
        res = tube_select(store, KNN_TABLE, track, buffer_m=buf, time_buffer_ms=tbuf)
        ms = (time.perf_counter() - t0) * 1e3
        expect_fids(res, want, f"(p) tube {buf} m / {tbuf} ms")
        out["p"].append({"buffer_m": buf, "time_buffer_ms": tbuf, "ms": ms,
                         "hits": int(len(res)), "scan_path": res.plan.scan_path})
    log(f"config #5 path: {json.dumps(out)}")
    return out


def knn_stream(store, points=(KNN_QUERY,) * KNN_REPS, k: int = KNN_K):
    """A kNN search at each of ``points`` (by default bench_knn's query
    KNN_REPS times, stream (n)): (answers, the paths that took them)."""
    from geomesa_tpu_torch.process import knn_search, last_knn_path

    out, paths = [], set()
    for pt in points:
        out.append(knn_search(store, KNN_TABLE, *pt, k=k))
        paths.add(last_knn_path())
    return out, sorted(paths)


def config_poly(store, n, knn_plans):
    """The polygon plane: bench_poly's N points in POLY_TABLE (z2), its
    device columns (sort keys and f32 coordinates), the plans of the lone
    star and stream (l), and the f64 oracle's answers."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.schema.featuretype import parse_spec

    x, y = synthesize_poly(n)
    ft = parse_spec(POLY_TABLE, POLY_SPEC)
    store.create_schema(ft)
    fids = np.char.add("f", np.arange(n).astype(f"<U{len(str(n - 1))}"))
    t0 = time.perf_counter()
    store._insert_columns(ft, {"__fid__": fids, "geom__x": x, "geom__y": y})
    ingest_s = time.perf_counter() - t0
    log(f"polygon table ingest: {n / ingest_s:,.0f} rec/s ({ingest_s:.1f} s)")
    table = store._tables[POLY_TABLE]["z2"]
    t0 = time.perf_counter()
    for seg in store.executor.device_index(table).segments:
        if not seg.load_poly(table):
            raise AssertionError("polygon table: no polygon columns on z2")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    streams = poly_streams()
    plans = {k: [store._plan_cached(POLY_TABLE, Query.cql(c)) for c, _r in streams[k]]
             for k in ("lone", "l")}
    plans["m"] = knn_plans
    if {p.index.name for k in ("lone", "l") for p in plans[k]} != {"z2"}:
        raise AssertionError("polygon plans left z2")
    t0 = time.perf_counter()
    oracle = {k: [poly_oracle(x, y, None, rings, False) for _c, rings in streams[k]]
              for k in ("lone", "l")}
    oracle_s = time.perf_counter() - t0
    log(f"polygon device columns uploaded in {upload_s:.1f} s; oracle {oracle_s:.1f} s")
    return streams, plans, oracle, {
        "rows": n, "ingest_rec_per_s": n / ingest_s, "ingest_s": ingest_s,
        "upload_s": upload_s, "oracle_s": oracle_s,
        "indices": [i.name for i in store._indices[POLY_TABLE]],
    }


def poly_path(store, streams, oracle):
    """The polygon plane's main path through the entry points: the lone
    star through ``store.query`` under ``GEOMESA_SEEK=auto`` (the host
    seek: its envelope covers ~1.3% of the table) and under ``0`` (the
    candidate mask and the host post-filter, the reference's route for a
    polygon alone), each checked and timed; stream (l) through
    ``query_many`` (warm, timed with fids unread and read) and stream (m)
    on config #5's z3 table, every query on ``device-batch-dual/bitmap``.
    Every answer equals the f64 even-odd oracle's."""
    from collections import Counter

    from geomesa_tpu_torch.index.planner import Query

    out = {}
    lone, _rings = streams["lone"][0]

    def timed(route, what):
        res = store.query(POLY_TABLE, lone)
        expect_fids(res, oracle["lone"][0], what)
        if res.plan.scan_path != route:
            raise AssertionError(f"{what} took {res.plan.scan_path}, not {route}")
        t0 = time.perf_counter()
        for _ in range(3):
            store.query(POLY_TABLE, lone)
        return (time.perf_counter() - t0) / 3 * 1e3

    os.environ["GEOMESA_SEEK"] = "auto"
    try:
        out["lone_ms_sync_auto"] = timed("host-seek", "lone star (auto)")
    finally:
        os.environ["GEOMESA_SEEK"] = "0"
    out["lone_ms_sync_mask"] = timed("device-mask/runs", "lone star (GEOMESA_SEEK=0)")
    out["hits_lone"] = int(len(oracle["lone"][0]))
    for name, table in (("l", POLY_TABLE), ("m", KNN_TABLE)):
        queries = [Query.cql(c, properties=[]) for c, _r in streams[name]]
        store.query_many(table, queries)  # warm: span window learning
        t0 = time.perf_counter()
        results = store.query_many(table, queries)
        pipe_s = (time.perf_counter() - t0) / len(queries)
        routes = Counter(r.plan.scan_path for r in results)
        for i, (r, rows) in enumerate(zip(results, oracle[name])):
            expect_fids(r, rows, f"polygon stream ({name}) query {i}")
        if set(routes) != {"device-batch-dual/bitmap"}:
            raise AssertionError(f"polygon stream ({name}) left the dual plane: {routes}")
        out[f"stream_{name}"] = {
            "queries": len(queries),
            "query_ms_pipelined": pipe_s * 1e3,
            "query_ms_pipelined_fids_read": timed_fids_read(store, table, queries) * 1e3,
            "hits_per_query": sum(len(r) for r in results) / len(results),
            "routes": dict(routes),
        }
    log(f"polygon path: {json.dumps(out)}")
    return out


def knn_cases(store, launched_shapes):
    """``knn_topk`` on config #5's z3 segment at each k its path launched
    (k plus the certificate's margin), for bench_knn's query point.

    Bound: bytes, the f32 coordinates and valid read once (9 B a row) and
    the rows written; operations, KNN_ROW_FOPS at the FP32 rate and
    KNN_ROW_IOPS at the INT32 rate a row. ``topk_ms`` times ``torch.topk``
    of the kernel's own distances (the selection alone; no single PyTorch
    call computes distance and selection), the entry's ``library_ms``."""
    from geomesa_tpu_torch.ops import kernels

    seg = store.executor.device_index(store._tables[KNN_TABLE]["z3"]).segments[0]
    n = seg.n_padded
    d = kernels.knn_distances(seg.xf, seg.yf, seg.valid, *KNN_QUERY)
    out = []
    for name, tag in sorted(k for k in launched_shapes if k[0] == "knn_topk"):
        kk = int(tag.split("=")[1])
        out.append(dict(
            name=name, path="config5", tag=tag, symbol="knn_topk_",
            replaces="geomesa_tpu/parallel/executor.py:2210",
            source="geomesa_tpu_torch/csrc/knn_topk.cu",
            kernel=lambda kk=kk: (kernels.knn_topk(seg.xf, seg.yf, seg.valid, *KNN_QUERY, kk),),
            plain=lambda kk=kk: (kernels.knn_topk_plain(seg.xf, seg.yf, seg.valid, *KNN_QUERY,
                                                        kk),),
            bytes=9 * n + 8 * kk,
            ops=KNN_ROW_IOPS * n,
            fops=KNN_ROW_FOPS * n,
            aside={"topk_ms": lambda kk=kk: torch.topk(d, kk, largest=False)},
            library="topk_ms",
            # the passes of a call, as the loaded build's launcher reports them
            launches=lambda kk=kk: (kernels.knn_topk(seg.xf, seg.yf, seg.valid, *KNN_QUERY, kk),
                                    kernels.LAST_PASSES["knn_topk"])[1],
            shape=f"rows={n} k={kk} query={KNN_QUERY}",
        ))
    return out


def poly_case(store, table, descs, has_time, path, plane=None, mask=False):
    """One ``poly_dual_bitmap`` shape: the descriptors of ``descs`` (the
    executor's ``_poly_batch_desc``) as ``dispatch_poly_batch`` pads them;
    ``plane`` = (codes, qcodes, edition) adds the attribute test, which the
    bound counts as ``dual_case`` does, on the envelope words; ``mask``
    times the coalescer's ``dual_mask_batch("poly")`` (the same kernels,
    their planes alone) against its own plain edition instead.

    Bound, counted from this run's data: bytes, the key columns and valid
    read once, the f32 coordinates of every row that some query's envelope
    holds, both planes written; operations (``point_cases``'s rule), per
    row and query the two planes' stores, per 32-row word holding an
    envelope row of a query that query's envelope chain and ballots, per
    enveloped row and non-degenerate edge of its query POLY_EDGE_FOPS
    (FP32) and POLY_EDGE_IOPS (INT32), and per enveloped row and edge it
    straddles POLY_STRADDLE_FOPS (FP32)."""
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.filters import attr_combine, exact_st_mask
    from geomesa_tpu_torch.parallel.executor import _pow2_at_least

    dev = store.executor.device
    seg = store.executor.device_index(table).segments[0]
    q = len(descs)
    ecap = _pow2_at_least(max(len(d[0]) for d in descs), 8)
    edges = np.zeros((q, ecap, 4), np.float32)
    for i, d in enumerate(descs):
        edges[i, :len(d[0])] = d[0]
    edges = torch.as_tensor(edges, device=dev)
    boxes = torch.as_tensor(np.stack([d[1] for d in descs]), device=dev)
    wins = torch.as_tensor(np.stack([d[2] for d in descs]), device=dev) if has_time else None
    xk, yk, valid, xf, yf, tk = seg._poly_cols(has_time)
    n = seg.n_padded
    codes, qcodes, kind = plane if plane is not None else (None, None, None)
    env_any = torch.zeros(n, dtype=torch.bool, device=dev)
    word_any = torch.zeros(n // 32, dtype=torch.bool, device=dev)
    env_words = env_rows = edge_rows = straddle_rows = live_pairs = 0
    for i, d in enumerate(descs):
        env = exact_st_mask(xk, yk, valid, boxes[i], tk, None if wins is None else wins[i])
        word_any |= env.view(-1, 32).any(1)
        if plane is not None:
            env = attr_combine(env, codes, qcodes[i], kind)
        env_any |= env
        rows = int(env.sum())
        env_rows += rows
        env_words += int(env.view(-1, 32).any(1).sum())
        live_pairs += int(torch.nn.functional.pad(env, (0, -n % 128)).view(-1, 128).any(1).sum())
        e = d[0]
        e = torch.as_tensor(e[~((e[:, 0] == e[:, 2]) & (e[:, 1] == e[:, 3]))], device=dev)
        edge_rows += rows * e.shape[0]
        fy = yf[env][:, None]
        straddle_rows += int(((e[:, 1] > fy) != (e[:, 3] > fy)).sum())
    key = 8 * (3 if has_time else 2)
    chain = 2 * (6 if has_time else 4)
    attr_bytes = attr_ops = 0
    if plane is not None:
        attr_bytes = 4 * 32 * int(word_any.sum()) + qcodes.numel() * qcodes.element_size()
        attr_ops = ATTR_TEST_OPS[kind](qcodes.shape[1])
    tag = f"q={q} E={ecap}{_attr_tag(kind, qcodes)}"
    args = (xk, yk, valid, xf, yf, edges, boxes, wins, tk, codes, qcodes, kind)
    if mask:
        kernel = lambda: kernels.dual_mask_batch("poly", *args)  # noqa: E731
        plain = lambda: kernels.dual_mask_batch_plain("poly", *args)  # noqa: E731
    else:
        kernel = lambda: kernels.poly_dual_bitmap(*args)  # noqa: E731
        plain = lambda: kernels.poly_dual_bitmap_plain(*args)  # noqa: E731
    return dict(
        name=("poly_mask_batch_" if mask else "poly_dual_bitmap_") + ("z3" if has_time else "z2")
        + (f"_{kind}" if kind else ""),
        path=path, tag=tag, symbol="poly_dual_bitmap_",
        replaces="geomesa_tpu/parallel/executor.py:" + ("569" if mask else "2110"),
        source="geomesa_tpu_torch/csrc/poly_dual_bitmap.cu",
        kernel=kernel,
        plain=plain,
        no_ab=plane is not None or mask,
        bytes=n * (key + 1) + 8 * int(env_any.sum()) + 2 * q * n // 8 + edges.numel() * 4
              + attr_bytes,
        ops=2 * q * n + 32 * env_words * (chain + 2 + attr_ops) + POLY_EDGE_IOPS * edge_rows,
        fops=POLY_EDGE_FOPS * edge_rows + POLY_STRADDLE_FOPS * straddle_rows,
        # the (chunk, query) pairs whose envelope holds a row: the cast's work items
        extra={"env_rows": env_rows, "edge_rows": edge_rows, "straddle_rows": straddle_rows,
               "live_pairs": live_pairs},
        shape=f"rows={n} q={q} E={ecap} env_rows={env_rows} edge_rows={edge_rows}"
              + (" time" if has_time else "") + (f" {kind}" if kind else ""),
    )


def poly_cases(store, plans, launched_shapes):
    """``poly_dual_bitmap`` at each shape the polygon path launched: the
    batches of streams (l) (z2) and (m) (z3) as ``dispatch_poly_batch``
    pads them and, where a query refetched alone (its span outgrew the
    learned window: the data decides which), the stream's first query at
    q = 1 with the batch's padded edge list."""
    from geomesa_tpu_torch.parallel.executor import _pow2_at_least

    ex = store.executor
    out, seen = [], set()
    for stream, table_name, index in (("l", POLY_TABLE, "z2"), ("m", KNN_TABLE, "z3")):
        table = store._tables[table_name][index]
        descs = [ex._poly_batch_desc(table, p)[:3] for p in plans[stream]]
        batch = descs + [descs[-1]] * ((len(descs) + 3) // 4 * 4 - len(descs))
        ecap = _pow2_at_least(max(len(d[0]) for d in descs), 8)
        first = descs[0]
        lone = [(np.concatenate([first[0], np.zeros((ecap - len(first[0]), 4), np.float32)]),)
                + tuple(first[1:])]
        for group in (batch, lone):
            case = poly_case(store, table, group, index == "z3", "poly")
            key = (case["name"], case["tag"])
            if key in launched_shapes and key not in seen:
                seen.add(key)
                out.append(case)
    return out


# -- count, stats and the attribute editions of the dual planes --------------

# stream (a'): bench_xz2's jittered boxes (another seed) AND kind = X on
# config #3's table; stream (l'): jittered stars AND actor1 = X on config
# #4's table
KIND_STREAM = 8
POLY_ATTR_STREAM = 8
# bench_attr_bbox's stats query, and the goldstein bounds of the range counts
STATS_SPEC = "Count();MinMax(goldstein);TopK(actor1)"
GOLD_RANGE = (-2.5, 4.0)
COUNT_REPS = 3


def kind_stream(reps: int = KIND_STREAM):
    """Stream (a'): [(cql, box, kind)], box i of bench_xz2's jitter
    (default_rng(72)) AND ``kind = X``, X cycling line, polygon, rect."""
    kinds = ("line", "polygon", "rect")
    return [(f"kind = '{kinds[i % 3]}' AND {xz_bbox_cql(b)}", b, kinds[i % 3])
            for i, b in enumerate(xz2_boxes(reps, seed=72))]


def kind_oracle(ways, box, kinds) -> np.ndarray:
    """Rows of ``box`` (``oracle_rows``) whose way is of one of ``kinds``."""
    rows = oracle_rows(ways, [box])
    return rows[np.isin(KIND_NAMES[ways["kind"][rows].astype(np.int64) + 1], kinds)]


def poly_attr_stream(reps: int = POLY_ATTR_STREAM):
    """Stream (l'): [(cql, rings, actor)], bench_poly's star jittered +-6
    deg (default_rng(97)) AND ``actor1 = X``, X cycling USA, CHN, RUS."""
    jit = np.random.default_rng(97)
    out = []
    for i in range(reps):
        dx, dy = jit.uniform(-6, 6, 2)
        ring = star(2.0 + dx, 10.0 + dy, 14.0)
        actor = ATTR_ACTORS[i % 3]
        out.append((f"actor1 = '{actor}' AND intersects(geom, POLYGON ({ring_wkt(ring)}))",
                    [ring], actor))
    return out


def gold_range_cql(geometry: str) -> str:
    return f"goldstein > {GOLD_RANGE[0]} AND goldstein <= {GOLD_RANGE[1]} AND {geometry}"


def count_items(data1, streams1, ways, poly_lone, poly_rows, data4):
    """The counts of the count phase: name -> (table, [(cql, oracle rows)]).
    Config #1's 20 jittered ``bbox AND DURING`` (``exact_count`` z3);
    bench_xz2's count on config #3's table (the q = 1 dual planes) and the
    same box AND ``kind >= 'polygon'`` (their range edition); bench_poly's
    star (the q = 1 ray cast); on config #4's table ``actor1 = 'USA' AND
    bbox`` and a goldstein range AND bbox (``exact_count`` z2 member,
    range) and the star AND the goldstein range (the ray cast's range
    edition)."""
    x, y, t = data1
    x4, y4, gold = data4["x"], data4["y"], data4["gold"]
    in_gold = (gold > GOLD_RANGE[0]) & (gold <= GOLD_RANGE[1])
    lone_cql, lone_rings = poly_lone
    star_rows = pip(lone_rings, x4, y4)
    boxes, cqls = streams1["config1"]
    return {
        "config1": ("gdelt", [(c, brute_force(x, y, t, b)) for b, c in zip(boxes, cqls)]),
        "xz2": ("ways", [(xz_bbox_cql(XZ2_BOX), oracle_rows(ways, [XZ2_BOX])),
                         (f"kind >= 'polygon' AND {xz_bbox_cql(XZ2_BOX)}",
                          kind_oracle(ways, XZ2_BOX, ("polygon", "rect")))]),
        "poly": (POLY_TABLE, [(lone_cql, poly_rows)]),
        "config4": (ATTR_TABLE, [
            (f"actor1 = 'USA' AND {bbox_cql(ATTR_BOX)}",
             attr_oracle(data4, (ATTR_BOX, ("USA",), None, False))),
            (gold_range_cql(bbox_cql(ATTR_BOX)), attr_oracle(data4, (ATTR_BOX, None, GOLD_RANGE,
                                                                      False))),
            (gold_range_cql(lone_cql[lone_cql.index("intersects"):]),
             star_rows[in_gold[star_rows]]),
        ]),
    }


def count_path(store, items):
    """The count push-down through ``store.count`` under
    ``GEOMESA_COUNT_DEVICE=1``: every count of ``items`` (``count_items``)
    equal to its oracle's rows, its plan answered by ``count_scan`` (not
    the host), and timed: ms per count, sync (COUNT_REPS rounds of the
    name's counts after a checked one)."""
    from geomesa_tpu_torch.index.planner import Query

    out = {}
    os.environ["GEOMESA_COUNT_DEVICE"] = "1"
    try:
        for name, (table, qs) in items.items():
            for i, (cql, rows) in enumerate(qs):
                got = store.count(table, cql)
                if got != len(rows):
                    raise AssertionError(f"count {name} {i}: {got} against the oracle's "
                                         f"{len(rows)} ({cql[:80]})")
                plan = store._plan_cached(table, Query.cql(cql))
                if store.executor.count_scan(store._tables[table][plan.index.name],
                                             plan) is None:
                    raise AssertionError(f"count {name} {i}: the device count declined")
            t0 = time.perf_counter()
            for _ in range(COUNT_REPS):
                for cql, _rows in qs:
                    store.count(table, cql)
            out[name] = {
                "counts": len(qs),
                "count_ms_sync": (time.perf_counter() - t0) * 1e3 / (COUNT_REPS * len(qs)),
                "rows_counted": [int(len(r)) for _c, r in qs],
            }
    finally:
        os.environ.pop("GEOMESA_COUNT_DEVICE", None)
    log(f"count path: {json.dumps(out)}")
    return out


def stats_path(store, data4):
    """bench_attr_bbox's stats push-down, ``STATS_SPEC`` on ``ATTR_BOX``,
    under ``GEOMESA_STATS_DEVICE=1`` (warm, then timed: ms per query, sync)
    with bench_attr_bbox's parity (the count, goldstein's min and max, and
    the top 5 actors against ``np.unique``); then under ``auto``, the path
    it takes recorded (``auto_stats_path``) and its parity checked too."""
    from geomesa_tpu_torch.index.planner import Query

    m = in_box(data4["x"], data4["y"], ATTR_BOX)
    uniq, cnt = np.unique(data4["actors"][m].astype(str), return_counts=True)
    gold = data4["gold"][m]

    def check(res, what):
        seq = res.aggregate["stats"].stats
        ok = (seq[0].count == int(m.sum()) and float(seq[1].min) == float(gold.min())
              and float(seq[1].max) == float(gold.max())
              and dict(seq[2].topk(5)) == dict(zip(uniq.tolist(), cnt.astype(int).tolist())))
        if not ok:
            raise AssertionError(f"{what}: stats parity failed: {res.aggregate['stats'].to_json()[:300]}")

    q = Query.cql(bbox_cql(ATTR_BOX), hints={"stats": STATS_SPEC})
    out = {}
    os.environ["GEOMESA_STATS_DEVICE"] = "1"
    try:
        res = store.query(ATTR_TABLE, q)
        check(res, "stats (GEOMESA_STATS_DEVICE=1)")
        if res.plan.scan_path != "device-stats":
            raise AssertionError(f"stats took {res.plan.scan_path}")
        t0 = time.perf_counter()
        for _ in range(COUNT_REPS):
            store.query(ATTR_TABLE, q)
        out["device_stats_ms"] = (time.perf_counter() - t0) * 1e3 / COUNT_REPS
        out["device_stats_path"] = res.plan.scan_path
    finally:
        os.environ.pop("GEOMESA_STATS_DEVICE", None)
    res = store.query(ATTR_TABLE, q)
    check(res, "stats (auto)")
    out["auto_stats_path"] = res.plan.scan_path
    out["rows_in_box"] = int(m.sum())
    log(f"stats path: {json.dumps(out)}")
    return out


def dual_attr_path(store, ways, data4):
    """Streams (a') and (l') through ``query_many`` (warm, then timed), every
    query on ``device-batch-dual/bitmap`` (the dual planes' attribute
    editions) and equal to its oracle: (a') ``kind_oracle``, (l') the f64
    even-odd ``pip`` AND the actor."""
    from geomesa_tpu_torch.index.planner import Query

    out = {}
    streams = {
        "a_prime": ("ways", [(c, kind_oracle(ways, b, (k,))) for c, b, k in kind_stream()]),
        "l_prime": (ATTR_TABLE, [(c, pip(rings, data4["x"], data4["y"])) for c, rings, _a
                                 in poly_attr_stream()]),
    }
    actor_of = [a for _c, _r, a in poly_attr_stream()]
    for name, (table, items) in streams.items():
        queries = [Query.cql(c, properties=[]) for c, _rows in items]
        store.query_many(table, queries)  # warm: span window learning
        t0 = time.perf_counter()
        results = store.query_many(table, queries)
        pipe_s = (time.perf_counter() - t0) / len(queries)
        for i, (r, (_c, rows)) in enumerate(zip(results, items)):
            if name == "l_prime":
                rows = rows[data4["actors"][rows] == actor_of[i]]
            expect_fids(r, rows, f"stream ({name}) query {i}",
                        prefix="w" if table == "ways" else "f")
            if r.plan.scan_path != "device-batch-dual/bitmap":
                raise AssertionError(f"stream ({name}) query {i} took {r.plan.scan_path}")
        out[name] = {
            "queries": len(queries),
            "query_ms_pipelined": pipe_s * 1e3,
            "hits_per_query": sum(len(r) for r in results) / len(results),
        }
    log(f"dual attribute path: {json.dumps(out)}")
    return out


def count_case(name, seg, box, win, path, plane=None):
    """One ``exact_count`` shape (q = 1); ``plane`` = (codes, qcodes,
    edition) adds the attribute test. Bound: bytes, the key columns and
    valid once (25 B a row with the window, 17 B without) and the 4 B code
    of every row of a 32-row word where the box test holds a row; the
    operations of ``exact_case`` for those words (the compare chain and
    the attribute test), with no ballot or store."""
    from geomesa_tpu_torch.ops import kernels

    n = seg.n_padded
    xk, yk, tk, valid = seg._exact_cols(win is not None)
    codes, qcodes, kind = plane if plane is not None else (None, None, None)
    key = 8 * (3 if win is not None else 2)
    box_bits = kernels.exact_bitmap_plain(xk, yk, tk, valid, box[None],
                                          None if win is None else win[None])[0]
    hit_words = int((box_bits.view(n // 32, 4) != 0).any(-1).sum())
    chain = 2 * (6 if win is not None else 4)
    attr_bytes = attr_ops = 0
    if plane is not None:
        attr_bytes = 4 * 32 * hit_words + qcodes.numel() * qcodes.element_size()
        attr_ops = ATTR_TEST_OPS[kind](qcodes.shape[1])
    return dict(
        name=name, path=path, tag=f"q=1{_attr_tag(kind, qcodes)}",
        symbol="exact_bitmap_kernel",
        replaces="geomesa_tpu/parallel/executor.py:638",
        source="geomesa_tpu_torch/csrc/exact_bitmap.cu",
        kernel=lambda: (kernels.exact_count(xk, yk, tk, valid, box, win, codes, qcodes, kind),),
        plain=lambda: (kernels.exact_count_plain(xk, yk, tk, valid, box, win, codes, qcodes,
                                                 kind),),
        no_ab=True,
        bytes=n * (key + 1) + 4 + attr_bytes,
        ops=32 * hit_words * (chain + attr_ops + 1),
        extra={"hit_words": hit_words},
        shape=f"rows={n} hit_words={hit_words}" + (" time" if win is not None else "")
              + (f" {kind}" if kind else ""),
    )


def hist_case(seg, box, win, attr, path):
    """One ``exact_stat_hist`` shape: q = 1, ``attr``'s codes and bins
    (``u_pad``, as ``stat_hist_start`` sizes them). Bound: bytes, the key
    columns and valid once, the 4 B code of every row of a 32-row word
    where the box test holds a row, the bins written once; operations, the
    compare chain and a bin add per row of those words. ``bincount_ms``
    times ``torch.bincount`` of the same hits' codes, already masked (the
    histogram alone; no single PyTorch call computes the function), the
    entry's ``library_ms``."""
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.ops.filters import exact_st_mask
    from geomesa_tpu_torch.parallel.executor import _pow2_at_least

    n = seg.n_padded
    xk, yk, tk, valid = seg._exact_cols(win is not None)
    codes, unified = seg._attr_codes[attr]
    u_pad = _pow2_at_least(len(unified), 8)
    key = 8 * (3 if win is not None else 2)
    m = exact_st_mask(xk, yk, valid, box, tk, win)
    hit_words = int(m.view(-1, 32).any(1).sum())
    live = codes[m & (codes >= 0)].to(torch.int64)
    chain = 2 * (6 if win is not None else 4)
    name = "exact_stat_hist_" + ("z3" if win is not None else "z2")
    return dict(
        name=name, path=path, tag=f"q=1 U={u_pad}", symbol="exact_bitmap_kernel",
        replaces="geomesa_tpu/parallel/executor.py:658",
        source="geomesa_tpu_torch/csrc/exact_bitmap.cu",
        kernel=lambda: (kernels.exact_stat_hist(xk, yk, tk, valid, box, win, codes, u_pad),),
        plain=lambda: (kernels.exact_stat_hist_plain(xk, yk, tk, valid, box, win, codes,
                                                     u_pad),),
        no_ab=True,
        bytes=n * (key + 1) + 4 * 32 * hit_words + 4 * (1 + u_pad),
        ops=32 * hit_words * (chain + 2),
        aside={"bincount_ms": lambda: torch.bincount(live, minlength=u_pad)},
        library="bincount_ms",
        extra={"hit_words": hit_words, "attribute": attr, "values": int(len(unified))},
        shape=f"rows={n} U={u_pad} ({attr}, {len(unified)} values) hit_words={hit_words}",
    )


def _plan_of(store, table_name, cql):
    """(index table, plan) of one query."""
    from geomesa_tpu_torch.index.planner import Query

    p = store._plan_cached(table_name, Query.cql(cql))
    return store._tables[table_name][p.index.name], p


def _up(store, a):
    return torch.as_tensor(np.ascontiguousarray(a), device=store.executor.device)


def count_cases(store, items, path):
    """[(path, case)]: the kernel each count of ``items`` (name -> (table,
    [(cql, rows)])) launches on the device count, at its descriptor:
    ``exact_count`` (with its attribute edition), the q = 1 dual planes of
    an extent table or the q = 1 ray cast of a polygon."""
    from geomesa_tpu_torch.parallel.executor import _pow2_at_least

    ex = store.executor
    cases = []
    for name, (table_name, qs) in items.items():
        for cql, _rows in qs:
            table, plan = _plan_of(store, table_name, cql)
            seg = ex.device_index(table).segments[0]
            if table.index.name in ("xz2", "xz3"):
                d, has_time, _g, _n, ainfo = ex._xz_batch_desc(table, plan)
                plane = None
                if ainfo is not None:
                    plane = seg._attr_plane_args(ainfo[0], ainfo[2], ainfo[1])
                cases.append((path, dual_case(
                    f"xz_dual_bitmap_{table.index.name}" + (f"_{ainfo[1]}" if ainfo else ""),
                    seg, _up(store, d[None]), has_time, path, plane)))
                continue
            desc = ex._exact_descriptor(table, plan)
            if desc is not None:
                box, win = desc
                cases.append((path, count_case(f"exact_count_{table.index.name}", seg,
                                               _up(store, box),
                                               None if win is None else _up(store, win), path)))
                continue
            got = ex._attr_batch_desc(table, plan)
            if got is not None:
                attr, kind, (box, win, payload) = got
                cases.append((path, count_case(
                    f"exact_count_{table.index.name}_{kind}", seg, _up(store, box),
                    None if win is None else _up(store, win), path,
                    seg._attr_plane_args(attr, payload, kind))))
                continue
            edges, box, win, has_time, _g, _n, ainfo = ex._poly_batch_desc(table, plan)
            ecap = _pow2_at_least(len(edges), 8)
            padded = np.concatenate([edges, np.zeros((ecap - len(edges), 4), np.float32)])
            plane = None
            if ainfo is not None:
                plane = (seg._attr_codes[ainfo[0]][0],
                         _up(store, seg._attr_batch_vectors(ainfo[0], ainfo[1], [ainfo[2]])),
                         ainfo[1])
            cases.append((path, poly_case(store, table, [(padded, box, win)], has_time, path,
                                          plane)))
    return cases


def push_down_cases(store, items, launched, timed):
    """The kernels of the count, stats and dual-attribute paths at every
    shape those paths launched (``launched`` = path -> its
    ``LAUNCH_SHAPES``) that no earlier case timed (``timed``: (name, tag)
    keys): ``exact_count`` at each count's descriptor, ``exact_stat_hist``
    for each attribute of STATS_SPEC, the q = 1 dual planes and ray cast of
    the counts, the batches of (a') and (l') with their attribute vectors
    and, where one of their queries refetched alone (its span outgrew the
    window), the first query at q = 1."""
    from geomesa_tpu_torch.parallel.executor import _pow2_at_least

    ex = store.executor

    def up(a):
        return _up(store, a)

    cases = count_cases(store, items, "count")
    # the stats query: a histogram an attribute of its spec
    table, plan = _plan_of(store, ATTR_TABLE, bbox_cql(ATTR_BOX))
    seg = ex.device_index(table).segments[0]
    box, win = ex._exact_descriptor(table, plan)
    for attr in ("goldstein", "actor1"):
        cases.append(("stats", hist_case(seg, up(box), None if win is None else up(win), attr,
                                         "stats")))
    # (a') and (l'): the batch and its first query alone, with the batch's vectors
    for table_name, cqls in (("ways", [c for c, _b, _k in kind_stream()]),
                             (ATTR_TABLE, [c for c, _r, _a in poly_attr_stream()])):
        pairs = [_plan_of(store, table_name, c) for c in cqls]
        table = pairs[0][0]
        seg = ex.device_index(table).segments[0]
        if table.index.name in ("xz2", "xz3"):
            got = [ex._xz_batch_desc(t, p) for t, p in pairs]
            attr, kind = got[0][4][0], got[0][4][1]
            descs = up(np.stack([g[0] for g in got]))
            qv = up(seg._attr_batch_vectors(attr, kind, [g[4][2] for g in got]))
            codes = seg._attr_codes[attr][0]
            for q in (len(got), 1):
                cases.append(("dual_attr", dual_case(
                    f"xz_dual_bitmap_{table.index.name}_{kind}", seg, descs[:q], got[0][1],
                    "dual_attr", (codes, qv[:q].contiguous(), kind))))
        else:
            got = [ex._poly_batch_desc(t, p) for t, p in pairs]
            attr, kind = got[0][6][0], got[0][6][1]
            descs = [g[:3] for g in got]
            payloads = [g[6][2] for g in got]
            qpad = (len(descs) + 3) // 4 * 4
            batch = descs + [descs[-1]] * (qpad - len(descs))
            payloads += [payloads[-1]] * (qpad - len(payloads))
            qv = up(seg._attr_batch_vectors(attr, kind, payloads))
            codes = seg._attr_codes[attr][0]
            ecap = _pow2_at_least(max(len(d[0]) for d in descs), 8)
            first = descs[0]
            lone = [(np.concatenate([first[0], np.zeros((ecap - len(first[0]), 4), np.float32)]),)
                    + tuple(first[1:])]
            for group, q in ((batch, qpad), (lone, 1)):
                cases.append(("dual_attr", poly_case(store, table, group, got[0][3], "dual_attr",
                                                     (codes, qv[:q].contiguous(), kind))))
    out, seen = [], set(timed)
    for path, case in cases:
        key = (case["name"], case["tag"])
        if key in launched[path] and key not in seen:
            seen.add(key)
            out.append(case)
    return out


# -- the host layer: native libraries and the host-seek route ---------------


# -- the concurrent phase: many callers, one query each ----------------------

# K barrier-started client threads of M store.query calls each (the
# reference's scripts/bench_gate.py run_concurrent_stream shape)
CONC_THREADS = 8
# 2 calls a thread (4 until the lifecycle and fault phases came: the cut
# keeps the script inside its limit)
CONC_ROUNDS = 2
# stream -> (table, the route of a query that rode a stacked sweep)
CONC_STREAMS = {
    "config1": ("gdelt", "device-exact/mask"),
    "xz2_bbox": ("ways", "device-batch-dual/mask"),
    "poly_l": (POLY_TABLE, "device-batch-dual/mask"),
    "attr_j": (ATTR_TABLE, "device-exact/mask"),
}
# the mask-batch launch names of the concurrent phase -> (stream, edition)
CONC_KERNELS = {
    "exact_mask_batch_z3": ("config1", None),
    "exact_mask_batch_z2_member": ("attr_j", "member"),
    "exact_mask_batch_z2_range": ("attr_j", "range"),
    "xz_mask_batch_xz2": ("xz2_bbox", None),
    "poly_mask_batch_z2": ("poly_l", None),
}


def concurrent_items(data1, streams1, streams3, oracle3, streams_p, oracle_p, streams4,
                     oracle4):
    """The four streams of the concurrent phase: name -> [(cql, sorted
    oracle rows)]: config #1's jittered ``bbox AND DURING`` (exact z3),
    config #3's (a) boxes (xz2 dual), the polygon plane's (l) stars (poly
    dual) and config #4's (j) (the member and range attribute planes)."""
    x, y, t = data1
    boxes, cqls = streams1["config1"]
    return {
        "config1": [(c, np.sort(brute_force(x, y, t, b))) for b, c in zip(boxes, cqls)],
        "xz2_bbox": [(c, np.sort(r)) for (c, _s), r in zip(streams3["xz2_bbox"],
                                                            oracle3["xz2_bbox"])],
        "poly_l": [(c, np.sort(r)) for (c, _r), r in zip(streams_p["l"], oracle_p["l"])],
        "attr_j": [(c, np.sort(r)) for (c, _s), r in zip(streams4["j"], oracle4["j"])],
    }


def hold_slot(ctl):
    """Hold one admission slot of ``ctl`` from a context of its own; returns
    its release."""
    import contextvars

    ctx = contextvars.Context()
    admit = ctl.admit()
    ctx.run(admit.__enter__)
    return lambda: ctx.run(admit.__exit__, None, None, None)


def client_pass(store, table, items, rounds: int = CONC_ROUNDS):
    """CONC_THREADS client threads, barrier-started, each ``rounds``
    ``store.query`` calls of ``items`` (thread k, round r: item (k * rounds +
    r) mod len). Returns ([(item, result, ms by the thread's clock)], wall
    seconds from the first start to the last answer)."""
    barrier = threading.Barrier(CONC_THREADS)
    out = [None] * (CONC_THREADS * rounds)
    spans = [None] * CONC_THREADS
    errors = []

    def client(k):
        try:
            barrier.wait(120)
            first = time.perf_counter()
            for r in range(rounds):
                i = (k * rounds + r) % len(items)
                t0 = time.perf_counter()
                res = store.query(table, items[i][0])
                out[k * rounds + r] = (i, res, (time.perf_counter() - t0) * 1e3)
            spans[k] = (first, time.perf_counter())
        except BaseException as e:  # noqa: BLE001 - raised below, in the caller
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(CONC_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    torch.cuda.synchronize()
    return out, max(e for _s, e in spans) - min(s for s, _e in spans)


def check_pass(out, items, what: str, full: bool) -> None:
    """Every answer of a pass against its oracle: its fid rows (``full``)
    or, cheaper, its hit count."""
    for j, (i, res, _ms) in enumerate(out):
        want = items[i][1]
        ok = (np.array_equal(fid_rows(np.asarray(res.fids)), want) if full
              else len(res) == len(want))
        if not ok:
            raise AssertionError(f"{what} query {j} (item {i}): {len(res)} hits against "
                                 f"{len(want)} from the oracle")


def coalesce_counters():
    from geomesa_tpu_torch.utils import devstats

    counters = devstats.devstats_metrics().snapshot()[0]
    return {k[len("batch.coalesce."):]: v for k, v in counters.items()
            if k.startswith("batch.coalesce.")}


def pass_metrics(out, wall_s: float, n_rows: int, c0, c1):
    """A pass's figures: wall, features/s (n x queries / wall), per-query
    p50 / p99 by the threads' clocks, the routes, the group sizes the
    queries rode, the coalescer's counters and every query's receipt
    ([d2h bytes, h2d bytes, kernel builds])."""
    ms = np.sort([m for _i, _r, m in out])
    routes, sizes = {}, {}
    for _i, res, _m in out:
        routes[res.scan_path] = routes.get(res.scan_path, 0) + 1
        sizes[res.coalesced] = sizes.get(res.coalesced, 0) + 1
    receipts = [[r.receipt["d2h_bytes"], r.receipt["h2d_bytes"], r.receipt["recompiles"]]
                for _i, r, _m in out]
    return {
        "queries": len(out),
        "wall_s": wall_s,
        "features_per_s": n_rows * len(out) / wall_s,
        "p50_ms": float(ms[len(ms) // 2]),
        "p99_ms": float(ms[min(len(ms) - 1, int(0.99 * len(ms)))]),
        "mean_ms": float(ms.mean()),
        "routes": routes,
        "group_sizes": {str(k): v for k, v in sorted(sizes.items())},
        "coalesce": {k: c1.get(k, 0) - c0.get(k, 0) for k in sorted(set(c0) | set(c1))
                     if c1.get(k, 0) != c0.get(k, 0)},
        "d2h_bytes_per_query": float(np.mean([r[0] for r in receipts])),
        "h2d_bytes_per_query": float(np.mean([r[1] for r in receipts])),
        "receipts": receipts,
    }


def receipt_probe(store, table, items, mask_route: str):
    """One wave of CONC_THREADS queries, one admission slot held (every
    arrival sees another query in flight) and ``geomesa.batch.max.queries``
    the wave's size (the group closes on its last join; a 100 ms window
    bounds it): one group of them all, every query on ``mask_route``, every
    answer its oracle's, and the members' receipts summing exactly to the
    wave's device.d2h.bytes and device.h2d.bytes."""
    from geomesa_tpu_torch.utils import devstats
    from geomesa_tpu_torch.utils.config import properties

    reg = devstats.devstats_metrics()
    with properties(geomesa_batch_window_ms="100", geomesa_batch_max_queries=str(CONC_THREADS)):
        release = hold_slot(store.admission)
        try:
            c0 = coalesce_counters()
            d0, h0 = reg.counter("device.d2h.bytes"), reg.counter("device.h2d.bytes")
            out, _wall = client_pass(store, table, items, rounds=1)
            d2h = reg.counter("device.d2h.bytes") - d0
            h2d = reg.counter("device.h2d.bytes") - h0
            c1 = coalesce_counters()
        finally:
            release()
    check_pass(out, items, f"{table} receipt probe", full=True)
    got = (c1.get("groups", 0) - c0.get("groups", 0), c1.get("members", 0) - c0.get("members", 0))
    routes = sorted({r.scan_path for _i, r, _m in out})
    sums = (sum(r.receipt["d2h_bytes"] for _i, r, _m in out),
            sum(r.receipt["h2d_bytes"] for _i, r, _m in out))
    if got != (1, CONC_THREADS) or routes != [mask_route] or sums != (d2h, h2d):
        raise AssertionError(f"{table} receipt probe: (groups, members) {got}, routes {routes}, "
                             f"receipts sum to {sums} against the wave's {(d2h, h2d)}")
    return {"d2h_bytes": d2h, "h2d_bytes": h2d, "routes": routes,
            "receipts": [[r.receipt["d2h_bytes"], r.receipt["h2d_bytes"]] for _i, r, _m in out]}


def concurrent_path(store, items):
    """The concurrent phase through ``store.query`` (the port's analog of
    the reference's bench_gate ``run_concurrent_stream`` and
    ``_receipt_probe``): per stream a warm pass with coalescing on (the
    defaults) and one with ``geomesa.batch.enabled=false`` (hit counts
    checked), a timed pass of each (every answer checked against the
    oracle's rows), then the receipt probe."""
    from geomesa_tpu_torch.utils.config import properties

    out = {}
    for name, (table, mask_route) in CONC_STREAMS.items():
        n_rows = next(iter(store._tables[table].values())).num_rows
        modes = {"coalesced": "true", "solo": "false"}
        for mode, enabled in modes.items():
            with properties(geomesa_batch_enabled=enabled):
                warm, _w = client_pass(store, table, items[name])
            check_pass(warm, items[name], f"{name} warm {mode}", full=False)
        stream = {"rows": n_rows}
        for mode, enabled in modes.items():
            with properties(geomesa_batch_enabled=enabled):
                c0 = coalesce_counters()
                got, wall = client_pass(store, table, items[name])
                c1 = coalesce_counters()
            check_pass(got, items[name], f"{name} {mode}", full=True)
            stream[mode] = pass_metrics(got, wall, n_rows, c0, c1)
            m = stream[mode]
            log(f"concurrent {name} {mode}: {m['queries']} queries in {wall:.3f} s, "
                f"{m['features_per_s']:.4g} features/s, p50 {m['p50_ms']:.2f} p99 "
                f"{m['p99_ms']:.2f} ms, d2h {m['d2h_bytes_per_query']:.0f} B/query, routes "
                f"{m['routes']}, groups {m['group_sizes']}, counters {m['coalesce']}")
        if stream["solo"]["coalesce"]:
            raise AssertionError(f"{name}: the escape hatch coalesced {stream['solo']['coalesce']}")
        stream["receipt_probe"] = receipt_probe(store, table, items[name], mask_route)
        out[name] = stream
    return out


def mask_cases(store, plans, launched_shapes):
    """The coalescer's mask batches at each (kernel, shape) the concurrent
    phase launched, on the descriptors of the first q queries of the
    kernel's stream (and edition): ``exact_mask_batch``,
    ``dual_mask_batch`` "xz" and "poly" against their plain editions."""
    ex = store.executor
    dev = ex.device
    out = []
    for (name, tag), count in sorted(launched_shapes.items()):
        if name not in CONC_KERNELS or not count:
            continue
        stream, edition = CONC_KERNELS[name]
        q = int(tag.split()[0][2:])
        if stream == "config1":
            table = store._tables["gdelt"]["z3"]
            descs = [ex._exact_descriptor(table, p) for p in plans["config1"][:q]]
            case = exact_case(name, ex.device_index(table).segments[0],
                              torch.as_tensor(np.stack([d[0] for d in descs]), device=dev),
                              torch.as_tensor(np.stack([d[1] for d in descs]), device=dev),
                              "concurrent", mask=True)
        elif stream == "attr_j":
            table = store._tables[ATTR_TABLE]["z2"]
            seg = ex.device_index(table).segments[0]
            got = [ex._attr_batch_desc(table, p) for p in plans["attr_j"]]
            got = [g for g in got if g[1] == edition][:q]
            attr = got[0][0]
            vectors = torch.as_tensor(seg._attr_batch_vectors(attr, edition, [g[2][2] for g in got]),
                                      device=dev)
            case = exact_case(name, seg,
                              torch.as_tensor(np.stack([g[2][0] for g in got]), device=dev),
                              None, "concurrent", (seg._attr_codes[attr][0], vectors, edition),
                              mask=True)
        elif stream == "xz2_bbox":
            table = store._tables["ways"]["xz2"]
            descs = torch.as_tensor(np.stack([ex._xz_batch_desc(table, p)[0]
                                              for p in plans["xz2_bbox"][:q]]), device=dev)
            case = dual_case(name, ex.device_index(table).segments[0], descs, False,
                             "concurrent", mask=True)
        else:
            table = store._tables[POLY_TABLE]["z2"]
            case = poly_case(store, table, [ex._poly_batch_desc(table, p)[:3]
                                            for p in plans["poly_l"][:q]], False, "concurrent",
                             mask=True)
        if (case["name"], case["tag"]) != (name, tag):
            raise AssertionError(f"mask case {case['name']} {case['tag']} for launched {name} {tag}")
        out.append(case)
    return out


# -- the aggregate pyramid's phase --------------------------------------------

# the cell bits of the cold builds: the finest grid the knob allows, then the
# default (the warm counts run at the default)
PYR_BITS = (12, 8)
PYR_TURNS = ("on", "off", "on", "off")
# the projection phase's box: away from config #1's clusters (a few thousand
# rows at 20M), so the transform's per-row expression stays cheap
PROJ_BOX = (-40.0, -20.0, -35.0, -15.0)
PROJ_SAMPLING = 0.1


def pyramid_items(data1, streams1, streams_p, oracle_p):
    """The counts of the pyramid phase: name -> (table, [(cql, oracle
    rows)]): config #1's 8 bbox-only queries (z2) and the polygon table's
    stream (l), 24 stars."""
    x, y, _t = data1
    boxes, cqls = streams1["bbox"]
    return {
        "config1_bbox": ("gdelt", [(c, np.flatnonzero(in_box(x, y, b)))
                                   for b, c in zip(boxes, cqls)]),
        "poly_l": (POLY_TABLE, [(c, rows) for (c, _r), rows in zip(streams_p["l"],
                                                                    oracle_p["l"])]),
    }


def pyramid_route(store, table, cql):
    """(route, interior rows, boundary rows) of one count: ``pyramid`` when
    the type's pyramid answers it (its interior cells' rows and the rows of
    its boundary ring, which the count scans), else the device count's."""
    from geomesa_tpu_torch.index.planner import Query

    q = Query.cql(cql)
    plan = store._plan_cached(table, q)
    got = store._pyramid_classify(table, store.get_schema(table), q, plan)
    if got is None:
        if store.executor.count_scan(store._tables[table][plan.index.name], plan) is None:
            raise AssertionError(f"pyramid phase: neither the pyramid nor the device counts {cql}")
        return "device-count", 0, 0
    pyr, interior, cells, _mask = got
    return "pyramid", int(interior), int(pyr.counts[0][cells[:, 1], cells[:, 0]].sum())


def build_totals(reg):
    """(builds, the agg.build timer's (count, seconds)) of the registry."""
    _c, _g, _t, totals = reg.snapshot()
    return reg.counter("agg.cache.builds"), totals.get("agg.build", (0, 0.0))


def build_split(store, table_name, bits):
    """One cold build of ``table_name``'s pyramid at ``bits``, taken step by
    step as ``ops/pyramid.build_pyramid`` and
    ``TorchScanExecutor.pyramid_counts`` take it, each step's ms on the
    host's clock around a synchronised device: the ``agg_mask`` upload
    (only the first build of a segment pays it), the kernel, the grid fetch
    (``_np_local``), the int64 conversion and sum over segments, the level
    reductions, ``AggPyramid``'s stats (``counts[0].sum()`` and the
    occupied count) and ``ensure_device``'s uploads. The parts' grid equals
    the plain edition's."""
    from geomesa_tpu_torch.ops import aggregations, kernels
    from geomesa_tpu_torch.ops.pyramid import agg_knobs
    from geomesa_tpu_torch.parallel.executor import _np_local
    from geomesa_tpu_torch.parallel.mesh import upload
    from geomesa_tpu_torch.utils.config import properties

    table = store._tables[table_name]["z2"]
    segs = store.executor.device_index(table).segments
    with properties(geomesa_agg_cell_bits=str(bits)):
        levels = agg_knobs()[1]
    out = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return got

    def fresh_masks():
        for seg in segs:
            seg.__dict__.pop("_agg_mask", None)
        return [seg.agg_mask(table) for seg in segs]

    masks = step("agg_mask_ms", fresh_masks)
    grids = step("kernel_ms", lambda: [
        kernels.pyramid_counts(seg.xi, seg.yi, m, bits, starts=seg.block_bounds)
        for seg, m in zip(segs, masks)])
    host = step("fetch_ms", lambda: [_np_local(g) for g in grids])

    def int64_sum():
        total = np.zeros((1 << bits, 1 << bits), dtype=np.int64)
        for g in host:
            total += g.astype(np.int64)
        return total

    total = step("int64_sum_ms", int64_sum)

    def reduce_levels():
        counts = [np.asarray(total, dtype=np.int64)]
        for _ in range(1, levels):
            g = counts[-1]
            if g.shape[0] < 2:
                break
            counts.append(g.reshape(g.shape[0] // 2, 2, g.shape[1] // 2, 2).sum(axis=(1, 3)))
        return counts

    counts = step("levels_ms", reduce_levels)
    rows, occupied = step("stats_ms", lambda: (int(counts[0].sum()), int((counts[0] > 0).sum())))
    step("ensure_device_ms", lambda: [upload(g.astype(np.int32), store.executor.device)
                                      for g in counts])
    want = sum(aggregations.pyramid_counts_plain(seg.xi, seg.yi, m, bits).to(torch.int64)
               for seg, m in zip(segs, masks))
    if not np.array_equal(_np_local(want), total):
        raise AssertionError(f"build split {table_name} bits={bits}: the grid differs")
    out.update(segments=len(segs), levels=len(counts), rows=rows, occupied=occupied,
               parts_ms=sum(v for k, v in out.items() if k.endswith("_ms")))
    return out


def bin_oracle(fids, x, y, t) -> np.ndarray:
    """BIN records of rows (track = the fid's 4-byte little-endian signed
    blake2b, date in seconds, f32 lat and lon), ordered by their fields."""
    import hashlib

    out = np.zeros(len(fids), dtype=[("track", "<i4"), ("dtg", "<i4"), ("lat", "<f4"),
                                     ("lon", "<f4")])
    out["track"] = [int.from_bytes(hashlib.blake2b(str(f).encode(), digest_size=4).digest(),
                                   "little", signed=True) for f in fids]
    out["dtg"] = (t // 1000).astype(np.int32)
    out["lat"] = y.astype(np.float32)
    out["lon"] = x.astype(np.float32)
    return np.sort(out, order=["dtg", "track", "lat", "lon"])


def pyramid_path(store, items, data1, data4, streams6, oracle6):
    """The aggregate pyramid cache through the entry points, with
    ``geomesa.agg.enabled=true`` (the rest of the script runs with it off)
    and ``GEOMESA_COUNT_DEVICE=1``: (1) the cold builds, a first count of
    each ``items`` table at each of PYR_BITS (the build's ms from the
    ``agg.build`` timer, its ``agg.cache.builds`` and its
    ``pyramid_counts`` launches, which must be more than 0); (2) every
    count of ``items`` with the cache on and off in turns, each equal to its
    oracle, with its route and its interior and boundary rows; (3)
    ``store.aggregate`` of config #4's box over goldstein against numpy
    (count, min and max exact, the f64 sum to rtol 1e-12), from the pyramid
    and, with the cache off, from the exact fallback; (4) config #6's stream
    (f) twice: the second pass on ``agg-cache-density``, every grid equal to
    the oracle; (5) on config #1's PROJ_BOX a transform, a sampled query
    (without and with ``sample_by``) and a ``bin`` query against numpy.
    ``main`` splits config #1's cold build at 8 and 12 bits into its steps
    (``build_split``) once this path's launches are read."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.utils import devstats
    from geomesa_tpu_torch.utils.config import properties

    reg = devstats.devstats_metrics()
    out = {"cold": {}, "warm": {}}
    os.environ["GEOMESA_COUNT_DEVICE"] = "1"
    try:
        with properties(geomesa_agg_enabled="true", geomesa_agg_cache_bytes="4GB"):
            for bits in PYR_BITS:
                with properties(geomesa_agg_cell_bits=str(bits)):
                    for name, (table, qs) in items.items():
                        cql, rows = qs[0]
                        b0, (n0, s0) = build_totals(reg)
                        l0 = kernels.LAUNCHES["pyramid_counts"]
                        t0 = time.perf_counter()
                        got = store.count(table, cql)
                        first_ms = (time.perf_counter() - t0) * 1e3
                        b1, (n1, s1) = build_totals(reg)
                        launches = kernels.LAUNCHES["pyramid_counts"] - l0
                        if got != len(rows):
                            raise AssertionError(f"pyramid cold count {name}: {got} against "
                                                 f"{len(rows)}")
                        if b1 - b0 != 1 or n1 - n0 != 1 or launches < 1:
                            raise AssertionError(f"pyramid cold build {name} bits={bits}: "
                                                 f"{b1 - b0} builds, {launches} launches")
                        out["cold"][f"{name}_bits{bits}"] = {
                            "build_ms": (s1 - s0) * 1e3, "first_count_ms": first_ms,
                            "builds": b1 - b0, "pyramid_counts_launches": launches,
                            "rows": int(store._tables[table]["z2"].num_rows),
                        }
            for name, (table, qs) in items.items():
                info = [pyramid_route(store, table, cql) for cql, _rows in qs]
                times = {"on": [], "off": []}
                for turn in PYR_TURNS:
                    with properties(geomesa_agg_enabled="true" if turn == "on" else "false"):
                        t0 = time.perf_counter()
                        for i, (cql, rows) in enumerate(qs):
                            got = store.count(table, cql)
                            if got != len(rows):
                                raise AssertionError(f"pyramid count {name} {i} ({turn}): {got} "
                                                     f"against the oracle's {len(rows)}")
                        times[turn].append((time.perf_counter() - t0) * 1e3 / len(qs))
                routes = {}
                for r, _i, _b in info:
                    routes[r] = routes.get(r, 0) + 1
                out["warm"][name] = {
                    "counts": len(qs), "count_ms_on": times["on"], "count_ms_off": times["off"],
                    "routes_on": routes, "route_off": "device-count",
                    "interior_rows": [i for _r, i, _b in info],
                    "boundary_rows": [b for _r, _i, b in info],
                    "rows_counted": [int(len(rows)) for _c, rows in qs],
                }
            box = bbox_cql(ATTR_BOX)
            gold = data4["gold"][in_box(data4["x"], data4["y"], ATTR_BOX)]
            agg = {"route": pyramid_route(store, ATTR_TABLE, box)[0]}
            if agg["route"] != "pyramid":
                raise AssertionError(f"aggregate of {box}: took {agg['route']}")
            for label, enabled in (("pyramid_cold", "true"), ("pyramid", "true"),
                                   ("fallback", "false")):
                with properties(geomesa_agg_enabled=enabled):
                    t0 = time.perf_counter()
                    got = store.aggregate(ATTR_TABLE, box, columns=["goldstein"])
                    agg[f"{label}_ms"] = (time.perf_counter() - t0) * 1e3
                col = got["columns"]["goldstein"]
                if (got["count"], col["count"], col["min"], col["max"]) != (
                        len(gold), len(gold), float(gold.min()), float(gold.max())) or \
                        abs(col["sum"] - gold.sum()) > 1e-12 * abs(gold.sum()):
                    raise AssertionError(f"aggregate ({label}): {got} against numpy "
                                         f"({len(gold)}, {gold.sum()}, {gold.min()}, {gold.max()})")
            agg.update(count=len(gold), sum=float(gold.sum()))
            out["aggregate"] = agg
            name = "f_dens_256x128"
            tname, items_f, _route = streams6[name]
            queries = density_queries(items_f)
            memo = {}
            for route in ("device-density", "agg-cache-density"):
                t0 = time.perf_counter()
                for i, q in enumerate(queries):
                    expect_grid(store.query(tname, q), oracle6[name][i], route,
                                f"pyramid phase {name} query {i}")
                memo[route] = (time.perf_counter() - t0) * 1e3 / len(queries)
            out["density_memo"] = {"queries": len(queries), "compute_ms": memo["device-density"],
                                   "memo_hit_ms": memo["agg-cache-density"]}
            out["projection"] = projection_checks(store, data1)
    finally:
        os.environ.pop("GEOMESA_COUNT_DEVICE", None)
    torch.cuda.synchronize()
    log(f"pyramid path: {json.dumps(out)}")
    return out


def projection_checks(store, data1):
    """A transform, sampled queries and a bin query on config #1's
    PROJ_BOX, each against numpy."""
    from geomesa_tpu_torch.index.planner import Query

    x, y, t = data1
    rows = np.flatnonzero(in_box(x, y, PROJ_BOX))
    cql = bbox_cql(PROJ_BOX)
    out = {"rows": int(len(rows))}
    t0 = time.perf_counter()
    res = store.query("gdelt", Query.cql(cql, properties=["geom", "secs=millisToSecs($dtg)"]))
    out["transform_ms"] = (time.perf_counter() - t0) * 1e3
    expect_fids(res, rows, "transform query")
    # the transform's fids are objects; fid_rows reads fixed-width strings
    got_rows = fid_rows(np.asarray(res.fids).astype(str))
    order = np.argsort(np.asarray([int(f[1:]) for f in res.fids]), kind="stable")
    got = np.asarray(res.columns["secs"], dtype=np.int64)[order]
    if not np.array_equal(got_rows, rows) or not np.array_equal(got, t[rows] // 1000):
        raise AssertionError("transform query: secs differ from numpy")
    plain = store.query("gdelt", cql).fids
    nth = int(round(1 / PROJ_SAMPLING))
    t0 = time.perf_counter()
    res = store.query("gdelt", Query.cql(cql, hints={"sampling": PROJ_SAMPLING}))
    out["sampled_ms"] = (time.perf_counter() - t0) * 1e3
    if list(res.fids) != list(plain[::nth]):
        raise AssertionError("sampled query: not every n-th row of the plain result")
    res = store.query("gdelt", Query.cql(cql, hints={"sampling": PROJ_SAMPLING,
                                                     "sample_by": "dtg"}))
    _u, counts = np.unique(t[rows], return_counts=True)
    if len(res) != int(((counts + nth - 1) // nth).sum()):
        raise AssertionError(f"sample_by query: {len(res)} rows")
    t0 = time.perf_counter()
    res = store.query("gdelt", Query.cql(cql, hints={"bin": {"track": "id", "sort": True}}))
    out["bin_ms"] = (time.perf_counter() - t0) * 1e3
    got = res.aggregate["bin"]
    if np.any(np.diff(got["dtg"]) < 0):
        raise AssertionError("bin query: records not in date order")
    fids = np.char.add("f", rows.astype(str))
    want = bin_oracle(fids, x[rows], y[rows], t[rows])
    if np.sort(got, order=["dtg", "track", "lat", "lon"]).tobytes() != want.tobytes():
        raise AssertionError("bin query: records differ from numpy")
    out["sampled_rows"] = int(len(plain[::nth]))
    return out


def pyramid_counts_caller(xi, yi, mask, bits, starts):
    """The ``pyramid_counts`` library called with the whole C interface,
    whichever design it holds (for ``--ab``): a design that sizes no
    scratch (one that zeroes the grid itself and reads only the first
    seven arguments) gets none."""
    from geomesa_tpu_torch.ops import kernels

    lib = kernels._lib("pyramid_counts")
    n, side = xi.shape[0], 1 << bits
    words = lib.pyramid_counts_scratch(n, bits) if hasattr(lib, "pyramid_counts_scratch") else 0
    scratch = torch.empty(max(words, 1), dtype=torch.int32, device=xi.device)
    out = torch.empty((side, side), dtype=torch.int32, device=xi.device)
    lo, hi = kernels.pyramid_block(starts, n)
    err = lib.pyramid_counts(xi.data_ptr(), yi.data_ptr(), mask.data_ptr(), bits, out.data_ptr(),
                             n, kernels._stream(xi.device), lo, hi,
                             scratch.data_ptr() if words else None, words)
    if err:
        raise RuntimeError(f"pyramid_counts launch failed: CUDA error {err}")
    return out


def pyramid_case(table, seg, bits, path):
    """One ``pyramid_counts`` shape: a z2 segment's grid coordinates and
    ``agg_mask`` at ``bits``. Bound: bytes, xi, yi and the mask read once
    (9 B a row) and the int32 grid written once (4 * 4^bits B).
    ``bincount_ms`` times ``torch.bincount(flat[mask], minlength=4^bits)``
    of the rows' flat cell ids, which computes the same grid (the entry's
    ``library_ms``)."""
    from geomesa_tpu_torch.ops import aggregations, kernels

    n = seg.n_padded
    xi, yi, mask, starts = seg.xi, seg.yi, seg.agg_mask(table), seg.block_bounds
    shift = 31 - bits
    flat = ((yi >> shift).to(torch.int64) << bits) | (xi >> shift).to(torch.int64)
    cells = 1 << (2 * bits)
    occupied = int((aggregations.pyramid_counts_plain(xi, yi, mask, bits) > 0).sum())
    return dict(
        name="pyramid_counts", path=path, tag=f"bits={bits} n={n}", symbol="pyramid_counts_",
        replaces="geomesa_tpu/ops/aggregations.py:388",
        source="geomesa_tpu_torch/csrc/pyramid_counts.cu",
        kernel=lambda: (kernels.pyramid_counts(xi, yi, mask, bits, starts=starts),),
        ab_kernel=lambda: (pyramid_counts_caller(xi, yi, mask, bits, starts),),
        plain=lambda: (aggregations.pyramid_counts_plain(xi, yi, mask, bits),),
        bytes=9 * n + 4 * cells,
        ops=0,
        aside={"bincount_ms": lambda: torch.bincount(flat[mask], minlength=cells)},
        library="bincount_ms",
        extra={"occupied_cells": occupied, "table": table.ft.name},
        shape=f"rows={n} bits={bits} cells={cells} occupied={occupied} ({table.ft.name})",
    )


def pyramid_cases(store, items, launched, timed):
    """The pyramid phase's kernels at every shape it launched: the
    ``pyramid_counts`` build on each z2 segment at each cell bits, and the
    device counts of its turns with the cache off where no earlier phase
    timed their shape."""
    segs = {}
    for tname in ("gdelt", POLY_TABLE, ATTR_TABLE):
        table = store._tables[tname]["z2"]
        for seg in store.executor.device_index(table).segments:
            segs.setdefault(seg.n_padded, (table, seg))
    cases = []
    for name, tag in sorted(k for k in launched if k[0] == "pyramid_counts"):
        bits, n = (int(kv.split("=")[1]) for kv in tag.split())
        table, seg = segs[n]
        cases.append(("pyramid", pyramid_case(table, seg, bits, "pyramid")))
    cases += count_cases(store, items, "pyramid")
    out, seen = [], set(timed)
    for path, case in cases:
        key = (case["name"], case["tag"])
        if key in launched and key not in seen:
            seen.add(key)
            out.append(case)
    return out


def native_build():
    """Build and load the four native host libraries (one g++ each, in
    parallel); fail unless every one loaded, with the loader's reason."""
    from geomesa_tpu_torch import native

    status = native.build_all()
    bad = {k: v["reason"] for k, v in status.items() if not v["loaded"]}
    if bad:
        raise AssertionError(f"native libraries did not load: {bad}")
    return status


@contextlib.contextmanager
def recording_range_walks(walks):
    """Record the inputs of every z range walk (``native.zranges_native``)
    and xz range walk (``ranges_boxes``) that planning makes, to time them
    again at the main path's shapes."""
    from geomesa_tpu_torch import native
    from geomesa_tpu_torch.curve.xz import _XZSFC

    zwalk, xzwalk = native.zranges_native, _XZSFC.ranges_boxes

    def zrec(*args):
        walks.setdefault("zranges", []).append(args)
        return zwalk(*args)

    def xzrec(sfc, windows, max_ranges=None):
        walks.setdefault("xzranges", []).append((sfc, windows, max_ranges))
        return xzwalk(sfc, windows, max_ranges)

    native.zranges_native, _XZSFC.ranges_boxes = zrec, xzrec
    try:
        yield walks
    finally:
        native.zranges_native, _XZSFC.ranges_boxes = zwalk, xzwalk


@contextlib.contextmanager
def plain_editions():
    """The native libraries off: every call site takes its plain edition."""
    os.environ["GEOMESA_TPU_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        del os.environ["GEOMESA_TPU_NO_NATIVE"]


def host_ms(fn, reps: int = 3):
    """(ms per call of ``fn`` on the host clock after one warm call, its
    last result)."""
    out = fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def timed_fids_read(store, name, queries) -> float:
    """Seconds per query of a pipelined stream that reads every result's
    fids inside the timed window (the lazy gather included)."""
    t0 = time.perf_counter()
    for r in store.query_many(name, queries):
        r.fids  # noqa: B018 - the gather is what is timed
    return (time.perf_counter() - t0) / len(queries)


def seek_stream(store, data, streams):
    """Config #1's 20 queries under GEOMESA_SEEK=auto, the chooser's
    default: a lone query (checked, then timed 3 times), the stream through
    query_many (warm, then timed with fids unread and read), every answer
    held against brute force; the routes taken and the kernels launched."""
    from collections import Counter

    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.ops import kernels

    x, y, t = data
    boxes, cqls = streams["config1"]
    queries = [Query.cql(c, properties=[]) for c in cqls]
    os.environ["GEOMESA_SEEK"] = "auto"
    try:
        kernels.reset_launches()
        res = store.query("gdelt", QUERY)
        expect_fids(res, brute_force(x, y, t), "seek stream: sync query")
        lone = res.plan.scan_path
        t0 = time.perf_counter()
        for _ in range(3):
            store.query("gdelt", QUERY)
        sync_s = (time.perf_counter() - t0) / 3
        store.query_many("gdelt", queries)
        t0 = time.perf_counter()
        results = store.query_many("gdelt", queries)
        pipe_s = (time.perf_counter() - t0) / len(queries)
        for i, (r, b) in enumerate(zip(results, boxes)):
            expect_fids(r, brute_force(x, y, t, b), f"seek stream query {i}")
        read_s = timed_fids_read(store, "gdelt", queries)
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    finally:
        os.environ["GEOMESA_SEEK"] = "0"
    out = {
        "mode": "auto",
        "lone_scan_path": lone,
        "scan_paths": dict(Counter(r.plan.scan_path for r in results)),
        "query_ms_sync": sync_s * 1e3,
        "query_ms_pipelined": pipe_s * 1e3,
        "query_ms_pipelined_fids_read": read_s * 1e3,
        "hits_per_query": sum(len(r) for r in results) / len(results),
        "launches": launches,
    }
    log(f"host-seek stream (GEOMESA_SEEK=auto): {json.dumps(out)}")
    return out


# the chooser's cutoff, swept: config #1's table under wider boxes and
# windows, (box, DURING days) -> about 0.24, 0.37, 0.53 and 0.72 of the rows
# in the plan's ranges (the chooser's own measure; config #1's stream: 0.09)
CROSSOVER = (
    ((-165.0, -6.5, 15.0, 83.5), (5, 19)),
    ((-180.0, -51.5, 105.0, 90.0), (5, 19)),
    ((-180.0, -51.5, 105.0, 90.0), (3, 25)),
    ((-180.0, -51.5, 105.0, 90.0), (2, 31)),
)
# one query a case (2 until the lifecycle and fault phases came)
CROSSOVER_REPS = 1


def seek_crossover(store, data):
    """The host seek against the device route where the chooser's cutoff
    (``SEEK_FRAC``) decides: per CROSSOVER case, ``CROSSOVER_REPS`` queries
    (its window shifted by 0, 1, ... hours) under ``GEOMESA_SEEK=1`` and ``0``, each
    pipelined (a warm query_many, then timed with fids unread and read),
    both routes' answers held against brute force; the share of the table
    in the plans' ranges and the route ``auto`` takes."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.parallel.executor import SEEK_FRAC

    x, y, t = data
    table = store._tables["gdelt"]["z3"]
    day = np.datetime64("2026-01-01T00:00:00", "ms").astype(np.int64)
    out = []
    for box, (d0, d1) in CROSSOVER:
        cqls, masks = [], []
        for h in range(CROSSOVER_REPS):
            lo, hi = day + (d0 - 1) * 86400_000 + h * 3600_000, day + (d1 - 1) * 86400_000 + h * 3600_000
            cqls.append(f"{bbox_cql(box)} AND dtg DURING {iso(lo)}/{iso(hi)}")
            masks.append(np.flatnonzero(in_box(x, y, box) & (t > lo) & (t < hi)))
        queries = [Query.cql(c, properties=[]) for c in cqls]
        plans = [store._plan_cached("gdelt", q) for q in queries]
        cand = [sum(int(np.maximum(e - s, 0).sum())
                    for b in table.blocks for s, e, _f in [b.scan_intervals(p.ranges)])
                for p in plans]
        row = {"box": box, "days": [d0, d1], "candidate_share": sum(cand) / len(cand) / len(x),
               "hits_per_query": sum(map(len, masks)) / len(masks)}
        for mode in ("1", "0", "auto"):
            os.environ["GEOMESA_SEEK"] = mode
            try:
                if mode == "auto":
                    row["auto_routes"] = sorted({r.plan.scan_path
                                                 for r in store.query_many("gdelt", queries)})
                    continue
                store.query_many("gdelt", queries)
                t0 = time.perf_counter()
                results = store.query_many("gdelt", queries)
                unread = (time.perf_counter() - t0) / len(queries)
                for i, (r, want) in enumerate(zip(results, masks)):
                    if not np.array_equal(fid_rows(r.fids), want):
                        raise AssertionError(f"crossover {box} {d0}-{d1} GEOMESA_SEEK={mode} "
                                             f"query {i}: fid-set parity failed")
                route = "seek" if mode == "1" else "device"
                row[route + "_routes"] = sorted({r.plan.scan_path for r in results})
                row[route + "_ms_pipelined"] = unread * 1e3
                row[route + "_ms_pipelined_fids_read"] = \
                    timed_fids_read(store, "gdelt", queries) * 1e3
            finally:
                os.environ["GEOMESA_SEEK"] = "0"
        want_auto = ["host-seek"] if row["candidate_share"] <= SEEK_FRAC else row["device_routes"]
        if row["auto_routes"] != want_auto or row["seek_routes"] != ["host-seek"]:
            raise AssertionError(f"crossover routes: {row}")
        out.append(row)
        log(f"seek crossover: {json.dumps(row)}")
    return out


def decode_case(windows):
    """The native decode of span windows [(bits, start, header count)]
    against numpy's unpack of the same windows: equal rows required; host
    ms per window of each."""
    from geomesa_tpu_torch import native

    nat_ms, got = host_ms(lambda: [native.bitmap_rows_native(w, s, c) for w, s, c in windows])
    np_ms, want = host_ms(lambda: [s + np.flatnonzero(np.unpackbits(w)).astype(np.int64)
                                   for w, s, _c in windows])
    for g, w in zip(got, want):
        if not np.array_equal(g, w):
            raise AssertionError("native bitmap decode differs from np.unpackbits")
    k = len(windows)
    return {
        "windows": k,
        "bytes_per_window": sum(len(w) for w, _s, _c in windows) / k,
        "rows_per_window": sum(len(g) for g in got) / k,
        "native_ms": nat_ms / k,
        "numpy_ms": np_ms / k,
    }


def batch_windows(store, table, plans):
    """Every (query, segment) span window of one batched dispatch of
    ``plans``: [(bits, start, header count)], a dual window as its hit and
    its decided plane (both bounded by the hit count)."""
    scans = store.executor.dispatch_many([(table, p) for p in plans])
    out = []
    for p in plans:
        for _seg, ph in scans[id(p)].pending:
            cnt, _lo, hi, start = (int(v) for v in ph.batch.header(ph.i))
            if not cnt or hi - start + 1 > ph.batch.span_cap:
                continue
            bits = ph.batch.query_bits(ph.i)
            if type(ph).__name__ == "_PendingXZBitmapHits":
                h = len(bits) // 2
                out += [(bits[:h], start, cnt), (bits[h:], start, cnt)]
            else:
                out.append((bits, start, cnt))
    return out


def native_timings(store, data, plans1, plans3, walks):
    """Each native library at the main path's shapes against its plain
    edition on the same inputs (equal results required), host ms per call:
    the decode of config #1's and stream (a)'s span windows (one batched
    dispatch each, device route), the z range walks of config #1's plans
    and the xz walks of config #3's plans (as planning made them; the
    Python xz walk only for its first 2 calls, ~1 s each), the seek scans
    of config #1's 20 plans."""
    from geomesa_tpu_torch.curve import zorder
    from geomesa_tpu_torch.parallel.executor import _HostSeekScan
    from geomesa_tpu_torch import native

    out = {
        "decode_config1": decode_case(
            batch_windows(store, store._tables["gdelt"]["z3"], plans1["config1"])),
        "decode_xz2_bbox": decode_case(
            batch_windows(store, store._tables["ways"]["xz2"], plans3["xz2_bbox"])),
    }
    zcalls = walks["zranges"]
    nat_ms, got = host_ms(lambda: [native.zranges_native(*a) for a in zcalls])
    with plain_editions():
        py_ms, want = host_ms(lambda: [zorder.zranges(*a) for a in zcalls], reps=1)
    for g, w in zip(got, want):
        if list(zip(*(v.tolist() for v in g))) != [tuple(r) for r in w]:
            raise AssertionError("native z range walk differs from the Python walk")
    out["zranges_config1"] = {
        "calls": len(zcalls), "ranges_per_call": sum(len(g[0]) for g in got) / len(zcalls),
        "native_ms": nat_ms / len(zcalls), "python_ms": py_ms / len(zcalls),
    }
    xcalls = walks["xzranges"]
    nat_ms, got = host_ms(lambda: [sfc.ranges_boxes(w, m) for sfc, w, m in xcalls])
    head = xcalls[:2]
    with plain_editions():
        py_ms, want = host_ms(lambda: [sfc.ranges_boxes(w, m) for sfc, w, m in head], reps=1)
    if got[:len(head)] != want:
        raise AssertionError("native xz range walk differs from the Python walk")
    out["xzranges_config3"] = {
        "calls": len(xcalls), "ranges_per_call": sum(map(len, got)) / len(xcalls),
        "native_ms": nat_ms / len(xcalls), "python_ms": py_ms / len(head),
        "python_calls": len(head),
    }
    table = store._tables["gdelt"]["z3"]
    ex = store.executor
    seeks = []
    for p in plans1["config1"]:
        per_block = [(b, *b.scan_intervals(p.ranges)) for b in table.blocks]
        seeks.append(_HostSeekScan(table, per_block, ex._native_seek_pred(table, p)))
    if any(sc.pred is None for sc in seeks):
        raise AssertionError("config #1's plans must take the native seek scan")
    nat_ms, got = host_ms(lambda: [list(sc) for sc in seeks])
    with plain_editions():
        np_ms, want = host_ms(lambda: [list(sc) for sc in seeks])
    for g, w in zip(got, want):
        if len(g) != len(w) or not all(b1 is b2 and np.array_equal(r1, r2)
                                       for (b1, r1), (b2, r2) in zip(g, w)):
            raise AssertionError("native seek scan differs from its numpy edition")
    k = len(seeks)
    out["seek_config1"] = {
        "queries": k,
        "candidates_per_query": sum(int(np.maximum(e - s, 0).sum()) for sc in seeks
                                    for _b, s, e, _f in sc.per_block) / k,
        "rows_per_query": sum(len(r) for g in got for _b, r in g) / k,
        "native_ms": nat_ms / k, "numpy_ms": np_ms / k,
    }
    log(f"native host libraries: {json.dumps(out)}")
    return out


# -- the write lifecycle, the labels and the faults ----------------------------

# shape-tag suffixes of the kernel shapes the lifecycle and fault phases
# launch, timed as entries of their own: holed masks (rows tombstoned
# inside the key-sorted runs), the ways table after ``compact`` and the
# labelled table
HOLES = " holes"
COMPACTED = " compacted"
LABELLED = " labelled"
# the host kNN's bbox queries on config #5's table (the fault phase's trip)
ON_KNN = " knn"
# config #3's streams whose plans ``xz_cases`` reads
XZ_CASE_STREAMS = ("xz3_or_during", "xz2_or", "xz3_bbox_during", "xz2_bbox", "xz2_triangle")
# the telemetry phase: EXPLAIN ANALYZE runs a query this many times and
# keeps the best-attributed one (the reference's test does the same), needs
# this share of the wall in named stages, and the on / off timing alternates
# this many rounds of each
EXPLAIN_REPS = 5
ATTRIBUTION_MIN = 0.9
TELEMETRY_ROUNDS = 3


def _stage_names(st, out=None):
    out = set() if out is None else out
    out.add(st["stage"])
    for c in st.get("stages", ()):
        _stage_names(c, out)
    return out


def _forget_plan(store, name, query) -> None:
    """Drop one query's cached plan, so its next run plans (and shows the
    planner's stages) without clearing the plans other phases hold."""
    from geomesa_tpu_torch.filter.parser import to_cql

    key = to_cql(store._as_query(query).filter)
    with store._plan_lock:
        for k in [k for k in store._plan_cache if k[0] == name and k[1] == key]:
            del store._plan_cache[k]


def explain_check(store, name, query, want_rows, what: str) -> dict:
    """EXPLAIN ANALYZE of one query, best of EXPLAIN_REPS by attribution,
    each run planned afresh: the attribution, the stages, the hits against
    the oracle, the rows scanned, the receipt's bytes against the link
    counters' delta of the call, its launches against the launch counter's
    delta, and its fingerprint among the registry's rows."""
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.utils import devstats

    reg = devstats.devstats_metrics()
    best = None
    for _ in range(EXPLAIN_REPS):
        _forget_plan(store, name, query)
        rc0 = devstats.receipt_snapshot()
        l0 = reg.counter("kernel.launch.total")
        n0 = sum(kernels.LAUNCHES.values())
        ea = store.explain_analyze(name, query)
        torch.cuda.synchronize()
        delta = devstats.receipt_since(rc0)
        launches = reg.counter("kernel.launch.total") - l0
        if launches != sum(kernels.LAUNCHES.values()) - n0 or launches < 1:
            raise AssertionError(f"{what}: {launches} launches counted, "
                                 f"{sum(kernels.LAUNCHES.values()) - n0} by kernel")
        for k in ("recompiles", "h2d_bytes", "d2h_bytes"):
            if ea["receipt"][k] != delta[k]:
                raise AssertionError(f"{what}: receipt {ea['receipt']} != link delta {delta}")
        if ea["actual"]["hits"] != len(want_rows) or ea["actual"]["rows_scanned"] <= 0:
            raise AssertionError(f"{what}: hits {ea['actual']} vs {len(want_rows)} brute force")
        stages = _stage_names(ea["stages"])
        if not {"query", "plan", "scan", "scan.block"} <= stages:
            raise AssertionError(f"{what}: stages {sorted(stages)}")
        ea["launches"] = launches
        if best is None or ea["attribution"]["fraction"] > best["attribution"]["fraction"]:
            best = ea
    if best["fingerprint"] not in {r["fingerprint"] for r in store._plans_obj().rows(n=10**6)}:
        raise AssertionError(f"{what}: fingerprint {best['fingerprint']} not in the registry")
    if best["attribution"]["fraction"] < ATTRIBUTION_MIN:
        raise AssertionError(f"{what}: attribution {best['attribution']}")
    out = {
        "attribution": best["attribution"],
        "scan_path": best["plan"]["scan_path"],
        "fingerprint": best["fingerprint"],
        "actual": best["actual"],
        "receipt": best["receipt"],
        "launches": best["launches"],
        "misestimate_log2": best["misestimate_log2"],
        "stages": sorted(_stage_names(best["stages"])),
        "top_stages": [(st["stage"], st["duration_ms"], st["self_ms"])
                       for st in best["stages"].get("stages", ())],
    }
    log(f"{what} EXPLAIN ANALYZE: {json.dumps(out)}")
    return out


@contextlib.contextmanager
def telemetry_off():
    """Plan telemetry and tenant metering off (their knobs, and the cached
    flags re-read)."""
    from geomesa_tpu_torch.utils import plans, tenants
    from geomesa_tpu_torch.utils.config import properties

    with properties(geomesa_plans_enabled="false", geomesa_tenants_enabled="false"):
        plans.set_enabled(None)
        tenants.set_enabled(None)
        try:
            yield
        finally:
            plans.set_enabled(None)
            tenants.set_enabled(None)


def telemetry_timing(store, queries) -> dict:
    """Config #1's 20-query stream, pipelined (``query_many``, fids unread)
    and sync (each query through ``store.query``), with telemetry at the
    defaults and off, TELEMETRY_ROUNDS alternating rounds each; every answer
    the same size in every round, and after the timed rounds the first
    round's answers with telemetry off equal, fid for fid, those with it on
    (which ``config1_path`` held against brute force)."""
    times = {"on": {"pipelined": [], "sync": []}, "off": {"pipelined": [], "sync": []}}
    sizes = None
    first = {}
    for rnd in range(TELEMETRY_ROUNDS):
        for mode in ("on", "off"):
            with (telemetry_off() if mode == "off" else contextlib.nullcontext()):
                store.query_many("gdelt", queries)  # warm
                t0 = time.perf_counter()
                res = store.query_many("gdelt", queries)
                times[mode]["pipelined"].append((time.perf_counter() - t0) * 1e3 / len(queries))
                t0 = time.perf_counter()
                lone = [store.query("gdelt", q) for q in queries]
                times[mode]["sync"].append((time.perf_counter() - t0) * 1e3 / len(queries))
            got = [len(r) for r in res] + [len(r) for r in lone]
            if sizes is None:
                sizes = got
            elif got != sizes:
                raise AssertionError(f"telemetry {mode}: answer sizes moved: {got} vs {sizes}")
            if rnd == 0:
                first[mode] = res + lone
            del res, lone
    for i, (on, off) in enumerate(zip(first["on"], first["off"])):
        if not np.array_equal(np.asarray(on.fids), np.asarray(off.fids)):
            raise AssertionError(f"telemetry on / off: answer {i} differs")
    out = {mode: {k: {"ms": v, "min": min(v)} for k, v in d.items()} for mode, d in times.items()}
    for k in ("pipelined", "sync"):
        out[f"{k}_delta_ms_of_minima"] = out["on"][k]["min"] - out["off"][k]["min"]
    log(f"telemetry on / off, ms a query ({card_line()}): {json.dumps(out)}")
    return out


def brownout_check(store, data, streams) -> dict:
    """The brownout ladder forced by injected ticks of the store's timeline
    sampler (the queue-ratio thresholds at 0, one tick a rung): at level 2 a
    ``batch`` query sheds with ``ShedLoad``, an interactive one answers its
    oracle, and a cold pyramid build (a cell size no earlier phase cached)
    defers with ``decision.pyramid.brownout_deferred`` while the count
    equals its oracle; then the ladder exits one rung a tick and the
    answers stay equal."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.utils import timeline
    from geomesa_tpu_torch.utils.audit import ShedLoad, robustness_metrics
    from geomesa_tpu_torch.utils.config import properties

    x, y, t = data
    want = brute_force(x, y, t)
    bbox_boxes, bbox_cqls = streams["bbox"]
    want_bbox = int(in_box(x, y, bbox_boxes[0]).sum())
    sampler = timeline.TimelineSampler(store=store, interval_s=1.0, window_s=60.0)
    m = robustness_metrics()
    levels = []

    def tick_to(level):
        over = store._brownout.level < level
        knobs = {f"geomesa_brownout_queue_ratio_{i}": "0" for i in (1, 2, 3)} if over else {}
        with properties(geomesa_brownout_enter_ticks="1", geomesa_brownout_exit_ticks="1",
                        **knobs):
            for _ in range(6):
                if store._brownout.level == level:
                    return
                snap = sampler.tick()
                levels.append(snap.get("brownout", {}).get("level", store._brownout.level))
        raise AssertionError(f"brownout stuck at {store._brownout.level}, wanted {level}")

    def hinted(cql, pri):
        return Query.cql(cql, hints={"geomesa.query.priority": pri})

    d0 = m.counter("decision.pyramid.brownout_deferred")
    tick_to(2)
    try:
        store.query("gdelt", hinted(QUERY, "batch"))
        raise AssertionError("a batch query was answered at brownout level 2")
    except ShedLoad as e:
        retry_after = e.retry_after_s
    expect_fids(store.query("gdelt", hinted(QUERY, "interactive")), want, "brownout interactive")
    with properties(geomesa_agg_enabled="true", geomesa_agg_cell_bits="7"):
        n = store.count("gdelt", bbox_cqls[0])
    if n != want_bbox:
        raise AssertionError(f"brownout count {n} != {want_bbox}")
    deferred = m.counter("decision.pyramid.brownout_deferred") - d0
    if deferred != 1:
        raise AssertionError(f"{deferred} cold builds deferred at level 2, wanted 1")
    tick_to(0)
    for pri in ("batch", "interactive"):
        expect_fids(store.query("gdelt", hinted(QUERY, pri)), want, f"after brownout {pri}")
    out = {"levels": levels, "retry_after_s": retry_after, "deferred_builds": deferred,
           "count": n}
    log(f"brownout: {json.dumps(out)}")
    return out


def telemetry_path(store, data1, streams1, oracle3, streams3) -> dict:
    """The telemetry phase on config #1's and config #3's loaded tables
    (before the lifecycle phases mutate them): EXPLAIN ANALYZE of config
    #1's device query and of stream (a)'s first query, an audited 20-query
    ``query_many``, the brownout ladder, and config #1's stream with
    telemetry on and off."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.utils.audit import InMemoryAuditWriter

    x, y, t = data1
    out = {"explain_config1": explain_check(store, "gdelt", QUERY, brute_force(x, y, t),
                                            "config #1")}
    cql_a = streams3["xz2_bbox"][0][0]
    out["explain_stream_a"] = explain_check(store, "ways", cql_a, oracle3["xz2_bbox"][0],
                                            "stream (a)")
    queries = [Query.cql(c, properties=[]) for c in streams1["config1"][1]]
    store.audit_writer = InMemoryAuditWriter()
    try:
        res = store.query_many("gdelt", queries)
        evs = store.audit_writer.events
    finally:
        store.audit_writer = None
    if len(evs) != len(queries):
        raise AssertionError(f"{len(evs)} audit events for {len(queries)} queries")
    for i, (ev, r) in enumerate(zip(evs, res)):
        if (ev.hits, ev.h2d_bytes, ev.d2h_bytes, ev.recompiles) != (
                len(r), r.receipt["h2d_bytes"], r.receipt["d2h_bytes"], r.receipt["recompiles"]):
            raise AssertionError(f"audit event {i}: {ev} vs receipt {r.receipt}")
        if ev.scan_path != r.scan_path or ev.outcome != "ok":
            raise AssertionError(f"audit event {i}: {ev.scan_path} {ev.outcome}")
    out["audit"] = {"events": len(evs), "d2h_bytes": sum(e.d2h_bytes for e in evs),
                    "scan_paths": sorted({e.scan_path for e in evs})}
    out["brownout"] = brownout_check(store, data1, streams1)
    out["timing"] = telemetry_timing(store, queries)
    out["plans_rows"] = len(store._plans_obj().rows(n=10**6))
    out["tenants"] = [(r["tenant"], r["calls"], r["outcomes"])
                      for r in store._tenants_obj().rows(n=10)]
    return out


# the share of config #1's fids the lifecycle phase deletes (drawn by seed),
# besides every row of one of the stream's boxes
DELETE_FRAC = 0.01
DELETE_BOX_INDEX = 3
# the share of config #1's rows the age-off window expires
EXPIRE_FRAC = 0.3
# the labelled table: config #1's generator at LABEL_ROWS rows, a __vis__
# column of eight label expressions, queried under three authorization sets
LABEL_TABLE = "labelled"
LABEL_ROWS = 8_000_000
LABELS = ("", "USA", "USA&SECRET", "USA|GBR", "(USA|GBR)&SECRET", "GBR", "SECRET",
          "GBR&SECRET")
LABEL_AUTHS = {"none": [], "usa": ["USA"], "cleared": ["USA", "GBR", "SECRET"]}
# the fault phase's schedule and the breaker it runs under (its cooldown set
# through the knob's override tier; the phase moves the breaker's clock)
FAULT_SCHEDULE = "device.dispatch:error=0.05,device.fetch:error=0.1"
FAULT_SEED = 23
BREAKER_FAILURES = 3
BREAKER_COOLDOWN_S = 2.0
# queries of config #1's stream and of stream (a) asked while the circuit is
# open (each answered by a host table scan at full size)
OPEN_QUERIES = (5, 6)
# the robustness counters no phase but the fault phase may move
FAULT_COUNTERS = ("degrade.device_to_host", "degrade.mirror_rebuilds", "degrade.agg_to_scan",
                  "degrade.coalesce_to_solo", "breaker.device.opens")


def label_readable(label: str, auths) -> bool:
    """The numpy oracle's label test, independent of the port's parser: an
    expression of the eight labels is Python boolean arithmetic over
    membership."""
    if not label:
        return True
    expr = label.replace("&", " and ").replace("|", " or ")
    return bool(eval(expr, {}, {name: name in auths for name in ("USA", "GBR", "SECRET")}))


def robustness_counters() -> dict:
    from geomesa_tpu_torch.utils.audit import robustness_metrics

    reg = robustness_metrics()
    return {k: reg.counter(k) for k in FAULT_COUNTERS}


def relabel(shapes, suffix) -> dict:
    """A path's launch shapes with ``suffix`` on every tag."""
    return {(name, tag + suffix): c for (name, tag), c in shapes.items()}


def tag_cases(cases, suffix):
    """Kernel cases re-tagged with ``suffix`` (the table state of their
    path)."""
    for c in cases:
        c["tag"] += suffix
        c["shape"] += suffix
    return cases


def take_launches(acc, suffix="", plain=()):
    """Fold the launches since the last reset into ``acc`` (a path's
    (counts, shapes)), each tag with ``suffix`` but those of the kernels
    named in ``plain``, and reset the counts."""
    from geomesa_tpu_torch.ops import kernels

    counts, shapes = acc
    for name, c in kernels.LAUNCHES.items():
        counts[name] = counts.get(name, 0) + c
    for (name, tag), c in kernels.LAUNCH_SHAPES.items():
        key = (name, tag if name in plain else tag + suffix)
        shapes[key] = shapes.get(key, 0) + c
    kernels.reset_launches()


def xz_path_cases(store, streams3, shapes, suffix, path):
    """``xz_cases`` (config #3's kernels on the ways' segments as they
    stand) at the shapes a later path launched, tagged with ``suffix``;
    fails on a launched shape with no case."""
    from geomesa_tpu_torch.index.planner import Query

    plans = {k: [store._plan_cached("ways", Query.cql(c)) for c, _ in streams3[k]]
             for k in XZ_CASE_STREAMS}
    cases = {}
    for c in xz_cases(store, plans):
        key = (c["name"], c["tag"] + suffix)
        if shapes.get(key) and key not in cases:
            c["path"] = path
            cases[key] = c
    missing = [k for k, v in shapes.items() if v and k not in cases]
    if missing:
        raise AssertionError(f"{path} path launched {missing}: no case")
    return tag_cases(list(cases.values()), suffix)


def host_ms_once(fn):
    """(ms on the host clock of one call of ``fn`` around a synchronised
    device, its value)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, got


def lifecycle_path(store, data1, streams1, streams6):
    """Deletes on config #1's table: 1% of the fids drawn by seed plus every
    row of one of the stream's boxes; then the 20 ``bbox AND DURING``
    queries through ``query_many`` (and the first alone), ``count`` of the
    same boxes from the device count (with DURING) and from the rebuilt
    pyramid at 8 and 12 cell bits (bbox only), and the (h) heatmaps, each
    answer equal to brute force over the surviving rows. Returns (metrics,
    the alive mask)."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.utils.config import properties

    x, y, t = data1
    n = len(x)
    boxes, cqls = streams1["config1"]
    rng = np.random.default_rng(91)
    dead = np.zeros(n, dtype=bool)
    dead[rng.choice(n, int(n * DELETE_FRAC), replace=False)] = True
    dead |= in_box(x, y, boxes[DELETE_BOX_INDEX])
    alive = ~dead
    doomed = np.char.add("f", np.flatnonzero(dead).astype(str))
    out = {"deleted": int(dead.sum())}
    ex = store.executor
    out["delete_features_ms"], _ = host_ms_once(
        lambda: store.delete_features("gdelt", doomed.tolist()))
    for name in ("z3", "z2"):
        out[f"apply_tombstones_{name}_ms"], _ = host_ms_once(
            lambda nm=name: ex.device_index(store._tables["gdelt"][nm]))
    log(f"lifecycle: {out['deleted']} deletes in {out['delete_features_ms']:.1f} ms, "
        f"tombstones on the z3 mirror {out['apply_tombstones_z3_ms']:.1f} ms, "
        f"on the z2 mirror {out['apply_tombstones_z2_ms']:.1f} ms")
    res = store.query("gdelt", QUERY)
    expect_fids(res, np.flatnonzero(in_box(x, y, BOX) & (t > T_LO) & (t < T_HI) & alive),
                "lifecycle lone query")
    queries = [Query.cql(c, properties=[]) for c in cqls]
    t0 = time.perf_counter()
    results = store.query_many("gdelt", queries)
    out["query_ms_pipelined"] = (time.perf_counter() - t0) * 1e3 / len(queries)
    for i, (r, b) in enumerate(zip(results, boxes)):
        m = in_box(x, y, b) & (t > T_LO) & (t < T_HI) & alive
        expect_fids(r, np.flatnonzero(m), f"lifecycle query {i}")
        if r.scan_path != "device-exact/bitmap":
            raise AssertionError(f"lifecycle query {i} took {r.scan_path}")
    if len(results[DELETE_BOX_INDEX]):
        raise AssertionError("the deleted box still answers rows")
    for i, (cql, b) in enumerate(zip(cqls, boxes)):
        want = int((in_box(x, y, b) & (t > T_LO) & (t < T_HI) & alive).sum())
        got = store._count_device("gdelt", Query.cql(cql))
        if got != want or store.count("gdelt", cql) != want:
            raise AssertionError(f"lifecycle device count {i}: {got} vs {want}")
    out["pyramid"] = {}
    for bits in (8, 12):
        routes = []
        with properties(geomesa_agg_enabled="true", geomesa_agg_cell_bits=str(bits)):
            for i, b in enumerate(boxes):
                cql = bbox_cql(b)
                want = int((in_box(x, y, b) & alive).sum())
                got = store.count("gdelt", cql)
                if got != want:
                    raise AssertionError(f"lifecycle pyramid count {i} at {bits} bits: "
                                         f"{got} vs {want}")
                routes.append(pyramid_route(store, "gdelt", cql)[0])
        if "pyramid" not in routes:
            raise AssertionError(f"the rebuilt pyramid at {bits} bits answered no count")
        out["pyramid"][f"bits{bits}"] = {"pyramid_counts": routes.count("pyramid")}
    tname, items, _route = streams6["h_gdelt_64x32"]
    for i, (cql, box, during, (w, h)) in enumerate(items):
        res = store.query(tname, Query.cql(cql, hints=density_hint(box, w, h)))
        want = density_oracle(x[alive], y[alive], t[alive], box, during, w, h)
        if res.scan_path != "device-density" or not np.array_equal(
                res.aggregate["density"], want):
            raise AssertionError(f"lifecycle heatmap {i}: {res.scan_path}")
    torch.cuda.synchronize()
    return out, alive


def lifecycle_cases(store, plans1, streams1, streams6, launched):
    """The holed kernel cases of the lifecycle path, one per shape it
    launched: ``exact_bitmap_z3`` with ``tvalid`` holed (q = 1 and the
    stream's 20), ``exact_count_z3``, ``density_grid_z3`` (stream (h)) and
    ``pyramid_counts`` at 8 and 12 bits with ``agg_mask`` holed inside its
    key-sorted runs."""
    ex = store.executor
    tables = store._tables["gdelt"]
    seg3 = ex.device_index(tables["z3"]).segments[0]
    seg2 = ex.device_index(tables["z2"]).segments[0]
    descs = [ex._exact_descriptor(tables["z3"], p) for p in plans1["config1"]]
    ebox = _up(store, np.stack([d[0] for d in descs]))
    ewin = _up(store, np.stack([d[1] for d in descs]))
    cases = []
    for name, tag in sorted(launched):
        base = tag[:-len(HOLES)]
        if name == "exact_bitmap_z3":
            q = int(base.split("=")[1])
            cases.append(exact_case(name, seg3, ebox[:q], ewin[:q], "lifecycle"))
        elif name == "exact_count_z3":
            cases.append(count_case(name, seg3, ebox[0], ewin[0], "lifecycle"))
        elif name == "exact_count_z2":
            # a bbox count the pyramid declined (the boundary dominated)
            table, plan = _plan_of(store, "gdelt", bbox_cql(streams1["config1"][0][0]))
            box, _win = ex._exact_descriptor(table, plan)
            cases.append(count_case(name, seg2, _up(store, box), None, "lifecycle"))
        elif name == "density_grid_z3":
            cases += density_cases(store, {"lifecycle": streams6["h_gdelt_64x32"]})
        elif name == "pyramid_counts":
            bits = int(base.split()[0].split("=")[1])
            cases.append(pyramid_case(tables["z2"], seg2, bits, "lifecycle"))
        else:
            raise AssertionError(f"lifecycle path launched {name} {tag}: no holed case")
    return tag_cases(cases, HOLES)


def ageoff_path(store, data1, streams1, alive):
    """Age-off on config #1's type: ``geomesa.feature.expiry`` in its user
    data expires about 30% of the rows; the 20 queries and their counts
    (through the query: the device count declines) mask them at scan;
    then ``age_off()`` tombstones them, the window goes, and the device
    count answers again. A row whose date falls inside the cut's drift
    over the phase (the store reads the clock at each scan) may go either
    way; each answer must be the rows at or after one cut inside that
    drift. Returns (metrics, the alive mask after the sweep)."""
    from geomesa_tpu_torch.index.planner import Query

    x, y, t = data1
    boxes, cqls = streams1["config1"]
    ft = store.get_schema("gdelt")
    cut = int(np.quantile(t, EXPIRE_FRAC))
    expiry_ms = int(time.time() * 1000) - cut
    ft.user_data["geomesa.feature.expiry"] = f"{expiry_ms} ms"
    out = {"expiry_ms": expiry_ms}

    def drift():
        return int(time.time() * 1000) - expiry_ms

    def check(rows_got, m_base, lo, hi, what):
        """``rows_got`` = the rows of ``m_base`` at or after one cut in [lo, hi]."""
        sure = m_base & (t >= hi)
        maybe = m_base & (t >= lo) & (t < hi)
        got = np.zeros(len(t), dtype=bool)
        got[rows_got] = True
        if (got & ~(sure | maybe)).any() or (sure & ~got).any():
            raise AssertionError(f"{what}: rows outside the age-off window")
        kept, dropped = t[got & maybe], t[maybe & ~got]
        if len(kept) and len(dropped) and dropped.max() >= kept.min():
            raise AssertionError(f"{what}: no one cut explains the answer")

    try:
        if store._shortcuts_ok("gdelt", ft):
            raise AssertionError("an aging type must decline the count shortcuts")
        lo = drift()
        results = store.query_many("gdelt", [Query.cql(c, properties=[]) for c in cqls])
        counts = [store.count("gdelt", c) for c in cqls[:4]]
        hi = drift()
        for i, (r, b) in enumerate(zip(results, boxes)):
            m = in_box(x, y, b) & (t > T_LO) & (t < T_HI) & alive
            fids = np.asarray(r.fids, dtype=np.str_)
            got = fid_rows(fids) if len(fids) else np.empty(0, dtype=np.int64)
            check(got, m, lo, hi, f"age-off query {i}")
        for i, (c, b) in enumerate(zip(counts, boxes)):
            m = in_box(x, y, b) & (t > T_LO) & (t < T_HI) & alive
            if not int((m & (t >= hi)).sum()) <= c <= int((m & (t >= lo)).sum()):
                raise AssertionError(f"age-off count {i}: {c}")
        lo = drift()
        out["age_off_ms"], aged = host_ms_once(lambda: store.age_off("gdelt"))
        hi = drift()
    finally:
        del ft.user_data["geomesa.feature.expiry"]
    tomb = store._tables["gdelt"]["z3"].tombstones
    gone = np.zeros(len(t), dtype=bool)
    gone[fid_rows(np.asarray(list(tomb), dtype=np.str_))] = True
    swept = gone & alive
    if int(swept.sum()) != aged:
        raise AssertionError(f"age_off returned {aged}, tombstoned {int(swept.sum())}")
    check(np.flatnonzero(alive & ~swept), alive, lo, hi, "the age_off sweep")
    alive = alive & ~swept
    out["aged_off"] = aged
    for i, (cql, b) in enumerate(zip(cqls, boxes)):
        want = int((in_box(x, y, b) & (t > T_LO) & (t < T_HI) & alive).sum())
        got = store._count_device("gdelt", Query.cql(cql))
        if got != want:
            raise AssertionError(f"device count after age_off {i}: {got} vs {want}")
    log(f"age-off: {aged} rows swept in {out['age_off_ms']:.1f} ms")
    torch.cuda.synchronize()
    return out, alive


def compaction_path(store, ways, streams3, oracle3, entries_out, ints):
    """Compaction on config #3's ways: 1% tombstoned by seed; streams (a)-(c)
    on the holed dual planes (the ``compaction`` path), (d) and (e) on the
    holed masks (``compaction_mask``), then ``compact`` and every stream
    again on the rebuilt mirror (``compacted``), each query equal to
    ``oracle_rows`` less the deleted ways. Each path's shapes are timed
    as entries of their own, tagged `` holes`` or `` compacted``, into
    ``entries_out``. Returns (metrics, {path: launches})."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.ops import kernels

    n = len(ways["kind"])
    dead = np.zeros(n, dtype=bool)
    dead[np.random.default_rng(92).choice(n, n // 100, replace=False)] = True
    store.delete_features("ways", np.char.add("w", np.flatnonzero(dead).astype(str)).tolist())
    out = {"deleted": int(dead.sum())}
    launched = {}

    def run(names, what):
        for name in names:
            items = streams3[name]
            results = store.query_many("ways", [Query.cql(c, properties=[]) for c, _ in items])
            for i, r in enumerate(results):
                rows = oracle3[name][i]
                expect_fids(r, rows[~dead[rows]], f"{what} {name} query {i}", prefix="w")

    kernels.reset_launches()
    run(("xz2_bbox", "xz3_bbox_during", "xz2_triangle"), "holed")
    launched["compaction"] = (dict(kernels.LAUNCHES), relabel(kernels.LAUNCH_SHAPES, HOLES))
    kernels.reset_launches()
    run(("xz2_or", "xz3_or_during"), "holed")
    launched["compaction_mask"] = (dict(kernels.LAUNCHES), relabel(kernels.LAUNCH_SHAPES, HOLES))
    entries_out += kernel_checks(
        xz_path_cases(store, streams3, launched["compaction"][1], HOLES, "compaction")
        + xz_path_cases(store, streams3, launched["compaction_mask"][1], HOLES,
                        "compaction_mask"), *ints)
    out["compact_ms"], _ = host_ms_once(lambda: store.compact("ways"))
    kernels.reset_launches()
    t0 = time.perf_counter()
    run(("xz2_bbox",), "compacted")
    out["first_stream_after_compact_ms"] = (time.perf_counter() - t0) * 1e3
    run(("xz3_bbox_during", "xz2_triangle", "xz2_or", "xz3_or_during"), "compacted")
    launched["compacted"] = (dict(kernels.LAUNCHES), relabel(kernels.LAUNCH_SHAPES, COMPACTED))
    for table in store._tables["ways"].values():
        if table.tombstones or len(table.blocks) != 1:
            raise AssertionError("compaction left tombstones or several blocks")
    entries_out += kernel_checks(
        xz_path_cases(store, streams3, launched["compacted"][1], COMPACTED, "compacted"), *ints)
    out["dead"] = dead
    log(f"compaction: {out['deleted']} ways deleted, compact {out['compact_ms']:.0f} ms, "
        f"the first stream after it (the mirror rebuild) "
        f"{out['first_stream_after_compact_ms']:.0f} ms")
    torch.cuda.synchronize()
    return out, launched


def labels_path(store, n, streams1):
    """A GDELT-style table of ``n`` rows ingested through
    ``writer.write_columns`` with a ``__vis__`` column of eight label
    expressions, config #1's 20 queries under three authorization sets
    (fids equal to the numpy oracle of box AND label), and the declines:
    no device count (the count equals the oracle's), no density
    push-down (the grid equals the oracle's)."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.schema.featuretype import parse_spec

    x, y, t = synthesize(n, seed=31)
    labels = np.random.default_rng(32).integers(0, len(LABELS), n)
    vis = np.asarray(LABELS, dtype=object)[labels]
    ft = parse_spec(LABEL_TABLE, "dtg:Date,*geom:Point:srid=4326")
    store.create_schema(ft)
    fids = np.char.add("f", np.arange(n).astype(f"<U{len(str(n - 1))}"))
    t0 = time.perf_counter()
    store.writer(LABEL_TABLE).write_columns(
        {"__fid__": fids, "geom__x": x, "geom__y": y, "dtg": t, "__vis__": vis})
    out = {"rows": n, "ingest_s": time.perf_counter() - t0}
    boxes, cqls = streams1["config1"]
    queries = [Query.cql(c, properties=[]) for c in cqls]
    try:
        for name, auths in LABEL_AUTHS.items():
            store.auths = auths
            readable = np.array([label_readable(lb, auths) for lb in LABELS])[labels]
            t0 = time.perf_counter()
            results = store.query_many(LABEL_TABLE, queries)
            out[f"{name}_query_ms_pipelined"] = (time.perf_counter() - t0) * 1e3 / len(queries)
            for i, (r, b) in enumerate(zip(results, boxes)):
                m = in_box(x, y, b) & (t > T_LO) & (t < T_HI) & readable
                expect_fids(r, np.flatnonzero(m), f"labels {name} query {i}")
                if not r.scan_path.startswith("device"):
                    raise AssertionError(f"labels {name} query {i} took {r.scan_path}")
            table, plan = _plan_of(store, LABEL_TABLE, cqls[0])
            if store.executor.count_scan(table, plan) is not None:
                raise AssertionError("a labelled table must decline the device count")
            want = int((in_box(x, y, boxes[0]) & (t > T_LO) & (t < T_HI) & readable).sum())
            if store.count(LABEL_TABLE, cqls[0]) != want:
                raise AssertionError(f"labels {name}: count")
            res = store.query(LABEL_TABLE, Query.cql(cqls[0], hints=density_hint(boxes[0], 64,
                                                                                 32)))
            grid = density_oracle(x[readable], y[readable], t[readable], boxes[0], True, 64, 32)
            if res.scan_path == "device-density" or not np.array_equal(
                    res.aggregate["density"], grid):
                raise AssertionError(f"labels {name}: density {res.scan_path}")
            out[f"{name}_readable"] = int(readable.sum())
            log(f"labels {name}: {out[f'{name}_query_ms_pipelined']:.2f} ms/query pipelined, "
                f"{int(readable.sum())} readable rows")
    finally:
        store.auths = None
    torch.cuda.synchronize()
    return out


def labels_cases(store, streams1, shapes):
    """``exact_bitmap_z3`` on the labelled table's z3 segment at each q the
    labels path launched it (config #1's queries' descriptors), tagged
    `` labelled``; fails on any other launched shape."""
    ex = store.executor
    cqls = streams1["config1"][1]
    seg = ex.device_index(store._tables[LABEL_TABLE]["z3"]).segments[0]
    descs = [ex._exact_descriptor(*_plan_of(store, LABEL_TABLE, c)) for c in cqls]
    ebox = _up(store, np.stack([d[0] for d in descs]))
    ewin = _up(store, np.stack([d[1] for d in descs]))
    cases = []
    for name, tag in sorted(k for k, v in shapes.items() if v):
        if name != "exact_bitmap_z3":
            raise AssertionError(f"labels path launched {name} {tag}: no case")
        q = int(tag[:-len(LABELLED)].split("=")[1])
        cases.append(exact_case(name, seg, ebox[:q], ewin[:q], "labels"))
    return tag_cases(cases, LABELLED)


def knn_host_cases(store, shapes):
    """``exact_bitmap`` on config #5's segment at the host kNN's first
    window around ``KNN_QUERY`` (q = 1), for the shapes the fault phase's
    tripped kNN launched, tagged `` knn`` (its ``knn_topk`` launches are
    config #5's shapes, timed there); fails on any other launched shape."""
    from geomesa_tpu_torch.process.geodesy import degrees_boxes
    from geomesa_tpu_torch.process.knn import _bbox_cql

    ex = store.executor
    cql = _bbox_cql(store.get_schema(KNN_TABLE), degrees_boxes(*KNN_QUERY, 1000.0), None)
    table, plan = _plan_of(store, KNN_TABLE, cql)
    box, win = ex._exact_descriptor(table, plan)
    seg = ex.device_index(table).segments[0]
    cases = []
    for name, tag in sorted(k for k, v in shapes.items() if v):
        if name == "knn_topk":
            continue
        if (name, tag) != (f"exact_bitmap_{table.index.name}", "q=1" + ON_KNN):
            raise AssertionError(f"the kNN trip launched {name} {tag}: no case")
        cases.append(exact_case(name, seg, _up(store, box[None]),
                                None if win is None else _up(store, win[None]), "faults_knn"))
    return tag_cases(cases, ON_KNN)


def fault_path(store, data1, streams1, alive, streams3, oracle3, ways_dead):
    """Config #1's stream and stream (a) under the seeded
    ``FAULT_SCHEDULE`` until the breaker opens: every answer equal to the
    fault-free one and each fired fault one ``degrade.device_to_host``;
    while open (the first ``OPEN_QUERIES`` of each stream), no kernel
    launches and every route reads ``host-table-breaker``; after the cooldown the probe query closes the
    circuit and rebuilds the mirror (its receipt's host -> device bytes).
    Last, one injected device-kNN failure answers the identical list on
    ``host-bbox`` and trips the session's device-kNN flag. Returns
    (metrics, {path: launches}): ``faults`` (config #1's holed table),
    ``faults_ways`` (the compacted ways) and ``faults_knn`` (``knn_topk``
    and the host kNN's bbox queries, tagged `` knn``)."""
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.process import knn_search, last_knn_path
    from geomesa_tpu_torch.utils import faults
    from geomesa_tpu_torch.utils.audit import robustness_metrics
    from geomesa_tpu_torch.utils.breaker import CircuitBreaker
    from geomesa_tpu_torch.utils.config import properties

    x, y, t = data1
    boxes, cqls = streams1["config1"]
    ex = store.executor
    reg = robustness_metrics()
    # the breaker's clock moves only when the phase moves it: the open
    # circuit's checks (host scans at full size) may take longer than the
    # cooldown, which must not elapse before the probe is due
    clock = [0.0]
    with properties(geomesa_breaker_failures=str(BREAKER_FAILURES),
                    geomesa_breaker_cooldown=f"{BREAKER_COOLDOWN_S} seconds"):
        ex.breaker = CircuitBreaker("device", clock=lambda: clock[0])
    if ex.breaker.cooldown_s != BREAKER_COOLDOWN_S:
        raise AssertionError("the cooldown knob did not reach the breaker")
    q1 = [Query.cql(c, properties=[]) for c in cqls]
    qa = [Query.cql(c, properties=[]) for c, _ in streams3["xz2_bbox"]]
    want1 = [np.flatnonzero(in_box(x, y, b) & (t > T_LO) & (t < T_HI) & alive) for b in boxes]
    want_a = [rows[~ways_dead[rows]] for rows in oracle3["xz2_bbox"]]

    def check(res1, res_a, what):
        for i, r in enumerate(res1):
            expect_fids(r, want1[i], f"{what} config #1 query {i}")
        for i, r in enumerate(res_a):
            expect_fids(r, want_a[i], f"{what} stream (a) query {i}", prefix="w")

    def fired():
        return sum(v for k, v in reg.report().items()
                   if k.startswith(("fault.device.dispatch.", "fault.device.fetch.")))

    f0, d0 = fired(), reg.counter("degrade.device_to_host")
    out = {"schedule": FAULT_SCHEDULE, "seed": FAULT_SEED}
    launched = {p: ({}, {}) for p in ("faults", "faults_ways", "faults_knn")}
    t_phase = time.perf_counter()
    rounds = 0
    routes = {}
    kernels.reset_launches()
    with faults.inject(FAULT_SCHEDULE, seed=FAULT_SEED):
        while ex.breaker.state != "open":
            rounds += 1
            if rounds > 50:
                raise AssertionError("the breaker never opened under the schedule")
            res1 = store.query_many("gdelt", q1)
            take_launches(launched["faults"], HOLES)
            res_a = store.query_many("ways", qa)
            take_launches(launched["faults_ways"], COMPACTED)
            check(res1, res_a, f"faults round {rounds}")
            for r in res1 + res_a:
                routes[r.scan_path] = routes.get(r.scan_path, 0) + 1
    out.update(rounds=rounds, fired=fired() - f0,
               degrades=reg.counter("degrade.device_to_host") - d0, routes=routes)
    if out["fired"] == 0 or out["degrades"] != out["fired"]:
        raise AssertionError(f"faults: {out['fired']} fired, {out['degrades']} degrades")
    out["rounds_s"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    res1 = store.query_many("gdelt", q1[:OPEN_QUERIES[0]])
    res_a = store.query_many("ways", qa[:OPEN_QUERIES[1]])
    out["open_circuit_s"] = time.perf_counter() - t0
    check(res1, res_a, "open circuit")
    if {r.scan_path for r in res1 + res_a} != {"host-table-breaker"}:
        raise AssertionError(f"open circuit routes: {sorted({r.scan_path for r in res1 + res_a})}")
    if any(kernels.LAUNCHES.values()):
        raise AssertionError("a kernel launched while the circuit was open")
    if ex.breaker.state != "open":
        raise AssertionError(f"the circuit left open early: {ex.breaker.state}")
    clock[0] += BREAKER_COOLDOWN_S
    rebuilt = id(store._tables["gdelt"]["z3"]) not in ex._cache
    probe = store.query("gdelt", QUERY)
    take_launches(launched["faults"], HOLES)
    expect_fids(probe, want1[0], "the probe query")
    if ex.breaker.state != "closed" or not probe.scan_path.startswith("device"):
        raise AssertionError(f"the probe left the breaker {ex.breaker.state} "
                             f"({probe.scan_path})")
    out["probe_receipt"] = probe.receipt
    out["probe_rebuilt_mirror"] = rebuilt
    # a rebuilt mirror uploads at least the z3 keys and the exact columns
    if probe.receipt["h2d_bytes"] < (8 * len(x) if rebuilt else 1):
        raise AssertionError(f"the probe query moved {probe.receipt['h2d_bytes']} B up")
    log(f"faults: {out['fired']} fired over {rounds} rounds ({out['rounds_s']:.1f} s), "
        f"{out['degrades']} degrades, routes {routes}; the open circuit "
        f"{out['open_circuit_s']:.1f} s; the probe moved {probe.receipt['h2d_bytes']} B up")
    ex.breaker = CircuitBreaker("device")
    # last: the device-kNN trip is sticky for the session
    got = knn_search(store, KNN_TABLE, *KNN_QUERY, k=KNN_K)
    if last_knn_path() != "device-topk":
        raise AssertionError(f"the fault-free kNN took {last_knn_path()}")
    d0 = reg.counter("degrade.device_to_host")
    with faults.inject("device.fetch:error@0x1", seed=FAULT_SEED):
        tripped = knn_search(store, KNN_TABLE, *KNN_QUERY, k=KNN_K)
    if tripped != got or last_knn_path() != "host-bbox" or not getattr(ex, "_device_tripped", False):
        raise AssertionError(f"the kNN trip: {last_knn_path()}, same list {tripped == got}")
    if reg.counter("degrade.device_to_host") != d0 + 1:
        raise AssertionError("the kNN failure did not degrade once")
    out["knn_trip"] = {"path": last_knn_path(), "same_list": True}
    take_launches(launched["faults_knn"], ON_KNN, plain=("knn_topk",))
    torch.cuda.synchronize()
    return out, launched


if __name__ == "__main__":
    sys.exit(main())
