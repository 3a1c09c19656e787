"""Times the kNN, polygon, pyramid and join kernels at the shapes their paths launch, on one GPU.

A kernel round's quick loop: builds config #5's table, the polygon table
and config #1's table at full size (``chip_smoke.config5`` /
``config_poly`` / ``config1``), then runs ``chip_smoke.kernel_checks`` on
``knn_topk`` at k = 17, 26 and 1125, on ``poly_dual_bitmap`` at z2 q=24
E=16 and z3 q=8 E=32, on ``pyramid_counts`` at 8 and 12 cell bits over
config #1's z2 segment and the polygon table's, and on ``join_pip`` /
``join_dwithin`` at the shapes the join phase launches (``chip_smoke.
join_path``: the fences and sites written and both builds warmed by
``query_join`` on config #1's base query, every pair set held to its f64
oracle; then ``join_cases`` on the first probe chunk, each beside its
dead-slot floor): each launch held against its plain edition, its device
time split by kernel (``pass_ms``) beside its bound, read in two profiler
windows and the larger kept (``ms_windows``; an entry whose windows differ
by more than 5%, or fall below the bound, is flagged), and, for each DIR
holding another design of a kernel's source (``DIR/knn_topk.cu``,
``DIR/poly_dual_bitmap.cu``, ``DIR/pyramid_counts.cu``, ``DIR/join.cu``,
same C interface), timed in turns with the committed design, each turn's
split by kernel beside it. With a DIR holding another ``knn_topk.cu`` it
also times config #5's searches end to end in turns under each design
(``knn_search``: (n), bench_knn's query at k = 10, and (o)'s 16 points at
k = 1000; ms a search on the host's clock, SEARCH_ROUNDS rounds); with
another ``pyramid_counts.cu``, the cold pyramid build of config #1's table
and the polygon table at 8 and 12 bits (``build_pyramid``'s ``agg.build``
ms, BUILD_ROUNDS rounds); with another ``join.cu``, the warm contains and
dwithin joins (ms a ``query_join`` on the host's clock around a
synchronised card, JOIN_ROUNDS rounds). ``--kernels`` picks the groups
(all four by default; ``join`` alone builds config #1's table only). It
checks no launch count: ``chip_smoke.py`` does.

    python3 kernel_ab.py [--ab DIR [DIR ...]] [--kernels GROUP ...] [--rows N] [--gdelt N]
                         [--out DIR]

The join kernels' A/B against another commit's design, in one line:
``mkdir -p _ab/old && git show <commit>:geomesa_tpu_torch/csrc/join.cu >
_ab/old/join.cu && python3 kernel_ab.py --kernels join --ab _ab/old``.

Prints one line per (kernel, shape); with ``--out DIR`` it also writes
the entries to ``DIR/kernel_ab.json``.
"""

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager, nullcontext

import torch

import chip_smoke as cs

SHAPES = {("knn_topk", "k=17"), ("knn_topk", "k=26"), ("knn_topk", "k=1125"),
          ("poly_dual_bitmap_z2", "q=24 E=16"), ("poly_dual_bitmap_z3", "q=8 E=32")}
# the pyramid phase's builds: cell bits over config #1's z2 segment and the
# polygon table's (their shape tags follow from the tables' padded rows)
PYRAMID_BITS = (8, 12)
PYRAMID_TABLES = ("gdelt", cs.POLY_TABLE)
BUILD_ROUNDS = 3


def search_ms(store, points, k: int) -> float:
    """ms a kNN search over ``points`` at ``k``, on the host's clock."""
    from geomesa_tpu_torch.process import knn_search

    t0 = time.perf_counter()
    for pt in points:
        knn_search(store, cs.KNN_TABLE, *pt, k=k)
    return (time.perf_counter() - t0) / len(points) * 1e3


SEARCH_ROUNDS = 5


def search_ab(store, src: str) -> dict:
    """(n) and (o) at k = 1000 under the committed ``knn_topk`` and the one
    built from ``src``, in turns (own, other, other, own; SEARCH_ROUNDS
    times), each reading warmed by two searches."""
    from geomesa_tpu_torch.ops import kernels

    streams = {"n_k10": ([cs.KNN_QUERY] * cs.KNN_REPS, cs.KNN_K),
               "o_k1000": (cs.knn_points(), 1000)}
    out = {name: {"own": [], "other": []} for name in streams}
    for which in ("own", "other", "other", "own") * SEARCH_ROUNDS:
        with kernels.using_source("knn_topk", src) if which == "other" else nullcontext():
            for name, (points, k) in streams.items():
                search_ms(store, points[:2], k)
                out[name][which].append(search_ms(store, points, k))
    cs.log(f"searches A/B vs {src}: {json.dumps(out)}")
    return out


def pyramid_cases(store):
    """``pyramid_counts`` at PYRAMID_BITS over each table's z2 segment."""
    cases = []
    for name in PYRAMID_TABLES:
        table = store._tables[name]["z2"]
        for seg in store.executor.device_index(table).segments:
            cases += [cs.pyramid_case(table, seg, bits, "pyramid") for bits in PYRAMID_BITS]
    return cases


@contextmanager
def other_pyramid_design(src: str):
    """Inside the block, the pyramid build launches the ``pyramid_counts``
    built from ``src`` through ``chip_smoke.pyramid_counts_caller`` (which
    takes a design of any scratch), uncounted."""
    from geomesa_tpu_torch.ops import kernels

    own = kernels.pyramid_counts
    kernels.pyramid_counts = lambda xi, yi, mask, bits, starts=None: cs.pyramid_counts_caller(
        xi, yi, mask, bits, starts)
    try:
        with kernels.using_source("pyramid_counts", src):
            yield
    finally:
        kernels.pyramid_counts = own


def build_ab(store, src: str) -> dict:
    """The cold pyramid build (``build_pyramid``, its ``agg.build`` timer)
    of each PYRAMID_TABLES table at each PYRAMID_BITS under the committed
    ``pyramid_counts`` and the one built from ``src``, in turns (own,
    other, other, own; BUILD_ROUNDS times), each after one warm-up build."""
    from geomesa_tpu_torch.ops.pyramid import build_pyramid
    from geomesa_tpu_torch.utils.config import properties
    from geomesa_tpu_torch.utils.devstats import devstats_metrics

    reg = devstats_metrics()

    def build_ms(name, bits):
        with properties(geomesa_agg_cell_bits=str(bits)):
            _c, _g, _t, before = reg.snapshot()
            build_pyramid(store._tables[name]["z2"], store.get_schema(name), store.executor)
            _c, _g, _t, after = reg.snapshot()
        return (after["agg.build"][1] - before.get("agg.build", (0, 0.0))[1]) * 1e3

    keys = [(name, bits) for name in PYRAMID_TABLES for bits in PYRAMID_BITS]
    out = {f"{name}_bits{bits}": {"own": [], "other": []} for name, bits in keys}
    for which in ("own", "other", "other", "own") * BUILD_ROUNDS:
        with other_pyramid_design(src) if which == "other" else nullcontext():
            for name, bits in keys:
                build_ms(name, bits)
                out[f"{name}_bits{bits}"][which].append(build_ms(name, bits))
    cs.log(f"cold builds A/B vs {src}: {json.dumps(out)}")
    return out


JOIN_ROUNDS = 3


def join_ms(store, build: str, pred: str) -> float:
    """ms of one warm ``query_join`` of config #1's base query against
    ``build``, on the host's clock around a synchronised card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = store.query_join(build, ("gdelt", cs.QUERY), predicate=pred)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if res.stats["path"] != "device-join" or res.stats["build"] != "hit":
        raise AssertionError(f"{build} join: {res.stats['path']} {res.stats['build']}")
    return ms


def join_ab(store, src: str) -> dict:
    """The warm contains and dwithin joins under the committed ``join.cu``
    and the one built from ``src``, in turns (own, other, other, own;
    JOIN_ROUNDS times), each reading after one warm-up join."""
    from geomesa_tpu_torch.ops import kernels

    joins = {"contains": ("fences", "contains"),
             "dwithin": ("sites", f"dwithin({cs.JOIN_RADIUS_M})")}
    out = {kind: {"own": [], "other": []} for kind in joins}
    for which in ("own", "other", "other", "own") * JOIN_ROUNDS:
        with kernels.using_source("join", src) if which == "other" else nullcontext():
            for kind, (build, pred) in joins.items():
                join_ms(store, build, pred)
                out[kind][which].append(join_ms(store, build, pred))
    cs.log(f"warm joins A/B vs {src}: {json.dumps(out)}")
    return out


# the kernel groups --kernels picks from, each with its kernel source
GROUP_SOURCES = {"knn": "knn_topk", "poly": "poly_dual_bitmap", "pyramid": "pyramid_counts",
                 "join": "join"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", nargs="+", default=[], metavar="DIR")
    ap.add_argument("--kernels", nargs="+", default=list(GROUP_SOURCES), choices=GROUP_SOURCES,
                    metavar="GROUP", help="kernel groups to time: " + ", ".join(GROUP_SOURCES))
    ap.add_argument("--rows", type=int, default=cs.KNN_ROWS,
                    help="points of config #5's and the polygon table")
    ap.add_argument("--gdelt", type=int, default=20_000_000, help="config #1 points")
    ap.add_argument("--out", help="directory for kernel_ab.json (none written without it)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.log("torch.cuda.is_available() is false: this script needs a CUDA device")
        return 2
    os.environ["GEOMESA_SEEK"] = "0"

    from geomesa_tpu_torch.ops import kernels
    from geomesa_tpu_torch.store.datastore import TorchDataStore

    cs.log(f"card: {cs.card_line()}")
    kernels.build_all()
    names = [GROUP_SOURCES[g] for g in args.kernels]
    for name in names:
        for line in kernels.ptxas_report()[name].splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"ptxas {name}: {line.strip()}")
    ab = {}
    for d in args.ab:
        for name in names:
            if os.path.exists(os.path.join(d, name + ".cu")):
                ab.setdefault(name, []).append(os.path.join(d, name + ".cu"))
    store = TorchDataStore()
    cases = []
    if {"knn", "poly", "pyramid"} & set(args.kernels):
        _data, _track, _oracle, plans_m, _setup = cs.config5(store, args.rows)
        _streams, plans_p, _oracle_p, _setup_p = cs.config_poly(store, args.rows, plans_m)
        cases += cs.knn_cases(store, SHAPES) if "knn" in args.kernels else []
        cases += cs.poly_cases(store, plans_p, SHAPES) if "poly" in args.kernels else []
    if {"pyramid", "join"} & set(args.kernels):
        data1 = cs.config1(store, args.gdelt)[0]
    if "pyramid" in args.kernels:
        cases += pyramid_cases(store)
    joins = None
    if "join" in args.kernels:
        kernels.reset_launches()
        joins = cs.join_path(store, data1)
        cases += cs.join_cases(store, dict(kernels.LAUNCH_SHAPES))
    entries = cs.kernel_checks(
        cases, cs.lane_ops_per_s(cs.INT32_LANES_PER_SM), cs.lane_ops_per_s(cs.FP32_LANES_PER_SM),
        ab)
    searches = {src: search_ab(store, src) for src in ab.get("knn_topk", [])}
    builds = {src: build_ab(store, src) for src in ab.get("pyramid_counts", [])}
    join_turns = {src: join_ab(store, src) for src in ab.get("join", [])}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "kernel_ab.json"), "w") as f:
            json.dump({"kernels": entries, "searches": searches, "builds": builds,
                       "joins": joins, "join_turns": join_turns}, f, indent=1)
    for e in entries:
        print(e["name"], e["shape_tag"], f"{e['ms']:.4f} ms, bound {e['bound_ms']:.4f}",
              f"windows {e['ms_windows']}" + (" FLAGGED" if e["flagged"] else ""),
              json.dumps({k: round(v, 4) for k, v in e["pass_ms"].items()}),
              json.dumps(e.get("ab_ms", {})),
              {k: e[k] for k in ("live_pairs", "straddle_rows", "edge_rows", "edge_tests",
                                 "straddles", "pairs_tested", "floor_of") if k in e})
    for src, times in searches.items():
        print("searches", src, json.dumps(times))
    for src, times in builds.items():
        print("cold builds", src, json.dumps(times))
    for src, times in join_turns.items():
        print("warm joins", src, json.dumps(times))
    print(f"{sum(e['flagged'] for e in entries)} of {len(entries)} entries flagged")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
