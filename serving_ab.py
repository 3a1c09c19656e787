"""Times the solo query path of two trees of the repository in turns, on one GPU.

A serving change's check that the path one caller takes alone did not
get slower: each turn is a process of its own that imports the port from
its tree, builds config #1's table at N rows (``chip_smoke.synthesize``,
the z3 and z2 exact columns uploaded) and times, with ``GEOMESA_SEEK=0``
(the device routes):

  * ``sync``: config #1's 20 jittered ``bbox AND DURING`` queries through
    ``store.query``, one at a time (``device-exact/runs``);
  * ``pipelined``: the same 20 through ``store.query_many``, fids unread
    (``device-exact/bitmap``);
  * ``bbox_sync``: the bbox-only stream's 8 queries (z2) one at a time;
  * ``resid_sync``: the 8 ``(A OR B) AND DURING`` queries one at a time
    (the candidate route and the host post-filter);

each ms a query, the median of ROUNDS rounds, after a warm round. The
turns go own, other, other, own, where "other" is the tree in DIR (for
example ``git archive`` of the parent commit, unpacked under ``_ab/``).

    python3 serving_ab.py --ab DIR [--rows N] [--out DIR]

Prints one JSON line per turn and a summary line; with ``--out DIR`` it
also writes them to ``DIR/serving_ab.json``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROUNDS = 5


def measure(root: str, rows: int) -> dict:
    """One turn: the port and chip_smoke of ``root``, config #1 at ``rows``."""
    sys.path.insert(0, os.path.abspath(root))
    os.environ["GEOMESA_SEEK"] = "0"
    import numpy as np
    import torch

    import chip_smoke as cs
    import geomesa_tpu_torch
    from geomesa_tpu_torch.index.planner import Query
    from geomesa_tpu_torch.schema.featuretype import parse_spec
    from geomesa_tpu_torch.store.datastore import TorchDataStore

    if not geomesa_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"imported {geomesa_tpu_torch.__file__}, not {root}'s port")
    store = TorchDataStore()
    x, y, t = cs.synthesize(rows)
    ft = parse_spec("gdelt", "dtg:Date,*geom:Point:srid=4326")
    store.create_schema(ft)
    store._insert_columns(ft, {"__fid__": np.char.add("f", np.arange(rows).astype(str)),
                               "geom__x": x, "geom__y": y, "dtg": t})
    for name in ("z3", "z2"):
        table = store._tables["gdelt"][name]
        for seg in store.executor.device_index(table).segments:
            seg.load_exact(table)
    torch.cuda.synchronize()
    boxes, cqls = cs.make_queries(cs.REPS)
    bbox = [cs.bbox_cql(b) for b in cs.jittered_boxes(cs.RESIDUAL_REPS, seed=17)]
    resid = [f"({cs.bbox_cql(a)} OR {cs.bbox_cql(b)}) AND {cs.DURING}"
             for a, b in zip(cs.jittered_boxes(cs.RESIDUAL_REPS, seed=23),
                             cs.jittered_boxes(cs.RESIDUAL_REPS, box=cs.BOX_B, seed=29))]
    pipelined = [Query.cql(c, properties=[]) for c in cqls]

    def one_at_a_time(items):
        t0 = time.perf_counter()
        for c in items:
            store.query("gdelt", c)
        return (time.perf_counter() - t0) / len(items) * 1e3

    def stream():
        t0 = time.perf_counter()
        store.query_many("gdelt", pipelined)
        return (time.perf_counter() - t0) / len(pipelined) * 1e3

    runs = {"sync": lambda: one_at_a_time(cqls), "pipelined": stream,
            "bbox_sync": lambda: one_at_a_time(bbox), "resid_sync": lambda: one_at_a_time(resid)}
    out = {"root": root, "rows": rows}
    for name, fn in runs.items():
        fn()  # warm: mirrors, span windows, plan cache
        got = sorted(fn() for _ in range(ROUNDS))
        out[name] = got[len(got) // 2]
        out[name + "_rounds"] = got
    res = store.query("gdelt", cqls[0])
    if len(res) != len(cs.brute_force(x, y, t, boxes[0])):
        raise AssertionError(f"{root}: config #1's first query is wrong")
    out["device"] = torch.cuda.get_device_name(0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="DIR", help="the other tree, timed in turns with this one")
    ap.add_argument("--rows", type=int, default=20_000_000, help="config #1 points")
    ap.add_argument("--out", help="directory for serving_ab.json")
    ap.add_argument("--measure", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure, args.rows)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this script needs a CUDA device",
              file=sys.stderr)
        return 2
    if not args.ab:
        ap.error("--ab DIR is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    turns = []
    for which, root in (("own", "."), ("other", args.ab), ("other", args.ab), ("own", ".")):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root,
                               "--rows", str(args.rows)], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise RuntimeError(f"the {which} turn ({root}) failed")
        turns.append({"which": which, **json.loads(proc.stdout.strip().splitlines()[-1])})
        print(json.dumps(turns[-1]), flush=True)
    summary = {"card": card, "rows": args.rows}
    for name in ("sync", "pipelined", "bbox_sync", "resid_sync"):
        summary[name] = {w: [t[name] for t in turns if t["which"] == w] for w in ("own", "other")}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "serving_ab.json"), "w") as f:
            json.dump({"turns": turns, "summary": summary}, f, indent=1)
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
