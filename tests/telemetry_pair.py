"""The store pair the port's telemetry tests share.

The same seeded numpy columns go into the reference ``TpuDataStore`` (a
one-device CPU mesh, run as on an accelerator: the exact device predicate,
batched dispatch, the bitmap protocol, no host seek) and into the port's
``TorchDataStore(device="cpu")``. ``REF_ENV`` is set for the whole module
by each test file's fixture; both packages read it.
"""

import numpy as np

import jax
from jax.sharding import Mesh

from geomesa_tpu.parallel.executor import TpuScanExecutor
from geomesa_tpu.schema.featuretype import parse_spec as ref_parse_spec
from geomesa_tpu.store.datastore import TpuDataStore

from geomesa_tpu_torch.parallel.executor import TorchScanExecutor
from geomesa_tpu_torch.schema.featuretype import parse_spec
from geomesa_tpu_torch.store.datastore import TorchDataStore

REF_ENV = {
    "GEOMESA_EXACT_DEVICE": "1",
    "GEOMESA_DEVBATCH": "1",
    "GEOMESA_BATCH_PROTO": "bitmap",
    "GEOMESA_SEEK": "0",
    # a query alone never rides the coalescer; the tests that want a
    # group form one themselves
    "GEOMESA_BATCH_ENABLED": "false",
}
T0 = 1483228800000
DAY = 86400000
SPEC = "actor:String,val:Integer,dtg:Date,*geom:Point:srid=4326"
ACTORS = ("USA", "FRA", "CHN")


def columns(n=3000, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "__fid__": np.array([f"f{i}" for i in range(n)], dtype=object),
        "geom__x": rng.uniform(-80, 80, n),
        "geom__y": rng.uniform(-80, 80, n),
        "dtg": T0 + rng.integers(0, 30 * DAY, n),
        "val": rng.integers(0, 100, n).astype(np.int32),
        "actor": np.array([ACTORS[i % 3] for i in range(n)], dtype=object),
    }


def ref_mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("shards",))


def pair(n=3000, seed=3, name="gdelt", ref_kw=None, port_kw=None, cols=None):
    """(reference store, port store) holding the same rows."""
    cols = columns(n, seed) if cols is None else cols
    ref = TpuDataStore(executor=TpuScanExecutor(ref_mesh()), **(ref_kw or {}))
    port = TorchDataStore(executor=TorchScanExecutor(device="cpu"), **(port_kw or {}))
    for ds, parse in ((ref, ref_parse_spec), (port, parse_spec)):
        ft = parse(name, SPEC)
        ds.create_schema(ft)
        ds._insert_columns(ft, {k: v.copy() for k, v in cols.items()})
    return ref, port


# the row fields that hold wall times (every other field must be equal)
TIMED = ("total_ms", "last_ms", "latency", "worst_exemplar")


def untimed(rows, drop=()):
    """Registry rows without their timings (and ``drop``), for equality."""
    return [{k: v for k, v in r.items() if k not in TIMED and k not in drop} for r in rows]
