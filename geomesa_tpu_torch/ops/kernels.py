"""Hand-written CUDA kernels of the scan path and their wrappers.

The kernels live in ``geomesa_tpu_torch/csrc`` (each source says which TPU
or XLA function it replaces, what bounds it on an H100 and how its design
answers that):

  * ``candidate_mask`` (``csrc/candidate_mask.cu``) replaces the Pallas
    ``_z3_mask_kernel`` / ``_z2_mask_kernel`` of
    ``geomesa_tpu/ops/pallas_kernels.py``;
  * ``exact_bitmap`` (``csrc/exact_bitmap.cu``) replaces the batched exact
    predicate of ``geomesa_tpu/parallel/executor.py``
    ``_exact_bitmap_batch_fn``, with the attribute plane of ``_attr_combine``
    (member, range, notmember, vocabmask) fused in; its count edition
    ``exact_count`` replaces ``_exact_count_fn`` and its histogram edition
    ``exact_stat_hist`` ``_exact_stat_hist_fn`` (the count and stats
    push-downs);
  * ``xz_mask`` (``csrc/xz_mask.cu``) replaces the Pallas
    ``_xz2_mask_kernel`` / ``_xz3_mask_kernel``;
  * ``xz_dual_bitmap`` (``csrc/xz_dual_bitmap.cu``) replaces the batched
    extent predicate of ``geomesa_tpu/parallel/executor.py``
    ``_xz_bitmap_batch_fn`` (the (hit, decided) planes), with the same
    attribute editions;
  * ``density_grid`` (``csrc/density_grid.cu``) replaces the Pallas
    ``_density_kernel`` and fuses the density band, masks and band indices
    of ``geomesa_tpu/ops/aggregations.py`` ``make_sharded_density_dual``
    around it;
  * ``knn_topk`` (``csrc/knn_topk.cu``) replaces ``_knn_fn`` of
    ``geomesa_tpu/parallel/executor.py`` (the f32 haversine distance of
    every row and its top-k);
  * ``poly_dual_bitmap`` (``csrc/poly_dual_bitmap.cu``) replaces the banded
    polygon ray cast of ``geomesa_tpu/parallel/executor.py``
    ``_poly_bitmap_batch_fn`` (the (hit, decided) planes), with the same
    attribute editions;
  * ``pyramid_counts`` (``csrc/pyramid_counts.cu``) replaces the XLA
    ``make_pyramid_counts`` of ``geomesa_tpu/ops/aggregations.py`` (the
    aggregate pyramid's per-cell row counts of a z2 segment): a grid that
    L2 holds (up to 10 bits) is zeroed and each warp's runs of a cell added
    with one atomic; a larger one is stored once, cell by cell, by tiles of
    the segment's longest key-sorted block that each own a z range, with
    shared runs, other blocks and rows out of order added by a later atomic
    pass;
  * ``join`` (``csrc/join.cu``) replaces the spatial join's ``_pip_fn``
    ("join_pip") and ``_dwithin_fn`` ("join_dwithin") of
    ``geomesa_tpu/ops/join.py``: the (accept, check) dual masks of a probe
    chunk's rows against their bucket's candidates, one launch a chunk
    (one block a group and candidate slot) where the reference launches
    once a bucket group;
  * ``devseek`` (``csrc/devseek.cu``) replaces the device-assisted seek's
    ``_devseek_fn`` ("devseek") and ``_devseek_xz_fn`` ("devseek_xz") of
    ``geomesa_tpu/parallel/executor.py``: the host-planned candidate
    intervals expanded on the device, the candidates' keys gathered and
    tested exactly, and the packed bitmap (two planes for extents) over the
    candidate space;
  * the coalescer's stacked full-table mask batches run on those kernels:
    ``exact_mask_batch`` (``exact_bitmap``'s bits) replaces
    ``_exact_mask_batch_fn``, and ``dual_mask_batch`` (``xz_dual_bitmap``'s
    or ``poly_dual_bitmap``'s planes) ``_dual_mask_batch_fn``, each
    counted under names of its own.

Each wrapper takes the kernel's plain PyTorch edition for tensors on the
CPU, and for CUDA tensors launches the kernel on the current stream of the
tensors' device, under ``torch.cuda.device`` (the launchers size their
grids from that device's own SM count, ``csrc/launch_grid.cuh``), counting
the launch in ``LAUNCHES`` by instantiation and in ``LAUNCH_SHAPES`` by
instantiation and shape, or raises. The attribute editions count under the
kernel's name and ``_<edition>``. The counts move under a lock, so
wrappers may launch from many threads (each on its thread's current
stream). Kernels build at first use with ``nvcc`` for ``sm_90a`` into a
plain-C shared library per source, loaded with ``ctypes``, once however
many threads ask (a lock per source, a temporary file per process and
thread); the build directory is ``geomesa_tpu_torch/_build``, every build
and launch counts in ``utils/devstats.py``, and ``ptxas_report`` returns
what ``-Xptxas -v`` said of each kernel (registers, spills).
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.ops.aggregations import (
    density_dual,
    pyramid_counts_plain,
    reciprocal_f32,
)
from geomesa_tpu_torch.ops.filters import (
    ATTR_KINDS,
    attr_combine,
    bbox_overlap_mask,
    exact_st_mask,
    devseek_plain,
    devseek_xz_plain,
    poly_planes,
    temporal_mask,
    xz_exact_planes,
    z2_query_mask,
    z3_query_mask,
)
from geomesa_tpu_torch.ops.geometry import join_dwithin_plain, join_pip_plain
from geomesa_tpu_torch.ops.zkernels import pack_mask_rows
from geomesa_tpu_torch.utils import devstats

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# exported C symbol -> kernel source
SOURCES = {
    "candidate_mask": "candidate_mask.cu",
    "exact_bitmap": "exact_bitmap.cu",
    "xz_mask": "xz_mask.cu",
    "xz_dual_bitmap": "xz_dual_bitmap.cu",
    "density_grid": "density_grid.cu",
    "knn_topk": "knn_topk.cu",
    "poly_dual_bitmap": "poly_dual_bitmap.cu",
    "pyramid_counts": "pyramid_counts.cu",
    "join": "join.cu",
    "devseek": "devseek.cu",
}
# extra nvcc flags per source: the f32 arithmetic of the density band, the
# kNN distance, the polygon ray cast and the join's masks must not contract
# into FMAs that the reference does not do
_NVCC_FLAGS = {name: ["-fmad=false"]
               for name in ("density_grid", "knn_topk", "poly_dual_bitmap", "join")}

# launches per kernel instantiation, counted where the wrapper launches
LAUNCHES: Dict[str, int] = {
    "candidate_mask_z3": 0,
    "candidate_mask_z2": 0,
    "exact_bitmap_z3": 0,
    "exact_bitmap_z2": 0,
    **{f"exact_bitmap_{z}_{kind}": 0 for z in ("z3", "z2") for kind in ATTR_KINDS},
    "xz_mask_xz2": 0,
    "xz_mask_xz3": 0,
    "xz_dual_bitmap_xz2": 0,
    "xz_dual_bitmap_xz3": 0,
    "density_grid_z3": 0,
    "density_grid_z2": 0,
    "knn_topk": 0,
    "poly_dual_bitmap_z3": 0,
    "poly_dual_bitmap_z2": 0,
    # the count and stats push-downs and the attribute editions of the dual
    # planes that chip_smoke.py's paths drive; any other instantiation
    # counts under its own name from its first launch
    "exact_count_z3": 0,
    "exact_count_z2_member": 0,
    "exact_count_z2_range": 0,
    "exact_stat_hist_z2": 0,
    "xz_dual_bitmap_xz2_member": 0,
    "xz_dual_bitmap_xz2_range": 0,
    "poly_dual_bitmap_z2_member": 0,
    "poly_dual_bitmap_z2_range": 0,
    # the coalescer's mask batches that chip_smoke.py's concurrent phase drives
    "exact_mask_batch_z3": 0,
    "exact_mask_batch_z2_member": 0,
    "exact_mask_batch_z2_range": 0,
    "xz_mask_batch_xz2": 0,
    "poly_mask_batch_z2": 0,
    # the aggregate pyramid's build (chip_smoke.py's pyramid phase)
    "pyramid_counts": 0,
    # the spatial join's masks and the device-assisted seek (chip_smoke.py's
    # join and device-seek phases)
    "join_pip": 0,
    "join_dwithin": 0,
    "devseek_z3": 0,
    "devseek_xz_xz2": 0,
    "devseek_xz_xz3": 0,
}
# launches per (instantiation, shape): "q=<descriptors>" for the bitmap
# kernels, the mask batches and the count (+ " K=<codes>" for member and
# notmember, " U=<lookup size>" for vocabmask, " E=<edges a query>" for the
# polygons), "U=<bins>" for the histogram, "K=<boxes> W=<windows>" for the
# masks, "<W>x<H>" for the grid, "k=<rows>" for the top-k, "bits=<b>
# n=<rows>" for the pyramid counts, "C=<candidates> E=<edges>" / "C=<candidates>"
# for the join's masks, "cand=<candidate space>" for the device-assisted seek
LAUNCH_SHAPES: Counter = Counter()
# both counts move under one lock: wrappers launch from many threads
_COUNT_LOCK = threading.Lock()


class _ThreadDict(threading.local):
    """A dict of which each thread sees its own."""

    def __init__(self):
        self.d: Dict[str, int] = {}

    def __getitem__(self, key: str) -> int:
        return self.d[key]

    def __setitem__(self, key: str, value: int) -> None:
        self.d[key] = value

    def get(self, key: str, default=None):
        return self.d.get(key, default)


# kernel launches of the calling thread's last call of a wrapper that runs
# several passes (knn_topk), as its launcher reports them
LAST_PASSES = _ThreadDict()

# the exact kernels keep q descriptors and per-warp partials in shared memory
EXACT_MAX_Q = 256
# the attribute plane: at most this many codes per query (member and
# notmember) and this many lookup entries per query (vocabmask)
ATTR_MAX_K = 32
ATTR_MAX_U = 1 << 16
# the candidate kernels stage boxes and windows in 48 KB of shared memory
_CAND_SMEM = 48 * 1024
# consecutive rows each density_grid thread takes per step (n is a multiple)
DENSITY_ROWS = 4
# int64 fields of one extent descriptor: (xmin, ymin, xmax, ymax, zero,
# rect, t_lo, t_hi)
XZ_DESC = 8
# queries of one polygon launch
POLY_MAX_Q = 64

_LIBS: Dict[str, ctypes.CDLL] = {}
# one build lock per source (the first launches of a kernel from several
# threads build it once), made under _LOCKS_LOCK
_BUILD_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A fault of the program in a hand kernel, not of the link: it failed
    to build, its wrapper was called with tensors it does not take, or its
    launch failed. The executor degrades nothing on it, strikes no breaker
    and the query raises."""


class KernelBuildError(KernelError):
    """A kernel library failed to build or load (``nvcc`` failed or is
    missing, or the library does not load)."""


class KernelLaunchError(KernelError):
    """A kernel's C entry point returned a CUDA error."""


class KernelArgumentError(KernelError, ValueError):
    """A wrapper was given tensors or sizes its kernel does not take (a
    ``ValueError`` too, as the checks raised before)."""


class KernelDtypeError(KernelArgumentError, TypeError):
    """A wrapper was given a tensor of the wrong dtype."""


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        LAUNCH_SHAPES.clear()


def _count(name: str, shape: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
        LAUNCH_SHAPES[(name, shape)] += 1
    devstats.count_launch()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _compile(name: str, src: Optional[str] = None) -> str:
    """Compile one source (``name``'s own unless ``src`` is given) into
    ``_build/<name>.<hash>.so`` unless present."""
    src = src or os.path.join(CSRC, SOURCES[name])
    flags = _NVCC_FLAGS.get(name, [])
    h = hashlib.sha256(" ".join(flags).encode())
    # the source and every header it may include from csrc
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"{name}.{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # unique to the process and the thread: concurrent builds of one source
    # never write one file, and os.replace publishes a whole library
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", *flags, "-I", CSRC, "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", tmp,
        src,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    with open(f"{tmp}.ptxas", "w") as f:
        f.write(proc.stderr)
    os.replace(f"{tmp}.ptxas", out + ".ptxas")
    os.replace(tmp, out)
    devstats.count_build(name, time.perf_counter() - t0)
    return out


def ptxas_report() -> Dict[str, str]:
    """What ``-Xptxas -v`` printed for each built source: per kernel
    instantiation its registers, shared memory and spill stores."""
    out = {}
    for name, lib in _LIBS.items():
        try:
            with open(lib._name + ".ptxas") as f:
                out[name] = f.read()
        except OSError:
            out[name] = ""
    return out


def build_all() -> Dict[str, str]:
    """Build and load every kernel source in parallel (one nvcc each);
    returns the library paths by kernel name."""
    names = list(SOURCES)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = list(pool.map(_lib, names))
    return {name: lib._name for name, lib in zip(names, libs)}


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# each C entry point's arguments (pointers and the stream as c_void_p)
_ARGTYPES = {
    "candidate_mask": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _LL, _P],
    "exact_bitmap": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _LL, _P],
    "xz_mask": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _LL, _P],
    "exact_count": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _LL, _P],
    "exact_stat_hist": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _LL, _P],
    "xz_dual_bitmap": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _LL, _P,
                       _I, _P, _P, _I],
    "density_grid": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _F, _F, _I, _I,
                     _P, _P, _P, _I, _LL, _P],
    "knn_topk": [_P, _P, _P, _F, _F, _LL, _LL, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong)],
    "poly_dual_bitmap": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _LL, _P,
                         _I, _P, _P, _I],
    "pyramid_counts": [_P, _P, _P, _I, _P, _LL, _P, _LL, _LL, _P, _LL],
    "join_pip": [_P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _F, _P, _LL, _P],
    "join_dwithin": [_P, _P, _P, _P, _I, _P, _I, _P, _P, _F, _F, _P, _LL, _P],
    "devseek": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P],
    "devseek_xz": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P],
}


# the C entry points of each source (default: the one named after it)
_ENTRIES = {"exact_bitmap": ("exact_bitmap", "exact_count", "exact_stat_hist"),
            "join": ("join_pip", "join_dwithin"),
            "devseek": ("devseek", "devseek_xz")}


def _load(name: str, path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for entry in _ENTRIES.get(name, (name,)):
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[entry]
    if name == "knn_topk":
        lib.knn_topk_scratch.restype = ctypes.c_longlong
        lib.knn_topk_scratch.argtypes = [_LL, _LL]
    # an earlier design of pyramid_counts (an --ab source) sizes no scratch
    if name == "pyramid_counts" and hasattr(lib, "pyramid_counts_scratch"):
        lib.pyramid_counts_scratch.restype = ctypes.c_longlong
        lib.pyramid_counts_scratch.argtypes = [_LL, _I]
    _LIBS[name] = lib
    return lib


def _lib(name: str) -> ctypes.CDLL:
    """``name``'s library, built and loaded at its first use, once however
    many threads ask at once."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCKS_LOCK:
        lock = _BUILD_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is None:
            try:
                lib = _load(name, _compile(name))
            except KernelBuildError:
                raise
            except Exception as e:
                raise KernelBuildError(f"{name}: {type(e).__name__}: {e}") from e
    return lib


@contextlib.contextmanager
def using_source(name: str, src: str):
    """Inside the block, ``name``'s wrapper launches the kernel built from
    ``src`` (a source with the same C interface): for timing two designs
    of one kernel in turns on the same inputs."""
    own = _lib(name)
    _load(name, _compile(name, src))
    try:
        yield
    finally:
        _LIBS[name] = own


def _check(t: torch.Tensor, what: str, dtype, device, shape=None) -> None:
    if t.dtype != dtype:
        raise KernelDtypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise KernelArgumentError(f"{what}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise KernelArgumentError(f"{what}: not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise KernelArgumentError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"{name} launch failed: CUDA error {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -- K1: candidate mask ------------------------------------------------------


def candidate_mask(xi, yi, valid, boxes, bins=None, offs=None, windows=None) -> torch.Tensor:
    """Conservative z3 (``windows`` given) or z2 candidate mask -> bool[n].

    ``xi, yi`` (and ``bins, offs``) int32[n], ``valid`` bool[n], ``boxes``
    int32[K, 4] as (xlo, ylo, xhi, yhi), ``windows`` int32[W, 3] as (bin,
    lo, hi)."""
    has_time = windows is not None
    if xi.device.type == "cpu":
        if has_time:
            return z3_query_mask(xi, yi, bins, offs, valid, boxes, windows)
        return z2_query_mask(xi, yi, valid, boxes)
    if xi.device.type != "cuda":
        raise KernelArgumentError(f"candidate_mask: unsupported device {xi.device}")
    dev, n = xi.device, xi.shape[0]
    if n % 4:
        raise KernelArgumentError(f"candidate_mask: rows ({n}) must be a multiple of 4")
    cols = [("xi", xi), ("yi", yi)] + ([("bins", bins), ("offs", offs)] if has_time else [])
    for what, t in cols:
        _check(t, what, torch.int32, dev, (n,))
        if t.data_ptr() % 16:
            raise KernelArgumentError(f"candidate_mask: {what} is not 16-byte aligned")
    _check(valid, "valid", torch.bool, dev, (n,))
    if valid.data_ptr() % 4:
        raise KernelArgumentError("candidate_mask: valid is not 4-byte aligned")
    _check(boxes, "boxes", torch.int32, dev)
    k = boxes.shape[0]
    w = 0
    if has_time:
        _check(windows, "windows", torch.int32, dev)
        w = windows.shape[0]
    if boxes.shape[1:] != (4,) or (has_time and windows.shape[1:] != (3,)):
        raise KernelArgumentError("candidate_mask: boxes must be [K, 4] and windows [W, 3]")
    if 4 * (4 * k + 3 * w) > _CAND_SMEM:
        raise KernelArgumentError(f"candidate_mask: {k} boxes / {w} windows exceed shared memory")
    fn = _lib("candidate_mask").candidate_mask
    with torch.cuda.device(dev):
        out = torch.empty(n, dtype=torch.bool, device=dev)
        err = fn(
            int(has_time), xi.data_ptr(), yi.data_ptr(),
            bins.data_ptr() if has_time else None, offs.data_ptr() if has_time else None,
            valid.data_ptr(), boxes.data_ptr(), k,
            windows.data_ptr() if has_time else None, w,
            out.data_ptr(), n, _stream(dev),
        )
    _raise_on(err, "candidate_mask")
    _count("candidate_mask_z3" if has_time else "candidate_mask_z2", f"K={k} W={w}")
    return out


# -- K2: exact bitmap --------------------------------------------------------


def _span_bounds(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cnt, lo, hi) of a bool mask; an empty mask gives lo=0, hi=n-1
    (the reference's _span_bounds)."""
    n = m.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=m.device)
    cnt = m.sum(dtype=torch.int64)
    lo = torch.where(m, idx, n).min()
    hi = torch.where(m, idx, -1).max()
    empty = cnt == 0
    return cnt, torch.where(empty, 0, lo), torch.where(empty, n - 1, hi)


def exact_bitmap_plain(xk, yk, tk, valid, boxes, wins=None, codes=None, qcodes=None,
                       attr_kind=None):
    """Plain edition of :func:`exact_bitmap`, one query at a time."""
    bits, hdr = [], []
    for i in range(boxes.shape[0]):
        m = exact_st_mask(xk, yk, valid, boxes[i], tk, None if wins is None else wins[i])
        if attr_kind is not None:
            m = attr_combine(m, codes, qcodes[i], attr_kind)
        bits.append(pack_mask_rows(m))
        hdr.append(torch.stack(_span_bounds(m)))
    n8 = xk.shape[0] // 8
    if not bits:
        return (torch.empty((0, n8), dtype=torch.uint8, device=xk.device),
                torch.empty((0, 3), dtype=torch.int32, device=xk.device))
    return torch.stack(bits), torch.stack(hdr).to(torch.int32)


def _attr_launch_args(codes, qcodes, attr_kind, n: int, q: int, dev, what: str):
    """(edition number, K or U_pad, shape tag suffix) of an attribute plane
    launch of the kernel ``what``, after checking its tensors; (0, 0, "")
    without one."""
    if attr_kind is None:
        if codes is not None or qcodes is not None:
            raise KernelArgumentError(f"{what}: codes and qcodes need an attr_kind")
        return 0, 0, ""
    if attr_kind not in ATTR_KINDS:
        raise KernelArgumentError(f"{what}: unknown attr_kind {attr_kind!r}")
    _check(codes, "codes", torch.int32, dev, (n,))
    if qcodes is None or qcodes.dim() != 2 or qcodes.shape[0] != q:
        raise KernelArgumentError(f"{what}: qcodes must be [{q}, ...] for {attr_kind}")
    width = qcodes.shape[1]
    if attr_kind == "range":
        _check(qcodes, "qcodes", torch.int32, dev, (q, 2))
        tag = ""
    elif attr_kind == "vocabmask":
        _check(qcodes, "qcodes", torch.uint8, dev)
        if not 0 < width <= ATTR_MAX_U:
            raise KernelArgumentError(f"{what}: lookup size {width} not in [1, {ATTR_MAX_U}]")
        tag = f" U={width}"
    else:
        _check(qcodes, "qcodes", torch.int32, dev)
        if not 0 < width <= ATTR_MAX_K:
            raise KernelArgumentError(f"{what}: {width} codes not in [1, {ATTR_MAX_K}]")
        tag = f" K={width}"
    return ATTR_KINDS.index(attr_kind) + 1, width, tag


def _attr_name(name: str, edition: int, attr_kind) -> str:
    """The launch-count name of an instantiation: ``name``, and
    ``_<edition>`` for an attribute edition."""
    return name + (f"_{attr_kind}" if edition else "")


def exact_bitmap(xk, yk, tk, valid, boxes, wins=None, codes=None, qcodes=None,
                 attr_kind=None):
    """q exact predicates -> (bits u8[q, n/8] MSB-first, hdr int32[q, 3]).

    ``xk, yk`` (and ``tk``) int64[n] sort keys; ``valid`` bool[n] (the
    temporal-valid column when ``wins`` is given); ``boxes`` int64[q, 4]
    keys of (xmin, xmax, ymin, ymax); ``wins`` int64[q, 2] inclusive (lo,
    hi) ms. With ``attr_kind`` (one of ``ATTR_KINDS``) each query's mask
    also takes its attribute test (:func:`attr_combine`): ``codes``
    int32[n] and ``qcodes`` one row per query, int32[q, K] (member,
    notmember), int32[q, 2] (range) or uint8[q, U_pad] (vocabmask). ``hdr``
    rows are (count, first hit, last hit) of the combined mask, with the
    empty rule of the reference: no hit gives (0, 0, n - 1)."""
    if xk.device.type == "cpu":
        return exact_bitmap_plain(xk, yk, tk if wins is not None else None, valid, boxes, wins,
                                  codes, qcodes, attr_kind)
    return _launch_exact_bitmap("exact_bitmap", xk, yk, tk, valid, boxes, wins, codes, qcodes,
                                attr_kind)


def _launch_exact_bitmap(name: str, xk, yk, tk, valid, boxes, wins, codes, qcodes, attr_kind):
    """The ``exact_bitmap`` launch of :func:`exact_bitmap` and
    :func:`exact_mask_batch`, counted under ``name`` + ``_z3`` / ``_z2``
    (+ ``_<edition>``)."""
    has_time = wins is not None
    if xk.device.type != "cuda":
        raise KernelArgumentError(f"{name}: unsupported device {xk.device}")
    dev, n = xk.device, xk.shape[0]
    q = boxes.shape[0]
    if n % 32 or n >= 2**31:
        raise KernelArgumentError(f"exact_bitmap: rows ({n}) must be a multiple of 32 below 2^31")
    if not 0 < q <= EXACT_MAX_Q:
        raise KernelArgumentError(f"exact_bitmap: q ({q}) must be in [1, {EXACT_MAX_Q}]")
    for what, t in [("xk", xk), ("yk", yk)] + ([("tk", tk)] if has_time else []):
        _check(t, what, torch.int64, dev, (n,))
    _check(valid, "valid", torch.bool, dev, (n,))
    _check(boxes, "boxes", torch.int64, dev, (q, 4))
    if has_time:
        _check(wins, "wins", torch.int64, dev, (q, 2))
    edition, width, tag = _attr_launch_args(codes, qcodes, attr_kind, n, q, dev, "exact_bitmap")
    fn = _lib("exact_bitmap").exact_bitmap
    with torch.cuda.device(dev):
        bits = torch.empty((q, n // 8), dtype=torch.uint8, device=dev)
        # the launcher initialises and decodes the header in place; its
        # last word is the launch's block ticket
        hdr = torch.empty(3 * q + 1, dtype=torch.int32, device=dev)
        err = fn(
            int(has_time), xk.data_ptr(), yk.data_ptr(),
            tk.data_ptr() if has_time else None, valid.data_ptr(), boxes.data_ptr(),
            wins.data_ptr() if has_time else None, q, edition,
            codes.data_ptr() if edition else None, qcodes.data_ptr() if edition else None,
            width, bits.data_ptr(), hdr.data_ptr(), n, _stream(dev),
        )
    _raise_on(err, "exact_bitmap")
    _count(_attr_name(f"{name}_" + ("z3" if has_time else "z2"), edition, attr_kind),
           f"q={q}{tag}")
    return bits, hdr[:3 * q].view(q, 3)


def exact_mask_batch_plain(xk, yk, tk, valid, boxes, wins=None, codes=None, qcodes=None,
                           attr_kind=None):
    """Plain edition of :func:`exact_mask_batch`: the stacked
    ``exact_st_mask`` (and ``attr_combine``) packed, one query at a time
    (:func:`exact_bitmap_plain`'s bits)."""
    return exact_bitmap_plain(xk, yk, tk, valid, boxes, wins, codes, qcodes, attr_kind)[0]


def exact_mask_batch(xk, yk, tk, valid, boxes, wins=None, codes=None, qcodes=None,
                     attr_kind=None) -> torch.Tensor:
    """q stacked exact predicates -> ONE full-table packed plane u8[q, n/8]
    MSB-first, no header and no span framing (the reference's
    ``_exact_mask_batch_fn``, the coalescer's sweep). Arguments as for
    :func:`exact_bitmap`, whose kernel computes the plane: its ``bits``
    output is this plane. Counted under ``exact_mask_batch_z3`` /
    ``_z2`` (+ ``_<edition>``); q is the real query count."""
    if xk.device.type == "cpu":
        return exact_mask_batch_plain(xk, yk, tk if wins is not None else None, valid, boxes,
                                      wins, codes, qcodes, attr_kind)
    return _launch_exact_bitmap("exact_mask_batch", xk, yk, tk, valid, boxes, wins, codes,
                                qcodes, attr_kind)[0]


def exact_count_plain(xk, yk, tk, valid, box, win=None, codes=None, qcodes=None,
                      attr_kind=None):
    """Plain edition of :func:`exact_count`: the mask of
    :func:`exact_bitmap_plain`, summed."""
    m = exact_st_mask(xk, yk, valid, box, tk, win)
    if attr_kind is not None:
        m = attr_combine(m, codes, qcodes[0], attr_kind)
    return m.sum(dtype=torch.int32).reshape(1)


def _one_query(xk, yk, tk, valid, box, win, what: str):
    """Checks of a one-query launch (the count and histogram editions) ->
    (device, rows)."""
    dev, n = xk.device, xk.shape[0]
    if n % 32 or n >= 2**31:
        raise KernelArgumentError(f"{what}: rows ({n}) must be a multiple of 32 below 2^31")
    for name, t in [("xk", xk), ("yk", yk)] + ([("tk", tk)] if win is not None else []):
        _check(t, name, torch.int64, dev, (n,))
    _check(valid, "valid", torch.bool, dev, (n,))
    _check(box, "box", torch.int64, dev, (4,))
    if win is not None:
        _check(win, "win", torch.int64, dev, (2,))
    return dev, n


def exact_count(xk, yk, tk, valid, box, win=None, codes=None, qcodes=None, attr_kind=None):
    """The hit count of ONE exact predicate -> int32[1] on the rows' device
    (the reference's ``_exact_count_fn``): the mask of :func:`exact_bitmap`
    for ``box`` int64[4] and ``win`` int64[2] (or None), with its attribute
    editions (``qcodes`` one row, [1, ...]), summed on the device; no
    bitmap is written. Read it after every segment's launch: one D2H copy
    each, no launch of its own."""
    has_time = win is not None
    if xk.device.type == "cpu":
        return exact_count_plain(xk, yk, tk if has_time else None, valid, box, win, codes,
                                 qcodes, attr_kind)
    if xk.device.type != "cuda":
        raise KernelArgumentError(f"exact_count: unsupported device {xk.device}")
    dev, n = _one_query(xk, yk, tk, valid, box, win, "exact_count")
    edition, width, tag = _attr_launch_args(codes, qcodes, attr_kind, n, 1, dev, "exact_count")
    fn = _lib("exact_bitmap").exact_count
    with torch.cuda.device(dev):
        out = torch.empty(1, dtype=torch.int32, device=dev)  # the launcher zeroes it
        err = fn(
            int(has_time), xk.data_ptr(), yk.data_ptr(), tk.data_ptr() if has_time else None,
            valid.data_ptr(), box.data_ptr(), win.data_ptr() if has_time else None, edition,
            codes.data_ptr() if edition else None, qcodes.data_ptr() if edition else None,
            width, out.data_ptr(), n, _stream(dev),
        )
    _raise_on(err, "exact_count")
    _count(_attr_name("exact_count_" + ("z3" if has_time else "z2"), edition, attr_kind),
           f"q=1{tag}")
    return out


# bins of the histogram edition (the reference's vocabmask cap, 65,536 codes)
STAT_HIST_MAX_U = 1 << 16


def exact_stat_hist_plain(xk, yk, tk, valid, box, win, codes, u_pad: int):
    """Plain edition of :func:`exact_stat_hist`: the mask, its sum, and
    ``torch.bincount`` of the codes of its non-null rows."""
    m = exact_st_mask(xk, yk, valid, box, tk, win)
    live = m & (codes >= 0) & (codes < u_pad)
    hist = torch.bincount(codes[live].to(torch.int64), minlength=u_pad)
    return torch.cat([m.sum(dtype=torch.int64).reshape(1), hist]).to(torch.int32)


def exact_stat_hist(xk, yk, tk, valid, box, win, codes, u_pad: int):
    """ONE exact predicate's hit count and the per-code histogram of its
    hits -> int32[1 + u_pad] on the rows' device (the reference's
    ``_exact_stat_hist_fn``): word 0 is the hit count, nulls included;
    word 1 + c the hits whose code is c. ``codes`` int32[n] are ranks below
    ``u_pad`` (1 <= u_pad <= 65,536), -1 for null and pad rows; a row with
    a code outside [0, u_pad) counts in word 0 only."""
    has_time = win is not None
    if not 1 <= u_pad <= STAT_HIST_MAX_U:
        raise KernelArgumentError(f"exact_stat_hist: u_pad ({u_pad}) not in [1, {STAT_HIST_MAX_U}]")
    if xk.device.type == "cpu":
        return exact_stat_hist_plain(xk, yk, tk if has_time else None, valid, box, win, codes,
                                     u_pad)
    if xk.device.type != "cuda":
        raise KernelArgumentError(f"exact_stat_hist: unsupported device {xk.device}")
    dev, n = _one_query(xk, yk, tk, valid, box, win, "exact_stat_hist")
    _check(codes, "codes", torch.int32, dev, (n,))
    fn = _lib("exact_bitmap").exact_stat_hist
    with torch.cuda.device(dev):
        out = torch.empty(1 + u_pad, dtype=torch.int32, device=dev)  # zeroed by the launcher
        err = fn(
            int(has_time), xk.data_ptr(), yk.data_ptr(), tk.data_ptr() if has_time else None,
            valid.data_ptr(), box.data_ptr(), win.data_ptr() if has_time else None,
            codes.data_ptr(), u_pad, out.data_ptr(), n, _stream(dev),
        )
    _raise_on(err, "exact_stat_hist")
    _count("exact_stat_hist_" + ("z3" if has_time else "z2"), f"q=1 U={u_pad}")
    return out


def frame_bitmaps(bits: torch.Tensor, hdr: torch.Tensor, span_cap: int):
    """Span framing of full-table bitmaps (the reference's
    _bitmap_frame_step): per query ``start = clamp((lo // 8) * 8, 0,
    n - span_cap)`` and the packed window ``[start, start + span_cap)``.
    Returns (header int32[q, 4] = (cnt, lo, hi, start), window
    u8[q, span_cap / 8]). ``span_cap`` is a multiple of 8, at most n."""
    n = bits.shape[1] * 8
    lo = hdr[:, 1].to(torch.int64)
    start = torch.clamp(torch.div(lo, 8, rounding_mode="floor") * 8, 0, n - span_cap)
    cols = torch.arange(span_cap // 8, dtype=torch.int64, device=bits.device)
    window = torch.gather(bits, 1, (start // 8)[:, None] + cols[None, :])
    header = torch.cat([hdr, start[:, None].to(torch.int32)], dim=1)
    return header, window



def frame_dual_bitmaps(hit_bits: torch.Tensor, dec_bits: torch.Tensor,
                       hdr: torch.Tensor, span_cap: int):
    """Span framing of the two planes of an extent batch (the reference's
    _dual_bitmap_row): one window per query keyed on the HIT span (decided
    is a subset of hit), the hit window then the decided window. Returns
    (header int32[q, 4], window u8[q, 2 * span_cap / 8])."""
    header, hit_w = frame_bitmaps(hit_bits, hdr, span_cap)
    _, dec_w = frame_bitmaps(dec_bits, hdr, span_cap)
    return header, torch.cat([hit_w, dec_w], dim=1)


# -- K3: extent candidate mask -----------------------------------------------


def xz_mask_plain(bxmin, bymin, bxmax, bymax, valid, boxes, bins=None, offs=None,
                  windows=None) -> torch.Tensor:
    """Plain edition of :func:`xz_mask` (the reference's ``_xla_mask_fn``
    for xz2 / xz3)."""
    m = bbox_overlap_mask(bxmin, bymin, bxmax, bymax, valid, boxes)
    if windows is not None:
        m = m & temporal_mask(bins, offs, windows)
    return m


def xz_mask(bxmin, bymin, bxmax, bymax, valid, boxes, bins=None, offs=None,
            windows=None) -> torch.Tensor:
    """Conservative xz3 (``windows`` given) or xz2 candidate mask -> bool[n].

    ``bxmin .. bymax`` float32[n] stored envelopes, ``valid`` bool[n],
    ``boxes`` float32[K, 4] as (xlo, ylo, xhi, yhi); ``bins, offs``
    int32[n] and ``windows`` int32[W, 3] as (bin, lo, hi)."""
    has_time = windows is not None
    if bxmin.device.type == "cpu":
        return xz_mask_plain(bxmin, bymin, bxmax, bymax, valid, boxes, bins, offs, windows)
    if bxmin.device.type != "cuda":
        raise KernelArgumentError(f"xz_mask: unsupported device {bxmin.device}")
    dev, n = bxmin.device, bxmin.shape[0]
    if n % 4:
        raise KernelArgumentError(f"xz_mask: rows ({n}) must be a multiple of 4")
    cols = [(w, t, torch.float32) for w, t in
            (("bxmin", bxmin), ("bymin", bymin), ("bxmax", bxmax), ("bymax", bymax))]
    if has_time:
        cols += [("bins", bins, torch.int32), ("offs", offs, torch.int32)]
    for what, t, dtype in cols:
        _check(t, what, dtype, dev, (n,))
        if t.data_ptr() % 16:
            raise KernelArgumentError(f"xz_mask: {what} is not 16-byte aligned")
    _check(valid, "valid", torch.bool, dev, (n,))
    if valid.data_ptr() % 4:
        raise KernelArgumentError("xz_mask: valid is not 4-byte aligned")
    _check(boxes, "boxes", torch.float32, dev)
    k, w = boxes.shape[0], 0
    if has_time:
        _check(windows, "windows", torch.int32, dev)
        w = windows.shape[0]
    if boxes.shape[1:] != (4,) or (has_time and windows.shape[1:] != (3,)):
        raise KernelArgumentError("xz_mask: boxes must be [K, 4] and windows [W, 3]")
    if 4 * (4 * k + 3 * w) > _CAND_SMEM:
        raise KernelArgumentError(f"xz_mask: {k} boxes / {w} windows exceed shared memory")
    fn = _lib("xz_mask").xz_mask
    with torch.cuda.device(dev):
        out = torch.empty(n, dtype=torch.bool, device=dev)
        err = fn(
            int(has_time), bxmin.data_ptr(), bymin.data_ptr(), bxmax.data_ptr(),
            bymax.data_ptr(), bins.data_ptr() if has_time else None,
            offs.data_ptr() if has_time else None, valid.data_ptr(), boxes.data_ptr(), k,
            windows.data_ptr() if has_time else None, w, out.data_ptr(), n, _stream(dev),
        )
    _raise_on(err, "xz_mask")
    _count("xz_mask_xz3" if has_time else "xz_mask_xz2", f"K={k} W={w}")
    return out


# -- K4: extent dual-plane bitmap ----------------------------------------------


def _attr_planes(hit, dec, codes, qcode, attr_kind):
    """The attribute test ANDed into a dual plane's hit before its decided
    plane derives from it (decided is a subset of hit)."""
    if attr_kind is None:
        return hit, dec
    hit = attr_combine(hit, codes, qcode, attr_kind)
    return hit, dec & hit


def xz_dual_bitmap_plain(bxmin, bymin, bxmax, bymax, isrect, valid, descs, tk=None,
                         codes=None, qcodes=None, attr_kind=None):
    """Plain edition of :func:`xz_dual_bitmap`, one query at a time."""
    n8 = bxmin.shape[0] // 8
    hits, decs, hdr = [], [], []
    for i in range(descs.shape[0]):
        hit, dec = xz_exact_planes(bxmin, bymin, bxmax, bymax, isrect, valid,
                                   descs[i], descs[0, 4], tk)
        hit, dec = _attr_planes(hit, dec, codes, None if qcodes is None else qcodes[i],
                                attr_kind)
        hits.append(pack_mask_rows(hit))
        decs.append(pack_mask_rows(dec))
        hdr.append(torch.stack(_span_bounds(hit)))
    if not hits:
        empty = torch.empty((0, n8), dtype=torch.uint8, device=bxmin.device)
        return empty, empty.clone(), torch.empty((0, 3), dtype=torch.int32, device=bxmin.device)
    return torch.stack(hits), torch.stack(decs), torch.stack(hdr).to(torch.int32)


def xz_dual_bitmap(bxmin, bymin, bxmax, bymax, isrect, valid, descs, tk=None,
                   codes=None, qcodes=None, attr_kind=None):
    """q exact extent predicates -> (hit bits u8[q, n/8], decided bits
    u8[q, n/8], hdr int32[q, 3]), both planes MSB-first.

    ``bxmin .. bymax`` int64[n] envelope sort keys, ``isrect`` and
    ``valid`` bool[n] (``valid`` is the temporal-valid column when ``tk``,
    the int64[n] ms column, is given); ``descs`` int64[q, 8] (see
    :func:`geomesa_tpu_torch.ops.filters.xz_exact_planes`). Every
    descriptor carries the same placeholder key: both editions take the
    first one's. With ``attr_kind`` (one of ``ATTR_KINDS``; ``codes``
    int32[n], ``qcodes`` a row per query as for :func:`exact_bitmap`) each
    query's attribute test ANDs into its hit plane before the decided plane
    derives from it. ``hdr`` rows are the HIT plane's (count, first, last),
    no hit giving (0, 0, n - 1)."""
    if bxmin.device.type == "cpu":
        return xz_dual_bitmap_plain(bxmin, bymin, bxmax, bymax, isrect, valid, descs, tk,
                                    codes, qcodes, attr_kind)
    return _launch_xz_dual_bitmap("xz_dual_bitmap", bxmin, bymin, bxmax, bymax, isrect, valid,
                                  descs, tk, codes, qcodes, attr_kind)


def _launch_xz_dual_bitmap(name: str, bxmin, bymin, bxmax, bymax, isrect, valid, descs,
                           tk=None, codes=None, qcodes=None, attr_kind=None):
    """The ``xz_dual_bitmap`` launch of :func:`xz_dual_bitmap` and
    :func:`dual_mask_batch`, counted under ``name`` + ``_xz3`` / ``_xz2``
    (+ ``_<edition>``)."""
    has_time = tk is not None
    if bxmin.device.type != "cuda":
        raise KernelArgumentError(f"{name}: unsupported device {bxmin.device}")
    dev, n = bxmin.device, bxmin.shape[0]
    q = descs.shape[0]
    if n % 32 or n >= 2**31:
        raise KernelArgumentError(f"xz_dual_bitmap: rows ({n}) must be a multiple of 32 below 2^31")
    if not 0 < q <= EXACT_MAX_Q:
        raise KernelArgumentError(f"xz_dual_bitmap: q ({q}) must be in [1, {EXACT_MAX_Q}]")
    cols = [("bxmin", bxmin), ("bymin", bymin), ("bxmax", bxmax), ("bymax", bymax)]
    for what, t in cols + ([("tk", tk)] if has_time else []):
        _check(t, what, torch.int64, dev, (n,))
    _check(isrect, "isrect", torch.bool, dev, (n,))
    _check(valid, "valid", torch.bool, dev, (n,))
    _check(descs, "descs", torch.int64, dev, (q, XZ_DESC))
    edition, width, tag = _attr_launch_args(codes, qcodes, attr_kind, n, q, dev,
                                            "xz_dual_bitmap")
    fn = _lib("xz_dual_bitmap").xz_dual_bitmap
    with torch.cuda.device(dev):
        hit_bits = torch.empty((q, n // 8), dtype=torch.uint8, device=dev)
        dec_bits = torch.empty((q, n // 8), dtype=torch.uint8, device=dev)
        hdr = torch.empty((q, 3), dtype=torch.int32, device=dev)
        hdr[:, 0] = 0
        hdr[:, 1] = n
        hdr[:, 2] = -1
        err = fn(
            int(has_time), bxmin.data_ptr(), bymin.data_ptr(), bxmax.data_ptr(),
            bymax.data_ptr(), isrect.data_ptr(), valid.data_ptr(),
            tk.data_ptr() if has_time else None, descs.data_ptr(), q,
            hit_bits.data_ptr(), dec_bits.data_ptr(), hdr.data_ptr(), n, _stream(dev),
            edition, codes.data_ptr() if edition else None,
            qcodes.data_ptr() if edition else None, width,
        )
    _raise_on(err, "xz_dual_bitmap")
    _count(_attr_name(f"{name}_" + ("xz3" if has_time else "xz2"), edition, attr_kind),
           f"q={q}{tag}")
    empty = hdr[:, 0] == 0
    hdr[:, 1] = torch.where(empty, 0, hdr[:, 1])
    hdr[:, 2] = torch.where(empty, n - 1, hdr[:, 2])
    return hit_bits, dec_bits, hdr


# -- K5: exact density grid --------------------------------------------------


def density_grid_plain(x, y, bins, offs, valid, boxes, windows, env,
                       width: int, height: int, band_cap: int):
    """Plain edition of :func:`density_grid` (``density_dual`` with the
    grid as int32)."""
    grid, idx, count = density_dual(x, y, bins, offs, valid, boxes, windows, env,
                                    width, height, band_cap)
    return grid.to(torch.int32), idx, count


def density_grid(x, y, bins, offs, valid, boxes, windows, env,
                 width: int, height: int, band_cap: int):
    """One segment's exact density pass -> (grid int32[H, W], band_idx
    int32[band_cap], band_count int32[1]) (see
    :func:`geomesa_tpu_torch.ops.aggregations.density_dual`).

    ``x, y`` float32[n] raw coordinates, ``valid`` bool[n], ``boxes``
    float32[K, 4] as (xlo, ylo, xhi, yhi), ``env`` float32[4] as (xmin,
    ymin, xmax, ymax); with time, ``bins, offs`` int32[n] (the in-bin ms
    offset) and ``windows`` int32[W, 3] as (bin, lo, hi), else all three
    None. On the card the band buffer holds ``min(count, band_cap)``
    indices in arbitrary order, then -1: compare it as a set."""
    has_time = windows is not None
    if x.device.type == "cpu":
        return density_grid_plain(x, y, bins, offs, valid, boxes, windows, env,
                                  width, height, band_cap)
    if x.device.type != "cuda":
        raise KernelArgumentError(f"density_grid: unsupported device {x.device}")
    dev, n = x.device, x.shape[0]
    if n >= 2**31 or n % DENSITY_ROWS:
        raise KernelArgumentError(f"density_grid: rows ({n}) must be a multiple of {DENSITY_ROWS} "
                         "below 2^31")
    if not (0 < width and 0 < height and width * height < 2**31 // 4):
        raise KernelArgumentError(f"density_grid: bad grid {width} x {height}")
    cols = [("x", x, torch.float32), ("y", y, torch.float32), ("valid", valid, torch.bool)]
    if has_time:
        cols += [("bins", bins, torch.int32), ("offs", offs, torch.int32)]
    for what, t, dtype in cols:
        _check(t, what, dtype, dev, (n,))
        # each thread loads its 4 rows' valid as 4 bytes, the rest as 16
        if t.data_ptr() % (4 if t is valid else 16):
            raise KernelArgumentError(f"density_grid: {what} is not {4 if t is valid else 16}-byte aligned")
    _check(boxes, "boxes", torch.float32, dev)
    _check(env, "env", torch.float32, dev, (4,))
    k, w = boxes.shape[0], 0
    if has_time:
        _check(windows, "windows", torch.int32, dev)
        w = windows.shape[0]
    if boxes.shape[1:] != (4,) or (has_time and windows.shape[1:] != (3,)):
        raise KernelArgumentError("density_grid: boxes must be [K, 4] and windows [W, 3]")
    # shared memory: the boxes, their margins and reject bounds, the windows
    if 4 * (10 * k + 3 * w) > _CAND_SMEM:
        raise KernelArgumentError(f"density_grid: {k} boxes / {w} windows exceed shared memory")
    fn = _lib("density_grid").density_grid
    with torch.cuda.device(dev):
        grid = torch.zeros((height, width), dtype=torch.int32, device=dev)
        band_idx = torch.full((band_cap,), -1, dtype=torch.int32, device=dev)
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        err = fn(
            int(has_time), x.data_ptr(), y.data_ptr(),
            bins.data_ptr() if has_time else None, offs.data_ptr() if has_time else None,
            valid.data_ptr(), boxes.data_ptr(), k,
            windows.data_ptr() if has_time else None, w, env.data_ptr(),
            reciprocal_f32(width), reciprocal_f32(height), width, height,
            grid.data_ptr(), band_idx.data_ptr(), count.data_ptr(), band_cap, n, _stream(dev),
        )
    _raise_on(err, "density_grid")
    _count("density_grid_" + ("z3" if has_time else "z2"), f"{width}x{height}")
    return grid, band_idx, count


# -- K6: kNN top-k -------------------------------------------------------------

# f32(pi / 180): the factor of jnp.radians / torch.deg2rad in float32
_RAD = np.float32(np.pi / 180.0)


def knn_distances(xf, yf, valid, qx: float, qy: float) -> torch.Tensor:
    """Plain f32 haversine half-angle of every row to (qx, qy), +inf where
    ``valid`` is false (the reference's ``dists`` in ``_knn_fn``): one
    rounding per operation, each op its own kernel on the rows' device."""
    dev = xf.device
    rad = torch.tensor(_RAD, device=dev)
    qxr = torch.tensor(np.float32(qx), device=dev) * rad
    qyr = torch.tensor(np.float32(qy), device=dev) * rad
    rx = xf * rad
    ry = yf * rad
    sdy = torch.sin((ry - qyr) * 0.5)
    sdx = torch.sin((rx - qxr) * 0.5)
    a = sdy * sdy + torch.cos(ry) * torch.cos(qyr) * sdx * sdx
    d = torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
    return torch.where(valid, d, torch.tensor(np.float32(np.inf), device=dev))


def knn_topk_plain(xf, yf, valid, qx: float, qy: float, k: int) -> torch.Tensor:
    """Plain edition of :func:`knn_topk`: a stable sort of the distances,
    the first ``min(k, n)`` rows (equal distances by row; ``torch.topk``
    promises no order for them)."""
    d = knn_distances(xf, yf, valid, qx, qy)
    return torch.sort(d, stable=True).indices[:min(k, d.shape[0])]


def knn_topk(xf, yf, valid, qx: float, qy: float, k: int) -> torch.Tensor:
    """The ``min(k, n)`` rows nearest (qx, qy) -> int64 rows ascending by
    (f32 distance, row) (see :func:`knn_distances`; invalid rows rank at
    +inf, by row). ``xf, yf`` float32[n] degrees, ``valid`` bool[n], k >= 1."""
    if k < 1:
        raise KernelArgumentError(f"knn_topk: k ({k}) must be at least 1")
    if xf.device.type == "cpu":
        return knn_topk_plain(xf, yf, valid, qx, qy, k)
    if xf.device.type != "cuda":
        raise KernelArgumentError(f"knn_topk: unsupported device {xf.device}")
    dev, n = xf.device, xf.shape[0]
    if n >= 2**31:
        raise KernelArgumentError(f"knn_topk: rows ({n}) must be below 2^31")
    _check(xf, "xf", torch.float32, dev, (n,))
    _check(yf, "yf", torch.float32, dev, (n,))
    _check(valid, "valid", torch.bool, dev, (n,))
    lib = _lib("knn_topk")
    kk = min(k, n)
    with torch.cuda.device(dev):
        words = lib.knn_topk_scratch(n, kk)
        if words < 0:
            raise KernelLaunchError("knn_topk: CUDA error sizing the scratch")
        scratch = torch.empty(max(1, words), dtype=torch.int64, device=dev)
        out = torch.empty(kk, dtype=torch.int64, device=dev)
        passes = ctypes.c_longlong(0)
        err = lib.knn_topk(xf.data_ptr(), yf.data_ptr(), valid.data_ptr(), float(np.float32(qx)),
                           float(np.float32(qy)), n, kk, scratch.data_ptr(), out.data_ptr(),
                           _stream(dev), ctypes.byref(passes))
    _raise_on(err, "knn_topk")
    _count("knn_topk", f"k={kk}")
    LAST_PASSES["knn_topk"] = passes.value
    return out


# -- K7: banded polygon dual-plane bitmap ---------------------------------------


def poly_dual_bitmap_plain(xk, yk, valid, xf, yf, edges, boxes, wins=None, tk=None,
                           codes=None, qcodes=None, attr_kind=None):
    """Plain edition of :func:`poly_dual_bitmap`, one query at a time
    (:func:`geomesa_tpu_torch.ops.filters.poly_planes`)."""
    n8 = xk.shape[0] // 8
    hits, decs, hdr = [], [], []
    for i in range(boxes.shape[0]):
        hit, dec = poly_planes(xk, yk, valid, boxes[i], xf, yf, edges[i], tk,
                               None if wins is None else wins[i])
        hit, dec = _attr_planes(hit, dec, codes, None if qcodes is None else qcodes[i],
                                attr_kind)
        hits.append(pack_mask_rows(hit))
        decs.append(pack_mask_rows(dec))
        hdr.append(torch.stack(_span_bounds(hit)))
    if not hits:
        empty = torch.empty((0, n8), dtype=torch.uint8, device=xk.device)
        return empty, empty.clone(), torch.empty((0, 3), dtype=torch.int32, device=xk.device)
    return torch.stack(hits), torch.stack(decs), torch.stack(hdr).to(torch.int32)


def poly_dual_bitmap(xk, yk, valid, xf, yf, edges, boxes, wins=None, tk=None,
                     codes=None, qcodes=None, attr_kind=None):
    """q banded point-in-polygon queries -> (hit bits u8[q, n/8], decided
    bits u8[q, n/8], hdr int32[q, 3]), both planes MSB-first.

    ``xk, yk`` (and ``tk``) int64[n] sort keys, ``valid`` bool[n] (the
    temporal-valid column when ``wins`` is given), ``xf, yf`` float32[n]
    raw coordinates; ``edges`` float32[q, E, 4] as (x1, y1, x2, y2), every
    query's edge list padded to E with degenerate (zero) edges; ``boxes``
    int64[q, 4] keys of each polygon's envelope (xmin, xmax, ymin, ymax);
    ``wins`` int64[q, 2] inclusive (lo, hi) ms. The planes are those of
    :func:`geomesa_tpu_torch.ops.filters.poly_planes`; with ``attr_kind``
    (``codes``, ``qcodes`` as for :func:`xz_dual_bitmap`) each query's
    attribute test ANDs into its hit plane before the decided plane derives
    from it. ``hdr`` rows are the HIT plane's (count, first, last), no hit
    giving (0, 0, n - 1)."""
    if xk.device.type == "cpu":
        return poly_dual_bitmap_plain(xk, yk, valid, xf, yf, edges, boxes, wins,
                                      tk if wins is not None else None, codes, qcodes, attr_kind)
    return _launch_poly_dual_bitmap("poly_dual_bitmap", xk, yk, valid, xf, yf, edges, boxes,
                                    wins, tk, codes, qcodes, attr_kind)


def _launch_poly_dual_bitmap(name: str, xk, yk, valid, xf, yf, edges, boxes, wins=None,
                             tk=None, codes=None, qcodes=None, attr_kind=None):
    """The ``poly_dual_bitmap`` launch of :func:`poly_dual_bitmap` and
    :func:`dual_mask_batch`, counted under ``name`` + ``_z3`` / ``_z2``
    (+ ``_<edition>``)."""
    has_time = wins is not None
    if xk.device.type != "cuda":
        raise KernelArgumentError(f"{name}: unsupported device {xk.device}")
    dev, n = xk.device, xk.shape[0]
    q = boxes.shape[0]
    if n % 32 or n >= 2**31:
        raise KernelArgumentError(f"poly_dual_bitmap: rows ({n}) must be a multiple of 32 below 2^31")
    if not 0 < q <= POLY_MAX_Q:
        raise KernelArgumentError(f"poly_dual_bitmap: q ({q}) must be in [1, {POLY_MAX_Q}]")
    for what, t in [("xk", xk), ("yk", yk)] + ([("tk", tk)] if has_time else []):
        _check(t, what, torch.int64, dev, (n,))
    _check(valid, "valid", torch.bool, dev, (n,))
    _check(xf, "xf", torch.float32, dev, (n,))
    _check(yf, "yf", torch.float32, dev, (n,))
    _check(boxes, "boxes", torch.int64, dev, (q, 4))
    if has_time:
        _check(wins, "wins", torch.int64, dev, (q, 2))
    _check(edges, "edges", torch.float32, dev)
    if edges.dim() != 3 or edges.shape[0] != q or edges.shape[2] != 4 or edges.shape[1] < 1:
        raise KernelArgumentError(f"poly_dual_bitmap: edges must be [{q}, E, 4], not {tuple(edges.shape)}")
    ecap = edges.shape[1]
    edition, width, tag = _attr_launch_args(codes, qcodes, attr_kind, n, q, dev,
                                            "poly_dual_bitmap")
    fn = _lib("poly_dual_bitmap").poly_dual_bitmap
    with torch.cuda.device(dev):
        hit_bits = torch.empty((q, n // 8), dtype=torch.uint8, device=dev)
        dec_bits = torch.empty((q, n // 8), dtype=torch.uint8, device=dev)
        # the launcher initialises and decodes the header in place; its
        # last word is the launch's block ticket
        hdr = torch.empty(3 * q + 1, dtype=torch.int32, device=dev)
        err = fn(
            int(has_time), xk.data_ptr(), yk.data_ptr(), tk.data_ptr() if has_time else None,
            valid.data_ptr(), xf.data_ptr(), yf.data_ptr(), edges.data_ptr(), q, ecap,
            boxes.data_ptr(), wins.data_ptr() if has_time else None, hit_bits.data_ptr(),
            dec_bits.data_ptr(), hdr.data_ptr(), n, _stream(dev), edition,
            codes.data_ptr() if edition else None, qcodes.data_ptr() if edition else None,
            width,
        )
    _raise_on(err, "poly_dual_bitmap")
    _count(_attr_name(f"{name}_" + ("z3" if has_time else "z2"), edition, attr_kind),
           f"q={q} E={ecap}{tag}")
    return hit_bits, dec_bits, hdr[:3 * q].view(q, 3)


# -- the coalescer's dual-plane mask batches -----------------------------------

# the mask-batch kind -> its launch-count name prefix
DUAL_MASK_NAMES = {"xz": "xz_mask_batch", "poly": "poly_mask_batch"}


def dual_mask_batch_plain(kind: str, *args, **kwargs):
    """Plain edition of :func:`dual_mask_batch`: the stacked
    ``xz_exact_planes`` (``kind`` "xz") or ``poly_planes`` ("poly"), the
    attribute test ANDed into each hit plane, packed one query at a time
    (:func:`xz_dual_bitmap_plain`'s or :func:`poly_dual_bitmap_plain`'s
    planes)."""
    if kind not in DUAL_MASK_NAMES:
        raise KernelArgumentError(f"dual_mask_batch: unknown kind {kind!r}")
    plain = xz_dual_bitmap_plain if kind == "xz" else poly_dual_bitmap_plain
    return plain(*args, **kwargs)[:2]


def dual_mask_batch(kind: str, *args, **kwargs):
    """q stacked extent-envelope (``kind`` "xz") or banded-polygon ("poly")
    predicates -> ONE pair of full-table packed planes (hit u8[q, n/8],
    decided u8[q, n/8]), MSB-first, no header and no span framing (the
    reference's ``_dual_mask_batch_fn``, the coalescer's dual sweep).
    Arguments after ``kind`` as for :func:`xz_dual_bitmap` or
    :func:`poly_dual_bitmap`, whose kernel computes the planes. Counted
    under ``xz_mask_batch_xz3`` / ``_xz2`` or ``poly_mask_batch_z3`` /
    ``_z2`` (+ ``_<edition>``); q is the real query count (the polygon
    kernel takes any q up to ``POLY_MAX_Q``)."""
    if kind not in DUAL_MASK_NAMES:
        raise KernelArgumentError(f"dual_mask_batch: unknown kind {kind!r}")
    if args[0].device.type == "cpu":
        return dual_mask_batch_plain(kind, *args, **kwargs)
    launch = _launch_xz_dual_bitmap if kind == "xz" else _launch_poly_dual_bitmap
    return launch(DUAL_MASK_NAMES[kind], *args, **kwargs)[:2]


# -- the aggregate pyramid's counts -------------------------------------------

PYRAMID_MIN_BITS, PYRAMID_MAX_BITS = 2, 12


def pyramid_block(starts, n: int) -> Tuple[int, int]:
    """The rows [lo, hi) the ``pyramid_counts`` kernel takes as its one
    key-sorted block: the longest block of ``starts`` (the row offsets of
    a segment's key-sorted blocks, then the end of the last one; the pad
    rows past it belong to no block), or all ``n`` rows without them."""
    if starts is None:
        return 0, n
    bounds = [int(s) for s in starts]
    if len(bounds) < 2 or bounds[0] < 0 or bounds[-1] > n or \
            any(b < a for a, b in zip(bounds, bounds[1:])):
        raise KernelArgumentError(f"pyramid_counts: block bounds {bounds} not ascending in [0, {n}]")
    i = max(range(len(bounds) - 1), key=lambda j: bounds[j + 1] - bounds[j])
    return bounds[i], bounds[i + 1]


def pyramid_counts(xi, yi, mask, bits: int, starts=None) -> torch.Tensor:
    """One z2 segment's pyramid count grid -> int32 [2^bits, 2^bits] on the
    rows' device (the reference's ``make_pyramid_counts``): the rows of
    ``mask`` (bool[n], valid and finite geometry) counted by cell ``(yi >>
    s) << bits | (xi >> s)``, ``s = 31 - bits``; ``xi, yi`` int32[n] are
    the z2 grid coordinates, ``bits`` in [2, 12]. ``starts`` (see
    :func:`pyramid_block`) names the segment's key-sorted blocks, whose
    order the kernel uses; without it the kernel takes all ``n`` rows as
    one key-sorted block. The grid is exact in any order: rows out of
    order only cost the kernel's fallbacks their time."""
    if not PYRAMID_MIN_BITS <= bits <= PYRAMID_MAX_BITS:
        raise KernelArgumentError(f"pyramid_counts: bits ({bits}) not in "
                         f"[{PYRAMID_MIN_BITS}, {PYRAMID_MAX_BITS}]")
    lo, hi = pyramid_block(starts, xi.shape[0])
    if xi.device.type == "cpu":
        return pyramid_counts_plain(xi, yi, mask, bits)
    if xi.device.type != "cuda":
        raise KernelArgumentError(f"pyramid_counts: unsupported device {xi.device}")
    dev, n = xi.device, xi.shape[0]
    _check(xi, "xi", torch.int32, dev, (n,))
    _check(yi, "yi", torch.int32, dev, (n,))
    _check(mask, "mask", torch.bool, dev, (n,))
    lib = _lib("pyramid_counts")
    side = 1 << bits
    with torch.cuda.device(dev):
        words = lib.pyramid_counts_scratch(n, bits)
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        out = torch.empty((side, side), dtype=torch.int32, device=dev)  # every cell written
        err = lib.pyramid_counts(xi.data_ptr(), yi.data_ptr(), mask.data_ptr(), bits,
                                 out.data_ptr(), n, _stream(dev), lo, hi, scratch.data_ptr(),
                                 words)
    _raise_on(err, "pyramid_counts")
    _count("pyramid_counts", f"bits={bits} n={n}")
    return out


# -- the spatial join's dual masks -------------------------------------------


def _group_candidates(rows: int, goff, grow, cand) -> torch.Tensor:
    """int32[rows, C]: each chunk row's candidate row of ``cand`` (its
    group ``g`` holds rows ``goff[g] .. goff[g + 1]``, whose candidates are
    ``cand[grow[g]]``)."""
    r = torch.arange(rows, dtype=torch.int64, device=cand.device)
    g = torch.searchsorted(goff.to(torch.int64), r, right=True) - 1
    return cand[grow.to(torch.int64)[g]]


def _join_flags(accept: torch.Tensor, check: torch.Tensor) -> torch.Tensor:
    """(accept, check) bool[R, C] -> u8 flags [C, R]: bit 0 accept, bit 1
    check."""
    return (accept.to(torch.uint8) | (check.to(torch.uint8) << 1)).t().contiguous()


def join_pip_chunk_plain(px, py, goff, grow, cand, edges, ecnt, eps_deg) -> torch.Tensor:
    """Plain edition of :func:`join_pip`: :func:`join_pip_plain` of every
    row against its group's candidates."""
    got = join_pip_plain(px, py, _group_candidates(px.shape[0], goff, grow, cand), edges, ecnt,
                         eps_deg)
    return _join_flags(*got)


def join_dwithin_chunk_plain(px, py, goff, grow, cand, bx, by, r_m, eps_m) -> torch.Tensor:
    """Plain edition of :func:`join_dwithin`: :func:`join_dwithin_plain` of
    every row against its group's candidates."""
    got = join_dwithin_plain(px, py, _group_candidates(px.shape[0], goff, grow, cand), bx, by,
                             r_m, eps_m)
    return _join_flags(*got)


def _join_chunk_checks(what: str, px, py, goff, grow, cand):
    """(device, rows, groups, candidate slots) of a join launch, after
    checking the chunk's tensors."""
    if px.device.type != "cuda":
        raise KernelArgumentError(f"{what}: unsupported device {px.device}")
    dev, rows = px.device, px.shape[0]
    groups = grow.shape[0]
    if not 0 < rows < 2**31 or groups < 1:
        raise KernelArgumentError(f"{what}: {rows} rows in {groups} groups")
    _check(px, "px", torch.float32, dev, (rows,))
    _check(py, "py", torch.float32, dev, (rows,))
    _check(goff, "goff", torch.int32, dev, (groups + 1,))
    _check(grow, "grow", torch.int32, dev, (groups,))
    _check(cand, "cand", torch.int32, dev)
    if cand.dim() != 2 or cand.shape[1] < 1:
        raise KernelArgumentError(f"{what}: cand must be [B, C], not {tuple(cand.shape)}")
    return dev, rows, groups, cand.shape[1]


def join_pip(px, py, goff, grow, cand, edges, ecnt, eps_deg) -> torch.Tensor:
    """The contains join's dual masks of one probe chunk -> u8 flags [C,
    R] (bit 0 accept, bit 1 check; slot-major).

    ``px, py`` float32[R] the chunk's routed rows sorted by group, ``goff``
    int32[groups + 1] the groups' row offsets, ``grow`` int32[groups] each
    group's row in the resident candidate matrix ``cand`` int32[B, C] (-1
    pads), ``edges`` float32[G, E, 4] and ``ecnt`` int32[G] the build
    geometries' edge lists, ``eps_deg`` the f32 boundary band. Row r of
    group g against slot s is :func:`join_pip_plain` of the row against
    ``cand[grow[g], s]``."""
    if px.device.type == "cpu":
        return join_pip_chunk_plain(px, py, goff, grow, cand, edges, ecnt, eps_deg)
    dev, rows, groups, c_cap = _join_chunk_checks("join_pip", px, py, goff, grow, cand)
    _check(edges, "edges", torch.float32, dev)
    if edges.dim() != 3 or edges.shape[2] != 4 or edges.shape[1] < 1:
        raise KernelArgumentError(f"join_pip: edges must be [G, E, 4], not {tuple(edges.shape)}")
    _check(ecnt, "ecnt", torch.int32, dev, (edges.shape[0],))
    e_cap = edges.shape[1]
    fn = _lib("join").join_pip
    with torch.cuda.device(dev):
        out = torch.empty((c_cap, rows), dtype=torch.uint8, device=dev)  # every flag written
        err = fn(px.data_ptr(), py.data_ptr(), goff.data_ptr(), grow.data_ptr(), groups,
                 cand.data_ptr(), c_cap, edges.data_ptr(), e_cap, ecnt.data_ptr(),
                 float(np.float32(eps_deg)), out.data_ptr(), rows, _stream(dev))
    _raise_on(err, "join_pip")
    _count("join_pip", f"C={c_cap} E={e_cap}")
    return out


def join_dwithin(px, py, goff, grow, cand, bx, by, r_m, eps_m) -> torch.Tensor:
    """The dwithin join's dual masks of one probe chunk -> u8 flags [C, R]
    (bit 0 accept, bit 1 check; slot-major). Arguments as for
    :func:`join_pip`, with ``bx, by`` float32[G] the build points (NaN for a
    null geometry) and ``r_m``, ``eps_m`` the f32 radius and band: row r of
    group g against slot s is :func:`join_dwithin_plain` of the row against
    ``cand[grow[g], s]``."""
    if px.device.type == "cpu":
        return join_dwithin_chunk_plain(px, py, goff, grow, cand, bx, by, r_m, eps_m)
    dev, rows, groups, c_cap = _join_chunk_checks("join_dwithin", px, py, goff, grow, cand)
    _check(bx, "bx", torch.float32, dev)
    if bx.dim() != 1:
        raise KernelArgumentError(f"join_dwithin: bx must be [G], not {tuple(bx.shape)}")
    _check(by, "by", torch.float32, dev, tuple(bx.shape))
    r, eps = np.float32(r_m), np.float32(eps_m)
    fn = _lib("join").join_dwithin
    with torch.cuda.device(dev):
        out = torch.empty((c_cap, rows), dtype=torch.uint8, device=dev)  # every flag written
        err = fn(px.data_ptr(), py.data_ptr(), goff.data_ptr(), grow.data_ptr(), groups,
                 cand.data_ptr(), c_cap, bx.data_ptr(), by.data_ptr(), float(r - eps),
                 float(r + eps), out.data_ptr(), rows, _stream(dev))
    _raise_on(err, "join_dwithin")
    _count("join_dwithin", f"C={c_cap}")
    return out


# -- the device-assisted seek -------------------------------------------------

# the seek's candidate space: a multiple of the launch's block, at most the
# reference's bitmap budget
DEVSEEK_MIN_CAND = 1024
DEVSEEK_MAX_CAND = 1 << 22


def _devseek_checks(what: str, starts, ends, cand_cap: int, n: int, dev):
    if cand_cap % DEVSEEK_MIN_CAND or not 0 < cand_cap <= DEVSEEK_MAX_CAND:
        raise KernelArgumentError(f"{what}: cand_cap ({cand_cap}) must be a multiple of "
                                  f"{DEVSEEK_MIN_CAND} up to {DEVSEEK_MAX_CAND}")
    if n >= 2**31:
        raise KernelArgumentError(f"{what}: rows ({n}) must be below 2^31")
    _check(starts, "starts", torch.int32, dev)
    if starts.dim() != 1 or starts.shape[0] < 1:
        raise KernelArgumentError(f"{what}: starts must be [n_iv], not {tuple(starts.shape)}")
    _check(ends, "ends", torch.int32, dev, tuple(starts.shape))
    return starts.shape[0]


def devseek(xk, yk, tk, valid, starts, ends, box, win, cand_cap: int) -> torch.Tensor:
    """The device-assisted seek of one point query over one segment -> u8
    [cand_cap / 8], MSB first (:func:`geomesa_tpu_torch.ops.filters.
    devseek_plain`): ``xk, yk`` (and ``tk``) int64[n] sort keys, ``valid``
    bool[n] (the temporal-valid column with ``win``), ``starts`` int32[n_iv]
    the candidate intervals' segment rows and ``ends`` int32[n_iv] the
    inclusive prefix sums of their lengths, ``box`` int64[4] keys of (xmin,
    xmax, ymin, ymax), ``win`` int64[2] inclusive ms or None, ``cand_cap`` a
    multiple of 1024 up to 2^22."""
    if xk.device.type == "cpu":
        return devseek_plain(xk, yk, tk, valid, starts, ends, box, win, cand_cap)
    if xk.device.type != "cuda":
        raise KernelArgumentError(f"devseek: unsupported device {xk.device}")
    dev, n = xk.device, xk.shape[0]
    has_time = win is not None
    n_iv = _devseek_checks("devseek", starts, ends, cand_cap, n, dev)
    for what, t in [("xk", xk), ("yk", yk)] + ([("tk", tk)] if has_time else []):
        _check(t, what, torch.int64, dev, (n,))
    _check(valid, "valid", torch.bool, dev, (n,))
    _check(box, "box", torch.int64, dev, (4,))
    if has_time:
        _check(win, "win", torch.int64, dev, (2,))
    fn = _lib("devseek").devseek
    with torch.cuda.device(dev):
        out = torch.empty(cand_cap // 8, dtype=torch.uint8, device=dev)  # every word written
        err = fn(int(has_time), xk.data_ptr(), yk.data_ptr(), tk.data_ptr() if has_time else None,
                 valid.data_ptr(), starts.data_ptr(), ends.data_ptr(), n_iv, box.data_ptr(),
                 win.data_ptr() if has_time else None, out.data_ptr(), cand_cap, _stream(dev))
    _raise_on(err, "devseek")
    _count("devseek_" + ("z3" if has_time else "z2"), f"cand={cand_cap}")
    return out


def devseek_xz(bxmin, bymin, bxmax, bymax, isrect, valid, tk, starts, ends, desc,
               cand_cap: int, has_time: bool) -> torch.Tensor:
    """The device-assisted seek of one extent query over one segment ->
    u8[2 * cand_cap / 8], the packed ``hit`` plane then ``decided``
    (:func:`geomesa_tpu_torch.ops.filters.devseek_xz_plain`): the four
    int64[n] envelope keys, ``isrect`` and ``valid`` bool[n] (the
    temporal-valid column with ``has_time``), ``tk`` int64[n] (read with
    ``has_time``), the intervals as for :func:`devseek`, ``desc`` int64[8]
    the executor's extent descriptor (``_xz_desc``)."""
    if bxmin.device.type == "cpu":
        return devseek_xz_plain(bxmin, bymin, bxmax, bymax, isrect, valid, tk, starts, ends,
                                desc, cand_cap, has_time)
    if bxmin.device.type != "cuda":
        raise KernelArgumentError(f"devseek_xz: unsupported device {bxmin.device}")
    dev, n = bxmin.device, bxmin.shape[0]
    n_iv = _devseek_checks("devseek_xz", starts, ends, cand_cap, n, dev)
    cols = [("bxmin", bxmin), ("bymin", bymin), ("bxmax", bxmax), ("bymax", bymax)]
    for what, t in cols + ([("tk", tk)] if has_time else []):
        _check(t, what, torch.int64, dev, (n,))
    _check(isrect, "isrect", torch.bool, dev, (n,))
    _check(valid, "valid", torch.bool, dev, (n,))
    _check(desc, "desc", torch.int64, dev, (XZ_DESC,))
    fn = _lib("devseek").devseek_xz
    with torch.cuda.device(dev):
        out = torch.empty(2 * cand_cap // 8, dtype=torch.uint8, device=dev)  # every word written
        err = fn(int(has_time), bxmin.data_ptr(), bymin.data_ptr(), bxmax.data_ptr(),
                 bymax.data_ptr(), isrect.data_ptr(), valid.data_ptr(),
                 tk.data_ptr() if has_time else None, starts.data_ptr(), ends.data_ptr(), n_iv,
                 desc.data_ptr(), out.data_ptr(), cand_cap, _stream(dev))
    _raise_on(err, "devseek_xz")
    _count("devseek_xz_" + ("xz3" if has_time else "xz2"), f"cand={cand_cap}")
    return out
