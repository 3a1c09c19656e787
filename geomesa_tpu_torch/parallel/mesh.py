"""Device choice, row padding and the counted link boundary.

Port of ``geomesa_tpu/parallel/mesh.py`` for one device. The reference
shards rows over a JAX mesh; this slice of the port runs on one CUDA device
(or on the CPU when a caller asks for it, as the tests do). ``upload`` is
the one host -> device copy and ``fetch`` the one device -> host copy of
the port: each counts its bytes in ``utils/devstats.py``
(``device.h2d.bytes`` / ``device.d2h.bytes`` and the query's receipt), and
each is a fault point with its span and its budget check
(``device.dispatch`` and ``device.fetch``, ``utils/faults.py``), so an
injected fault surfaces where a failing device would. ``device_tripped`` /
``trip_device`` keep the session's sticky device-kNN trip.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from geomesa_tpu_torch.utils import deadline, devstats, faults, trace

Device = Union[str, torch.device]

# measured host <-> device round trip (ms) per device
_LINK_LATENCY_MS: Dict[str, float] = {}


def default_device(device: Optional[Device] = None) -> torch.device:
    """The device to run on: ``device`` when given, else the first CUDA
    device. Raises when no device is given and CUDA is unavailable — the
    port never carries on silently on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", 0)


def pad_to_multiple(arr: np.ndarray, multiple: int, fill) -> np.ndarray:
    """Pad axis 0 to a multiple of ``multiple`` with ``fill``."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr
    pad_width = [(0, rem)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill)


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> contiguous tensor on ``device`` (the
    ``device.dispatch`` boundary: its span, budget check and fault point),
    its bytes counted as host -> device after the copy (on the CPU too: the
    bytes that crossed the boundary helper; a faulted copy moved
    nothing)."""
    arr = np.ascontiguousarray(arr)
    with trace.span("device.dispatch", bytes=int(arr.nbytes)):
        deadline.check("device.dispatch")
        faults.fault_point("device.dispatch")
        out = torch.as_tensor(arr, device=device)
    devstats.count_h2d(arr.nbytes)
    return out


def fetch(t: torch.Tensor, boundary: bool = True) -> np.ndarray:
    """Device tensor -> host numpy array (the ``device.fetch`` boundary:
    its span, budget check and fault point), its bytes counted as device
    -> host. ``boundary=False`` skips the span, the check and the fault
    point (the link probe's own round trips)."""
    nbytes = int(t.numel() * t.element_size())
    with record_function("geomesa.fetch"), (
            trace.span("device.fetch", bytes=nbytes) if boundary else contextlib.nullcontext()):
        if boundary:
            deadline.check("device.fetch")
            faults.fault_point("device.fetch")
        out = t.cpu().numpy()
    devstats.count_d2h(out.nbytes)
    return out


def link_latency_ms(device: Optional[Device] = None) -> float:
    """Measured host <-> device round-trip latency in ms (the reference's
    ``link_latency_ms``, "link_probe"): the least of 5 round trips of
    ``x + 1`` on eight floats of ``device`` (the first CUDA device by
    default), after one warm trip, cached per device. The floor of any
    device dispatch: the automatic device paths (the kNN top-k) decline
    over a slow link. 0.0 on the CPU, where device compute is host
    compute."""
    dev = default_device(device)
    if dev.type == "cpu":
        return 0.0
    key = str(dev)
    got = _LINK_LATENCY_MS.get(key)
    if got is None:
        x = torch.zeros(8, dtype=torch.float32, device=dev)
        fetch(x + 1, boundary=False)  # the first trip pays the allocations
        samples = []
        for _ in range(5):
            t0 = time.perf_counter()
            fetch(x + 1, boundary=False)
            samples.append((time.perf_counter() - t0) * 1e3)
        # the least, not the median: the cost choice wants the link's floor,
        # and contention on the host only ever inflates a sample
        got = _LINK_LATENCY_MS[key] = float(min(samples))
    return got


def device_auto_declines(env_var: str, link_cap_ms: float = 10.0,
                         device: Optional[Device] = None) -> bool:
    """The cost gate of the scalar and aggregate push-downs (the count and
    the stats): True when the path should answer on the host. ``env_var``
    "0" declines and "1" passes; "auto" (or unset) declines on a CPU
    ``device``, where device compute is host compute, and on a CUDA device
    whose round trip (``link_latency_ms``) is above ``link_cap_ms``."""
    env = os.environ.get(env_var, "auto")
    if env == "0":
        return True
    if env == "1":
        return False
    dev = default_device(device)
    if dev.type == "cpu":
        return True
    return link_latency_ms(dev) > link_cap_ms


def device_tripped(executor, env_var: str) -> bool:
    """True when a device path already failed this session AND the caller
    has not forced this path on (``env_var`` != "1"): an automatic path
    stays on the host after one failure instead of paying it per call; an
    explicit "1" keeps trying (the reference's ``device_tripped``)."""
    if os.environ.get(env_var, "auto") == "1":
        return False
    return bool(getattr(executor, "_device_tripped", False))


def trip_device(executor, env_var: str, tag: str, exc: BaseException) -> None:
    """Record a device-path failure: one stderr line, a
    ``decision.degrade.<tag>_to_host`` count, and the executor's session
    trip flag, unless the caller forced this path on (a failure under a
    forced "1" must not send the other automatic paths to the host)."""
    import sys

    from geomesa_tpu_torch.utils import audit

    if os.environ.get(env_var, "auto") != "1":
        executor._device_tripped = True
    audit.decision("degrade", f"{tag}_to_host", error=type(exc).__name__)
    sys.stderr.write(f"[{tag}] device path failed ({type(exc).__name__}); host path answers\n")
