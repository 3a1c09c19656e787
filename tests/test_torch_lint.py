"""The port's lint, by AST scan of ``geomesa_tpu_torch/``.

* only ``ops/kernels.py`` reaches a kernel library (``_lib(`` or
  ``kernels._LIBS``), and only it and the native host loader import
  ``ctypes``;
* every wrapper in ``ops/kernels.py`` that launches (checks a launch's
  error with ``_raise_on``) also counts the launch (``_count``), and
  every fault it raises is a ``KernelError``;
* ``.cpu()`` and ``.numpy()`` appear only in the counted device -> host
  helper (``parallel/mesh.py`` ``fetch``), and ``torch.as_tensor`` /
  ``torch.from_numpy`` only in the counted host -> device helper
  (``upload``): every copy over the link is in the device receipts;
* those two helpers carry the ``device.dispatch`` / ``device.fetch`` fault
  points (with their spans and budget checks), so every copy over the
  link can fail the way a device does; only the link probe skips them;
* no module imports ``jax`` or anything of ``geomesa_tpu``;
* the telemetry modules (``utils/audit.py``, ``plans.py``, ``tenants.py``,
  ``timeline.py``, ``slo.py``, ``brownout.py``, ``admission.py``) are in
  the scan and touch no tensor: only ``utils/trace.py`` imports ``torch``
  (for its profiler ranges);
* the spatial join (``ops/join.py``) and the device-assisted seek reach
  their kernels through the counted wrappers and their copies through
  ``mesh``: each launch is counted, each copy is in the receipts;
* every ``decision(point, reason)`` names its point as a string constant
  and its reason as a stable code (a constant, or a name or f-string of
  names that picks among constants; never a formatted message), and every
  store
  path that folds a query into the plan registry sits in an open
  plan-telemetry scope (``plans.begin`` / ``end``).
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "geomesa_tpu_torch")


def _modules():
    out = {}
    for d, dirs, files in os.walk(PORT):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    out[os.path.relpath(path, PORT)] = ast.parse(fh.read(), path)
    return out


MODULES = _modules()
KERNELS = os.path.join("ops", "kernels.py")
MESH = os.path.join("parallel", "mesh.py")
EXECUTOR = os.path.join("parallel", "executor.py")
PYRAMID = os.path.join("ops", "pyramid.py")


def _functions(tree):
    """(qualified name, node) of every function, methods as Class.name."""
    out = []

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((prefix + child.name, child))
                walk(child, prefix + child.name + ".")
            elif isinstance(child, ast.ClassDef):
                walk(child, prefix + child.name + ".")

    walk(tree, "")
    return out


def _called(node, name: str) -> bool:
    """Whether ``node`` calls ``name`` (a bare name or an attribute)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            if (isinstance(f, ast.Name) and f.id == name) or (
                    isinstance(f, ast.Attribute) and f.attr == name):
                return True
    return False


def _method_sites(name: str):
    """(module, enclosing function) of every call of ``.name(...)``."""
    sites = []
    for mod, tree in MODULES.items():
        for fname, fn in _functions(tree):
            inner = {id(n) for _f, g in _functions(fn) for n in ast.walk(g)}
            for n in ast.walk(fn):
                if id(n) in inner:
                    continue  # counted in the nested function itself
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                        and n.func.attr == name:
                    sites.append((mod, fname))
    return sites


def test_the_scan_sees_the_package():
    assert KERNELS in MODULES and MESH in MODULES and len(MODULES) > 40


def test_only_ops_kernels_reaches_a_kernel_library():
    offenders = []
    for mod, tree in MODULES.items():
        if mod == KERNELS:
            continue
        for n in ast.walk(tree):
            if isinstance(n, ast.Call) and ((isinstance(n.func, ast.Name) and n.func.id == "_lib")
                                            or (isinstance(n.func, ast.Attribute)
                                                and n.func.attr == "_lib")):
                offenders.append(f"{mod}:{n.lineno} _lib(")
            if isinstance(n, ast.Attribute) and n.attr == "_LIBS":
                offenders.append(f"{mod}:{n.lineno} _LIBS")
    assert not offenders, offenders
    ctypes_users = sorted(
        mod for mod, tree in MODULES.items()
        for n in ast.walk(tree)
        if (isinstance(n, ast.Import) and any(a.name == "ctypes" for a in n.names))
        or (isinstance(n, ast.ImportFrom) and n.module == "ctypes"))
    assert ctypes_users == [os.path.join("native", "__init__.py"), KERNELS]


def test_every_launching_wrapper_counts_its_launch():
    launchers = [(name, fn) for name, fn in _functions(MODULES[KERNELS])
                 if _called(fn, "_raise_on")]
    assert len(launchers) >= 9
    uncounted = [name for name, fn in launchers if not _called(fn, "_count")]
    assert not uncounted, uncounted
    # and nothing but a launcher counts: a count means a launch
    counting = {name for name, fn in _functions(MODULES[KERNELS]) if _called(fn, "_count")}
    assert counting == {name for name, _fn in launchers}


def test_kernel_faults_raise_kernel_errors():
    """Every exception ``ops/kernels.py`` raises is a ``KernelError`` (a
    build, argument or launch fault, which the executor's envelopes
    re-raise instead of degrading to the host), but inside ``_compile``,
    whose failure ``_lib`` wraps in ``KernelBuildError``."""
    kernel_errors = {"KernelError", "KernelBuildError", "KernelLaunchError",
                     "KernelArgumentError", "KernelDtypeError"}
    offenders = []
    for name, fn in _functions(MODULES[KERNELS]):
        if name == "_compile":
            continue
        for n in ast.walk(fn):
            if isinstance(n, ast.Raise) and isinstance(n.exc, ast.Call):
                f = n.exc.func
                if not (isinstance(f, ast.Name) and f.id in kernel_errors):
                    offenders.append(f"{name}:{n.lineno}")
    assert not offenders, offenders
    lib = dict(_functions(MODULES[KERNELS]))["_lib"]
    assert _called(lib, "KernelBuildError")


def test_pyramid_counts_launch_and_grid_copies_are_counted():
    """The pyramid build's wrapper counts its launch, the executor fetches
    each segment's grid through the counted helper, and the pyramid's
    device copies go up through ``upload``."""
    kern = dict(_functions(MODULES[KERNELS]))["pyramid_counts"]
    assert _called(kern, "_raise_on") and _called(kern, "_count")
    build = dict(_functions(MODULES[EXECUTOR]))["TorchScanExecutor.pyramid_counts"]
    assert _called(build, "pyramid_counts") and _called(build, "_np_local")
    assert not (_called(build, "cpu") or _called(build, "numpy"))
    resident = dict(_functions(MODULES[PYRAMID]))["AggPyramid.ensure_device"]
    assert _called(resident, "upload")


@pytest.mark.parametrize("method", ["cpu", "numpy"])
def test_device_to_host_copies_pass_the_counted_helper(method):
    assert _method_sites(method) == [(MESH, "fetch")]


@pytest.mark.parametrize("fn", ["as_tensor", "from_numpy"])
def test_host_to_device_copies_pass_the_counted_helper(fn):
    assert _method_sites(fn) == ([(MESH, "upload")] if fn == "as_tensor" else [])


def test_no_module_imports_jax_or_the_reference():
    offenders = []
    for mod, tree in MODULES.items():
        for n in ast.walk(tree):
            names = []
            if isinstance(n, ast.Import):
                names = [a.name for a in n.names]
            elif isinstance(n, ast.ImportFrom) and n.level == 0:
                names = [n.module or ""]
            offenders += [f"{mod}:{n.lineno} {x}" for x in names
                          if x.split(".")[0] in ("jax", "jaxlib", "geomesa_tpu")]
    assert not offenders, offenders


def _strings(node):
    return {n.value for n in ast.walk(node) if isinstance(n, ast.Constant)
            and isinstance(n.value, str)}


@pytest.mark.parametrize("helper,point", [("upload", "device.dispatch"),
                                          ("fetch", "device.fetch")])
def test_link_helpers_carry_the_fault_points(helper, point):
    fn = dict(_functions(MODULES[MESH]))[helper]
    for call in ("fault_point", "check", "span"):
        assert _called(fn, call), (helper, call)
    assert point in _strings(fn)
    assert _called(dict(_functions(MODULES[EXECUTOR]))["_np_local"], "fetch")


def test_only_the_link_probe_skips_the_fetch_fault_point():
    """``fetch(..., boundary=False)`` (no span, check or fault point) only
    in ``link_latency_ms``."""
    sites = []
    for mod, tree in MODULES.items():
        for fname, fn in _functions(MODULES[mod]):
            for n in ast.walk(fn):
                if isinstance(n, ast.Call) and any(k.arg == "boundary" for k in n.keywords) \
                        and _called(n, "fetch"):
                    sites.append((mod, fname))
    assert sites and set(sites) == {(MESH, "link_latency_ms")}, sites


TELEMETRY = [os.path.join("utils", f"{m}.py") for m in
             ("audit", "plans", "tenants", "timeline", "slo", "brownout", "admission", "trace")]


def _imports(tree):
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            out.update(a.name.split(".")[0] for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.level == 0 and n.module:
            out.add(n.module.split(".")[0])
    return out


@pytest.mark.parametrize("mod", TELEMETRY)
def test_telemetry_modules_touch_no_tensor(mod):
    assert mod in MODULES
    uses_torch = "torch" in _imports(MODULES[mod])
    assert uses_torch == (mod == os.path.join("utils", "trace.py")), mod


def _stable_code(node) -> bool:
    """A string constant, a name (a code chosen among constants) or an
    f-string of constants and names: never a call or an attribute, which is
    how an exception's message would get in."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, ast.Name):
        return True
    if isinstance(node, ast.JoinedStr):
        return all(isinstance(v, ast.Constant) or (isinstance(v, ast.FormattedValue)
                                                    and isinstance(v.value, ast.Name))
                   for v in node.values)
    return False


def test_decisions_name_stable_codes():
    sites = []
    for mod, tree in MODULES.items():
        for n in ast.walk(tree):
            if isinstance(n, ast.Call) and (
                    (isinstance(n.func, ast.Name) and n.func.id == "decision")
                    or (isinstance(n.func, ast.Attribute) and n.func.attr == "decision")):
                point, reason = (n.args + [None, None])[:2]
                ok = (isinstance(point, ast.Constant) and isinstance(point.value, str)
                      and reason is not None and _stable_code(reason))
                sites.append((mod, n.lineno, ok))
    assert len(sites) >= 12
    assert all(ok for *_s, ok in sites), [s for s in sites if not s[2]]


def test_store_observes_plans_inside_a_scope():
    """``query``, each ``query_many`` member and ``aggregate`` open the
    pending scope their observation drains (``plans.begin`` ... ``end``)."""
    store = dict(_functions(MODULES[os.path.join("store", "datastore.py")]))
    for fn in ("TorchDataStore.query", "TorchDataStore._query_many_planned",
               "TorchDataStore.aggregate"):
        assert _called(store[fn], "begin") and _called(store[fn], "end"), fn
    for fn in ("TorchDataStore._audit", "TorchDataStore._audit_failure",
               "TorchDataStore.aggregate"):
        assert _called(store[fn], "observe"), fn


JOIN = os.path.join("ops", "join.py")
STORE = os.path.join("store", "datastore.py")


@pytest.mark.parametrize("wrapper", ["join_pip", "join_dwithin", "devseek", "devseek_xz"])
def test_join_and_devseek_launches_are_counted(wrapper):
    fn = dict(_functions(MODULES[KERNELS]))[wrapper]
    assert _called(fn, "_raise_on") and _called(fn, "_count"), wrapper


def test_join_and_devseek_copies_pass_the_counted_helpers():
    """The join uploads its build side and each probe chunk through
    ``upload`` (``join_upload``) and fetches each chunk's flags through the
    counted ``fetch`` (``join_fetch``); the seek uploads its descriptors and
    intervals through ``upload`` and resolves through ``_np_local``; and
    its every decision is a constant code."""
    join = dict(_functions(MODULES[JOIN]))
    ex = dict(_functions(MODULES[EXECUTOR]))
    assert _called(join["JoinBuild.ensure_device"], "upload")
    dj = join["device_join"]
    assert _called(dj, "join_upload") and _called(dj, "join_fetch")
    assert _called(dj, "join_pip") and _called(dj, "join_dwithin")
    assert _called(ex["join_upload"], "upload") and _called(ex["join_fetch"], "_np_local")
    for fn in ("TorchScanExecutor._device_seek", "TorchScanExecutor._device_seek_xz",
               "TorchScanExecutor._candidate_batches"):
        assert _called(ex[fn], "upload"), fn
    assert _called(ex["TorchScanExecutor._device_seek"], "devseek")
    assert _called(ex["TorchScanExecutor._device_seek_xz"], "devseek_xz")
    for cls in ("_DeviceSeekScan", "_DeviceSeekXZScan"):
        assert _called(ex[f"{cls}.__iter__"], "_np_local"), cls
    for mod in (JOIN, STORE, EXECUTOR):
        for _name, fn in _functions(MODULES[mod]):
            assert not (_called(fn, "cpu") or _called(fn, "numpy") or _called(fn, "as_tensor"))
    reasons = set()
    for n in ast.walk(MODULES[JOIN]):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "decision":
            assert isinstance(n.args[0], ast.Constant) and n.args[0].value == "join.kernel"
            assert isinstance(n.args[1], ast.Constant)
            reasons.add(n.args[1].value)
    assert reasons == {"build_ineligible", "antipodal_radius", "env_disabled",
                       "device_tripped", "brownout"}
    store = dict(_functions(MODULES[STORE]))["TorchDataStore.query_join"]
    assert _called(store, "begin") and _called(store, "end") and _called(store, "observe")
