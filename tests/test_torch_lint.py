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
* no module imports ``jax`` or anything of ``geomesa_tpu``.
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
