"""The port's serving utilities against the JAX package's, on the CPU.

``utils/deadline.py``, ``utils/faults.py``, ``utils/admission.py`` and the
override tier of ``utils/config.py``: each scenario runs on the port's
module and on the reference's, and both must behave alike (the same
raises, the same admissions, the same seeded fault sequence for the same
spec and seed).
"""

import contextvars
import threading
import time

import pytest

from geomesa_tpu.utils import admission as ref_admission
from geomesa_tpu.utils import audit as ref_audit
from geomesa_tpu.utils import config as ref_config
from geomesa_tpu.utils import deadline as ref_deadline
from geomesa_tpu.utils import faults as ref_faults

from geomesa_tpu_torch.utils import admission, audit, config, deadline, faults

MODS = {
    "port": (admission, deadline, audit, faults, config),
    "ref": (ref_admission, ref_deadline, ref_audit, ref_faults, ref_config),
}


@pytest.fixture(params=sorted(MODS))
def mods(request):
    return MODS[request.param]


def _hold(ctl, priority=None):
    ctx = contextvars.Context()
    admit = ctl.admit(priority=priority)
    ctx.run(admit.__enter__)
    return lambda: ctx.run(admit.__exit__, None, None, None)


def _wait_queued(ctl, n):
    for _ in range(500):
        with ctl._cond:
            if ctl.queued >= n:
                return
        time.sleep(0.002)
    raise AssertionError(f"{n} waiters never queued")


# -- deadline ---------------------------------------------------------------


def test_deadline_budget_check_and_nesting(mods):
    _adm, dl_mod, au, _f, _c = mods
    assert dl_mod.ambient() is None and dl_mod.remaining() is None
    dl_mod.check("nothing")  # free without a budget
    with dl_mod.budget(30.0) as outer:
        assert dl_mod.ambient() is outer and 29.0 < dl_mod.remaining() <= 30.0
        with dl_mod.budget(60.0) as inner:  # a nested budget only tightens
            assert inner.t_end == outer.t_end
        with dl_mod.budget(None) as same:
            assert same is outer
    with dl_mod.budget(0.0):
        with pytest.raises(au.QueryTimeout, match="budget"):
            dl_mod.check("scan.block")
    assert dl_mod.ambient() is None


def test_deadline_cancel_pierces_nesting_and_attach(mods):
    _adm, dl_mod, au, _f, _c = mods
    outer = dl_mod.Deadline(30.0)
    inner = dl_mod.Deadline(30.0, outer=outer)
    fired = []
    unreg = inner.on_cancel(lambda: fired.append("inner"))
    dropped = outer.on_cancel(lambda: fired.append("dropped"))
    dropped()
    outer.cancel()
    assert fired == ["inner"] and inner.is_cancelled
    late = []
    inner.on_cancel(lambda: late.append(1))
    assert late == [1]  # already cancelled: fires at once
    unreg()
    with dl_mod.attach(inner):
        assert dl_mod.ambient() is inner
        with pytest.raises(au.QueryTimeout, match="cancelled"):
            dl_mod.check("admit.wait")
    with dl_mod.attach(None) as d:
        assert d is None


# -- faults -----------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "batch.coalesce:error=0.3,batch.coalesce:drop=0.5",
    "batch.coalesce:latency@2x3=0.8",
    "batch.*:error@1=0.6",
])
@pytest.mark.parametrize("seed", [3, 11, 42])
def test_fault_draws_match_the_reference(spec, seed):
    """One spec and seed: the same rule fires on the same hit, over 200
    hits, in both packages."""
    port_set, ref_set = faults.parse(spec, seed=seed), ref_faults.parse(spec, seed=seed)
    kinds = ("error", "drop", "latency", "crash")
    got = [getattr(port_set.draw("batch.coalesce", kinds), "kind", None) for _ in range(200)]
    want = [getattr(ref_set.draw("batch.coalesce", kinds), "kind", None) for _ in range(200)]
    assert got == want
    assert any(got) and not all(got)


def test_fault_point_raises_and_counts(mods):
    _adm, dl_mod, au, f_mod, _c = mods
    reg = au.robustness_metrics()
    for kind, exc in (("error", OSError), ("drop", ConnectionError)):
        c0 = reg.counter(f"fault.batch.coalesce.{kind}")
        with f_mod.inject(f"batch.coalesce:{kind}", seed=1):
            with pytest.raises(exc):
                f_mod.fault_point("batch.coalesce")
        assert reg.counter(f"fault.batch.coalesce.{kind}") == c0 + 1
    with f_mod.inject("batch.coalesce:crash@1x1", seed=1):
        f_mod.fault_point("batch.coalesce")  # skipped
        with pytest.raises(BaseException) as e:
            f_mod.fault_point("batch.coalesce")
        assert not isinstance(e.value, Exception)
        f_mod.fault_point("batch.coalesce")  # capped
    with f_mod.inject(rules=[f_mod.FaultRule("batch.coalesce", "latency", latency_s=5.0)]):
        with dl_mod.budget(0.05):
            t0 = time.perf_counter()
            f_mod.fault_point("batch.coalesce")  # never sleeps past the budget
            assert time.perf_counter() - t0 < 1.0
    with pytest.raises(ValueError):
        f_mod.parse("batch.coalesce")
    with pytest.raises(ValueError):
        f_mod.inject("batch.coalesce:melt")


# -- admission --------------------------------------------------------------


def test_admission_caps_inflight_and_sheds_past_the_queue(mods):
    adm, dl_mod, au, _f, _c = mods
    ctl = adm.AdmissionController(max_inflight=2, max_queue=1, critical_reserve=0)
    r1, r2 = _hold(ctl), _hold(ctl)
    assert ctl.inflight == 2
    admitted = threading.Event()

    def waiter():
        with ctl.admit():
            admitted.set()

    th = threading.Thread(target=waiter)
    th.start()
    _wait_queued(ctl, 1)
    c0 = au.robustness_metrics().counter("shed.overflow")
    with pytest.raises(au.ShedLoad):
        with ctl.admit():
            pass
    assert au.robustness_metrics().counter("shed.overflow") == c0 + 1
    assert not admitted.is_set()
    r1()
    assert admitted.wait(5)
    th.join(5)
    r2()
    assert ctl.inflight == 0 and ctl.queued == 0 and ctl.sheds == 1
    # a budget that dies in the queue: QueryTimeout, never admitted
    releases = [_hold(ctl), _hold(ctl)]
    with dl_mod.budget(0.05):
        with pytest.raises(au.QueryTimeout, match="admission queue"):
            with ctl.admit():
                pass
    for release in releases:
        release()
    assert ctl.inflight == 0


def test_admission_priority_reserve_and_nesting(mods):
    """The critical reserve: a non-critical query stops one slot short, a
    critical one takes the last slot; a nested admit rides its context's
    slot; classify reads the priority hint."""
    adm, _dl, _au, _f, _c = mods
    ctl = adm.AdmissionController(max_inflight=2, max_queue=4, critical_reserve=1)
    r1 = _hold(ctl, "batch")
    order = []

    def waiter():
        with ctl.admit(priority="interactive"):
            order.append("interactive")

    th = threading.Thread(target=waiter)
    th.start()
    _wait_queued(ctl, 1)
    with ctl.admit(priority="critical"):
        order.append("critical")
        with ctl.admit(priority="critical"):  # rides the slot
            assert ctl.inflight == 2
    assert order == ["critical"]
    r1()
    th.join(5)
    assert order == ["critical", "interactive"]
    assert adm.classify({adm.PRIORITY_HINT: " Critical "}) == "critical"
    assert adm.classify({adm.PRIORITY_HINT: "urgent"}) == "interactive"
    assert adm.classify(None) == "interactive"
    assert adm.PRIORITIES == ("critical", "interactive", "batch", "background")


def test_admission_cancel_wakes_a_queued_waiter_at_once(mods):
    adm, dl_mod, au, _f, _c = mods
    ctl = adm.AdmissionController(max_inflight=1, max_queue=4)
    release = _hold(ctl)
    try:
        dl = dl_mod.Deadline(30.0)
        woke = {}

        def waiter():
            t0 = time.perf_counter()
            try:
                with dl_mod.attach(dl):
                    with ctl.admit():
                        pass
            except au.QueryTimeout:
                woke["t"] = time.perf_counter() - t0

        th = threading.Thread(target=waiter)
        th.start()
        _wait_queued(ctl, 1)
        t_cancel = time.perf_counter()
        dl.cancel()
        th.join(5)
        assert "t" in woke
        assert time.perf_counter() - t_cancel < 0.5
    finally:
        release()
    assert ctl.queued == 0 and ctl.inflight == 0


# -- config -----------------------------------------------------------------


@pytest.fixture
def knob(mods):
    """A knob of the module under test, out of the reference's registry
    of known knobs afterwards."""
    cfg = mods[4]
    yield cfg.SystemProperty("geomesa.test.serving.knob", "7")
    getattr(cfg, "_KNOWN", {}).pop("geomesa.test.serving.knob", None)


def test_properties_scope_and_tiers(mods, knob, monkeypatch):
    cfg = mods[4]
    assert knob.to_int() == 7
    monkeypatch.setenv("GEOMESA_TEST_SERVING_KNOB", "9")
    assert knob.get() == "9"
    with cfg.properties(geomesa_test_serving_knob="2 seconds"):
        assert knob.to_duration_ms() == 2000
        with cfg.properties(geomesa_test_serving_knob="off"):
            assert knob.to_bool() is False and knob.to_int() == 7
        assert knob.get() == "2 seconds"
    assert knob.get() == "9"
    cfg.set_property("geomesa.test.serving.knob", "1.5")
    try:
        assert knob.to_float() == 1.5 and knob.to_bool() is False
    finally:
        cfg.set_property("geomesa.test.serving.knob", None)
    assert knob.get() == "9"
    for name in ("BATCH_ENABLED", "BATCH_WINDOW_MS", "BATCH_MAX_QUERIES", "QUERY_TIMEOUT",
                 "QUERY_MAX_INFLIGHT", "QUERY_QUEUE_DEPTH", "PRIORITY_DEFAULT"):
        port_knob, ref_knob = getattr(config, name), getattr(ref_config, name)
        assert (port_knob.name, port_knob.default) == (ref_knob.name, ref_knob.default), name
