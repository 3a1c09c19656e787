"""The port's brownout ladder against the JAX package, on the CPU.

* The ladder: the same injected ticks (admission queue fill, SLO
  verdicts, enter / exit hysteresis knobs) walk the port's
  ``BrownoutController`` through the reference's level sequence, one rung
  a step, with the same Retry-After, signals and transition records.
* The store: levels forced by injected ticks (queue-ratio thresholds set
  to 0, so an empty queue reads as overload) shed ``background`` at 1 and
  ``batch`` at 2 with ``ShedLoad`` and a Retry-After; ``interactive`` and
  ``critical`` answer equal to a brute-force oracle at every level; at 2 a
  cold pyramid build defers (``decision.pyramid.brownout_deferred``, the
  count still exact) while a warm pyramid keeps answering; at 3 a
  non-critical query that would queue sheds; the ladder exits one rung a
  step and answers stay equal. The store's timeline tick drives it.
* ``geomesa.brownout.enabled=false``: a forced level sheds nothing.
"""

import contextvars

import numpy as np
import pytest
import torch

from geomesa_tpu.utils import brownout as ref_brownout
from geomesa_tpu.utils import slo as ref_slo

from geomesa_tpu_torch.index.planner import Query
from geomesa_tpu_torch.utils import brownout, slo, timeline
from geomesa_tpu_torch.utils.audit import ShedLoad, robustness_metrics
from geomesa_tpu_torch.utils.config import properties
from telemetry_pair import REF_ENV, columns, pair

BOX = (-50.0, -50.0, 50.0, 50.0)
CQL = "bbox(geom, -50, -50, 50, 50)"


@pytest.fixture(scope="module", autouse=True)
def _env():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_ENV.items():
            mp.setenv(k, v)
        yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _flags():
    for mod in (brownout, ref_brownout):
        mod.set_enabled(None)
    yield
    for mod in (brownout, ref_brownout):
        mod.set_enabled(None)


class _Admission:
    """An admission gate whose queue depth the test scripts."""

    def __init__(self, max_queue=100):
        self.max_queue = max_queue
        self.queued = 0

    def peek(self):
        return {"inflight": 0, "queued": self.queued}


class _Engine:
    def __init__(self, store):
        self.store = store

    def evaluate(self, exemplars=True):
        bad = self.store.violating
        return {"violating": bad,
                "slos": [{"name": n, "violating": True, "fast": {"burn_rate": 20.5}}
                         for n in bad]}


class _Store:
    def __init__(self):
        self.admission = _Admission()
        self.violating = []


def _script(seed, n=60):
    """Seeded ticks: (queued of 100, violating SLO names)."""
    rng = np.random.default_rng(seed)
    out = []
    level = 0
    for _ in range(n):
        level = int(np.clip(level + rng.integers(-30, 31), 0, 100))
        out.append((level, ["query-latency"] if rng.random() < 0.2 else []))
    return out


@pytest.mark.parametrize("enter,exit_", [("2", "3"), ("1", "1"), ("3", "2")])
@pytest.mark.parametrize("seed", [0, 1])
def test_ladder_sequence_equals_the_reference(seed, enter, exit_, monkeypatch):
    monkeypatch.setenv("GEOMESA_BROWNOUT_ENTER_TICKS", enter)
    monkeypatch.setenv("GEOMESA_BROWNOUT_EXIT_TICKS", exit_)
    monkeypatch.setattr(slo, "engine_for", lambda store, create=True: _Engine(store))
    monkeypatch.setattr(ref_slo, "engine_for", lambda store, create=True: _Engine(store))
    ctl, ref = brownout.BrownoutController(), ref_brownout.BrownoutController()
    st, rst = _Store(), _Store()
    levels, ref_levels = [], []
    for queued, bad in _script(seed):
        for s in (st, rst):
            s.admission.queued, s.violating = queued, bad
        got, want = ctl.on_tick(st), ref.on_tick(rst)
        assert (got is None) == (want is None)
        if got is not None:
            assert {k: v for k, v in got.items() if k != "since"} == \
                {k: v for k, v in want.items() if k != "since"}
        levels.append(ctl.level)
        ref_levels.append(ref.level)
        assert ctl.retry_after_s() == ref.retry_after_s()
        assert ctl.shedding_classes() == ref.shedding_classes()
        for p in ("critical", "interactive", "batch", "background"):
            assert ctl.should_shed(p) == ref.should_shed(p)
            assert ctl.queue_allowed(p) == ref.queue_allowed(p)
        assert ctl.speculation_allowed() == ref.speculation_allowed()
        assert ctl.hedging_allowed() == ref.hedging_allowed()
    assert levels == ref_levels
    assert max(levels) >= 2 and all(abs(a - b) <= 1 for a, b in zip(levels, levels[1:]))
    strip = lambda h: [{k: v for k, v in r.items() if k != "t"} for r in h]  # noqa: E731
    assert strip(ctl._history) == strip(ref._history)
    snap = ctl.snapshot()
    assert snap["level"] == ctl.level and snap["transitions"]


def test_a_quiet_store_reports_nothing():
    ctl = brownout.BrownoutController()
    assert ctl.on_tick(_Store()) is None and ctl.level == 0
    assert brownout.controller_for(object()) is None


# -- the store under a forced ladder ---------------------------------------------


def _hint(cql, pri):
    q = Query.cql(cql)
    q.hints["geomesa.query.priority"] = pri
    return q


def _oracle(cols, box=BOX):
    x, y = cols["geom__x"], cols["geom__y"]
    m = (x >= box[0]) & (x <= box[2]) & (y >= box[1]) & (y <= box[3])
    return set(cols["__fid__"][m])


def _tick_to(store, level, sampler):
    """Drive the ladder to ``level`` by injected ticks: the queue-ratio
    thresholds at 0 (an empty queue reads as full) to raise it, the
    defaults to lower it, one rung a tick (enter / exit after 1 tick)."""
    over = store._brownout.level < level
    ratios = {"geomesa_brownout_queue_ratio_1": "0", "geomesa_brownout_queue_ratio_2": "0",
              "geomesa_brownout_queue_ratio_3": "0"} if over else {}
    seen = []
    with properties(geomesa_brownout_enter_ticks="1", geomesa_brownout_exit_ticks="1",
                    **ratios):
        for _ in range(8):
            if store._brownout.level == level:
                break
            snap = sampler.tick()
            seen.append(snap["brownout"]["level"] if "brownout" in snap else 0)
    return seen


def test_store_sheds_defers_and_recovers():
    cols = columns(4000, 5)
    want = _oracle(cols)
    _ref, port = pair(cols=cols, port_kw={"max_inflight": 2})
    sampler = timeline.TimelineSampler(store=port, interval_s=1.0, window_s=60.0)
    m = robustness_metrics()
    d0 = m.counter("decision.pyramid.brownout_deferred")
    assert _tick_to(port, 1, sampler) == [1]
    with pytest.raises(ShedLoad) as e:
        port.query("gdelt", _hint(CQL, "background"))
    assert e.value.retry_after_s == 1.0
    assert set(port.query("gdelt", _hint(CQL, "batch")).fids) == want
    assert _tick_to(port, 2, sampler) == [2]
    for pri in ("batch", "background"):
        with pytest.raises(ShedLoad):
            port.query("gdelt", _hint(CQL, pri))
    with pytest.raises(ShedLoad):
        port.query_many("gdelt", [_hint(CQL, "batch")])
    for pri in ("interactive", "critical"):
        assert set(port.query("gdelt", _hint(CQL, pri)).fids) == want
    # a cold pyramid build defers; the count is the exact scan's
    assert port.count("gdelt", CQL) == len(want)
    assert m.counter("decision.pyramid.brownout_deferred") == d0 + 1
    assert port.aggregate("gdelt", CQL)["count"] == len(want)
    assert m.counter("decision.pyramid.brownout_deferred") == d0 + 2
    assert "_agg_cache" not in port.__dict__ or len(port._agg_cache) == 0
    assert _tick_to(port, 3, sampler) == [3]
    # level 3: a non-critical query that would queue sheds at once (one
    # slot held; the critical reserve keeps the other for critical)
    ctx = contextvars.Context()
    held = port.admission.admit(priority="critical")
    ctx.run(held.__enter__)
    try:
        with pytest.raises(ShedLoad, match="refuses to queue"):
            port.query("gdelt", _hint(CQL, "interactive"))
        assert set(port.query("gdelt", _hint(CQL, "critical")).fids) == want
    finally:
        ctx.run(held.__exit__, None, None, None)
    assert set(port.query("gdelt", _hint(CQL, "interactive")).fids) == want
    # the ladder exits one rung a tick; the cold build runs again
    assert _tick_to(port, 0, sampler) == [2, 1, 0]
    for pri in ("background", "batch", "interactive", "critical"):
        assert set(port.query("gdelt", _hint(CQL, pri)).fids) == want
    assert port.count("gdelt", CQL) == len(want)
    assert m.counter("decision.pyramid.brownout_deferred") == d0 + 2
    assert len(port._agg_cache) > 0
    assert m.counter("decision.brownout.raise") >= 3 and m.counter("decision.brownout.lower") >= 3


def test_a_warm_pyramid_keeps_answering_at_level_two():
    cols = columns(4000, 6)
    _ref, port = pair(cols=cols)
    sampler = timeline.TimelineSampler(store=port, interval_s=1.0, window_s=60.0)
    n = port.count("gdelt", CQL)  # builds the pyramid
    hits0 = robustness_metrics().counter("decision.pyramid.brownout_deferred")
    _tick_to(port, 2, sampler)
    assert port._brownout.level == 2
    assert port.count("gdelt", CQL) == n == len(_oracle(cols))
    assert robustness_metrics().counter("decision.pyramid.brownout_deferred") == hits0
    _tick_to(port, 0, sampler)


def test_disabled_ladder_sheds_nothing():
    cols = columns(2000, 7)
    _ref, port = pair(cols=cols)
    brownout.set_enabled(False)
    port._brownout.level = 3
    try:
        assert set(port.query("gdelt", _hint(CQL, "background")).fids) == _oracle(cols)
        assert port.count("gdelt", CQL) == len(_oracle(cols))
        sampler = timeline.TimelineSampler(store=port, interval_s=1.0, window_s=60.0)
        assert "brownout" not in sampler.tick()
    finally:
        port._brownout.level = 0


def test_knobs_equal_the_reference():
    assert brownout.brownout_knobs() == ref_brownout.brownout_knobs()
    with properties(geomesa_brownout_enabled="false"):
        brownout.set_enabled(None)
        assert not brownout.enabled()
    brownout.set_enabled(None)
    assert brownout.enabled()
