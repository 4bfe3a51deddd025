"""The port's overload tier (deequ_tpu_torch/serve/admission.py) on the
CPU: twins of tests/test_admission.py, each held against the reference.

Every test drives the reference's objects (``deequ_tpu.serve.admission``,
``deequ_tpu.exceptions``, ``deequ_tpu.serve.VerificationService``) and the
port's with the same sequence of calls, asserts the reference test's
properties on both, and asserts that the two record the same outcomes:
accept or the same typed refusal with the same reason, queue depth, SLO
class and ``retry_after_s``, the same ladder levels and transitions, the
same pop order. Where an outcome rides a wall clock (a ``retry_after_s``
priced from a served batch's wall, a latency), both sides record only
that it is there. A service's completed metrics are held against the
reference's under tests/torch_parity.py's bounds, and against the port's
own serial run bit for bit.

- The SLO surface: ``Slo`` validation, the ``DEEQU_TORCH_SLO_CLASS`` /
  ``DEEQU_TORCH_SLO_DEADLINE_MS`` defaults beside the reference's
  ``DEEQU_TPU_*`` (typed ``EnvConfigError`` on a malformed value) and the
  structured ``ServiceOverloadedException`` family.
- Admission: accept or a typed refusal with a drain-rate ``retry_after_s``,
  per-class queue budgets (critical's reserved room), the brownout
  ladder's policy by level.
- The brownout ladder: hysteretic up and down, its threshold checks, the
  latency signal.
- The tenant-fair queue: strict class priority, weighted deficit
  round-robin under a flooding tenant, deadline sheds at pop time, depths
  and drain.
- The service: a deadline shed resolved once and typed, a flood that
  cannot starve a victim, the ladder up and back down (after one wide
  batch too), completed results bit for bit their serial runs under
  overload, kill-and-resume carrying the original deadline, the stats and
  per-class counters.

The reference's ``test_chaos_load_fixture_replays_clean`` replays the
chaos engine's load fixtures and waits for the port's chaos engine (its
tooling slice)."""

import contextlib
import dataclasses
import struct
import time

import numpy as np
import pytest
import torch

import deequ_tpu.exceptions as ref_exc
import deequ_tpu.serve.admission as ref_adm
import deequ_tpu_torch.exceptions as port_exc
import deequ_tpu_torch.serve.admission as port_adm
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu_torch import use_device
from deequ_tpu_torch.parallel.mesh import use_mesh
from torch_parity import assert_metric_parity, port_table, ref_column

pytestmark = [pytest.mark.torch_port, pytest.mark.slo]


@pytest.fixture(autouse=True)
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_device("cpu"), use_mesh(None):
        yield
    torch.set_num_threads(threads)


def _bits(v):
    return struct.pack("<d", v) if isinstance(v, float) else v


def _plain(value):
    """A value both packages can compare: an ``Slo`` as its fields."""
    if dataclasses.is_dataclass(value):
        return (type(value).__name__,) + dataclasses.astuple(value)
    return value


#: the structured fields of the overload exception family
_FIELDS = ("reason", "queue_depth", "retry_after_s", "slo_class", "tenant",
           "deadline_ms", "waited_s")


def _refusal(e: BaseException, timed: bool = False):
    """A raised exception as its type's name, its message (the switch
    prefix made one) and its structured fields; ``timed``: a
    ``retry_after_s`` priced from a wall clock, recorded as present."""
    fields = [getattr(e, f, None) for f in _FIELDS]
    if timed:
        fields[2] = fields[2] is not None
    return (type(e).__name__, str(e).replace("DEEQU_TPU_", "DEEQU_TORCH_"), *fields)


def _outcome(fn, timed: bool = False):
    try:
        return ("ok", _plain(fn()))
    except Exception as e:  # noqa: BLE001 — the refusal is the outcome
        return _refusal(e, timed)


def _twin(scenario, ref=ref_adm, port=port_adm):
    """``scenario`` on the reference's module and on the port's: the two
    traces must be equal. Returns the port's."""
    want, got = scenario(ref), scenario(port)
    assert got == want, f"port {got!r}\nreference {want!r}"
    return got


# -- the SLO surface -----------------------------------------------------------


def test_slo_validation_and_resolution():
    def scenario(m):
        explicit = m.Slo(cls="best_effort")
        return [
            _plain(m.Slo()),
            m.Slo(deadline_ms=250.0).deadline_seconds,
            m.Slo(cls="critical").deadline_seconds,
            _outcome(lambda: m.Slo(cls="urgent")),
            _outcome(lambda: m.Slo(deadline_ms=0.0)),
            _outcome(lambda: m.Slo(weight=0.0)),
            _outcome(lambda: m.resolve_slo("critical")),
            m.resolve_slo(explicit) is explicit,
        ]

    got = _twin(scenario)
    assert got[0] == ("Slo", None, 1.0, "standard")
    assert got[1] == 0.25 and got[2] is None
    assert got[3][0] == "ValueError" and "cls" in got[3][1]
    assert got[4][0] == "ValueError" and "deadline_ms" in got[4][1]
    assert got[5][0] == "ValueError" and "weight" in got[5][1]
    assert got[6][0] == "TypeError"
    assert got[7] is True


def test_slo_env_defaults(monkeypatch):
    def setenv(name, value):
        monkeypatch.setenv(f"DEEQU_TPU_{name}", value)
        monkeypatch.setenv(f"DEEQU_TORCH_{name}", value)

    def resolve():
        return _twin(lambda m: _outcome(lambda: m.resolve_slo(None)))

    setenv("SLO_CLASS", "critical")
    setenv("SLO_DEADLINE_MS", "250")
    assert resolve() == ("ok", ("Slo", 250.0, 1.0, "critical"))
    setenv("SLO_DEADLINE_MS", "0")  # 0 disables
    assert resolve() == ("ok", ("Slo", None, 1.0, "critical"))
    setenv("SLO_CLASS", "urgent")
    got = resolve()
    assert got[0] == "EnvConfigError" and "DEEQU_TORCH_SLO_CLASS" in got[1]
    setenv("SLO_CLASS", "standard")
    setenv("SLO_DEADLINE_MS", "banana")
    got = resolve()
    assert got[0] == "EnvConfigError" and "DEEQU_TORCH_SLO_DEADLINE_MS" in got[1]


def test_overload_exception_family_structured():
    def scenario(x):
        base = x.ServiceOverloadedException(
            "full", queue_depth=7, retry_after_s=0.5, slo_class="standard")
        rej = x.AdmissionRejectedException(
            "budget", reason="class_budget", queue_depth=3,
            retry_after_s=0.1, slo_class="best_effort")
        shed = x.DeadlineExceededException(
            "late", tenant="t0", slo_class="best_effort",
            deadline_ms=100.0, waited_s=0.2)
        legacy = x.ServiceOverloadedException("legacy")
        return [
            _refusal(base), _refusal(rej), _refusal(shed), _refusal(legacy),
            isinstance(base, x.ServeException),
            isinstance(rej, x.ServiceOverloadedException),
            isinstance(shed, x.ServiceOverloadedException),
        ]

    got = _twin(scenario, ref_exc, port_exc)
    base, rej, shed, legacy = got[:4]
    assert base[3:6] == (7, 0.5, "standard")
    assert rej[2] == "class_budget"
    assert shed[6] == "t0" and shed[8] == 0.2
    assert legacy[3:6] == (None, None, None)  # every structured field is optional
    assert got[4:] == [True, True, True]


# -- admission controller ----------------------------------------------------


def _admit(m, ctrl, cls="standard", depth=0, class_depth=0, tenant_pending=0,
           tenant="t"):
    return _outcome(lambda: ctrl.admit(
        tenant=tenant, slo=m.Slo(cls=cls), queue_depth=depth,
        class_depth=class_depth, tenant_pending=tenant_pending,
    ))


def test_admission_accept_reject_and_retry_after():
    def scenario(m):
        ctrl = m.AdmissionController(max_pending=10, brownout=None)
        trace = [_admit(m, ctrl, depth=0), _admit(m, ctrl, depth=10)]
        # the drain-rate feed turns refusals into a schedule: 10 served in
        # 1s -> a 19-deep queue drains in ~2s
        ctrl.note_served(10, 1.0)
        trace += [ctrl.retry_after(19), ctrl.retry_after(10 ** 9)]
        ctrl.note_served(30, 1.0, cost=600.0)
        trace += [ctrl.retry_after(19), ctrl.retry_after(19, queued_cost=900.0),
                  ctrl.cost_fraction(900.0), ctrl.retry_after(10), _admit(m, ctrl, depth=10)]
        return trace

    got = _twin(scenario)
    assert got[0] == ("ok", 0)  # accepted, no brownout
    refused = got[1]
    assert refused[0] == "ServiceOverloadedException"
    assert refused[3] == 10 and refused[4] > 0 and refused[5] == "standard"
    assert 1.0 < got[2] < 4.0
    assert got[3] == 30.0  # bounded
    assert got[5] < got[2]  # a faster drain schedules an earlier retry
    assert got[5] == 900.0 / 600.0  # the queued cost over the cost rate
    assert got[8][4] == got[7]  # a refusal carries the depth schedule


def test_admission_class_queue_budgets_reserve_critical_headroom():
    def scenario(m):
        ctrl = m.AdmissionController(max_pending=10, brownout=None)
        return [
            # best_effort owns half the queue: refused at class_depth 5
            # even though the queue itself has room
            _admit(m, ctrl, cls="best_effort", depth=5, class_depth=5),
            _admit(m, ctrl, cls="standard", depth=7, class_depth=7),
            _admit(m, ctrl, cls="standard", depth=8, class_depth=8),
            # critical may use the whole queue
            _admit(m, ctrl, cls="critical", depth=9, class_depth=9),
            dict(m.CLASS_QUEUE_SHARE),
            _outcome(lambda: m.AdmissionController(max_pending=10,
                                                   class_share={"vip": 0.5})),
            _outcome(lambda: m.AdmissionController(max_pending=10,
                                                   class_share={"standard": 0.0})),
            _outcome(lambda: m.AdmissionController(max_pending=0)),
        ]

    got = _twin(scenario)
    assert got[0][0] == "AdmissionRejectedException" and got[0][2] == "class_budget"
    assert got[3] == ("ok", 0)
    assert got[4]["critical"] == 1.0
    assert [g[0] for g in got[5:]] == ["ValueError"] * 3


def test_admission_brownout_policy_by_level():
    # capacity 10: depth 5 -> level 1, 8 -> level 2, 9 -> level 3
    def scenario(m):
        ctrl = m.AdmissionController(
            max_pending=10, brownout=m.BrownoutController(capacity=10),
            inflight_cap=2,
        )
        return [
            # level 1: best_effort admissions shed, standard still admitted
            _admit(m, ctrl, cls="best_effort", depth=5, class_depth=1),
            _admit(m, ctrl, cls="standard", depth=5, class_depth=1),
            # level 2: per-tenant inflight cap on top
            _admit(m, ctrl, cls="standard", depth=8, class_depth=1, tenant_pending=2),
            _admit(m, ctrl, cls="standard", depth=8, class_depth=1, tenant_pending=1),
            # level 3: critical only
            _admit(m, ctrl, cls="standard", depth=9, class_depth=1),
            _admit(m, ctrl, cls="critical", depth=9, class_depth=1),
            ctrl.brownout.level, ctrl.brownout.transitions,
        ]

    got = _twin(scenario)
    assert got[0][2] == "brownout_best_effort"
    assert got[1] == ("ok", 1)
    assert got[2][2] == "tenant_inflight_cap"
    assert got[3] == ("ok", 2)
    assert got[4][2] == "brownout_critical_only"
    assert got[5] == ("ok", 3)


# -- brownout ladder ---------------------------------------------------------


def test_brownout_transitions_up_and_down_hysteretic():
    def scenario(m):
        b = m.BrownoutController(capacity=100)
        levels = [b.update(d) for d in (10, 95, 95, 65, 65, 45, 20, 0)]
        # the cost pressure alone raises the ladder
        levels += [b.update(0, cost_frac=0.8), b.update(0, cost_frac=0.1)]
        off = m.BrownoutController(capacity=100, enabled=False)
        return levels, b.transitions, off.update(100)

    levels, transitions, off = _twin(scenario)
    # ascent jumps straight to the highest threshold crossed; descent is
    # one level per update, and only below the DOWN bar
    assert levels[:7] == [0, 3, 3, 2, 2, 1, 0]
    assert levels[8:] == [2, 1]
    assert transitions == 6
    assert off == 0  # a disabled ladder never leaves 0


def test_brownout_threshold_validation_and_latency_signal():
    def scenario(m):
        trace = [
            _outcome(lambda: m.BrownoutController(capacity=10, up=(0.5, 0.7, 0.9),
                                                  down=(0.5, 0.5, 0.7))),
            _outcome(lambda: m.BrownoutController(capacity=10, up=(0.9, 0.7, 0.5),
                                                  down=(0.2, 0.3, 0.4))),
            _outcome(lambda: m.BrownoutController(capacity=0)),
        ]
        # a slow backend is overload too: hot p95 holds level >= 1 with a
        # shallow queue
        b = m.BrownoutController(capacity=100, latency_high=0.1)
        for _ in range(20):
            b.observe_latency(0.5)
        trace += [b.recent_latency_p95(), b.update(0), b.update(0)]
        b._lat.clear()
        for _ in range(20):
            b.observe_latency(0.001)
        trace += [b.recent_latency_p95(), b.update(0)]
        return trace

    got = _twin(scenario)
    assert "hysteresis" in got[0][1]
    assert "ascend" in got[1][1]
    assert got[2][0] == "ValueError"
    assert got[3:6] == [0.5, 1, 1]  # latency still hot: no descent
    assert got[6:] == [0.001, 0]


# -- the deadline-aware tenant-fair queue ------------------------------------


class _Req:
    def __init__(self, m, tenant, cls="standard", weight=1.0, deadline_at=None):
        self.tenant = tenant
        self.slo = m.Slo(cls=cls, weight=weight)
        self.deadline_at = deadline_at


def _pops(q, k, now=0.0, shed=None):
    out = []
    for _ in range(k):
        req = q.pop(now, shed if shed is not None else (lambda r: None))
        out.append(None if req is None else req.tenant)
    return out


def test_queue_strict_class_priority():
    def scenario(m):
        q = m.TenantFairQueue()
        q.push(_Req(m, "flood", cls="best_effort"))
        q.push(_Req(m, "s", cls="standard"))
        q.push(_Req(m, "c", cls="critical"))
        q.push(_Req(m, "c2", cls="critical"))
        return _pops(q, 5)

    assert _twin(scenario) == ["c", "c2", "s", "flood", None]


def test_queue_wdrr_fairness_under_flood_tenant():
    def scenario(m):
        q = m.TenantFairQueue()
        for _ in range(50):
            q.push(_Req(m, "flood"))
        q.push(_Req(m, "victim-a"))
        q.push(_Req(m, "victim-b", weight=2.0))
        first = _pops(q, 6)
        q = m.TenantFairQueue()
        for _ in range(40):
            q.push(_Req(m, "flood"))
            q.push(_Req(m, "heavy", weight=2.0))
        return first, _pops(q, 30)

    first, window = _twin(scenario)
    # one rotation grants every tenant a slot: both victims dispatch
    # within the first handful of pops instead of behind 50 floods
    assert "victim-a" in first and "victim-b" in first
    # weights scale the share inside a class: a weight-2 tenant drains
    # 2x the slots of a weight-1 tenant under the same contention
    assert window.count("heavy") >= 2 * window.count("flood") - 2


def test_queue_pop_time_deadline_shed():
    def scenario(m):
        q = m.TenantFairQueue()
        q.push(_Req(m, "late", deadline_at=10.0))
        q.push(_Req(m, "late", deadline_at=11.0))
        q.push(_Req(m, "alive", deadline_at=99.0))
        q.push(_Req(m, "later", deadline_at=60.0))
        shed = []
        got = _pops(q, 1, now=50.0, shed=shed.append)
        return got, [r.tenant for r in shed], len(q), q.class_depth("standard")

    got, shed, left, depth = _twin(scenario)
    assert got == ["alive"]
    assert shed == ["late", "late"]
    assert (left, depth) == (1, 1)


def test_queue_depths_and_drain():
    def scenario(m):
        q = m.TenantFairQueue()
        q.push(_Req(m, "a", cls="critical"))
        q.push(_Req(m, "a"))
        q.push(_Req(m, "b", cls="best_effort"))
        before = (len(q), q.tenant_depth("a"), q.class_depth("critical"), q.depths())
        drained = [r.tenant for r in q.drain()]
        return before, drained, len(q), q.depths()

    (n, a_depth, critical, depths), drained, left, after = _twin(scenario)
    assert (n, a_depth, critical) == (3, 2, 1)
    assert depths["best_effort"] == {"b": 1}
    assert drained == ["a", "a", "b"]
    assert left == 0 and after == {"critical": {}, "standard": {}, "best_effort": {}}


# -- service-level integration -----------------------------------------------


class _Side:
    """One package's serving surface: its service, SLO, exceptions,
    registry and stats, its analyzers, and its tables from a seed."""

    def __init__(self, name):
        self.name = name
        if name == "ref":
            import deequ_tpu.analyzers as an
            from deequ_tpu import VerificationSuite
            from deequ_tpu.obs import registry
            from deequ_tpu.ops.scan_engine import SCAN_STATS
            from deequ_tpu.parallel.mesh import use_mesh as ref_use_mesh
            from deequ_tpu.serve import VerificationService

            self.adm, self.exc = ref_adm, ref_exc
            self.scope = lambda: ref_use_mesh(None)
        else:
            import deequ_tpu_torch.analyzers as an
            from deequ_tpu_torch import VerificationSuite
            from deequ_tpu_torch.obs import registry
            from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
            from deequ_tpu_torch.serve import VerificationService

            self.adm, self.exc = port_adm, port_exc
            self.scope = contextlib.nullcontext
        self.an, self.suite, self.registry = an, VerificationSuite, registry
        self.stats, self.Service = SCAN_STATS, VerificationService

    def table(self, n=64, seed=0):
        r = np.random.default_rng(seed)
        ref = RefTable([
            ref_column("x", "fractional", r.normal(100, 5, n), r.random(n) > 0.05),
            ref_column("i", "integral", r.integers(0, 50, n).astype(np.float64),
                       np.ones(n, bool)),
        ])
        return ref if self.name == "ref" else port_table(ref)

    def analyzers(self):
        return [self.an.Size(), self.an.Completeness("x"), self.an.Mean("x"),
                self.an.Sum("i")]

    def Slo(self, **kw):
        return self.adm.Slo(**kw)


def _service_twin(scenario):
    """``scenario(side)`` on the reference's service (one device,
    ``use_mesh(None)``) and on the port's (the CPU): it returns
    (observed, metrics); the observed traces must be equal, and each
    completed suite's metrics, in the analyzers' order, within
    tests/torch_parity.py's bounds. Returns the port's observed trace."""
    out = {}
    for name in ("ref", "port"):
        side = _Side(name)
        with side.scope():
            out[name] = scenario(side)
    (want, ref_metrics), (got, port_metrics) = out["ref"], out["port"]
    assert got == want, f"port {got!r}\nreference {want!r}"
    assert len(port_metrics) == len(ref_metrics)
    for ref_list, port_list in zip(ref_metrics, port_metrics):
        assert len(port_list) == len(ref_list)
        for ref_metric, port_metric in zip(ref_list, port_list):
            assert_metric_parity(ref_metric, port_metric)
    return got


def _metrics(side, result):
    return [result.metrics[a] for a in side.analyzers()]


def test_service_deadline_shed_exactly_once_typed():
    def scenario(side):
        shed_counter = side.registry.SERVE_SHED_BY_CLASS["best_effort"]
        before = shed_counter.value
        svc = side.Service(start=False, coalesce_window=0.0)
        try:
            doomed = svc.submit(
                side.table(seed=1), required_analyzers=side.analyzers(), tenant="late",
                slo=side.Slo(deadline_ms=10.0, cls="best_effort"),
            )
            ok = svc.submit(
                side.table(seed=2), required_analyzers=side.analyzers(), tenant="ok",
            )
            time.sleep(0.05)  # the queued deadline expires before start()
            svc.start()
            with pytest.raises(side.exc.DeadlineExceededException) as e:
                doomed.result(timeout=60)
            assert e.value.waited_s > 0
            shed = _refusal(e.value, timed=True)
            shed = shed[:1] + shed[2:-1]  # the message and the wait are timed
            # the shed is not a tenant failure: the healthy submission
            # completes and the tenant is not quarantined
            result = ok.result(timeout=60)
            observed = (
                shed, doomed.resolve_count, shed_counter.value - before,
                any(d.get("kind") == "deadline_shed" for d in side.stats.degradation_events),
                all(m.value.is_success for m in result.metrics.values()),
                svc.tenant_health.is_quarantined("late"),
            )
        finally:
            svc.stop(drain=False)
        return observed, [_metrics(side, result)]

    shed, resolved, counted, event, ok, quarantined = _service_twin(scenario)
    assert shed[0] == "DeadlineExceededException"
    assert shed[3] is True  # a retry_after_s is there
    assert shed[4:6] == ("best_effort", "late")
    assert (resolved, counted, event, ok, quarantined) == (1, 1, True, True, False)


def test_service_flood_tenant_cannot_starve_victim():
    def scenario(side):
        svc = side.Service(start=False, max_batch=4, coalesce_window=0.0)
        try:
            flood = [
                svc.submit(side.table(seed=3), required_analyzers=side.analyzers(),
                           tenant="flood")
                for _ in range(16)
            ]
            victim = svc.submit(
                side.table(seed=4), required_analyzers=side.analyzers(), tenant="victim",
            )
            svc.start()
            results = [f.result(timeout=60) for f in flood + [victim]]
            # WDRR: the victim rides an early batch, not behind the flood
            slowest = sorted(f.resolved_at for f in flood)
            assert victim.resolved_at < slowest[-2]
            rank = sorted(f.resolved_at for f in flood + [victim]).index(victim.resolved_at)
        finally:
            svc.stop(drain=False)
        return rank, [_metrics(side, r) for r in results]

    # the victim rides the first batch of 4 (the queue's first rotation)
    assert _service_twin(scenario) < 4


def test_service_brownout_ladder_up_then_down():
    def scenario(side):
        svc = side.Service(start=False, max_pending=10, max_batch=4, coalesce_window=0.0)
        try:
            futures = [
                svc.submit(side.table(seed=5), required_analyzers=side.analyzers(),
                           tenant=f"t{i}")
                for i in range(6)
            ]
            # depth crossed 0.5x capacity at the last admit: level >= 1,
            # and best_effort admissions shed typed
            raised = svc._brownout.level
            with pytest.raises(side.exc.AdmissionRejectedException) as e:
                svc.submit(side.table(seed=6), required_analyzers=side.analyzers(),
                           tenant="be", slo=side.Slo(cls="best_effort"))
            refused = _refusal(e.value)
            svc.start()
            results = [f.result(timeout=60) for f in futures]
            svc.flush(timeout=60)
            # the drain-side ladder steps back down as the queue empties
            lowered = svc._brownout.level
            ok = svc.submit(side.table(seed=7), required_analyzers=side.analyzers(),
                            tenant="be", slo=side.Slo(cls="best_effort"))
            results.append(ok.result(timeout=60))
            assert svc._brownout.transitions >= 2
        finally:
            svc.stop(drain=False)
        return (raised, refused, lowered), [_metrics(side, r) for r in results]

    raised, refused, lowered = _service_twin(scenario)
    assert raised >= 1 and lowered == 0
    assert refused[0] == "AdmissionRejectedException"
    assert refused[2] == "brownout_best_effort" and refused[4] is not None


def test_service_brownout_descends_after_one_batch_drain():
    """A backlog drained in ONE wide batch must not park the service at
    a high brownout level: idle worker ticks walk the ladder back down,
    so a quiet service never refuses best_effort against an empty
    queue."""
    def scenario(side):
        svc = side.Service(start=False, max_pending=10, max_batch=32, coalesce_window=0.0)
        try:
            futures = [
                svc.submit(
                    side.table(seed=20), required_analyzers=side.analyzers(),
                    tenant=f"t{i}",
                    # critical: may fill the whole queue (class share 1.0)
                    slo=side.Slo(cls="critical"),
                )
                for i in range(9)  # depth 8 at the last admit: level 2
            ]
            raised = svc._brownout.level
            svc.start()
            results = [f.result(timeout=60) for f in futures]
            svc.flush(timeout=60)
            deadline = time.monotonic() + 5.0
            while svc._brownout.level and time.monotonic() < deadline:
                time.sleep(0.05)
            lowered = svc._brownout.level
            ok = svc.submit(side.table(seed=21), required_analyzers=side.analyzers(),
                            tenant="be", slo=side.Slo(cls="best_effort"))
            results.append(ok.result(timeout=60))
        finally:
            svc.stop(drain=False)
        return (raised, lowered), [_metrics(side, r) for r in results]

    raised, lowered = _service_twin(scenario)
    assert raised >= 2 and lowered == 0


def test_completed_results_bit_identical_under_overload():
    def scenario(side):
        table = side.table(n=128, seed=8)
        serial = side.suite.run(table, [], required_analyzers=side.analyzers())
        svc = side.Service(start=False, max_batch=8, coalesce_window=0.0)
        try:
            doomed = [
                svc.submit(table, required_analyzers=side.analyzers(), tenant="late",
                           slo=side.Slo(deadline_ms=5.0, cls="best_effort"))
                for _ in range(4)
            ]
            alive = [
                svc.submit(table, required_analyzers=side.analyzers(), tenant=f"t{i}",
                           slo=side.Slo(cls="critical" if i % 2 else "standard"))
                for i in range(6)
            ]
            time.sleep(0.05)
            svc.start()
            shed = 0
            for f in doomed:
                try:
                    f.result(timeout=60)
                except side.exc.DeadlineExceededException:
                    shed += 1
            results = [f.result(timeout=60) for f in alive]
            for result in results:
                for a, m1 in serial.metrics.items():
                    m2 = result.metrics[a]
                    assert m1.value.is_success and m2.value.is_success
                    assert _bits(m1.value.get()) == _bits(m2.value.get()), (
                        "overload must never degrade computation: "
                        f"{a} {m2.value.get()!r} != serial {m1.value.get()!r}"
                    )
        finally:
            svc.stop(drain=False)
        return shed, [_metrics(side, r) for r in [serial] + results]

    assert _service_twin(scenario) == 4


def test_kill_and_resume_preserves_original_deadline():
    def scenario(side):
        donor = side.Service(start=False)
        try:
            future = donor.submit(
                side.table(seed=9), required_analyzers=side.analyzers(), tenant="move",
                slo=side.Slo(deadline_ms=40.0, cls="standard"),
            )
            pending = donor.stop(drain=False)
            req_deadline = pending[0].deadline_at
            # queue wait accrues ACROSS the recycle: by adoption time the
            # original absolute deadline has passed, so the adopting
            # service sheds instead of serving stale
            time.sleep(0.06)
            adopter = side.Service(start=True, coalesce_window=0.0)
            try:
                adopter.resume(pending)
                kept = pending[0].deadline_at == req_deadline
                with pytest.raises(side.exc.DeadlineExceededException) as e:
                    future.result(timeout=60)
                observed = (len(pending), req_deadline is not None, kept,
                            type(e.value).__name__, future.resolve_count)
            finally:
                adopter.stop(drain=False)
        finally:
            donor.stop(drain=False)
        return observed, []

    assert _service_twin(scenario) == (1, True, True, "DeadlineExceededException", 1)


def test_stats_and_admission_counters():
    def scenario(side):
        admitted = side.registry.SERVE_ADMITTED_BY_CLASS["critical"]
        before = admitted.value
        svc = side.Service(start=False)
        try:
            svc.submit(side.table(seed=10), required_analyzers=side.analyzers(),
                       tenant="a", slo=side.Slo(cls="critical"))
            stats = svc.stats()
            section = side.registry.REGISTRY.snapshot()["serve"]
            observed = (
                admitted.value - before, stats["pending"], stats["pending_by_class"],
                stats["brownout_level"], sorted(stats),
                section["admitted_by_class"]["critical"] >= before + 1,
                sorted(section["shed_by_class"]), "brownout_level" in section,
            )
        finally:
            svc.stop(drain=False)
        return observed, []

    got = _service_twin(scenario)
    assert got[0] == 1 and got[1] == 1
    assert got[2]["critical"] == 1
    assert got[3] == 0
    assert got[5] is True
    assert got[6] == sorted(port_adm.SLO_CLASSES)
    assert got[7] is True
