"""The port's serving fleet (deequ_tpu_torch/serve: fleet.py, router.py,
membership.py) on the CPU: twins of every test of tests/test_fleet.py,
each held against the reference, and the port's own contracts.

Every twin runs one scenario on the reference's objects (``deequ_tpu``,
its fleets on the reference's devices) and on the port's (on the CPU,
``use_device("cpu")``), asserts the reference test's properties on both,
and asserts that both record the same outcomes: the same placement, the
same victims and re-dispatch counts, the same typed refusals, the same
fleet sections. Each side's fleet results are bit for bit its own serial
runs; across the two sides the metrics agree within
tests/torch_parity.py's bounds.

- Placement: consistent-hash routing is deterministic and spread, a leave
  moves only the lost worker's keys, a rejoin restores the placement, the
  ring walk orders every worker from the placed one; the digest keys on
  schema, analyzers and rows and is the same in both packages.
- Membership: ``check_workers`` fails typed or degrades, an
  unattributable probe timeout is typed with every worker suspect, the
  monitor fires once a newly lost worker.
- Failover: a scripted death mid-load re-dispatches exactly the dead
  worker's requests, every result bit for bit its serial run, every future
  resolved once; budgets follow the request (``worker_failover``); retries
  run out typed; an expired victim is shed typed; the monitor detects a
  stall; admission refusals spill to the ring's successor.
- One quarantine, warm rejoin, the registry's ``fleet`` section, the
  context manager, concurrent submitters, the ``DEEQU_TORCH_FLEET_*``
  switches, the futures' first-resolution gate.
- The port's own: a fleet without a card and without a CPU request raises
  typed; ``WorkerLostException`` is no fault the ladder retries or the
  service bisects; four threads running coalesced batches of one shared
  plan at once stay bit for bit their serial runs with exact counts (and
  the LUT memo builds once under racing threads); the new modules import
  neither jax nor the reference.
"""

import functools
import itertools
import struct
import threading
import time

import numpy as np
import pytest
import torch

from deequ_tpu_torch import use_device
from deequ_tpu_torch.parallel.mesh import use_mesh as port_use_mesh
from deequ_tpu_torch.resilience.governance import fault_state_scope

pytestmark = [pytest.mark.torch_port, pytest.mark.fleet]

# The reference (and with it jax) is imported only inside the twins, so the
# card-marked test below collects where jax is not installed.


@pytest.fixture(autouse=True)
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_device("cpu"), port_use_mesh(None), fault_state_scope():
        yield
    torch.set_num_threads(threads)


# -- the two sides ----------------------------------------------------------------


def _arrays(n, seed):
    r = np.random.default_rng(seed)
    return (r.normal(100, 5, n), r.random(n) > 0.05,
            r.integers(0, 50, n).astype(np.float64), np.ones(n, bool))


def _ref_table(n=64, seed=0):
    from deequ_tpu.data.table import ColumnarTable as RefTable
    from torch_parity import ref_column

    x, x_mask, i, i_mask = _arrays(n, seed)
    return RefTable([ref_column("x", "fractional", x, x_mask),
                     ref_column("i", "integral", i, i_mask)])


def _port_table(n=64, seed=0):
    """The port's twin of :func:`_ref_table`: the same arrays."""
    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    x, x_mask, i, i_mask = _arrays(n, seed)
    return ColumnarTable([Column("x", DType.FRACTIONAL, values=x, mask=x_mask),
                          Column("i", DType.INTEGRAL, values=i, mask=i_mask)])


class _Side:
    """One package's surface, by the names both share."""

    def __init__(self, name: str):
        self.name = name
        if name == "ref":
            import deequ_tpu.analyzers as an
            import deequ_tpu.envcfg as envcfg
            import deequ_tpu.exceptions as exc
            import deequ_tpu.serve as serve
            import deequ_tpu.serve.service as service
            from deequ_tpu import VerificationSuite
            from deequ_tpu.obs.registry import REGISTRY
            from deequ_tpu.ops.scan_engine import SCAN_STATS
            from deequ_tpu.parallel.mesh import use_mesh
            from deequ_tpu.resilience.governance import RunPolicy

            self.prefix = "DEEQU_TPU_"
        else:
            import deequ_tpu_torch.analyzers as an
            import deequ_tpu_torch.envcfg as envcfg
            import deequ_tpu_torch.exceptions as exc
            import deequ_tpu_torch.serve as serve
            import deequ_tpu_torch.serve.service as service
            from deequ_tpu_torch import VerificationSuite
            from deequ_tpu_torch.obs.registry import REGISTRY
            from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
            from deequ_tpu_torch.parallel.mesh import use_mesh
            from deequ_tpu_torch.resilience.governance import RunPolicy

            self.prefix = "DEEQU_TORCH_"
        self.an, self.envcfg, self.exc, self.serve, self.service = an, envcfg, exc, serve, service
        self.VerificationSuite, self.REGISTRY, self.SCAN_STATS = VerificationSuite, REGISTRY, SCAN_STATS
        self.use_mesh, self.RunPolicy = use_mesh, RunPolicy

    def table(self, n=64, seed=0):
        return _ref_table(n, seed) if self.name == "ref" else _port_table(n, seed)

    def analyzers(self):
        return [self.an.Size(), self.an.Completeness("x"), self.an.Mean("x"), self.an.Sum("i")]

    def tenant_tables(self, k=8, base=48):
        """Distinct row counts: distinct digests (and plans), so tenants
        spread over the ring."""
        return {f"t{i}": self.table(n=base + 16 * i, seed=200 + i) for i in range(k)}

    def serial(self, tables):
        with self.use_mesh(None):
            return {t: self.VerificationSuite.run(tbl, [], required_analyzers=self.analyzers())
                    for t, tbl in tables.items()}

    def fleet(self, **kw):
        kw.setdefault("n_workers", 4)
        kw.setdefault("monitor", False)
        kw.setdefault("distinct_devices", False)
        kw.setdefault("worker_knobs", {"coalesce_window": 0.0})
        return self.serve.VerificationFleet(**kw)

    def route(self, fleet, tables):
        return {t: fleet.route(tbl, required_analyzers=self.analyzers())
                for t, tbl in tables.items()}


@functools.lru_cache(maxsize=None)
def _side(name: str) -> _Side:
    return _Side(name)


def _bits(value):
    return struct.pack("<d", value) if isinstance(value, float) else value


def _assert_bit_identical(serial_result, served_result, label=""):
    assert serial_result.status == served_result.status, label
    for a, m1 in serial_result.metrics.items():
        m2 = served_result.metrics[a]
        assert m1.value.is_success == m2.value.is_success, (label, str(a))
        if m1.value.is_success:
            assert _bits(m1.value.get()) == _bits(m2.value.get()), (
                f"{label}: {a} serial={m1.value.get()!r} fleet={m2.value.get()!r}")


def _status(result) -> str:
    return str(result.status).split(".")[-1]


def _twin(scenario):
    """``scenario(side)`` on the reference and on the port. It returns
    (record, results): the records must be equal, and the results
    ({label: VerificationResult}) agree metric by metric within the parity
    bounds. Returns the port's record."""
    from torch_parity import assert_metric_parity

    want, ref_results = scenario(_side("ref"))
    got, port_results = scenario(_side("port"))
    assert got == want, f"port {got!r}\nreference {want!r}"
    assert set(port_results) == set(ref_results)
    for label, ref_res in ref_results.items():
        port_res = port_results[label]
        assert _status(ref_res) == _status(port_res), label
        ref_metrics = sorted(ref_res.metrics.items(), key=lambda kv: repr(kv[0]))
        port_metrics = sorted(port_res.metrics.items(), key=lambda kv: repr(kv[0]))
        assert [repr(a) for a, _ in ref_metrics] == [repr(a) for a, _ in port_metrics], label
        for (_, m1), (_, m2) in zip(ref_metrics, port_metrics):
            assert_metric_parity(m1, m2)
    return got


def _outcome(fn):
    """("ok", value) or the raised exception's type name."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the typed refusal is the outcome
        return (type(e).__name__,)


# -- router ------------------------------------------------------------------------


def test_router_deterministic_and_spread():
    def scenario(s):
        digests = [s.serve.route_digest(s.table(n=32 + 8 * i, seed=i), s.analyzers())
                   for i in range(24)]
        r1, r2 = s.serve.ConsistentHashRouter(), s.serve.ConsistentHashRouter()
        for w in range(4):
            r1.add_worker(w)
            r2.add_worker(w)
        placed = [r1.place(d) for d in digests]
        assert placed == [r2.place(d) for d in digests]
        assert len(set(placed)) >= 3
        assert len(r1) == 4
        assert s.serve.ConsistentHashRouter().place(digests[0]) is None
        with pytest.raises(ValueError):
            s.serve.ConsistentHashRouter(vnodes=0)
        return (digests, placed), {}

    _twin(scenario)


def test_router_leave_moves_only_the_lost_workers_keys():
    def scenario(s):
        digests = [s.serve.route_digest(s.table(n=32 + 8 * i, seed=i), s.analyzers())
                   for i in range(48)]
        router = s.serve.ConsistentHashRouter()
        for w in range(4):
            router.add_worker(w)
        before = {d: router.place(d) for d in digests}
        victim = before[digests[0]]
        router.remove_worker(victim)
        after = {d: router.place(d) for d in digests}
        for d in digests:
            if before[d] == victim:
                assert after[d] != victim
            else:
                assert after[d] == before[d]
        router.add_worker(victim)
        assert {d: router.place(d) for d in digests} == before
        return (victim, sorted(after.items())), {}

    _twin(scenario)


def test_route_digest_keys_on_schema_analyzers_rows():
    def scenario(s):
        t = s.table(n=64, seed=1)
        d0 = s.serve.route_digest(t, s.analyzers())
        assert d0 == s.serve.route_digest(s.table(n=64, seed=99), s.analyzers())
        assert d0 != s.serve.route_digest(s.table(n=65, seed=1), s.analyzers())
        assert d0 != s.serve.route_digest(t, s.analyzers()[:-1])
        assert s.serve.route_digest(object(), s.analyzers()) == s.serve.route_digest(
            object(), s.analyzers())
        return (d0, s.serve.route_digest(object(), s.analyzers())), {}

    # the same submission has the same digest in both packages
    _twin(scenario)


def test_router_walk_orders_every_worker_from_placement():
    def scenario(s):
        router = s.serve.ConsistentHashRouter()
        for w in range(4):
            router.add_worker(w)
        digest = s.serve.route_digest(s.table(seed=32), s.analyzers())
        walk = router.walk(digest)
        assert walk[0] == router.place(digest)
        assert sorted(walk) == [0, 1, 2, 3]
        assert walk == router.walk(digest)
        router.remove_worker(walk[0])
        assert router.walk(digest)[0] == walk[1]
        assert s.serve.ConsistentHashRouter().walk(digest) == []
        return walk, {}

    _twin(scenario)


# -- membership --------------------------------------------------------------------


def _membership(s, hb, on_loss=lambda wid, exc: None, **kw):
    return s.serve.FleetMembership(members=lambda: sorted(hb), probe_of=lambda wid: hb[wid],
                                   on_loss=on_loss, **kw)


def test_check_workers_fail_and_degrade_modes():
    def scenario(s):
        now = time.monotonic()
        hb = {0: (True, now), 1: (True, now - 99.0), 2: (False, now)}
        membership = _membership(s, hb, interval=0.05, stall_timeout=1.0)
        with pytest.raises(s.exc.WorkerLostException) as ei:
            membership.check_workers(on_worker_loss="fail")
        assert ei.value.worker_ids == (1, 2)
        report = membership.check_workers(on_worker_loss="degrade")
        assert report.degraded and report.lost == [1, 2]
        assert report.surviving == [0]
        with pytest.raises(ValueError):
            membership.check_workers(on_worker_loss="ignore")
        return (ei.value.worker_ids, report.lost, report.surviving, report.n_workers), {}

    _twin(scenario)


def test_check_workers_unattributable_timeout_is_typed_all_suspect():
    def scenario(s):
        hb = {0: (True, time.monotonic()), 1: (True, time.monotonic())}
        membership = _membership(s, hb, interval=0.05, stall_timeout=0.5)

        def wedged_probe(timeout):
            raise TimeoutError("probe never returned")

        with pytest.raises(s.exc.WorkerLostException) as ei:
            membership.check_workers(probe=wedged_probe)
        assert ei.value.worker_ids == (0, 1)
        return ei.value.worker_ids, {}

    _twin(scenario)


def test_monitor_fires_on_loss_once_per_lost_worker():
    def scenario(s):
        now = time.monotonic()
        hb = {0: (True, now), 1: (True, now), 2: (True, now)}
        lost: list = []
        membership = _membership(s, hb, on_loss=lambda wid, exc: lost.append((wid, exc)),
                                 interval=0.02, stall_timeout=0.2)
        report = membership.poll()
        assert not report.degraded and lost == []
        hb[1] = (True, now - 10.0)
        report = membership.poll()
        assert report.lost == [1]
        assert [wid for wid, _ in lost] == [1]
        assert all(isinstance(e, s.exc.WorkerLostException) for _, e in lost)
        del hb[1]
        membership.poll()
        assert len(lost) == 1
        return [(wid, e.worker_ids) for wid, e in lost], {}

    _twin(scenario)


# -- the switches ------------------------------------------------------------------


def test_fleet_env_knobs_registry(monkeypatch):
    def scenario(s):
        from deequ_tpu_torch.exceptions import EnvConfigError as PortEnvError

        from deequ_tpu.exceptions import EnvConfigError as RefEnvError

        env_error = RefEnvError if s.name == "ref" else PortEnvError
        p = s.prefix
        FleetConfig = s.serve.FleetConfig
        monkeypatch.setenv(f"{p}FLEET_WORKERS", "2")
        monkeypatch.setenv(f"{p}HEARTBEAT_INTERVAL", "0.5")
        monkeypatch.setenv(f"{p}FAILOVER_RETRIES", "7")
        monkeypatch.setenv(f"{p}FLEET_LEDGER_DIR", "/nonexistent/ledger")
        cfg = FleetConfig(ledger_dir="")
        record = [cfg.n_workers, cfg.heartbeat_interval, cfg.failover_retries,
                  cfg.stall_timeout, FleetConfig().ledger_dir]
        assert record[:4] == [2, 0.5, 7, 4.0]
        monkeypatch.delenv(f"{p}FLEET_LEDGER_DIR")
        snap = s.envcfg.registry_snapshot()
        for name in ("FLEET_WORKERS", "HEARTBEAT_INTERVAL", "FAILOVER_RETRIES",
                     "FLEET_LEDGER_DIR"):
            assert p + name in snap, name
        monkeypatch.setenv(f"{p}HEARTBEAT_INTERVAL", "fast")
        with pytest.raises(env_error, match="HEARTBEAT_INTERVAL"):
            FleetConfig()
        monkeypatch.delenv(f"{p}HEARTBEAT_INTERVAL")
        monkeypatch.setenv(f"{p}FAILOVER_RETRIES", "-1")
        with pytest.raises(env_error, match="FAILOVER_RETRIES"):
            FleetConfig()
        monkeypatch.setenv(f"{p}FAILOVER_RETRIES", "2")
        monkeypatch.setenv(f"{p}FLEET_WORKERS", "0")
        with pytest.raises(env_error, match="FLEET_WORKERS"):
            s.envcfg.env_value(f"{p}FLEET_WORKERS")
        monkeypatch.delenv(f"{p}FLEET_WORKERS")
        monkeypatch.delenv(f"{p}FAILOVER_RETRIES")
        return record, {}

    _twin(scenario)


# -- the futures' first-resolution gate ----------------------------------------------


def test_future_first_resolution_wins():
    def scenario(s):
        fut = s.service.VerificationFuture(tenant="t")
        assert fut._claim()
        fut._resolve("first")
        fut._resolve("second")
        fut._reject(RuntimeError("x"))
        assert fut.result() == "first"
        assert fut.resolve_count == 1
        assert fut.late_resolutions == 2
        assert fut._claim() is False
        return (fut.result(), fut.resolve_count, fut.late_resolutions), {}

    _twin(scenario)


def test_future_reject_then_resolve_keeps_first():
    def scenario(s):
        fut = s.service.VerificationFuture(tenant="t")
        fut._reject(s.exc.WorkerLostException("gone", worker_ids=(3,)))
        fut._resolve("late success")
        with pytest.raises(s.exc.WorkerLostException):
            fut.result()
        assert fut.resolve_count == 1 and fut.late_resolutions == 1
        return (fut.resolve_count, fut.late_resolutions), {}

    _twin(scenario)


# -- quarantine across kill-and-resume -------------------------------------------------


def test_quarantine_state_survives_kill_and_resume():
    def scenario(s):
        with s.use_mesh(None):
            first = s.serve.VerificationService(start=False, quarantine_after=2)
            for _ in range(2):
                first.tenant_health.record_failure("poison")
            assert first.tenant_health.is_quarantined("poison")
            first.start()
            pending = first.stop(drain=False)
            assert pending.tenant_health is not None
            assert "poison" in pending.tenant_health["quarantined"]
            second = s.serve.VerificationService(start=False, quarantine_after=2)
            assert not second.tenant_health.is_quarantined("poison")
            second.resume(pending)
            assert second.tenant_health.is_quarantined("poison")
            failures = second.tenant_health.failures["poison"]
            assert failures == 2
            second.tenant_health.record_success("poison")
            assert not second.tenant_health.is_quarantined("poison")
            second.stop(drain=False)
        return failures, {}

    _twin(scenario)


def test_tenant_health_restore_is_conservative_union():
    def scenario(s):
        ours = s.service._TenantHealth(3)
        ours.failures["a"] = 2
        ours.quarantined.add("q1")
        ours.restore({"failures": {"a": 1, "b": 2}, "quarantined": {"q2"}})
        assert ours.failures == {"a": 2, "b": 2}
        assert ours.quarantined == {"q1", "q2"}
        return (ours.failures, sorted(ours.quarantined)), {}

    _twin(scenario)


# -- the fleet -----------------------------------------------------------------------


def test_fleet_failover_bit_identity_scripted_death():
    """4 workers (the reference's on four forced host devices, the port's on
    the CPU); the busiest worker wedged before the load and then killed:
    exactly its tenants re-dispatch, every result is bit for bit its serial
    run, every future resolves once."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("the reference's side needs >=4 forced host-platform devices")

    def scenario(s):
        tables = s.tenant_tables(k=8)
        serial = s.serial(tables)
        fleet = s.fleet(distinct_devices=True)
        try:
            routed = s.route(fleet, tables)
            victim_worker = max(set(routed.values()),
                                key=lambda w: sum(1 for v in routed.values() if v == w))
            victims = [t for t, w in routed.items() if w == victim_worker]
            assert victims
            fleet.stall_worker(victim_worker, seconds=30.0)
            time.sleep(0.05)
            futures = {t: fleet.submit(tbl, required_analyzers=s.analyzers(), tenant=t)
                       for t, tbl in tables.items()}
            redispatched = fleet.kill_worker(victim_worker)
            assert redispatched == len(victims)
            results = {t: f.result(timeout=300) for t, f in futures.items()}
            for t, result in results.items():
                _assert_bit_identical(serial[t], result, label=t)
            for t, f in futures.items():
                assert f.done() and f.resolve_count == 1, t
            assert fleet.workers_lost == 1
            assert fleet.requests_redispatched == len(victims)
            stats = fleet.stats()
            assert stats["workers_alive"] == 3
            assert stats["failovers"] >= 1
        finally:
            fleet.stop(drain=True)
        return (sorted(routed.items()), victim_worker, redispatched,
                stats["workers_alive"], stats["workers_lost"]), results

    _twin(scenario)


def test_fleet_healthy_load_spreads_and_serves_bit_identical():
    def scenario(s):
        tables = s.tenant_tables(k=6)
        serial = s.serial(tables)
        fleet = s.fleet()
        try:
            routed = s.route(fleet, tables)
            futures = {t: fleet.submit(tbl, required_analyzers=s.analyzers(), tenant=t)
                       for t, tbl in tables.items()}
            results = {t: f.result(timeout=120) for t, f in futures.items()}
            for t, r in results.items():
                _assert_bit_identical(serial[t], r, label=t)
            fleet.flush()
            served = {i: w["suites_served"] for i, w in fleet.stats()["workers"].items()}
            assert sum(served.values()) == len(tables)
            assert sum(1 for n in served.values() if n) >= 2
        finally:
            fleet.stop(drain=True)
        return (sorted(routed.items()), served), results

    _twin(scenario)


def test_fleet_budget_follows_failover_no_free_retries():
    def scenario(s):
        tables = s.tenant_tables(k=4)
        fleet = s.fleet()
        try:
            routed = s.route(fleet, tables)
            victim_worker, victim = next((w, t) for t, w in routed.items() if w is not None)
            fleet.stall_worker(victim_worker, seconds=30.0)
            time.sleep(0.05)
            roomy = fleet.submit(tables[victim], required_analyzers=s.analyzers(),
                                 tenant=victim, run_policy=s.RunPolicy(max_total_attempts=5))
            broke = fleet.submit(tables[victim], required_analyzers=s.analyzers(),
                                 tenant=f"{victim}-broke",
                                 run_policy=s.RunPolicy(max_total_attempts=0))
            fleet.kill_worker(victim_worker)
            ok = roomy.result(timeout=120)
            assert ok.run_budget["charges"].get("worker_failover") == 1
            degraded = broke.result(timeout=120)
            assert degraded.run_budget["exhausted"]
            assert all(not m.value.is_success for m in degraded.metrics.values())
            assert any(e["kind"] == "tenant_budget_exhausted"
                       for e in s.SCAN_STATS.degradation_events)
            fleet2 = s.fleet(n_workers=2)
            try:
                routed2 = s.route(fleet2, tables)
                w2, t2 = next((w, t) for t, w in routed2.items() if w is not None)
                fleet2.stall_worker(w2, seconds=30.0)
                time.sleep(0.05)
                doomed = fleet2.submit(tables[t2], required_analyzers=s.analyzers(), tenant=t2,
                                       run_policy=s.RunPolicy(max_total_attempts=0,
                                                              on_budget_exhausted="raise"))
                fleet2.kill_worker(w2)
                with pytest.raises(s.exc.RunBudgetExhaustedException):
                    doomed.result(timeout=120)
            finally:
                fleet2.stop(drain=True)
        finally:
            fleet.stop(drain=True)
        return ((victim_worker, victim), ok.run_budget["charges"], (w2, t2),
                degraded.run_budget["exhausted"]), {"roomy": ok, "broke": degraded}

    _twin(scenario)


def test_fleet_failover_retries_exhaust_typed():
    def scenario(s):
        tables = s.tenant_tables(k=4)
        fleet = s.fleet(failover_retries=0)
        try:
            routed = s.route(fleet, tables)
            victim_worker, victim = next((w, t) for t, w in routed.items() if w is not None)
            fleet.stall_worker(victim_worker, seconds=30.0)
            time.sleep(0.05)
            doomed = fleet.submit(tables[victim], required_analyzers=s.analyzers(),
                                  tenant=victim)
            fleet.kill_worker(victim_worker)
            with pytest.raises(s.exc.WorkerLostException, match="failover_retries") as ei:
                doomed.result(timeout=60)
            assert doomed.resolve_count == 1
        finally:
            fleet.stop(drain=True)
        return (victim_worker, ei.value.worker_ids, str(ei.value)), {}

    _twin(scenario)


def test_fleet_cross_worker_quarantine_shared_ledger():
    def scenario(s):
        fleet = s.fleet(n_workers=3, quarantine_after=2)
        try:
            ledgers = {id(w.service.tenant_health) for w in fleet._workers.values()}
            assert ledgers == {id(fleet._tenant_health)}
            fleet._tenant_health.record_failure("poison")
            fleet._tenant_health.record_failure("poison")
            for w in fleet._workers.values():
                assert w.service.tenant_health.is_quarantined("poison")
            before = s.SCAN_STATS.coalesced_batches
            result = fleet.verify(s.table(n=96, seed=7), required_analyzers=s.analyzers(),
                                  tenant="poison")
            assert result.scan_stats.get("coalesced") is False
            assert s.SCAN_STATS.coalesced_batches == before
            for w in fleet._workers.values():
                assert not w.service.tenant_health.is_quarantined("poison")
        finally:
            fleet.stop(drain=True)
        return len(ledgers), {"poison": result}

    _twin(scenario)


def test_fleet_rejoin_is_warm_and_all_dead_is_typed():
    def scenario(s):
        tables = s.tenant_tables(k=4)
        fleet = s.fleet(n_workers=2)
        try:
            for t, tbl in tables.items():
                fleet.verify(tbl, required_analyzers=s.analyzers(), tenant=t)
            fleet.kill_worker(0)
            worker = fleet.rejoin_worker(0)
            warmed = len(worker.service.plan_cache)
            assert warmed > 0
            assert fleet.stats()["workers_alive"] == 2
            assert fleet.rejoin_worker(0) is worker
            fleet.kill_worker(0)
            fleet.kill_worker(1)
            with pytest.raises(s.exc.ServiceClosedException, match="no alive"):
                fleet.submit(s.table(n=48), required_analyzers=s.analyzers(), tenant="t")
            revived = fleet.rejoin_worker(1)
            assert revived.alive
            result = fleet.verify(s.table(n=48, seed=3), required_analyzers=s.analyzers(),
                                  tenant="back")
            assert result is not None
        finally:
            fleet.stop(drain=True)
        return warmed, {"back": result}

    _twin(scenario)


def test_fleet_monitor_detects_stall_and_fails_over():
    def scenario(s):
        tables = s.tenant_tables(k=4)
        serial = s.serial(tables)
        fleet = s.serve.VerificationFleet(
            n_workers=2, monitor=False, distinct_devices=False, heartbeat_interval=0.05,
            stall_timeout=0.4, worker_knobs={"coalesce_window": 0.0, "max_batch": 1})
        try:
            # warm every plan first, then arm the monitor: a cold build would
            # read as a stall
            for t, tbl in tables.items():
                fleet.verify(tbl, required_analyzers=s.analyzers(), tenant=t)
            fleet.prewarm()
            fleet.membership.start()
            routed = s.route(fleet, tables)
            victim_worker = next(w for w in routed.values() if w is not None)
            victims = [t for t, w in routed.items() if w == victim_worker]
            fleet.stall_worker(victim_worker, seconds=2.5)
            time.sleep(0.1)
            futures = {t: fleet.submit(tbl, required_analyzers=s.analyzers(), tenant=t)
                       for t, tbl in tables.items()}
            results = {t: f.result(timeout=120) for t, f in futures.items()}
            assert fleet.workers_lost == 1
            assert fleet.requests_redispatched >= len(victims)
            for t, f in futures.items():
                assert f.resolve_count == 1, t
                _assert_bit_identical(serial[t], results[t], label=t)
            lost = fleet.workers_lost
        finally:
            fleet.stop(drain=True)
        return (sorted(routed.items()), victim_worker, lost), results

    _twin(scenario)


def test_fleet_registry_section_reads_through():
    def scenario(s):
        fleet = s.fleet(n_workers=2)
        try:
            result = fleet.verify(s.table(n=80, seed=5), required_analyzers=s.analyzers(),
                                  tenant="obs")
            section = s.REGISTRY.snapshot()["fleet"]
            assert section["workers_alive"] == 2
            assert set(section["workers"]) == {"0", "1"}
            assert all("queue_depth" in w and "suites_served" in w
                       for w in section["workers"].values())
            keys = sorted(section)
            fleet.kill_worker(0)
            section = s.REGISTRY.snapshot()["fleet"]
            assert section["workers_alive"] == 1
            assert section["workers_lost"] == 1
            gauge = s.REGISTRY.snapshot()["instruments"]["fleet_workers_alive"]
        finally:
            fleet.stop(drain=True)
        return (keys, sorted(section["workers"]["0"]), gauge), {"obs": result}

    _twin(scenario)


def test_fleet_stop_context_manager_and_closed_typed():
    def scenario(s):
        with s.fleet(n_workers=2) as fleet:
            result = fleet.verify(s.table(n=40, seed=11), required_analyzers=s.analyzers(),
                                  tenant="cm")
        with pytest.raises(s.exc.ServiceClosedException):
            fleet.submit(s.table(n=40, seed=11), required_analyzers=s.analyzers(), tenant="cm")
        return fleet.stats()["workers_alive"], {"cm": result}

    _twin(scenario)


def test_fleet_concurrent_submitters_one_resolution_each():
    def scenario(s):
        tables = s.tenant_tables(k=6)
        serial = s.serial(tables)
        fleet = s.fleet()
        futures: dict = {}
        lock = threading.Lock()

        def submitter(items):
            for t, tbl in items:
                f = fleet.submit(tbl, required_analyzers=s.analyzers(), tenant=t)
                with lock:
                    futures[t] = f

        try:
            items = list(tables.items())
            threads = [threading.Thread(target=submitter, args=(items[i::2],))
                       for i in range(2)]
            for th in threads:
                th.start()
            fleet.kill_worker(0)
            for th in threads:
                th.join()
            results = {}
            for t, f in futures.items():
                results[t] = f.result(timeout=120)
                assert f.resolve_count == 1, t
                _assert_bit_identical(serial[t], results[t], label=t)
        finally:
            fleet.stop(drain=True)
        return sorted(futures), results

    _twin(scenario)


def test_fleet_failover_sheds_expired_victim_typed():
    def scenario(s):
        table = s.table(seed=31)
        fleet = s.fleet(n_workers=2)
        try:
            wid = fleet.route(table, required_analyzers=s.analyzers())
            fleet.stall_worker(wid, seconds=30.0)
            time.sleep(0.05)
            doomed = fleet.submit(table, required_analyzers=s.analyzers(), tenant="late",
                                  slo=s.serve.Slo(deadline_ms=30.0, cls="standard"))
            fresh = fleet.submit(table, required_analyzers=s.analyzers(), tenant="fresh",
                                 slo=s.serve.Slo(deadline_ms=60_000.0, cls="standard"))
            time.sleep(0.08)
            redispatched = fleet.kill_worker(wid)
            with pytest.raises(s.exc.DeadlineExceededException) as e:
                doomed.result(timeout=60)
            assert e.value.slo_class == "standard"
            assert e.value.tenant == "late"
            assert doomed.resolve_count == 1
            assert redispatched == 1
            assert fleet.requests_redispatched == 1
            result = fresh.result(timeout=120)
            assert all(m.value.is_success for m in result.metrics.values())
            assert fresh.resolve_count == 1
            assert any(d.get("kind") == "deadline_shed" and d.get("at") == "failover"
                       for d in s.SCAN_STATS.degradation_events)
        finally:
            fleet.stop(drain=True)
        return (wid, redispatched, e.value.slo_class, e.value.deadline_ms), {"fresh": result}

    _twin(scenario)


def test_fleet_spills_admission_refusal_to_ring_successor():
    def scenario(s):
        table = s.table(seed=33)
        fleet = s.fleet(n_workers=2, worker_knobs={"coalesce_window": 0.0, "max_pending": 1})
        try:
            wid = fleet.route(table, required_analyzers=s.analyzers())
            other = [w for w in range(2) if w != wid][0]
            fleet.stall_worker(wid, seconds=30.0)
            fleet.stall_worker(other, seconds=2.0)
            time.sleep(0.05)
            first = fleet.submit(table, required_analyzers=s.analyzers(), tenant="a")
            spilled = fleet.submit(table, required_analyzers=s.analyzers(), tenant="b")
            with fleet._lock:
                assert fleet._assignments[spilled].worker == other
            with pytest.raises(s.exc.ServiceOverloadedException) as e:
                fleet.submit(table, required_analyzers=s.analyzers(), tenant="c")
            assert e.value.queue_depth == 1
            assert e.value.retry_after_s is not None
            fleet.kill_worker(wid)
            results = {}
            for label, f in (("a", first), ("b", spilled)):
                results[label] = f.result(timeout=120)
                assert all(m.value.is_success for m in results[label].metrics.values())
                assert f.resolve_count == 1
        finally:
            fleet.stop(drain=True)
        return (wid, other, type(e.value).__name__, e.value.queue_depth), results

    _twin(scenario)


# -- the port's own ---------------------------------------------------------------------


def test_fleet_without_a_device_raises_typed():
    """No card and no CPU request: the fleet raises typed at construction,
    as every port entry point does; ``use_device("cpu")`` places every
    worker on the CPU."""
    from deequ_tpu_torch.exceptions import DeviceUnavailableException
    from deequ_tpu_torch.serve import VerificationFleet

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the fleet places its workers there")
    with use_device(None):
        with pytest.raises(DeviceUnavailableException):
            VerificationFleet(n_workers=2, monitor=False)
    fleet = _side("port").fleet(n_workers=2, distinct_devices=True)
    try:
        assert {str(w.device) for w in fleet._workers.values()} == {"cpu"}
        assert {str(w.service._device) for w in fleet._workers.values()} == {"cpu"}
    finally:
        fleet.stop()


def test_worker_lost_is_no_device_fault_to_retry_or_bisect():
    """``WorkerLostException`` is a DeviceException naming workers, not
    cards: the classifier passes it through unchanged, it implicates no
    device, the service does not bisect on it and the retry policy does
    not retry it."""
    from deequ_tpu_torch.exceptions import (
        DeviceException,
        WorkerLostException,
        classify_device_error,
        implicated_devices,
    )
    from deequ_tpu_torch.resilience.retry import RetryPolicy
    from deequ_tpu_torch.serve.service import _bisectable

    from deequ_tpu.exceptions import WorkerLostException as RefWorkerLost

    for message in ("worker 3 died: scripted death",
                    "lost contact with fleet worker(s) [1, 2] (surviving: [0])"):
        e = WorkerLostException(message, worker_ids=(3,))
        ref = RefWorkerLost(message, worker_ids=(3,))
        assert isinstance(e, DeviceException)
        assert (e.worker_ids, e.boundary) == (ref.worker_ids, ref.boundary)
        assert classify_device_error(e) is e
        assert e.device_ids == () and implicated_devices(e) == ()
        assert not _bisectable(e)
        assert not RetryPolicy().is_retryable(e)


def test_warm_state_hands_plans_and_families_by_reference():
    """``PlanCache.entries`` is the LRU order, most recent last;
    ``warm_state(limit)`` takes the last ``limit``; ``warm_from`` adopts
    them, and a joiner on the same device serves a repeat suite with no
    program built."""
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
    from deequ_tpu_torch.serve import VerificationService

    donor = VerificationService(max_batch=4, coalesce_window=0.0)
    joiner = VerificationService(max_batch=4, coalesce_window=0.0)
    try:
        tables = [_side("port").table(n=40 + 8 * k, seed=k) for k in range(3)]
        for k, t in enumerate(tables):
            donor.verify(t, required_analyzers=_side("port").analyzers(), tenant=f"d{k}")
        entries = donor.plan_cache.entries()
        assert [p.key.chunk for p in entries] == [40, 48, 56]
        plans, families = donor.warm_state(2)
        assert [p.key.chunk for p in plans] == [48, 56]
        assert donor.warm_state(0)[0] == []
        joiner.warm_from(plans, families)
        assert [p for p in joiner.plan_cache.entries()] == plans  # the same objects
        built = SCAN_STATS.programs_built
        joiner.verify(tables[2], required_analyzers=_side("port").analyzers(), tenant="j")
        assert SCAN_STATS.programs_built == built
    finally:
        donor.stop()
        joiner.stop()


def test_stop_joins_a_stalled_zombie_promptly():
    """A killed worker whose thread sleeps a scripted stall is joined by
    ``fleet.stop()``: the stop ends the stall, so no thread of the fleet
    outlives it."""
    fleet = _side("port").fleet(n_workers=2)
    try:
        fleet.stall_worker(0, seconds=30.0)
        time.sleep(0.05)
        fleet.kill_worker(0)
        zombie = fleet._zombies[0]
    finally:
        t0 = time.monotonic()
        fleet.stop()
    assert time.monotonic() - t0 < 10.0
    assert not zombie._thread.is_alive()
    assert all(not w.service._thread.is_alive() for w in fleet._workers.values())


def _shared_plan_batches(tables, analyzers, plan, ks, device="cpu"):
    from deequ_tpu_torch.serve.executor import run_coalesced

    out = []
    for K in ks:
        members = tables[:K]
        out.append((K, run_coalesced(plan, members, [f"m{k}" for k in range(K)], device)))
    return out


def test_concurrent_workers_share_one_plan_bit_for_bit(monkeypatch):
    """Four threads run coalesced batches of ONE shared plan at once, K from
    1 to 64 in a different order each, so the program is built by racing
    first batches and the fold's ``single_rows`` tiling grows mid-run (in
    the device's turn); a fifth runs serial ``run()``s meanwhile, as a fleet
    worker does for a quarantined or whole-check tenant. Every member is
    bit for bit its serial run, one program is built, and the counts are
    exact: one K1 batch and one fold merge a batch plus the serial runs'
    own, the census's batches, members, programs, scan passes and rows,
    and each serial result's ``scan_stats`` its solo run's."""
    from deequ_tpu_torch.ops import masked_reduce, scan_engine
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
    from deequ_tpu_torch.serve.plan_cache import PlanKey, build_serve_plan, SUBPLAN_CACHE
    from deequ_tpu_torch.verification import VerificationSuite

    an = _side("port").an
    analyzers = [an.Size(), an.Completeness("x"), an.Mean("x"), an.Sum("i"), an.Maximum("x"),
                 an.StandardDeviation("i")]
    tables = [_side("port").table(n=96, seed=900 + k) for k in range(64)]
    serial = [VerificationSuite.run(t, [], required_analyzers=analyzers) for t in tables]
    plan = build_serve_plan(tables[0], analyzers)
    assert plan.coalescable
    from deequ_tpu_torch.serve.plan_cache import schema_signature

    plan.key = PlanKey(schema_signature(tables[0], plan.needed), tuple(analyzers),
                       plan.layout, 96)
    SUBPLAN_CACHE.clear()

    counts = {"reduce_into": 0, "merge": {}}
    count_lock = threading.Lock()
    reduce_into, merge_tags = masked_reduce.reduce_into, masked_reduce.merge_tags

    def counted_reduce(*a, **k):
        with count_lock:
            counts["reduce_into"] += 1
        return reduce_into(*a, **k)

    def counted_merge(*a, caller="fold", **k):
        with count_lock:
            counts["merge"][caller] = counts["merge"].get(caller, 0) + 1
        return merge_tags(*a, caller=caller, **k)

    monkeypatch.setattr(scan_engine.masked_reduce, "reduce_into", counted_reduce)
    monkeypatch.setattr(scan_engine.masked_reduce, "merge_tags", counted_merge)
    census = ("coalesced_batches", "coalesced_tenants", "programs_built", "programs_reused",
              "plan_cache_hits", "plan_cache_misses", "chunks_processed", "scan_passes",
              "rows_scanned")

    # one serial run alone: its launches and census, and its scan_stats
    # (every serial table has its shape)
    before = {name: getattr(SCAN_STATS, name) for name in census}
    with use_device("cpu"):
        solo = VerificationSuite.run(tables[0], [], required_analyzers=analyzers)
    solo_census = {name: getattr(SCAN_STATS, name) - v for name, v in before.items()}
    solo_launches = {"reduce_into": counts["reduce_into"], "merge": dict(counts["merge"])}
    assert solo_census["scan_passes"] >= 1 and solo_census["rows_scanned"] == 96
    counts.update(reduce_into=0, merge={})

    orders = []
    for w in range(4):
        ks = list(range(1, 65))
        np.random.default_rng(w).shuffle(ks)
        orders.append(ks[:16])
    serial_runs = 16
    before = {name: getattr(SCAN_STATS, name) for name in census}
    barrier = threading.Barrier(5)
    results, errors = [None] * 5, []

    def worker(w):
        try:
            barrier.wait()
            with use_device("cpu"):
                if w < 4:
                    results[w] = _shared_plan_batches(tables, analyzers, plan, orders[w])
                else:
                    results[w] = [VerificationSuite.run(tables[r % 8], [],
                                                        required_analyzers=analyzers)
                                  for r in range(serial_runs)]
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(5)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not errors, errors
    batches = sum(len(o) for o in orders)
    members = sum(sum(o) for o in orders)
    delta = {name: getattr(SCAN_STATS, name) - v for name, v in before.items()}
    assert delta["coalesced_batches"] == batches
    assert delta["coalesced_tenants"] == members
    assert delta["chunks_processed"] == members + serial_runs * solo_census["chunks_processed"]
    assert delta["scan_passes"] == batches + serial_runs * solo_census["scan_passes"]
    assert delta["rows_scanned"] == 96 * members + serial_runs * 96
    assert delta["programs_built"] == 1
    assert delta["programs_reused"] == batches - 1
    assert delta["plan_cache_hits"] + delta["plan_cache_misses"] == members
    merges = {c: serial_runs * n for c, n in solo_launches["merge"].items()}
    merges["coalesced"] = merges.get("coalesced", 0) + batches
    assert counts == {"reduce_into": batches + serial_runs * solo_launches["reduce_into"],
                      "merge": merges}
    assert plan.program_for("cpu")[0].fold is not None
    widest = plan.program_for("cpu")[0].fold._tiled[0].numel() // \
        plan.program_for("cpu")[0].fold.elem_size
    assert widest >= max(max(o) for o in orders)

    # each serial run's own census, whatever the other threads scanned
    timing = ("dispatch_seconds", "drain_wait_seconds")
    want_stats = {k: v for k, v in solo.scan_stats.items() if k not in timing}
    for r, result in enumerate(results[4]):
        assert {k: v for k, v in result.scan_stats.items() if k not in timing} == want_stats, r
        assert result.device_events == [], r
        _assert_bit_identical(serial[r % 8], result, label=f"serial {r}")

    # each member's scan results, finalised as the service does, are its
    # serial run's bits
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner, AnalyzerContext

    for w in range(4):
        for K, per_member in results[w]:
            for k, scan_results in enumerate(per_member):
                ctx = AnalysisRunner._finalize_scanning_analyzers(
                    AnalyzerContext.empty(), plan.scannable, plan.extract_plan, scan_results)
                for a in analyzers:
                    want = serial[k].metrics[a].value.get()
                    assert _bits(ctx.metric_map[a].value.get()) == _bits(want), (w, K, k, a)


@pytest.mark.parametrize("warm_plans", [8, 0])
def test_rejoined_worker_builds_no_plan_only_when_warmed(warm_plans):
    """A joiner warmed from the survivors' hot plans builds no serve plan of
    its own for the tenants it takes back; a cold one (``warm_plans=0``:
    the analyzer families travel, the plans do not) builds one a plan key.
    Programs say nothing here: both find them in the process-wide sub-plan
    cache on one device."""
    s = _side("port")
    tables = s.tenant_tables(k=8)
    fleet = s.fleet(n_workers=2, warm_plans=warm_plans)
    try:
        for t, tbl in tables.items():
            fleet.verify(tbl, required_analyzers=s.analyzers(), tenant=t)
        fleet.prewarm()
        fleet.kill_worker(0)
        for t, tbl in tables.items():
            fleet.verify(tbl, required_analyzers=s.analyzers(), tenant=t)
        worker = fleet.rejoin_worker(0)
        home = [t for t, w in s.route(fleet, tables).items() if w == 0]
        assert home
        for t, tbl in tables.items():
            fleet.verify(tbl, required_analyzers=s.analyzers(), tenant=t)
        assert worker.service.suites_served == len(home)
        assert worker.service.plans_built == (0 if warm_plans else len(home))
    finally:
        fleet.stop()


def test_lut_memo_builds_once_under_racing_threads():
    """Threads that ask for one dictionary's LUT at once build it once:
    ``BUILDS`` counts one, and every thread gets the kept array."""
    from deequ_tpu_torch.ops import lut_cache

    dictionary = np.array([f"v{i}" for i in range(2000)], dtype=object)
    gate = threading.Barrier(8)
    got, calls = [], itertools.count()

    def builder(d):
        next(calls)
        time.sleep(0.01)  # long enough that every thread misses first
        return np.arange(len(d), dtype=np.int64)

    def ask():
        gate.wait()
        got.append(lut_cache.dictionary_lut(dictionary, "fleet-race", builder))

    before = lut_cache.BUILDS
    threads = [threading.Thread(target=ask) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert lut_cache.BUILDS - before == 1
    assert len({id(a) for a in got}) == 1
    assert next(calls) >= 2  # the race did happen: several built, one kept


@pytest.mark.cuda
def test_cuda_concurrent_workers_exact_launch_counts():
    """On a card: four threads run coalesced batches of one shared plan at
    once; ``masked_reduce.LAUNCHES`` and ``MERGE_LAUNCHES_BY_CALLER
    ["coalesced"]`` grow by exactly one a batch, and every member is bit
    for bit its serial run there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and its merge are CUDA C++ with no CPU mode")
    from deequ_tpu_torch.ops import masked_reduce
    from deequ_tpu_torch.serve.plan_cache import PlanKey, build_serve_plan, schema_signature
    from deequ_tpu_torch.verification import VerificationSuite

    analyzers = _side("port").analyzers()
    tables = [_side("port").table(n=256, seed=950 + k) for k in range(32)]
    with use_device("cuda"):
        serial = [VerificationSuite.run(t, [], required_analyzers=analyzers) for t in tables]
        plan = build_serve_plan(tables[0], analyzers)
        plan.key = PlanKey(schema_signature(tables[0], plan.needed), tuple(analyzers),
                           plan.layout, 256)
        launches = masked_reduce.LAUNCHES
        merges = masked_reduce.MERGE_LAUNCHES_BY_CALLER.get("coalesced", 0)
        out = [None] * 4

        def worker(w):
            out[w] = _shared_plan_batches(tables, analyzers, plan, [1 + (w * 7 + j) % 32
                                                                   for j in range(8)],
                                          device="cuda")

        threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    assert masked_reduce.LAUNCHES - launches == 32
    assert masked_reduce.MERGE_LAUNCHES_BY_CALLER["coalesced"] - merges == 32
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner, AnalyzerContext

    for per_worker in out:
        for K, per_member in per_worker:
            for k, scan_results in enumerate(per_member):
                ctx = AnalysisRunner._finalize_scanning_analyzers(
                    AnalyzerContext.empty(), plan.scannable, plan.extract_plan, scan_results)
                for a in analyzers:
                    assert _bits(ctx.metric_map[a].value.get()) == \
                        _bits(serial[k].metrics[a].value.get())


def test_fleet_modules_import_neither_jax_nor_the_reference():
    import os
    import subprocess
    import sys

    code = (
        "import sys, deequ_tpu_torch.serve.fleet, deequ_tpu_torch.serve.router, "
        "deequ_tpu_torch.serve.membership, deequ_tpu_torch.serve.transport, "
        "deequ_tpu_torch.serve.ledger\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'deequ_tpu' or m.startswith('deequ_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

