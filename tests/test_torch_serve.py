"""The port's serving layer (deequ_tpu_torch/serve: the service, its plan
cache and the coalesced executor) on the CPU: twins of tests/test_serve.py,
the service held against the reference's, and the port's own contracts.

- Coalesced == serial, bit for bit: every analyzer family's metric from a
  coalesced batch equals the tenant's own ``VerificationSuite.run`` (encoded
  and sketch members, string members with their own dictionaries); a
  member's bits do not depend on K or on its place in the batch (the twin
  of the reference's padding test: the port pads no tenant axis, and
  ``coalesce_padded_slots`` stays 0); one fetch a batch; unequal row
  counts and grouping suites do not coalesce; a service over a mesh serves
  serially.
- The plan cache: a repeat suite builds nothing; a schema, predicate or row
  count change misses; a degenerate first table poisons nothing.
- Isolation: an OOM at a coalesced dispatch bisects the batch and every
  member completes; one member's exhausted budget degrades its result
  alone; a repeat offender is quarantined to the serial route and one
  success heals it; a sticky fault (a lost device) rejects the whole batch
  typed with no bisection.
- Lifecycle: cancellation, kill-and-resume onto the original futures, a
  worker that outlives a bad request, typed backpressure, the
  ``DEEQU_TORCH_SERVE_*`` switches.
- Placement: a service built under ``use_device("cpu")`` serves on the CPU
  whatever the submitting thread's scope; one built with no scope on a
  host without a card rejects every future typed.
- K1 and its fold merge run once a coalesced batch, whatever K: the merged
  batch gives each member the bits of its own.
- Parity: both packages' services over the same seeded tenants, within
  tests/torch_parity.py's bounds.

The reference's tests that need the plan lint or the chaos engine
(``test_chaos_schedule_through_coalesced_dispatch``, the three
``test_packed_lint_*``) wait for the port's tooling slice."""

import struct

import numpy as np
import pytest
import torch

from deequ_tpu_torch import Check, CheckLevel, VerificationSuite, use_device
from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    Maximum,
    Mean,
    Minimum,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.exceptions import (
    DeviceLostException,
    DeviceUnavailableException,
    EnvConfigError,
    ServiceClosedException,
    ServiceOverloadedException,
)
from deequ_tpu_torch.ops import masked_reduce
from deequ_tpu_torch.ops.device_policy import install_scan_fault_hook
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
from deequ_tpu_torch.parallel.mesh import use_mesh
from deequ_tpu_torch.resilience.faults import FaultInjectingScanHook
from deequ_tpu_torch.resilience.governance import RunPolicy, fault_state_scope
from deequ_tpu_torch.serve import VerificationService

pytestmark = [pytest.mark.torch_port, pytest.mark.serve]


@pytest.fixture(autouse=True)
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_device("cpu"), use_mesh(None), fault_state_scope():
        yield
    torch.set_num_threads(threads)


def _table(n=256, seed=0, with_string=False, encoded=False):
    r = np.random.default_rng(seed)
    cols = [
        Column("x", DType.FRACTIONAL, values=r.normal(100, 5, n), mask=r.random(n) > 0.05),
        Column("i", DType.INTEGRAL, values=r.integers(0, 50, n).astype(np.float64),
               mask=np.ones(n, bool)),
    ]
    if with_string:
        dictionary = np.array(["aa", "bb", "cc-1", "dd"], dtype=object)
        cols.append(Column("s", DType.STRING,
                           codes=r.integers(0, len(dictionary), n).astype(np.int32),
                           dictionary=dictionary))
    t = ColumnarTable(cols)
    if encoded:
        assert t.encode(["i"])["i"].encoding is not None
    return t


def _families(with_string=False):
    analyzers = [
        Size(), Completeness("x"), Mean("x"), StandardDeviation("x"), Minimum("x"),
        Maximum("x"), Sum("x"), ApproxCountDistinct("x"), ApproxQuantile("x", 0.5),
        Mean("i"),
    ]
    if with_string:
        analyzers.append(PatternMatch("s", r"^[a-z]+$"))
    return analyzers


def _bits(value):
    return struct.pack("<d", value) if isinstance(value, float) else value


def _assert_bit_identical(serial_result, served_result, label=""):
    assert serial_result.status == served_result.status, label
    assert set(serial_result.metrics) == set(served_result.metrics), label
    for a, m1 in serial_result.metrics.items():
        m2 = served_result.metrics[a]
        assert m1.value.is_success == m2.value.is_success, (label, str(a))
        if m1.value.is_success:
            assert _bits(m1.value.get()) == _bits(m2.value.get()), (
                f"{label}: {a} serial={m1.value.get()!r} served={m2.value.get()!r}")


def _serial(tables, analyzers):
    return [VerificationSuite.run(t, [], required_analyzers=analyzers) for t in tables]


def _serve_one_batch(tables, analyzers, prefix="t", **knobs):
    """Every table submitted before the worker starts, so they share a
    batch whatever the scheduler does."""
    svc = VerificationService(start=False, max_batch=max(16, len(tables)), **knobs)
    try:
        futures = [svc.submit(t, required_analyzers=analyzers, tenant=f"{prefix}{i}")
                   for i, t in enumerate(tables)]
        svc.start()
        return [f.result(timeout=60) for f in futures]
    finally:
        svc.stop(drain=False)


@pytest.fixture
def service():
    svc = VerificationService(max_batch=16, coalesce_window=0.02)
    yield svc
    svc.stop(drain=False)


# -- bit for bit -------------------------------------------------------------------


def test_coalesced_bit_identical_per_family():
    analyzers = _families()
    tables = [_table(n=256, seed=s, encoded=True) for s in range(8)]
    serial = _serial(tables, analyzers)
    before = SCAN_STATS.coalesced_batches
    served = _serve_one_batch(tables, analyzers)
    assert SCAN_STATS.coalesced_batches == before + 1, "the 8 tenants must share one batch"
    assert all(r.scan_stats.get("coalesced") is True for r in served)
    for i, (s, c) in enumerate(zip(serial, served)):
        _assert_bit_identical(s, c, label=f"tenant {i}")


def test_coalesced_string_luts_bit_identical():
    """String members, each with its own dictionary and lookup tables in
    its slot of the batch's buffer, match their serial runs."""
    analyzers = _families(with_string=True)
    tables = [_table(n=128, seed=s, with_string=True) for s in range(5)]
    serial = _serial(tables, analyzers)
    served = _serve_one_batch(tables, analyzers, prefix="s")
    for i, (s, c) in enumerate(zip(serial, served)):
        _assert_bit_identical(s, c, label=f"string tenant {i}")


@pytest.mark.parametrize("K", [1, 2, 3, 5, 8])
def test_member_bits_do_not_depend_on_k_or_position(K):
    """The twin of the reference's padding test: the port pads no tenant
    axis, so a batch of K holds K members (no padded slot), and a member's
    bits are its serial run's whatever K and whichever row it takes."""
    analyzers = _families()
    probe = _table(n=200, seed=40)
    others = [_table(n=200, seed=41 + s) for s in range(K - 1)]
    want = VerificationSuite.run(probe, [], required_analyzers=analyzers)
    padded = SCAN_STATS.coalesce_padded_slots
    for position in sorted({0, K - 1}):
        tables = others[:position] + [probe] + others[position:]
        tenants = SCAN_STATS.coalesced_tenants
        served = _serve_one_batch(tables, analyzers, prefix="p")
        assert SCAN_STATS.coalesced_tenants - tenants == K
        _assert_bit_identical(want, served[position], label=f"K={K} row {position}")
    assert SCAN_STATS.coalesce_padded_slots == padded


def test_one_fetch_per_coalesced_batch(service):
    analyzers = _families()
    service.submit(_table(n=128, seed=59), required_analyzers=analyzers,
                   tenant="w").result(timeout=60)
    service.flush()
    fetches, batches = SCAN_STATS.device_fetches, SCAN_STATS.coalesced_batches
    futures = [service.submit(_table(n=128, seed=60 + s), required_analyzers=analyzers,
                              tenant=f"f{s}") for s in range(6)]
    [f.result(timeout=60) for f in futures]
    new_batches = SCAN_STATS.coalesced_batches - batches
    assert new_batches >= 1
    assert SCAN_STATS.device_fetches - fetches == new_batches


def test_mixed_row_counts_group_separately():
    analyzers = [Size(), Mean("x"), Completeness("x")]
    tables = [_table(n=100, seed=s) for s in range(2)] + \
        [_table(n=300, seed=10 + s) for s in range(2)]
    serial = _serial(tables, analyzers)
    before = SCAN_STATS.coalesced_batches
    served = _serve_one_batch(tables, analyzers, prefix="m")
    assert SCAN_STATS.coalesced_batches == before + 2, "one batch a row count"
    for i, (s, c) in enumerate(zip(serial, served)):
        _assert_bit_identical(s, c, label=f"mixed member {i}")


def test_grouping_suite_serves_serial(service):
    from deequ_tpu_torch.analyzers import Uniqueness

    check = (Check(CheckLevel.ERROR, "u").has_uniqueness(("i",), lambda u: u >= 0.0)
             .has_size(lambda n: n == 64))
    serial = VerificationSuite.run(_table(n=64, seed=7), [check])
    before = SCAN_STATS.coalesced_batches
    served = service.submit(_table(n=64, seed=7), [check], tenant="g").result(timeout=60)
    assert SCAN_STATS.coalesced_batches == before
    assert served.scan_stats.get("coalesced") is False
    assert Uniqueness(("i",)) in served.metrics
    _assert_bit_identical(serial, served, label="grouping suite")


def test_service_under_mesh_serves_serial():
    from deequ_tpu_torch.parallel.mesh import virtual_mesh

    analyzers = [Size(), Mean("x")]
    mesh = virtual_mesh(8, "cpu")
    with use_mesh(mesh):
        serial = VerificationSuite.run(_table(n=128, seed=3), [], required_analyzers=analyzers)
        svc = VerificationService(max_batch=8, coalesce_window=0.0)
    try:
        before = SCAN_STATS.coalesced_batches
        served = svc.submit(_table(n=128, seed=3), required_analyzers=analyzers,
                            tenant="mesh").result(timeout=60)
        assert SCAN_STATS.coalesced_batches == before
        assert served.scan_stats.get("coalesced") is False
        _assert_bit_identical(serial, served, label="mesh tenant")
    finally:
        svc.stop(drain=False)


# -- the plan cache ----------------------------------------------------------------


def test_plan_cache_hit_builds_nothing():
    """The repeat-tenant contract: the second identical suite is a hit and
    builds no program (the ops, the fold's device tensors and the recipe
    all come from the cache)."""
    svc = VerificationService(max_batch=4, coalesce_window=0.0)
    try:
        analyzers = _families()
        svc.submit(_table(n=128, seed=1), required_analyzers=analyzers,
                   tenant="a").result(timeout=60)
        built, hits = SCAN_STATS.programs_built, SCAN_STATS.plan_cache_hits
        result = svc.submit(_table(n=128, seed=2), required_analyzers=analyzers,
                            tenant="a").result(timeout=60)
        assert all(m.value.is_success for m in result.metrics.values())
        assert SCAN_STATS.programs_built == built, "a repeat suite built a program"
        assert SCAN_STATS.plan_cache_hits == hits + 1
    finally:
        svc.stop(drain=False)


def test_plan_cache_miss_on_schema_predicate_and_rows(service):
    base = [Size(), Mean("x"), Completeness("x")]
    where = [Size(), Mean("x", where="x > 90"), Completeness("x")]

    def run(analyzers, table):
        misses, hits = SCAN_STATS.plan_cache_misses, SCAN_STATS.plan_cache_hits
        service.submit(table, required_analyzers=analyzers, tenant="cm").result(timeout=60)
        return (SCAN_STATS.plan_cache_hits - hits, SCAN_STATS.plan_cache_misses - misses)

    assert run(base, _table(n=128, seed=1)) == (0, 1)
    assert run(base, _table(n=128, seed=2)) == (1, 0)
    assert run(where, _table(n=128, seed=3)) == (0, 1)
    assert run(where, _table(n=128, seed=4)) == (1, 0)
    assert run(base, _table(n=96, seed=5)) == (0, 1)
    extra = _table(n=128, seed=6)
    r = np.random.default_rng(6)
    extra = ColumnarTable([extra["x"], extra["i"],
                           Column("z", DType.FRACTIONAL, values=r.normal(0, 1, 128),
                                  mask=np.ones(128, bool))])
    assert run(base, extra) == (1, 0)  # a column no analyzer reads
    ints_as_x = ColumnarTable([
        Column("x", DType.INTEGRAL, values=r.integers(0, 100, 128).astype(np.float64),
               mask=np.ones(128, bool)),
        Column("i", DType.INTEGRAL, values=r.integers(0, 50, 128).astype(np.float64),
               mask=np.ones(128, bool)),
    ])
    assert run(base, ints_as_x) == (0, 1)  # a read column's dtype


def test_degenerate_first_table_does_not_poison_plan(service):
    analyzers = [Mean("x"), Completeness("i")]
    r = np.random.default_rng(5)
    missing_i = ColumnarTable([Column("x", DType.FRACTIONAL, values=r.normal(100, 5, 64),
                                      mask=np.ones(64, bool))])
    degenerate = service.submit(missing_i, required_analyzers=analyzers,
                                tenant="d").result(timeout=60)
    assert any(m.value.is_failure for m in degenerate.metrics.values())
    serial = VerificationSuite.run(_table(n=64, seed=6), [], required_analyzers=analyzers)
    before = SCAN_STATS.coalesced_batches
    served = service.submit(_table(n=64, seed=6), required_analyzers=analyzers,
                            tenant="h").result(timeout=60)
    assert all(m.value.is_success for m in served.metrics.values())
    assert SCAN_STATS.coalesced_batches > before
    _assert_bit_identical(serial, served, label="after a degenerate tenant")


# -- isolation -----------------------------------------------------------------------


def test_fault_bisects_tenant_axis(service):
    analyzers = [Size(), Mean("x"), Minimum("x"), Maximum("x")]
    tables = [_table(n=128, seed=70 + s) for s in range(8)]
    serial = _serial(tables, analyzers)
    service.submit(_table(n=128, seed=69), required_analyzers=analyzers,
                   tenant="w").result(timeout=60)
    hook = FaultInjectingScanHook(faults={0: ("oom", 1)}, relative=True)
    prev = install_scan_fault_hook(hook)
    try:
        futures = [service.submit(t, required_analyzers=analyzers, tenant=f"b{i}")
                   for i, t in enumerate(tables)]
        served = [f.result(timeout=120) for f in futures]
    finally:
        install_scan_fault_hook(prev)
    assert hook.injected
    assert "coalesce_bisect" in [e["kind"] for e in SCAN_STATS.degradation_events]
    for i, (s, c) in enumerate(zip(serial, served)):
        _assert_bit_identical(s, c, label=f"bisected member {i}")


def test_sticky_fault_rejects_the_batch_typed_without_bisection():
    """A lost device leaves a CUDA context unusable: the batch is not split,
    every member's future is rejected with the typed fault, and no member
    is retried."""
    analyzers = [Size(), Mean("x")]
    tables = [_table(n=64, seed=150 + s) for s in range(4)]
    events = len(SCAN_STATS.degradation_events)
    svc = VerificationService(start=False, max_batch=4)
    hook = FaultInjectingScanHook(faults={0: ("lost", 1)}, relative=True)
    prev = install_scan_fault_hook(hook)
    try:
        futures = [svc.submit(t, required_analyzers=analyzers, tenant=f"l{i}")
                   for i, t in enumerate(tables)]
        svc.start()
        for f in futures:
            with pytest.raises(DeviceLostException):
                f.result(timeout=60)
    finally:
        install_scan_fault_hook(prev)
        svc.stop(drain=False)
    kinds = [e["kind"] for e in SCAN_STATS.degradation_events[events:]]
    assert "coalesce_bisect" not in kinds
    assert kinds.count("coalesce_sticky_fault") == 1
    assert len(hook.calls) == 1, "a sticky fault must launch nothing more"


def test_poison_tenant_bisects_isolates_and_is_quarantined():
    """A fault that follows one tenant: each batch holding it bisects down
    to it alone, its serial rung fails typed (the OOM ladder to its floor),
    every other member is bit for bit its serial run; two such batches
    quarantine it, and one healthy serial run readmits it."""
    from deequ_tpu_torch.exceptions import DeviceOOMException

    analyzers = [Size(), Mean("x"), Completeness("x")]
    tables = [_table(n=256, seed=160 + s) for s in range(8)]
    serial = _serial(tables, analyzers)
    svc = VerificationService(start=False, max_batch=8, coalesce_window=0.0,
                              quarantine_after=2)
    hook = FaultInjectingScanHook(tenant_faults={"p3": "oom"})
    prev = install_scan_fault_hook(hook)
    try:
        for round_ in range(2):
            events = len(SCAN_STATS.degradation_events)
            futures = [svc.submit(t, required_analyzers=analyzers, tenant=f"p{i}")
                       for i, t in enumerate(tables)]
            if round_ == 0:
                svc.start()
            served = [f.result(timeout=120) for f in futures]
            kinds = [e["kind"] for e in SCAN_STATS.degradation_events[events:]]
            assert kinds.count("coalesce_bisect") == 3, kinds  # 8 -> 4 -> 2 -> 1
            assert "oom_bisect" in kinds  # the serial rung's ladder
            poison = served[3]
            assert poison.scan_stats.get("isolated_after")
            assert all(not m.value.is_success
                       and isinstance(m.value.exception, DeviceOOMException)
                       for m in poison.metrics.values())
            for i, (s_, c) in enumerate(zip(serial, served)):
                if i != 3:
                    _assert_bit_identical(s_, c, label=f"round {round_} member {i}")
        assert svc.tenant_health.is_quarantined("p3")
        assert "tenant_quarantine" in [e["kind"] for e in SCAN_STATS.degradation_events]
    finally:
        install_scan_fault_hook(prev)
    try:
        healed = svc.submit(tables[3], required_analyzers=analyzers,
                            tenant="p3").result(timeout=60)
        assert healed.scan_stats.get("coalesced") is False
        _assert_bit_identical(serial[3], healed, label="readmitted tenant")
        assert not svc.tenant_health.is_quarantined("p3")
    finally:
        svc.stop(drain=False)


def test_budget_exhaustion_degrades_only_its_slice():
    analyzers = [Size(), Mean("x")]
    tables = [_table(n=64, seed=90 + s) for s in range(4)]
    serial = _serial(tables, analyzers)
    svc = VerificationService(start=False, max_batch=4)
    hook = FaultInjectingScanHook(faults={0: ("oom", 1)}, relative=True)
    prev = install_scan_fault_hook(hook)
    try:
        futures = [svc.submit(t, required_analyzers=analyzers, tenant=f"x{i}",
                              run_policy=RunPolicy(max_total_attempts=0 if i == 1 else 100))
                   for i, t in enumerate(tables)]
        svc.start()
        served = [f.result(timeout=120) for f in futures]
    finally:
        install_scan_fault_hook(prev)
        svc.stop(drain=False)
    assert hook.injected
    for i, (s, c) in enumerate(zip(serial, served)):
        if i == 1:
            assert [m for m in c.metrics.values() if m.value.is_failure]
            assert c.run_budget.get("exhausted"), c.run_budget
        else:
            _assert_bit_identical(s, c, label=f"healthy member {i}")
    assert "tenant_budget_exhausted" in [e["kind"] for e in SCAN_STATS.degradation_events]


def test_tenant_quarantine_and_healing():
    svc = VerificationService(max_batch=4, coalesce_window=0.0, quarantine_after=2)
    try:
        analyzers = [Size(), Mean("x")]
        svc.submit(_table(n=64, seed=99), required_analyzers=analyzers,
                   tenant="w").result(timeout=60)
        for attempt in range(2):
            prev = install_scan_fault_hook(
                FaultInjectingScanHook(faults={0: ("oom", 1)}, relative=True))
            try:
                svc.submit(_table(n=64, seed=100 + attempt), required_analyzers=analyzers,
                           tenant="offender",
                           run_policy=RunPolicy(max_total_attempts=0)).result(timeout=120)
            finally:
                install_scan_fault_hook(prev)
        assert svc.tenant_health.is_quarantined("offender")
        assert "tenant_quarantine" in [e["kind"] for e in SCAN_STATS.degradation_events]
        before = SCAN_STATS.coalesced_batches
        result = svc.submit(_table(n=64, seed=104), required_analyzers=analyzers,
                            tenant="offender").result(timeout=60)
        assert SCAN_STATS.coalesced_batches == before
        assert result.scan_stats.get("coalesced") is False
        assert not svc.tenant_health.is_quarantined("offender")
    finally:
        svc.stop(drain=False)


# -- lifecycle -----------------------------------------------------------------------


def test_future_cancellation():
    from concurrent.futures import CancelledError

    svc = VerificationService(start=False)
    analyzers = [Size(), Mean("x")]
    fut = svc.submit(_table(n=32, seed=1), required_analyzers=analyzers, tenant="c")
    assert fut.cancel() is True and fut.cancelled()
    with pytest.raises(CancelledError):
        fut.result(timeout=1)
    svc.start()
    live = svc.submit(_table(n=32, seed=2), required_analyzers=analyzers, tenant="c")
    assert live.result(timeout=60) is not None
    assert live.cancel() is False
    svc.stop(drain=False)


def test_kill_and_resume_pending_queue():
    analyzers = [Size(), Mean("x"), Completeness("x")]
    tables = [_table(n=64, seed=110 + s) for s in range(4)]
    serial = _serial(tables, analyzers)
    first = VerificationService(start=False, max_batch=4)
    futures = [first.submit(t, required_analyzers=analyzers, tenant=f"k{i}")
               for i, t in enumerate(tables)]
    pending = first.stop(drain=False)
    assert len(pending) == 4 and not any(f.done() for f in futures)
    with pytest.raises(ServiceClosedException):
        first.submit(tables[0], required_analyzers=analyzers)
    second = VerificationService(max_batch=4, coalesce_window=0.01)
    try:
        second.resume(pending)
        served = [f.result(timeout=60) for f in futures]
        for i, (s, c) in enumerate(zip(serial, served)):
            _assert_bit_identical(s, c, label=f"resumed member {i}")
        assert all(f.resolve_count == 1 for f in futures)
    finally:
        second.stop(drain=False)


def test_worker_survives_bad_request():
    svc = VerificationService(max_batch=4, coalesce_window=0.0)
    try:
        analyzers = [Size(), Mean("x")]

        class NotAPolicy:
            pass

        bad = svc.submit(_table(n=32, seed=1), required_analyzers=analyzers, tenant="bad",
                         run_policy=NotAPolicy())
        with pytest.raises(Exception):
            bad.result(timeout=60)
        good = svc.submit(_table(n=32, seed=2), required_analyzers=analyzers,
                          tenant="ok").result(timeout=60)
        assert all(m.value.is_success for m in good.metrics.values())
    finally:
        svc.stop(drain=False)


def test_backpressure_typed():
    svc = VerificationService(start=False, max_pending=2)
    svc.submit(_table(n=16, seed=1), required_analyzers=[Size()])
    svc.submit(_table(n=16, seed=2), required_analyzers=[Size()])
    with pytest.raises(ServiceOverloadedException):
        svc.submit(_table(n=16, seed=3), required_analyzers=[Size()])
    svc.stop(drain=False)


def test_env_registry_serve_switches(monkeypatch):
    from deequ_tpu_torch.envcfg import env_value, registry_snapshot

    monkeypatch.setenv("DEEQU_TORCH_SERVE_MAX_BATCH", "8")
    assert env_value("DEEQU_TORCH_SERVE_MAX_BATCH") == 8
    svc = VerificationService(start=False)
    assert svc.config.max_batch == 8
    svc.stop(drain=False)
    monkeypatch.setenv("DEEQU_TORCH_SERVE_MAX_BATCH", "zero")
    with pytest.raises(EnvConfigError, match="DEEQU_TORCH_SERVE_MAX_BATCH"):
        VerificationService(start=False)
    snap = registry_snapshot()
    assert "error" in snap["DEEQU_TORCH_SERVE_MAX_BATCH"]


def test_env_registry_typed_errors(monkeypatch):
    from deequ_tpu_torch.envcfg import env_value

    monkeypatch.setenv("DEEQU_TORCH_SERVE_COALESCE_WINDOW", "-1")
    with pytest.raises(EnvConfigError, match="SERVE_COALESCE_WINDOW"):
        env_value("DEEQU_TORCH_SERVE_COALESCE_WINDOW")
    monkeypatch.setenv("DEEQU_TORCH_SERVE_COALESCE_WINDOW", "0.5")
    assert env_value("DEEQU_TORCH_SERVE_COALESCE_WINDOW") == 0.5
    assert issubclass(EnvConfigError, ValueError)


# -- placement -------------------------------------------------------------------------


def test_service_built_under_a_cpu_scope_serves_on_the_cpu():
    """The worker thread runs in the constructing thread's context: its
    use_device("cpu") scope holds there though the submitting thread has
    none."""
    analyzers = [Size(), Mean("x")]
    want = VerificationSuite.run(_table(n=64, seed=1), [], required_analyzers=analyzers)
    svc = VerificationService(max_batch=4, coalesce_window=0.0)
    try:
        with use_device(None):
            result = svc.submit(_table(n=64, seed=1), required_analyzers=analyzers,
                                tenant="c").result(timeout=60)
        assert result.device == "cpu"
        _assert_bit_identical(want, result, label="cpu-scoped service")
    finally:
        svc.stop(drain=False)


def test_service_without_a_device_rejects_typed(monkeypatch):
    """With no card and no CPU scope the worker raises where a scan would:
    every future is rejected with DeviceUnavailableException, nothing runs
    on the CPU (the host's card is hidden, as a host without one)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with use_device(None):
        svc = VerificationService(max_batch=4, coalesce_window=0.0)
    try:
        future = svc.submit(_table(n=64, seed=1), required_analyzers=[Size(), Mean("x")],
                            tenant="nodev")
        with pytest.raises(DeviceUnavailableException):
            future.result(timeout=60)
    finally:
        svc.stop(drain=False)


# -- one K1 batch and one fold merge a coalesced batch -----------------------------------


@pytest.mark.parametrize("K", [1, 3, 8])
def test_coalesced_batch_resolves_k1_and_merge_once(monkeypatch, K):
    """However many members, a coalesced batch makes ONE reduce_into call
    and ONE merge_tags call (on a card: one K1 batch, one merge launch)."""
    from deequ_tpu_torch.ops import scan_engine

    calls = {"reduce_into": 0, "merge_tags": []}
    reduce_into, merge_tags = masked_reduce.reduce_into, masked_reduce.merge_tags

    def counted_reduce(*a, **k):
        calls["reduce_into"] += 1
        return reduce_into(*a, **k)

    def counted_merge(*a, caller="fold", **k):
        calls["merge_tags"].append(caller)
        return merge_tags(*a, caller=caller, **k)

    analyzers = _families()
    tables = [_table(n=128, seed=200 + s) for s in range(K)]
    serial = _serial(tables, analyzers)
    monkeypatch.setattr(scan_engine.masked_reduce, "reduce_into", counted_reduce)
    monkeypatch.setattr(scan_engine.masked_reduce, "merge_tags", counted_merge)
    batches = SCAN_STATS.coalesced_batches
    served = _serve_one_batch(tables, analyzers, prefix="k")
    assert SCAN_STATS.coalesced_batches == batches + 1
    assert calls["reduce_into"] == 1
    assert calls["merge_tags"] == ["coalesced"]
    for i, (s, c) in enumerate(zip(serial, served)):
        _assert_bit_identical(s, c, label=f"K={K} member {i}")


def test_merged_k1_batch_gives_each_member_its_own_bits():
    """_DeviceFoldPlan.flatten_rows / single_rows over K members' partials
    (one K1 batch, one merge) against flatten / single a member."""
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops.scan_engine import _ChunkPacker, _DeviceFoldPlan

    analyzers = [a for a in _families() if not isinstance(a, ApproxQuantile)]
    tables = [_table(n=96, seed=300 + s) for s in range(5)]
    ops, _, fails = AnalysisRunner._build_scan_ops(tables[0], analyzers)
    assert not fails
    row_valid = torch.ones(96, dtype=torch.bool)
    rows = []
    for t in tables:
        packer = _ChunkPacker({n: t[n] for n in ("i", "x")})
        planes = [torch.from_numpy(p) for p in packer.pack(0, 96)]
        vals = packer.unpack_vals(*planes, row_valid)
        rows.append([op.update(vals, row_valid, 96, 96) for op in ops])
    fold = _DeviceFoldPlan(ops, rows[0], 1, "cpu")
    merged = fold.single_rows(fold.flatten_rows(rows, row_valid))
    for k, partials in enumerate(rows):
        alone = fold.single(fold.flatten(partials, row_valid))
        assert merged[k].numpy().tobytes() == alone.numpy().tobytes(), f"member {k}"


def test_single_rows_keeps_one_tiling_for_the_largest_k():
    """single_rows tiles its masks, identities and indices once, for the most
    rows seen yet; a smaller K reads a prefix of that tiling and a larger K
    replaces it, and every row keeps its own bits."""
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops.scan_engine import _ChunkPacker, _DeviceFoldPlan

    analyzers = [a for a in _families() if not isinstance(a, ApproxQuantile)]
    tables = [_table(n=64, seed=320 + s) for s in range(6)]
    ops, _, _ = AnalysisRunner._build_scan_ops(tables[0], analyzers)
    row_valid = torch.ones(64, dtype=torch.bool)
    rows = []
    for t in tables:
        packer = _ChunkPacker({n: t[n] for n in ("i", "x")})
        vals = packer.unpack_vals(*[torch.from_numpy(p) for p in packer.pack(0, 64)],
                                  row_valid)
        rows.append([op.update(vals, row_valid, 64, 64) for op in ops])
    fold = _DeviceFoldPlan(ops, rows[0], 1, "cpu")
    alone = [fold.single(fold.flatten(r, row_valid)).numpy().tobytes() for r in rows]
    assert fold.elem_size
    widths = []
    for K in (4, 2, 4, 6, 1, 6):
        merged = fold.single_rows(fold.flatten_rows(rows[:K], row_valid))
        assert [m.numpy().tobytes() for m in merged] == alone[:K], f"K={K}"
        widths.append(fold._tiled[0].numel() // fold.elem_size)
    assert widths == [4, 4, 4, 6, 6, 6]


@pytest.mark.cuda
def test_cuda_coalesced_batch_one_k1_launch_bit_identical():
    """On a card: a coalesced batch of 8 launches K1 once and its fold merge
    once, and each member is bit for bit its serial run there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and its merge are CUDA C++ with no CPU mode")
    analyzers = _families()
    tables = [_table(n=256, seed=400 + s) for s in range(8)]
    with use_device("cuda"):
        serial = _serial(tables, analyzers)
        launches, merges = masked_reduce.LAUNCHES, masked_reduce.MERGE_LAUNCHES
        served = _serve_one_batch(tables, analyzers, prefix="g")
    assert masked_reduce.LAUNCHES == launches + 1
    assert masked_reduce.MERGE_LAUNCHES == merges + 1
    for i, (s, c) in enumerate(zip(serial, served)):
        _assert_bit_identical(s, c, label=f"card member {i}")


# -- against the reference's service ----------------------------------------------------


def test_service_parity_with_the_reference():
    """Both packages' services over the same seeded tenants (the reference
    on one device, ``use_mesh(None)``): every metric within
    tests/torch_parity.py's bounds, and both coalesce."""
    import deequ_tpu.analyzers as ref_an
    import deequ_tpu_torch.analyzers as port_an
    from deequ_tpu.data.table import ColumnarTable as RefTable
    from deequ_tpu.ops.scan_engine import SCAN_STATS as REF_STATS
    from deequ_tpu.parallel.mesh import use_mesh as ref_use_mesh
    from deequ_tpu.serve import VerificationService as RefService
    from torch_parity import assert_metric_parity, port_table, ref_column

    def ref_table(seed, n=256):
        r = np.random.default_rng(seed)
        return RefTable([
            ref_column("x", "fractional", r.normal(100, 5, n), r.random(n) > 0.05),
            ref_column("i", "integral", r.integers(0, 50, n).astype(np.float64),
                       np.ones(n, bool)),
        ])

    def suite(pkg):
        return [pkg.Size(), pkg.Completeness("x"), pkg.Mean("x"), pkg.Sum("x"),
                pkg.StandardDeviation("x"), pkg.Mean("i"), pkg.Maximum("i"),
                pkg.Minimum("i"), pkg.ApproxCountDistinct("i")]

    refs = [ref_table(500 + s) for s in range(6)]
    with ref_use_mesh(None):
        ref_batches = REF_STATS.coalesced_batches
        ref_svc = RefService(start=False, max_batch=16)
        ref_futs = [ref_svc.submit(t, required_analyzers=suite(ref_an), tenant=f"r{i}")
                    for i, t in enumerate(refs)]
        ref_svc.start()
        ref_results = [f.result(timeout=120) for f in ref_futs]
        ref_svc.stop()
        assert REF_STATS.coalesced_batches > ref_batches
    port_batches = SCAN_STATS.coalesced_batches
    port_results = _serve_one_batch([port_table(t) for t in refs], suite(port_an), prefix="r")
    assert SCAN_STATS.coalesced_batches == port_batches + 1
    for ref_res, port_res in zip(ref_results, port_results):
        assert str(ref_res.status).split(".")[-1] == str(port_res.status).split(".")[-1]
        for ref_a, port_a in zip(suite(ref_an), suite(port_an)):
            assert_metric_parity(ref_res.metrics[ref_a], port_res.metrics[port_a])


def test_obs_and_serve_import_neither_jax_nor_the_reference():
    """The new packages keep the port's rule: torch and numpy, never jax
    and nothing of deequ_tpu."""
    import os
    import subprocess
    import sys

    code = (
        "import sys, deequ_tpu_torch.obs, deequ_tpu_torch.obs.export, "
        "deequ_tpu_torch.obs.registry, deequ_tpu_torch.serve, "
        "deequ_tpu_torch.serve.executor, deequ_tpu_torch.serve.plan_cache, "
        "deequ_tpu_torch.serve.admission, deequ_tpu_torch.serve.service\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'deequ_tpu' or m.startswith('deequ_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_argument_places_the_worker():
    """``device=`` places the worker on a device of its own, whatever the
    constructing thread's scope; ``verify`` submits and waits."""
    analyzers = [Size(), Mean("x")]
    want = VerificationSuite.run(_table(n=64, seed=5), [], required_analyzers=analyzers)
    with use_device(None):
        svc = VerificationService(device="cpu", max_batch=4, coalesce_window=0.0)
    try:
        result = svc.verify(_table(n=64, seed=5), required_analyzers=analyzers, tenant="d")
        assert result.device == "cpu"
        _assert_bit_identical(want, result, label="device-placed worker")
    finally:
        svc.stop(drain=False)


def test_inject_stall_freezes_the_heartbeat():
    """A scripted stall holds the worker before its next batch: the
    heartbeat stops for the stall, and the queued suite resolves after it."""
    import time

    svc = VerificationService(max_batch=4, coalesce_window=0.0)
    try:
        svc.inject_stall(0.3)
        time.sleep(0.05)  # the idle worker takes the stall
        beat = svc.heartbeat
        t0 = time.monotonic()
        future = svc.submit(_table(n=32, seed=9), required_analyzers=[Size()], tenant="s")
        future.result(timeout=60)
        assert future.resolved_at - t0 >= 0.2
        assert svc.heartbeat > beat
    finally:
        svc.stop(drain=False)


def test_packed_plan_declares_members_on_the_sort_route():
    """``plan_packed_scan``: the members' declarations and count on the
    plan, and the KLL op on its sort, never the select, as a serial scan
    of a table in memory runs it."""
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops.scan_plan import PackedMember, plan_packed_scan, plan_scan_ops

    table = _table(n=64, seed=1)
    ops, _, fails = AnalysisRunner._build_scan_ops(table, [ApproxQuantile("x", 0.5), Mean("x")])
    assert not fails
    members = [PackedMember(label="a"), PackedMember(label="b")]
    plan = plan_packed_scan(ops, members=members, select_kernel=True, chunk_rows=64,
                            platform="cpu")
    assert plan.tenants == 2 and plan.members == tuple(members)
    assert (plan.variant, plan.select_ops, plan.sort_ops) == ("sort", 0, 1)
    serial = plan_scan_ops(ops, None, False, True, 64, "cpu")
    assert (serial.variant, serial.sort_ops, serial.tenants) == ("sort", 1, 1)
