"""The port's run-level fault governance (``resilience/governance.py`` and
its charge sites in ``resilience/retry.py``, ``ops/scan_executors.py``,
``analyzers/runner.py`` and ``verification.py``) on the CPU: twins of the
governance tests of tests/test_chaos.py under the same names, and parity
with the reference.

The twins keep the reference's holds on its integer-valued table (every
fold sum exact in f64). The two that reshard a mesh,
``test_bisect_and_reshard_charge_one_budget`` and
``test_budget_exhaustion_mid_reshard_degrades_partial``, run over the
port's 8-member virtual mesh on the CPU (``parallel/mesh.py:virtual_mesh``),
where the reference runs over its 8 forced host devices.
``test_fault_state_scope_isolates_singletons_and_hook`` holds the port's
singletons (``DEVICE_HEALTH``, ``MESH_HEALTH``, ``RETRY_TELEMETRY``). The
chaos engine's tests wait for the port's tooling.

Port-only: the same fault schedule and budget give the same
``unverified_row_ranges``, exhaustion reason, ledger and partial metrics
in both packages (the reference on one device, ``use_mesh(None)``).
"""

import time

import numpy as np
import pytest

from deequ_tpu_torch.analyzers import Completeness, Maximum, Mean, Minimum, Size
from deequ_tpu_torch.analyzers.runner import AnalysisRunner
from deequ_tpu_torch.checks import Check, CheckLevel
from deequ_tpu_torch.data.streaming import stream_table
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.exceptions import (
    DeviceHangException,
    DeviceOOMException,
    RunBudgetExhaustedException,
)
from deequ_tpu_torch.ops.device_policy import DEVICE_HEALTH, MESH_HEALTH
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, install_scan_fault_hook
from deequ_tpu_torch.resilience import (
    RETRY_TELEMETRY,
    FaultInjectingScanHook,
    FaultSchedule,
    FlakyBatchSource,
    RetryPolicy,
    RunPolicy,
    current_run_budget,
    fault_state_scope,
    run_budget_scope,
)
from deequ_tpu_torch.verification import VerificationSuite

pytestmark = [pytest.mark.chaos, pytest.mark.torch_port]

FAST = RetryPolicy(max_attempts=4, base_delay=0.0005, max_delay=0.002)


@pytest.fixture(autouse=True)
def _on_cpu():
    import torch

    from deequ_tpu_torch import use_device

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    SCAN_STATS.reset()
    with use_device("cpu"):
        yield
    torch.set_num_threads(threads)


def int_table(n=2000, seed=3):
    """Integer-valued columns: every fold sum is exact in f64, so
    recovered runs are bit-identical to clean ones."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1000, n).astype(np.float64)
    mask = np.ones(n, dtype=np.bool_)
    mask[::97] = False
    return ColumnarTable(
        [
            Column("id", DType.INTEGRAL, values=np.arange(n, dtype=np.int64),
                   mask=np.ones(n, dtype=np.bool_)),
            Column("val", DType.FRACTIONAL, values=vals, mask=mask),
        ]
    )


def analyzers_for():
    return [Size(), Completeness("val"), Mean("val"), Minimum("val"), Maximum("val")]


def check_for():
    return Check(CheckLevel.ERROR, "chaos").has_size(lambda s: s >= 0)


# -- RunPolicy / RunBudget unit behaviour ---------------------------------------


def test_run_policy_validation():
    with pytest.raises(ValueError):
        RunPolicy(on_budget_exhausted="explode")
    with pytest.raises(ValueError):
        RunPolicy(run_deadline=-1.0)
    with pytest.raises(ValueError):
        VerificationSuite.on_data(int_table(8)).with_run_budget()


def test_budget_ledger_accounting_and_typed_exhaustion():
    budget = RunPolicy(max_total_attempts=2).arm()
    budget.charge("io_retry")
    budget.charge("oom_bisect")
    assert budget.attempts == 2
    assert budget.charges == {"io_retry": 1, "oom_bisect": 1}
    assert budget.exhausted_reason is None
    with pytest.raises(RunBudgetExhaustedException) as ei:
        budget.charge("cpu_fallback_refused")
    assert ei.value.reason == "max_total_attempts"
    assert ei.value.degraded  # the default policy mode
    assert ei.value.ledger["charges"] == {
        "io_retry": 1, "oom_bisect": 1, "cpu_fallback_refused": 1,
    }
    # once exhausted, EVERY further charge re-raises: a nested retry loop
    # that swallowed the first raise cannot keep spending
    with pytest.raises(RunBudgetExhaustedException):
        budget.charge("io_retry")
    assert budget.attempts == sum(budget.charges.values())


def test_budget_wall_deadline_exhausts():
    budget = RunPolicy(run_deadline=0.02, on_budget_exhausted="raise").arm()
    time.sleep(0.03)
    with pytest.raises(RunBudgetExhaustedException) as ei:
        budget.charge("io_retry")
    assert ei.value.reason == "run_deadline"
    assert not ei.value.degraded


def test_budget_scope_is_ambient_and_restores():
    assert current_run_budget() is None
    budget = RunPolicy(max_total_attempts=5).arm()
    with run_budget_scope(budget):
        assert current_run_budget() is budget
    assert current_run_budget() is None


def test_fault_state_scope_isolates_singletons_and_hook():
    DEVICE_HEALTH.reset()
    MESH_HEALTH.reset()
    outer_attempts = RETRY_TELEMETRY.attempts

    def hook(boundary, ctx):
        pass

    prev = install_scan_fault_hook(hook)
    try:
        with fault_state_scope():
            from deequ_tpu_torch.ops.device_policy import current_scan_fault_hook

            # the scope starts clean (hook removed, counters reset) ...
            assert current_scan_fault_hook() is None
            DEVICE_HEALTH.consecutive_faults = 99
            DEVICE_HEALTH.last_fault = DeviceOOMException("inside the scope")
            MESH_HEALTH.consecutive_faults[3] = 7
            RETRY_TELEMETRY.attempts += 41
        # ... and leaks nothing out
        assert DEVICE_HEALTH.consecutive_faults == 0
        assert DEVICE_HEALTH.last_fault is None
        assert MESH_HEALTH.consecutive_faults == {}
        assert RETRY_TELEMETRY.attempts == outer_attempts
        from deequ_tpu_torch.ops.device_policy import current_scan_fault_hook

        assert current_scan_fault_hook() is hook
    finally:
        install_scan_fault_hook(prev)


# -- one budget across the composed ladder ------------------------------------


def test_bisect_and_reshard_charge_one_budget():
    """Two scans over the 8-member virtual mesh, two different rungs (an
    OOM bisection, then a targeted member loss resharding the mesh): one
    ledger records both."""
    from deequ_tpu_torch.parallel.mesh import use_mesh, virtual_mesh

    mesh = virtual_mesh(8, "cpu")
    victim = mesh.device_ids[1]
    with fault_state_scope(), use_mesh(mesh):
        hook = FaultInjectingScanHook({0: ("oom", 2), 1: ("lost", 1, victim)}, relative=True)
        install_scan_fault_hook(hook)
        budget = RunPolicy(max_total_attempts=10).arm()
        with run_budget_scope(budget):
            ctx1 = AnalysisRunner.do_analysis_run(int_table(seed=1), analyzers_for())
            ctx2 = AnalysisRunner.do_analysis_run(int_table(seed=2), analyzers_for())
        assert all(m.value.is_success for m in ctx1.all_metrics())
        assert all(m.value.is_success for m in ctx2.all_metrics())
        assert budget.charges.get("oom_bisect") == 2
        assert budget.charges.get("mesh_reshard") == 1
        assert budget.attempts == sum(budget.charges.values())
        assert budget.exhausted_reason is None


def test_budget_exhaustion_mid_reshard_degrades_partial():
    """A zero budget over the 8-member virtual mesh: the first reshard
    charge exhausts it mid-rung, and the run degrades to a partial result
    with every row unverified."""
    from deequ_tpu_torch.parallel.mesh import use_mesh, virtual_mesh

    mesh = virtual_mesh(8, "cpu")
    victim = mesh.device_ids[2]
    table = int_table()
    with fault_state_scope(), use_mesh(mesh):
        hook = FaultInjectingScanHook(
            {0: ("lost", FaultSchedule.PERMANENT, victim)}, relative=True
        )
        install_scan_fault_hook(hook)
        result = VerificationSuite.do_verification_run(
            table, [check_for()], analyzers_for(),
            max_total_attempts=0, on_budget_exhausted="degrade",
        )
    assert result.run_budget["exhausted"] == "max_total_attempts"
    assert result.run_budget["charges"] == {"mesh_reshard": 1}
    assert result.unverified_row_ranges == [(0, table.num_rows)]
    for metric in result.metrics.values():
        assert isinstance(metric.value.exception, RunBudgetExhaustedException)


def test_io_retries_and_ladder_share_the_budget():
    """A streaming run whose batch reads retry AND whose scan OOMs:
    io_retry and oom_bisect charges land on the same ledger (a stream's
    per-batch scans never get their own)."""
    table = int_table()
    with fault_state_scope():
        hook = FaultInjectingScanHook({1: ("oom", 1)}, relative=True)
        install_scan_fault_hook(hook)
        schedule = FaultSchedule(fail={("batch", 0): 2})
        from deequ_tpu_torch.data.source import TableBatchSource
        from deequ_tpu_torch.data.streaming import StreamingTable

        stream = StreamingTable(FlakyBatchSource(TableBatchSource(table, 500), schedule))
        result = VerificationSuite.do_verification_run(
            stream, [check_for()], analyzers_for(),
            on_batch_error="skip", retry_policy=FAST, max_total_attempts=10,
        )
    assert result.status.name != "ERROR"
    assert result.run_budget["charges"]["io_retry"] == 2
    assert result.run_budget["charges"]["oom_bisect"] == 1
    assert result.run_budget["attempts"] == 3
    assert result.run_budget["exhausted"] is None
    # the scan_stats delta mirrors the ledger
    assert result.scan_stats["budget_charges"] == 3
    assert result.scan_stats["budget_exhaustions"] == 0
    # and the retry telemetry agrees with the io_retry charges
    assert result.retry_stats["attempts"] == 2


# -- degradation to partial results ------------------------------------------


def test_budget_exhaustion_mid_bisection_degrades_partial():
    table = int_table()
    with fault_state_scope():
        hook = FaultInjectingScanHook({0: ("oom", FaultSchedule.PERMANENT)}, relative=True)
        install_scan_fault_hook(hook)
        result = VerificationSuite.do_verification_run(
            table, [check_for()], analyzers_for(),
            max_total_attempts=2, on_budget_exhausted="degrade",
        )
    # the run COMPLETED (no raise), reports the exact unverified range,
    # and every analyzer carries the typed exhaustion failure
    assert result.run_budget["exhausted"] == "max_total_attempts"
    assert result.unverified_row_ranges == [(0, table.num_rows)]
    kinds = [e["kind"] for e in result.device_events]
    assert "budget_exhausted" in kinds and "oom_bisect" in kinds
    for metric in result.metrics.values():
        assert metric.value.is_failure
        assert isinstance(metric.value.exception, RunBudgetExhaustedException)
    assert result.scan_stats["budget_exhaustions"] == 1


def test_streaming_budget_exhaustion_yields_exact_partial():
    """Mid-stream exhaustion: the batches folded before the budget ran out
    finalize into REAL metrics; the tail is reported unverified with an
    exact batch-aligned range."""
    table = int_table()
    with fault_state_scope():
        hook = FaultInjectingScanHook({2: ("oom", FaultSchedule.PERMANENT)}, relative=True)
        install_scan_fault_hook(hook)
        result = VerificationSuite.do_verification_run(
            stream_table(table, 500), [check_for()], analyzers_for(),
            on_batch_error="skip", retry_policy=FAST,
            max_total_attempts=2, on_budget_exhausted="degrade",
        )
    assert result.run_budget["exhausted"] == "max_total_attempts"
    assert result.unverified_row_ranges == [(1000, 2000)]
    by_name = {str(a): m for a, m in result.metrics.items()}
    size = by_name["Size(where=None)"]
    assert size.value.is_success and size.value.get() == 1000.0
    # the partial metrics cover EXACTLY the verified prefix
    expected_mean = float(np.mean(table["val"].values[:1000][table["val"].mask[:1000]]))
    mean = by_name["Mean(column='val', where=None)"]
    assert mean.value.is_success and mean.value.get() == expected_mean


def test_stream_cannot_exceed_attempts_by_paying_per_batch():
    """The per-batch retries of a stream share ONE max_total_attempts: two
    flaky batches needing 2 retries each exhaust a 3-attempt budget."""
    table = int_table()
    with fault_state_scope():
        schedule = FaultSchedule(fail={("batch", 0): 2, ("batch", 2): 2})
        from deequ_tpu_torch.data.source import TableBatchSource
        from deequ_tpu_torch.data.streaming import StreamingTable

        stream = StreamingTable(FlakyBatchSource(TableBatchSource(table, 500), schedule))
        result = VerificationSuite.do_verification_run(
            stream, [check_for()], analyzers_for(),
            on_batch_error="skip", retry_policy=FAST,
            max_total_attempts=3, on_budget_exhausted="degrade",
        )
    assert result.run_budget["exhausted"] == "max_total_attempts"
    assert result.run_budget["charges"] == {"io_retry": 4}
    # batches 0 and 1 were verified before the budget died on batch 2
    assert result.unverified_row_ranges == [(1000, 2000)]


@pytest.mark.parametrize("attempts", [10, 2], ids=["within", "exhausted"])
def test_plain_stream_read_retries_charge_the_run_budget(attempts):
    """A stream read by the plain fused scan (``on_batch_error="fail"``):
    its batches come off a reader thread, which re-enters the run's
    budget, so the read retries charge the run's ledger — and exhaust it
    — as the reference's do. The same ledger, rows and metrics in both
    packages."""
    from deequ_tpu.analyzers import Mean as RefMean
    from deequ_tpu.analyzers import Size as RefSize
    from deequ_tpu.checks import Check as RefCheck
    from deequ_tpu.checks import CheckLevel as RefLevel
    from deequ_tpu.data.source import TableBatchSource as RefTableSource
    from deequ_tpu.data.streaming import StreamingTable as RefStreamingTable
    from deequ_tpu.parallel.mesh import use_mesh
    from deequ_tpu.resilience import FaultSchedule as RefSchedule
    from deequ_tpu.resilience import FlakyBatchSource as RefFlaky
    from deequ_tpu.resilience import RetryPolicy as RefPolicy
    from deequ_tpu.resilience import fault_state_scope as ref_scope
    from deequ_tpu.verification import VerificationSuite as RefSuite
    from deequ_tpu_torch.analyzers import Size as PortSize
    from deequ_tpu_torch.data.source import TableBatchSource
    from deequ_tpu_torch.data.streaming import StreamingTable

    table = int_table()
    fail = {("batch", 0): 2, ("batch", 2): 1}
    with fault_state_scope():
        stream = StreamingTable(FlakyBatchSource(TableBatchSource(table, 500),
                                                 FaultSchedule(fail=fail)))
        got = VerificationSuite.do_verification_run(
            stream, [check_for()], [PortSize(), Mean("val")],
            retry_policy=FAST, max_total_attempts=attempts,
        )
    with ref_scope(), use_mesh(None):
        ref_stream = RefStreamingTable(RefFlaky(RefTableSource(_ref_table(table), 500),
                                                RefSchedule(fail=fail)))
        want = RefSuite.do_verification_run(
            ref_stream, [RefCheck(RefLevel.ERROR, "chaos").has_size(lambda s: s >= 0)],
            [RefSize(), RefMean("val")],
            retry_policy=RefPolicy(max_attempts=4, base_delay=0.0005, max_delay=0.002),
            max_total_attempts=attempts,
        )
    assert got.run_budget["charges"] == {"io_retry": 3}
    assert got.scan_stats["budget_charges"] == 3
    if attempts == 10:
        assert got.run_budget["exhausted"] is None and got.unverified_row_ranges == []
        assert got.retry_stats["retries"] == 3
    else:
        assert got.run_budget["exhausted"] == "max_total_attempts"
        assert got.unverified_row_ranges == [(0, table.num_rows)]
        for metric in got.metrics.values():
            assert isinstance(metric.value.exception, RunBudgetExhaustedException)
    assert _outcome(got) == _outcome(want)


def test_raise_mode_propagates_typed():
    table = int_table()
    with fault_state_scope():
        hook = FaultInjectingScanHook({0: ("oom", FaultSchedule.PERMANENT)}, relative=True)
        install_scan_fault_hook(hook)
        with pytest.raises(RunBudgetExhaustedException) as ei:
            VerificationSuite.do_verification_run(
                table, [check_for()], analyzers_for(),
                max_total_attempts=1, on_budget_exhausted="raise",
            )
        assert not ei.value.degraded
        assert ei.value.ledger["charges"] == {"oom_bisect": 2}


def test_run_deadline_caps_watchdog_so_hangs_terminate():
    """A hung step with NO device_deadline still ends inside run_deadline:
    the budget arms the attempt's watchdog with the wall left; the refused
    CPU rung's charge then finds the budget spent, and the run degrades to
    a typed partial result."""
    table = int_table(500)
    with fault_state_scope():
        hook = FaultInjectingScanHook({0: ("hang", 1)}, hang_seconds=30.0, relative=True)
        install_scan_fault_hook(hook)
        t0 = time.monotonic()
        result = VerificationSuite.do_verification_run(
            table, [check_for()], analyzers_for(),
            on_device_error="fallback", run_deadline=1.0, on_budget_exhausted="degrade",
        )
        elapsed = time.monotonic() - t0
    assert elapsed < 8.0
    assert SCAN_STATS.watchdog_timeouts >= 1
    assert result.run_budget["exhausted"] == "run_deadline"
    assert result.unverified_row_ranges == [(0, table.num_rows)]
    for metric in result.metrics.values():
        assert isinstance(metric.value.exception, RunBudgetExhaustedException)


def test_healthy_run_charges_nothing():
    result = VerificationSuite.do_verification_run(
        int_table(), [check_for()], analyzers_for(),
        run_deadline=30.0, max_total_attempts=5,
    )
    assert result.status.name == "SUCCESS"
    assert result.run_budget["attempts"] == 0
    assert result.run_budget["charges"] == {}
    assert result.scan_stats["budget_charges"] == 0


# -- port-only ------------------------------------------------------------------


def _ref_table(table):
    from deequ_tpu.data.table import Column as RefColumn
    from deequ_tpu.data.table import ColumnarTable as RefTable
    from deequ_tpu.data.table import DType as RefDType

    return RefTable([
        RefColumn("id", RefDType.INTEGRAL, values=table["id"].values.copy(),
                  mask=table["id"].mask.copy()),
        RefColumn("val", RefDType.FRACTIONAL, values=table["val"].values.copy(),
                  mask=table["val"].mask.copy()),
    ])


def _ref_run(table, faults, streamed: bool, **kwargs):
    from deequ_tpu.analyzers import Completeness as RC
    from deequ_tpu.analyzers import Maximum as RMax
    from deequ_tpu.analyzers import Mean as RM
    from deequ_tpu.analyzers import Minimum as RMin
    from deequ_tpu.analyzers import Size as RS
    from deequ_tpu.checks import Check as RCheck
    from deequ_tpu.checks import CheckLevel as RLevel
    from deequ_tpu.data.streaming import stream_table as ref_stream
    from deequ_tpu.ops.scan_engine import install_scan_fault_hook as ref_install
    from deequ_tpu.parallel.mesh import use_mesh
    from deequ_tpu.resilience import FaultInjectingScanHook as RefHook
    from deequ_tpu.resilience import RetryPolicy as RefPolicy
    from deequ_tpu.resilience import fault_state_scope as ref_scope
    from deequ_tpu.verification import VerificationSuite as RefSuite

    rtable = _ref_table(table)
    data = ref_stream(rtable, 500) if streamed else rtable
    with ref_scope(), use_mesh(None):
        ref_install(RefHook(faults, relative=True))
        if streamed:
            kwargs.update(on_batch_error="skip",
                          retry_policy=RefPolicy(max_attempts=4, base_delay=0.0005,
                                                 max_delay=0.002))
        return RefSuite.do_verification_run(
            data, [RCheck(RLevel.ERROR, "chaos").has_size(lambda s: s >= 0)],
            [RS(), RC("val"), RM("val"), RMin("val"), RMax("val")], **kwargs,
        )


def _outcome(result):
    metrics = {}
    for m in result.metrics.values():
        metrics[(m.name, m.instance)] = (
            m.value.get() if m.value.is_success else type(m.value.exception).__name__
        )
    return (
        [tuple(r) for r in result.unverified_row_ranges],
        result.run_budget["exhausted"],
        result.run_budget["charges"],
        [e["kind"] for e in result.device_events],
        metrics,
    )


@pytest.mark.parametrize(
    "faults,streamed,attempts",
    [
        ({0: ("oom", FaultSchedule.PERMANENT)}, False, 2),
        ({2: ("oom", FaultSchedule.PERMANENT)}, True, 2),
        ({1: ("oom", 1), 3: ("oom", FaultSchedule.PERMANENT)}, True, 4),
        ({1: ("oom", 2)}, True, 5),
    ],
    ids=["in_memory", "stream_batch_2", "stream_batch_3", "stream_within_budget"],
)
def test_budget_partial_result_parity_with_reference(faults, streamed, attempts):
    """The same schedule and budget: the same unverified rows, exhaustion
    reason, ledger, rungs and partial metrics in both packages."""
    table = int_table()
    kwargs = dict(max_total_attempts=attempts, on_budget_exhausted="degrade")
    want = _outcome(_ref_run(table, faults, streamed, **dict(kwargs)))
    with fault_state_scope():
        install_scan_fault_hook(FaultInjectingScanHook(faults, relative=True))
        data = stream_table(table, 500) if streamed else table
        extra = dict(on_batch_error="skip", retry_policy=FAST) if streamed else {}
        got = _outcome(VerificationSuite.do_verification_run(
            data, [check_for()], analyzers_for(), **kwargs, **extra))
    assert got == want


def test_deadline_arms_no_watchdog_on_a_healthy_run():
    """A governed healthy run: the attempt runs under the budget's watchdog
    and charges nothing; an armed device deadline on a healthy run raises
    no hang."""
    with fault_state_scope():
        result = VerificationSuite.do_verification_run(
            int_table(), [check_for()], analyzers_for(),
            run_deadline=30.0, device_deadline=30.0,
        )
    assert result.status.name == "SUCCESS"
    assert result.run_budget["charges"] == {}
    assert result.device_events == []
    assert SCAN_STATS.watchdog_timeouts == 0
    with pytest.raises(DeviceHangException):
        with fault_state_scope():
            install_scan_fault_hook(FaultInjectingScanHook({0: ("hang", 1)}, hang_seconds=2.0))
            from deequ_tpu_torch.ops.scan_engine import run_scan

            table = int_table(300)
            run_scan(table, [a.scan_op(table) for a in analyzers_for()], "cpu",
                     device_deadline=0.1)
