"""The port's device fault tolerance (``exceptions.py``,
``ops/device_policy.py``, ``ops/scan_executors.py``, ``ops/scan_engine.py``)
on the CPU: twins of the 30 tests of tests/test_device_faults.py under the
same names, and parity with the reference.

The twins keep the reference's holds, on integer-valued tables (every
partial sum exact in f64, so a bisected scan gives a clean run's bits at
any chunk size), run on the CPU (``use_device("cpu")``) with faults
scripted at the execute seam by ``FaultInjectingScanHook``. Two changes
are the port's:

- the classifier's message table holds torch and CUDA messages (CUDA out
  of memory, ``cudaErrorMemoryAllocation``, an ``nvcc``/``ptxas`` failure,
  a missing kernel image, an illegal address, an unspecified launch
  failure, an uncorrectable ECC error) in place of XLA status strings;
- the six tests that hold the reference's CPU rung or its breaker
  (``test_persistent_oom_with_fallback_lands_on_cpu``,
  ``test_streaming_persistent_failure_fallback_cpu``,
  ``test_device_health_forces_fallback_after_repeated_faults``,
  ``test_fallback_evicts_accelerator_residency``,
  ``test_device_health_half_open_probe``,
  ``test_watchdog_hang_feeds_fallback_policy``) hold
  ``DeviceFallbackRefusedException`` and the ``cpu_fallback_refused``
  event instead: the port never moves a CUDA run onto the CPU.

Port-only: the same hook schedule on the same integer table gives the same
degradation kinds, chunk sizes, bisection counts and metrics in both
packages (the reference on one device, ``use_mesh(None)``); a hung
worker abandoned by the watchdog launches nothing and counts no fetch when
it wakes; a failed attempt's frames are released before the retry.
"""

import gc
import math
import time
import warnings
import weakref
from contextlib import contextmanager

import numpy as np
import pytest

from deequ_tpu.analyzers import (
    Completeness as RefCompleteness,
    Maximum as RefMaximum,
    Mean as RefMean,
    Minimum as RefMinimum,
    Size as RefSize,
)
from deequ_tpu.data.table import Column as RefColumn
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu.data.table import DType as RefDType
from deequ_tpu.ops import scan_engine as ref_engine
from deequ_tpu.ops.device_policy import DEVICE_HEALTH as REF_DEVICE_HEALTH
from deequ_tpu.parallel.mesh import use_mesh
from deequ_tpu.resilience import FaultInjectingScanHook as RefHook
from deequ_tpu_torch.checks import Check, CheckLevel, CheckStatus
from deequ_tpu_torch.data.fs import (
    InMemoryFileSystem,
    _REGISTRY,
    register_filesystem,
)
from deequ_tpu_torch.data.streaming import StreamingTable, stream_table
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.exceptions import (
    DeviceCompileException,
    DeviceException,
    DeviceFallbackRefusedException,
    DeviceHangException,
    DeviceLostException,
    DeviceOOMException,
    GroupBudgetIgnoredWarning,
    MetricCalculationRuntimeException,
    ReusingNotPossibleResultsMissingException,
    classify_device_error,
)
from deequ_tpu_torch.ops.device_policy import DEVICE_HEALTH
from deequ_tpu_torch.ops.scan_engine import (
    SCAN_STATS,
    install_scan_fault_hook,
    run_scan,
)
from deequ_tpu_torch.resilience import (
    FaultInjectingFileSystem,
    FaultInjectingScanHook,
    FaultSchedule,
    FlakyBatchSource,
    InjectedDeviceError,
    RetryPolicy,
)
from deequ_tpu_torch.verification import VerificationSuite

pytestmark = [pytest.mark.devicefault, pytest.mark.torch_port]

CPU = "cpu"
FAST = RetryPolicy(max_attempts=4, base_delay=0.0005, max_delay=0.002)


@pytest.fixture(autouse=True)
def _clean_device_state():
    """Each test starts on the CPU with a healthy device, fresh counters
    and no installed hook."""
    import torch

    from deequ_tpu_torch import use_device

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    SCAN_STATS.reset()
    DEVICE_HEALTH.reset()
    prev = install_scan_fault_hook(None)
    with use_device(CPU):
        yield
    install_scan_fault_hook(prev)
    DEVICE_HEALTH.reset()
    torch.set_num_threads(threads)


@contextmanager
def scan_faults(hook):
    prev = install_scan_fault_hook(hook)
    try:
        yield hook
    finally:
        install_scan_fault_hook(prev)


def int_table(n=2000, seed=0):
    """Integer-valued fractional and integral columns: every partial sum
    is exact in f64, so "bit-identical across chunkings" is fair."""
    rng = np.random.default_rng(seed)
    return ColumnarTable(
        [
            Column("x", DType.FRACTIONAL, values=rng.integers(0, 100, n).astype(np.float64)),
            Column("g", DType.INTEGRAL, values=rng.integers(0, 7, n).astype(np.int64)),
        ]
    )


def checks_for(n):
    return (
        Check(CheckLevel.ERROR, "devicefault")
        .is_complete("x")
        .has_size(lambda s: s == n)
        .has_mean("x", lambda v: v > 0)
        .has_min("x", lambda v: v >= 0)
        .has_uniqueness(["g"], lambda v: v >= 0.0)
    )


def metric_values(result):
    return {
        repr(a): m.value.get()
        for a, m in result.metrics.items()
        if m.value.is_success
    }


def basic_analyzers():
    from deequ_tpu_torch.analyzers import Completeness, Maximum, Mean, Minimum, Size

    return [Size(), Completeness("x"), Mean("x"), Minimum("x"), Maximum("x")]


def persist(table, **kwargs):
    from deequ_tpu_torch.ops.scan_engine import persist_table

    return persist_table(table, CPU, max_bytes=1 << 30, **kwargs)


def leaves_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))


# -- taxonomy ----------------------------------------------------------------


@pytest.mark.parametrize(
    "message,expected",
    [
        (
            "CUDA out of memory. Tried to allocate 16.00 GiB. GPU 0 has a total "
            "capacity of 79.19 GiB of which 2.31 GiB is free.",
            DeviceOOMException,
        ),
        ("cudaErrorMemoryAllocation: out of memory", DeviceOOMException),
        (
            "nvcc failed (1) building masked_reduce.cu: ptxas error : Entry "
            "function 'k1_tiles' uses too much shared data",
            DeviceCompileException,
        ),
        (
            "CUDA error: no kernel image is available for execution on the device",
            DeviceCompileException,
        ),
        ("CUDA error: an illegal memory access was encountered", DeviceLostException),
        ("CUDA error: unspecified launch failure", DeviceLostException),
        ("CUDA error: uncorrectable ECC error encountered", DeviceLostException),
    ],
)
def test_classify_runtime_messages(message, expected):
    """torch and CUDA runtime messages map onto the typed taxonomy."""
    typed = classify_device_error(RuntimeError(message), "execute")
    assert isinstance(typed, expected)
    assert typed.boundary == "execute"
    assert isinstance(typed, MetricCalculationRuntimeException)
    assert isinstance(typed.__cause__, RuntimeError)


def test_classify_preserves_boundary_and_trace_default():
    # the positional trace default applies only to torch's own CUDA error
    # types (a class of that name), never to plain RuntimeErrors
    AcceleratorError = type("AcceleratorError", (RuntimeError,), {})
    typed = classify_device_error(AcceleratorError("something inscrutable"), "trace")
    assert isinstance(typed, DeviceCompileException)
    assert typed.boundary == "trace"
    # a plain application RuntimeError with no device pattern stays
    # unclassified at the trace boundary — it is a bug, not weather
    assert classify_device_error(RuntimeError("app bug in update fn"), "trace") is None


def test_classify_memoryerror_is_oom():
    """A host MemoryError while packing a chunk classifies as OOM: smaller
    chunks are exactly the right response there too."""
    typed = classify_device_error(MemoryError("cannot allocate"), "transfer")
    assert isinstance(typed, DeviceOOMException)
    assert typed.boundary == "transfer"


def test_classify_ignores_logic_errors():
    assert classify_device_error(ValueError("bug, not weather")) is None
    assert classify_device_error(KeyError("missing")) is None
    # an unrecognisable RuntimeError at the execute boundary is not
    # guessed at — it propagates untyped rather than mis-degrade
    assert classify_device_error(RuntimeError("some app bug")) is None


def test_classify_passes_through_already_typed():
    exc = DeviceOOMException("already typed", boundary="execute")
    assert classify_device_error(exc) is exc


def test_reusing_exception_lives_in_the_taxonomy():
    """ReusingNotPossibleResultsMissingException lives in exceptions.py
    (the runner's name is the same class) and stays a RuntimeError."""
    from deequ_tpu_torch.analyzers import runner

    assert (
        runner.ReusingNotPossibleResultsMissingException
        is ReusingNotPossibleResultsMissingException
    )
    assert issubclass(
        ReusingNotPossibleResultsMissingException, MetricCalculationRuntimeException
    )
    assert issubclass(ReusingNotPossibleResultsMissingException, RuntimeError)


# -- OOM chunk bisection -----------------------------------------------------


def test_oom_bisection_in_memory_bit_identical():
    """A transient OOM on an in-memory fused scan halves the chunk and
    retries; metrics match the clean run exactly and the rung is
    recorded."""
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    table = int_table(2000)
    analyzers = basic_analyzers()
    clean = AnalysisRunner.do_analysis_run(table, analyzers)
    clean_vals = {repr(a): m.value.get() for a, m in clean.metric_map.items()}

    SCAN_STATS.reset()
    with scan_faults(FaultInjectingScanHook(faults={0: ("oom", 1)})) as hook:
        ctx = AnalysisRunner.do_analysis_run(table, analyzers)
    vals = {repr(a): m.value.get() for a, m in ctx.metric_map.items()}
    assert vals == clean_vals
    assert hook.injected == [("oom", 0, 0)]
    assert SCAN_STATS.oom_bisections == 1
    assert SCAN_STATS.bisection_depth == 1
    (event,) = [e for e in SCAN_STATS.degradation_events if e["kind"] == "oom_bisect"]
    assert event["chunk_to"] < event["chunk_from"]


def test_oom_bisection_goes_deeper_on_repeat():
    """Two consecutive OOMs bisect twice (chunk / 4) before succeeding."""
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    table = int_table(2000)
    analyzers = basic_analyzers()
    clean_vals = {
        repr(a): m.value.get()
        for a, m in AnalysisRunner.do_analysis_run(table, analyzers).metric_map.items()
    }
    SCAN_STATS.reset()
    with scan_faults(FaultInjectingScanHook(faults={0: ("oom", 2)})):
        ctx = AnalysisRunner.do_analysis_run(table, analyzers)
    assert {repr(a): m.value.get() for a, m in ctx.metric_map.items()} == clean_vals
    assert SCAN_STATS.oom_bisections == 2
    assert SCAN_STATS.bisection_depth == 2


def test_oom_evicts_device_residency():
    """The first response to an OOM is freeing the persisted table's
    residency — the biggest tenant — before retrying."""
    table = int_table(2000)
    persist(table)
    assert table._device_cache is not None
    with scan_faults(FaultInjectingScanHook(faults={0: ("oom", 1)})):
        result = run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU)
    assert len(result) == 5
    assert table._device_cache is None
    (event,) = [e for e in SCAN_STATS.degradation_events if e["kind"] == "oom_bisect"]
    assert event["evicted_bytes"] > 0


def test_persistent_oom_without_fallback_raises_typed():
    """An OOM at every chunk size bottoms out at the bisection floor and
    raises the typed exception (which the runner maps onto failure metrics
    by the shared-scan rule)."""
    table = int_table(500)
    ops = [a.scan_op(table) for a in basic_analyzers()]
    with scan_faults(FaultInjectingScanHook(faults={0: ("oom", math.inf)})):
        with pytest.raises(DeviceOOMException):
            run_scan(table, ops, CPU)
    assert SCAN_STATS.oom_bisections >= 1  # it tried before giving up


def test_persistent_oom_with_fallback_lands_on_cpu():
    """Where the reference re-runs the scan on its CPU, the port refuses:
    DeviceFallbackRefusedException from the OOM at the floor, one
    ``cpu_fallback_refused`` event, ``fallback_refused`` counted."""
    table = int_table(500)
    with scan_faults(FaultInjectingScanHook(faults={0: ("oom", math.inf)})) as hook:
        with pytest.raises(DeviceFallbackRefusedException) as exc:
            run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU,
                     on_device_error="fallback")
    assert isinstance(exc.value.__cause__, DeviceOOMException)
    assert exc.value.reason == "oom_at_bisection_floor"
    assert SCAN_STATS.fallback_refused == 1
    kinds = [e["kind"] for e in SCAN_STATS.degradation_events]
    assert "oom_bisect" in kinds and kinds[-1] == "cpu_fallback_refused"
    assert SCAN_STATS.degradation_events[-1]["chunk"] == 64
    assert len(hook.injected) == SCAN_STATS.oom_bisections + 1


# -- acceptance: streaming run, OOM at batch k -------------------------------


def test_streaming_oom_at_batch_k_completes_via_bisection():
    """An OOM injected at batch 3 of a streaming run: the run completes by
    bisection, one degradation event, every metric the fault-free run's
    bits."""
    n, batch_rows = 2000, 200
    table = int_table(n)
    check = checks_for(n)

    ref = (
        VerificationSuite.on_data(stream_table(table, batch_rows))
        .add_check(check)
        .on_batch_error("skip")  # the same resilient loop as the faulted run
        .run()
    )
    assert ref.status == CheckStatus.SUCCESS

    SCAN_STATS.reset()
    with scan_faults(FaultInjectingScanHook(faults={3: ("oom", 1)})) as hook:
        result = (
            VerificationSuite.on_data(stream_table(table, batch_rows))
            .add_check(check)
            .on_batch_error("skip")
            .run()
        )
    assert result.status == CheckStatus.SUCCESS
    assert hook.injected == [("oom", 3, 0)]
    assert len(result.skipped_batches) == 0  # degraded, nothing dropped
    assert SCAN_STATS.oom_bisections >= 1
    assert len(SCAN_STATS.degradation_events) >= 1
    assert [e["kind"] for e in result.device_events] == ["oom_bisect"]
    assert metric_values(result) == metric_values(ref)


def test_streaming_persistent_failure_fallback_cpu():
    """A dead card under ``on_device_error("fallback")``: where the
    reference passes the suite on its CPU, every batch scan's analyzers
    fail with DeviceFallbackRefusedException (caused by the lost device),
    the refusal is an event of the run, and the grouping analyzer, which
    runs no fused scan, still gives the fault-free run's value."""
    n, batch_rows = 2000, 200
    table = int_table(n)
    check = checks_for(n)
    ref = (
        VerificationSuite.on_data(stream_table(table, batch_rows))
        .add_check(check)
        .on_batch_error("skip")
        .run()
    )

    SCAN_STATS.reset()
    dead = {i: ("lost", FaultSchedule.PERMANENT) for i in range(n // batch_rows)}
    with scan_faults(FaultInjectingScanHook(faults=dead)):
        result = (
            VerificationSuite.on_data(stream_table(table, batch_rows))
            .add_check(check)
            .on_device_error("fallback")
            .run()
        )
    assert result.status == CheckStatus.ERROR
    assert SCAN_STATS.fallback_refused >= 1
    assert any(e["kind"] == "cpu_fallback_refused" for e in result.device_events)
    failed = {repr(a): m for a, m in result.metrics.items() if m.value.is_failure}
    assert failed
    for m in failed.values():
        assert isinstance(m.value.exception, DeviceFallbackRefusedException)
        assert isinstance(m.value.exception.__cause__, DeviceLostException)
    survivors = metric_values(result)
    assert survivors and all(ref_value == metric_values(ref)[k]
                             for k, ref_value in survivors.items())


def test_streaming_device_fault_fail_policy_is_typed_not_raw():
    """Without fallback, a dead card fails the pass's analyzers with the
    typed exception — callers never see raw runtime strings."""
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    table = int_table(400)
    with scan_faults(
        FaultInjectingScanHook(faults={i: ("lost", FaultSchedule.PERMANENT) for i in range(4)})
    ):
        ctx = AnalysisRunner.do_analysis_run(
            stream_table(table, 100), basic_analyzers(), on_batch_error="skip",
        )
    failures = [m for m in ctx.all_metrics() if m.value.is_failure]
    assert failures
    for m in failures:
        assert isinstance(m.value.exception, DeviceLostException)


def test_device_health_forces_fallback_after_repeated_faults():
    """A card that faults repeatedly opens the breaker: the next
    ``"fallback"`` scan is refused up front ("unhealthy_backend") without a
    single step on the card; a clean pass on the card closes it."""
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    table = int_table(300)
    analyzers = basic_analyzers()
    dead = FaultInjectingScanHook(
        faults={i: ("lost", FaultSchedule.PERMANENT) for i in range(10)}
    )
    with scan_faults(dead):
        for _ in range(DEVICE_HEALTH.threshold):
            ctx = AnalysisRunner.do_analysis_run(table, analyzers, on_device_error="fallback")
            assert all(isinstance(m.value.exception, DeviceFallbackRefusedException)
                       for m in ctx.all_metrics())
    assert DEVICE_HEALTH.should_force_fallback()
    SCAN_STATS.reset()
    with scan_faults(FaultInjectingScanHook()) as watcher:  # records calls only
        ctx = AnalysisRunner.do_analysis_run(table, analyzers, on_device_error="fallback")
    assert watcher.calls == []  # refused without touching the card
    assert any(
        e["kind"] == "cpu_fallback_refused" and e.get("reason") == "unhealthy_backend"
        for e in SCAN_STATS.degradation_events
    )
    for m in ctx.all_metrics():
        assert isinstance(m.value.exception, DeviceFallbackRefusedException)
        assert isinstance(m.value.exception.__cause__, DeviceLostException)
    # a clean pass on the card forgives
    AnalysisRunner.do_analysis_run(table, analyzers)
    assert not DEVICE_HEALTH.should_force_fallback()


def test_fallback_evicts_accelerator_residency():
    """A lost device under ``"fallback"``: the refusal drops the table's
    residency on the card that failed, and the typed refusal carries the
    loss; the next run, with the card healthy again, gives the persisted
    run's bits from the host."""
    table = int_table(1000)
    persist(table)
    clean = run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU)
    persist(table)
    with scan_faults(FaultInjectingScanHook(faults={0: ("lost", math.inf)})):
        with pytest.raises(DeviceFallbackRefusedException) as exc:
            run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU,
                     on_device_error="fallback")
    assert isinstance(exc.value.__cause__, DeviceLostException)
    assert table._device_cache is None
    assert [e["kind"] for e in SCAN_STATS.degradation_events] == ["cpu_fallback_refused"]
    leaves_equal(run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU), clean)


def test_device_health_half_open_probe():
    """The breaker is not a one-way door: every probe_interval-th decision
    is a half-open probe. Driven through run_scan: the refused scans raise
    DeviceFallbackRefusedException ("unhealthy_backend") with no step on the
    card, the probe runs on the card, and its success closes the breaker."""
    for _ in range(DEVICE_HEALTH.threshold):
        DEVICE_HEALTH.record_fault(DeviceLostException("blip"))
    decisions = [
        DEVICE_HEALTH.should_force_fallback()
        for _ in range(DEVICE_HEALTH.probe_interval * 2)
    ]
    assert decisions.count(False) == 2  # two half-open probes
    DEVICE_HEALTH.record_success()
    assert not DEVICE_HEALTH.should_force_fallback()

    table = int_table(300)
    ops = [a.scan_op(table) for a in basic_analyzers()]
    for _ in range(DEVICE_HEALTH.threshold):
        DEVICE_HEALTH.record_fault(DeviceLostException("blip"))
    SCAN_STATS.reset()
    outcomes = []
    with scan_faults(FaultInjectingScanHook()) as watcher:
        for _ in range(DEVICE_HEALTH.probe_interval):
            steps_before = len(watcher.calls)
            try:
                run_scan(table, ops, CPU, on_device_error="fallback")
                outcomes.append(("ran", len(watcher.calls) - steps_before))
            except DeviceFallbackRefusedException as e:
                assert e.reason == "unhealthy_backend"
                assert isinstance(e.__cause__, DeviceLostException)
                outcomes.append(("refused", len(watcher.calls) - steps_before))
    refused = DEVICE_HEALTH.probe_interval - 1
    assert outcomes == [("refused", 0)] * refused + [("ran", 1)]
    assert [e["kind"] for e in SCAN_STATS.degradation_events] == (
        ["cpu_fallback_refused"] * refused)
    assert DEVICE_HEALTH.consecutive_faults == 0


# -- compute watchdog --------------------------------------------------------


def test_watchdog_converts_hang_to_typed_exception():
    table = int_table(400)
    ops = [a.scan_op(table) for a in basic_analyzers()]
    with scan_faults(
        FaultInjectingScanHook(faults={0: ("hang", math.inf)}, hang_seconds=5.0)
    ):
        with pytest.raises(DeviceHangException) as exc:
            run_scan(table, ops, CPU, device_deadline=0.2)
    assert exc.value.deadline == 0.2
    assert SCAN_STATS.watchdog_timeouts == 1


def test_watchdog_hang_feeds_fallback_policy():
    """A hang under ``"fallback"``: the watchdog's DeviceHangException ends
    the ladder, and where the reference re-runs on its CPU the port fails
    the analyzers with DeviceFallbackRefusedException caused by the hang."""
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    table = int_table(400)
    analyzers = basic_analyzers()
    SCAN_STATS.reset()
    with scan_faults(FaultInjectingScanHook(faults={0: ("hang", 1)}, hang_seconds=5.0)):
        ctx = AnalysisRunner.do_analysis_run(
            table, analyzers, on_device_error="fallback", device_deadline=0.2,
        )
    for m in ctx.all_metrics():
        assert isinstance(m.value.exception, DeviceFallbackRefusedException)
        cause = m.value.exception.__cause__
        assert isinstance(cause, DeviceHangException) and cause.deadline == 0.2
    kinds = [e["kind"] for e in SCAN_STATS.degradation_events]
    assert kinds == ["watchdog_timeout", "cpu_fallback_refused"]


def test_no_deadline_means_no_watchdog_machinery():
    """Without a deadline the step runs on the caller's thread: a short
    injected hang just takes that long, and nothing is recorded."""
    table = int_table(200)
    ops = [a.scan_op(table) for a in basic_analyzers()]
    with scan_faults(FaultInjectingScanHook(faults={0: ("hang", 1)}, hang_seconds=0.05)):
        run_scan(table, ops, CPU)
    assert SCAN_STATS.watchdog_timeouts == 0


# -- hook determinism --------------------------------------------------------


def test_scan_hook_injection_is_deterministic():
    """The same script over the same workload gives the same injection
    logs."""
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    table = int_table(800)
    logs = []
    for _ in range(2):
        DEVICE_HEALTH.reset()
        hook = FaultInjectingScanHook(faults={1: ("oom", 1), 2: ("oom", 2)})
        with scan_faults(hook):
            AnalysisRunner.do_analysis_run(
                stream_table(table, 200), basic_analyzers(), on_batch_error="skip",
            )
        logs.append(list(hook.injected))
    assert logs[0] == logs[1]
    assert logs[0] == [("oom", 1, 0), ("oom", 2, 0), ("oom", 2, 1)]


# -- combined fault domains: device + I/O + kill-and-resume ------------------


class _KillSwitch(BaseException):
    """Out-of-band abort, like SIGKILL from the runner's point of view."""


class _KillingSource:
    def __init__(self, inner, kill_at):
        self.inner = inner
        self.kill_at = kill_at

    @property
    def schema(self):
        return self.inner.schema

    @property
    def num_rows(self):
        return self.inner.num_rows

    @property
    def _batch_rows(self):
        return getattr(self.inner, "_batch_rows", None)

    def batches(self, columns=None, batch_rows=None):
        yield from self.batches_from(0, columns=columns, batch_rows=batch_rows)

    def batches_from(self, start=0, columns=None, batch_rows=None):
        idx = start
        for batch in self.inner.batches_from(start, columns=columns, batch_rows=batch_rows):
            if idx >= self.kill_at:
                raise _KillSwitch(f"killed at batch {idx}")
            yield batch
            idx += 1


def test_combined_device_and_io_faults_kill_and_resume(tmp_path):
    """Device faults (an OOM at batch 5 before the kill, at batch 12 after
    the resume) and I/O faults (the checkpoint directory on a
    FaultInjectingFileSystem with transient errors, a FlakyBatchSource
    read fault) in the same run; the killed run resumes from its
    checkpoint and the final metrics are a clean run's bits."""
    n, batch_rows = 2000, 100  # 20 batches
    table = int_table(n)
    check = checks_for(n)

    def fresh_source():
        return stream_table(table, batch_rows=batch_rows).source

    ref = (
        VerificationSuite.on_data(StreamingTable(fresh_source()))
        .add_check(check)
        .with_checkpoint(str(tmp_path / "ref"), every_batches=4)
        .run()
    )
    assert ref.status == CheckStatus.SUCCESS

    inner_fs = InMemoryFileSystem()
    fs_sched = FaultSchedule(error_rate=0.3, seed=11)
    register_filesystem("fault-dev", lambda path: FaultInjectingFileSystem(inner_fs, fs_sched))
    try:
        from deequ_tpu_torch.resilience import StreamCheckpointer

        def make_ckpt():
            return StreamCheckpointer(
                "fault-dev://ckpts", every_batches=4,
                retry=RetryPolicy(max_attempts=6, base_delay=0.0005),
            )

        # run 1: an OOM at batch 5 (bisected), killed at batch 10
        killed = StreamingTable(_KillingSource(fresh_source(), kill_at=10))
        with scan_faults(FaultInjectingScanHook(faults={5: ("oom", 1)})) as h1:
            with pytest.raises(_KillSwitch):
                VerificationSuite.on_data(killed).add_check(check).with_checkpoint(
                    make_ckpt()).run()
        assert ("oom", 5, 0) in h1.injected

        # run 2: resumes past batch 8; an OOM at batch 12 and a transient
        # read fault at batch 14 in the same run
        DEVICE_HEALTH.reset()
        io_sched = FaultSchedule(fail={("batch", 14): 1})
        resumed_table = StreamingTable(FlakyBatchSource(fresh_source(), io_sched)).with_retry(FAST)
        SCAN_STATS.reset()
        with scan_faults(FaultInjectingScanHook(faults={12 - 8: ("oom", 1)})) as h2:
            resumed = (
                VerificationSuite.on_data(resumed_table)
                .add_check(check)
                .with_checkpoint(make_ckpt())
                .run()
            )
        assert resumed.status == CheckStatus.SUCCESS
        assert h2.injected, "the device fault did not fire on the resumed run"
        assert any(k[0] == "ioerror" for k in io_sched.injected)
        assert SCAN_STATS.oom_bisections >= 1
        assert resumed.retry_stats["retries"] >= 1
        assert metric_values(resumed) == metric_values(ref)
    finally:
        _REGISTRY.pop("fault-dev", None)


# -- retry telemetry -----------------------------------------------------------


def test_retry_stats_surfaced_on_result():
    """The run reports its attempt counts, backoff sleep and last
    exception."""
    n = 1000
    table = int_table(n)
    sched = FaultSchedule(fail={("batch", 2): 2, ("batch", 5): 1})
    flaky = StreamingTable(FlakyBatchSource(stream_table(table, 100).source, sched)).with_retry(FAST)
    result = (
        VerificationSuite.on_data(flaky)
        .add_check(checks_for(n))
        .on_batch_error("skip")
        .run()
    )
    assert result.status == CheckStatus.SUCCESS
    stats = result.retry_stats
    assert stats["retries"] >= 3
    assert stats["backoff_seconds"] > 0
    assert "InjectedIOError" in stats["last_exception"]
    assert result.skipped_batches == []


def test_retry_stats_clean_run_is_zero():
    n = 400
    result = (
        VerificationSuite.on_data(stream_table(int_table(n), 100))
        .add_check(checks_for(n))
        .on_batch_error("skip")
        .run()
    )
    assert result.retry_stats["retries"] == 0
    assert result.retry_stats["exhausted"] == 0
    assert result.retry_stats["last_exception"] is None


# -- a group budget with checkpoints warns once a run --------------------------


def test_group_budget_with_checkpoint_warns_once_per_run(tmp_path):
    """group_memory_budget with checkpointing disables spill with exactly
    ONE GroupBudgetIgnoredWarning a run — not one a batch — and run 2
    warns again."""
    n, batch_rows = 1200, 100
    table = int_table(n)
    for run_idx in range(2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result = (
                VerificationSuite.on_data(stream_table(table, batch_rows))
                .add_check(checks_for(n))
                .with_group_memory_budget(1 << 20)
                .with_checkpoint(str(tmp_path / f"ck{run_idx}"), every_batches=4)
                .run()
            )
        assert result.status == CheckStatus.SUCCESS
        budget_warnings = [w for w in caught if issubclass(w.category, GroupBudgetIgnoredWarning)]
        assert len(budget_warnings) == 1, (
            f"run {run_idx}: expected exactly 1 warning, got {len(budget_warnings)}"
        )
    assert SCAN_STATS.spill_runs == 0


# -- telemetry surfaces ------------------------------------------------------


def test_execution_report_includes_device_counters():
    """``scan_execution_report()`` is the flat ScanStats snapshot with the
    device counters (``fallback_refused`` where the reference counts
    ``fallback_scans``); its event list is a copy, not a live view."""
    import deequ_tpu_torch

    report = deequ_tpu_torch.scan_execution_report()
    for key in (
        "device_faults", "oom_bisections", "bisection_depth",
        "watchdog_timeouts", "fallback_refused", "degradation_events",
        "unverified_row_ranges",
    ):
        assert key in report
    report["degradation_events"].append({"kind": "bogus"})
    assert all(e.get("kind") != "bogus" for e in SCAN_STATS.degradation_events)


def test_injected_device_error_is_realistic():
    """The injected stand-in classifies exactly like the error torch
    raises — the harness exercises the production classifier."""
    typed = classify_device_error(
        InjectedDeviceError("CUDA out of memory. Tried to allocate 8.00 GiB."), "execute",
    )
    assert isinstance(typed, DeviceOOMException)
    hook = FaultInjectingScanHook(faults={0: ("compile", 1), 1: ("lost", 1)}, relative=False)
    for scan_id, want in ((0, DeviceCompileException), (1, DeviceLostException)):
        with pytest.raises(InjectedDeviceError) as raw:
            hook("execute", {"scan_id": scan_id, "attempt": 0})
        assert isinstance(classify_device_error(raw.value), want)


def test_on_device_error_validation():
    table = int_table(100)
    with pytest.raises(ValueError):
        VerificationSuite.on_data(table).on_device_error("retry")
    with pytest.raises(ValueError):
        run_scan(table, [], CPU, on_device_error="bogus")


def test_oom_mid_fold_restarts_device_accumulator_cleanly():
    """An OOM at a LATER chunk's step aborts a fold that already holds
    earlier chunks; the bisected retry starts a FRESH fold — no chunk
    folded twice, the clean run's bits, still one fetch."""
    table = int_table(8192, seed=5)
    clean = run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU, chunk_rows=1024)
    halved = run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU, chunk_rows=512)

    SCAN_STATS.reset()
    # chunk 3 of attempt 0 OOMs (chunks 0-2 already merged into the fold);
    # the bisected retry scans everything at chunk 512
    hook_obj = FaultInjectingScanHook(faults={0: ("oom", 1)})
    with scan_faults(
        lambda boundary, ctx: (
            hook_obj(boundary, ctx) if int(ctx.get("chunk_index", -1)) == 3 else None
        )
    ):
        result = run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU,
                          chunk_rows=1024)
    assert SCAN_STATS.oom_bisections == 1
    leaves_equal(result, clean)
    leaves_equal(result, halved)
    # the retry's fetch is the scan's only one: the aborted attempt's fold
    # was dropped, never fetched; read through the locked snapshot
    assert SCAN_STATS.snapshot()["device_fetches"] == 1


def test_fused_resident_scan_survives_injected_oom():
    """An OOM on a persisted table's scan evicts the residency and bisects
    like any other scan — the clean metrics, the rung recorded."""
    table = int_table(8192, seed=6)
    clean = run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU, chunk_rows=1024)
    persist(table, chunk_rows=1024)
    assert table._device_cache is not None

    SCAN_STATS.reset()
    with scan_faults(FaultInjectingScanHook(faults={0: ("oom", 1)})):
        result = run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU)
    assert table._device_cache is None  # residency evicted
    assert SCAN_STATS.oom_bisections == 1
    leaves_equal(result, clean)


# -- port-only: parity with the reference, abandoned workers, frames ----------


def _ref_int_table(table):
    return RefTable([
        RefColumn("x", RefDType.FRACTIONAL, values=table["x"].values.copy()),
        RefColumn("g", RefDType.INTEGRAL, values=table["g"].values.copy()),
    ])


def _ref_analyzers():
    return [RefSize(), RefCompleteness("x"), RefMean("x"), RefMinimum("x"), RefMaximum("x")]


def _ladder_digest(events):
    keys = ("kind", "chunk_from", "chunk_to", "depth", "chunk", "reason")
    return [tuple(e.get(k) for k in keys) for e in events]


@pytest.mark.parametrize(
    "n,faults,chunk_rows,at_chunk",
    [
        (2000, {0: ("oom", 1)}, None, None),
        (2000, {0: ("oom", 2)}, None, None),
        (8192, {0: ("oom", 1)}, 1024, 3),
        (1500, {0: ("oom", 3)}, 700, None),
    ],
    ids=["one_oom", "two_ooms", "mid_fold", "odd_chunk"],
)
def test_ladder_parity_with_reference(n, faults, chunk_rows, at_chunk):
    """The same hook schedule on the same integer table: the same rungs
    (kinds, chunk_from / chunk_to, depth), oom_bisections, bisection_depth
    and metrics in both packages."""
    from deequ_tpu.ops.device_policy import install_scan_fault_hook as ref_install

    def gated(hook):
        if at_chunk is None:
            return hook
        return lambda b, ctx: hook(b, ctx) if int(ctx.get("chunk_index", -1)) == at_chunk else None

    def metrics(analyzers, results):
        out = {}
        for a, r in zip(analyzers, results):
            m = a.compute_metric_from(a.state_from_scan_result(r))
            out[(m.name, m.instance)] = m.value.get()
        return out

    table = int_table(n, seed=9)
    analyzers = basic_analyzers()
    port_hook = FaultInjectingScanHook(faults=faults)
    with scan_faults(gated(port_hook)):
        port_res = run_scan(table, [a.scan_op(table) for a in analyzers], CPU,
                            chunk_rows=chunk_rows)
    port = (_ladder_digest(SCAN_STATS.degradation_events), SCAN_STATS.oom_bisections,
            SCAN_STATS.bisection_depth, list(port_hook.injected))

    rtable = _ref_int_table(table)
    ref_analyzers = _ref_analyzers()
    ref_engine.SCAN_STATS.reset()
    REF_DEVICE_HEALTH.reset()
    ref_hook = RefHook(faults=faults)
    prev = ref_install(gated(ref_hook))
    try:
        with use_mesh(None):
            ref_res = ref_engine.run_scan(
                rtable, [a.scan_op(rtable) for a in ref_analyzers], chunk_rows=chunk_rows)
    finally:
        ref_install(prev)
        REF_DEVICE_HEALTH.reset()
    ref = (_ladder_digest(ref_engine.SCAN_STATS.degradation_events),
           ref_engine.SCAN_STATS.oom_bisections, ref_engine.SCAN_STATS.bisection_depth,
           list(ref_hook.injected))
    assert port == ref
    assert port[1] >= 1
    assert metrics(analyzers, port_res) == metrics(ref_analyzers, ref_res)


def test_persistent_oom_floor_parity_with_reference():
    """A persistent OOM bottoms out at the same floor, after the same
    halvings, in both packages, and raises typed OOM under "fail"."""
    from deequ_tpu.exceptions import DeviceOOMException as RefOOM
    from deequ_tpu.ops.device_policy import install_scan_fault_hook as ref_install

    table = int_table(500)
    with scan_faults(FaultInjectingScanHook(faults={0: ("oom", math.inf)})):
        with pytest.raises(DeviceOOMException):
            run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU)
    rtable = _ref_int_table(table)
    ref_engine.SCAN_STATS.reset()
    prev = ref_install(RefHook(faults={0: ("oom", math.inf)}))
    try:
        with use_mesh(None), pytest.raises(RefOOM):
            ref_engine.run_scan(rtable, [a.scan_op(rtable) for a in _ref_analyzers()])
    finally:
        ref_install(prev)
        REF_DEVICE_HEALTH.reset()
    assert _ladder_digest(SCAN_STATS.degradation_events) == _ladder_digest(
        ref_engine.SCAN_STATS.degradation_events)
    assert SCAN_STATS.oom_bisections == ref_engine.SCAN_STATS.oom_bisections == 3


def test_abandoned_worker_launches_and_counts_nothing(monkeypatch):
    """A hang past the deadline: the worker stalled in the hook is
    abandoned; when it wakes it runs no step (no K1 batch resolved, no
    chunk processed, no fetch counted), and a clean run in the meantime
    counts its own batch and fetch only."""
    from deequ_tpu_torch.ops import masked_reduce

    batches = []
    original = masked_reduce.reduce_into

    def counting(*args, **kwargs):
        batches.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(masked_reduce, "reduce_into", counting)
    table = int_table(400)
    ops = [a.scan_op(table) for a in basic_analyzers()]
    with scan_faults(FaultInjectingScanHook(faults={0: ("hang", 1)}, hang_seconds=0.6)):
        with pytest.raises(DeviceHangException):
            run_scan(table, ops, CPU, device_deadline=0.1)
    hung = SCAN_STATS.snapshot()
    assert (hung["chunks_processed"], hung["device_fetches"], len(batches)) == (0, 0, 0)
    SCAN_STATS.reset()
    clean = run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU)
    time.sleep(0.9)  # the stalled worker wakes, finds itself abandoned
    after = SCAN_STATS.snapshot()
    assert (after["chunks_processed"], after["device_fetches"], len(batches)) == (1, 1, 1)
    assert len(clean) == 5


def test_failed_attempt_frames_are_released_before_the_retry():
    """The OOM rung drops the aborted attempt's frames: its fold is gone
    (no live reference) before the bisected attempt allocates its own."""
    from deequ_tpu_torch.ops import scan_engine

    table = int_table(4096, seed=2)
    folds = []
    original = scan_engine._DeviceFoldPlan

    class Tracked(original):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            folds.append(weakref.ref(self))

    alive_at_retry = []
    hook_obj = FaultInjectingScanHook(faults={0: ("oom", 1)})

    def hook(boundary, ctx):
        if ctx["attempt"] == 1 and ctx["chunk_index"] == 0:
            gc.collect()
            alive_at_retry.append(sum(r() is not None for r in folds))
        if ctx["chunk_index"] == 2:
            hook_obj(boundary, ctx)

    scan_engine._DeviceFoldPlan = Tracked
    try:
        with scan_faults(hook):
            run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU, chunk_rows=1024)
    finally:
        scan_engine._DeviceFoldPlan = original
    assert SCAN_STATS.oom_bisections == 1
    assert alive_at_retry == [0]


def test_oom_on_an_encoded_layout_demotes_before_bisecting():
    """An OOM of an attempt that read an encoded layout demotes to the
    decoded layout at the same chunk (``encoded_demote``) before any
    bisection; a second OOM then bisects. Both runs give the encoded
    run's bits, and a persisted encoded table is evicted with it."""
    table = int_table(2000).encode(["x"])
    assert table["x"].encoding is not None
    clean = run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU)
    assert SCAN_STATS.encoded_scan_passes == 1
    persist(table)
    SCAN_STATS.reset()
    with scan_faults(FaultInjectingScanHook(faults={0: ("oom", 2)})):
        result = run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU)
    leaves_equal(result, clean)
    assert table._device_cache is None
    events = SCAN_STATS.degradation_events
    assert [e["kind"] for e in events] == ["encoded_demote", "oom_bisect"]
    assert events[0]["chunk"] == events[1]["chunk_from"] == 2000
    assert events[1]["chunk_to"] == 1000 and events[0]["evicted_bytes"] > 0
    assert (SCAN_STATS.encoded_demotions, SCAN_STATS.oom_bisections) == (1, 1)
    # the demoted attempts read the decoded layout
    assert SCAN_STATS.encoded_scan_passes == 1


@pytest.mark.parametrize("streamed", [False, True], ids=["in_memory", "stream"])
def test_abandoned_attempt_steps_no_further_chunk(monkeypatch, streamed):
    """A run deadline and no fault hook: the attempt's slow host packing
    outlasts the budget's watchdog, the caller raises typed, and the
    abandoned attempt packs no further chunk and steps none when it
    wakes — its chunk loop and every device call check the abandonment."""
    from deequ_tpu_torch.ops import scan_engine

    packs = []
    original = scan_engine._ChunkPacker.pack

    def slow_pack(self, *args, **kwargs):
        packs.append(1)
        time.sleep(0.15)
        return original(self, *args, **kwargs)

    monkeypatch.setattr(scan_engine._ChunkPacker, "pack", slow_pack)
    table = int_table(4000)
    data = stream_table(table, 400) if streamed else table
    ops = [a.scan_op(table) for a in basic_analyzers()]
    with pytest.raises(DeviceHangException):
        run_scan(data, ops, CPU, chunk_rows=400, run_deadline=0.5)
    at_raise = (len(packs), SCAN_STATS.chunks_processed, SCAN_STATS.device_fetches)
    assert 1 <= at_raise[0] < 10
    time.sleep(0.75)  # five packs' time: the worker wakes and stops
    assert (len(packs), SCAN_STATS.chunks_processed, SCAN_STATS.device_fetches) == at_raise
    assert SCAN_STATS.device_fetches == 0


@pytest.mark.parametrize("has_add_note", [True, False], ids=["notes", "no_notes"])
def test_released_attempt_keeps_its_text(monkeypatch, has_add_note):
    """The ladder clears a failed attempt's tracebacks but keeps their text
    on the fault (``released_attempt``, and a note where the Python has
    ``BaseException.add_note``, 3.11 on); without ``add_note`` the ladder
    still bisects and raises typed."""
    import builtins

    from deequ_tpu_torch.ops import scan_executors

    if not has_add_note:
        def no_add_note(obj, name):
            return name != "add_note" and builtins.hasattr(obj, name)

        monkeypatch.setattr(scan_executors, "hasattr", no_add_note, raising=False)
    table = int_table(1000)
    with scan_faults(FaultInjectingScanHook(faults={0: ("oom", FaultSchedule.PERMANENT)})):
        with pytest.raises(DeviceOOMException) as ei:
            run_scan(table, [a.scan_op(table) for a in basic_analyzers()], CPU,
                     chunk_rows=256)
    assert SCAN_STATS.oom_bisections == 2  # 256 -> 128 -> 64, the floor
    assert ei.value.__traceback__ is not None  # the last raise's own
    assert "InjectedDeviceError" in ei.value.released_attempt
    notes = getattr(ei.value, "__notes__", [])
    assert bool(notes) == has_add_note
