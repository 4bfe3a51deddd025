"""The port's mesh fault tolerance (``exceptions.py``, ``ops/device_policy.py:
MeshHealth``, ``ops/scan_executors.py``' sharded executor,
``ops/scan_engine.py:run_scan``, ``parallel/distributed.py``) on the CPU:
twins of every test of tests/test_mesh_faults.py under the same names,
and parity with the reference.

The reference's ``mesh8`` fixture (its 8 forced host-platform devices)
maps to ``virtual_mesh(8, "cpu")``: eight members, ids 0..7, on the CPU,
whose chip losses are scripted at the execute seam by
``FaultInjectingScanHook``'s targeted specs while the recovery (the mesh
rebuilt over the survivors, the shards packed again, the monoid refold)
is real. The twins keep the reference's holds on integer-valued tables,
where every partial sum is exact in f64 and so bit for bit the same
whatever the mesh's width. The port's differences:

- the messages are CUDA's ("... on cuda:3", "CUDA device 3", "GPU 5"), and
  a member id stands where the reference has a jax device id;
- ``test_all_chips_lost_falls_through_to_cpu_fallback`` and
  ``test_shard_deadline_feeds_fallback_policy``, which end on the
  reference's CPU rung, hold ``DeviceFallbackRefusedException`` and the
  ``cpu_fallback_refused`` event: the port never moves a run onto the CPU;
- the multi-process tests patch the port's ``process_count`` /
  ``process_index`` (the process group's world size and rank) where the
  reference patches ``jax.process_count`` / ``jax.process_index``.

Port-only: the same schedules on the same tables give the same rung
events, ``mesh_events``, ``resharded`` and metrics in both packages (the
reference on its 8-device mesh).
"""

import math
from contextlib import contextmanager

import numpy as np
import pytest

from deequ_tpu_torch.checks import Check, CheckLevel, CheckStatus
from deequ_tpu_torch.data.streaming import StreamingTable, stream_table
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.exceptions import (
    DeviceFallbackRefusedException,
    DeviceHangException,
    DeviceLostException,
    DeviceOOMException,
    MeshDegradedException,
    PeerLostException,
    classify_device_error,
    implicated_devices,
)
from deequ_tpu_torch.ops.device_policy import DEVICE_HEALTH, MESH_HEALTH, MeshHealth
from deequ_tpu_torch.ops.scan_engine import (
    SCAN_STATS,
    install_scan_fault_hook,
    persist_table,
    run_scan,
    total_resident_bytes,
)
from deequ_tpu_torch.parallel import distributed
from deequ_tpu_torch.parallel.mesh import (
    current_mesh,
    mesh_device_ids,
    mesh_excluding,
    use_mesh,
    virtual_mesh,
)
from deequ_tpu_torch.resilience import FaultInjectingScanHook, FaultSchedule
from deequ_tpu_torch.verification import VerificationSuite

pytestmark = [pytest.mark.meshfault, pytest.mark.torch_port]

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_mesh_state():
    """Each test starts on the CPU over the 8-member virtual mesh, with a
    healthy device and mesh, fresh counters and no installed hook."""
    import torch

    from deequ_tpu_torch import use_device

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    SCAN_STATS.reset()
    DEVICE_HEALTH.reset()
    MESH_HEALTH.reset()
    prev = install_scan_fault_hook(None)
    with use_device(CPU), use_mesh(virtual_mesh(8, CPU)):
        yield
    install_scan_fault_hook(prev)
    DEVICE_HEALTH.reset()
    MESH_HEALTH.reset()
    torch.set_num_threads(threads)


@pytest.fixture
def mesh8():
    mesh = current_mesh()
    assert mesh is not None and mesh.size == 8
    return mesh


@contextmanager
def scan_faults(hook):
    prev = install_scan_fault_hook(hook)
    try:
        yield hook
    finally:
        install_scan_fault_hook(prev)


def int_table(n=2000, seed=0):
    """Integer-valued columns: every partial-state sum is exact in f64, so
    "bit-identical across mesh shapes" is a fair hold (a reshard changes
    the members' association)."""
    rng = np.random.default_rng(seed)
    return ColumnarTable(
        [
            Column("x", DType.FRACTIONAL, values=rng.integers(0, 100, n).astype(np.float64)),
            Column("g", DType.INTEGRAL, values=rng.integers(0, 7, n).astype(np.int64)),
        ]
    )


def basic_analyzers():
    from deequ_tpu_torch.analyzers import Completeness, Maximum, Mean, Minimum, Size

    return [Size(), Completeness("x"), Mean("x"), Minimum("x"), Maximum("x")]


def scan_ops(table):
    return [a.scan_op(table) for a in basic_analyzers()]


def checks_for(n):
    return (
        Check(CheckLevel.ERROR, "meshfault")
        .is_complete("x")
        .has_size(lambda s: s == n)
        .has_mean("x", lambda v: v > 0)
        .has_min("x", lambda v: v >= 0)
    )


def metric_values(result):
    return {
        repr(a): m.value.get()
        for a, m in result.metrics.items()
        if m.value.is_success
    }


def assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))


def lost_hooks(ids):
    """One permanent targeted loss a member, fired in member order."""
    hooks = [FaultInjectingScanHook(faults={0: ("lost", FaultSchedule.PERMANENT, d)})
             for d in ids]

    def all_dead(boundary, ctx):
        for h in hooks:
            h(boundary, ctx)

    return all_dead


# -- taxonomy: attribution ---------------------------------------------------


@pytest.mark.parametrize(
    "message,expected_ids",
    [
        ("CUDA error: an illegal memory access was encountered on cuda:3", (3,)),
        ("CUDA error: unspecified launch failure (CUDA device 2)", (2,)),
        ("UNAVAILABLE: injected device halt; device 3 is lost", (3,)),
        ("ABORTED: collective timed out on chip #5", (5,)),
        ("CUDA error: an illegal memory access was encountered", ()),
        ("CUDA out of memory. Tried to allocate 8589934592 bytes.", ()),
        # an enumeration names the set, not a culprit: a whole-backend
        # loss listing its devices is not pinned on the first of them
        ("CUDA error: no CUDA-capable device is detected; visible devices: 0,1", ()),
        ("CUDA error: unknown error; visible devices: 0,1,2,3", ()),
    ],
)
def test_implicated_devices_extraction(message, expected_ids):
    assert implicated_devices(RuntimeError(message)) == expected_ids


def test_attributed_loss_classifies_as_mesh_degraded():
    """A loss the message pins on a member is a mesh fault; an unattributed
    loss stays whole-device."""
    typed = classify_device_error(
        RuntimeError("CUDA error: an illegal memory access was encountered on cuda:3"),
        "execute",
    )
    assert isinstance(typed, MeshDegradedException)
    assert typed.device_ids == (3,)
    # MeshDegraded is a DeviceException, not a DeviceLostException
    assert isinstance(typed, DeviceLostException) is False
    untyped = classify_device_error(
        RuntimeError("CUDA error: an illegal memory access was encountered"), "execute"
    )
    assert isinstance(untyped, DeviceLostException)
    assert untyped.device_ids == ()


def test_attributed_oom_keeps_oom_type_with_device_ids():
    typed = classify_device_error(
        RuntimeError(
            "CUDA out of memory. Tried to allocate 1024 bytes. GPU 5 has a total "
            "capacity of 79.19 GiB"
        ),
        "execute",
    )
    assert isinstance(typed, DeviceOOMException)
    assert typed.device_ids == (5,)


# -- MeshHealth --------------------------------------------------------------


def test_mesh_health_quarantine_and_half_open_probe():
    mh = MeshHealth(threshold=2, probe_interval=4)
    # a lost member is quarantined at once
    mh.record_fault(MeshDegradedException("d3 gone", device_ids=(3,)))
    assert mh.quarantined() == frozenset({3})
    # a member's OOM counts one step toward the threshold
    mh.record_fault(DeviceOOMException("oom on 5", device_ids=(5,)))
    assert 5 not in mh.quarantined()
    mh.record_fault(DeviceOOMException("oom on 5", device_ids=(5,)))
    assert mh.quarantined() == frozenset({3, 5})

    ids = list(range(8))
    decisions = [mh.healthy_subset(ids) for _ in range(8)]
    # every probe_interval-th exclusion decision readmits for a probe
    probes = [d for d in decisions if not d[1]]
    assert len(probes) == 2
    for healthy, excluded in [d for d in decisions if d[1]]:
        assert sorted(excluded) == [3, 5]
        assert sorted(healthy) == [0, 1, 2, 4, 6, 7]
    # one successful pass over the probed members forgives
    mh.record_success(ids)
    assert mh.quarantined() == frozenset()
    assert mh.healthy_subset(ids) == (ids, [])


def test_mesh_health_unattributable_fault_is_noop():
    mh = MeshHealth()
    mh.record_fault(DeviceLostException("whole backend gone"))
    assert mh.quarantined() == frozenset()
    assert mh.consecutive_faults == {}


# -- acceptance: a member lost mid-scan -> reshard, bit for bit ---------------


def test_chip_loss_reshards_bit_identical_to_healthy_7dev_run(mesh8):
    """A scripted loss of member 3 mid-scan completes on the 7 survivors
    with results bit for bit a healthy 7-member run's; the reshard is
    recorded and no CPU rung is reached while members remain."""
    table = int_table(4096, seed=1)
    lost_id = mesh_device_ids(mesh8)[3]
    with use_mesh(mesh_excluding(mesh8, {lost_id})):
        healthy7 = run_scan(table, scan_ops(table), CPU)

    SCAN_STATS.reset()
    hook = FaultInjectingScanHook(faults={0: ("lost", FaultSchedule.PERMANENT, lost_id)})
    with scan_faults(hook):
        # "fallback" armed on purpose: the reshard wins before the ladder
        # reaches the CPU rung
        degraded = run_scan(table, scan_ops(table), CPU, on_device_error="fallback")

    assert hook.injected == [("lost", 0, 0, lost_id)]
    assert SCAN_STATS.mesh_reshards == 1
    assert SCAN_STATS.fallback_refused == 0, "reached the CPU rung with 7 healthy members"
    (event,) = [e for e in SCAN_STATS.degradation_events if e["kind"] == "mesh_reshard"]
    assert event["lost_devices"] == [lost_id]
    assert event["mesh_from"] == 8 and event["mesh_to"] == 7
    assert_results_equal(degraded, healthy7)
    # the dead member is quarantined for later scans
    assert lost_id in MESH_HEALTH.quarantined()


def test_chip_loss_acceptance_through_verification_suite(mesh8):
    """The same through the flagship entry point: the reshard lands on
    mesh_events / resharded and the checks pass with the healthy 7-member
    run's metrics."""
    n = 2000
    table = int_table(n, seed=2)
    check = checks_for(n)
    lost_id = mesh_device_ids(mesh8)[3]

    with use_mesh(mesh_excluding(mesh8, {lost_id})):
        ref = VerificationSuite.on_data(table).add_check(check).run()
    assert ref.status == CheckStatus.SUCCESS

    SCAN_STATS.reset()
    with scan_faults(
        FaultInjectingScanHook(faults={0: ("lost", FaultSchedule.PERMANENT, lost_id)})
    ):
        result = VerificationSuite.on_data(table).add_check(check).run()

    assert result.status == CheckStatus.SUCCESS
    assert result.resharded
    assert any(e["kind"] == "mesh_reshard" for e in result.mesh_events)
    assert not any(e["kind"] == "cpu_fallback_refused" for e in result.device_events)
    assert result.unverified_row_ranges == []
    assert metric_values(result) == metric_values(ref)
    # the clean run did not reshard
    assert ref.resharded is False and ref.mesh_events == []


def test_two_chip_loss_reshards_twice(mesh8):
    """Two members lost one after the other shrink the mesh 8 -> 7 -> 6,
    and the scan still completes on the survivors."""
    table = int_table(2048, seed=3)
    ids = mesh_device_ids(mesh8)
    with use_mesh(mesh_excluding(mesh8, {ids[1], ids[6]})):
        healthy6 = run_scan(table, scan_ops(table), CPU)

    SCAN_STATS.reset()
    with scan_faults(lost_hooks([ids[1], ids[6]])):
        degraded = run_scan(table, scan_ops(table), CPU)
    assert SCAN_STATS.mesh_reshards == 2
    assert SCAN_STATS.fallback_refused == 0
    assert_results_equal(degraded, healthy6)


def test_quarantined_chip_excluded_up_front(mesh8):
    """After a reshard quarantined a member, the next scan builds its mesh
    without it at once (mesh_quarantine) instead of failing into it."""
    table = int_table(1024, seed=4)
    lost_id = mesh_device_ids(mesh8)[2]
    # the member is dead for every scan: any step on it would fault
    hook = FaultInjectingScanHook(
        faults={i: ("lost", FaultSchedule.PERMANENT, lost_id) for i in range(8)}
    )
    with scan_faults(hook):
        run_scan(table, scan_ops(table), CPU)
        assert lost_id in MESH_HEALTH.quarantined()
        SCAN_STATS.reset()
        n_injected = len(hook.injected)
        run_scan(table, scan_ops(table), CPU)
    # no new injection: nothing ran on the dead member again
    assert len(hook.injected) == n_injected
    kinds = [e["kind"] for e in SCAN_STATS.degradation_events]
    assert "mesh_quarantine" in kinds and "mesh_reshard" not in kinds


def test_reshard_composes_with_oom_bisection(mesh8):
    """A member loss (reshard) and a transient whole-mesh OOM (bisection)
    in one scan both degrade; the metrics equal the healthy 7-member
    run's."""
    table = int_table(4096, seed=5)
    lost_id = mesh_device_ids(mesh8)[3]
    with use_mesh(mesh_excluding(mesh8, {lost_id})):
        healthy7 = run_scan(table, scan_ops(table), CPU, chunk_rows=1024)

    SCAN_STATS.reset()
    lost_hook = FaultInjectingScanHook(faults={0: ("lost", FaultSchedule.PERMANENT, lost_id)})
    # an untargeted transient OOM that fires on the attempt after the reshard
    oom_hook = FaultInjectingScanHook(faults={0: ("oom", 2)})

    def both(boundary, ctx):
        lost_hook(boundary, ctx)
        oom_hook(boundary, ctx)

    with scan_faults(both):
        degraded = run_scan(table, scan_ops(table), CPU, chunk_rows=1024)
    assert SCAN_STATS.mesh_reshards == 1
    assert SCAN_STATS.oom_bisections >= 1
    assert SCAN_STATS.fallback_refused == 0
    kinds = [e["kind"] for e in SCAN_STATS.degradation_events]
    assert "mesh_reshard" in kinds and "oom_bisect" in kinds
    # the chunks differ after the bisection, but the monoid fold keeps
    # the states equal (integer-valued data: exact f64 sums)
    for g, w in zip(degraded, healthy7):
        for key in w:
            np.testing.assert_allclose(np.asarray(g[key], dtype=np.float64),
                                       np.asarray(w[key], dtype=np.float64))


def test_per_chip_oom_at_floor_sheds_chip_before_cpu(mesh8):
    """An OOM the message pins on one member, lasting through the
    bisection to its floor, sheds that member instead of giving up the
    other seven."""
    table = int_table(512, seed=6)
    sick_id = mesh_device_ids(mesh8)[5]
    with use_mesh(mesh_excluding(mesh8, {sick_id})):
        healthy7 = run_scan(table, scan_ops(table), CPU)

    SCAN_STATS.reset()
    with scan_faults(
        FaultInjectingScanHook(faults={0: ("oom", FaultSchedule.PERMANENT, sick_id)})
    ):
        degraded = run_scan(table, scan_ops(table), CPU, on_device_error="fallback")
    assert SCAN_STATS.mesh_reshards == 1
    assert SCAN_STATS.fallback_refused == 0
    assert_results_equal(degraded, healthy7)


def test_reshard_restores_chunk_size_after_floor_bisection(mesh8):
    """A member's OOM that bisected to the floor does not pin the scan on
    the survivors at floor-sized chunks: the pressure left with the
    member, so the retry starts again at the caller's chunk size."""
    table = int_table(4096, seed=18)
    sick_id = mesh_device_ids(mesh8)[5]
    SCAN_STATS.reset()
    with scan_faults(
        FaultInjectingScanHook(faults={0: ("oom", FaultSchedule.PERMANENT, sick_id)})
    ):
        run_scan(table, scan_ops(table), CPU, chunk_rows=1024)
    assert SCAN_STATS.mesh_reshards == 1
    # 4096 rows at the caller's chunk (1024 -> 1029 rounded to 7 members)
    # are 4 chunks; a floor-pinned retry would process ~65
    assert SCAN_STATS.chunks_processed == 4, SCAN_STATS.chunks_processed


def test_all_chips_lost_falls_through_to_cpu_fallback(mesh8):
    """Only when no member is left does the ladder reach its last rung —
    where the reference re-runs on its CPU and the port refuses, typed."""
    table = int_table(512, seed=7)
    SCAN_STATS.reset()
    with scan_faults(lost_hooks(mesh_device_ids(mesh8))):
        with pytest.raises(DeviceFallbackRefusedException) as exc:
            run_scan(table, scan_ops(table), CPU, on_device_error="fallback")
    assert isinstance(exc.value.__cause__, MeshDegradedException)
    assert SCAN_STATS.fallback_refused == 1
    assert SCAN_STATS.mesh_reshards >= 1  # it kept shrinking first
    (event,) = [e for e in SCAN_STATS.degradation_events
                if e["kind"] == "cpu_fallback_refused"]
    assert event["reason"] == "MeshDegradedException"


def test_all_chips_lost_without_fallback_raises_typed(mesh8):
    table = int_table(256, seed=8)
    with scan_faults(lost_hooks(mesh_device_ids(mesh8))):
        with pytest.raises(MeshDegradedException):
            run_scan(table, scan_ops(table), CPU)


# -- straggler deadline ------------------------------------------------------


def test_shard_deadline_converts_straggler_to_typed_failure(mesh8):
    """A member stalling a step past the shard deadline raises a typed
    DeviceHangException recorded as a mesh_straggler event."""
    table = int_table(512, seed=9)
    SCAN_STATS.reset()
    with scan_faults(FaultInjectingScanHook(faults={0: ("hang", math.inf)}, hang_seconds=5.0)):
        with pytest.raises(DeviceHangException):
            run_scan(table, scan_ops(table), CPU, shard_deadline=0.2)
    assert SCAN_STATS.mesh_stragglers >= 1
    (event,) = [e for e in SCAN_STATS.degradation_events if e["kind"] == "mesh_straggler"]
    assert event["deadline"] == 0.2
    assert event["mesh_size"] == 8


def test_shard_deadline_feeds_fallback_policy(mesh8):
    """A transient straggler under on_device_error='fallback' reaches the
    CPU rung (the hang names no member to shed), where the reference
    completes on its CPU and the port refuses, typed."""
    table = int_table(512, seed=10)
    SCAN_STATS.reset()
    with scan_faults(FaultInjectingScanHook(faults={0: ("hang", 1)}, hang_seconds=5.0)):
        with pytest.raises(DeviceFallbackRefusedException) as exc:
            run_scan(table, scan_ops(table), CPU, on_device_error="fallback",
                     shard_deadline=0.2)
    assert isinstance(exc.value.__cause__, DeviceHangException)
    assert SCAN_STATS.mesh_stragglers == 1
    assert SCAN_STATS.fallback_refused == 1


def test_tighter_device_deadline_is_not_labeled_straggler(mesh8):
    """A hang that trips a device deadline tighter than the shard deadline
    is a plain watchdog timeout, not a straggler."""
    table = int_table(256, seed=30)
    SCAN_STATS.reset()
    with scan_faults(FaultInjectingScanHook(faults={0: ("hang", 1)}, hang_seconds=5.0)):
        with pytest.raises(DeviceHangException):
            run_scan(table, scan_ops(table), CPU, device_deadline=0.2, shard_deadline=60.0)
    assert SCAN_STATS.mesh_stragglers == 0
    kinds = [e["kind"] for e in SCAN_STATS.degradation_events]
    assert "watchdog_timeout" in kinds and "mesh_straggler" not in kinds


def test_shard_deadline_armed_on_plain_streaming_path(mesh8):
    """The straggler deadline covers plain streaming scans too: a stalled
    member becomes a typed DeviceHangException failure metric, never a
    frozen run."""
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    table = int_table(800, seed=31)
    with scan_faults(FaultInjectingScanHook(faults={0: ("hang", math.inf)}, hang_seconds=5.0)):
        ctx = AnalysisRunner.do_analysis_run(
            stream_table(table, 200), basic_analyzers(), shard_deadline=0.2,
        )
    failures = [m for m in ctx.all_metrics() if m.value.is_failure]
    assert failures
    for m in failures:
        assert isinstance(m.value.exception, DeviceHangException)


def test_shard_deadline_ignored_on_single_device():
    """The straggler watchdog is a mesh feature: a scan on one device arms
    nothing for it."""
    table = int_table(256, seed=11)
    with use_mesh(None):
        with scan_faults(FaultInjectingScanHook(faults={0: ("hang", 1)}, hang_seconds=0.05)):
            run_scan(table, scan_ops(table), CPU, shard_deadline=0.2)
    assert SCAN_STATS.mesh_stragglers == 0


# -- streaming and kill-and-resume through a reshard --------------------------


def test_streaming_chip_loss_resilient_loop_reshards(mesh8):
    """A member lost at batch 2 of a resilient streaming run reshards that
    batch's scan; later batches run on the shrunken mesh; the metrics
    match a fault-free run bit for bit."""
    n, batch_rows = 2000, 250
    table = int_table(n, seed=12)
    check = checks_for(n)
    lost_id = mesh_device_ids(mesh8)[4]

    ref = (VerificationSuite.on_data(stream_table(table, batch_rows))
           .add_check(check).on_batch_error("skip").run())
    assert ref.status == CheckStatus.SUCCESS

    SCAN_STATS.reset()
    with scan_faults(
        FaultInjectingScanHook(faults={2: ("lost", FaultSchedule.PERMANENT, lost_id)})
    ):
        result = (VerificationSuite.on_data(stream_table(table, batch_rows))
                  .add_check(check).on_batch_error("skip").run())
    assert result.status == CheckStatus.SUCCESS
    assert result.resharded
    assert result.skipped_batches == []
    assert SCAN_STATS.mesh_reshards == 1
    assert metric_values(result) == metric_values(ref)


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


def test_kill_and_resume_through_reshard_bit_identical(tmp_path, mesh8):
    """A member dies at batch 2 (reshard), the run is killed at batch 6,
    and the resumed run meets the same dead member (left out up front by
    the quarantine) and finishes bit for bit a clean checkpointed run."""
    n, batch_rows = 2000, 200  # 10 batches
    table = int_table(n, seed=13)
    check = checks_for(n)
    lost_id = mesh_device_ids(mesh8)[1]

    def fresh_source():
        return stream_table(table, batch_rows=batch_rows).source

    ref = (VerificationSuite.on_data(StreamingTable(fresh_source())).add_check(check)
           .with_checkpoint(str(tmp_path / "ref"), every_batches=4).run())
    assert ref.status == CheckStatus.SUCCESS

    ckpt = str(tmp_path / "run")
    killed = StreamingTable(_KillingSource(fresh_source(), kill_at=6))
    hook = FaultInjectingScanHook(faults={2: ("lost", FaultSchedule.PERMANENT, lost_id)})
    with scan_faults(hook):
        with pytest.raises(_KillSwitch):
            (VerificationSuite.on_data(killed).add_check(check)
             .with_checkpoint(ckpt, every_batches=4).run())
    assert ("lost", 2, 0, lost_id) in hook.injected
    assert lost_id in MESH_HEALTH.quarantined()

    # the resumed run: the member is still dead, any step on it faults again
    SCAN_STATS.reset()
    resume_hook = FaultInjectingScanHook(
        faults={i: ("lost", FaultSchedule.PERMANENT, lost_id) for i in range(16)}
    )
    with scan_faults(resume_hook):
        resumed = (VerificationSuite.on_data(StreamingTable(fresh_source())).add_check(check)
                   .with_checkpoint(ckpt, every_batches=4).run())
    assert resumed.status == CheckStatus.SUCCESS
    assert SCAN_STATS.fallback_refused == 0
    assert metric_values(resumed) == metric_values(ref)


# -- stale residency ---------------------------------------------------------


def test_reshard_evicts_residency_pinned_to_old_mesh(mesh8):
    """Residency is sharded over the whole mesh; after a member's loss the
    reshard evicts it (it cannot serve the shrunken mesh) and the budget
    falls to zero."""
    table = int_table(2048, seed=14)
    persist_table(table, CPU, max_bytes=1 << 30, mesh=mesh8)
    assert table._device_cache is not None
    assert total_resident_bytes() > 0
    lost_id = mesh_device_ids(mesh8)[0]
    SCAN_STATS.reset()
    with scan_faults(
        FaultInjectingScanHook(faults={0: ("lost", FaultSchedule.PERMANENT, lost_id)})
    ):
        run_scan(table, scan_ops(table), CPU)
    assert SCAN_STATS.mesh_reshards == 1
    assert table._device_cache is None
    assert total_resident_bytes() == 0
    (event,) = [e for e in SCAN_STATS.degradation_events if e["kind"] == "mesh_reshard"]
    assert event["evicted_bytes"] > 0


def test_mesh_change_evicts_stale_residency(mesh8):
    """A scan over another mesh than the one a table was persisted over
    evicts the stale shards (and their budget) instead of leaving them
    resident."""
    table = int_table(1024, seed=15)
    persist_table(table, CPU, max_bytes=1 << 30, mesh=mesh8)
    assert total_resident_bytes() > 0
    clean = run_scan(table, scan_ops(table), CPU)

    table2 = int_table(1024, seed=15)
    persist_table(table2, CPU, max_bytes=1 << 30, mesh=mesh8)
    SCAN_STATS.reset()
    smaller = mesh_excluding(mesh8, {mesh_device_ids(mesh8)[7]})
    with use_mesh(smaller):
        got = run_scan(table2, scan_ops(table2), CPU)
    assert table2._device_cache is None
    assert any(e["kind"] == "stale_residency_evicted" for e in SCAN_STATS.degradation_events)
    assert_results_equal(got, clean)
    table.unpersist()


def test_evicted_cache_stops_charging_budget():
    """An evicted cache charges nothing, even while a reference to it is
    held."""
    table = int_table(1024, seed=16)
    cache = persist_table(table, CPU, max_bytes=1 << 30)
    assert total_resident_bytes() > 0
    from deequ_tpu_torch.ops.scan_engine import _evict_device_cache

    freed = _evict_device_cache(table)
    assert freed > 0
    assert cache.nbytes == 0
    assert total_resident_bytes() == 0


# -- multi-process peer loss --------------------------------------------------


def _patch_group(monkeypatch, n_proc, pid):
    monkeypatch.setattr(distributed, "process_count", lambda: n_proc)
    monkeypatch.setattr(distributed, "process_index", lambda: pid)


def test_split_row_range_balanced():
    """The balanced split never differs by more than one row across parts
    and covers every row once."""
    from deequ_tpu_torch.parallel.distributed import split_row_range

    for total, n in [(7, 8), (10, 8), (10, 3), (8, 8), (0, 4), (3, 8),
                     (100, 1), (1, 1), (1000003, 7)]:
        sizes = []
        covered = 0
        for part in range(n):
            start, stop = split_row_range(total, n, part)
            assert 0 <= start <= stop <= total
            assert start == covered, (total, n, part)
            covered = stop
            sizes.append(stop - start)
        assert covered == total
        assert max(sizes) - min(sizes) <= 1, (total, n, sizes)

    with pytest.raises(ValueError):
        split_row_range(10, 0, 0)
    with pytest.raises(ValueError):
        split_row_range(10, 4, 4)


def test_host_row_range_balanced(monkeypatch):
    from deequ_tpu_torch.parallel.distributed import host_row_range

    sizes = []
    for pid in range(8):
        _patch_group(monkeypatch, 8, pid)
        start, stop = host_row_range(10)
        sizes.append(stop - start)
    assert sizes == [2, 2, 1, 1, 1, 1, 1, 1]


def test_check_peers_single_host_is_trivially_healthy():
    from deequ_tpu_torch.parallel.distributed import check_peers

    report = check_peers(1000)
    assert not report.degraded
    assert report.lost == []


def test_check_peers_fail_raises_typed(monkeypatch):
    from deequ_tpu_torch.parallel.distributed import check_peers

    _patch_group(monkeypatch, 4, 0)
    with pytest.raises(PeerLostException) as exc:
        check_peers(1000, timeout=0.1, probe=lambda timeout: [0, 1, 3])
    assert exc.value.lost_processes == (2,)


def test_check_peers_degrade_reports_unverified_ranges(monkeypatch):
    """on_peer_loss='degrade': the survivors complete and the lost ranks'
    balanced row ranges are reported unverified, on the report and on
    ScanStats."""
    from deequ_tpu_torch.parallel.distributed import check_peers, split_row_range

    _patch_group(monkeypatch, 4, 0)
    SCAN_STATS.reset()
    report = check_peers(1003, timeout=0.1, on_peer_loss="degrade",
                         probe=lambda t: [0, 1, 3])
    assert report.degraded
    assert report.lost == [2]
    assert report.surviving == [0, 1, 3]
    want = split_row_range(1003, 4, 2)
    assert report.unverified_row_ranges == [want]
    assert SCAN_STATS.peer_losses == 1
    assert SCAN_STATS.unverified_row_ranges == [want]
    (event,) = [e for e in SCAN_STATS.degradation_events if e["kind"] == "peer_lost"]
    assert (event["start"], event["stop"]) == want


def test_check_peers_unattributable_timeout_raises_even_degrade(monkeypatch):
    from deequ_tpu_torch.parallel.distributed import check_peers

    _patch_group(monkeypatch, 2, 0)

    def probe(timeout):
        raise TimeoutError("barrier stalled, everyone heartbeated")

    with pytest.raises(PeerLostException):
        check_peers(100, timeout=0.1, on_peer_loss="degrade", probe=probe)


def test_check_peers_validates_policy():
    from deequ_tpu_torch.parallel.distributed import check_peers

    with pytest.raises(ValueError):
        check_peers(100, on_peer_loss="retry")


def test_unverified_ranges_surface_on_verification_result(monkeypatch):
    """Partial results end to end: the run's .on_peer_loss("degrade")
    runs the peer check inside the run, so a lost rank's rows land on
    unverified_row_ranges and mesh_events; a fresh run starts clean."""
    from deequ_tpu_torch.parallel.distributed import split_row_range

    n = 800
    table = int_table(n, seed=17)
    _patch_group(monkeypatch, 4, 0)
    monkeypatch.setattr(distributed, "_default_peer_probe", lambda timeout: [0, 2, 3])

    result = (VerificationSuite.on_data(table).add_check(checks_for(n))
              .on_peer_loss("degrade", timeout=0.1).run())
    assert result.status == CheckStatus.SUCCESS
    assert result.unverified_row_ranges == [split_row_range(n, 4, 1)]
    (event,) = [e for e in result.mesh_events if e["kind"] == "peer_lost"]
    assert (event["start"], event["stop"]) == split_row_range(n, 4, 1)

    # "fail" raises typed through the same wiring
    with pytest.raises(PeerLostException):
        (VerificationSuite.on_data(table).add_check(checks_for(n))
         .on_peer_loss("fail", timeout=0.1).run())
    with pytest.raises(ValueError):
        VerificationSuite.on_data(table).on_peer_loss("retry")

    # a fresh run without the check inherits nothing of the degradation
    clean = VerificationSuite.on_data(table).add_check(checks_for(n)).run()
    assert clean.unverified_row_ranges == []
    assert clean.mesh_events == []


class _CountlessSource:
    """A BatchSource wrapper that forgets its row count (the shape of a
    generator's source; StreamingTable.num_rows then raises TypeError)."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def schema(self):
        return self.inner.schema

    @property
    def num_rows(self):
        return None

    @property
    def _batch_rows(self):
        return getattr(self.inner, "_batch_rows", None)

    def batches(self, columns=None, batch_rows=None):
        return self.inner.batches(columns=columns, batch_rows=batch_rows)

    def batches_from(self, start=0, columns=None, batch_rows=None):
        return self.inner.batches_from(start, columns=columns, batch_rows=batch_rows)


def test_on_peer_loss_survives_countless_stream(monkeypatch):
    """A stream that does not know its row count still gets the peer
    check: the loss is reported as an event, only without a row range."""
    n = 600
    table = int_table(n, seed=19)
    stream = StreamingTable(_CountlessSource(stream_table(table, 200).source))
    with pytest.raises(TypeError):
        stream.num_rows  # the shape under test
    _patch_group(monkeypatch, 4, 0)
    monkeypatch.setattr(distributed, "_default_peer_probe", lambda timeout: [0, 2, 3])
    result = (VerificationSuite.on_data(stream).add_check(checks_for(n))
              .on_batch_error("skip").on_peer_loss("degrade", timeout=0.1).run())
    assert result.status == CheckStatus.SUCCESS
    (event,) = [e for e in result.mesh_events if e["kind"] == "peer_lost"]
    assert event["lost_processes"] == [1]
    assert result.unverified_row_ranges == []


# -- parity with the reference --------------------------------------------------


def _ref_int_table(n, seed):
    from deequ_tpu.data.table import Column as RefColumn
    from deequ_tpu.data.table import ColumnarTable as RefTable
    from deequ_tpu.data.table import DType as RefDType

    rng = np.random.default_rng(seed)
    return RefTable([
        RefColumn("x", RefDType.FRACTIONAL,
                  values=rng.integers(0, 100, n).astype(np.float64)),
        RefColumn("g", RefDType.INTEGRAL, values=rng.integers(0, 7, n).astype(np.int64)),
    ])


def _ref_checks(n):
    from deequ_tpu.checks import Check as RefCheck
    from deequ_tpu.checks import CheckLevel as RefLevel

    return (RefCheck(RefLevel.ERROR, "meshfault").is_complete("x")
            .has_size(lambda s: s == n).has_mean("x", lambda v: v > 0)
            .has_min("x", lambda v: v >= 0))


def _shape_of(events):
    keep = ("kind", "lost_devices", "mesh_from", "mesh_to", "excluded_devices", "mesh_size")
    return [{k: e[k] for k in keep if k in e} for e in events]


@pytest.mark.parametrize("schedule", ["lost_member_3", "two_lost", "oom_member_5"])
def test_mesh_rungs_match_the_reference(schedule, mesh8):
    """The same targeted schedule on the same integer table over an
    8-wide mesh: the reference (its 8 forced host devices, ids 0..7) and
    the port (the 8-member virtual mesh) take the same rungs, report the
    same mesh_events and resharded flag, and give the same metrics."""
    from deequ_tpu.ops.device_policy import DEVICE_HEALTH as REF_DEVICE_HEALTH
    from deequ_tpu.ops.device_policy import MESH_HEALTH as REF_MESH_HEALTH
    from deequ_tpu.ops.scan_engine import install_scan_fault_hook as ref_install
    from deequ_tpu.parallel.mesh import current_mesh as ref_current_mesh
    from deequ_tpu.resilience import FaultInjectingScanHook as RefHook
    from deequ_tpu.resilience import FaultSchedule as RefSchedule
    from deequ_tpu.verification import VerificationSuite as RefSuite

    ref_mesh = ref_current_mesh()
    assert ref_mesh is not None and math.prod(ref_mesh.devices.shape) == 8
    specs = {
        "lost_member_3": [("lost", 3)],
        "two_lost": [("lost", 1), ("lost", 6)],
        "oom_member_5": [("oom", 5)],
    }[schedule]
    n = 2048
    ref_hooks = [RefHook(faults={0: (kind, RefSchedule.PERMANENT, d)}) for kind, d in specs]
    port_hooks = [FaultInjectingScanHook(faults={0: (kind, FaultSchedule.PERMANENT, d)})
                  for kind, d in specs]

    def chain(hooks):
        def hook(boundary, ctx):
            for h in hooks:
                h(boundary, ctx)
        return hook

    REF_DEVICE_HEALTH.reset()
    REF_MESH_HEALTH.reset()
    prev = ref_install(chain(ref_hooks))
    try:
        want = RefSuite.on_data(_ref_int_table(n, 21)).add_check(_ref_checks(n)).run()
    finally:
        ref_install(prev)
        REF_DEVICE_HEALTH.reset()
        REF_MESH_HEALTH.reset()
    with scan_faults(chain(port_hooks)):
        got = VerificationSuite.on_data(int_table(n, 21)).add_check(checks_for(n)).run()

    assert got.status.name == want.status.name == "SUCCESS"
    assert got.resharded is want.resharded is True
    assert _shape_of(got.mesh_events) == _shape_of(want.mesh_events)
    assert [e["kind"] for e in got.device_events] == [e["kind"] for e in want.device_events]
    assert metric_values(got) == {repr(a): m.value.get() for a, m in want.metrics.items()
                                  if m.value.is_success}
