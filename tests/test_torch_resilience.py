"""The port's resilience layer (``deequ_tpu_torch/resilience``: retries,
crash-safe persistence, fault injection, quarantine, checkpoint and
resume; the resilient stream loop of ``analyzers/runner.py``) on the CPU:
twins of the 49 tests of tests/test_resilience.py, and the port's own.

The twins keep the reference's names and holds; the port runs each on
the CPU (``use_device("cpu")``). Two hold the port's own machinery in the
reference's place: the deferred fetch counts ``fetch_deferred``'s one
fetch a checkpoint boundary (``ScanStats.deferred_fetches``), and a batch
scan sabotaged at its drain breaks the port's ``DeferredScan`` unpacking
instead of the reference's partial folder.

Port-only: a checkpoint written by either package resumes the other's
run (same fingerprint, same fold stacks); ``on_device_error="fallback"``
takes the resilient loop on a stream and any value but "fail" and
"fallback" raises ValueError; quarantine and
retries over a stream of fused scans, grouping sets and Histogram equal
numpy over the rows that remain; a resumed run under a group budget
warns once and still gives the uninterrupted run's bits.
"""

import os

import numpy as np
import pytest

from deequ_tpu_torch.checks import Check, CheckLevel, CheckStatus
from deequ_tpu_torch.data.fs import (
    InMemoryFileSystem,
    _REGISTRY,
    register_filesystem,
)
from deequ_tpu_torch.data.streaming import StreamingTable, stream_table
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.exceptions import (
    CorruptStateException,
    RetryExhaustedException,
)
from deequ_tpu_torch.resilience import (
    FaultInjectingFileSystem,
    FaultSchedule,
    FlakyBatchSource,
    RetryPolicy,
    StreamCheckpoint,
    StreamCheckpointer,
    atomic_write_bytes,
    retry_call,
    run_fingerprint,
    unwrap_checksum,
    wrap_checksum,
)
from deequ_tpu_torch.verification import VerificationSuite

pytestmark = [pytest.mark.fault, pytest.mark.torch_port]


@pytest.fixture(autouse=True)
def _on_cpu():
    import torch

    from deequ_tpu_torch import use_device
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    SCAN_STATS.reset()
    with use_device("cpu"):
        yield
    torch.set_num_threads(threads)

FAST = RetryPolicy(max_attempts=4, base_delay=0.0005, max_delay=0.002)


def small_table(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return ColumnarTable(
        [
            Column("x", DType.FRACTIONAL, values=rng.normal(0.0, 1.0, n)),
            Column(
                "g",
                DType.INTEGRAL,
                values=rng.integers(0, 7, n).astype(np.int64),
            ),
        ]
    )


def checks_for(n):
    return (
        Check(CheckLevel.ERROR, "resilience")
        .is_complete("x")
        .has_size(lambda s: s == n)
        .has_uniqueness(["g"], lambda v: v >= 0.0)
    )


def metric_values(result):
    return {
        repr(a): m.value.get()
        for a, m in result.metrics.items()
        if m.value.is_success
    }


# -- RetryPolicy -------------------------------------------------------------


def test_retry_policy_succeeds_after_transient_failures():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise IOError("transient")
        return "ok"

    assert FAST.call(flaky, what="flaky") == "ok"
    assert calls["n"] == 3


def test_retry_policy_exhaustion_is_typed():
    def always():
        raise IOError("permanent")

    with pytest.raises(RetryExhaustedException) as exc:
        FAST.call(always, what="doomed read")
    assert exc.value.attempts == FAST.max_attempts
    assert isinstance(exc.value.__cause__, IOError)


def test_retry_policy_does_not_retry_logic_errors():
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise ValueError("bug, not weather")

    with pytest.raises(ValueError):
        FAST.call(broken)
    assert calls["n"] == 1


def test_retry_delays_grow_and_cap():
    policy = RetryPolicy(
        max_attempts=10, base_delay=0.01, max_delay=0.05, multiplier=2.0,
        jitter=0.0,
    )
    delays = [policy.delay_for(k) for k in range(6)]
    assert delays[:3] == [0.01, 0.02, 0.04]
    assert all(d == 0.05 for d in delays[3:])


def test_retry_call_uses_process_default():
    # the default policy retries OSErrors without any explicit policy
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise OSError("transient")
        return 42

    assert retry_call(flaky, what="default-policy read") == 42


# -- fault schedule determinism ---------------------------------------------


def test_fault_schedule_seeded_reproducible():
    def drive(schedule):
        for i in range(50):
            try:
                schedule.check(("batch", i % 10))
            except IOError:
                pass
        return list(schedule.injected)

    a = drive(FaultSchedule(seed=7, error_rate=0.3))
    b = drive(FaultSchedule(seed=7, error_rate=0.3))
    c = drive(FaultSchedule(seed=8, error_rate=0.3))
    assert a == b
    assert a != c
    assert len(a) > 0


def test_fault_schedule_explicit_counts():
    sched = FaultSchedule(fail={("batch", 1): 2})
    with pytest.raises(IOError):
        sched.check(("batch", 1))
    with pytest.raises(IOError):
        sched.check(("batch", 1))
    sched.check(("batch", 1))  # third attempt succeeds
    sched.check(("batch", 0))  # unscheduled keys never fail


# -- checksummed envelope ----------------------------------------------------


def test_checksum_roundtrip_and_torn_detection():
    payload = b"state bytes" * 100
    enveloped = wrap_checksum(payload)
    assert unwrap_checksum(enveloped, "t") == payload
    with pytest.raises(CorruptStateException, match="torn"):
        unwrap_checksum(enveloped[: len(enveloped) // 2], "t")
    flipped = bytearray(enveloped)
    flipped[-1] ^= 0xFF
    with pytest.raises(CorruptStateException, match="checksum"):
        unwrap_checksum(bytes(flipped), "t")


def test_atomic_write_leaves_no_temp_files(tmp_path):
    from deequ_tpu_torch.data.fs import LocalFileSystem

    fs = LocalFileSystem()
    path = str(tmp_path / "out.bin")
    atomic_write_bytes(fs, path, b"payload")
    assert sorted(os.listdir(tmp_path)) == ["out.bin"]
    with open(path, "rb") as f:
        assert f.read() == b"payload"


# -- crash-safe metrics repository ------------------------------------------


def _save_one(repo, n=100):
    from deequ_tpu_torch.repository import AnalysisResult, ResultKey

    ctx = VerificationSuite.on_data(small_table(n)).add_check(
        Check(CheckLevel.ERROR, "c").has_size(lambda s: s == n)
    ).run()
    from deequ_tpu_torch.analyzers.runner import AnalyzerContext

    key = ResultKey(1234, {"tag": "t"})
    repo.save(AnalysisResult(key, AnalyzerContext(dict(ctx.metrics))))
    return key


def test_repository_corrupt_json_is_typed(tmp_path):
    from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository

    path = str(tmp_path / "metrics.json")
    repo = FileSystemMetricsRepository(path)
    key = _save_one(repo)
    assert repo.load_by_key(key) is not None
    with open(path, "w") as f:
        f.write('{"deequ_tpu_envelope": 1, "crc32":')  # torn mid-write
    with pytest.raises(CorruptStateException):
        FileSystemMetricsRepository(path).load_by_key(key)


def test_repository_checksum_catches_payload_corruption(tmp_path):
    from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository

    path = str(tmp_path / "metrics.json")
    repo = FileSystemMetricsRepository(path)
    key = _save_one(repo)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x5A  # bit rot inside the payload
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CorruptStateException, match="checksum"):
        FileSystemMetricsRepository(path).load_by_key(key)


def test_repository_legacy_plain_json_still_loads(tmp_path):
    from deequ_tpu_torch.repository import serde
    from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository

    path = str(tmp_path / "metrics.json")
    repo = FileSystemMetricsRepository(path)
    key = _save_one(repo)
    results = repo.load().get()
    # rewrite as the pre-resilience format: bare results JSON, no envelope
    with open(path, "w") as f:
        f.write(serde.serialize(results))
    loaded = FileSystemMetricsRepository(path).load_by_key(key)
    assert loaded is not None
    assert serde.serialize([loaded])  # round-trips


def test_repository_torn_write_detected(tmp_path):
    """An injected torn write (the crash-without-rename shape) must be
    DETECTED on read, not decoded as garbage."""
    from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository

    sched = FaultSchedule(torn_rate=1.0)
    fs = FaultInjectingFileSystem(InMemoryFileSystem(), sched)
    register_filesystem("fault-torn", lambda path: fs)
    try:
        repo = FileSystemMetricsRepository("fault-torn://metrics.json")
        key = _save_one(repo)
        assert any(kind == "torn" for kind, _, _ in sched.injected)
        with pytest.raises(CorruptStateException):
            FileSystemMetricsRepository(
                "fault-torn://metrics.json"
            ).load_by_key(key)
    finally:
        _REGISTRY.pop("fault-torn", None)


def test_repository_retries_transient_open(tmp_path):
    from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository

    inner = InMemoryFileSystem()
    sched = FaultSchedule(fail={("open", "fault-rt://metrics.json"): 1})
    register_filesystem(
        "fault-rt", lambda path: FaultInjectingFileSystem(inner, sched)
    )
    try:
        repo = FileSystemMetricsRepository("fault-rt://metrics.json")
        key = _save_one(repo)  # first open injected, retried through
        assert repo.load_by_key(key) is not None
        assert ("ioerror", ("open", "fault-rt://metrics.json"), 0) in sched.injected
    finally:
        _REGISTRY.pop("fault-rt", None)


# -- crash-safe state provider ----------------------------------------------


def test_state_provider_corruption_is_typed(tmp_path):
    from deequ_tpu_torch.analyzers import Mean
    from deequ_tpu_torch.analyzers.states import MeanState
    from deequ_tpu_torch.states import FileSystemStateProvider

    provider = FileSystemStateProvider(str(tmp_path))
    provider.persist(Mean("x"), MeanState(10.0, 4))
    loaded = provider.load(Mean("x"))
    assert (loaded.total, loaded.count) == (10.0, 4)
    (state_file,) = [p for p in os.listdir(tmp_path) if p.endswith(".state")]
    full = os.path.join(str(tmp_path), state_file)
    raw = bytearray(open(full, "rb").read())
    raw[-3] ^= 0x5A
    open(full, "wb").write(bytes(raw))
    with pytest.raises(CorruptStateException):
        provider.load(Mean("x"))


def test_state_provider_legacy_raw_blob_loads(tmp_path):
    from deequ_tpu_torch.analyzers import Mean
    from deequ_tpu_torch.analyzers.states import MeanState
    from deequ_tpu_torch.states import FileSystemStateProvider
    from deequ_tpu_torch.states.serde import serialize_state

    provider = FileSystemStateProvider(str(tmp_path))
    # pre-resilience file: bare serde bytes, no checksum envelope
    path = provider._path(Mean("x"))
    with open(path, "wb") as f:
        f.write(serialize_state(MeanState(6.0, 3)))
    loaded = provider.load(Mean("x"))
    assert (loaded.total, loaded.count) == (6.0, 3)


# -- spill run integrity -----------------------------------------------------


def _write_run(tmp_path):
    from deequ_tpu_torch.spill.runs import RunWriter

    path = str(tmp_path / "r.run")
    w = RunWriter(path, 1)
    w.write_block(
        (np.arange(64, dtype=np.int64),),
        (np.zeros(64, dtype=bool),),
        np.ones(64, dtype=np.int64),
    )
    w.close()
    return path


def test_spill_run_crc_roundtrip(tmp_path):
    from deequ_tpu_torch.spill.runs import RunReader

    path = _write_run(tmp_path)
    (block,) = list(RunReader(path).blocks())
    kv, kn, counts = block
    assert np.array_equal(kv[0], np.arange(64))
    assert counts.sum() == 64


def test_spill_run_bitflip_detected(tmp_path):
    from deequ_tpu_torch.spill.runs import RunReader

    path = _write_run(tmp_path)
    raw = bytearray(open(path, "rb").read())
    raw[-5] ^= 0x01  # flip one payload bit
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CorruptStateException, match="checksum"):
        list(RunReader(path).blocks())


def test_spill_run_torn_block_detected(tmp_path):
    from deequ_tpu_torch.spill.runs import RunReader

    path = _write_run(tmp_path)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) - 16])  # torn tail
    with pytest.raises(CorruptStateException, match="torn"):
        list(RunReader(path).blocks())


# -- spill store context manager --------------------------------------------


def _spilling_store(tmp_path):
    from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows
    from deequ_tpu_torch.spill.store import SpillingFrequencyStore

    store = SpillingFrequencyStore(("g",), budget_bytes=1, spill_dir=str(tmp_path))
    state = FrequenciesAndNumRows(
        ("g",),
        (np.arange(256, dtype=np.int64),),
        (np.zeros(256, dtype=bool),),
        np.ones(256, dtype=np.int64),
        256,
    )
    store.add(state)  # budget=1 byte: spills immediately
    return store


def test_spill_store_releases_on_exception(tmp_path):
    with pytest.raises(RuntimeError):
        with _spilling_store(tmp_path) as store:
            assert store._tmpdir is not None and os.path.isdir(store._tmpdir)
            tmpdir = store._tmpdir
            raise RuntimeError("simulated run failure")
    assert not os.path.exists(tmpdir)


def test_spill_store_keeps_dir_for_taken_result(tmp_path):
    with _spilling_store(tmp_path) as store:
        result = store.result()
        tmpdir = store._tmpdir
    assert os.path.isdir(tmpdir)  # SpilledFrequencies still streams from it
    assert result.num_rows == 256
    store.release()
    assert not os.path.exists(tmpdir)


def test_spill_store_releases_when_result_never_taken(tmp_path):
    with _spilling_store(tmp_path) as store:
        tmpdir = store._tmpdir
    assert not os.path.exists(tmpdir)


# -- flaky source + retry + quarantine ---------------------------------------


def test_transient_batch_faults_retry_to_identical_metrics():
    table = small_table()
    plain = VerificationSuite.on_data(
        stream_table(table, batch_rows=100)
    ).add_check(checks_for(1000)).run()

    sched = FaultSchedule(fail={("batch", 2): 2, ("batch", 7): 1})
    flaky = StreamingTable(
        FlakyBatchSource(stream_table(table, batch_rows=100).source, sched)
    ).with_retry(FAST)
    retried = VerificationSuite.on_data(flaky).add_check(checks_for(1000)).run()

    assert retried.status == CheckStatus.SUCCESS
    assert metric_values(retried) == metric_values(plain)
    assert len([k for k in sched.injected if k[0] == "ioerror"]) == 3


def test_retry_exhaustion_fails_the_run(tmp_path):
    table = small_table()
    sched = FaultSchedule(fail={("batch", 3): FaultSchedule.PERMANENT})
    flaky = StreamingTable(
        FlakyBatchSource(stream_table(table, batch_rows=100).source, sched)
    )
    result = (
        VerificationSuite.on_data(flaky)
        .add_check(checks_for(1000))
        .with_retry_policy(FAST)
        .on_batch_error("fail")
        # force the resilient path (on_batch_error is its default "fail";
        # a checkpointer with no prior state engages it too)
        .with_checkpoint(str(tmp_path / "ck"))
        .run()
    )
    assert result.status == CheckStatus.ERROR
    assert all(m.value.is_failure for m in result.metrics.values())
    failure = next(iter(result.metrics.values())).value.exception
    assert "still failing" in str(failure)


def test_quarantine_skips_and_reports(tmp_path):
    table = small_table()
    batch_rows = 100
    sched = FaultSchedule(fail={("batch", 4): FaultSchedule.PERMANENT})
    flaky = StreamingTable(
        FlakyBatchSource(
            stream_table(table, batch_rows=batch_rows).source, sched
        )
    )
    result = (
        VerificationSuite.on_data(flaky)
        .add_check(
            Check(CheckLevel.ERROR, "q")
            .is_complete("x")
            .has_size(lambda s: s == 900)  # one quarantined batch of 100
        )
        .with_retry_policy(FAST)
        .on_batch_error("skip")
        .run()
    )
    assert result.status == CheckStatus.SUCCESS
    assert result.skipped_batches == [4]
    values = metric_values(result)
    assert values["Size(where=None)"] == 900.0


def test_quarantine_without_faults_matches_plain_run():
    table = small_table()
    plain = VerificationSuite.on_data(
        stream_table(table, batch_rows=128)
    ).add_check(checks_for(1000)).run()
    resilient = (
        VerificationSuite.on_data(stream_table(table, batch_rows=128))
        .add_check(checks_for(1000))
        .on_batch_error("skip")
        .run()
    )
    assert resilient.skipped_batches == []
    plain_vals = metric_values(plain)
    for name, value in metric_values(resilient).items():
        assert value == pytest.approx(plain_vals[name], rel=1e-12)


# -- checkpoint / resume -----------------------------------------------------


class _KillSwitch(BaseException):
    """Out-of-band abort, like SIGKILL from the runner's point of view:
    not an Exception, so no failure-isolation layer converts it."""


class _KillingSource:
    """Source wrapper that hard-kills the process loop at a given
    absolute batch index."""

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
        for batch in self.inner.batches_from(
            start, columns=columns, batch_rows=batch_rows
        ):
            if self.kill_at is not None and idx == self.kill_at:
                raise _KillSwitch(f"killed at batch {idx}")
            yield batch
            idx += 1


class _StartRecorder:
    """Source wrapper recording every batches_from(start) — proves the
    resumed run did NOT restart from batch 0."""

    def __init__(self, inner):
        self.inner = inner
        self.starts = []

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
        self.starts.append(start)
        return self.inner.batches_from(
            start, columns=columns, batch_rows=batch_rows
        )


def test_kill_and_resume_bit_identical(tmp_path):
    """Acceptance: a streaming verification run killed mid-stream resumes
    from its last checkpoint and yields metrics IDENTICAL (==, not
    approx) to an uninterrupted run — with transient faults injected on
    the resumed read path too."""
    table = small_table(2000)
    batch_rows = 100  # 20 batches
    check = checks_for(2000)

    def fresh_source():
        return stream_table(table, batch_rows=batch_rows).source

    # uninterrupted reference run through the same checkpointed path
    ref = (
        VerificationSuite.on_data(StreamingTable(fresh_source()))
        .add_check(check)
        .with_checkpoint(str(tmp_path / "ref"), every_batches=4)
        .run()
    )
    assert ref.status == CheckStatus.SUCCESS

    # run 1: killed at batch 10 (checkpoints at 4 and 8 persist)
    ckpt_dir = str(tmp_path / "run")
    killed = StreamingTable(_KillingSource(fresh_source(), kill_at=10))
    with pytest.raises(_KillSwitch):
        (
            VerificationSuite.on_data(killed)
            .add_check(check)
            .with_checkpoint(ckpt_dir, every_batches=4)
            .run()
        )
    saved = sorted(os.listdir(ckpt_dir))
    assert saved, "kill left no checkpoints behind"

    # run 2: same checkpoint dir, clean data, transient faults injected
    sched = FaultSchedule(fail={("batch", 9): 1, ("batch", 12): 2})
    recorder = _StartRecorder(FlakyBatchSource(fresh_source(), sched))
    resumed = (
        VerificationSuite.on_data(StreamingTable(recorder).with_retry(FAST))
        .add_check(check)
        .with_checkpoint(ckpt_dir, every_batches=4)
        .run()
    )
    assert resumed.status == CheckStatus.SUCCESS
    # resumed from the batch-8 checkpoint, not from zero
    assert recorder.starts and min(recorder.starts) == 8
    # bit-identical to the uninterrupted run
    assert metric_values(resumed) == metric_values(ref)
    # completed run cleared its checkpoints
    assert sorted(os.listdir(ckpt_dir)) == []


def test_checkpoint_resume_under_quarantine(tmp_path):
    """Quarantined batch indices survive the checkpoint round-trip: the
    resumed run reports the skips recorded before the kill."""
    table = small_table(1200)
    batch_rows = 100
    ckpt_dir = str(tmp_path / "q")
    sched = FaultSchedule(fail={("batch", 2): FaultSchedule.PERMANENT})

    def make_check():
        # the SAME check set both runs: the analyzer set is part of the
        # checkpoint fingerprint — a different set must not resume
        return (
            Check(CheckLevel.ERROR, "q")
            .is_complete("x")
            .has_size(lambda s: s == 1100)  # one quarantined batch of 100
        )

    killed = StreamingTable(
        _KillingSource(
            FlakyBatchSource(
                stream_table(table, batch_rows=batch_rows).source, sched
            ),
            kill_at=8,
        )
    )
    with pytest.raises(_KillSwitch):
        (
            VerificationSuite.on_data(killed)
            .add_check(make_check())
            .with_checkpoint(ckpt_dir, every_batches=2)
            .on_batch_error("skip")
            .with_retry_policy(FAST)
            .run()
        )

    resumed = (
        VerificationSuite.on_data(
            StreamingTable(stream_table(table, batch_rows=batch_rows).source)
        )
        .add_check(make_check())
        .with_checkpoint(ckpt_dir, every_batches=2)
        .on_batch_error("skip")
        .run()
    )
    assert resumed.status == CheckStatus.SUCCESS
    assert resumed.skipped_batches == [2]
    assert metric_values(resumed)["Size(where=None)"] == 1100.0


def test_checkpointer_falls_back_past_corrupt_file(tmp_path):
    from deequ_tpu_torch.analyzers.states import NumMatches

    ck = StreamCheckpointer(str(tmp_path), every_batches=1)
    fp = run_fingerprint(["k"], 100)
    assert ck.save(fp, StreamCheckpoint(4, [], {"k": [(0, NumMatches(4))]}))
    assert ck.save(fp, StreamCheckpoint(8, [1], {"k": [(1, NumMatches(8))]}))
    # corrupt the newest checkpoint file in place
    names = sorted(os.listdir(tmp_path))
    newest = os.path.join(str(tmp_path), names[-1])
    raw = bytearray(open(newest, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(newest, "wb").write(bytes(raw))

    recovered = ck.load_latest(fp)
    assert recovered is not None
    assert recovered.batch_index == 4  # fell back to the older snapshot
    assert recovered.stacks["k"][0][1].num_matches == 4
    # a different fingerprint must not resume from these files
    assert ck.load_latest(run_fingerprint(["other"], 100)) is None


def test_checkpoint_save_failure_does_not_kill_run(tmp_path):
    """Storage refusing checkpoint writes degrades resumability only: the
    run completes with correct metrics."""
    inner = InMemoryFileSystem()
    sched = FaultSchedule(error_rate=1.0)  # every fs op fails
    register_filesystem(
        "fault-ck", lambda path: FaultInjectingFileSystem(inner, sched)
    )
    try:
        ck = StreamCheckpointer(
            "fault-ck://ckpts", every_batches=2,
            retry=RetryPolicy(max_attempts=2, base_delay=0.0005),
        )
        result = (
            VerificationSuite.on_data(stream_table(small_table(), batch_rows=100))
            .add_check(checks_for(1000))
            .with_checkpoint(ck)
            .run()
        )
        assert result.status == CheckStatus.SUCCESS
        assert ck.saves == 0 and ck.save_failures > 0
    finally:
        _REGISTRY.pop("fault-ck", None)


def test_with_retry_source_still_quarantines():
    """A permanently-poisoned batch must quarantine even when the retry
    layer lives on the SOURCE (with_retry): the inner layer's
    RetryExhaustedException is treated as already-exhausted, not retried
    again and not fatal."""
    table = small_table()
    sched = FaultSchedule(fail={("batch", 2): FaultSchedule.PERMANENT})
    flaky = StreamingTable(
        FlakyBatchSource(stream_table(table, batch_rows=100).source, sched)
    ).with_retry(FAST)
    result = (
        VerificationSuite.on_data(flaky)
        .add_check(
            Check(CheckLevel.ERROR, "wr")
            .is_complete("x")
            .has_size(lambda s: s == 900)
        )
        .on_batch_error("skip")
        .run()
    )
    assert result.status == CheckStatus.SUCCESS
    assert result.skipped_batches == [2]
    # the inner RetryingBatchSource spent exactly its own attempt budget
    # on the poisoned batch — the outer loop must not multiply it
    attempts = len(
        [k for k in sched.injected if k[0] == "ioerror" and k[1] == ("batch", 2)]
    )
    assert attempts == FAST.max_attempts


def test_duplicate_analyzers_fold_once():
    from deequ_tpu_torch.analyzers import Size
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    ctx = AnalysisRunner.do_analysis_run(
        stream_table(small_table(400), batch_rows=100),
        [Size(), Size()],
        on_batch_error="skip",
    )
    (metric,) = ctx.all_metrics()
    assert metric.value.get() == 400.0


def test_resilient_path_respects_group_budget():
    """Quarantine mode + group memory budget: frequency folds spill to
    disk (bounded host RAM) and still produce the plain-run metrics."""
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    table = small_table(2000)
    check = (
        Check(CheckLevel.ERROR, "b")
        .has_uniqueness(["g"], lambda v: v >= 0.0)
    )
    plain = VerificationSuite.on_data(
        stream_table(table, batch_rows=200)
    ).add_check(check).run()

    SCAN_STATS.reset()
    budgeted = (
        VerificationSuite.on_data(stream_table(table, batch_rows=200))
        .add_check(check)
        .with_group_memory_budget(1)  # 1 byte: every delta spills
        .on_batch_error("skip")
        .run()
    )
    assert budgeted.status == CheckStatus.SUCCESS
    assert metric_values(budgeted) == pytest.approx(metric_values(plain))
    assert SCAN_STATS.spill_runs > 0  # the budget was actually honored


def test_checkpoint_budget_conflict_warns(tmp_path):
    with pytest.warns(UserWarning, match="group_memory_budget is ignored"):
        result = (
            VerificationSuite.on_data(stream_table(small_table(), batch_rows=100))
            .add_check(checks_for(1000))
            .with_group_memory_budget(1)
            .with_checkpoint(str(tmp_path), every_batches=4)
            .run()
        )
    assert result.status == CheckStatus.SUCCESS


def test_checkpoint_from_other_dataset_is_ignored(tmp_path):
    """A checkpoint written over dataset A must not resume a run over
    dataset B: the fingerprint carries the source identity the source
    exposes (here: the metadata row count)."""
    # same ANALYZER set both runs (assertion lambdas are constraint-side,
    # Size()/Completeness('x') are the fold keys) — only the data differs
    check_a = (
        Check(CheckLevel.ERROR, "fp")
        .is_complete("x")
        .has_size(lambda s: s == 1000)
    )
    ckpt_dir = str(tmp_path / "fp")

    killed = StreamingTable(
        _KillingSource(stream_table(small_table(1000), batch_rows=100).source, 6)
    )
    with pytest.raises(_KillSwitch):
        (
            VerificationSuite.on_data(killed)
            .add_check(check_a)
            .with_checkpoint(ckpt_dir, every_batches=2)
            .run()
        )
    assert os.listdir(ckpt_dir)

    # dataset B: different rows — same analyzers, same batch geometry
    other = stream_table(small_table(1200, seed=9), batch_rows=100)
    recorder = _StartRecorder(other.source)
    result = (
        VerificationSuite.on_data(StreamingTable(recorder))
        .add_check(
            Check(CheckLevel.ERROR, "fp")
            .is_complete("x")
            .has_size(lambda s: s == 1200)
        )
        .with_checkpoint(ckpt_dir, every_batches=2)
        .run()
    )
    assert result.status == CheckStatus.SUCCESS
    assert min(recorder.starts) == 0  # no resume from A's checkpoint


def test_retry_policy_arg_covers_default_streaming_path():
    """retry_policy= (and .with_retry_policy) must retry the DEFAULT
    streaming paths too, not only the resilient branch."""
    from deequ_tpu_torch.analyzers import Mean
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    table = small_table()
    sched = FaultSchedule(fail={("batch", 3): 2})
    flaky = StreamingTable(
        FlakyBatchSource(stream_table(table, batch_rows=100).source, sched)
    )
    ctx = AnalysisRunner.do_analysis_run(
        flaky, [Mean("x")], retry_policy=FAST
    )
    (metric,) = ctx.all_metrics()
    assert metric.value.is_success
    assert metric.value.get() == pytest.approx(float(np.mean(table["x"].values)))
    assert len(sched.injected) == 2  # both transient faults were retried


def test_non_retryable_error_quarantines_without_backoff():
    """An error outside the policy's retry_on set must quarantine on the
    FIRST attempt in skip mode — the policy said backoff cannot help."""

    class Poison(OSError):  # I/O-shaped (quarantinable), filterable
        pass

    inner = stream_table(small_table(), batch_rows=100).source
    attempts = {"n": 0}

    class PoisonAt3:
        schema = property(lambda s: inner.schema)
        num_rows = property(lambda s: inner.num_rows)
        _batch_rows = property(lambda s: getattr(inner, "_batch_rows", None))

        def batches(self, columns=None, batch_rows=None):
            yield from self.batches_from(0, columns=columns, batch_rows=batch_rows)

        def batches_from(self, start=0, columns=None, batch_rows=None):
            idx = start
            for b in inner.batches_from(start, columns=columns, batch_rows=batch_rows):
                if idx == 3:
                    attempts["n"] += 1
                    raise Poison("bad payload")
                yield b
                idx += 1

    result = (
        VerificationSuite.on_data(StreamingTable(PoisonAt3()))
        .add_check(
            Check(CheckLevel.ERROR, "nr")
            .is_complete("x")
            .has_size(lambda s: s == 900)
        )
        .with_retry_policy(
            RetryPolicy(max_attempts=5, base_delay=0.0005, retry_on=(Poison,))
        )
        .on_batch_error("skip")
        .run()
    )
    # Poison IS retryable under this policy: retried to exhaustion...
    assert result.skipped_batches == [3]
    assert attempts["n"] == 5

    attempts["n"] = 0
    result2 = (
        VerificationSuite.on_data(StreamingTable(PoisonAt3()))
        .add_check(
            Check(CheckLevel.ERROR, "nr")
            .is_complete("x")
            .has_size(lambda s: s == 900)
        )
        .with_retry_policy(
            RetryPolicy(
                max_attempts=5, base_delay=0.0005, retry_on=(TimeoutError,)
            )
        )
        .on_batch_error("skip")
        .run()
    )
    # ...but when the policy EXCLUDES it from retry_on, it quarantines on
    # attempt 1 — no pointless backoff schedule
    assert result2.status == CheckStatus.SUCCESS
    assert result2.skipped_batches == [3]
    assert attempts["n"] == 1


def test_third_party_filesystem_without_rename_still_works(tmp_path):
    """A FileSystem subclass written against the pre-resilience 6-method
    interface (no rename override) must still persist atomically-enough
    via the base-class copy+delete fallback."""
    from deequ_tpu_torch.data.fs import FileSystem, _REGISTRY, register_filesystem
    from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository

    class OldSchoolFS(FileSystem):
        files = {}

        def open(self, path, mode="rb"):
            import io

            if "r" in mode:
                data = self.files[path]
                return io.BytesIO(data) if "b" in mode else io.StringIO(data.decode())
            fs = self

            class W(io.BytesIO):
                def close(inner):
                    fs.files[path] = inner.getvalue()
                    super().close()

            return W()

        def exists(self, path):
            return path in self.files

        def makedirs(self, path):
            pass

        def listdir(self, path):
            return []

        def delete(self, path):
            self.files.pop(path, None)

    register_filesystem("oldfs", lambda path: OldSchoolFS())
    try:
        repo = FileSystemMetricsRepository("oldfs://metrics.json")
        key = _save_one(repo)
        assert repo.load_by_key(key) is not None
        # no temp files left behind by the copy+delete fallback
        assert list(OldSchoolFS.files) == ["oldfs://metrics.json"]
    finally:
        _REGISTRY.pop("oldfs", None)


def test_skip_mode_terminates_on_permanently_dead_source():
    """Quarantine must not loop forever when EVERY read fails (storage
    gone, not patchily flaky): past the consecutive-skip bound the pass
    fails with a typed error instead of hanging. Modeled on a source with
    UNKNOWN batch count (known counts instead end cleanly at the bound)."""
    inner = stream_table(small_table(), batch_rows=100).source

    class Opaque:
        # no ``inner`` attribute: the runner cannot see batch geometry
        schema = property(lambda s: inner.schema)
        num_rows = property(lambda s: inner.num_rows)

        def batches(self, columns=None, batch_rows=None):
            return inner.batches(columns=columns, batch_rows=batch_rows)

        def batches_from(self, start=0, columns=None, batch_rows=None):
            return inner.batches_from(
                start, columns=columns, batch_rows=batch_rows
            )

    sched = FaultSchedule(error_rate=1.0)
    flaky = StreamingTable(FlakyBatchSource(Opaque(), sched))
    result = (
        VerificationSuite.on_data(flaky)
        .add_check(Check(CheckLevel.ERROR, "dead").is_complete("x"))
        .on_batch_error("skip")
        .with_retry_policy(RetryPolicy(max_attempts=2, base_delay=0.0002))
        .run()
    )
    assert result.status == CheckStatus.ERROR
    (metric,) = result.metrics.values()
    assert metric.value.is_failure
    assert "permanently dead" in str(metric.value.exception)


def test_skip_mode_reports_fully_quarantined_bounded_source():
    """When the batch count IS known and every real batch is unreadable,
    the run completes with every index reported — accurate accounting,
    not a blanket 'dead storage' error."""
    sched = FaultSchedule(error_rate=1.0)
    flaky = StreamingTable(
        FlakyBatchSource(stream_table(small_table(), batch_rows=100).source, sched)
    )
    result = (
        VerificationSuite.on_data(flaky)
        .add_check(Check(CheckLevel.ERROR, "allq").is_complete("x"))
        .on_batch_error("skip")
        .with_retry_policy(RetryPolicy(max_attempts=2, base_delay=0.0002))
        .run()
    )
    assert result.skipped_batches == list(range(10))
    (metric,) = result.metrics.values()
    assert metric.value.is_failure  # no data survived to compute from


def test_failed_analyzer_stays_failed_after_resume(tmp_path):
    """An analyzer that dropped out before a checkpoint must NOT be
    revived by resume: a success metric over a gap of batches would be
    silently wrong."""
    from deequ_tpu_torch.analyzers import Mean, Size
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    calls = {"n": 0}

    class FailsOnThirdBatch(Size):
        def state_from_scan_result(self, result):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("poisoned batch payload")
            return super().state_from_scan_result(result)

    table = small_table(1200)
    flaky_size = FailsOnThirdBatch()
    analyzers = [flaky_size, Mean("x")]
    ckpt_dir = str(tmp_path / "sticky")

    killed = StreamingTable(
        _KillingSource(stream_table(table, batch_rows=100).source, kill_at=8)
    )
    with pytest.raises(_KillSwitch):
        AnalysisRunner.do_analysis_run(
            killed, analyzers, checkpoint=StreamCheckpointer(
                ckpt_dir, every_batches=2
            )
        )

    resumed = AnalysisRunner.do_analysis_run(
        stream_table(table, batch_rows=100),
        analyzers,
        checkpoint=StreamCheckpointer(ckpt_dir, every_batches=2),
    )
    size_metric = resumed.metric_map[flaky_size]
    assert size_metric.value.is_failure
    assert "kept failed on resume" in str(size_metric.value.exception)
    # the healthy analyzer still resumed to the correct value
    assert resumed.metric_map[Mean("x")].value.get() == pytest.approx(
        float(np.mean(table["x"].values))
    )
    # and it was never re-folded from batch 0 (3 calls in run 1, 0 after)
    assert calls["n"] == 3


def test_checkpoint_unserializable_state_is_best_effort(tmp_path):
    """A fold state with no registered codec (user-defined State) makes
    the checkpoint fail gracefully, never the run."""

    class Oddball:
        pass

    ck = StreamCheckpointer(str(tmp_path), every_batches=1)
    ok = ck.save(
        run_fingerprint(["k"], None),
        StreamCheckpoint(1, [], {"k": [(0, Oddball())]}),
    )
    assert ok is False
    assert ck.save_failures == 1
    assert os.listdir(tmp_path) == []


def test_corrupt_decode_error_is_quarantinable():
    """A typed corruption error mid-decode (torn data page) is exactly
    the 'poisoned batch' quarantine exists for — skipped, not fatal."""
    inner = stream_table(small_table(), batch_rows=100).source

    class CorruptAt3:
        schema = property(lambda s: inner.schema)
        num_rows = property(lambda s: inner.num_rows)
        _batch_rows = property(lambda s: getattr(inner, "_batch_rows", None))

        def batches(self, columns=None, batch_rows=None):
            yield from self.batches_from(0, columns=columns, batch_rows=batch_rows)

        def batches_from(self, start=0, columns=None, batch_rows=None):
            idx = start
            for b in inner.batches_from(start, columns=columns, batch_rows=batch_rows):
                if idx == 3:
                    raise CorruptStateException("batch 3", "torn data page")
                yield b
                idx += 1

    result = (
        VerificationSuite.on_data(StreamingTable(CorruptAt3()))
        .add_check(
            Check(CheckLevel.ERROR, "cq")
            .is_complete("x")
            .has_size(lambda s: s == 900)
        )
        .with_retry_policy(FAST)
        .on_batch_error("skip")
        .run()
    )
    assert result.status == CheckStatus.SUCCESS
    assert result.skipped_batches == [3]


def test_fingerprint_sees_through_retry_wrapper(tmp_path):
    """with_retry wraps the source; the checkpoint fingerprint must still
    see the underlying file identity, so a checkpoint from dataset A
    never resumes a run over dataset B."""
    from deequ_tpu_torch.data.source import TableBatchSource

    class NamedSource(TableBatchSource):
        def __init__(self, table, batch_rows, paths):
            super().__init__(table, batch_rows)
            self.paths = paths

    check = (
        Check(CheckLevel.ERROR, "id").is_complete("x").has_size(lambda s: s > 0)
    )
    ckpt_dir = str(tmp_path / "id")
    table = small_table(1000)

    killed = StreamingTable(
        _KillingSource(NamedSource(table, 100, ["a.parquet"]), kill_at=6)
    ).with_retry(FAST)
    with pytest.raises(_KillSwitch):
        (
            VerificationSuite.on_data(killed)
            .add_check(check)
            .with_checkpoint(ckpt_dir, every_batches=2)
            .run()
        )
    assert os.listdir(ckpt_dir)

    # different file, same rows + analyzers + geometry: must NOT resume
    other = small_table(1000, seed=5)
    rec_b = _StartRecorder(NamedSource(other, 100, ["b.parquet"]))
    (
        VerificationSuite.on_data(StreamingTable(rec_b).with_retry(FAST))
        .add_check(check)
        .with_checkpoint(ckpt_dir, every_batches=2)
        .run()
    )
    assert min(rec_b.starts) == 0

    # the SAME file resumes (the retry wrapper must not hide identity) —
    # rerun the killed config's path with clean data
    killed2 = StreamingTable(
        _KillingSource(NamedSource(table, 100, ["a.parquet"]), kill_at=6)
    ).with_retry(FAST)
    with pytest.raises(_KillSwitch):
        (
            VerificationSuite.on_data(killed2)
            .add_check(check)
            .with_checkpoint(ckpt_dir, every_batches=2)
            .run()
        )
    rec_a = _StartRecorder(NamedSource(table, 100, ["a.parquet"]))
    result = (
        VerificationSuite.on_data(StreamingTable(rec_a).with_retry(FAST))
        .add_check(check)
        .with_checkpoint(ckpt_dir, every_batches=2)
        .run()
    )
    assert result.status == CheckStatus.SUCCESS
    assert min(rec_a.starts) == 6


def test_with_retry_works_on_batches_only_source():
    """A duck-typed source implementing only batches()/schema must still
    work through with_retry (the wrapper falls back to the protocol's
    islice seek)."""

    inner = stream_table(small_table(400), batch_rows=100).source

    class BatchesOnly:
        schema = property(lambda s: inner.schema)
        num_rows = property(lambda s: inner.num_rows)

        def batches(self, columns=None, batch_rows=None):
            return inner.batches(columns=columns, batch_rows=batch_rows)

    result = (
        VerificationSuite.on_data(StreamingTable(BatchesOnly()).with_retry(FAST))
        .add_check(
            Check(CheckLevel.ERROR, "duck")
            .is_complete("x")
            .has_size(lambda s: s == 400)
        )
        .run()
    )
    assert result.status == CheckStatus.SUCCESS


def test_eof_probe_error_does_not_quarantine_phantom_batches():
    """A source that errors on the end-of-stream probe (e.g. a trailing
    corrupt file) must not quarantine indices past the last real batch or
    fail a run whose data was fully read."""
    # 10 real batches; the probe of batch 10 (and anything past it)
    # always raises
    sched = FaultSchedule(
        fail={("batch", i): FaultSchedule.PERMANENT for i in range(10, 30)}
    )
    flaky = StreamingTable(
        FlakyBatchSource(stream_table(small_table(), batch_rows=100).source, sched)
    )
    result = (
        VerificationSuite.on_data(flaky)
        .add_check(
            Check(CheckLevel.ERROR, "eof")
            .is_complete("x")
            .has_size(lambda s: s == 1000)  # every real row counted
        )
        .with_retry_policy(FAST)
        .on_batch_error("skip")
        .run()
    )
    assert result.status == CheckStatus.SUCCESS
    assert result.skipped_batches == []


def test_empty_stream_resilient_path():
    empty = stream_table(small_table(0))
    result = (
        VerificationSuite.on_data(empty)
        .add_check(Check(CheckLevel.ERROR, "e").has_size(lambda s: s == 0))
        .on_batch_error("skip")
        .run()
    )
    assert result.status == CheckStatus.SUCCESS
    assert metric_values(result)["Size(where=None)"] == 0.0


def test_resilient_loop_fetches_at_checkpoint_boundaries(tmp_path):
    """The resilient streaming loop defers each batch's fused scan and
    drains them with ONE coalesced fetch per checkpoint boundary — 16
    batches checkpointed every 4 cost ~4 scan fetches, not 16 — while
    metrics stay bit-identical to the undeferred (per-batch, device-
    folded) semantics."""
    from deequ_tpu_torch.analyzers import Completeness, Maximum, Mean, Size
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    table = small_table(1600, seed=11)
    analyzers = [Size(), Completeness("x"), Mean("x"), Maximum("g")]

    plain = AnalysisRunner.do_analysis_run(table, analyzers)

    ck = StreamCheckpointer(str(tmp_path / "ck"), every_batches=4)
    SCAN_STATS.reset()
    ctx = AnalysisRunner.do_analysis_run(
        stream_table(table, batch_rows=100), analyzers, checkpoint=ck
    )
    assert SCAN_STATS.scan_passes == 16  # one fused scan per batch
    # scan-result fetches coalesce at the 4 checkpoint boundaries (the
    # grouping-free workload does no other device->host materialization)
    assert SCAN_STATS.device_fetches <= 5, SCAN_STATS.device_fetches
    assert SCAN_STATS.deferred_fetches == 4
    assert ck.saves == 4
    for a in analyzers:
        va = plain.metric_map[a].value.get()
        vb = ctx.metric_map[a].value.get()
        # counts/extrema exact; float sums within folding tolerance of
        # the single-chunk run
        assert va == vb or abs(va - vb) <= 1e-12 * max(abs(va), 1.0), (
            a, va, vb)


def test_deferred_batch_scan_failure_isolates_and_run_continues(tmp_path):
    """A batch whose deferred fold blows up at the drain boundary fails
    only ITS analyzers' shared scan (sticky, shared-scan rule); the
    stream completes and non-scan analyzers still succeed."""
    from deequ_tpu_torch.analyzers import Histogram, Mean, Size
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    table = small_table(800, seed=13)
    analyzers = [Size(), Mean("x"), Histogram("g")]

    import deequ_tpu_torch.ops.scan_engine as se

    original = se.fetch_deferred
    calls = {"n": 0}

    def sabotage_first(scans):
        calls["n"] += 1
        if calls["n"] == 1 and scans:
            scans[0]._fold.unflatten = lambda *a, **k: (_ for _ in ()).throw(
                RuntimeError("injected drain failure")
            )
        return original(scans)

    se.fetch_deferred = sabotage_first
    try:
        ctx = AnalysisRunner.do_analysis_run(
            stream_table(table, batch_rows=100), analyzers,
            checkpoint=StreamCheckpointer(str(tmp_path / "ck2"),
                                          every_batches=2),
        )
    finally:
        se.fetch_deferred = original
    # the sabotaged batch's fused scan fails Size and Mean (shared scan)
    assert ctx.metric_map[analyzers[0]].value.is_failure
    assert ctx.metric_map[analyzers[1]].value.is_failure
    # Histogram folds outside the fused scan and survives
    assert ctx.metric_map[analyzers[2]].value.is_success


# -- port-only -----------------------------------------------------------------


def _checkpoint_states(pkg):
    """The same fold stacks built in ``pkg`` (the reference's or the port's
    ``analyzers`` modules): scalar, frequency and HLL states."""
    import importlib

    states = importlib.import_module(f"{pkg}.analyzers.states")
    grouping = importlib.import_module(f"{pkg}.analyzers.grouping")
    freq = grouping.FrequenciesAndNumRows(
        ("g",), (np.array([1, 4, 9], dtype=np.int64),), (np.array([True, False, False]),),
        np.array([3, 1, 2], dtype=np.int64), 6)
    return {
        "analyzer::Size(where=None)": [(2, states.NumMatches(400)), (0, states.NumMatches(100))],
        "analyzer::Mean(column='x', where=None)": [(1, states.MeanState(-3.25, 200))],
        "group::g": [(2, freq)],
    }


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_files_cross_packages(tmp_path, writer):
    """A checkpoint written by either package loads in the other: the same
    fingerprint, batch index, quarantined batches, failures and fold
    stacks (each state re-encoding to the writer's bytes)."""
    import deequ_tpu.resilience as ref_res
    import deequ_tpu.states.serde as ref_serde
    import deequ_tpu_torch.resilience as port_res
    import deequ_tpu_torch.states.serde as port_serde

    keys = sorted(_checkpoint_states("deequ_tpu"))
    geometry = (100, ["a.parquet"], 1000)
    assert ref_res.run_fingerprint(keys, geometry) == port_res.run_fingerprint(keys, geometry)
    fp = port_res.run_fingerprint(keys, geometry)
    failed = {"analyzer::Mean(column='x', where=None)": "poisoned batch payload"}
    if writer == "reference":
        stacks = _checkpoint_states("deequ_tpu")
        assert ref_res.StreamCheckpointer(str(tmp_path), every_batches=4).save(
            fp, ref_res.StreamCheckpoint(8, [3], stacks, failed))
        got = port_res.StreamCheckpointer(str(tmp_path)).load_latest(fp)
        enc_want, enc_got = ref_serde.serialize_state, port_serde.serialize_state
    else:
        stacks = _checkpoint_states("deequ_tpu_torch")
        assert port_res.StreamCheckpointer(str(tmp_path), every_batches=4).save(
            fp, port_res.StreamCheckpoint(8, [3], stacks, failed))
        got = ref_res.StreamCheckpointer(str(tmp_path)).load_latest(fp)
        enc_want, enc_got = port_serde.serialize_state, ref_serde.serialize_state
    assert got is not None
    assert (got.batch_index, got.skipped, got.failed) == (8, [3], failed)
    assert sorted(got.stacks) == keys
    for key in keys:
        assert [lvl for lvl, _ in got.stacks[key]] == [lvl for lvl, _ in stacks[key]]
        for (_, have), (_, want) in zip(got.stacks[key], stacks[key]):
            assert enc_got(have) == enc_want(want)
    assert os.listdir(tmp_path) == ["ckpt_0000000008.dqck"]


def test_on_device_error_other_than_fail_is_not_yet_ported():
    """The device fault ladder is ported: "fallback" is accepted on a
    stream (it takes the resilient loop, each batch's scan laddered) and
    gives a healthy stream's metrics; any other value raises ValueError,
    as in the reference."""
    from deequ_tpu_torch.analyzers import Size
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    stream = stream_table(small_table(200), batch_rows=100)
    ctx = AnalysisRunner.do_analysis_run(stream, [Size()], on_device_error="fallback")
    assert [m.value.get() for m in ctx.all_metrics()] == [200.0]
    fallback = VerificationSuite.do_verification_run(
        stream, [checks_for(200)], on_device_error="fallback")
    ok = VerificationSuite.do_verification_run(
        stream, [checks_for(200)], on_device_error="fail")
    assert fallback.status == ok.status == CheckStatus.SUCCESS
    assert {repr(a): m.value.get() for a, m in fallback.metrics.items()} == {
        repr(a): m.value.get() for a, m in ok.metrics.items()}
    assert fallback.device_events == []
    for bogus in ("retry", "cpu"):
        with pytest.raises(ValueError, match="on_device_error"):
            AnalysisRunner.do_analysis_run(stream, [Size()], on_device_error=bogus)
        with pytest.raises(ValueError, match="on_device_error"):
            VerificationSuite.do_verification_run(
                stream, [checks_for(200)], on_device_error=bogus)


def _mixed_table(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return ColumnarTable([
        Column("x", DType.FRACTIONAL, values=rng.normal(5.0, 2.0, n),
               mask=rng.random(n) > 0.02),
        Column("g", DType.INTEGRAL, values=rng.integers(0, 300, n).astype(np.int64)),
        Column("s", DType.STRING, codes=rng.integers(-1, 9, n).astype(np.int32),
               dictionary=np.array([f"v{i}" for i in range(9)], dtype=object)),
    ])


def test_quarantine_of_a_mixed_suite_equals_numpy_over_the_rows_left():
    """Fused-scan metrics, a grouping set and a Histogram over a stream with
    two dead batches and transient faults elsewhere: the dead batches are
    reported and every metric equals numpy over the rows that remain."""
    from deequ_tpu_torch.analyzers import Histogram, Maximum, Size, Sum, Uniqueness
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    table, rows = _mixed_table(1000, 3), 100
    sched = FaultSchedule(fail={("batch", 2): FaultSchedule.PERMANENT,
                                ("batch", 7): FaultSchedule.PERMANENT,
                                ("batch", 4): 2, ("batch", 9): 1})
    flaky = StreamingTable(FlakyBatchSource(stream_table(table, batch_rows=rows).source, sched))
    analyzers = [Size(), Sum("x"), Maximum("x"), Uniqueness(["g"]), Histogram("s")]
    ctx = AnalysisRunner.do_analysis_run(
        flaky, analyzers, retry_policy=FAST, on_batch_error="skip")
    assert ctx.skipped_batches == [2, 7]
    keep = np.ones(1000, dtype=bool)
    keep[200:300] = keep[700:800] = False
    x, mask = table["x"].values[keep], table["x"].mask[keep]
    assert ctx.metric(Size()).value.get() == float(keep.sum())
    assert ctx.metric(Sum("x")).value.get() == pytest.approx(float(x[mask].sum()), rel=1e-12)
    assert ctx.metric(Maximum("x")).value.get() == float(x[mask].max())
    _, counts = np.unique(table["g"].values[keep], return_counts=True)
    assert ctx.metric(Uniqueness(["g"])).value.get() == (counts == 1).sum() / keep.sum()
    codes = table["s"].codes[keep]
    dist = ctx.metric(Histogram("s")).value.get()
    assert dist.values["NullValue"].absolute == int((codes < 0).sum())
    assert {k: v.absolute for k, v in dist.values.items() if k != "NullValue"} == {
        f"v{i}": int((codes == i).sum()) for i in range(9) if (codes == i).any()}


def test_budgeted_checkpointed_resume_warns_and_keeps_bits(tmp_path):
    """A group budget with a checkpoint is ignored with one
    GroupBudgetIgnoredWarning a run, and the killed and resumed run
    still gives the uninterrupted run's bits (grouping sets included)."""
    import warnings

    from deequ_tpu_torch.exceptions import GroupBudgetIgnoredWarning

    table = _mixed_table(1200, 5)
    check = (Check(CheckLevel.ERROR, "b").has_uniqueness(["g"], lambda v: v >= 0.0)
             .has_mean("x", lambda v: True).has_entropy("s", lambda v: True))

    def run(data, directory):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            result = (VerificationSuite.on_data(data).add_check(check)
                      .with_group_memory_budget(1)
                      .with_checkpoint(directory, every_batches=3).run())
        assert [w.category for w in seen] == [GroupBudgetIgnoredWarning]
        return result

    ref = run(stream_table(table, batch_rows=100), str(tmp_path / "ref"))
    killed = StreamingTable(_KillingSource(stream_table(table, batch_rows=100).source, 7))
    with pytest.raises(_KillSwitch):
        run(killed, str(tmp_path / "run"))
    recorder = _StartRecorder(stream_table(table, batch_rows=100).source)
    resumed = run(StreamingTable(recorder), str(tmp_path / "run"))
    assert recorder.starts == [6]
    bits = lambda r: {k: np.float64(v).tobytes() for k, v in metric_values(r).items()}  # noqa: E731
    assert bits(resumed) == bits(ref)
