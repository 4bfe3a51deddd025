"""VerificationSuite — the flagship entry point (reference layer L7,
VerificationSuite.scala, VerificationRunBuilder.scala,
VerificationResult.scala; the counterpart of ``deequ_tpu/verification.py``).

    result = (VerificationSuite.on_data(table)
              .add_check(Check(CheckLevel.ERROR, "tests")
                         .is_complete("id")
                         .has_size(lambda n: n >= 100))
              .run())

The run executes on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` here, or the ``deequ_tpu_torch.use_device`` scope); with
no CUDA device and no such request, ``run()`` raises
``DeviceUnavailableException``. The checks are evaluated on the run's
device too: a Holt-Winters anomaly check fits on it.

With a metrics repository (``use_repository``), a run reuses the results
stored under a key, appends its own under another, and holds metrics
against their history (``add_anomaly_check``)::

    result = (VerificationSuite.on_data(table)
              .use_repository(repo)
              .save_or_append_result(ResultKey(day, {"tenant": "t0"}))
              .add_anomaly_check(OnlineNormalStrategy(), Size())
              .run())
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.runner import (
    AnalysisRunner,
    AnalyzerContext,
    _save_or_append_result,
)
from deequ_tpu_torch.checks import Check, CheckLevel, CheckResult, CheckStatus
from deequ_tpu_torch.data.table import ColumnarTable, Schema
from deequ_tpu_torch.device import use_device
from deequ_tpu_torch.parallel.mesh import _UNSET, resolve_placement, use_mesh
from deequ_tpu_torch.metrics import Metric


@dataclass
class VerificationResult:
    """(reference VerificationResult.scala:33-119)

    ``device`` names the device the run executed on; ``scan_stats`` holds
    the run's deltas of the engine counters (``scan_passes``,
    ``device_fetches``, ``bytes_fetched``, ``grouping_passes``,
    ``hist_kernel_dispatches``, ``hist_plain_dispatches``,
    ``hist_host_dispatches``): the observable for the one-fetch-per-scan
    contract and for the dense grouping counts going through the kernel;
    over a stream also the stream's and the spill engine's counters.
    ``skipped_batches``: the stream batch indices a run with
    ``on_batch_error="skip"`` quarantined (reference
    VerificationResult.skipped_batches).

    Faults and governance (the reference's fields): ``device_events`` the
    rungs the run's scans took (``ScanStats.degradation_events`` of the
    run: ``oom_bisect``, ``encoded_demote``, ``watchdog_timeout``,
    ``cpu_fallback_refused``, ``budget_exhausted``); ``retry_stats`` the
    run's retry telemetry (``resilience/retry.py:RETRY_TELEMETRY``:
    invocations, failed attempts, retries, backoff seconds, exhausted, the
    last exception); ``unverified_row_ranges`` the [start, stop) rows the
    run finished without verifying — non-empty means the metrics cover a
    strict subset of the data; ``run_budget`` the armed run budget's
    ledger (empty when the run was ungoverned).

    Meshes (the reference's fields): ``mesh_events`` the mesh-level rows
    of ``device_events`` (``mesh_reshard``, ``mesh_quarantine``,
    ``mesh_straggler``, ``stale_residency_evicted``, ``peer_lost``);
    ``resharded`` True when a scan of the run finished on a mesh shrunk
    around lost members — its metrics are those of a healthy run on the
    smaller mesh. A multi-process run under ``on_peer_loss="degrade"``
    that lost a peer lists the peer's rows on ``unverified_row_ranges``.

    Tracing (``obs/``, armed by ``with_tracing()``,
    ``do_verification_run(trace=...)`` or ``DEEQU_TORCH_TRACE=1``; off by
    default): ``run_trace`` the run's per-phase breakdown
    (``FlightRecorder.summary``: spans and events by name, wall seconds a
    phase; the execute and fetch phases cover the wall ``scan_stats``
    counts as ``dispatch_seconds`` and ``drain_wait_seconds``), empty for
    an untraced run; ``trace_recorder`` the recorder (export it with
    ``obs.write_chrome_trace``), None for an untraced run."""

    status: CheckStatus
    check_results: Dict[Check, CheckResult]
    metrics: Dict[Analyzer, Metric]
    skipped_batches: List[int] = field(default_factory=list)
    device: str = ""
    scan_stats: Dict[str, object] = field(default_factory=dict)
    device_events: List[dict] = field(default_factory=list)
    retry_stats: Dict[str, object] = field(default_factory=dict)
    unverified_row_ranges: List[tuple] = field(default_factory=list)
    run_budget: Dict[str, object] = field(default_factory=dict)
    mesh_events: List[dict] = field(default_factory=list)
    resharded: bool = False
    run_trace: Dict[str, object] = field(default_factory=dict)
    trace_recorder: Optional[object] = field(default=None, repr=False, compare=False)

    @staticmethod
    def success_metrics_as_rows(
        result: "VerificationResult",
        for_analyzers: Optional[Sequence[Analyzer]] = None,
    ) -> List[dict]:
        return AnalyzerContext.success_metrics_as_rows(
            AnalyzerContext(result.metrics), for_analyzers
        )

    @staticmethod
    def success_metrics_as_json(
        result: "VerificationResult",
        for_analyzers: Optional[Sequence[Analyzer]] = None,
    ) -> str:
        return json.dumps(VerificationResult.success_metrics_as_rows(result, for_analyzers))

    @staticmethod
    def check_results_as_rows(result: "VerificationResult") -> List[dict]:
        rows = []
        for check, check_result in result.check_results.items():
            for cr in check_result.constraint_results:
                rows.append(
                    {
                        "check": check.description,
                        "check_level": check.level.value,
                        "check_status": check_result.status.value,
                        "constraint": str(cr.constraint),
                        "constraint_status": cr.status.value,
                        "constraint_message": cr.message or "",
                    }
                )
        return rows

    @staticmethod
    def check_results_as_json(result: "VerificationResult") -> str:
        return json.dumps(VerificationResult.check_results_as_rows(result))


_STAT_KEYS = (
    "scan_passes",
    "device_fetches",
    "bytes_fetched",
    "grouping_passes",
    "hist_kernel_dispatches",
    "hist_plain_dispatches",
    "hist_host_dispatches",
    "chunks_staged",
    "bytes_staged",
    "fold_drains",
    "kll_compactions",
    "spill_runs",
    "spill_bytes_written",
    "spill_bytes_read",
    "spill_merge_passes",
    "deferred_fetches",
    "device_faults",
    "oom_bisections",
    "encoded_demotions",
    "watchdog_timeouts",
    "fallback_refused",
    "budget_charges",
    "budget_exhaustions",
    "mesh_faults",
    "mesh_reshards",
    "mesh_stragglers",
    "peer_losses",
    "dispatch_seconds",
    "drain_wait_seconds",
)

#: the degradation kinds of mesh-level decisions (``mesh_events``)
_MESH_EVENT_KINDS = frozenset((
    "mesh_reshard",
    "mesh_quarantine",
    "mesh_straggler",
    "stale_residency_evicted",
    "peer_lost",
))


def _required(checks: Sequence[Check], required_analyzers) -> List[Analyzer]:
    """The analyzers a run needs: the required ones, then each check's,
    de-duplicated."""
    analyzers = list(required_analyzers)
    for check in checks:
        analyzers.extend(check.required_analyzers())
    return _dedup_analyzers(analyzers)


def _dedup_analyzers(analyzers: Sequence[Analyzer]) -> List[Analyzer]:
    """Order-preserving de-dup (reference unions into a Set)."""
    seen = set()
    unique = []
    for a in analyzers:
        if a not in seen:
            seen.add(a)
            unique.append(a)
    return unique


class VerificationSuite:
    """(reference VerificationSuite.scala:49-315)"""

    @staticmethod
    def on_data(data: ColumnarTable, device=None) -> "VerificationRunBuilder":
        """A run over ``data``: a ColumnarTable (persisted or not) or a
        StreamingTable, which the run reads a batch at a time."""
        return VerificationRunBuilder(data, device)

    @staticmethod
    def run(
        data: ColumnarTable,
        checks: Sequence[Check],
        required_analyzers: Sequence[Analyzer] = (),
        device=None,
        trace=None,
    ) -> VerificationResult:
        return VerificationSuite.do_verification_run(
            data, checks, required_analyzers, device, trace=trace
        )

    @staticmethod
    def do_verification_run(
        data: ColumnarTable,
        checks: Sequence[Check],
        required_analyzers: Sequence[Analyzer] = (),
        device=None,
        aggregate_with=None,
        save_states_with=None,
        metrics_repository=None,
        reuse_existing_results_for_key=None,
        fail_if_results_missing: bool = False,
        save_or_append_results_with_key=None,
        group_memory_budget: Optional[int] = None,
        checkpoint=None,
        on_batch_error: str = "fail",
        retry_policy=None,
        on_device_error: str = "fail",
        device_deadline: Optional[float] = None,
        run_deadline: Optional[float] = None,
        max_total_attempts: Optional[int] = None,
        on_budget_exhausted: Optional[str] = None,
        shard_deadline: Optional[float] = None,
        on_peer_loss: Optional[str] = None,
        peer_timeout: Optional[float] = None,
        mesh=_UNSET,
        trace=None,
    ) -> VerificationResult:
        """One verification run; ``aggregate_with`` (a StateLoader) merges
        saved states into this run's, ``save_states_with`` (a
        StatePersister) saves the merged states. With
        ``metrics_repository``: ``reuse_existing_results_for_key`` takes
        the metrics stored under that key instead of computing them, and
        ``save_or_append_results_with_key`` appends the run's metrics under
        that key after the checks are evaluated, so an anomaly check never
        sees its own run in the history (reference
        VerificationSuite.scala: evaluation at L263-281, the save at
        L174-193).

        ``group_memory_budget`` bounds the host bytes of grouping states
        (past it they spill to disk); on a stream ``checkpoint`` makes the
        run resumable, ``on_batch_error="skip"`` quarantines unreadable
        batches (``skipped_batches``) and ``retry_policy`` overrides the
        batch reads' RetryPolicy (``AnalysisRunner.do_analysis_run``).

        Device faults (``ops/scan_executors.py``): an OOM in a fused scan
        evicts residency, demotes an encoded layout and bisects the chunk;
        past the ladder ``on_device_error="fail"`` fails the scan's
        analyzers with the typed fault, and ``"fallback"`` — where the
        reference re-runs on its CPU — with
        ``DeviceFallbackRefusedException`` (the port never runs a CUDA run on
        the CPU). ``device_deadline`` (seconds) arms the watchdog on each
        chunk's step and fetch.

        Run governance (``resilience/governance.py``): ``run_deadline`` /
        ``max_total_attempts`` arm ONE fault budget for the whole run, which
        every rung of every scan charges (a stream's per-batch scans and
        read retries included). On exhaustion ``on_budget_exhausted=
        "degrade"`` (the default) completes with a partial result — failure
        metrics for the analyzers that could not finish and exact
        ``unverified_row_ranges`` — and ``"raise"`` raises a typed
        ``RunBudgetExhaustedException``. The ledger lands on
        ``run_budget``, the rungs on ``device_events``, the retries on
        ``retry_stats``.

        Meshes (``parallel/mesh.py``): the run takes ``mesh`` (default: the
        ``use_mesh`` scope, else the default mesh of a machine with several
        cards when no device was asked for) and shards every scan and
        dense count over it. A fault that names members reshards onto the
        survivors (``mesh_events``, ``resharded``); ``shard_deadline``
        (seconds) arms the straggler watchdog. ``on_peer_loss`` (None: no
        check) runs ``parallel/distributed.py:check_peers`` inside the
        run, before the analysis: ``"fail"`` raises a typed
        ``PeerLostException`` when a peer process stopped responding,
        ``"degrade"`` reports the lost ranks' row ranges on
        ``unverified_row_ranges``; ``peer_timeout`` overrides the probe's
        timeout.

        Tracing (``obs/``): ``trace`` arms the flight recorder for this run
        — a FlightRecorder, ``True`` (the ``DEEQU_TORCH_TRACE``-armed global
        recorder, else a fresh one for this run) or ``False`` (no tracing,
        the global recorder included); None takes the caller's scope or the
        global recorder. Nothing is armed process-wide. The run is one
        ``verification_run`` span around every seam's spans and events; the
        summary lands on ``run_trace``, the recorder on
        ``trace_recorder``."""
        from deequ_tpu_torch.obs.recorder import (
            current_recorder,
            maybe_arm_from_env,
            recording_scope,
            resolve_recorder,
        )
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
        from deequ_tpu_torch.resilience.governance import (
            current_run_budget,
            resolve_run_policy,
            run_budget_scope,
        )
        from deequ_tpu_torch.resilience.retry import RETRY_TELEMETRY

        dev, mesh = resolve_placement(device, mesh)
        retry_before = RETRY_TELEMETRY.snapshot()
        # the run's own counts, events and unverified ranges: other threads
        # (a fleet's other workers) scan at the same time
        with SCAN_STATS.tally() as own:
            # ONE budget for the whole run (unless the caller's scope holds
            # one): every charge site of every scan draws on it
            budget = current_run_budget()
            armed_here = None
            if budget is None:
                policy = resolve_run_policy(run_deadline, max_total_attempts, on_budget_exhausted)
                if policy is not None:
                    budget = armed_here = policy.arm()
            # the recorder: the trace argument, else the caller's scope, else
            # the global one; the run's summary is a delta from here
            maybe_arm_from_env()
            recorder = resolve_recorder(trace) if trace is not None else current_recorder()
            trace_since = time.monotonic() if recorder is not None else None
            trace_dropped = recorder.dropped if recorder is not None else 0
            with contextlib.ExitStack() as scopes:
                if trace is not None:
                    scopes.enter_context(recording_scope(recorder))
                if recorder is not None:
                    scopes.enter_context(recorder.span("verification_run"))
                if armed_here is not None:
                    scopes.enter_context(run_budget_scope(budget))
                # the peer check runs inside the run, after the baselines, so a
                # degraded outcome lands on this result
                if on_peer_loss is not None:
                    from deequ_tpu_torch.parallel.distributed import (
                        DEFAULT_PEER_TIMEOUT,
                        check_peers,
                    )

                    # a source that does not know its rows still gets the check;
                    # the lost ranks' rows just cannot be named
                    try:
                        total_rows = int(data.num_rows or 0)
                    except (AttributeError, TypeError):
                        total_rows = 0
                    check_peers(
                        total_rows,
                        timeout=DEFAULT_PEER_TIMEOUT if peer_timeout is None else peer_timeout,
                        on_peer_loss=on_peer_loss,
                    )
                context = AnalysisRunner.do_analysis_run(
                    data, _required(checks, required_analyzers), dev,
                    aggregate_with=aggregate_with, save_states_with=save_states_with,
                    metrics_repository=metrics_repository,
                    reuse_existing_results_for_key=reuse_existing_results_for_key,
                    fail_if_results_missing=fail_if_results_missing,
                    retry_policy=retry_policy,
                    group_memory_budget=group_memory_budget,
                    checkpoint=checkpoint,
                    on_batch_error=on_batch_error,
                    on_device_error=on_device_error,
                    device_deadline=device_deadline,
                    mesh=mesh,
                    shard_deadline=shard_deadline,
                )
            with use_device(dev), use_mesh(mesh):
                result = VerificationSuite._evaluate(checks, context)
                _save_or_append_result(
                    metrics_repository, save_or_append_results_with_key, context
                )
        result.device = str(dev)
        result.scan_stats = {k: own.counts.get(k, 0) for k in _STAT_KEYS}
        result.device_events = [dict(e) for e in own.events]
        result.mesh_events = [e for e in result.device_events
                              if e.get("kind") in _MESH_EVENT_KINDS]
        result.resharded = any(e.get("kind") == "mesh_reshard" for e in result.mesh_events)
        result.unverified_row_ranges = [tuple(r) for r in own.unverified]
        result.retry_stats = RETRY_TELEMETRY.delta_since(retry_before)
        if budget is not None:
            result.run_budget = budget.snapshot()
        if recorder is not None:
            result.run_trace = recorder.summary(since=trace_since,
                                                dropped_baseline=trace_dropped)
            result.trace_recorder = recorder
        return result

    @staticmethod
    def run_on_aggregated_states(
        schema: Schema,
        checks: Sequence[Check],
        state_loaders: Sequence,
        required_analyzers: Sequence[Analyzer] = (),
        save_states_with=None,
        metrics_repository=None,
        save_or_append_results_with_key=None,
    ) -> VerificationResult:
        """Verification from saved states alone, with no scan: each
        analyzer's states merge across ``state_loaders`` (reference
        VerificationSuite.scala:208-229)."""
        ctx = AnalysisRunner.run_on_aggregated_states(
            schema, _required(checks, required_analyzers), state_loaders,
            save_states_with=save_states_with,
            metrics_repository=metrics_repository,
            save_or_append_results_with_key=save_or_append_results_with_key,
        )
        return VerificationSuite._evaluate(checks, ctx)

    @staticmethod
    def is_check_applicable_to_data(check: Check, schema: Schema):
        """Dry-run a check over random data of the schema
        (reference VerificationSuite.scala:238-248; ``applicability.py``)."""
        from deequ_tpu_torch.applicability import Applicability

        return Applicability.is_check_applicable(check, schema)

    @staticmethod
    def are_analyzers_applicable_to_data(analyzers: Sequence[Analyzer], schema: Schema):
        """(reference VerificationSuite.scala:251-261)"""
        from deequ_tpu_torch.applicability import Applicability

        return Applicability.are_analyzers_applicable(analyzers, schema)

    @staticmethod
    def _evaluate(
        checks: Sequence[Check], analysis_context: AnalyzerContext
    ) -> VerificationResult:
        """(reference VerificationSuite.scala:263-281)"""
        check_results = {c: c.evaluate(analysis_context) for c in checks}
        if not check_results:
            status = CheckStatus.SUCCESS
        else:
            status = max(
                (r.status for r in check_results.values()),
                key=lambda s: s.severity,
            )
        return VerificationResult(
            status, check_results, dict(analysis_context.metric_map),
            list(analysis_context.skipped_batches),
        )


class IncrementalVerificationStream:
    """Pipelined incremental verification (reference
    VerificationSuite.scala:208-229: per arriving batch, merge states and
    evaluate the checks) over the micro-batched scan of
    ``analyzers/incremental.py``. Checks are evaluated at drain time in
    submission order, so each batch's result is the serial loop's::

        stream = IncrementalVerificationStream(
            checks=[check], aggregate_with=states, save_states_with=states,
        )
        for key, batch in arriving:
            for done_key, result in stream.submit(batch, result_key=key):
                ...
        for done_key, result in stream.close():
            ...

    With ``metrics_repository``, each batch's metrics are appended under
    its ``result_key`` after its checks are evaluated (reference
    ordering: an anomaly check never sees its own batch)."""

    def __init__(
        self,
        checks: Sequence[Check],
        required_analyzers: Sequence[Analyzer] = (),
        aggregate_with=None,
        save_states_with=None,
        metrics_repository=None,
        window: int = 8,
        device=None,
    ):
        from deequ_tpu_torch.analyzers.incremental import IncrementalAnalysisStream

        self.checks = list(checks)
        self.metrics_repository = metrics_repository
        self._stream = IncrementalAnalysisStream(
            _required(self.checks, required_analyzers),
            aggregate_with=aggregate_with,
            save_states_with=save_states_with,
            window=window,
            device=device,
        )

    def _finalize(self, drained):
        out = []
        with use_device(self._stream.device), use_mesh(self._stream.mesh):
            for result_key, ctx in drained:
                result = VerificationSuite._evaluate(self.checks, ctx)
                _save_or_append_result(self.metrics_repository, result_key, ctx)
                result.device = str(self._stream.device)
                out.append((result_key, result))
        return out

    def submit(self, data: ColumnarTable, result_key=None):
        """Buffer one batch; returns the (result_key, VerificationResult)
        pairs of batches drained now."""
        return self._finalize(self._stream.submit(data, tag=result_key))

    def close(self):
        """Drain everything still in flight (FIFO)."""
        return self._finalize(self._stream.close())


@dataclass(frozen=True)
class AnomalyCheckConfig:
    """(reference VerificationRunBuilder.scala:336-341)"""

    level: CheckLevel
    description: str
    with_tag_values: dict = field(default_factory=dict)
    after_date: Optional[int] = None
    before_date: Optional[int] = None


class VerificationRunBuilder:
    """Fluent configuration (reference VerificationRunBuilder.scala:28-182)."""

    def __init__(self, data: ColumnarTable, device=None):
        self._data = data
        self._device = device
        self._checks: List[Check] = []
        self._required_analyzers: List[Analyzer] = []
        self._aggregate_with = None
        self._save_states_with = None
        self._metrics_repository = None
        self._reuse_key = None
        self._fail_if_results_missing = False
        self._save_key = None
        self._group_memory_budget: Optional[int] = None
        self._checkpoint = None
        self._on_batch_error = "fail"
        self._retry_policy = None
        self._on_device_error = "fail"
        self._device_deadline: Optional[float] = None
        self._run_deadline: Optional[float] = None
        self._max_total_attempts: Optional[int] = None
        self._on_budget_exhausted: Optional[str] = None
        self._shard_deadline: Optional[float] = None
        self._on_peer_loss: Optional[str] = None
        self._peer_timeout: Optional[float] = None
        self._trace = None

    def add_check(self, check: Check) -> "VerificationRunBuilder":
        self._checks.append(check)
        return self

    def add_checks(self, checks: Sequence[Check]) -> "VerificationRunBuilder":
        self._checks.extend(checks)
        return self

    def add_required_analyzer(self, analyzer: Analyzer) -> "VerificationRunBuilder":
        self._required_analyzers.append(analyzer)
        return self

    def add_required_analyzers(self, analyzers) -> "VerificationRunBuilder":
        self._required_analyzers.extend(analyzers)
        return self

    def aggregate_with(self, state_loader) -> "VerificationRunBuilder":
        self._aggregate_with = state_loader
        return self

    def save_states_with(self, state_persister) -> "VerificationRunBuilder":
        self._save_states_with = state_persister
        return self

    def with_group_memory_budget(self, budget_bytes: int) -> "VerificationRunBuilder":
        """Bound the host bytes of grouping states: past the budget,
        frequency tables spill to disk as sorted runs and stream back at
        finalize (``spill/``), so a uniqueness check of a high-cardinality
        column costs disk bandwidth instead of memory
        (``scan_stats``: ``spill_runs``, ``spill_bytes_written``)."""
        self._group_memory_budget = int(budget_bytes)
        return self

    def with_checkpoint(self, checkpoint, every_batches: Optional[int] = None
                        ) -> "VerificationRunBuilder":
        """Make a streaming run resumable: every ``every_batches`` batches
        the fold states are saved (atomic, checksummed) to ``checkpoint``
        (a ``resilience.StreamCheckpointer`` or a directory); a run again
        after a crash resumes from the last valid checkpoint with the
        same metrics, bit for bit."""
        from deequ_tpu_torch.resilience.checkpoint import StreamCheckpointer

        if isinstance(checkpoint, str):
            checkpoint = StreamCheckpointer(checkpoint, every_batches=every_batches or 8)
        elif every_batches is not None:
            checkpoint.every_batches = int(every_batches)
        self._checkpoint = checkpoint
        return self

    def on_batch_error(self, policy: str) -> "VerificationRunBuilder":
        """A stream's policy for a batch whose reads keep failing: "fail"
        (the default: the run's analyzers fail) or "skip" (the batch is
        quarantined and its index lands on
        ``VerificationResult.skipped_batches``)."""
        if policy not in ("fail", "skip"):
            raise ValueError(f"on_batch_error must be 'fail' or 'skip', got {policy!r}")
        self._on_batch_error = policy
        return self

    def with_retry_policy(self, policy) -> "VerificationRunBuilder":
        """The RetryPolicy of this run's batch reads (default: the table's,
        else the process default)."""
        self._retry_policy = policy
        return self

    def on_device_error(self, policy: str) -> "VerificationRunBuilder":
        """The device-fault policy of this run's fused scans: "fail" (the
        default: a scan the card cannot finish fails its analyzers with the
        typed ``Device*Exception``) or "fallback" (where the reference
        re-runs the scan on its CPU, the port fails them with
        ``DeviceFallbackRefusedException``; a stream takes the resilient
        loop, so each batch gets the ladder). An OOM evicts, demotes and
        bisects under either policy. The rungs land on
        ``VerificationResult.device_events``."""
        if policy not in ("fail", "fallback"):
            raise ValueError(f"on_device_error must be 'fail' or 'fallback', got {policy!r}")
        self._on_device_error = policy
        return self

    def with_device_deadline(self, seconds: float) -> "VerificationRunBuilder":
        """Arm the watchdog: a chunk's step or a fetch of this run that
        takes longer than ``seconds`` raises a typed
        ``DeviceHangException`` instead of hanging the run (also
        ``DEEQU_TORCH_DEVICE_DEADLINE``)."""
        self._device_deadline = float(seconds)
        return self

    def with_shard_deadline(self, seconds: float) -> "VerificationRunBuilder":
        """Arm the straggler watchdog on the chunk steps of this run's
        scans over a mesh of two or more members: a member stalling past
        ``seconds`` raises a typed ``DeviceHangException`` (a
        ``mesh_straggler`` event on ``mesh_events``) instead of freezing
        the mesh. A scan on one device is not affected. Also settable
        process-wide with ``DEEQU_TORCH_SHARD_DEADLINE``."""
        self._shard_deadline = float(seconds)
        return self

    def on_peer_loss(self, policy: str, timeout: Optional[float] = None
                     ) -> "VerificationRunBuilder":
        """The multi-process peer-loss policy, checked inside the run (a
        no-op in a single process): ``"fail"`` raises a typed
        ``PeerLostException`` when a peer stopped responding; ``"degrade"``
        finishes on the surviving processes and reports the lost ranks'
        ``host_row_range`` rows on ``unverified_row_ranges``. ``timeout``
        (seconds) overrides the probe's heartbeat and barrier deadline."""
        from deequ_tpu_torch.parallel.distributed import validate_loss_mode

        validate_loss_mode(policy, "on_peer_loss")
        self._on_peer_loss = policy
        if timeout is not None:
            self._peer_timeout = float(timeout)
        return self

    def with_run_budget(
        self,
        run_deadline: Optional[float] = None,
        max_total_attempts: Optional[int] = None,
        on_budget_exhausted: str = "degrade",
    ) -> "VerificationRunBuilder":
        """Arm ONE fault budget for this run (``resilience/governance.py``):
        ``run_deadline`` bounds its wall clock, ``max_total_attempts`` the
        failure-driven attempts of every rung of every scan (I/O retries,
        OOM bisections, encoded demotions, refused CPU rungs). On
        exhaustion "degrade" completes with a partial result (failure
        metrics and exact ``unverified_row_ranges``), "raise" raises a
        typed ``RunBudgetExhaustedException``. Also
        ``DEEQU_TORCH_RUN_DEADLINE`` / ``DEEQU_TORCH_RUN_ATTEMPTS``; the
        ledger lands on ``VerificationResult.run_budget``."""
        if run_deadline is None and max_total_attempts is None:
            raise ValueError("with_run_budget needs run_deadline and/or max_total_attempts")
        if on_budget_exhausted not in ("degrade", "raise"):
            raise ValueError(
                f"on_budget_exhausted must be 'degrade' or 'raise', got {on_budget_exhausted!r}"
            )
        self._run_deadline = float(run_deadline) if run_deadline is not None else None
        self._max_total_attempts = (
            int(max_total_attempts) if max_total_attempts is not None else None
        )
        self._on_budget_exhausted = on_budget_exhausted
        return self

    def with_tracing(self, recorder=None, capacity: Optional[int] = None
                     ) -> "VerificationRunBuilder":
        """Arm the flight recorder (``obs/``) for this run: pass a
        FlightRecorder to share one across runs, or let this make one
        (``capacity`` bounds its ring). The summary lands on
        ``result.run_trace`` and the recorder on ``result.trace_recorder``
        (``obs.write_chrome_trace(result.trace_recorder, path)`` writes the
        Perfetto file). Off otherwise, unless ``DEEQU_TORCH_TRACE=1``."""
        from deequ_tpu_torch.obs.recorder import FlightRecorder

        if recorder is not None and capacity is not None:
            raise ValueError("pass either an existing recorder or a capacity, not both")
        if recorder is None:
            recorder = FlightRecorder() if capacity is None else FlightRecorder(capacity)
        self._trace = recorder
        return self

    def use_repository(self, repository) -> "VerificationRunBuilderWithRepository":
        return VerificationRunBuilderWithRepository(self, repository)

    def run(self) -> VerificationResult:
        return VerificationSuite.do_verification_run(
            self._data, self._checks, self._required_analyzers, self._device,
            aggregate_with=self._aggregate_with,
            save_states_with=self._save_states_with,
            metrics_repository=self._metrics_repository,
            reuse_existing_results_for_key=self._reuse_key,
            fail_if_results_missing=self._fail_if_results_missing,
            save_or_append_results_with_key=self._save_key,
            group_memory_budget=self._group_memory_budget,
            checkpoint=self._checkpoint,
            on_batch_error=self._on_batch_error,
            retry_policy=self._retry_policy,
            on_device_error=self._on_device_error,
            device_deadline=self._device_deadline,
            run_deadline=self._run_deadline,
            max_total_attempts=self._max_total_attempts,
            on_budget_exhausted=self._on_budget_exhausted,
            shard_deadline=self._shard_deadline,
            on_peer_loss=self._on_peer_loss,
            peer_timeout=self._peer_timeout,
            trace=self._trace,
        )


class VerificationRunBuilderWithRepository(VerificationRunBuilder):
    """(reference VerificationRunBuilder.scala:184-244)"""

    def __init__(self, base: VerificationRunBuilder, repository):
        super().__init__(base._data, base._device)
        self.__dict__.update(base.__dict__)
        self._metrics_repository = repository

    def reuse_existing_results_for_key(
        self, result_key, fail_if_results_missing: bool = False
    ) -> "VerificationRunBuilderWithRepository":
        self._reuse_key = result_key
        self._fail_if_results_missing = fail_if_results_missing
        return self

    def save_or_append_result(self, result_key) -> "VerificationRunBuilderWithRepository":
        self._save_key = result_key
        return self

    def add_anomaly_check(
        self,
        anomaly_detection_strategy,
        analyzer: Analyzer,
        anomaly_check_config: Optional[AnomalyCheckConfig] = None,
    ) -> "VerificationRunBuilderWithRepository":
        """(reference VerificationRunBuilder.scala:227-243)"""
        config = anomaly_check_config or AnomalyCheckConfig(
            CheckLevel.WARNING,
            f"Anomaly check for {analyzer!r}",
        )
        check = Check(config.level, config.description).is_newest_point_non_anomalous(
            self._metrics_repository,
            anomaly_detection_strategy,
            analyzer,
            config.with_tag_values,
            config.after_date,
            config.before_date,
        )
        self._checks.append(check)
        return self
