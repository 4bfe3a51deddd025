"""AnalysisRunner — the query planner (reference layer L4,
analyzers/runners/AnalysisRunner.scala; the counterpart of
``deequ_tpu/analyzers/runner.py``). A run resolves its device and mesh
once (``parallel/mesh.py:resolve_placement``) and holds the mesh's scope
for its whole analysis, so every fused scan and dense grouping count
inside is row-sharded over the members.

Planning pipeline, mirroring doAnalysisRun (reference L97-203):

1. partition analyzers by failing preconditions -> failure metrics;
2. split {scan-shareable | shared grouping | own pass (Histogram)};
3. fuse ALL scan-shareable analyzers into ONE pass (ops/scan_engine.py —
   the analogue of the single data.agg(...) job);
4. run each own-pass analyzer on its own (``analyzer.calculate``);
5. for each distinct grouping-column set, compute ONCE what its analyzers
   need — the count statistics when every analyzer is a function of the
   count distribution, else the frequency table — and finalize all its
   analyzers from it.

Partial failure is data: a failure inside the fused scan maps onto every
participating analyzer (reference L320-323); precondition failures become
failure metrics instead of aborting (L137-145). Where-free KLL ops of one
sketch size run as one batched op (``_coalesce_scan_ops``).

States: on every route (the fused scan, own-pass Histogram, grouping)
``aggregate_with`` merges a saved state into the computed one and
``save_states_with`` saves the result; a grouping set with either set
materialises its frequency table (the count-statistics shortcut holds no
mergeable state). ``run_on_aggregated_states`` computes metrics from
saved states alone, with no scan. The pipelined stream of arriving
batches is ``analyzers/incremental.py``.

Over a StreamingTable (reference L625-712, L1229-1265): the fused scan
streams; the own-pass analyzers share ONE read of the stream, each folding
its state a batch; each grouping set folds one frequency table a batch
(the count-statistics shortcut needs the whole table's counts).

Under a group memory budget (``group_memory_budget=``, the stream's
``with_group_memory_budget``, or ``DEEQU_TORCH_GROUP_MEMORY_BUDGET``) those
frequency folds go through a ``spill.SpillingFrequencyStore``: past the
budget they spill sorted runs to disk and stream them back merged at
finalize. A budgeted in-memory table whose grouping would build its
frequency table is cut into ``budget_batch_rows`` slices and takes the
same fold; the count-statistics route is not affected by a budget.

With ``checkpoint=`` or ``on_batch_error="skip"`` a stream takes the
resilient loop (``_run_streaming_resilient``, reference L716-1150): one
read for every analyzer, the fused scan a batch deferred and fetched at
checkpoint boundaries, host fold stacks checkpointed and resumed, and
batches that cannot be read quarantined and reported on
``AnalyzerContext.skipped_batches``; ``on_device_error="fallback"`` takes
it too, so each batch's scan gets the whole device fault ladder.

Device faults and governance: each fused scan runs the fault ladder of
``ops/scan_executors.py`` (``on_device_error``, ``device_deadline``, over a
mesh the reshard and ``shard_deadline``); a run
budget (``resilience/governance.py``, armed here from the environment when
no caller armed one) spans every scan of the analysis, and its exhaustion
under ``on_budget_exhausted="degrade"`` becomes a partial result: failure
metrics for the analyzers whose scan could not finish and the exact rows
never verified on ``SCAN_STATS.unverified_row_ranges``.

Metrics repositories (reference L116-134, L192-202): with
``reuse_existing_results_for_key`` the metrics the repository holds for
that key are taken as they are and only the rest are computed (all of
them present: no scan at all); ``save_or_append_results_with_key``
appends the run's metrics to the repository's entry for that key.
"""

from __future__ import annotations

import contextlib

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.analyzers.base import (
    Analyzer,
    ScanShareableAnalyzer,
    State,
    StreamStateFolder,
    find_first_failing,
    merge_states,
)
from deequ_tpu_torch.analyzers.grouping import (
    FrequencyBasedAnalyzer,
    Histogram,
    ScanShareableFrequencyBasedAnalyzer,
)
from deequ_tpu_torch.data.table import ColumnarTable, Schema
from deequ_tpu_torch.exceptions import (
    GroupBudgetIgnoredWarning,
    MetricCalculationRuntimeException,
    NotYetPortedException,
    ReusingNotPossibleResultsMissingException,
    RunBudgetExhaustedException,
    wrap_if_necessary,
)
from deequ_tpu_torch.metrics import Metric
from deequ_tpu_torch.ops.scan_engine import run_scan
from deequ_tpu_torch.ops.segment import group_count_stats, group_counts_state
from deequ_tpu_torch.parallel.mesh import _UNSET, resolve_placement, use_mesh


def _is_grouping_shared(analyzer: Analyzer) -> bool:
    """Grouping analyzers that share one computation per grouping set.
    Histogram is excluded: its null handling and row count differ, so it
    runs its own pass (reference Histogram.scala is a plain Analyzer)."""
    return isinstance(analyzer, FrequencyBasedAnalyzer) and not isinstance(
        analyzer, Histogram
    )


def _count_stats_capable(analyzer: Analyzer) -> bool:
    """True when the analyzer is a pure function of the count distribution
    (the ``group_count_stats`` route: group values never decode). Gated on
    an explicit override, so a subclass that implements only
    ``compute_from_frequencies`` gets the frequency table."""
    return (
        isinstance(analyzer, ScanShareableFrequencyBasedAnalyzer)
        and type(analyzer).compute_from_count_stats
        is not ScanShareableFrequencyBasedAnalyzer.compute_from_count_stats
    )


def _count_stats_route(analyzers, aggregate_with, save_states_with) -> bool:
    """True when a grouping set takes the count statistics: no state is
    loaded or saved and every analyzer of the set is a function of the
    count distribution (group values never decode)."""
    return (
        aggregate_with is None
        and save_states_with is None
        and all(_count_stats_capable(a) for a in analyzers)
    )


@dataclass
class AnalyzerContext:
    """Result map Analyzer -> Metric (reference AnalyzerContext.scala:29-105).

    ``skipped_batches``: the stream batch indices the resilient loop
    quarantined (``on_batch_error="skip"``) — skipped data is reported
    (``VerificationResult.skipped_batches``), never dropped silently."""

    metric_map: Dict[Analyzer, Metric] = field(default_factory=dict)
    skipped_batches: List[int] = field(default_factory=list)

    @staticmethod
    def empty() -> "AnalyzerContext":
        return AnalyzerContext({})

    def all_metrics(self) -> List[Metric]:
        return list(self.metric_map.values())

    def __add__(self, other: "AnalyzerContext") -> "AnalyzerContext":
        merged = dict(self.metric_map)
        merged.update(other.metric_map)
        skipped = list(self.skipped_batches)
        seen = set(skipped)
        skipped += [i for i in other.skipped_batches if i not in seen]
        return AnalyzerContext(merged, skipped)

    def metric(self, analyzer: Analyzer) -> Optional[Metric]:
        return self.metric_map.get(analyzer)

    @staticmethod
    def success_metrics_as_rows(
        analyzer_context: "AnalyzerContext",
        for_analyzers: Optional[Sequence[Analyzer]] = None,
    ) -> List[dict]:
        """The successful metrics, flattened, as row dicts (the reference's
        DataFrame of them, AnalyzerContext.scala:60-85)."""
        rows = []
        for analyzer, metric in analyzer_context.metric_map.items():
            if for_analyzers and analyzer not in for_analyzers:
                continue
            if not metric.value.is_success:
                continue
            for m in metric.flatten():
                if m.value.is_success:
                    rows.append({
                        "entity": m.entity.value,
                        "instance": m.instance,
                        "name": m.name,
                        "value": m.value.get(),
                    })
        return rows

    @staticmethod
    def success_metrics_as_json(
        analyzer_context: "AnalyzerContext",
        for_analyzers: Optional[Sequence[Analyzer]] = None,
    ) -> str:
        return json.dumps(
            AnalyzerContext.success_metrics_as_rows(analyzer_context, for_analyzers)
        )


def _release_spill(folder) -> None:
    """Free a fold's spill directory when its ``result()`` will never run
    (a failed fold, an aborted pass)."""
    store = getattr(folder, "_spill_store", None)
    if store is not None:
        store.release()


def _spilling_folder(columns, budget: Optional[int]) -> StreamStateFolder:
    """A fold of frequency states over ``columns``: through a spill store
    under ``budget`` (its states canonical deltas), else in memory."""
    if budget is None:
        return StreamStateFolder()
    from deequ_tpu_torch.spill import SpillingFrequencyStore

    return StreamStateFolder(
        spill_store=SpillingFrequencyStore(tuple(columns), budget),
        assume_canonical=True,
    )


def _save_or_append_result(metrics_repository, result_key, ctx) -> None:
    """Append ctx's metrics to the repository's entry for result_key: the
    one load-combine-save sequence every runner path shares."""
    if metrics_repository is None or result_key is None:
        return
    from deequ_tpu_torch.repository import AnalysisResult

    existing = metrics_repository.load_by_key(result_key)
    combined = (existing.analyzer_context + ctx) if existing is not None else ctx
    metrics_repository.save(AnalysisResult(result_key, combined))


class AnalysisRunner:
    """Entry point for computing metrics (reference AnalysisRunner.scala)."""

    @staticmethod
    def on_data(data: ColumnarTable, device=None) -> "AnalysisRunBuilder":
        from deequ_tpu_torch.analyzers.builder import AnalysisRunBuilder

        return AnalysisRunBuilder(data, device)

    @staticmethod
    def do_analysis_run(
        data: ColumnarTable,
        analyzers: Sequence[Analyzer],
        device=None,
        aggregate_with=None,
        save_states_with=None,
        metrics_repository=None,
        reuse_existing_results_for_key=None,
        fail_if_results_missing: bool = False,
        save_or_append_results_with_key=None,
        retry_policy=None,
        group_memory_budget: Optional[int] = None,
        checkpoint=None,
        on_batch_error: str = "fail",
        on_device_error: str = "fail",
        device_deadline: Optional[float] = None,
        mesh=_UNSET,
        shard_deadline: Optional[float] = None,
        _placed: bool = False,
    ) -> AnalyzerContext:
        """Compute every analyzer's metric over ``data`` on ``device``
        (default: ``cuda``, or the ambient ``use_device`` scope; raises
        DeviceUnavailableException when that device is not there), over
        ``mesh`` (default: the ``use_mesh`` scope, else the default mesh
        of a machine with several cards when no device was asked for; the
        rule is ``parallel/mesh.py:resolve_placement``). Over a mesh every
        fused scan and dense grouping count is row-sharded over its
        members, and ``shard_deadline`` (seconds; default
        ``DEEQU_TORCH_SHARD_DEADLINE``) arms the straggler watchdog on the
        scans' chunk steps.
        ``aggregate_with`` (a StateLoader) merges each analyzer's saved
        state into the one computed here; ``save_states_with`` (a
        StatePersister) saves the result. With ``metrics_repository``:
        ``reuse_existing_results_for_key`` takes the metrics stored under
        that key instead of computing them (``fail_if_results_missing``
        raises when some are not there), and
        ``save_or_append_results_with_key`` appends the run's metrics to
        that key's entry.

        ``data`` may be a StreamingTable (module doc); ``retry_policy`` (a
        ``resilience.retry.RetryPolicy``) then runs its batch reads under
        that policy.

        ``group_memory_budget`` (bytes; also the table's
        ``group_memory_budget`` or ``DEEQU_TORCH_GROUP_MEMORY_BUDGET``)
        bounds the host memory of grouping states: past it frequency
        states spill to disk as sorted runs and merge back streamed at
        finalize (``spill/``). None: unbounded.

        On a stream: ``checkpoint`` (a ``resilience.StreamCheckpointer`` or
        a directory) persists the fold states every ``every_batches``
        batches, and a run killed midway resumes from its last checkpoint
        with the metrics an uninterrupted checkpointed run gives, bit for
        bit; ``on_batch_error="skip"`` quarantines batches whose reads keep
        failing past the retries (reported on ``skipped_batches``) instead
        of failing the run.

        Device faults (``ops/scan_executors.py``): a fused scan's OOM evicts
        residency, demotes an encoded layout and bisects the chunk under
        either policy; past that, or on a lost device, a kernel that will
        not build or a hang, ``on_device_error="fail"`` fails the scan's
        analyzers with the typed fault (the shared-scan rule) and
        ``"fallback"`` — where the reference re-runs on its CPU — with
        ``DeviceFallbackRefusedException``. On a stream ``"fallback"`` takes
        the resilient loop, so each batch's scan has the ladder.
        ``device_deadline`` (seconds) arms the watchdog on each chunk's step
        and fetch. A run budget armed from the
        environment (``DEEQU_TORCH_RUN_DEADLINE`` /
        ``DEEQU_TORCH_RUN_ATTEMPTS``), when the caller armed none, spans
        the whole analysis."""
        if on_device_error not in ("fail", "fallback"):
            raise ValueError(
                f"on_device_error must be 'fail' or 'fallback', got {on_device_error!r}"
            )
        if on_batch_error not in ("fail", "skip"):
            raise ValueError(
                f"on_batch_error must be 'fail' or 'skip', got {on_batch_error!r}"
            )
        dev, mesh = resolve_placement(device, mesh)
        if not analyzers:
            return AnalyzerContext.empty()
        if not _placed:
            from deequ_tpu_torch.resilience.governance import (
                current_run_budget,
                resolve_run_policy,
                run_budget_scope,
            )

            # the mesh scope holds for the whole run: every scan and count
            # inside reads it. A budget the environment arms spans the
            # whole analysis too: without it every per-batch scan of a
            # stream would arm a fresh one and pay per batch again
            policy = resolve_run_policy() if current_run_budget() is None else None
            with use_mesh(mesh), (run_budget_scope(policy.arm()) if policy is not None
                                  else contextlib.nullcontext()):
                return AnalysisRunner.do_analysis_run(
                    data, analyzers, dev,
                    aggregate_with=aggregate_with,
                    save_states_with=save_states_with,
                    metrics_repository=metrics_repository,
                    reuse_existing_results_for_key=reuse_existing_results_for_key,
                    fail_if_results_missing=fail_if_results_missing,
                    save_or_append_results_with_key=save_or_append_results_with_key,
                    retry_policy=retry_policy,
                    group_memory_budget=group_memory_budget,
                    checkpoint=checkpoint,
                    on_batch_error=on_batch_error,
                    on_device_error=on_device_error,
                    device_deadline=device_deadline,
                    mesh=mesh, shard_deadline=shard_deadline, _placed=True,
                )
        streaming = getattr(data, "is_streaming", False)
        if retry_policy is not None and streaming:
            data = data.with_retry(retry_policy)

        # (1) repository reuse (reference L116-134)
        results_loaded = AnalyzerContext.empty()
        if metrics_repository is not None and reuse_existing_results_for_key is not None:
            existing = metrics_repository.load_by_key(reuse_existing_results_for_key)
            if existing is not None:
                results_loaded = AnalyzerContext({
                    a: m for a, m in existing.analyzer_context.metric_map.items()
                    if a in analyzers
                })
        remaining = [a for a in analyzers if a not in results_loaded.metric_map]
        if fail_if_results_missing and remaining:
            raise ReusingNotPossibleResultsMissingException(
                "Could not find all necessary results in the MetricsRepository, "
                f"the calculation of the metrics for these analyzers would be "
                f"needed: {', '.join(str(a) for a in remaining)}"
            )

        # (2) precondition partition (reference L137-145)
        passed: List[Analyzer] = []
        failure_ctx = AnalyzerContext.empty()
        for analyzer in remaining:
            exc = find_first_failing(data.schema, analyzer.preconditions())
            if exc is None:
                passed.append(analyzer)
            else:
                failure_ctx.metric_map[analyzer] = analyzer.to_failure_metric(exc)

        # (3) split (reference L148-153); the grouping analyzers share one
        # computation per distinct sorted grouping-column set (L175-190)
        grouping = [a for a in passed if _is_grouping_shared(a)]
        scanning = [a for a in passed if isinstance(a, ScanShareableAnalyzer)]
        own_pass = [a for a in passed if a not in grouping and a not in scanning]
        by_grouping: Dict[Tuple[str, ...], List[FrequencyBasedAnalyzer]] = {}
        for analyzer in grouping:
            key = tuple(sorted(analyzer.group_columns))
            by_grouping.setdefault(key, []).append(analyzer)

        from deequ_tpu_torch.spill import budget_batch_rows, resolve_group_budget

        budget = resolve_group_budget(data, group_memory_budget)

        # the resilient stream loop: checkpoints and quarantine need the
        # fold states of every analyzer on the host, so all of them share
        # one batch loop (reference L319-341)
        if streaming and (checkpoint is not None or on_batch_error != "fail"
                          or on_device_error != "fail"):
            resilient_ctx = AnalysisRunner._run_streaming_resilient(
                data, scanning, own_pass, by_grouping, dev,
                aggregate_with, save_states_with, budget=budget,
                checkpoint=checkpoint, on_batch_error=on_batch_error,
                retry_policy=retry_policy, on_device_error=on_device_error,
                device_deadline=device_deadline, shard_deadline=shard_deadline,
            )
            result = results_loaded + failure_ctx + resilient_ctx
            _save_or_append_result(
                metrics_repository, save_or_append_results_with_key, result
            )
            return result

        # (4) one fused scan for all shareable analyzers (reference L289-336)
        scan_ctx = AnalysisRunner._run_scanning_analyzers(
            data, scanning, dev, aggregate_with, save_states_with,
            on_device_error=on_device_error, device_deadline=device_deadline,
            shard_deadline=shard_deadline,
        )

        # (5) own-pass analyzers (reference L155-160); on a stream they
        # share one read. A budgeted in-memory table cuts its frequency-
        # shaped own-pass states (Histogram) into budget-sized slices and
        # takes the spilling stream fold, as the grouping sets do.
        own_ctx = AnalyzerContext.empty()
        if streaming and own_pass:
            own_ctx += AnalysisRunner._run_own_pass_streaming(
                data, own_pass, dev, aggregate_with, save_states_with, budget
            )
        elif own_pass:
            spillable: List[Analyzer] = []
            if budget is not None and data.num_rows > budget_batch_rows(budget):
                spillable = [a for a in own_pass if isinstance(a, FrequencyBasedAnalyzer)]
            if spillable:
                from deequ_tpu_torch.data.streaming import stream_table

                own_ctx += AnalysisRunner._run_own_pass_streaming(
                    stream_table(data, budget_batch_rows(budget)), spillable, dev,
                    aggregate_with, save_states_with, budget,
                )
            for a in own_pass:
                if a not in spillable:
                    own_ctx.metric_map[a] = a.calculate(
                        data, dev, aggregate_with, save_states_with
                    )

        # (6) one computation per grouping set; the dense sets of a table
        # in memory first fuse into one dispatch, and a set fusion did not
        # compute runs its own pass
        group_ctx = AnalyzerContext.empty()
        fused = AnalysisRunner._fuse_grouping_sets(
            data, by_grouping, dev, aggregate_with, save_states_with, budget
        )
        for group_key, group_analyzers in by_grouping.items():
            group_ctx += AnalysisRunner._run_grouping_analyzers(
                data, list(group_key), group_analyzers, dev,
                aggregate_with, save_states_with, budget,
                precomputed=fused.get(group_key),
            )
        result = results_loaded + failure_ctx + scan_ctx + own_ctx + group_ctx

        # (7) save to the repository (reference L192-202)
        _save_or_append_result(
            metrics_repository, save_or_append_results_with_key, result
        )
        return result

    @staticmethod
    def _run_own_pass_streaming(
        data, analyzers: Sequence[Analyzer], device,
        aggregate_with=None, save_states_with=None, budget: Optional[int] = None,
    ) -> AnalyzerContext:
        """Every own-pass analyzer's state folded over ONE read of the
        stream (the columns any of them needs), not one read each
        (reference L625-712). An analyzer whose batch state raises drops
        out with a failure metric and the others go on; an error of the
        read itself fails them all (the shared-scan rule). Under
        ``budget`` a frequency-shaped state (Histogram, whose states are
        sorted labels: canonical) folds through a spill store."""
        columns: Optional[set] = set()
        for a in analyzers:
            cols = a._stream_columns()
            if cols is None:
                columns = None
                break
            columns.update(cols)
        folders = {
            a: _spilling_folder(a.group_columns, budget)
            if isinstance(a, FrequencyBasedAnalyzer) else StreamStateFolder()
            for a in analyzers
        }
        failed: Dict[Analyzer, Exception] = {}
        try:
            for batch in data.batches(
                columns=sorted(columns) if columns is not None else None
            ):
                for a in analyzers:
                    if a in failed:
                        continue
                    try:
                        folders[a].add(a.compute_state_from(batch, device))
                    except NotYetPortedException:
                        raise
                    except Exception as e:  # noqa: BLE001 — failure is data
                        failed[a] = e
        except BaseException as e:
            # spill directories must not outlive the pass
            for f in folders.values():
                _release_spill(f)
            if isinstance(e, NotYetPortedException) or not isinstance(e, Exception):
                raise
            wrapped = wrap_if_necessary(e)  # the read failed every analyzer
            return AnalyzerContext({a: a.to_failure_metric(wrapped) for a in analyzers})
        ctx = AnalyzerContext.empty()
        for a in analyzers:
            if a in failed:
                ctx.metric_map[a] = a.to_failure_metric(wrap_if_necessary(failed[a]))
                _release_spill(folders[a])  # its result() never runs
            else:
                ctx.metric_map[a] = a.calculate_metric(
                    folders[a].result(), aggregate_with, save_states_with
                )
        return ctx

    @staticmethod
    def _build_scan_ops(data: ColumnarTable, analyzers):
        """Each analyzer's ScanOp, with failure isolation: a malformed op
        (say, a bad where expression) fails only its analyzer. Returns
        (ops, scannable, op_failures); shared by the serial path and the
        stream's group path (analyzers/incremental.py)."""
        ops, scannable, op_failures = [], [], {}
        for analyzer in analyzers:
            try:
                ops.append(analyzer.scan_op(data))
                scannable.append(analyzer)
            except Exception as e:  # noqa: BLE001 — failure is data
                op_failures[analyzer] = wrap_if_necessary(e)
        return ops, scannable, op_failures

    @staticmethod
    def _dispatch_scanning_analyzers(
        data: ColumnarTable,
        analyzers: Sequence[ScanShareableAnalyzer],
        device,
        defer: bool = False,
        on_device_error: str = "fail",
        device_deadline: Optional[float] = None,
        shard_deadline: Optional[float] = None,
    ):
        """Build the ops and run the fused scan. Returns (ctx holding the
        failures, scannable, plan, results); results is None when nothing
        scanned or the scan failed (its failure then maps onto every
        participating analyzer, reference L320-323). ``defer``: results is
        a ``scan_engine.DeferredScan``, not yet fetched. An exhausted run
        budget is the run's outcome, not the analyzers': it propagates, for
        the caller to degrade or raise."""
        ctx = AnalyzerContext.empty()
        ops, scannable, op_failures = AnalysisRunner._build_scan_ops(data, analyzers)
        for analyzer, err in op_failures.items():
            ctx.metric_map[analyzer] = analyzer.to_failure_metric(err)
        if not scannable:
            return ctx, [], [], None
        exec_ops, plan = AnalysisRunner._coalesce_scan_ops(ops)
        try:
            results = run_scan(data, exec_ops, device, defer=defer,
                               on_device_error=on_device_error,
                               device_deadline=device_deadline,
                               shard_deadline=shard_deadline)
        except RunBudgetExhaustedException:
            raise
        except Exception as e:  # noqa: BLE001 — failure is data
            wrapped = wrap_if_necessary(e)
            for a in scannable:
                ctx.metric_map[a] = a.to_failure_metric(wrapped)
            return ctx, [], [], None
        return ctx, scannable, plan, results

    @staticmethod
    def _finalize_scanning_analyzers(
        ctx: AnalyzerContext, scannable, plan, results,
        aggregate_with=None, save_states_with=None,
    ) -> AnalyzerContext:
        """States from the scan's results, merged and saved as asked, then
        metrics."""
        for analyzer, (exec_idx, extract) in zip(scannable, plan):
            try:
                result = results[exec_idx]
                if extract is not None:
                    result = extract(result)
                state = analyzer.state_from_scan_result(result)
            except Exception as e:  # noqa: BLE001
                ctx.metric_map[analyzer] = analyzer.to_failure_metric(
                    wrap_if_necessary(e)
                )
                continue
            ctx.metric_map[analyzer] = analyzer.calculate_metric(
                state, aggregate_with, save_states_with
            )
        return ctx

    @staticmethod
    def _run_scanning_analyzers(
        data: ColumnarTable,
        analyzers: Sequence[ScanShareableAnalyzer],
        device,
        aggregate_with=None,
        save_states_with=None,
        on_device_error: str = "fail",
        device_deadline: Optional[float] = None,
        shard_deadline: Optional[float] = None,
    ) -> AnalyzerContext:
        """One fused scan for ``analyzers``, then their metrics. A run
        budget exhausted by the scan under ``on_budget_exhausted="degrade"``
        leaves every row of this pass unverified: the range is recorded and
        the analyzers fail with the typed exhaustion (failure is data)."""
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

        try:
            ctx, scannable, plan, results = AnalysisRunner._dispatch_scanning_analyzers(
                data, analyzers, device, on_device_error=on_device_error,
                device_deadline=device_deadline, shard_deadline=shard_deadline,
            )
        except RunBudgetExhaustedException as e:
            if not e.degraded:
                raise
            try:
                total = int(data.num_rows or 0)
            except Exception:  # noqa: BLE001 — a source that does not know its rows
                total = 0
            if total > 0:
                SCAN_STATS.record_unverified(0, total, reason=str(e))
            else:
                SCAN_STATS.record_degradation("budget_exhausted", reason=str(e))
            return AnalyzerContext({a: a.to_failure_metric(e) for a in analyzers})
        if results is None:
            return ctx
        return AnalysisRunner._finalize_scanning_analyzers(
            ctx, scannable, plan, results, aggregate_with, save_states_with
        )

    @staticmethod
    def _coalesce_scan_ops(ops):
        """Merge where-free KLL ops of one sketch size into one batched op:
        one (K, n) sort a chunk instead of K sorts (reference
        ``runner._coalesce_scan_ops``). A column asked for by several such
        ops (say, quantiles 0.1 and 0.9 of one column) is sorted once: each
        column's summary is a function of its values alone.

        Returns (exec_ops, plan) where plan[i] = (exec index, extractor or
        None) for ops[i]."""
        from deequ_tpu_torch.analyzers.sketches import (
            _kll_multi_extract,
            _kll_multi_scan_op,
        )

        groups: Dict[Tuple, List[int]] = {}
        for i, op in enumerate(ops):
            hint = op.batch_hint
            if hint is not None and hint[0] == "kll":
                groups.setdefault(hint[:2], []).append(i)
        mergeable = {key: idxs for key, idxs in groups.items() if len(idxs) >= 2}
        members = {i for idxs in mergeable.values() for i in idxs}
        exec_ops = [op for i, op in enumerate(ops) if i not in members]
        plan: List[Optional[Tuple[int, Optional[Callable]]]] = [None] * len(ops)
        for j, i in enumerate(i for i in range(len(ops)) if i not in members):
            plan[i] = (j, None)
        for (_, sketch_size), idxs in sorted(mergeable.items()):
            columns = tuple(dict.fromkeys(ops[i].batch_hint[2] for i in idxs))
            exec_idx = len(exec_ops)
            exec_ops.append(_kll_multi_scan_op(columns, sketch_size))
            for i in idxs:
                j = columns.index(ops[i].batch_hint[2])
                plan[i] = (exec_idx, lambda result, j=j: _kll_multi_extract(result, j))
        return exec_ops, plan

    @staticmethod
    def _run_streaming_resilient(
        data,
        scanning: Sequence[ScanShareableAnalyzer],
        own_pass: Sequence[Analyzer],
        by_grouping: Dict[Tuple[str, ...], List],
        device,
        aggregate_with=None,
        save_states_with=None,
        budget: Optional[int] = None,
        checkpoint=None,
        on_batch_error: str = "fail",
        retry_policy=None,
        on_device_error: str = "fail",
        device_deadline: Optional[float] = None,
        shard_deadline: Optional[float] = None,
    ) -> AnalyzerContext:
        """One resilient loop over the stream for every kind of analyzer
        (scan-shareable, own pass, grouping), with the fold states on the
        host so they can be checkpointed (reference L716-1150):

        - batch reads run through ``resilient_batches``: a transient error
          retries with a backoff and a reopen at the batch; past the
          retries the pass fails (the shared-scan rule) or, with
          ``on_batch_error="skip"``, the batch index is quarantined;
        - the scan-shareable analyzers share one fused scan a batch; it is
          deferred, and the batches' scans since the last boundary are
          fetched together (``fetch_deferred``) at each checkpoint
          boundary, or every 8 batches without checkpoints — their states
          fold on the host in batch order;
        - every ``checkpoint.every_batches`` batches the fold stacks are
          saved, atomic and checksummed; a run starts from the newest
          valid checkpoint of its fingerprint and resumes at its batch
          index. The stacks are the fold state, so a resumed run gives an
          uninterrupted checkpointed run's metrics bit for bit.

        Under ``budget`` the frequency folds spill, except in a
        checkpointed run: a spill store's runs are not checkpointed, so
        the budget is ignored there with a GroupBudgetIgnoredWarning.

        Each batch's scan runs the device fault ladder under
        ``on_device_error``. A run budget that runs out mid-stream under
        ``on_budget_exhausted="degrade"`` ends the loop with a partial
        result: the scans already dispatched are fetched (or, if that
        fails, dropped with their analyzers failed), the fold stacks
        finalize over every batch verified so far, and the rows from the
        first batch not verified to the stream's end are recorded as
        unverified (``SCAN_STATS.unverified_row_ranges``)."""
        from deequ_tpu_torch.data.source import TableBatchSource
        from deequ_tpu_torch.ops.scan_engine import fetch_deferred
        from deequ_tpu_torch.resilience.checkpoint import (
            StreamCheckpoint,
            StreamCheckpointer,
            run_fingerprint,
        )
        from deequ_tpu_torch.resilience.retry import resilient_batches, resolve_retry_policy

        if isinstance(checkpoint, str):
            checkpoint = StreamCheckpointer(checkpoint)
        policy = resolve_retry_policy(data, retry_policy)

        # equal analyzers fold once (their fold keys are equal)
        scanning = list(dict.fromkeys(scanning))
        own_pass = list(dict.fromkeys(own_pass))
        by_grouping = {g: list(dict.fromkeys(a)) for g, a in by_grouping.items()}
        per_analyzer = scanning + own_pass

        if budget is not None and checkpoint is not None:
            import warnings

            warnings.warn(
                "group_memory_budget is ignored for checkpointed streaming runs: "
                "spilled frequency state cannot be checkpointed; frequency folds "
                "stay in host RAM",
                GroupBudgetIgnoredWarning,
                stacklevel=3,
            )
            budget = None

        keys = {a: f"analyzer::{a!r}" for a in per_analyzer}
        group_keys = {g: "group::" + ",".join(g) for g in by_grouping}
        folders: Dict[str, StreamStateFolder] = {}
        for a in scanning:
            folders[keys[a]] = StreamStateFolder()
        for a in own_pass:
            folders[keys[a]] = (
                _spilling_folder(a.group_columns, budget)
                if isinstance(a, FrequencyBasedAnalyzer) else StreamStateFolder()
            )
        for g in by_grouping:
            folders[group_keys[g]] = _spilling_folder(g, budget)

        # column pruning: the union of every fold's columns (None: all)
        columns: Optional[set] = set()
        for a in per_analyzer:
            cols = a._stream_columns()
            if cols is None:
                columns = None
                break
            columns.update(cols)
        if columns is not None:
            for g in by_grouping:
                columns.update(g)
            if not columns and len(data.schema.column_names):
                # a lone Size() prunes to no column, and a batch of no
                # column cannot carry its row count: read one
                columns.add(data.schema.column_names[0])
        read_cols = sorted(columns) if columns is not None else None

        # the fingerprint: fold keys, batch geometry and the identity the
        # source shows (file paths, its row count), looked up through
        # wrappers (``.inner``) — a checkpoint of other data must not
        # resume this run
        batch_rows = getattr(data, "preferred_batch_rows", None)
        src = getattr(data, "source", None)
        src_id = None
        probe, depth = src, 0
        while probe is not None and src_id is None and depth < 8:
            src_id = getattr(probe, "paths", None) or getattr(probe, "path", None)
            probe = getattr(probe, "inner", None)
            depth += 1
        try:
            known_rows = src.num_rows if src is not None else None
        except Exception:  # noqa: BLE001 — identity is best effort
            known_rows = None
        fingerprint = run_fingerprint(sorted(folders), (batch_rows, src_id, known_rows))

        # the exact batch count where it is knowable (a source cut by
        # rows): it tells an unreadable batch from a failing probe of the
        # stream's end
        innermost, depth = src, 0
        while hasattr(innermost, "inner") and depth < 8:
            innermost = innermost.inner
            depth += 1
        max_batches = None
        if isinstance(innermost, TableBatchSource) and known_rows is not None and batch_rows:
            max_batches = max((known_rows + batch_rows - 1) // batch_rows, 1)

        start = 0
        skipped: List[int] = []
        failed: Dict[Analyzer, Metric] = {}
        failed_groups: Dict[Tuple[str, ...], Exception] = {}
        if checkpoint is not None:
            recovered = checkpoint.load_latest(fingerprint)
            if recovered is not None:
                start = recovered.batch_index
                skipped = list(recovered.skipped)
                for key, stack in recovered.stacks.items():
                    if key in folders:
                        folders[key]._stack = list(stack)
                # failures stay failed on resume: a success metric over a
                # gap of batches would be wrong
                key_to_analyzer = {k: a for a, k in keys.items()}
                key_to_group = {k: g for g, k in group_keys.items()}
                for key, msg in recovered.failed.items():
                    exc = MetricCalculationRuntimeException(
                        f"{msg} (failed before the checkpoint at batch "
                        f"{recovered.batch_index}; kept failed on resume)"
                    )
                    if key in key_to_analyzer:
                        a = key_to_analyzer[key]
                        failed[a] = a.to_failure_metric(exc)
                    elif key in key_to_group:
                        failed_groups[key_to_group[key]] = exc

        drain_every = checkpoint.every_batches if checkpoint is not None else 8
        pending: List[Tuple] = []  # (scannable, plan, DeferredScan)

        def fail_scan(scannable, err) -> None:
            wrapped = wrap_if_necessary(err)
            for a in scannable:
                if a not in failed:
                    failed[a] = a.to_failure_metric(wrapped)

        def drain_pending() -> None:
            """One fetch of every pending batch scan, folded in batch order;
            a scan that fails fails its analyzers (sticky), the others and
            later batches go on."""
            if not pending:
                return
            entries = list(pending)
            pending.clear()
            try:
                fetch_deferred([scan for _, _, scan in entries])
            except Exception as e:  # noqa: BLE001 — scoped to these scans
                for scannable, _, _ in entries:
                    fail_scan(scannable, e)
                return
            for scannable, plan, scan in entries:
                try:
                    results = scan.result()
                except Exception as e:  # noqa: BLE001
                    fail_scan(scannable, e)
                    continue
                for a, (exec_idx, extract) in zip(scannable, plan):
                    if a in failed:
                        continue
                    try:
                        r = results[exec_idx]
                        if extract is not None:
                            r = extract(r)
                        folders[keys[a]].add(a.state_from_scan_result(r))
                    except Exception as e:  # noqa: BLE001
                        failed[a] = a.to_failure_metric(wrap_if_necessary(e))

        def fold_batch(batch) -> None:
            alive = [a for a in scanning if a not in failed]
            if alive:
                sctx, scannable, plan, scan = AnalysisRunner._dispatch_scanning_analyzers(
                    batch, alive, device, defer=True, on_device_error=on_device_error,
                    device_deadline=device_deadline, shard_deadline=shard_deadline,
                )
                failed.update(sctx.metric_map)
                if scan is not None:
                    pending.append((scannable, plan, scan))
            for a in own_pass:
                if a in failed:
                    continue
                try:
                    folders[keys[a]].add(a.compute_state_from(batch, device))
                except (NotYetPortedException, RunBudgetExhaustedException):
                    raise  # the run's outcome, not this analyzer's
                except Exception as e:  # noqa: BLE001 — failure is data
                    failed[a] = a.to_failure_metric(wrap_if_necessary(e))
            for g in by_grouping:
                if g in failed_groups:
                    continue
                folder = folders[group_keys[g]]
                try:
                    folder.add(group_counts_state(
                        batch, list(g), device,
                        canonicalize=folder._spill_store is not None,
                    ))
                except RunBudgetExhaustedException:
                    raise
                except Exception as e:  # noqa: BLE001 — failure is data
                    failed_groups[g] = wrap_if_necessary(e)

        got_any = start > 0
        last_seen = start - 1
        try:
            for idx, batch in resilient_batches(
                lambda i: data.batches_from(i, columns=read_cols),
                policy,
                on_batch_error=on_batch_error,
                quarantined=skipped,
                start=start,
                max_batches=max_batches,
            ):
                got_any = True
                # counted after the fold: a batch whose scan exhausts the
                # run budget is not verified, and the degraded range
                # starts at it
                fold_batch(batch)
                last_seen = idx
                n_done = idx + 1
                due = checkpoint is not None and checkpoint.due(n_done)
                if due or len(pending) >= drain_every:
                    drain_pending()
                if due:
                    failed_msgs = {
                        keys[a]: str(getattr(m.value, "exception", m.value))
                        for a, m in failed.items()
                    }
                    failed_msgs.update({group_keys[g]: str(e) for g, e in failed_groups.items()})
                    checkpoint.save(fingerprint, StreamCheckpoint(
                        n_done, list(skipped),
                        {k: list(f._stack) for k, f in folders.items()}, failed_msgs,
                    ))
            if not got_any and not skipped:
                # an empty stream: fold one empty batch so counting
                # analyzers give their identity metrics (Size = 0)
                from deequ_tpu_torch.data.streaming import empty_table

                schema = data.schema if read_cols is None else Schema(
                    [data.schema[c] for c in read_cols]
                )
                fold_batch(empty_table(schema))
            drain_pending()  # the batches since the last boundary
        except RunBudgetExhaustedException as e:
            if not e.degraded:
                for f in folders.values():
                    _release_spill(f)
                raise
            from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

            # the scans dispatched before the budget ran out are fetched with
            # no new rung (a failure there fails their analyzers)
            drain_pending()
            boundary = max([last_seen] + list(skipped)) + 1
            first_row = None
            if batch_rows and known_rows is not None:
                first_row = min(boundary * int(batch_rows), int(known_rows))
            if first_row is not None and first_row < int(known_rows):
                SCAN_STATS.record_unverified(first_row, int(known_rows), reason=str(e))
            else:
                SCAN_STATS.record_degradation(
                    "budget_exhausted", reason=str(e), batches_verified=boundary,
                )
        except BaseException as e:
            # spill directories must not outlive the run; checkpoints
            # written so far stay for the resume
            for f in folders.values():
                _release_spill(f)
            if isinstance(e, NotYetPortedException) or not isinstance(e, Exception):
                raise
            wrapped = wrap_if_necessary(e)  # the read failed every analyzer
            ctx = AnalyzerContext({a: a.to_failure_metric(wrapped) for a in per_analyzer})
            for group_analyzers in by_grouping.values():
                for a in group_analyzers:
                    ctx.metric_map[a] = a.to_failure_metric(wrapped)
            ctx.skipped_batches = list(skipped)
            return ctx

        ctx = AnalyzerContext.empty()
        for a in per_analyzer:
            if a in failed:
                ctx.metric_map[a] = failed[a]
                _release_spill(folders[keys[a]])  # its result() never runs
            else:
                ctx.metric_map[a] = a.calculate_metric(
                    folders[keys[a]].result(), aggregate_with, save_states_with
                )
        for g, group_analyzers in by_grouping.items():
            if g in failed_groups:
                for a in group_analyzers:
                    ctx.metric_map[a] = a.to_failure_metric(failed_groups[g])
                _release_spill(folders[group_keys[g]])
            else:
                merged = folders[group_keys[g]].result()
                for a in group_analyzers:
                    ctx.metric_map[a] = a.calculate_metric(
                        merged, aggregate_with, save_states_with
                    )
        ctx.skipped_batches = list(skipped)
        if checkpoint is not None:
            # the run completed: a later run of this directory starts fresh
            checkpoint.clear()
        return ctx

    @staticmethod
    def _fuse_grouping_sets(
        data, by_grouping, device, aggregate_with, save_states_with,
        budget: Optional[int],
    ) -> Dict[Tuple[str, ...], object]:
        """Cross-set fusion ahead of the per-set passes (reference
        ``_fuse_grouping_sets``): every grouping set of a table in memory
        goes to ``segment.fused_group_counts`` in one call, so the dense
        ones ride one dispatch. Returns {grouping key: state} for the sets
        it computed; none with the switch off
        (``DEEQU_TORCH_PLAN_FUSION=0``), fewer than two sets, a stream, a
        group memory budget (a budgeted set is cut into slices, which one
        fused vector would defeat), or any error (each set's own pass then
        meets it and reports it per analyzer)."""
        from deequ_tpu_torch.ops.scan_plan import plan_fusion_enabled
        from deequ_tpu_torch.ops.segment import GroupRequest, fused_group_counts

        if not plan_fusion_enabled():
            return {}
        if len(by_grouping) < 2 or getattr(data, "is_streaming", False) or budget is not None:
            return {}
        keys = list(by_grouping)
        requests = [
            GroupRequest(
                key,
                "stats" if _count_stats_route(by_grouping[key], aggregate_with,
                                              save_states_with) else "freq",
            )
            for key in keys
        ]
        try:
            computed = fused_group_counts(data, requests, device)
        except Exception:  # noqa: BLE001 — the per-set passes surface it
            return {}
        return {keys[i]: state for i, state in computed.items()}

    @staticmethod
    def _run_grouping_analyzers(
        data: ColumnarTable,
        grouping_columns: List[str],
        analyzers: Sequence[FrequencyBasedAnalyzer],
        device,
        aggregate_with=None,
        save_states_with=None,
        budget: Optional[int] = None,
        precomputed=None,
    ) -> AnalyzerContext:
        """The count statistics when no state is loaded or saved and every
        analyzer of the set is a function of the count distribution (group
        values never decode), else the frequency table, merged and saved
        as asked (reference L1266-1331). Over a stream the frequency
        table folds a batch at a time (reference L1229-1265): the count
        statistics need the whole table's counts. Under ``budget`` that
        fold spills (each batch's state a canonical delta), and an
        in-memory table that would build its frequency table is cut into
        ``budget_batch_rows`` slices and takes it; the count statistics
        are not affected by a budget. ``precomputed``: the set's count
        statistics or frequency table, already computed by cross-set
        fusion (:meth:`_fuse_grouping_sets`), taken in place of its own
        pass."""
        if getattr(data, "is_streaming", False):
            folder = _spilling_folder(grouping_columns, budget)
            try:
                for batch in data.batches(columns=grouping_columns):
                    folder.add(group_counts_state(
                        batch, grouping_columns, device, canonicalize=budget is not None
                    ))
                merged = folder.result()
            except BaseException as e:
                _release_spill(folder)  # a failed fold must not leak its runs
                if isinstance(e, NotYetPortedException) or not isinstance(e, Exception):
                    raise
                wrapped = wrap_if_necessary(e)
                return AnalyzerContext({a: a.to_failure_metric(wrapped) for a in analyzers})
            return AnalyzerContext({
                a: a.calculate_metric(merged, aggregate_with, save_states_with)
                for a in analyzers
            })
        count_stats = _count_stats_route(analyzers, aggregate_with, save_states_with)
        if not count_stats and budget is not None:
            from deequ_tpu_torch.data.streaming import stream_table
            from deequ_tpu_torch.spill import budget_batch_rows

            batch_rows = budget_batch_rows(budget)
            if data.num_rows > batch_rows:
                return AnalysisRunner._run_grouping_analyzers(
                    stream_table(data, batch_rows), grouping_columns, analyzers,
                    device, aggregate_with, save_states_with, budget,
                )
        try:
            if precomputed is not None:
                stats = state = precomputed
            elif count_stats:
                stats = group_count_stats(data, grouping_columns, device)
            else:
                state = group_counts_state(data, grouping_columns, device)
        except Exception as e:  # noqa: BLE001 — failure is data
            wrapped = wrap_if_necessary(e)
            return AnalyzerContext(
                {a: a.to_failure_metric(wrapped) for a in analyzers}
            )
        if count_stats:
            return AnalyzerContext(
                {a: a.metric_from_count_stats(stats) for a in analyzers}
            )
        return AnalyzerContext({
            a: a.calculate_metric(state, aggregate_with, save_states_with)
            for a in analyzers
        })

    @staticmethod
    def run_on_aggregated_states(
        schema: Schema,
        analyzers: Sequence[Analyzer],
        state_loaders: Sequence,
        save_states_with=None,
        metrics_repository=None,
        save_or_append_results_with_key=None,
    ) -> AnalyzerContext:
        """Metrics from saved states alone, with no scan: each analyzer's
        states merge across ``state_loaders`` in order (reference
        AnalysisRunner.scala:385-460); ``save_states_with`` keeps the
        merged states, ``save_or_append_results_with_key`` appends the
        metrics to ``metrics_repository``."""
        if not analyzers or not state_loaders:
            return AnalyzerContext.empty()
        passed: List[Analyzer] = []
        ctx = AnalyzerContext.empty()
        for analyzer in analyzers:
            exc = find_first_failing(schema, analyzer.preconditions())
            if exc is None:
                passed.append(analyzer)
            else:
                ctx.metric_map[analyzer] = analyzer.to_failure_metric(exc)
        for analyzer in passed:
            merged: Optional[State] = None
            try:
                for loader in state_loaders:
                    merged = merge_states(merged, loader.load(analyzer))
                if save_states_with is not None and merged is not None:
                    save_states_with.persist(analyzer, merged)
                ctx.metric_map[analyzer] = analyzer.compute_metric_from(merged)
            except Exception as e:  # noqa: BLE001
                ctx.metric_map[analyzer] = analyzer.to_failure_metric(
                    wrap_if_necessary(e)
                )
        _save_or_append_result(
            metrics_repository, save_or_append_results_with_key, ctx
        )
        return ctx
