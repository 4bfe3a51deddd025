"""AnalysisRunner — the query planner (reference layer L4,
analyzers/runners/AnalysisRunner.scala; the counterpart of
``deequ_tpu/analyzers/runner.py`` for one in-memory table on one device).

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
(the count-statistics shortcut needs the whole table's counts). The
reference's resilient stream loop (``checkpoint``, ``on_batch_error``,
``on_device_error``) is slice 8c of the port and not here.

Metrics repositories (reference L116-134, L192-202): with
``reuse_existing_results_for_key`` the metrics the repository holds for
that key are taken as they are and only the rest are computed (all of
them present: no scan at all); ``save_or_append_results_with_key``
appends the run's metrics to the repository's entry for that key.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.analyzers.base import (
    Analyzer,
    ScanShareableAnalyzer,
    State,
    StreamStateFolder,
    find_first_failing,
    group_budget,
    merge_states,
)
from deequ_tpu_torch.analyzers.grouping import (
    FrequencyBasedAnalyzer,
    Histogram,
    ScanShareableFrequencyBasedAnalyzer,
)
from deequ_tpu_torch.data.table import ColumnarTable, Schema
from deequ_tpu_torch.device import resolve_device
from deequ_tpu_torch.exceptions import (
    NotYetPortedException,
    ReusingNotPossibleResultsMissingException,
    wrap_if_necessary,
)
from deequ_tpu_torch.metrics import Metric
from deequ_tpu_torch.ops.scan_engine import run_scan
from deequ_tpu_torch.ops.segment import group_count_stats, group_counts_state


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


@dataclass
class AnalyzerContext:
    """Result map Analyzer -> Metric (reference AnalyzerContext.scala:29-105)."""

    metric_map: Dict[Analyzer, Metric] = field(default_factory=dict)

    @staticmethod
    def empty() -> "AnalyzerContext":
        return AnalyzerContext({})

    def __add__(self, other: "AnalyzerContext") -> "AnalyzerContext":
        merged = dict(self.metric_map)
        merged.update(other.metric_map)
        return AnalyzerContext(merged)

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
    ) -> AnalyzerContext:
        """Compute every analyzer's metric over ``data`` on ``device``
        (default: ``cuda``, or the ambient ``use_device`` scope; raises
        DeviceUnavailableException when that device is not there).
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
        that policy."""
        dev = resolve_device(device)
        if not analyzers:
            return AnalyzerContext.empty()
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

        # (3) split (reference L148-153)
        grouping = [a for a in passed if _is_grouping_shared(a)]
        scanning = [a for a in passed if isinstance(a, ScanShareableAnalyzer)]
        own_pass = [a for a in passed if a not in grouping and a not in scanning]

        # (4) one fused scan for all shareable analyzers (reference L289-336)
        scan_ctx = AnalysisRunner._run_scanning_analyzers(
            data, scanning, dev, aggregate_with, save_states_with
        )

        # (5) own-pass analyzers (reference L155-160); on a stream they
        # share one read
        if streaming and own_pass:
            own_ctx = AnalysisRunner._run_own_pass_streaming(
                data, own_pass, dev, aggregate_with, save_states_with
            )
        else:
            own_ctx = AnalyzerContext({
                a: a.calculate(data, dev, aggregate_with, save_states_with)
                for a in own_pass
            })

        # (6) one computation per distinct sorted grouping-column set
        # (reference L175-190)
        by_grouping: Dict[Tuple[str, ...], List[FrequencyBasedAnalyzer]] = {}
        for analyzer in grouping:
            key = tuple(sorted(analyzer.group_columns))
            by_grouping.setdefault(key, []).append(analyzer)
        group_ctx = AnalyzerContext.empty()
        for group_key, group_analyzers in by_grouping.items():
            group_ctx += AnalysisRunner._run_grouping_analyzers(
                data, list(group_key), group_analyzers, dev,
                aggregate_with, save_states_with,
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
        aggregate_with=None, save_states_with=None,
    ) -> AnalyzerContext:
        """Every own-pass analyzer's state folded over ONE read of the
        stream (the columns any of them needs), not one read each
        (reference L625-712). An analyzer whose batch state raises drops
        out with a failure metric and the others go on; an error of the
        read itself fails them all (the shared-scan rule)."""
        columns: Optional[set] = set()
        for a in analyzers:
            cols = a._stream_columns()
            if cols is None:
                columns = None
                break
            columns.update(cols)
        budget = group_budget(data)
        folders = {a: StreamStateFolder(budget) for a in analyzers}
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
        except NotYetPortedException:
            raise
        except Exception as e:  # noqa: BLE001 — the read failed every analyzer
            wrapped = wrap_if_necessary(e)
            return AnalyzerContext({a: a.to_failure_metric(wrapped) for a in analyzers})
        ctx = AnalyzerContext.empty()
        for a in analyzers:
            if a in failed:
                ctx.metric_map[a] = a.to_failure_metric(wrap_if_necessary(failed[a]))
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
    ):
        """Build the ops and run the fused scan. Returns (ctx holding the
        failures, scannable, plan, results); results is None when nothing
        scanned or the scan failed (its failure then maps onto every
        participating analyzer, reference L320-323)."""
        ctx = AnalyzerContext.empty()
        ops, scannable, op_failures = AnalysisRunner._build_scan_ops(data, analyzers)
        for analyzer, err in op_failures.items():
            ctx.metric_map[analyzer] = analyzer.to_failure_metric(err)
        if not scannable:
            return ctx, [], [], None
        exec_ops, plan = AnalysisRunner._coalesce_scan_ops(ops)
        try:
            results = run_scan(data, exec_ops, device)
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
    ) -> AnalyzerContext:
        """One fused scan for ``analyzers``, then their metrics."""
        ctx, scannable, plan, results = AnalysisRunner._dispatch_scanning_analyzers(
            data, analyzers, device
        )
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
    def _run_grouping_analyzers(
        data: ColumnarTable,
        grouping_columns: List[str],
        analyzers: Sequence[FrequencyBasedAnalyzer],
        device,
        aggregate_with=None,
        save_states_with=None,
    ) -> AnalyzerContext:
        """The count statistics when no state is loaded or saved and every
        analyzer of the set is a function of the count distribution (group
        values never decode), else the frequency table, merged and saved
        as asked (reference L1266-1331). Over a stream the frequency
        table folds a batch at a time (reference L1229-1265): the count
        statistics need the whole table's counts."""
        if getattr(data, "is_streaming", False):
            try:
                folder = StreamStateFolder(group_budget(data))
                for batch in data.batches(columns=grouping_columns):
                    folder.add(group_counts_state(batch, grouping_columns, device))
                merged = folder.result()
            except NotYetPortedException:
                raise
            except Exception as e:  # noqa: BLE001 — failure is data
                wrapped = wrap_if_necessary(e)
                return AnalyzerContext({a: a.to_failure_metric(wrapped) for a in analyzers})
            return AnalyzerContext({
                a: a.calculate_metric(merged, aggregate_with, save_states_with)
                for a in analyzers
            })
        count_stats = (
            aggregate_with is None
            and save_states_with is None
            and all(_count_stats_capable(a) for a in analyzers)
        )
        try:
            if count_stats:
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
