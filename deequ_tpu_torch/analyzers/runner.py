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
failure metrics instead of aborting (L137-145). Streams, saved and
aggregated states and repositories wait for later slices. Where-free KLL
ops of one sketch size run as one batched op (``_coalesce_scan_ops``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.analyzers.base import (
    Analyzer,
    ScanShareableAnalyzer,
    find_first_failing,
)
from deequ_tpu_torch.analyzers.grouping import (
    FrequencyBasedAnalyzer,
    Histogram,
    ScanShareableFrequencyBasedAnalyzer,
)
from deequ_tpu_torch.data.table import ColumnarTable
from deequ_tpu_torch.device import resolve_device
from deequ_tpu_torch.exceptions import wrap_if_necessary
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


class AnalysisRunner:
    """Entry point for computing metrics (reference AnalysisRunner.scala)."""

    @staticmethod
    def do_analysis_run(
        data: ColumnarTable,
        analyzers: Sequence[Analyzer],
        device=None,
    ) -> AnalyzerContext:
        """Compute every analyzer's metric over ``data`` on ``device``
        (default: ``cuda``, or the ambient ``use_device`` scope; raises
        DeviceUnavailableException when that device is not there)."""
        dev = resolve_device(device)
        if not analyzers:
            return AnalyzerContext.empty()

        # (1) precondition partition (reference L137-145)
        passed: List[Analyzer] = []
        failure_ctx = AnalyzerContext.empty()
        for analyzer in analyzers:
            exc = find_first_failing(data.schema, analyzer.preconditions())
            if exc is None:
                passed.append(analyzer)
            else:
                failure_ctx.metric_map[analyzer] = analyzer.to_failure_metric(exc)

        # (2) split (reference L148-153)
        grouping = [a for a in passed if _is_grouping_shared(a)]
        scanning = [a for a in passed if isinstance(a, ScanShareableAnalyzer)]
        own_pass = [a for a in passed if a not in grouping and a not in scanning]

        # (3) one fused scan for all shareable analyzers (reference L289-336)
        scan_ctx = AnalysisRunner._run_scanning_analyzers(data, scanning, dev)

        # (4) own-pass analyzers (reference L155-160)
        own_ctx = AnalyzerContext(
            {a: a.calculate(data, dev) for a in own_pass}
        )

        # (5) one computation per distinct sorted grouping-column set
        # (reference L175-190)
        by_grouping: Dict[Tuple[str, ...], List[FrequencyBasedAnalyzer]] = {}
        for analyzer in grouping:
            key = tuple(sorted(analyzer.group_columns))
            by_grouping.setdefault(key, []).append(analyzer)
        group_ctx = AnalyzerContext.empty()
        for group_key, group_analyzers in by_grouping.items():
            group_ctx += AnalysisRunner._run_grouping_analyzers(
                data, list(group_key), group_analyzers, dev
            )
        return failure_ctx + scan_ctx + own_ctx + group_ctx

    @staticmethod
    def _run_scanning_analyzers(
        data: ColumnarTable,
        analyzers: Sequence[ScanShareableAnalyzer],
        device,
    ) -> AnalyzerContext:
        """Per-analyzer ScanOp construction with failure isolation (a
        malformed op, e.g. a bad where expression, fails only its
        analyzer), then one fused scan whose failure maps onto every
        participating analyzer."""
        ctx = AnalyzerContext.empty()
        ops = []
        scannable = []
        for analyzer in analyzers:
            try:
                op = analyzer.scan_op(data)
            except Exception as e:  # noqa: BLE001 — failure is data
                ctx.metric_map[analyzer] = analyzer.to_failure_metric(
                    wrap_if_necessary(e)
                )
                continue
            ops.append(op)
            scannable.append(analyzer)
        if not scannable:
            return ctx
        exec_ops, plan = AnalysisRunner._coalesce_scan_ops(ops)
        try:
            results = run_scan(data, exec_ops, device)
        except Exception as e:  # noqa: BLE001 — a failure inside the shared
            # scan maps onto every participating analyzer (reference L320-323)
            wrapped = wrap_if_necessary(e)
            for a in scannable:
                ctx.metric_map[a] = a.to_failure_metric(wrapped)
            return ctx
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
            ctx.metric_map[analyzer] = analyzer.calculate_metric(state)
        return ctx

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
    ) -> AnalyzerContext:
        """The count statistics when every analyzer of the set is a
        function of the count distribution (group values never decode),
        else the frequency table (reference L1266-1331)."""
        count_stats = all(_count_stats_capable(a) for a in analyzers)
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
        return AnalyzerContext(
            {a: a.calculate_metric(state) for a in analyzers}
        )
