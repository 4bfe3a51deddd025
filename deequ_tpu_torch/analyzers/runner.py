"""AnalysisRunner — the query planner (reference layer L4,
analyzers/runners/AnalysisRunner.scala; the counterpart of
``deequ_tpu/analyzers/runner.py`` for one in-memory table on one device).

Planning pipeline, mirroring doAnalysisRun (reference L97-203):

1. partition analyzers by failing preconditions -> failure metrics;
2. split {scan-shareable | grouping};
3. fuse ALL scan-shareable analyzers into ONE pass (ops/scan_engine.py —
   the analogue of the single data.agg(...) job);
4. for each distinct grouping-column set, compute the count statistics
   ONCE and finalize all its analyzers from them.

Partial failure is data: a failure inside the fused scan maps onto every
participating analyzer (reference L320-323); precondition failures become
failure metrics instead of aborting (L137-145). Streams, saved and
aggregated states, repositories and sketches wait for later slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.analyzers.base import (
    Analyzer,
    ScanShareableAnalyzer,
    find_first_failing,
)
from deequ_tpu_torch.analyzers.grouping import FrequencyBasedAnalyzer
from deequ_tpu_torch.data.table import ColumnarTable
from deequ_tpu_torch.device import resolve_device
from deequ_tpu_torch.exceptions import wrap_if_necessary
from deequ_tpu_torch.metrics import Metric
from deequ_tpu_torch.ops.scan_engine import run_scan
from deequ_tpu_torch.ops.segment import group_count_stats


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
        grouping = [a for a in passed if isinstance(a, FrequencyBasedAnalyzer)]
        scanning = [a for a in passed if isinstance(a, ScanShareableAnalyzer)]

        # (3) one fused scan for all shareable analyzers (reference L289-336)
        scan_ctx = AnalysisRunner._run_scanning_analyzers(data, scanning, dev)

        # (4) one count-stats pass per distinct sorted grouping-column set
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
        return failure_ctx + scan_ctx + group_ctx

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
        try:
            results = run_scan(data, ops, device)
        except Exception as e:  # noqa: BLE001 — a failure inside the shared
            # scan maps onto every participating analyzer (reference L320-323)
            wrapped = wrap_if_necessary(e)
            for a in scannable:
                ctx.metric_map[a] = a.to_failure_metric(wrapped)
            return ctx
        for analyzer, result in zip(scannable, results):
            try:
                state = analyzer.state_from_scan_result(result)
            except Exception as e:  # noqa: BLE001
                ctx.metric_map[analyzer] = analyzer.to_failure_metric(
                    wrap_if_necessary(e)
                )
                continue
            ctx.metric_map[analyzer] = analyzer.calculate_metric(state)
        return ctx

    @staticmethod
    def _run_grouping_analyzers(
        data: ColumnarTable,
        grouping_columns: List[str],
        analyzers: Sequence[FrequencyBasedAnalyzer],
        device,
    ) -> AnalyzerContext:
        try:
            stats = group_count_stats(data, grouping_columns, device)
        except Exception as e:  # noqa: BLE001 — failure is data
            wrapped = wrap_if_necessary(e)
            return AnalyzerContext(
                {a: a.to_failure_metric(wrapped) for a in analyzers}
            )
        return AnalyzerContext(
            {a: a.calculate_metric(stats) for a in analyzers}
        )
