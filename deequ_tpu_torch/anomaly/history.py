"""History extraction helpers (reference anomalydetection/HistoryUtils.scala)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class DataPoint:
    """A (time, optional metric value) pair."""

    time: int
    metric_value: Optional[float]


def extract_metric_values(
    metrics: Sequence[Tuple[int, Optional[object]]]
) -> List[DataPoint]:
    """(date, Optional[Metric]) pairs -> DataPoints, keeping only successful
    double values (reference HistoryUtils.scala:24-46)."""
    out = []
    for time, metric in metrics:
        value: Optional[float] = None
        if metric is not None and getattr(metric, "value", None) is not None:
            if metric.value.is_success:
                try:
                    value = float(metric.value.get())
                except (TypeError, ValueError):
                    value = None
        out.append(DataPoint(time, value))
    return out


def history_from_loader(loader, analyzer) -> List[DataPoint]:
    """One analyzer's metric history pulled through the repository
    LOADER interface only (``MetricsRepositoryMultipleResultsLoader``)
    — never through backend private fields — sorted by dataset date.

    This is the ONE history-pull every anomaly-strategy consumer
    (``checks.is_newest_point_non_anomalous``, ad hoc detector runs)
    shares, which is what makes the strategies backend-agnostic: the
    in-memory, filesystem, and columnar repositories all satisfy the
    loader contract, so the same saves yield the same DataPoints — and
    therefore the same ``AnomalyDetectionResult`` — from any of them
    (the cross-backend parity test in tests/test_metrics_repo.py pins
    it)."""
    results = loader.for_analyzers([analyzer]).get()
    pairs = [
        (
            result.result_key.data_set_date,
            result.analyzer_context.metric_map.get(analyzer),
        )
        for result in results
    ]
    pairs.sort(key=lambda t: t[0])
    return extract_metric_values(pairs)
